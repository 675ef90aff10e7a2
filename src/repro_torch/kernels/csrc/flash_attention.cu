// Causal / sliding-window GQA attention forward with an online softmax,
// fp32: every prefill layer of the dense models served in fp32 (qwen3-0.6b:
// one launch per layer) goes through this kernel. The bf16 mode has its
// own tensor-core kernel, flash_attention_mma.cu.
//
// Replaces the fp32 side of the Pallas TPU kernel of
// src/repro/kernels/flash_attention/flash_attention.py:
// flash_attention_fwd (_flash_kernel, _call).
//
// Function: out[b,h,s] = softmax_t(mask(softcap(q[b,h,s]·k[b,h/rep,t] /
// sqrt(hd)))) @ v[b,h/rep], the logits of masked (real) keys set to
// -2.3819763e38 as in the reference, keys at or past the true T removed
// outright in every mode. Every product, the softmax and the accumulator
// are fp32 (no TF32, no tensor cores).
//
// What bounds it on Hopper: operations. A (64 x 64) tile does 2·hd
// flops per logit against hd·4 bytes staged once per 64 queries, far
// above the card's fp32 ops:byte balance; without tensor cores the bound
// is the 67 TFLOP/s fp32 rate.
//
// Design (a simple kernel first; wgmma/TMA come later):
// - one block of 128 threads per (64 query rows, head, batch); query head
//   h reads KV head h / rep directly (no repeated K/V in memory);
// - the Q tile and one (64 x hd) K and V tile at a time are staged in
//   shared memory as fp32 (rows padded by one float so the strided reads
//   of the logit tile hit distinct banks); K/V tiles past the causal
//   diagonal, and tiles wholly outside the window, are never loaded;
// - each thread computes an 8 x 4 patch of the logit tile in registers,
//   writes it to shared memory, two threads per row run the online
//   softmax update (running max and sum per row), and each thread
//   accumulates an 8 x (hd/16) patch of the output in registers;
// - no state crosses blocks, and S and T need not be multiples of 64.
// The shared footprint (~113 KB at hd = 128) is above the 48 KB default,
// so the launcher raises the kernel's dynamic shared-memory limit.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 128;
constexpr int kRows = kBQ / 8;   // rows per thread (8 row groups)
constexpr int kCols = kBK / 16;  // logit columns per thread (16 col groups)
constexpr float kBigNeg = -2.3819763e38f;

__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD +
                          kBQ * (kBK + 1) + 3 * kBQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int H, int KV,
                 int S, int T_len, int causal, int window, float softcap) {
  constexpr int kOut = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                      // [kBQ][HD + 1]
  float* sK = sQ + kBQ * (HD + 1);       // [kBK][HD + 1]
  float* sV = sK + kBK * (HD + 1);       // [kBK][HD]
  float* sP = sV + kBK * HD;             // [kBQ][kBK + 1]
  float* sM = sP + kBQ * (kBK + 1);      // running row max
  float* sL = sM + kBQ;                  // running row sum
  float* sC = sL + kBQ;                  // this tile's rescale factor

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int ty = tid / 16;               // row group: rows ty + 8 i
  const int tx = tid % 16;               // col group: cols tx + 16 j
  const float sqrt_hd = sqrtf(static_cast<float>(HD));

  const T* qb = q + (static_cast<size_t>(b) * H + h) * S * HD;
  const T* kb = k + (static_cast<size_t>(b) * KV + kvh) * T_len * HD;
  const T* vb = v + (static_cast<size_t>(b) * KV + kvh) * T_len * HD;
  T* ob = out + (static_cast<size_t>(b) * H + h) * S * HD;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    sQ[r * (HD + 1) + d] = q0 + r < S ? to_f32(qb[(q0 + r) * HD + d]) : 0.f;
  }
  if (tid < kBQ) {
    sM[tid] = kBigNeg;
    sL[tid] = 0.f;
  }

  // the tiles this query block needs: causal stops at its last row's
  // diagonal; a window starts at the first key its first row can see —
  // skipped only when every row of the block has its own diagonal key
  // (q_last < T), so no row is left with nothing but masked keys
  const int q_last = min(q0 + kBQ, S) - 1;
  const int kv_end = causal ? min(T_len, q_last + 1) : T_len;
  int kv_begin = 0;
  if (causal && window > 0 && q_last < T_len)
    kv_begin = max(0, q0 - window + 1) / kBK * kBK;

  float acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[i][j] = 0.f;

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();   // the previous tile is consumed (and Q is staged)
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const bool live = k0 + r < T_len;
      sK[r * (HD + 1) + d] = live ? to_f32(kb[(k0 + r) * HD + d]) : 0.f;
      sV[r * HD + d] = live ? to_f32(vb[(k0 + r) * HD + d]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = sQ[(ty + 8 * i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = sK[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int r = ty + 8 * i, c = tx + 16 * j;
        const int kp = k0 + c;
        float x = s[i][j] / sqrt_hd;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        if (kp >= T_len) {
          x = -INFINITY;                 // padding: no key at all
        } else {
          const int dist = q0 + r - kp;
          bool ok = !causal || dist >= 0;
          if (window > 0) ok = ok && dist < window;
          if (!ok) x = kBigNeg;
        }
        sP[r * (kBK + 1) + c] = x;
      }
    }
    __syncthreads();

    {  // online softmax: threads 2r and 2r+1 own row r, 32 columns each
      const int r = tid >> 1, half = tid & 1;
      float* row = sP + r * (kBK + 1) + half * 32;
      float mx = -INFINITY;
      for (int c = 0; c < 32; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);   // finite: sM >= kBigNeg
      float sum = 0.f;
      for (int c = 0; c < 32; ++c) {
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      __syncwarp();
      if (half == 0) {
        const float corr = expf(m_old - m_new);
        sC[r] = corr;
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float corr = sC[ty + 8 * i];
#pragma unroll
      for (int j = 0; j < kOut; ++j) acc[i][j] *= corr;
    }
    for (int c = 0; c < kBK; ++c) {
      float pv[kRows], vv[kOut];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = sP[(ty + 8 * i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < kOut; ++j) vv[j] = sV[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kOut; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty + 8 * i;
    if (q0 + r >= S) continue;
    const float l = fmaxf(sL[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < kOut; ++j)
      ob[(q0 + r) * HD + tx + 16 * j] = from_f32<T>(acc[i][j] / l);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int KV, int S, int T_len, int causal, int window,
           float softcap, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HD>();
  // raised once per instantiation, before any launch (and so outside
  // any CUDA-graph capture of a launch)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, KV, S, T_len,
      causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q: (B, H, S, hd); k, v: (B, KV, T, hd); out: (B, H, S, hd); all
// contiguous fp32; hd 64 or 128; H a multiple of KV. Returns the launch's
// cudaError_t (1 = invalid value for an unsupported hd).
int ffly_flash_attention_fwd(const void* q, const void* k, const void* v,
                             void* out, int B, int H, int KV, int S,
                             int T_len, int hd, int causal, int window,
                             float softcap, void* stream) {
  if (B == 0 || H == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch<float, 64>(q, k, v, out, B, H, KV, S, T_len, causal,
                             window, softcap, st);
  if (hd == 128)
    return launch<float, 128>(q, k, v, out, B, H, KV, S, T_len, causal,
                              window, softcap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
