// Causal / sliding-window GQA attention forward, bf16, on Hopper's tensor
// cores: every prefill layer of a dense model served in bf16 (qwen3-0.6b:
// one launch per layer) goes through this kernel. The fp32 mode stays on
// the SIMT kernel of flash_attention.cu.
//
// Replaces the bf16 side of the Pallas TPU kernel of
// src/repro/kernels/flash_attention/flash_attention.py:
// flash_attention_fwd (_flash_kernel, _call).
//
// Function: out[b,h,s] = softmax_t(mask(softcap(q[b,h,s]·k[b,h/rep,t] /
// sqrt(hd)))) @ v[b,h/rep], the logits of masked (real) keys set to
// -2.3819763e38 as in the reference, keys at or past the true T removed
// outright in every mode. Inputs and output bf16, hd 64 or 128.
//
// Numerics: Q·Kᵀ runs on the tensor cores with fp32 accumulation, and a
// bf16·bf16 product is exact in fp32, so the logits lose nothing against
// the plain version beyond summation order. They are scaled after the
// product, in log2 units (x·log2 e / sqrt(hd), so that each p is one ex2),
// then softcapped (tanh as 1 - 2/(1 + e^2y), a few fp32 ulp from tanhf)
// and masked in fp32; a masked real key's logit is -2.3819763e38 in these
// units too, which keeps the plain version's semantics (no weight beside a
// real key, a uniform average where every key is masked). The softmax is
// fp32; the row sum l adds the fp32 p. The one new rounding is P rounded to
// bf16 as the A operand of P·V, at most 2^-8·max|v| (about 2^-9 over a
// row's keys). O accumulates in fp32 and is rounded to bf16 once.
//
// What bounds it on Hopper: operations. At the qwen3 layer (B 4, H 16,
// KV 8, S = T = 1024, hd 128, causal) the function needs 17.2 GFLOP for
// 50.3 MB, ~340 operations a byte, above the bf16 tensor cores' ops:byte
// balance (~295): the bound is the bf16 tensor-core rate (989 TFLOP/s
// dense), 17.4 us. The design feeds the tensor cores from registers and
// swizzled shared memory and keeps everything else (the logits, the
// softmax, O) in registers, so device memory sees each byte once.
//
// Design (FlashAttention-2's shape on mma.sync; wgmma/TMA come later):
// - one block of 4 warps per (64 query rows, head, batch), each warp owning
//   16 rows; query head h reads KV head h / rep directly (no repeated K/V
//   in memory); the linear block index walks the query blocks from the
//   last (the longest causal rows) to the first, so the causal tail does
//   not leave SMs idle at the end of the grid;
// - Q is copied to shared memory once and held in registers as the A
//   fragments of mma.sync.m16n8k16 (ldmatrix) for the whole key loop;
// - K/V tiles of 64 keys are copied with cp.async (16 bytes a thread, rows
//   past T zero-filled by a src-size of 0) into a ring of two buffers, so
//   tile j+1 arrives while tile j is computed, with one barrier a tile
//   (a third buffer measured no faster); every tile is stored with its
//   16-byte chunks XOR-swizzled by row, so ldmatrix (K) and ldmatrix.trans
//   (V, the B operand of P·V) read without bank conflicts;
// - S = Q·Kᵀ lands in fp32 registers; scale, softcap and masks are applied
//   on the fragment layout (the masks only on tiles that cross the causal
//   diagonal, the window edge or T); the online softmax takes each row's
//   max and sum across its quad (__shfl_xor_sync 1 and 2), so no logit tile
//   goes through shared memory and no barrier separates the two products;
// - P, rounded to bf16 in registers, is the A operand of P·V as it stands:
//   the C layout of m16n8 is the A layout of m16n8k16. O stays in fp32
//   registers, rescaled by exp(m_old - m_new) per tile;
// - the epilogue divides by max(l, 1e-30), rounds to bf16, stages the tile
//   in Q's shared memory and stores it with 16-byte vector stores;
// - tiles are skipped as in the fp32 kernel: causal stops at the block's
//   last diagonal key; a causal window starts at the tile of the first key
//   the block's first row can see.
// Shared memory: Q plus two K and two V tiles, 80 KB at hd 128 (40 KB at
// hd 64), so two blocks fit on an SM; the launcher raises the kernel's
// dynamic shared-memory limit. Every base pointer must be 16-byte aligned
// (the wrapper copies a view that is not).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per block, 16 per warp
constexpr int kBK = 64;          // keys per tile
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kNT = kBK / 8;     // 8-key n-tiles of the logit tile
constexpr float kBigNeg = -2.3819763e38f;
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

// Element offset of 16-byte chunk c of row r in a [rows][HD] bf16 tile.
// Chunk c is stored at c ^ (r % 8): the 8 rows one ldmatrix phase reads at
// one logical chunk land in 8 distinct groups of 4 banks.
template <int HD>
__device__ __forceinline__ int swz(int r, int c) {
  return r * HD + ((c ^ (r & 7)) << 3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(live ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a·b on one m16n8k16 tile: a row-major 16x16, b column-major 16x8
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// tanh(y) = 1 - 2 / (1 + e^(2y)), within a few fp32 ulp of 1 (the
// library's tanhf is several times slower here)
__device__ __forceinline__ float tanh_fast(float y) {
  const float e2y = exp2f(fminf(y * (2.f * kLog2e), 126.f));
  return 1.f - __fdividef(2.f, 1.f + e2y);
}

// two floats rounded to bf16, the first in the low half (the lower index
// of an mma fragment pair)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0 + 64) of a [n_rows][HD] matrix into a swizzled tile;
// rows at or past n_rows are zero-filled
template <int HD>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src,
                                          int row0, int n_rows, int tid) {
  constexpr int kChunks = HD / 8;
#pragma unroll
  for (int x = 0; x < 64 * kChunks / kThreads; ++x) {
    const int i = tid + x * kThreads;
    const int r = i / kChunks, c = i % kChunks;
    const bool live = row0 + r < n_rows;
    const bf16* from = src + static_cast<size_t>(live ? row0 + r : 0) * HD +
                       c * 8;
    cp_async16(smem_u32(tile + swz<HD>(r, c)), from, live);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      int H, int KV, int S, int T_len, int causal, int window,
                      float softcap) {
  constexpr int kKS = HD / 16;   // 16-dim k-steps of Q·Kᵀ
  constexpr int kOT = HD / 8;    // 8-dim n-tiles of O
  constexpr int kChunks = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][HD], then the output
  bf16* sK = sQ + kBQ * HD;                      // 2 x [kBK][HD]
  bf16* sV = sK + 2 * kBK * HD;                  // 2 x [kBK][HD]

  // the linear block index, longest query block first
  const int heads = gridDim.y * gridDim.z;
  const int lin =
      blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int q0 = (gridDim.x - 1 - lin / heads) * kBQ;
  const int h = (lin % heads) % H;
  const int b = (lin % heads) / H;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;   // fragment row group, column pair
  // logits in log2 units (x·log2 e), so that p = 2^(x - m) is one ex2:
  // x = s·log2e / sqrt(hd), or softcap·log2e·tanh(s / (sqrt(hd)·softcap))
  const float inv_sqrt_hd = 1.f / sqrtf(static_cast<float>(HD));
  const bool capped = softcap > 0.f;
  const float pre = capped ? inv_sqrt_hd / softcap : inv_sqrt_hd * kLog2e;
  const float post = softcap * kLog2e;

  const bf16* qb = q + (static_cast<size_t>(b) * H + h) * S * HD;
  const bf16* kb = k + (static_cast<size_t>(b) * KV + kvh) * T_len * HD;
  const bf16* vb = v + (static_cast<size_t>(b) * KV + kvh) * T_len * HD;
  bf16* ob = out + (static_cast<size_t>(b) * H + h) * S * HD;

  // the tiles this query block needs: causal stops at its last row's
  // diagonal; a window starts at the first key its first row can see —
  // skipped only when every row of the block has its own diagonal key
  // (q_last < T), so no row is left with nothing but masked keys
  const int q_last = min(q0 + kBQ, S) - 1;
  const int kv_end = causal ? min(T_len, q_last + 1) : T_len;
  int kv_begin = 0;
  if (causal && window > 0 && q_last < T_len)
    kv_begin = max(0, q0 - window + 1) / kBK * kBK;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + kBK - 1) / kBK
                                        : 0;

  // tile i lives in buffer i % 2
  load_tile<HD>(sQ, qb, q0, S, tid);
  if (n_tiles > 0) {
    load_tile<HD>(sK, kb, kv_begin, T_len, tid);
    load_tile<HD>(sV, vb, kv_begin, T_len, tid);
  }
  cp_async_commit();

  uint32_t qf[kKS][4];
  float o[kOT][4];
#pragma unroll
  for (int n = 0; n < kOT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kBigNeg, kBigNeg};   // running max of rows g and g + 8
                                     // (log2 units)
  float l[2] = {0.f, 0.f};           // running sum of the fp32 p

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = kv_begin + it * kBK;
    const bf16* cK = sK + (it & 1) * kBK * HD;
    const bf16* cV = sV + (it & 1) * kBK * HD;
    cp_async_wait<0>();   // this thread's copies of tile it have landed
    __syncthreads();      // everyone's have, and tile it - 1's buffer is free
    if (it + 1 < n_tiles) {   // tile it + 1 streams in during this one
      load_tile<HD>(sK + ((it + 1) & 1) * kBK * HD, kb, k0 + kBK, T_len, tid);
      load_tile<HD>(sV + ((it + 1) & 1) * kBK * HD, vb, k0 + kBK, T_len, tid);
      cp_async_commit();
    }
    if (it == 0) {
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        const int r = warp * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
        ldsm_x4(smem_u32(sQ + swz<HD>(r, 2 * ks + (lane >> 4))), qf[ks]);
      }
    }

    // S = Q·Kᵀ: a warp's 16 rows x 64 keys in fp32
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        uint32_t kf[4];
        const int r = j * 8 + (lane & 7) + ((lane >> 4) << 3);
        ldsm_x4(smem_u32(cK + swz<HD>(r, 2 * ks + ((lane >> 3) & 1))), kf);
        mma_bf16(s[j], qf[ks], kf[0], kf[1]);
        mma_bf16(s[j + 1], qf[ks], kf[2], kf[3]);
      }
    }

    // scale, softcap, and the masks where the tile crosses T, the causal
    // diagonal or the window's edge
    const bool edge = k0 + kBK > T_len || (causal && k0 + kBK - 1 > q0) ||
                      (window > 0 && q0 + kBQ - 1 - k0 >= window);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * pre;
        if (capped) x = post * tanh_fast(x);
        if (edge) {
          const int kp = k0 + j * 8 + 2 * t + (e & 1);
          if (kp >= T_len) {
            x = -INFINITY;               // padding: no key at all
          } else {
            const int dist = q0 + warp * 16 + g + (e >> 1) * 8 - kp;
            bool ok = !causal || dist >= 0;
            if (window > 0) ok = ok && dist < window;
            if (!ok) x = kBigNeg;
          }
        }
        s[j][e] = x;
      }
    }

    // online softmax: rows g (e = 0, 1) and g + 8 (e = 2, 3), each spread
    // over the 4 lanes of a quad
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);   // finite: m >= kBigNeg
      const float corr = exp2f(m[hr] - m_new);
      m[hr] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
          const float p = exp2f(s[j][e] - m_new);
          s[j][e] = p;
          sum += p;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[hr] = l[hr] * corr + sum;
#pragma unroll
      for (int n = 0; n < kOT; ++n) {
        o[n][2 * hr] *= corr;
        o[n][2 * hr + 1] *= corr;
      }
    }

    // O += P·V: P's C fragments, rounded to bf16, are the A fragments
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < kOT; n += 2) {
        uint32_t vf[4];
        const int r = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
        ldsm_x4_trans(smem_u32(cV + swz<HD>(r, n + (lane >> 4))), vf);
        mma_bf16(o[n], pa, vf[0], vf[1]);
        mma_bf16(o[n + 1], pa, vf[2], vf[3]);
      }
    }
  }

  // epilogue: O / l in bf16, staged in Q's (swizzled) rows, 16-byte stores
  if (n_tiles == 0) {   // no tile: Q's copy may still be landing
    cp_async_wait<0>();
    __syncthreads();
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float lr = fmaxf(l[hr], 1e-30f);
    const int r = warp * 16 + g + hr * 8;
#pragma unroll
    for (int n = 0; n < kOT; ++n)
      *reinterpret_cast<uint32_t*>(sQ + swz<HD>(r, n) + 2 * t) =
          pack_bf16(o[n][2 * hr] / lr, o[n][2 * hr + 1] / lr);
  }
  __syncwarp();
#pragma unroll
  for (int x = 0; x < 16 * kChunks / 32; ++x) {
    const int i = lane + 32 * x;
    const int r = warp * 16 + i / kChunks, c = i % kChunks;
    if (q0 + r < S)
      *reinterpret_cast<uint4*>(ob + static_cast<size_t>(q0 + r) * HD +
                                c * 8) =
          *reinterpret_cast<const uint4*>(sQ + swz<HD>(r, c));
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int KV, int S, int T_len, int causal, int window,
           float softcap, cudaStream_t stream) {
  constexpr size_t bytes = sizeof(bf16) * (kBQ + 4 * kBK) * HD;
  // raised once per instantiation, before any launch (and so outside
  // any CUDA-graph capture of a launch)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_bf16_kernel<HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), H, KV, S, T_len,
      causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q: (B, H, S, hd); k, v: (B, KV, T, hd); out: (B, H, S, hd); all
// contiguous bf16 with 16-byte aligned base pointers; hd 64 or 128; H a
// multiple of KV. Returns the launch's cudaError_t (1 = invalid value for
// an unsupported hd).
int ffly_flash_attention_bf16_fwd(const void* q, const void* k,
                                  const void* v, void* out, int B, int H,
                                  int KV, int S, int T_len, int hd,
                                  int causal, int window, float softcap,
                                  void* stream) {
  if (B == 0 || H == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch<64>(q, k, v, out, B, H, KV, S, T_len, causal, window,
                      softcap, st);
  if (hd == 128)
    return launch<128>(q, k, v, out, B, H, KV, S, T_len, causal, window,
                       softcap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
