// RWKV6 ("Finch") WKV recurrence over a whole sequence: every prefill
// layer of rwkv6-1.6b goes through this kernel (one launch per layer).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/wkv6/wkv6.py:
// wkv6_chunked (_wkv6_kernel).
//
// Function, per (batch b, head h), with K = V = 64 and state S (K x V)
// starting at state0 (or zero):
//     y_t[j]    = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//     S[i][j]  <- S[i][j] * w_t[i] + k_t[i] * v_t[j]
// y in the inputs' type (fp32 or bf16), the final state fp32; all
// arithmetic is fp32.
//
// What bounds it on Hopper: latency. The work is ~7 flops per state
// entry per token and the bytes are the inputs read once, so the card's
// rates would finish it in tens of microseconds; but the recurrence is
// sequential in t, and B * H = 128 independent sequences at the serving
// shape give one block per SM, two warps each. Each token costs a
// dependent chain through the 64-term sum.
//
// Design: the CUDA layout the TPU kernel re-blocked away from
// (wkv6.py:3-13) fits Hopper as it is. One block of 64 threads per
// (b, h); thread j holds column S[:, j] in 64 registers for the whole
// sequence. Tokens are staged 32 at a time: each thread loads element j
// of r_t, k_t, w_t, v_t (coalesced 256-byte rows) into shared memory,
// then the block walks the 32 tokens with no further synchronisation,
// reading r_t, k_t, w_t as broadcast float4s and writing y_t[j]
// (coalesced). Four partial sums break the 64-term dependency chain.
// Nothing carries between blocks; any T works (no chunk divisibility).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kHead = 64;        // K = V = RWKV head size
constexpr int kStage = 32;       // tokens staged per pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kHead)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ state0,
            T* __restrict__ y, float* __restrict__ state_out, int T_len,
            int H) {
  __shared__ __align__(16) float sr[kStage][kHead];
  __shared__ __align__(16) float sk[kStage][kHead];
  __shared__ __align__(16) float sw[kStage][kHead];
  __shared__ float sv[kStage][kHead];
  __shared__ __align__(16) float su[kHead];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int j = threadIdx.x;
  const size_t state_base = static_cast<size_t>(bh) * kHead * kHead;

  float S[kHead];   // S[i] = state[i][j]
#pragma unroll
  for (int i = 0; i < kHead; ++i)
    S[i] = state0 != nullptr ? state0[state_base + i * kHead + j] : 0.f;
  su[j] = u[h * kHead + j];

  for (int t0 = 0; t0 < T_len; t0 += kStage) {
    const int n = min(kStage, T_len - t0);
    __syncthreads();   // the previous stage is consumed (and su is set)
    for (int tt = 0; tt < n; ++tt) {
      const size_t off =
          ((static_cast<size_t>(b) * T_len + t0 + tt) * H + h) * kHead + j;
      sr[tt][j] = to_f32(r[off]);
      sk[tt][j] = to_f32(k[off]);
      sw[tt][j] = to_f32(w[off]);
      sv[tt][j] = to_f32(v[off]);
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = sv[tt][j];
      const float4* r4 = reinterpret_cast<const float4*>(sr[tt]);
      const float4* k4 = reinterpret_cast<const float4*>(sk[tt]);
      const float4* w4 = reinterpret_cast<const float4*>(sw[tt]);
      const float4* u4 = reinterpret_cast<const float4*>(su);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i4 = 0; i4 < kHead / 4; ++i4) {
        const float4 rr = r4[i4], kk = k4[i4], ww = w4[i4], uu = u4[i4];
        const float rv[4] = {rr.x, rr.y, rr.z, rr.w};
        const float kv_[4] = {kk.x, kk.y, kk.z, kk.w};
        const float wv[4] = {ww.x, ww.y, ww.z, ww.w};
        const float uv[4] = {uu.x, uu.y, uu.z, uu.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * i4 + e;
          const float kv = kv_[e] * vj;
          acc[e] = fmaf(rv[e], S[i] + uv[e] * kv, acc[e]);
          S[i] = fmaf(S[i], wv[e], kv);
        }
      }
      const size_t off =
          ((static_cast<size_t>(b) * T_len + t0 + tt) * H + h) * kHead + j;
      y[off] = from_f32<T>((acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
  }

#pragma unroll
  for (int i = 0; i < kHead; ++i) state_out[state_base + i * kHead + j] = S[i];
}

}  // namespace

extern "C" {

// r, k, v, w: (B, T, H, 64) contiguous, fp32 (is_bf16 = 0) or bf16
// (is_bf16 = 1); u: (H, 64) fp32; state0: (B, H, 64, 64) fp32 or null
// (zero initial state); y: (B, T, H, 64) in the inputs' type;
// state_out: (B, H, 64, 64) fp32. Returns the launch's cudaError_t.
int ffly_wkv6(const void* r, const void* k, const void* v, const void* w,
              const float* u, const float* state0, void* y,
              float* state_out, int B, int T_len, int H, int is_bf16,
              void* stream) {
  if (B == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    wkv6_kernel<T><<<B * H, kHead, 0, st>>>(
        static_cast<const T*>(r), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(w), u, state0,
        static_cast<T*>(y), state_out, T_len, H);
  } else {
    wkv6_kernel<float><<<B * H, kHead, 0, st>>>(
        static_cast<const float*>(r), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(w), u,
        state0, static_cast<float*>(y), state_out, T_len, H);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
