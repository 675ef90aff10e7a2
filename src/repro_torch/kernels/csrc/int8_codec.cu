// Blockwise symmetric int8 quantize / dequantize of a packed flat buffer:
// the FFLY v2 delta codec's hot path (every migration quantizes the whole
// server-stage checkpoint on pack and dequantizes it on unpack).
//
// Replaces the Pallas TPU kernels of
// src/repro/kernels/int8_codec/int8_codec.py: quantize_packed
// (_quant_kernel, _quant_res_kernel) and dequantize_packed
// (_dequant_kernel, _dequant_res_kernel).
//
// What bounds it on Hopper: memory. Quantize reads 4 B (8 B residual)
// and writes 1 B per element, with a handful of flops, far below the
// card's ops:byte balance. The design is one pass: a thread block owns
// one 1024-element row (the codec's BLOCK), keeps the row in registers
// (4 values per thread), reduces max|r| with warp shuffles plus one
// shared-memory step, and writes q and the row's scale — the row is read
// from device memory once. Loads are coalesced (thread t reads elements
// t, t+256, t+512, t+768 of the row).
//
// Exactness: the FFLY bytes are a wire format, so q and the scales must
// equal numpy's (repro/kernels/int8_codec/ref.py) bit for bit:
//   s = max(fl(max|r| / 127), 1e-12)    correctly rounded division
//   q = clip(rint(fl(r / s)), -127, 127) round half to even
// and on decode  x = fl(fl(q * s) + base)  — two roundings, never an FMA.
// The explicit _rn intrinsics pin each rounding; the file is never built
// with --use_fast_math.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 1024;            // codec block (one scale per row)
constexpr int kThreads = 256;
constexpr int kPerThread = kBlock / kThreads;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One block per row. base == nullptr: plain mode (quantize x);
// otherwise residual mode (quantize x - base). Elements past n are zero,
// so the tail of the last row quantizes to 0.
__global__ void __launch_bounds__(kThreads)
quantize_packed_kernel(const float* __restrict__ x,
                       const float* __restrict__ base, long long n,
                       int8_t* __restrict__ q, float* __restrict__ scales) {
  __shared__ float warp_amax[kThreads / 32];
  __shared__ float row_amax;
  const long long row0 = static_cast<long long>(blockIdx.x) * kBlock;

  float r[kPerThread];
  float amax = 0.0f;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = row0 + threadIdx.x + k * kThreads;
    float v = 0.0f;
    if (i < n) {
      v = x[i];
      if (base != nullptr) v = __fsub_rn(v, base[i]);
    }
    r[k] = v;
    amax = fmaxf(amax, fabsf(v));
  }
  amax = warp_max(amax);
  if ((threadIdx.x & 31) == 0) warp_amax[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x < 32) {
    float m = threadIdx.x < kThreads / 32 ? warp_amax[threadIdx.x] : 0.0f;
    m = warp_max(m);
    if (threadIdx.x == 0) row_amax = m;
  }
  __syncthreads();

  const float s = fmaxf(__fdiv_rn(row_amax, 127.0f), 1e-12f);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = row0 + threadIdx.x + k * kThreads;
    float v = rintf(__fdiv_rn(r[k], s));
    v = fminf(fmaxf(v, -127.0f), 127.0f);
    q[i] = static_cast<int8_t>(static_cast<int>(v));
  }
  if (threadIdx.x == 0) scales[blockIdx.x] = s;
}

// Elementwise decode over n values. Rows at or past n_scales (a trimmed
// scale section) use scale 1.0, as the reference pads them.
__global__ void __launch_bounds__(kThreads)
dequantize_packed_kernel(const int8_t* __restrict__ q,
                         const float* __restrict__ scales,
                         long long n_scales, const float* __restrict__ base,
                         long long n, float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    const long long row = i / kBlock;
    const float s = row < n_scales ? scales[row] : 1.0f;
    float v = __fmul_rn(static_cast<float>(q[i]), s);
    if (base != nullptr) v = __fadd_rn(v, base[i]);
    out[i] = v;
  }
}

}  // namespace

extern "C" {

// x, base: (n,) float32 (base may be null). q: (rows * 1024,) int8 and
// scales: (rows,) float32 with rows = ceil(n / 1024). Returns the launch's
// cudaError_t.
int ffly_quantize_packed(const float* x, const float* base, long long n,
                         int8_t* q, float* scales, void* stream) {
  const long long rows = (n + kBlock - 1) / kBlock;
  if (rows == 0) return 0;
  quantize_packed_kernel<<<static_cast<unsigned int>(rows), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      x, base, n, q, scales);
  return static_cast<int>(cudaGetLastError());
}

// q: (n,) int8; scales: (n_scales,) float32; base: (n,) float32 or null;
// out: (n,) float32.
int ffly_dequantize_packed(const int8_t* q, const float* scales,
                           long long n_scales, const float* base,
                           long long n, float* out, void* stream) {
  if (n == 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 65536) blocks = 65536;
  dequantize_packed_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      q, scales, n_scales, base, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
