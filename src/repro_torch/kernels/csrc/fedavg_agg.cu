// Streaming weighted sums of E stacked parameter vectors, two kernels:
//
//   fedavg_agg      out = w @ stacked, w normalized on the host: the FedAvg
//                   round barrier (paper Step 5). Replaces the Pallas TPU
//                   kernel src/repro/kernels/fedavg_agg/fedavg_agg.py:
//                   fedavg_agg (_agg_kernel).
//   fedavg_agg_mix  out = keep * g + w @ stacked, w the unnormalized
//                   effective FedAsync coefficients and keep = 1 - sum(w)
//                   computed on the host: one pass folds a whole flush
//                   window into the global vector. Replaces fedavg_agg_mix
//                   (_mix_kernel) of the same file.
//
// What bounds it on Hopper: memory. It reads E*N floats and writes N,
// with 2E flops per output — far below the card's ops:byte balance. The
// TPU kernel streamed (E, 4096) tiles through VMEM; here each thread owns
// output elements (grid-stride) and walks the E rows at its column, so
// every load of a warp is one coalesced 128-byte line along N and each
// input byte is read once. The E weights are read through the read-only
// cache. The sum is fp32 in row order e = 0..E-1, each product and sum
// rounded separately (no FMA), the order of repro.core.fedavg.fedavg.
// The mix adds keep * g last, again rounded separately, so it equals its
// plain version (kernels/fedavg_agg/ref.py) bit for bit. The TPU kernel
// padded N to its 4096-column block; here the grid-stride loop masks the
// ragged end, so nothing is padded or copied.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// kMix = false: fedavg_agg (g and keep unused); true: fedavg_agg_mix.
template <bool kMix>
__global__ void __launch_bounds__(kThreads)
weighted_sum_kernel(const float* __restrict__ g,
                    const float* __restrict__ stacked,
                    const float* __restrict__ w, float keep, int E,
                    long long N, float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < N; i += stride) {
    float acc = 0.0f;
    for (int e = 0; e < E; ++e)
      acc = __fadd_rn(acc, __fmul_rn(__ldg(w + e), stacked[e * N + i]));
    out[i] = kMix ? __fadd_rn(__fmul_rn(keep, g[i]), acc) : acc;
  }
}

unsigned int grid_for(long long N) {
  long long blocks = (N + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(blocks > 65536 ? 65536 : blocks);
}

}  // namespace

extern "C" {

// stacked: (E, N) float32 row-major; w: (E,) float32; out: (N,) float32.
// Returns the launch's cudaError_t.
int ffly_fedavg_agg(const float* stacked, const float* w, int E,
                    long long N, float* out, void* stream) {
  if (N == 0) return 0;
  weighted_sum_kernel<false><<<grid_for(N), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      nullptr, stacked, w, 0.0f, E, N, out);
  return static_cast<int>(cudaGetLastError());
}

// g: (N,) float32; stacked: (E, N) float32 row-major; w: (E,) float32;
// out: (N,) float32. Returns the launch's cudaError_t.
int ffly_fedavg_agg_mix(const float* g, const float* stacked, const float* w,
                        float keep, int E, long long N, float* out,
                        void* stream) {
  if (N == 0) return 0;
  weighted_sum_kernel<true><<<grid_for(N), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      g, stacked, w, keep, E, N, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
