// Streaming weighted average of E stacked parameter vectors: the FedAvg
// round barrier (paper Step 5), out = w @ stacked with w already
// normalized on the host.
//
// Replaces the Pallas TPU kernel of
// src/repro/kernels/fedavg_agg/fedavg_agg.py: fedavg_agg (_agg_kernel).
//
// What bounds it on Hopper: memory. It reads E*N floats and writes N,
// with 2E flops per output — far below the card's ops:byte balance. The
// TPU kernel streamed (E, 4096) tiles through VMEM; here each thread owns
// output elements (grid-stride) and walks the E rows at its column, so
// every load of a warp is one coalesced 128-byte line along N and each
// input byte is read once. The E weights are read through the read-only
// cache. The sum is fp32 in row order e = 0..E-1, each product and sum
// rounded separately (no FMA), the order of repro.core.fedavg.fedavg.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fedavg_agg_kernel(const float* __restrict__ stacked,
                  const float* __restrict__ w, int E, long long N,
                  float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < N; i += stride) {
    float acc = 0.0f;
    for (int e = 0; e < E; ++e)
      acc = __fadd_rn(acc, __fmul_rn(__ldg(w + e), stacked[e * N + i]));
    out[i] = acc;
  }
}

}  // namespace

extern "C" {

// stacked: (E, N) float32 row-major; w: (E,) float32; out: (N,) float32.
// Returns the launch's cudaError_t.
int ffly_fedavg_agg(const float* stacked, const float* w, int E,
                    long long N, float* out, void* stream) {
  if (N == 0) return 0;
  long long blocks = (N + kThreads - 1) / kThreads;
  if (blocks > 65536) blocks = 65536;
  fedavg_agg_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(stacked, w, E, N,
                                                           out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
