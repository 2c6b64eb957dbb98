// gather_distance: D[b, m] = ||q_b - corpus[ids[b, m]]||^2, +inf for ids < 0.
//
// Replaces the TPU kernel repro/kernels/gather_distance/gather_distance.py
// (gather_distance_kernel). The work is a gather of one d-float row per
// candidate, so it is bound by device-memory bytes (B*M*d*4 read), not by
// its 3*d operations a candidate. Design: a block serves one query row and
// a tile of kWarps candidates; the query row goes once into shared memory;
// one warp per candidate reads the id once and streams the row coalesced
// (float4 a lane), then reduces in a fixed order (sqdist.cuh). A padding id
// writes +inf without touching the corpus.
#include <cuda_runtime.h>

#include "sqdist.cuh"

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * repro_torch::kWarpSize)
gather_distance_kernel(const float* __restrict__ queries, const float* __restrict__ corpus,
                       const int* __restrict__ ids, float* __restrict__ out, int M, int d,
                       bool vec4) {
  extern __shared__ float4 smem4[];
  float* q = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.y;
  repro_torch::load_query(q, queries, b, d);
  const int lane = threadIdx.x & (repro_torch::kWarpSize - 1);
  const int m = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (m >= M) return;
  const size_t slot = static_cast<size_t>(b) * M + m;
  const int id = ids[slot];
  if (id < 0) {
    if (lane == 0) out[slot] = __int_as_float(0x7f800000);
    return;
  }
  const float dist =
      repro_torch::warp_sqdist(q, corpus + static_cast<size_t>(id) * d, d, vec4, lane);
  if (lane == 0) out[slot] = dist;
}

}  // namespace

extern "C" int repro_gather_distance(const float* queries, const float* corpus, const int* ids,
                                     float* out, int B, int M, int d, int vec4, void* stream) {
  if (B == 0 || M == 0) return 0;
  const dim3 grid((M + kWarps - 1) / kWarps, B);
  const size_t smem = static_cast<size_t>((d + 3) / 4) * sizeof(float4);
  gather_distance_kernel<<<grid, kWarps * repro_torch::kWarpSize, smem,
                           static_cast<cudaStream_t>(stream)>>>(queries, corpus, ids, out, M, d,
                                                                vec4 != 0);
  return static_cast<int>(cudaGetLastError());
}
