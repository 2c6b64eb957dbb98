// fused_expand: one pass over a (B, M) candidate batch emits
//   dists[b, m]     = ||q_b - corpus[id]||^2           (+inf for id < 0)
//   satisfied[b, m] = valid & constraint(meta[id]) & !tombstoned(id)
//   fresh[b, m]     = valid & visited bit (b, id) clear
//
// Replaces the TPU kernel repro/kernels/fused_expand/fused_expand.py
// (fused_expand_kernel, exact rows). Like gather_distance it is bound by
// device-memory bytes: the d-float row dominates, plus one 4-byte meta word,
// one visited word and one label word (or the two range bounds) per
// candidate. Design: the gather_distance layout (block = one query row and
// kWarps candidates, one warp per candidate, the shared sqdist.cuh
// reduction, so fused and unfused distances are identical bits); lane 0
// issues the meta and visited loads before the row reduction so they
// overlap it, then evaluates the verdicts (probe.cuh, shared with
// fused_expand_adc.cu) and writes the two bool masks. Templated on the
// family (label / range / udf) and on the tombstone probe.
#include <cuda_runtime.h>

#include <algorithm>

#include "grid.cuh"
#include "probe.cuh"
#include "sqdist.cuh"

namespace {

constexpr int kWarps = 8;

template <int FAMILY, bool WITH_TOMB>
__global__ void __launch_bounds__(kWarps * repro_torch::kWarpSize)
fused_expand_kernel(const float* __restrict__ queries, const float* __restrict__ corpus,
                    const int* __restrict__ ids, const int* __restrict__ visited,
                    const int* __restrict__ meta, const int* __restrict__ cons,
                    const int* __restrict__ tomb, float* __restrict__ dists,
                    bool* __restrict__ sat, bool* __restrict__ fresh, int M, int d, int W,
                    int Lw, bool vec4) {
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
    if (lane == 0) {
      dists[slot] = __int_as_float(0x7f800000);
      sat[slot] = false;
      fresh[slot] = false;
    }
    return;
  }
  repro_torch::Probe probe{};
  if (lane == 0) probe = repro_torch::probe_load<WITH_TOMB>(visited, meta, tomb, b, W, id);
  const float dist =
      repro_torch::warp_sqdist(q, corpus + static_cast<size_t>(id) * d, d, vec4, lane);
  if (lane != 0) return;
  bool ok, fr;
  repro_torch::probe_verdicts<FAMILY, WITH_TOMB>(probe, cons, b, Lw, id, &ok, &fr);
  dists[slot] = dist;
  sat[slot] = ok;
  fresh[slot] = fr;
}

}  // namespace

// family: 0 label (meta int32 labels, cons (B, Lw) int32 words), 1 range
// (meta float32 values, cons (B, 2) float32 bounds), 2 udf (meta int32
// verdicts, cons unused). tomb may be null when with_tomb is 0. The queries
// ride grid y, so a batch past kGridY (65,535) launches in chunks of queries
// with the per-query arrays offset; each output row depends only on its own
// inputs, so the bits are those of one launch.
extern "C" int repro_fused_expand(const float* queries, const float* corpus, const int* ids,
                                  const int* visited, const void* meta, const void* cons,
                                  const int* tomb, float* dists, bool* sat, bool* fresh, int B,
                                  int M, int d, int W, int Lw, int family, int with_tomb,
                                  int vec4, void* stream) {
  if (B == 0 || M == 0) return 0;
  const size_t smem = static_cast<size_t>((d + 3) / 4) * sizeof(float4);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* mt = static_cast<const int*>(meta);
  const int* cs = static_cast<const int*>(cons);
  const size_t cons_row = repro_torch::cons_words(family, Lw);
  for (long long b0 = 0; b0 < B; b0 += repro_torch::kGridY) {
    const size_t r = static_cast<size_t>(b0);
    const unsigned nb = static_cast<unsigned>(std::min<long long>(B - b0, repro_torch::kGridY));
    const dim3 grid((M + kWarps - 1) / kWarps, nb);
    const int status = repro_torch::with_family(family, with_tomb, [&](auto fam, auto tmb) {
      fused_expand_kernel<decltype(fam)::value, decltype(tmb)::value>
          <<<grid, kWarps * repro_torch::kWarpSize, smem, s>>>(
              queries + r * d, corpus, ids + r * M, visited + r * W, mt, cs + r * cons_row,
              tomb, dists + r * M, sat + r * M, fresh + r * M, M, d, W, Lw, vec4 != 0);
    });
    if (status != 0) return status;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
