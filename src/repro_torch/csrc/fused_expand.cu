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
// overlap it, then evaluates the constraint and writes the two bool masks.
// Templated on the family (label / range / udf) and on the tombstone probe.
#include <cuda_runtime.h>

#include "sqdist.cuh"

namespace {

constexpr int kWarps = 8;
enum Family : int { kLabel = 0, kRange = 1, kUdf = 2 };

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
  int vword = 0, mval = 0, tword = 0;
  if (lane == 0) {
    vword = __ldg(visited + static_cast<size_t>(b) * W + (id >> 5));
    mval = __ldg(meta + id);
    if (WITH_TOMB) tword = __ldg(tomb + (id >> 5));
  }
  const float dist =
      repro_torch::warp_sqdist(q, corpus + static_cast<size_t>(id) * d, d, vec4, lane);
  if (lane != 0) return;
  const unsigned bit = static_cast<unsigned>(id) & 31u;
  bool ok;
  if (FAMILY == kLabel) {
    const int lab = mval;
    ok = false;
    if (lab >= 0 && (lab >> 5) < Lw) {
      const unsigned cw = static_cast<unsigned>(__ldg(cons + static_cast<size_t>(b) * Lw + (lab >> 5)));
      ok = ((cw >> (static_cast<unsigned>(lab) & 31u)) & 1u) != 0u;
    }
  } else if (FAMILY == kRange) {
    const float v = __int_as_float(mval);
    const float lo = __int_as_float(__ldg(cons + 2 * b));
    const float hi = __int_as_float(__ldg(cons + 2 * b + 1));
    ok = (v >= lo) && (v <= hi);
  } else {
    ok = mval != 0;
  }
  if (WITH_TOMB) ok = ok && (((static_cast<unsigned>(tword) >> bit) & 1u) == 0u);
  dists[slot] = dist;
  sat[slot] = ok;
  fresh[slot] = ((static_cast<unsigned>(vword) >> bit) & 1u) == 0u;
}

template <int FAMILY, bool WITH_TOMB>
void launch(dim3 grid, size_t smem, cudaStream_t stream, const float* queries,
            const float* corpus, const int* ids, const int* visited, const int* meta,
            const int* cons, const int* tomb, float* dists, bool* sat, bool* fresh, int M,
            int d, int W, int Lw, bool vec4) {
  fused_expand_kernel<FAMILY, WITH_TOMB><<<grid, kWarps * repro_torch::kWarpSize, smem, stream>>>(
      queries, corpus, ids, visited, meta, cons, tomb, dists, sat, fresh, M, d, W, Lw, vec4);
}

}  // namespace

// family: 0 label (meta int32 labels, cons (B, Lw) int32 words), 1 range
// (meta float32 values, cons (B, 2) float32 bounds), 2 udf (meta int32
// verdicts, cons unused). tomb may be null when with_tomb is 0.
extern "C" int repro_fused_expand(const float* queries, const float* corpus, const int* ids,
                                  const int* visited, const void* meta, const void* cons,
                                  const int* tomb, float* dists, bool* sat, bool* fresh, int B,
                                  int M, int d, int W, int Lw, int family, int with_tomb,
                                  int vec4, void* stream) {
  if (B == 0 || M == 0) return 0;
  const dim3 grid((M + kWarps - 1) / kWarps, B);
  const size_t smem = static_cast<size_t>((d + 3) / 4) * sizeof(float4);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* mt = static_cast<const int*>(meta);
  const int* cs = static_cast<const int*>(cons);
  const bool v4 = vec4 != 0;
#define REPRO_LAUNCH(F, T) \
  launch<F, T>(grid, smem, s, queries, corpus, ids, visited, mt, cs, tomb, dists, sat, fresh, M, d, W, Lw, v4)
  switch (family * 2 + (with_tomb ? 1 : 0)) {
    case 0: REPRO_LAUNCH(kLabel, false); break;
    case 1: REPRO_LAUNCH(kLabel, true); break;
    case 2: REPRO_LAUNCH(kRange, false); break;
    case 3: REPRO_LAUNCH(kRange, true); break;
    case 4: REPRO_LAUNCH(kUdf, false); break;
    case 5: REPRO_LAUNCH(kUdf, true); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
