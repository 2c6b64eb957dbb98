// fused_expand: one pass over a (B, M) candidate batch emits
//   dists[b, m]     = ||q_b - corpus[id]||^2           (+inf for id < 0)
//   satisfied[b, m] = valid & constraint(meta[id]) & !tombstoned(id)
//   fresh[b, m]     = valid & visited bit (b, id) clear
//
// Replaces the TPU kernel repro/kernels/fused_expand/fused_expand.py
// (fused_expand_kernel, exact rows). Like gather_distance it is bound by
// device-memory bytes: the d-float row dominates, plus one 4-byte meta word,
// one visited word and one label word (or the two range bounds) per
// candidate. At the search's 256 x 32 candidates what it pays is latency:
// the chain of dependent memory trips from the candidate's id to its stores.
// The design keeps that chain at gather_distance's two trips (ids, then the
// rows and probes together) plus, for the label family past 32 words, the
// constraint word behind the meta word.
//
// The register path (d % 4 == 0, 16-byte aligned rows and query, d <= 256)
// is gather_distance's (sqdist.cuh's RowTile, the same tile size C from the
// same small- and large-launch rule, so the distances are the same bits by
// construction): a warp owns C candidates of one query, keeps the query row
// in registers (no shared memory, no barrier), reads the ids with one
// coalesced load and issues every row load before any reduction. Lane
// c < C owns candidate c's probes: it issues the visited, meta and
// tombstone words of candidate c beside the row loads. The query's
// constraint row is read at warp start: for Lw <= 32 label words lane l
// holds word l and the verdict takes word lab >> 5 with one shuffle; for
// longer rows the word is loaded as soon as the meta word arrives, before
// the reduction; the range bounds are two registers. Lane c then writes
// candidate c's distance and both masks, as coalesced stores of the tile.
//
// Every other d (not a multiple of 4, unaligned rows or query, d > 256, up
// to MAX_DIM) takes the shared-memory path: a block of kSmemWarps
// candidates of one query, the query row staged in shared memory, one warp
// a candidate (warp_sqdist's order, so again the same bits). The id and the
// probe loads are issued before the staging barrier, and the label word
// before the butterfly.
//
// The queries ride grid y and z (grid.cuh), so B takes any size. The
// verdicts are probe.cuh's, shared with fused_expand_adc.cu. Templated on
// the family (label / range / udf) and on the tombstone probe.
#include <cuda_runtime.h>

#include "grid.cuh"
#include "probe.cuh"
#include "sqdist.cuh"

namespace {

using repro_torch::kFullMask;
using repro_torch::kLabel;
using repro_torch::kRange;
using repro_torch::kSmemWarps;
using repro_torch::kTileWarps;
using repro_torch::kWarpSize;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

template <int NV, int C, int FAMILY, bool WITH_TOMB>
__global__ void __launch_bounds__(kTileWarps * kWarpSize)
fused_expand_kernel_reg(const float* __restrict__ queries, const float* __restrict__ corpus,
                        const int* __restrict__ ids, const int* __restrict__ visited,
                        const int* __restrict__ meta, const int* __restrict__ cons,
                        const int* __restrict__ tomb, float* __restrict__ dists,
                        bool* __restrict__ sat, bool* __restrict__ fresh, int B, int M, int d,
                        int W, int Lw) {
  const long long b = repro_torch::grid_row();
  const int m0 = (blockIdx.x * kTileWarps + (threadIdx.x >> 5)) * C;
  if (b >= B || m0 >= M) return;  // whole warps leave together
  const int lane = threadIdx.x & (kWarpSize - 1);
  const int nc = min(C, M - m0);
  const size_t slot0 = static_cast<size_t>(b) * M + m0;
  const int d4 = d >> 2;

  const int my_id = lane < nc ? __ldg(ids + slot0 + lane) : -1;
  // The query's constraint row, at warp start.
  const int* crow = cons + static_cast<size_t>(b) * repro_torch::cons_words(FAMILY, Lw);
  unsigned lane_word = 0u;
  float lo = 0.0f, hi = 0.0f;
  if (FAMILY == kLabel && Lw <= kWarpSize && lane < Lw) {
    lane_word = static_cast<unsigned>(__ldg(crow + lane));
  }
  if (FAMILY == kRange) {
    lo = __int_as_float(__ldg(crow));
    hi = __int_as_float(__ldg(crow + 1));
  }
  repro_torch::RowTile<NV, C> tile;
  tile.load_query(queries, b, d, lane);
  repro_torch::Probe p{};
  if (my_id >= 0) p = repro_torch::probe_load<WITH_TOMB>(visited, meta, tomb, b, W, my_id);
  tile.load_rows(corpus, my_id, d, lane);
  if (FAMILY == kLabel) {
    const bool in_row = repro_torch::label_in_row(p.mval, Lw);
    if (Lw <= kWarpSize) {  // the same branch for the whole warp
      const unsigned w = __shfl_sync(kFullMask, lane_word, (p.mval >> 5) & (kWarpSize - 1));
      p.cword = in_row ? w : 0u;
    } else {
      p.cword = in_row ? static_cast<unsigned>(__ldg(crow + (p.mval >> 5))) : 0u;
    }
  }
  const float dist = tile.reduce(d4, lane);
  if (lane < nc) {
    bool ok, fr;
    repro_torch::probe_verdicts<FAMILY, WITH_TOMB>(p, lo, hi, my_id, &ok, &fr);
    const bool valid = my_id >= 0;
    dists[slot0 + lane] = valid ? dist : inf();
    sat[slot0 + lane] = valid && ok;
    fresh[slot0 + lane] = valid && fr;
  }
}

template <int FAMILY, bool WITH_TOMB>
__global__ void __launch_bounds__(kSmemWarps * kWarpSize)
fused_expand_kernel_smem(const float* __restrict__ queries, const float* __restrict__ corpus,
                         const int* __restrict__ ids, const int* __restrict__ visited,
                         const int* __restrict__ meta, const int* __restrict__ cons,
                         const int* __restrict__ tomb, float* __restrict__ dists,
                         bool* __restrict__ sat, bool* __restrict__ fresh, int B, int M, int d,
                         int W, int Lw, bool vec4) {
  extern __shared__ float4 smem4[];
  float* q = reinterpret_cast<float*>(smem4);
  const long long b = repro_torch::grid_row();
  if (b >= B) return;  // the whole block
  const int lane = threadIdx.x & (kWarpSize - 1);
  const int m = blockIdx.x * kSmemWarps + (threadIdx.x >> 5);
  const bool live = m < M;
  const size_t slot = static_cast<size_t>(b) * M + m;
  // The id and lane 0's probes are in flight while the query is staged.
  const int id = live ? __ldg(ids + slot) : -1;
  const int* crow = cons + static_cast<size_t>(b) * repro_torch::cons_words(FAMILY, Lw);
  repro_torch::Probe p{};
  float lo = 0.0f, hi = 0.0f;
  if (lane == 0 && id >= 0) {
    p = repro_torch::probe_load<WITH_TOMB>(visited, meta, tomb, b, W, id);
    if (FAMILY == kRange) {
      lo = __int_as_float(__ldg(crow));
      hi = __int_as_float(__ldg(crow + 1));
    }
  }
  repro_torch::load_query(q, queries, b, d);
  if (!live) return;
  if (id < 0) {
    if (lane == 0) {
      dists[slot] = inf();
      sat[slot] = false;
      fresh[slot] = false;
    }
    return;
  }
  const float part =
      repro_torch::warp_sqdist_partial(q, corpus + static_cast<size_t>(id) * d, d, vec4, lane);
  if (FAMILY == kLabel && lane == 0) {
    p.cword = repro_torch::label_in_row(p.mval, Lw)
                  ? static_cast<unsigned>(__ldg(crow + (p.mval >> 5)))
                  : 0u;
  }
  const float dist = repro_torch::warp_sum(part);
  if (lane != 0) return;
  bool ok, fr;
  repro_torch::probe_verdicts<FAMILY, WITH_TOMB>(p, lo, hi, id, &ok, &fr);
  dists[slot] = dist;
  sat[slot] = ok;
  fresh[slot] = fr;
}

}  // namespace

// family: 0 label (meta int32 labels, cons (B, Lw) int32 words), 1 range
// (meta float32 values, cons (B, 2) float32 bounds), 2 udf (meta int32
// verdicts, cons unused). tomb may be null when with_tomb is 0.
extern "C" int repro_fused_expand(const float* queries, const float* corpus, const int* ids,
                                  const int* visited, const void* meta, const void* cons,
                                  const int* tomb, float* dists, bool* sat, bool* fresh, int B,
                                  int M, int d, int W, int Lw, int family, int with_tomb,
                                  void* stream) {
  if (B == 0 || M == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* mt = static_cast<const int*>(meta);
  const int* cs = static_cast<const int*>(cons);
  const int nv = repro_torch::reg_nv(queries, corpus, d);
  const int status = repro_torch::with_family(family, with_tomb, [&](auto fam, auto tmb) {
    constexpr int F = decltype(fam)::value;
    constexpr bool T = decltype(tmb)::value;
    if (nv > 0) {
      repro_torch::with_tile(nv, static_cast<long long>(B) * M, [&](auto nv_c, auto c_c) {
        constexpr int C = decltype(c_c)::value;
        const int tiles = (M + C - 1) / C;
        const dim3 grid = repro_torch::rows_grid((tiles + kTileWarps - 1) / kTileWarps, B);
        fused_expand_kernel_reg<decltype(nv_c)::value, C, F, T>
            <<<grid, kTileWarps * kWarpSize, 0, s>>>(queries, corpus, ids, visited, mt, cs, tomb,
                                                     dists, sat, fresh, B, M, d, W, Lw);
      });
    } else {
      const bool vec4 = d % 4 == 0 && repro_torch::aligned16(corpus);
      const dim3 grid = repro_torch::rows_grid((M + kSmemWarps - 1) / kSmemWarps, B);
      const size_t smem = static_cast<size_t>((d + 3) / 4) * sizeof(float4);
      fused_expand_kernel_smem<F, T><<<grid, kSmemWarps * kWarpSize, smem, s>>>(
          queries, corpus, ids, visited, mt, cs, tomb, dists, sat, fresh, B, M, d, W, Lw, vec4);
    }
  });
  if (status != 0) return status;
  return static_cast<int>(cudaGetLastError());
}
