// gather_distance: D[b, m] = ||q_b - corpus[ids[b, m]]||^2, +inf for ids < 0.
//
// Replaces the TPU kernel repro/kernels/gather_distance/gather_distance.py
// (gather_distance_kernel). The work is a gather of one d-float row per
// candidate, so it is bound by device-memory bytes (B*M*d*4 read when no
// row repeats), not by its 3*d operations a candidate. What holds a gather
// back on this card is the number of row requests in flight, so a warp
// issues the rows of several candidates before it reduces any (PERF.md,
// Findings, holds the designs measured).
//
// Design (the register path, d % 4 == 0 with 16-byte aligned rows and
// queries, d <= 4 * 32 * kMaxNV): each warp owns a tile of C candidates of
// one query; a block's tile_warps warps serve tiles of one query, on grid x,
// and the queries ride grid y and z (grid.cuh), so B takes any size. A
// warp keeps its query row in registers (NV float4s a lane: 1 at d = 128,
// 2 at d = 256), reads its candidates' ids with one coalesced load, and
// issues all its candidates' row loads (NV * C float4s a lane) before any
// reduction; the candidates' xor butterflies are interleaved. There is no
// shared memory and no barrier. C follows the launch's size: NV * C =
// rows_in_flight float4s a lane (4 by default, 2 KB a warp) below
// kLargeLaunch candidates, where more warps with fewer rows each finish
// sooner (the search's 256 x 32), and kRowsLarge = 8 (4 KB a warp) from
// there on (NN-descent's rounds). Every other d (not a multiple of 4,
// unaligned rows, or d > 256, up to MAX_DIM = 12288) takes the
// shared-memory path: a block of kSmemWarps candidates of one query with
// the query row staged once in shared memory, one warp a candidate.
//
// The register path's block shape is a point of the tuner's lattice
// (tune/config.py::LATTICE: warps a block TW, rows in flight), passed by
// the wrapper from the tuning table; every point is instantiated as
// template arguments and gives the same bits (the order is RowTile's,
// whatever the tile). fused_expand.cu keeps the default shape.
//
// Both paths are sqdist.cuh's (RowTile, and warp_sqdist on the
// shared-memory path), which fused_expand.cu runs too, so the two kernels
// and both paths give the same bits. A padding id writes +inf without
// touching the corpus.
#include <cuda_runtime.h>

#include <type_traits>
#include <utility>

#include "grid.cuh"
#include "sqdist.cuh"

namespace {

// The tuning lattice; tests/test_torch_tune.py holds it to LATTICE.
using TileWarpsLattice = std::integer_sequence<int, 2, 4, 8>;     // tile_warps
using RowsInFlightLattice = std::integer_sequence<int, 2, 4, 8>;  // rows_in_flight

template <int... Vs>
constexpr bool in_lattice(std::integer_sequence<int, Vs...>, int v) {
  return ((v == Vs) || ...);
}

static_assert(in_lattice(TileWarpsLattice{}, repro_torch::kTileWarps) &&
                  in_lattice(RowsInFlightLattice{}, repro_torch::kRowsSmall) &&
                  in_lattice(RowsInFlightLattice{}, repro_torch::kRowsLarge),
              "the default shape and kRowsLarge must be instantiated");

// Call f(std::integral_constant<int, V>) for the V of the sequence equal to v.
template <typename F, int... Vs>
void with_value(std::integer_sequence<int, Vs...>, int v, F&& f) {
  (void)((v == Vs ? (f(std::integral_constant<int, Vs>{}), true) : false) || ...);
}

// sqdist.cuh's with_tile at a lattice point: call launch(TW, NV, C), each a
// std::integral_constant<int, ...>, with TW = tile_warps warps a block and
// NV * C = rows_in_flight float4s a lane below kLargeLaunch candidates,
// kRowsLarge from there on.
template <typename Launch>
void with_tile_config(int tile_warps, int rows_in_flight, int nv, long long cands,
                      Launch&& launch) {
  using repro_torch::tile_cands;
  const int rows = cands >= repro_torch::kLargeLaunch ? repro_torch::kRowsLarge : rows_in_flight;
  with_value(TileWarpsLattice{}, tile_warps, [&](auto tw) {
    with_value(RowsInFlightLattice{}, rows, [&](auto r) {
      constexpr int R = decltype(r)::value;
      if (nv <= 1) {
        launch(tw, std::integral_constant<int, 1>{},
               std::integral_constant<int, tile_cands(R, 1)>{});
      } else {
        launch(tw, std::integral_constant<int, 2>{},
               std::integral_constant<int, tile_cands(R, 2)>{});
      }
    });
  });
}

using repro_torch::kSmemWarps;
using repro_torch::kWarpSize;

template <int TW, int NV, int C>
__global__ void __launch_bounds__(TW * kWarpSize)
gather_distance_kernel_reg(const float* __restrict__ queries, const float* __restrict__ corpus,
                           const int* __restrict__ ids, float* __restrict__ out, int B, int M,
                           int d) {
  const long long b = repro_torch::grid_row();
  const int m0 = (blockIdx.x * TW + (threadIdx.x >> 5)) * C;
  if (b >= B || m0 >= M) return;  // whole warps leave together
  const int lane = threadIdx.x & (kWarpSize - 1);
  const int nc = min(C, M - m0);
  const size_t slot0 = static_cast<size_t>(b) * M + m0;
  const int d4 = d >> 2;

  const int my_id = lane < nc ? __ldg(ids + slot0 + lane) : -1;
  repro_torch::RowTile<NV, C> tile;
  tile.load_query(queries, b, d, lane);
  tile.load_rows(corpus, my_id, d, lane);
  const float dist = tile.reduce(d4, lane);
  // Lane c stores candidate c: one coalesced store of the warp's tile.
  if (lane < nc) out[slot0 + lane] = my_id < 0 ? __int_as_float(0x7f800000) : dist;
}

__global__ void __launch_bounds__(kSmemWarps * kWarpSize)
gather_distance_kernel_smem(const float* __restrict__ queries, const float* __restrict__ corpus,
                            const int* __restrict__ ids, float* __restrict__ out, int B, int M,
                            int d, bool vec4) {
  extern __shared__ float4 smem4[];
  float* q = reinterpret_cast<float*>(smem4);
  const long long b = repro_torch::grid_row();
  if (b >= B) return;  // the whole block
  repro_torch::load_query(q, queries, b, d);
  const int lane = threadIdx.x & (kWarpSize - 1);
  const int m = blockIdx.x * kSmemWarps + (threadIdx.x >> 5);
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

// tile_warps, rows_in_flight: a point of the tuner's lattice; any other is
// cudaErrorInvalidValue, and nothing launches.
extern "C" int repro_gather_distance(const float* queries, const float* corpus, const int* ids,
                                     float* out, int B, int M, int d, int tile_warps,
                                     int rows_in_flight, void* stream) {
  if (!in_lattice(TileWarpsLattice{}, tile_warps) ||
      !in_lattice(RowsInFlightLattice{}, rows_in_flight)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || M == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nv = repro_torch::reg_nv(queries, corpus, d);
  if (nv > 0) {
    with_tile_config(tile_warps, rows_in_flight, nv, static_cast<long long>(B) * M,
                     [&](auto tw_c, auto nv_c, auto c_c) {
      constexpr int TW = decltype(tw_c)::value;
      constexpr int C = decltype(c_c)::value;
      const int tiles = (M + C - 1) / C;
      const dim3 grid = repro_torch::rows_grid((tiles + TW - 1) / TW, B);
      gather_distance_kernel_reg<TW, decltype(nv_c)::value, C><<<grid, TW * kWarpSize, 0, s>>>(
          queries, corpus, ids, out, B, M, d);
    });
  } else {
    const bool vec4 = d % 4 == 0 && repro_torch::aligned16(corpus);
    const dim3 grid = repro_torch::rows_grid((M + kSmemWarps - 1) / kSmemWarps, B);
    const size_t smem = static_cast<size_t>((d + 3) / 4) * sizeof(float4);
    gather_distance_kernel_smem<<<grid, kSmemWarps * kWarpSize, smem, s>>>(
        queries, corpus, ids, out, B, M, d, vec4);
  }
  return static_cast<int>(cudaGetLastError());
}
