// Squared L2 by one warp: the gather-and-reduce core of gather_distance.cu
// and fused_expand.cu.
//
// Both kernels run this code, on both of their paths, so the unfused
// (gather_distance) and fused (fused_expand) search paths produce identical
// distance bits on the card by construction. The order: lane l owns the
// float4s l, l + 32, ... of the row (elements l, l + 32, ... on the scalar
// path) and adds their squared differences in ascending order with explicit
// fused multiply-adds (no contraction left to the compiler); then an xor
// butterfly sums the 32 partials in a fixed order. Addition is commutative
// in IEEE arithmetic, so every lane ends with the same value.
//
// Two paths share that order. The register path (RowTile: d % 4 == 0,
// 16-byte aligned rows and query, d <= 4 * 32 * kMaxNV = 256) gives a warp
// a tile of C candidates of one query, keeps the query row in registers (NV
// float4s a lane), and issues every row load of the tile before the first
// reduction; the C butterflies are interleaved. The shared-memory path
// (warp_sqdist_partial + warp_sum: every other d, up to MAX_DIM) gives a
// warp one candidate, with the query row staged in shared memory.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace repro_torch {

constexpr int kWarpSize = 32;
constexpr unsigned kFullMask = 0xffffffffu;

constexpr int kTileWarps = 4;      // register path: warps a block
constexpr int kRowsSmall = 4;      // float4s a lane holds in flight (NV * C), small launches
constexpr int kRowsLarge = 8;      // the same from kLargeLaunch candidates on
constexpr long long kLargeLaunch = 1 << 20;
constexpr int kMaxNV = 2;          // register path up to d = 4 * 32 * kMaxNV = 256
constexpr int kSmemWarps = 8;      // shared-memory path: candidates (warps) a block

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// float4s a lane holds of the query row on the register path (1 or 2), or
// 0 where the shared-memory path serves the launch.
inline int reg_nv(const float* queries, const float* corpus, int d) {
  if (d % 4 != 0 || d > 4 * kWarpSize * kMaxNV || !aligned16(queries) || !aligned16(corpus)) {
    return 0;
  }
  return (d / 4 + kWarpSize - 1) / kWarpSize;
}

// Candidates a warp owns when each lane holds `rows` float4s in flight.
constexpr int tile_cands(int rows, int nv) { return rows > nv ? rows / nv : 1; }

// Call launch(std::integral_constant<int, NV>, std::integral_constant<int, C>)
// for nv (1 or 2) and the C of a launch of `cands` candidates: a small
// launch (the search's B x M) spreads over more warps with fewer candidates
// each, a large one (NN-descent's rounds) keeps more rows in flight a warp.
template <typename Launch>
inline void with_tile(int nv, long long cands, Launch&& launch) {
  using N1 = std::integral_constant<int, 1>;
  using N2 = std::integral_constant<int, 2>;
  const bool large = cands >= kLargeLaunch;
  if (nv <= 1) {
    large ? launch(N1{}, std::integral_constant<int, tile_cands(kRowsLarge, 1)>{})
          : launch(N1{}, std::integral_constant<int, tile_cands(kRowsSmall, 1)>{});
  } else {
    large ? launch(N2{}, std::integral_constant<int, tile_cands(kRowsLarge, 2)>{})
          : launch(N2{}, std::integral_constant<int, tile_cands(kRowsSmall, 2)>{});
  }
}

// The register path's tile: C candidates of one query, lane c holding
// candidate c's id. The kernel calls load_query, load_rows and reduce in
// that order and may issue its own loads in between.
template <int NV, int C>
struct RowTile {
  float4 q[NV];
  float4 r[C][NV];

  __device__ __forceinline__ void load_query(const float* __restrict__ queries, long long b,
                                             int d, int lane) {
    const float4* q4 = reinterpret_cast<const float4*>(queries + static_cast<size_t>(b) * d);
    const int d4 = d >> 2;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int k = lane + j * kWarpSize;
      q[j] = k < d4 ? __ldg(q4 + k) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }

  // Every row load of the tile; an id < 0 loads nothing. The ids are
  // shuffled out first and the loads issued back to back: with a shuffle
  // between loads the compiler issued the last row after the first
  // reduction's wait, one more device-memory trip.
  __device__ __forceinline__ void load_rows(const float* __restrict__ corpus, int my_id, int d,
                                            int lane) {
    const int d4 = d >> 2;
    int id[C];
#pragma unroll
    for (int c = 0; c < C; ++c) id[c] = __shfl_sync(kFullMask, my_id, c);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float4* row4 =
          reinterpret_cast<const float4*>(corpus + static_cast<size_t>(max(id[c], 0)) * d);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int k = lane + j * kWarpSize;
        r[c][j] = (id[c] >= 0 && k < d4) ? __ldg(row4 + k)
                                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
  }

  // Candidate `lane`'s squared distance in lanes 0 .. C - 1.
  __device__ __forceinline__ float reduce(int d4, int lane) const {
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      acc[c] = 0.0f;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (lane + j * kWarpSize < d4) {
          float t = r[c][j].x - q[j].x;
          acc[c] = __fmaf_rn(t, t, acc[c]);
          t = r[c][j].y - q[j].y;
          acc[c] = __fmaf_rn(t, t, acc[c]);
          t = r[c][j].z - q[j].z;
          acc[c] = __fmaf_rn(t, t, acc[c]);
          t = r[c][j].w - q[j].w;
          acc[c] = __fmaf_rn(t, t, acc[c]);
        }
      }
    }
#pragma unroll
    for (int off = kWarpSize / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        acc[c] = __fadd_rn(acc[c], __shfl_xor_sync(kFullMask, acc[c], off));
      }
    }
    float mine = acc[0];
#pragma unroll
    for (int c = 1; c < C; ++c) mine = lane == c ? acc[c] : mine;
    return mine;
  }
};

// The shared-memory path, before the butterfly: this lane's partial sum.
// q: the query row in shared memory (16-byte aligned); row: the corpus row
// in device memory. vec4: d % 4 == 0 and the corpus is 16-byte aligned, so
// each lane loads float4s; otherwise one float a lane per step.
__device__ __forceinline__ float warp_sqdist_partial(const float* __restrict__ q,
                                                     const float* __restrict__ row, int d,
                                                     bool vec4, int lane) {
  float acc = 0.0f;
  if (vec4) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    for (int k = lane; k < (d >> 2); k += kWarpSize) {
      const float4 r = __ldg(r4 + k);
      const float4 x = q4[k];
      float t = r.x - x.x;
      acc = __fmaf_rn(t, t, acc);
      t = r.y - x.y;
      acc = __fmaf_rn(t, t, acc);
      t = r.z - x.z;
      acc = __fmaf_rn(t, t, acc);
      t = r.w - x.w;
      acc = __fmaf_rn(t, t, acc);
    }
  } else {
    for (int k = lane; k < d; k += kWarpSize) {
      const float t = __ldg(row + k) - q[k];
      acc = __fmaf_rn(t, t, acc);
    }
  }
  return acc;
}

// The fixed xor butterfly over the warp's 32 partials.
__device__ __forceinline__ float warp_sum(float acc) {
#pragma unroll
  for (int off = kWarpSize / 2; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_xor_sync(kFullMask, acc, off));
  }
  return acc;
}

__device__ __forceinline__ float warp_sqdist(const float* __restrict__ q,
                                             const float* __restrict__ row, int d, bool vec4,
                                             int lane) {
  return warp_sum(warp_sqdist_partial(q, row, d, vec4, lane));
}

// Copy the query row into shared memory; every thread of the block helps.
__device__ __forceinline__ void load_query(float* q_smem, const float* __restrict__ queries,
                                           long long b, int d) {
  const float* src = queries + static_cast<size_t>(b) * d;
  for (int k = threadIdx.x; k < d; k += blockDim.x) q_smem[k] = src[k];
  __syncthreads();
}

}  // namespace repro_torch
