// gather_distance: D[b, m] = ||q_b - corpus[ids[b, m]]||^2, +inf for ids < 0.
//
// Replaces the TPU kernel repro/kernels/gather_distance/gather_distance.py
// (gather_distance_kernel). The work is a gather of one d-float row per
// candidate, so it is bound by device-memory bytes (B*M*d*4 read when no
// row repeats), not by its 3*d operations a candidate. What holds a gather
// back on this card is the number of row requests in flight: at the
// NN-descent build's 65,535 x 128 candidates the earlier design (one block
// per query row and 8 candidates, the query staged in shared memory behind
// a __syncthreads, one 512-byte row request per warp) kept one row a warp
// in flight and paid a block's set-up for every 4 KB of rows.
//
// Design (the register path, d % 4 == 0 with 16-byte aligned rows and
// queries, d <= 4 * 32 * kMaxNV): each warp owns a tile of C candidates of
// one query; a block's kWarps warps serve tiles of one query, on grid x,
// and the queries ride grid y and z (grid.cuh), so B takes any size. A
// warp keeps its query row in registers (NV float4s a lane: 1 at d = 128,
// 2 at d = 256), reads its candidates' ids with one coalesced load, and
// issues all its candidates' row loads (NV * C float4s a lane) before any
// reduction; the candidates' xor butterflies are interleaved. There is no
// shared memory and no barrier. C follows the launch's size: NV * C = 4
// float4s a lane (2 KB a warp) below kLargeLaunch candidates, where more
// warps with fewer rows each finish sooner (the search's 256 x 32), and 8
// (4 KB a warp) from there on (NN-descent's rounds). Every other d (not a
// multiple of 4, unaligned rows, or d > 256, up to MAX_DIM = 12288) takes
// the shared-memory path: a block of kSmemWarps candidates of one query
// with the query row staged once in shared memory, one warp a candidate.
//
// Both paths add in warp_sqdist's order (sqdist.cuh): lane l owns the
// float4s l, l + 32, ... (elements l, l + 32, ... on the scalar path) and
// adds their squared differences in ascending order with rounded fused
// multiply-adds, then the fixed xor butterfly sums the 32 partials. So the
// register path gives the same bits as the shared-memory path and as
// fused_expand.cu, which calls warp_sqdist. A padding id writes +inf
// without touching the corpus.
#include <cuda_runtime.h>

#include <cstdint>

#include "grid.cuh"
#include "sqdist.cuh"

namespace {

constexpr int kWarps = 4;      // warps a block
constexpr int kRowsSmall = 4;  // float4s a lane holds in flight (NV * C), small launches
constexpr int kRowsLarge = 8;  // the same from kLargeLaunch candidates on
constexpr long long kLargeLaunch = 1 << 20;
constexpr int kMaxNV = 2;      // register path up to d = 4 * 32 * kMaxNV = 256
constexpr int kSmemWarps = 8;  // shared-memory path: candidates (warps) a block

// Candidates a warp owns when each lane holds `rows` float4s in flight.
constexpr int cands(int rows, int nv) { return rows > nv ? rows / nv : 1; }

template <int NV, int C>
__global__ void __launch_bounds__(kWarps * repro_torch::kWarpSize)
gather_distance_kernel_reg(const float* __restrict__ queries, const float* __restrict__ corpus,
                           const int* __restrict__ ids, float* __restrict__ out, int B, int M,
                           int d) {
  const long long b = repro_torch::grid_row();
  const int m0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * C;
  if (b >= B || m0 >= M) return;  // whole warps leave together
  const int lane = threadIdx.x & (repro_torch::kWarpSize - 1);
  const int nc = min(C, M - m0);
  const size_t slot0 = static_cast<size_t>(b) * M + m0;
  const int d4 = d >> 2;

  const int my_id = lane < nc ? __ldg(ids + slot0 + lane) : -1;
  const float4* q4 = reinterpret_cast<const float4*>(queries + static_cast<size_t>(b) * d);
  float4 q[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int k = lane + j * repro_torch::kWarpSize;
    q[j] = k < d4 ? __ldg(q4 + k) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  int id[C];
#pragma unroll
  for (int c = 0; c < C; ++c) id[c] = __shfl_sync(repro_torch::kFullMask, my_id, c);

  // Every row load of the warp is issued before the first reduction.
  float4 r[C][NV];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float4* row4 = reinterpret_cast<const float4*>(corpus + static_cast<size_t>(
                                                                      max(id[c], 0)) * d);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int k = lane + j * repro_torch::kWarpSize;
      r[c][j] = (id[c] >= 0 && k < d4) ? __ldg(row4 + k) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    acc[c] = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (lane + j * repro_torch::kWarpSize < d4) {
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
  for (int off = repro_torch::kWarpSize / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      acc[c] = __fadd_rn(acc[c], __shfl_xor_sync(repro_torch::kFullMask, acc[c], off));
    }
  }
  // Lane c stores candidate c: one coalesced store of the warp's tile.
  float mine = acc[0];
#pragma unroll
  for (int c = 1; c < C; ++c) mine = lane == c ? acc[c] : mine;
  if (lane < nc) out[slot0 + lane] = my_id < 0 ? __int_as_float(0x7f800000) : mine;
}

__global__ void __launch_bounds__(kSmemWarps * repro_torch::kWarpSize)
gather_distance_kernel_smem(const float* __restrict__ queries, const float* __restrict__ corpus,
                            const int* __restrict__ ids, float* __restrict__ out, int B, int M,
                            int d, bool vec4) {
  extern __shared__ float4 smem4[];
  float* q = reinterpret_cast<float*>(smem4);
  const long long b = repro_torch::grid_row();
  if (b >= B) return;  // the whole block
  repro_torch::load_query(q, queries, static_cast<int>(b), d);
  const int lane = threadIdx.x & (repro_torch::kWarpSize - 1);
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

template <int NV, int C>
void launch_reg_c(const float* queries, const float* corpus, const int* ids, float* out, int B,
                  int M, int d, cudaStream_t s) {
  const int tiles = (M + C - 1) / C;
  const dim3 grid = repro_torch::rows_grid((tiles + kWarps - 1) / kWarps, B);
  gather_distance_kernel_reg<NV, C><<<grid, kWarps * repro_torch::kWarpSize, 0, s>>>(
      queries, corpus, ids, out, B, M, d);
}

// A small launch (the search's B x M) spreads over more warps with fewer
// candidates each; a large one (NN-descent's rounds) keeps more rows in
// flight per warp.
template <int NV>
void launch_reg(const float* queries, const float* corpus, const int* ids, float* out, int B,
                int M, int d, cudaStream_t s) {
  if (static_cast<long long>(B) * M >= kLargeLaunch) {
    launch_reg_c<NV, cands(kRowsLarge, NV)>(queries, corpus, ids, out, B, M, d, s);
  } else {
    launch_reg_c<NV, cands(kRowsSmall, NV)>(queries, corpus, ids, out, B, M, d, s);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" int repro_gather_distance(const float* queries, const float* corpus, const int* ids,
                                     float* out, int B, int M, int d, void* stream) {
  if (B == 0 || M == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = d % 4 == 0 && aligned16(corpus);
  if (vec4 && aligned16(queries) && d <= 4 * repro_torch::kWarpSize * kMaxNV) {
    const int nv = (d / 4 + repro_torch::kWarpSize - 1) / repro_torch::kWarpSize;
    if (nv <= 1) {
      launch_reg<1>(queries, corpus, ids, out, B, M, d, s);
    } else {
      launch_reg<2>(queries, corpus, ids, out, B, M, d, s);
    }
  } else {
    const dim3 grid = repro_torch::rows_grid((M + kSmemWarps - 1) / kSmemWarps, B);
    const size_t smem = static_cast<size_t>((d + 3) / 4) * sizeof(float4);
    gather_distance_kernel_smem<<<grid, kSmemWarps * repro_torch::kWarpSize, smem, s>>>(
        queries, corpus, ids, out, B, M, d, vec4);
  }
  return static_cast<int>(cudaGetLastError());
}
