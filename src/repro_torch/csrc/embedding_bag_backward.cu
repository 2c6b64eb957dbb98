// embedding_bag_backward: the table's gradient of a sum-mode bag,
// d_table[r] = sum of g[b] over every (b, l) with ids[b, l] == r.
//
// Replaces no TPU kernel: the reference differentiates the jnp take + mask +
// sum of models/recsys/models.py::embedding_bag_sum, whose gradient XLA
// scatters into a dense (V, D) table. The port's forward bag is a CUDA kernel
// (embedding_bag.cu), so its backward is one too. PyTorch's index_add_ of
// the masked rows would build the (B * L, D) rows whole (3.4 GB at the
// two-tower train batch) and add them with atomics in no fixed order.
//
// Bound by device-memory bytes: the dense (V, D) float32 output is written
// once (4.1 GB at a 4M-row table), the (B, D) upstream gradient and the ids
// are read; one add per float read. Design: the wrapper sorts the flattened
// keys (ids clamped to V - 1, padding mapped to V) stably with torch.sort,
// so each run of equal ids holds its positions in row-major (b, l) order.
// Then two kernels, and every byte of their outputs is written once:
//
//   * row_bounds: the (V + 1,) int32 CSR offsets of the sorted keys, row r's
//     run being [bounds[r], bounds[r + 1]). Sorted position i (and a last,
//     virtual position n of key V) writes i into every row in (the previous
//     key, its key]: a run's first position the rows it starts and the empty
//     rows before it, position n the rows after the last valid key. No
//     zeroing pass and no search. A gap of more than 32 rows (a sparse
//     table, all-padding batches) is filled by its whole block, coalesced.
//   * dense_rows: one warp a chunk of 32 rows of the output, rows in order
//     (a grid-stride loop over the chunks), kDepth g rows in flight. The
//     warp adds the g rows of its run left to right from
//     +0.0, one rounded add at a time (__fadd_rn), the order of the plain
//     version (kernels/embedding_bag.py::embedding_bag_backward_plain), and
//     stores the row once; an empty row stores zeros. The stores are
//     streaming (__stcs, evict-first), so the output passes L2 once and does
//     not evict the upstream gradient that the reads reuse. Those reads are
//     random rows of g (67 MB at the train bag, past the 50 MB L2), so the
//     columns are walked in slabs, one launch a slab, each slab's columns of
//     g small enough to stay in L2 (the wrapper sizes it): each element of
//     the output is still written once. Lanes span the slab, four floats a
//     lane (float4) where D % 4 == 0 and the pointers are 16-byte aligned,
//     one float otherwise; a slab wider than a warp's span is walked in
//     spans, re-reading the run's positions.
//
// Row offsets are 64-bit (a 4M x 256 table holds 1.0e9 floats).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;          // warps a block, each on 32 output rows
constexpr int kBoundsThreads = 256;
constexpr int kShortGap = 32;      // rows a thread fills alone
constexpr long long kMaxBlocks = 16384;
constexpr int kDepth = 2;          // g rows a warp loads before adding them

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static T add(T a, T b) {
    return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                       __fadd_rn(a.w, b.w));
  }
};
template <>
struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static T add(T a, T b) { return __fadd_rn(a, b); }
};

// keys: (n,) int32 sorted, in [0, V] (V for padding); bounds: (V + 1,).
// Thread i in [0, n] writes i into rows (key[i - 1], key[i]], with key[-1]
// = -1 and key[n] = V; the rows of the sorted keys' gaps are disjoint and
// cover [0, V], so every entry is written once. A gap of more than
// kShortGap rows is listed in shared memory and filled by the whole block.
__global__ void __launch_bounds__(kBoundsThreads)
row_bounds_kernel(const int* __restrict__ keys, int* __restrict__ bounds, long long n,
                  long long V) {
  __shared__ long long gap_lo[kBoundsThreads], gap_hi[kBoundsThreads];
  __shared__ int gap_at[kBoundsThreads];
  __shared__ int n_gaps;
  if (threadIdx.x == 0) n_gaps = 0;
  __syncthreads();
  const long long i = static_cast<long long>(blockIdx.x) * kBoundsThreads + threadIdx.x;
  long long lo = 0, hi = -1;  // rows [lo, hi] take i
  if (i <= n) {
    lo = (i > 0 ? static_cast<long long>(__ldg(keys + i - 1)) : -1LL) + 1;
    hi = i < n ? static_cast<long long>(__ldg(keys + i)) : V;
  }
  const long long len = hi - lo + 1;
  if (len > kShortGap) {
    const int at = atomicAdd(&n_gaps, 1);
    gap_lo[at] = lo;
    gap_hi[at] = hi;
    gap_at[at] = static_cast<int>(i);
  } else {
    for (long long r = lo; r <= hi; ++r) bounds[r] = static_cast<int>(i);
  }
  __syncthreads();
  for (int k = 0; k < n_gaps; ++k) {
    const int v = gap_at[k];
    for (long long r = gap_lo[k] + threadIdx.x; r <= gap_hi[k]; r += kBoundsThreads) bounds[r] = v;
  }
}

// bounds: (V + 1,) CSR offsets into the sorted order; pos: (n,) int64 flat
// positions b * L + l in the sorted order; g: (B, D); out: (V, D), its
// vector columns [c0, c1) written whole. A warp takes 32 rows at a time:
// one coalesced load of their offsets, their sorted positions' bags 32 at a
// time (one coalesced load, then shuffles), and kDepth g rows in flight
// before any is added; a row is stored once its run has been added, the
// empty rows between as zeros.
template <int VEC, int K>
__global__ void __launch_bounds__(kWarps * 32)
dense_rows_kernel(const int* __restrict__ bounds, const long long* __restrict__ pos,
                  const float* __restrict__ g, float* __restrict__ out, int L, int D,
                  long long V, int c0, int c1) {
  using V_ = Vec<VEC>;
  using T = typename V_::T;
  constexpr int kSpan = 32 * K;  // vectors a lane-span of D
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const T* rows = reinterpret_cast<const T*>(g);
  const int dv = D / VEC;
  const long long chunks = (V + 31) / 32;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;

  for (long long c = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       c < chunks; c += stride) {
    const long long r0 = c * 32;
    const int nrows = static_cast<int>(V - r0 < 32 ? V - r0 : 32);
    const int start = lane < nrows ? __ldg(bounds + r0 + lane) : 0;  // row r0 + lane's run
    const int last = __ldg(bounds + r0 + nrows);                      // the chunk's end
    const int s0 = __shfl_sync(kAll, start, 0);
    for (int d0 = c0; d0 < c1; d0 += kSpan) {
      T acc[K];
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] = V_::zero();
      int row = 0;
      int row_end = __shfl_sync(kAll, start, 1 < nrows ? 1 : 0);
      if (nrows == 1) row_end = last;
      auto store = [&](int at) {
        T* dst = reinterpret_cast<T*>(out + (r0 + at) * D);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int v = k * 32 + lane;
          if (d0 + v < c1) __stcs(dst + d0 + v, acc[k]);
          acc[k] = V_::zero();
        }
      };
      long long bag = 0;
      for (int j0 = s0; j0 < last; j0 += kDepth) {
        const int w = (j0 - s0) & 31;  // kDepth divides 32: a group stays in one window
        if (w == 0) bag = j0 + lane < last ? __ldg(pos + j0 + lane) / L : 0;
        T val[kDepth][K];
#pragma unroll
        for (int u = 0; u < kDepth; ++u) {
          const long long b = __shfl_sync(kAll, bag, w + u);
          const T* src = rows + b * dv + d0;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int v = k * 32 + lane;
            val[u][k] = (j0 + u < last && d0 + v < c1) ? __ldg(src + v) : V_::zero();
          }
        }
#pragma unroll
        for (int u = 0; u < kDepth; ++u) {
          if (j0 + u >= last) break;
          while (row_end <= j0 + u) {  // rows whose runs end before this position
            store(row);
            ++row;
            row_end = __shfl_sync(kAll, start, row + 1 < nrows ? row + 1 : 0);
            if (row + 1 >= nrows) row_end = last;
          }
#pragma unroll
          for (int k = 0; k < K; ++k) acc[k] = V_::add(acc[k], val[u][k]);
        }
      }
      for (; row < nrows; ++row) store(row);
    }
  }
}

}  // namespace

// keys (n,) int32 sorted ascending (ids clamped to V - 1, padding V) ->
// bounds (V + 1,) int32, row r's run of the sorted order being [bounds[r],
// bounds[r + 1]). n < 2**31 - 1.
extern "C" int repro_embedding_bag_row_bounds(const int* keys, int* bounds, long long n,
                                              long long V, void* stream) {
  if (n < 0 || n >= 0x7fffffffLL || V < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + 1 + kBoundsThreads - 1) / kBoundsThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  row_bounds_kernel<<<static_cast<unsigned>(blocks), kBoundsThreads, 0, s>>>(keys, bounds, n, V);
  return static_cast<int>(cudaGetLastError());
}

// bounds (V + 1,) int32 (repro_embedding_bag_row_bounds), pos (n,) int64
// (b * L + l of each sorted key, row-major order within a run), g (B, D)
// float32, out (V, D) float32, every element written, in slabs of ``slab``
// columns (a multiple of 4 where vec4), one launch a slab. vec4: D % 4 == 0
// and g and out 16-byte aligned.
extern "C" int repro_embedding_bag_backward(const int* bounds, const long long* pos,
                                            const float* g, float* out, int L, int D,
                                            long long V, int vec4, int slab, void* stream) {
  if (L < 1 || D < 0 || V < 1 || slab < 1 || (vec4 && slab % 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (D == 0) return 0;
  long long blocks = ((V + 31) / 32 + kWarps - 1) / kWarps;  // a warp a chunk of 32 rows
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = vec4 ? 4 : 1;
  for (int c0 = 0; c0 < D; c0 += slab) {
    const int c1 = c0 + slab < D ? c0 + slab : D;
    if (vec4) {
      dense_rows_kernel<4, 2><<<grid, block, 0, s>>>(bounds, pos, g, out, L, D, V, c0 / vec,
                                                      c1 / vec);
    } else {
      dense_rows_kernel<1, 4><<<grid, block, 0, s>>>(bounds, pos, g, out, L, D, V, c0, c1);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
