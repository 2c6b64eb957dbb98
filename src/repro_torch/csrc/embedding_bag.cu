// embedding_bag: sum-mode bags, out[b] = sum_l table[ids[b, l]] over ids >= 0.
//
// Replaces the TPU kernel repro/kernels/embedding_bag/embedding_bag.py
// (embedding_bag_kernel), the history bag of the two-tower user tower.
// Bound by device-memory bytes: each valid id reads one D-float row of the
// table (1 KB at D = 256), and the rows of a serving batch are scattered
// over a table far larger than L2 (51 GB at 50M items), so every row comes
// from device memory; one add per float read is far below the card's
// operation rate. The TPU kernel's (B, L) grid, one DMA'd row per step into
// a VMEM accumulator, does not carry over. Design: one warp per bag. The
// warp reads the bag's ids 32 at a time, one per lane, and a ballot gives
// the valid ones as a bit mask, so padding rows are never loaded. Lanes
// span D, four floats a lane (float4 loads, neighbouring lanes on
// neighbouring addresses) where D % 4 == 0 and the pointers are 16-byte
// aligned, one float otherwise. kDepth rows are loaded before any is added,
// so several independent row loads of each warp are in flight. Each lane
// adds its rows in registers, left to right in l (l = 0, 1, ...), one
// rounded add at a time from +0.0, the order of the plain version
// (kernels/embedding_bag.py::embedding_bag_plain) and of the Pallas
// kernel's grid, so all three give the same bits; then one coalesced
// store. D wider than a warp's span is walked in spans of 32 * VEC * K
// floats, reading the ids again for each.
//
// Row offsets are 64-bit: the 50M-row item table holds 1.28e10 floats. Ids
// at or above V are clamped to V - 1, so no read leaves the table.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;   // bags a block
constexpr int kDepth = 4;   // rows of one warp in flight
constexpr unsigned kFull = 0xffffffffu;

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
  __device__ static T div(T a, float c) {
    return make_float4(__fdiv_rn(a.x, c), __fdiv_rn(a.y, c), __fdiv_rn(a.z, c),
                       __fdiv_rn(a.w, c));
  }
};
template <>
struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static T add(T a, T b) { return __fadd_rn(a, b); }
  __device__ static T div(T a, float c) { return __fdiv_rn(a, c); }
};

// VEC floats a load (4: float4, 1: scalar); K loads a lane per span of D.
template <int VEC, int K>
__global__ void __launch_bounds__(kWarps * 32)
embedding_bag_kernel(const float* __restrict__ table, const int* __restrict__ ids,
                     float* __restrict__ out, int B, int L, int D, long long V, bool mean) {
  using V_ = Vec<VEC>;
  using T = typename V_::T;
  constexpr int kSpan = 32 * VEC * K;
  const int lane = threadIdx.x & 31;
  const long long bag = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (bag >= B) return;  // whole warps leave together
  const int* bag_ids = ids + bag * L;
  const T* rows = reinterpret_cast<const T*>(table);
  T* dst = reinterpret_cast<T*>(out + bag * D);
  const int dv = D / VEC;  // vectors a row (D % VEC == 0 on the float4 path)
  const long long top = V - 1;

  for (int d0 = 0; d0 < dv; d0 += kSpan / VEC) {
    T acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = V_::zero();
    int count = 0;
    for (int l0 = 0; l0 < L; l0 += 32) {
      const int mine = l0 + lane < L ? __ldg(bag_ids + l0 + lane) : -1;
      unsigned valid = __ballot_sync(kFull, mine >= 0);
      count += __popc(valid);
      while (valid) {  // valid is the same in every lane: no divergence
        long long row[kDepth];
        bool has[kDepth];
#pragma unroll
        for (int j = 0; j < kDepth; ++j) {
          has[j] = valid != 0;
          const int src = has[j] ? __ffs(valid) - 1 : 0;
          valid &= valid - 1;  // the lowest l first: left to right
          const long long id = __shfl_sync(kFull, mine, src);
          row[j] = (id > top ? top : id) * dv + d0;
        }
        T r[kDepth][K];
#pragma unroll
        for (int j = 0; j < kDepth; ++j) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int v = k * 32 + lane;
            r[j][k] = (has[j] && d0 + v < dv) ? __ldg(rows + row[j] + v) : V_::zero();
          }
        }
#pragma unroll
        for (int j = 0; j < kDepth; ++j) {
          if (has[j]) {
#pragma unroll
            for (int k = 0; k < K; ++k) acc[k] = V_::add(acc[k], r[j][k]);
          }
        }
      }
    }
    const float denom = static_cast<float>(count > 0 ? count : 1);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int v = k * 32 + lane;
      if (d0 + v < dv) dst[d0 + v] = mean ? V_::div(acc[k], denom) : acc[k];
    }
  }
}

}  // namespace

// table (V, D) float32, ids (B, L) int32 (< 0: padding), out (B, D) float32.
// vec4: D % 4 == 0 and table and out 16-byte aligned. mean: divide each bag
// by max(its count of valid ids, 1).
extern "C" int repro_embedding_bag(const float* table, const int* ids, float* out, int B, int L,
                                   int D, long long V, int vec4, int mean, void* stream) {
  if (B == 0 || D == 0) return 0;
  if (B < 0 || L < 0 || D < 0 || V < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + kWarps - 1) / kWarps);
  const dim3 block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    embedding_bag_kernel<4, 2><<<grid, block, 0, s>>>(table, ids, out, B, L, D, V, mean != 0);
  } else {
    embedding_bag_kernel<1, 4><<<grid, block, 0, s>>>(table, ids, out, B, L, D, V, mean != 0);
  }
  return static_cast<int>(cudaGetLastError());
}
