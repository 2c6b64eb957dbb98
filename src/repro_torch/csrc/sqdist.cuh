// Squared L2 by one warp, shared by gather_distance.cu and fused_expand.cu.
//
// Both kernels use this lane-to-element map and this order (gather_distance's
// register path repeats them with the query row in registers), so the
// unfused (gather_distance) and fused (fused_expand) search paths produce
// identical distance bits on the card. Each lane accumulates its
// elements in ascending order with explicit fused multiply-adds (no
// contraction left to the compiler), then an xor butterfly sums the 32
// partials in a fixed order. Addition is commutative in IEEE arithmetic,
// so every lane ends with the same value.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kWarpSize = 32;
constexpr unsigned kFullMask = 0xffffffffu;

// q: the query row in shared memory (16-byte aligned); row: the corpus row
// in device memory. vec4: d % 4 == 0 and the corpus is 16-byte aligned, so
// each lane loads float4s (one pass covers d = 128); otherwise one float a
// lane per step.
__device__ __forceinline__ float warp_sqdist(const float* __restrict__ q,
                                             const float* __restrict__ row,
                                             int d, bool vec4, int lane) {
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
#pragma unroll
  for (int off = kWarpSize / 2; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_xor_sync(kFullMask, acc, off));
  }
  return acc;
}

// Copy the query row into shared memory; every thread of the block helps.
__device__ __forceinline__ void load_query(float* q_smem, const float* __restrict__ queries,
                                           int b, int d) {
  const float* src = queries + static_cast<size_t>(b) * d;
  for (int k = threadIdx.x; k < d; k += blockDim.x) q_smem[k] = src[k];
  __syncthreads();
}

}  // namespace repro_torch
