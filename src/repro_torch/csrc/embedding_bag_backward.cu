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
// so each run of equal ids holds its positions in row-major (b, l) order,
// and zeroes the output. One warp a sorted position: a warp whose position
// does not start a run of a valid id leaves at once; the others walk their
// run, adding the g rows of its positions left to right from +0.0, one
// rounded add at a time (__fadd_rn), the order of the plain version
// (kernels/embedding_bag.py::embedding_bag_backward_plain), then store the
// row once. Lanes span D, four floats a lane (float4) where D % 4 == 0 and
// the pointers are 16-byte aligned, one float otherwise; D wider than a
// warp's span is walked in spans, re-reading the run's positions.
//
// Row offsets are 64-bit (a 4M x 256 table holds 1.0e9 floats).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;  // sorted positions a block

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

// keys: (n,) int32 sorted, V for padding; pos: (n,) int64 flat positions
// b * L + l in the sorted order; g: (B, D); out: (V, D), zeroed.
template <int VEC, int K>
__global__ void __launch_bounds__(kWarps * 32)
embedding_bag_backward_kernel(const int* __restrict__ keys, const long long* __restrict__ pos,
                              const float* __restrict__ g, float* __restrict__ out,
                              long long n, int L, int D, long long V) {
  using V_ = Vec<VEC>;
  using T = typename V_::T;
  constexpr int kSpan = 32 * K;  // vectors a lane-span of D
  const int lane = threadIdx.x & 31;
  const long long i = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (i >= n) return;  // whole warps leave together
  const int key = __ldg(keys + i);
  if (key >= V) return;                          // padding, sorted last
  if (i > 0 && __ldg(keys + i - 1) == key) return;  // not the start of a run
  const T* rows = reinterpret_cast<const T*>(g);
  T* dst = reinterpret_cast<T*>(out + static_cast<long long>(key) * D);
  const int dv = D / VEC;

  for (int d0 = 0; d0 < dv; d0 += kSpan) {
    T acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = V_::zero();
    for (long long j = i; j < n && __ldg(keys + j) == key; ++j) {
      const long long b = __ldg(pos + j) / L;
      const T* row = rows + b * dv + d0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int v = k * 32 + lane;
        if (d0 + v < dv) acc[k] = V_::add(acc[k], __ldg(row + v));
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int v = k * 32 + lane;
      if (d0 + v < dv) dst[d0 + v] = acc[k];
    }
  }
}

}  // namespace

// keys (n,) int32 sorted ascending (ids clamped to V - 1, padding V), pos
// (n,) int64 (b * L + l of each key, row-major order within a run), g (B, D)
// float32, out (V, D) float32 zeroed. vec4: D % 4 == 0 and g and out 16-byte
// aligned.
extern "C" int repro_embedding_bag_backward(const int* keys, const long long* pos, const float* g,
                                            float* out, long long n, int L, int D, long long V,
                                            int vec4, void* stream) {
  if (n == 0 || D == 0) return 0;
  if (n < 0 || L < 1 || D < 0 || V < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    embedding_bag_backward_kernel<4, 2><<<grid, block, 0, s>>>(keys, pos, g, out, n, L, D, V);
  } else {
    embedding_bag_backward_kernel<1, 4><<<grid, block, 0, s>>>(keys, pos, g, out, n, L, D, V);
  }
  return static_cast<int>(cudaGetLastError());
}
