// l2_matmul: out[i, j] = max(|q_i|^2 - 2 q_i.x_j + |x_j|^2, 0) for q (M, d)
// and x (N, d), float32 in and out.
//
// Replaces the TPU kernel repro/kernels/l2_matmul/l2_matmul.py (l2_matmul,
// the matrix-unit tile with the norms added per k tile). On the card the
// work is a float32 product, 2*M*N*d operations against M*N*4 bytes of
// output, so it is bound by operations (67 TFLOP/s outside the tensor
// cores): at the build's (1024, 1M, 128) that is 4.0 ms against 1.2 ms of
// writes. It runs in full float32 on the FMA units, no TF32 and no tensor
// cores, because the kNN graph's neighbour order depends on the last bits.
//
// Design: one block of 256 threads per 128 x 128 output tile. The sum over
// d is a loop inside the block (the TPU's sequential k grid has no
// counterpart): each step stages a 128 x 8 slice of q and of x in shared
// memory, transposed so that a thread reads its operands as float4s, and
// double-buffered so the next slice's loads overlap this slice's FMAs.
// Each thread keeps an 8 x 8 register tile and adds, for every k in
// ascending order, a[i] * b[j] with one rounded fused multiply-add. The
// thread that loads a row's slice also adds the squares of what it loaded,
// so the row norms come from the same pass over q and x. The epilogue forms
// ((-2 * qx) + |q|^2) + |x|^2 (the order of the plain version), clamps at 0
// and stores the tile with 64-bit offsets. The q tiles ride grid x, the x
// tiles grid y and then z (any N), so the output tiles of one x tile are
// adjacent in launch order and x is read from device memory about once
// while q stays in L2.
// Ragged M, N and d are masked: missing elements load as 0 and add nothing.
#include <cuda_runtime.h>

#include "grid.cuh"

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 8;
constexpr int kThreads = 256;

// Load the 4 elements k0 + lk .. k0 + lk + 3 of one row (0 past d or for a
// row out of range).
template <bool kVec4>
__device__ __forceinline__ void load_slice(const float* __restrict__ row, bool ok, int k, int d,
                                           float (&v)[4]) {
  if (kVec4) {
    if (ok && k < d) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(row + k));
      v[0] = t.x;
      v[1] = t.y;
      v[2] = t.z;
      v[3] = t.w;
    } else {
      v[0] = v[1] = v[2] = v[3] = 0.0f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = (ok && k + i < d) ? __ldg(row + k + i) : 0.0f;
  }
}

template <bool kVec4, bool kVecOut>
__global__ void __launch_bounds__(kThreads, 2)
l2_matmul_kernel(const float* __restrict__ q, const float* __restrict__ x,
                 float* __restrict__ out, int M, int N, int d) {
  __shared__ __align__(16) float As[2][kBK][kBM];
  __shared__ __align__(16) float Bs[2][kBK][kBN];
  __shared__ float q2s[kBM];
  __shared__ float x2s[kBN];

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // column group of the 8 x 8 register tile
  const int ty = tid >> 4;  // row group
  // q tiles on grid x (fastest in launch order), x tiles on grid y and then
  // z (grid.cuh), so N takes any size.
  const int n_tile = static_cast<int>(repro_torch::grid_row());
  if (n_tile * kBN >= N) return;  // the last z slice's spare tiles
  const int m0 = blockIdx.x * kBM;
  const int n0 = n_tile * kBN;

  // Loader map: thread tid loads row tid / 2 of each tile, elements
  // (tid % 2) * 4 .. + 3 of each 8-wide slice.
  const int lr = tid >> 1;
  const int lk = (tid & 1) * 4;
  const bool qok = m0 + lr < M;
  const bool xok = n0 + lr < N;
  const float* qrow = q + static_cast<size_t>(qok ? m0 + lr : 0) * d;
  const float* xrow = x + static_cast<size_t>(xok ? n0 + lr : 0) * d;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  float q2 = 0.0f, x2 = 0.0f;
  float qv[4], xv[4];

  const int n_k = (d + kBK - 1) / kBK;
  load_slice<kVec4>(qrow, qok, lk, d, qv);
  load_slice<kVec4>(xrow, xok, lk, d, xv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    q2 = __fmaf_rn(qv[i], qv[i], q2);
    x2 = __fmaf_rn(xv[i], xv[i], x2);
    As[0][lk + i][lr] = qv[i];
    Bs[0][lk + i][lr] = xv[i];
  }
  __syncthreads();

  for (int kt = 0; kt < n_k; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < n_k;
    if (more) {
      const int k = (kt + 1) * kBK + lk;
      load_slice<kVec4>(qrow, qok, k, d, qv);
      load_slice<kVec4>(xrow, xok, k, d, xv);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][kk][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    if (more) {
      // The other buffer was last read before the previous barrier.
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        q2 = __fmaf_rn(qv[i], qv[i], q2);
        x2 = __fmaf_rn(xv[i], xv[i], x2);
        As[cur ^ 1][lk + i][lr] = qv[i];
        Bs[cur ^ 1][lk + i][lr] = xv[i];
      }
    }
    __syncthreads();
  }

  // Each row's norm is split over the two threads that loaded it (lanes
  // tid and tid ^ 1 of one warp).
  q2 = __fadd_rn(q2, __shfl_xor_sync(0xffffffffu, q2, 1));
  x2 = __fadd_rn(x2, __shfl_xor_sync(0xffffffffu, x2, 1));
  if ((tid & 1) == 0) {
    q2s[lr] = q2;
    x2s[lr] = x2;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    const int row = m0 + r;
    if (row >= M) continue;
    const float qn = q2s[r];
    float* orow = out + static_cast<size_t>(row) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = h * 64 + tx * 4;
      const int col = n0 + c;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float t = __fadd_rn(__fmul_rn(-2.0f, acc[i][h * 4 + j]), qn);
        v[j] = fmaxf(__fadd_rn(t, x2s[c + j]), 0.0f);
      }
      if (kVecOut) {
        if (col < N) *reinterpret_cast<float4*>(orow + col) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < N) orow[col + j] = v[j];
      }
    }
  }
}

template <bool kVec4, bool kVecOut>
void launch(const float* q, const float* x, float* out, int M, int N, int d, cudaStream_t s) {
  const dim3 grid = repro_torch::rows_grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  l2_matmul_kernel<kVec4, kVecOut><<<grid, kThreads, 0, s>>>(q, x, out, M, N, d);
}

}  // namespace

// vec4: d % 4 == 0 and q, x 16-byte aligned (float4 loads); vec_out:
// N % 4 == 0 and out 16-byte aligned (float4 stores). The wrapper keeps
// ceil(M / 128) below 2**31 (grid x); N takes any int.
extern "C" int repro_l2_matmul(const float* q, const float* x, float* out, int M, int N, int d,
                               int vec4, int vec_out, void* stream) {
  if (M == 0 || N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4 && vec_out) {
    launch<true, true>(q, x, out, M, N, d, s);
  } else if (vec4) {
    launch<true, false>(q, x, out, M, N, d, s);
  } else if (vec_out) {
    launch<false, true>(q, x, out, M, N, d, s);
  } else {
    launch<false, false>(q, x, out, M, N, d, s);
  }
  return static_cast<int>(cudaGetLastError());
}
