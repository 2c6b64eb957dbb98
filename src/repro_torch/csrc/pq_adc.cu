// pq_adc: the full-corpus ADC scan, out[b, v] = sum_s lut[b, s, codes[v, s]].
//
// Replaces the TPU kernel repro/kernels/pq_adc/pq_adc.py (pq_adc_kernel).
// Bound by device-memory bytes: the (B, N) float32 output (4 bytes a
// distance) outweighs the codes (m_sub * 4 bytes a row, read once per query
// group and mostly from L2) and the LUT; the m_sub adds a distance are far
// below the card's operation rate. Beside the bytes, every distance does
// m_sub lookups in a staged table: 4.1e9 at B = 256, N = 1M, m_sub = 16,
// 16.4 GB of shared-memory reads, ~0.5 ms at 128 bytes a clock on each of
// 132 SMs even without a bank conflict. That is this design's floor.
//
// The earlier design gave each thread one code row and all queries of its
// group, so the 32 lanes of a warp looked up 32 random codes in one query's
// table at once (~3.5-way bank conflicts on every lookup), and each warp
// waited for its code rows before any lookup. Here the lanes run over
// queries. A block stages the LUTs of a group of Q queries in shared memory
// as [s][code][q], q fastest, straight from lut[b][s][code] (no transposed
// copy outside the kernel); Q is the largest power of two up to 32 whose
// tables fit a block's shared memory (8 at m_sub = 16, n_cent = 256, 128
// KB). A lane serves QL = min(Q, 4) queries of one code row with one
// 16-byte lookup per code (QL floats: the lane's queries' entries of that
// code sit side by side), so the Q / QL lanes of a row read Q consecutive
// words of one code's entry, and each quarter-warp's lookup touches 4
// random codes in 4 bank groups (~2.1-way, against ~3.5) with a quarter of
// the earlier instructions a lookup. The lanes of a row load the same code
// words (one transaction), one row ahead of the lookups, so their latency
// hides behind the current row's; each code is clamped into [0, n_cent) as
// an unsigned and turned into a shared-memory offset once for QL queries.
// One block of kThreads threads walks a chunk of rows. Blocks of the same
// row chunk are adjacent in launch order (query groups on grid x), so a
// chunk's codes come from device memory about once.
//
// Each distance adds its m_sub entries left to right, s = 0, 1, ..., one
// rounded add at a time: the order of the plain version
// (kernels/pq_adc.py::ordered_sum) and of fused_expand_adc.cu, so all of
// them give the same bits.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kChunk = 16;           // code words held in registers at once
constexpr int kRowsPerBlock = 16384; // rows a block walks (fewer when N needs more blocks)
constexpr int kMaxLaneQ = 4;         // queries a lane serves: one 16-byte lookup
constexpr size_t kSmemLimit = 232448; // bytes of shared memory one block may use (sm_90)
constexpr size_t kSmemDefault = 48 * 1024;  // dynamic shared memory a launch gets unasked

template <int QL>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
};
template <>
struct Vec<2> {
  using T = float2;
};
template <>
struct Vec<4> {
  using T = float4;
};

// Codes s0 .. s0 + kChunk - 1 of row v (0 past m_sub).
__device__ __forceinline__ void load_codes(const int* __restrict__ codes, int v, int s0,
                                           int m_sub, bool vec4, int (&dst)[kChunk]) {
  const int* crow = codes + static_cast<size_t>(v) * m_sub + s0;
  const int sn = min(kChunk, m_sub - s0);
  if (vec4 && sn == kChunk) {
    const int4* c4 = reinterpret_cast<const int4*>(crow);
#pragma unroll
    for (int j = 0; j < kChunk / 4; ++j) {
      const int4 c = __ldg(c4 + j);
      dst[4 * j] = c.x;
      dst[4 * j + 1] = c.y;
      dst[4 * j + 2] = c.z;
      dst[4 * j + 3] = c.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) dst[j] = j < sn ? __ldg(crow + j) : 0;
  }
}

template <int Q>
__global__ void __launch_bounds__(kThreads, 1)
pq_adc_kernel(const float* __restrict__ lut, const int* __restrict__ codes,
              float* __restrict__ out, int B, int N, int m_sub, int n_cent, int rows_per_block,
              bool vec4) {
  constexpr int QL = Q < kMaxLaneQ ? Q : kMaxLaneQ;  // queries a lane serves
  constexpr int L = Q / QL;                           // lanes a code row
  constexpr int R = 32 / L;                           // code rows a warp serves at once
  using V = typename Vec<QL>::T;
  extern __shared__ float4 smem4[];
  float* slut = reinterpret_cast<float*>(smem4);
  const int q0 = blockIdx.x * Q;
  const int qn = min(Q, B - q0);
  const int table = m_sub * n_cent;
  // Stage [s][code][q]: element e holds query e % Q's entry e / Q.
  for (int e = threadIdx.x; e < table * Q; e += kThreads) {
    const int q = e % Q;
    slut[e] = q < qn ? __ldg(lut + static_cast<size_t>(q0 + q) * table + e / Q) : 0.0f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int lq = (lane % L) * QL;  // the lane's first query in the group
  const int r = lane / L;
  const int row0 = blockIdx.y * rows_per_block;
  const int row_end = min(N, row0 + rows_per_block);
  const int stride = (kThreads / 32) * R;
  const unsigned top = static_cast<unsigned>(n_cent - 1);
  const V* sq = reinterpret_cast<const V*>(slut + lq);
  // The first code chunk of the lane's next row is loaded one row ahead, so
  // its latency hides behind this row's lookups.
  int v = row0 + (threadIdx.x >> 5) * R + r;
  int next[kChunk];
  load_codes(codes, min(v, row_end - 1), 0, m_sub, vec4, next);
  for (; v - r < row_end; v += stride) {
    int code[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) code[j] = next[j];
    load_codes(codes, min(v + stride, row_end - 1), 0, m_sub, vec4, next);
    float acc[QL] = {};
    for (int s0 = 0; s0 < m_sub; s0 += kChunk) {
      if (s0 > 0) load_codes(codes, min(v, row_end - 1), s0, m_sub, vec4, code);
      const int sn = min(kChunk, m_sub - s0);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (j < sn) {
          // A code outside [0, n_cent) reads entry n_cent - 1 (an unsigned
          // clamp, as in fused_expand_adc.cu): no read leaves the table.
          const unsigned c = min(static_cast<unsigned>(code[j]), top);
          const V val = sq[((s0 + j) * n_cent + static_cast<int>(c)) * L];
          const float* f = reinterpret_cast<const float*>(&val);
#pragma unroll
          for (int k = 0; k < QL; ++k) acc[k] = (s0 + j == 0) ? f[k] : __fadd_rn(acc[k], f[k]);
        }
      }
    }
    if (v < row_end) {
#pragma unroll
      for (int k = 0; k < QL; ++k) {
        if (lq + k < qn) out[static_cast<size_t>(q0 + lq + k) * N + v] = acc[k];
      }
    }
  }
}

template <int Q>
int launch(const float* lut, const int* codes, float* out, int B, int N, int m_sub, int n_cent,
           bool vec4, cudaStream_t stream) {
  const int groups = (B + Q - 1) / Q;
  int rows_per_block = kRowsPerBlock;
  const int max_chunks = 65535;  // grid y
  if ((N + rows_per_block - 1) / rows_per_block > max_chunks) {
    rows_per_block = (N + max_chunks - 1) / max_chunks;
  }
  const dim3 grid(groups, (N + rows_per_block - 1) / rows_per_block);
  const size_t smem = static_cast<size_t>(Q) * m_sub * n_cent * sizeof(float);
  // The limit is a property of the kernel on the current card: set it on
  // every launch past the 48 KB default, so each card gets it.
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        pq_adc_kernel<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  pq_adc_kernel<Q><<<grid, kThreads, smem, stream>>>(lut, codes, out, B, N, m_sub, n_cent,
                                                     rows_per_block, vec4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vec4: m_sub % 4 == 0 and codes 16-byte aligned. One query's table
// (m_sub * n_cent floats) must fit a block's shared memory.
extern "C" int repro_pq_adc(const float* lut, const int* codes, float* out, int B, int N,
                            int m_sub, int n_cent, int vec4, void* stream) {
  if (B == 0 || N == 0) return 0;
  const size_t table_bytes = static_cast<size_t>(m_sub) * n_cent * sizeof(float);
  if (m_sub < 1 || n_cent < 1 || table_bytes > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v = vec4 != 0;
  const size_t fit = kSmemLimit / table_bytes;  // tables a block can stage
  if (fit >= 32) return launch<32>(lut, codes, out, B, N, m_sub, n_cent, v, s);
  if (fit >= 16) return launch<16>(lut, codes, out, B, N, m_sub, n_cent, v, s);
  if (fit >= 8) return launch<8>(lut, codes, out, B, N, m_sub, n_cent, v, s);
  if (fit >= 4) return launch<4>(lut, codes, out, B, N, m_sub, n_cent, v, s);
  if (fit >= 2) return launch<2>(lut, codes, out, B, N, m_sub, n_cent, v, s);
  return launch<1>(lut, codes, out, B, N, m_sub, n_cent, v, s);
}
