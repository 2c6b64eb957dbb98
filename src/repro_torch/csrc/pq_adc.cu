// pq_adc: the full-corpus ADC scan, out[b, v] = sum_s lut[b, s, codes[v, s]].
//
// Replaces the TPU kernel repro/kernels/pq_adc/pq_adc.py (pq_adc_kernel).
// Bound by device-memory bytes: the (B, N) float32 output (4 bytes a
// distance) outweighs the codes (m_sub * 4 bytes a row, read once per query
// group and mostly from L2) and the LUT; the m_sub adds a distance are far
// below the card's operation rate. Design: a block takes a group of up to
// kMaxQ queries and a chunk of corpus rows. It stages the group's LUTs in
// shared memory once (16 KB a query at m_sub = 16, n_cent = 256), then
// each thread owns one code row at a time: it loads the row (four 16-byte
// loads at m_sub = 16), turns each code into a shared-memory offset once,
// and adds the group's entries into one register per query. Neighbouring
// threads own neighbouring rows, so the stores of out[b, v] are coalesced.
// Blocks of the same row chunk are adjacent in launch order (query groups
// on grid x), so a chunk's codes come from device memory about once.
//
// Each distance adds its m_sub entries left to right, s = 0, 1, ..., one
// rounded add at a time: the order of the plain version
// (kernels/pq_adc.py::ordered_sum) and of fused_expand_adc.cu, so all of
// them give the same bits.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxQ = 8;           // queries a block stages (pq_adc.py MAX_GROUP)
constexpr int kChunk = 16;         // code words held in registers at once
constexpr int kRowsPerThread = 32; // row tiles a block walks

__global__ void __launch_bounds__(kThreads)
pq_adc_kernel(const float* __restrict__ lut, const int* __restrict__ codes,
              float* __restrict__ out, int B, int N, int m_sub, int n_cent, int group,
              int rows_per_block, bool vec4) {
  extern __shared__ float4 smem4[];
  float* slut = reinterpret_cast<float*>(smem4);
  const int q0 = blockIdx.x * group;
  const int qn = min(group, B - q0);
  const int table = m_sub * n_cent;
  const int total = qn * table;
  const float* src = lut + static_cast<size_t>(q0) * table;
  if ((total & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int k = threadIdx.x; k < (total >> 2); k += kThreads) smem4[k] = __ldg(src4 + k);
  } else {
    for (int k = threadIdx.x; k < total; k += kThreads) slut[k] = __ldg(src + k);
  }
  __syncthreads();

  const int row0 = blockIdx.y * rows_per_block;
  const int row_end = min(N, row0 + rows_per_block);
  const unsigned top = static_cast<unsigned>(n_cent - 1);
  for (int v = row0 + threadIdx.x; v < row_end; v += kThreads) {
    const int* crow = codes + static_cast<size_t>(v) * m_sub;
    float acc[kMaxQ];
#pragma unroll
    for (int qi = 0; qi < kMaxQ; ++qi) acc[qi] = 0.0f;
    for (int s0 = 0; s0 < m_sub; s0 += kChunk) {
      const int sn = min(kChunk, m_sub - s0);
      int off[kChunk];
      if (vec4 && sn == kChunk) {
        const int4* c4 = reinterpret_cast<const int4*>(crow + s0);
#pragma unroll
        for (int j = 0; j < kChunk / 4; ++j) {
          const int4 c = __ldg(c4 + j);
          off[4 * j] = c.x;
          off[4 * j + 1] = c.y;
          off[4 * j + 2] = c.z;
          off[4 * j + 3] = c.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) off[j] = j < sn ? __ldg(crow + s0 + j) : 0;
      }
      // A code outside [0, n_cent) is clamped into it: no read leaves the table.
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        off[j] = (s0 + j) * n_cent + static_cast<int>(min(static_cast<unsigned>(off[j]), top));
      }
#pragma unroll
      for (int qi = 0; qi < kMaxQ; ++qi) {
        if (qi < qn) {
          const float* t = slut + qi * table;
#pragma unroll
          for (int j = 0; j < kChunk; ++j) {
            if (j < sn) {
              const float val = t[off[j]];
              acc[qi] = (s0 + j == 0) ? val : __fadd_rn(acc[qi], val);
            }
          }
        }
      }
    }
#pragma unroll
    for (int qi = 0; qi < kMaxQ; ++qi) {
      if (qi < qn) out[static_cast<size_t>(q0 + qi) * N + v] = acc[qi];
    }
  }
}

}  // namespace

// group: queries a block stages (<= kMaxQ; group * m_sub * n_cent floats of
// shared memory). vec4: m_sub % 4 == 0 and codes 16-byte aligned.
extern "C" int repro_pq_adc(const float* lut, const int* codes, float* out, int B, int N,
                            int m_sub, int n_cent, int group, int vec4, void* stream) {
  if (B == 0 || N == 0) return 0;
  if (group < 1 || group > kMaxQ || m_sub < 1 || n_cent < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int groups = (B + group - 1) / group;
  int rows_per_block = kThreads * kRowsPerThread;
  const int max_chunks = 65535;  // grid y
  if ((N + rows_per_block - 1) / rows_per_block > max_chunks) {
    rows_per_block = ((N + max_chunks - 1) / max_chunks + kThreads - 1) / kThreads * kThreads;
  }
  const dim3 grid(groups, (N + rows_per_block - 1) / rows_per_block);
  const size_t smem = static_cast<size_t>(group) * m_sub * n_cent * sizeof(float);
  static size_t smem_set = 48 * 1024;  // the default limit of dynamic shared memory
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        pq_adc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  pq_adc_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      lut, codes, out, B, N, m_sub, n_cent, group, rows_per_block, vec4 != 0);
  return static_cast<int>(cudaGetLastError());
}
