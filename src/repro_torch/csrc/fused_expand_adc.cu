// fused_expand_adc: the PQ twin of fused_expand. One pass over a (B, M)
// candidate batch emits
//   dists[b, m]     = sum_s lut[b, s, codes[id, s]]       (+inf for id < 0)
//   satisfied[b, m] = valid & constraint(meta[id]) & !tombstoned(id)
//   fresh[b, m]     = valid & visited bit (b, id) clear
//
// Replaces the TPU kernel repro/kernels/fused_expand/fused_expand.py
// (fused_expand_adc_kernel, body _make_adc_kernel). Bound by device-memory
// bytes: per candidate one m_sub-word code row (64 bytes at m_sub = 16), a
// meta word, a visited word and a label word (or two bounds), and m_sub
// LUT entries, each 4 bytes, from the query's (m_sub, n_cent) table. Design:
// a block serves one query row and up to kMaxThreads candidates, one thread
// a candidate. The thread issues its probe loads (probe.cuh, shared with
// fused_expand.cu) and its code row (four 16-byte loads at m_sub = 16)
// first, then reads its m_sub LUT entries straight from the query's table:
// the table (16 KB at m_sub = 16, n_cent = 256) is read by every candidate
// of the row and stays in L1/L2, so staging it whole per block would move
// more bytes than the lookups do. The TPU kernel's DMA ring, scalar
// prefetch and one-hot compare-select do not carry over.
//
// The distance adds its m_sub entries left to right, s = 0, 1, ..., one
// rounded add at a time: the order of the unfused plain formula
// (kernels/pq_adc.py::adc_lookup) and of pq_adc.cu, so fused and unfused
// PQ traversals give the same bits on the card.
#include <cuda_runtime.h>

#include <algorithm>

#include "grid.cuh"
#include "probe.cuh"

namespace {

constexpr int kMaxThreads = 128;
constexpr int kChunk = 16;  // code words held in registers at once

template <int FAMILY, bool WITH_TOMB>
__global__ void __launch_bounds__(kMaxThreads)
fused_expand_adc_kernel(const float* __restrict__ lut, const int* __restrict__ codes,
                        const int* __restrict__ ids, const int* __restrict__ visited,
                        const int* __restrict__ meta, const int* __restrict__ cons,
                        const int* __restrict__ tomb, float* __restrict__ dists,
                        bool* __restrict__ sat, bool* __restrict__ fresh, int M, int m_sub,
                        int n_cent, int W, int Lw, bool vec4) {
  const int b = blockIdx.y;
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const size_t slot = static_cast<size_t>(b) * M + m;
  const int id = ids[slot];
  if (id < 0) {
    dists[slot] = __int_as_float(0x7f800000);
    sat[slot] = false;
    fresh[slot] = false;
    return;
  }
  const repro_torch::Probe probe =
      repro_torch::probe_load<WITH_TOMB>(visited, meta, tomb, b, W, id);
  const int* crow = codes + static_cast<size_t>(id) * m_sub;
  const float* table = lut + static_cast<size_t>(b) * m_sub * n_cent;
  const unsigned top = static_cast<unsigned>(n_cent - 1);
  float acc = 0.0f;
  for (int s0 = 0; s0 < m_sub; s0 += kChunk) {
    const int sn = min(kChunk, m_sub - s0);
    int c[kChunk];
    if (vec4 && sn == kChunk) {
      const int4* c4 = reinterpret_cast<const int4*>(crow + s0);
#pragma unroll
      for (int j = 0; j < kChunk / 4; ++j) {
        const int4 w = __ldg(c4 + j);
        c[4 * j] = w.x;
        c[4 * j + 1] = w.y;
        c[4 * j + 2] = w.z;
        c[4 * j + 3] = w.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) c[j] = j < sn ? __ldg(crow + s0 + j) : 0;
    }
    float val[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      // A code outside [0, n_cent) is clamped into it: no read leaves the table.
      const unsigned cj = min(static_cast<unsigned>(c[j]), top);
      val[j] = j < sn ? __ldg(table + static_cast<size_t>(s0 + j) * n_cent + cj) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (j < sn) acc = (s0 + j == 0) ? val[j] : __fadd_rn(acc, val[j]);
    }
  }
  bool ok, fr;
  repro_torch::probe_verdicts<FAMILY, WITH_TOMB>(probe, cons, b, Lw, id, &ok, &fr);
  dists[slot] = acc;
  sat[slot] = ok;
  fresh[slot] = fr;
}

}  // namespace

// lut (B, m_sub, n_cent) float32, codes (n, m_sub) int32; the rest as
// repro_fused_expand (fused_expand.cu), chunks of kGridY queries included.
// vec4: m_sub % 4 == 0 and codes 16-byte aligned.
extern "C" int repro_fused_expand_adc(const float* lut, const int* codes, const int* ids,
                                      const int* visited, const void* meta, const void* cons,
                                      const int* tomb, float* dists, bool* sat, bool* fresh,
                                      int B, int M, int m_sub, int n_cent, int W, int Lw,
                                      int family, int with_tomb, int vec4, void* stream) {
  if (B == 0 || M == 0) return 0;
  if (m_sub < 1 || n_cent < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = M >= kMaxThreads ? kMaxThreads : (M + 31) / 32 * 32;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* mt = static_cast<const int*>(meta);
  const int* cs = static_cast<const int*>(cons);
  const size_t cons_row = repro_torch::cons_words(family, Lw);
  const size_t table = static_cast<size_t>(m_sub) * n_cent;
  for (long long b0 = 0; b0 < B; b0 += repro_torch::kGridY) {
    const size_t r = static_cast<size_t>(b0);
    const unsigned nb = static_cast<unsigned>(std::min<long long>(B - b0, repro_torch::kGridY));
    const dim3 grid((M + threads - 1) / threads, nb);
    const int status = repro_torch::with_family(family, with_tomb, [&](auto fam, auto tmb) {
      fused_expand_adc_kernel<decltype(fam)::value, decltype(tmb)::value>
          <<<grid, threads, 0, s>>>(lut + r * table, codes, ids + r * M, visited + r * W, mt,
                                    cs + r * cons_row, tomb, dists + r * M, sat + r * M,
                                    fresh + r * M, M, m_sub, n_cent, W, Lw, vec4 != 0);
    });
    if (status != 0) return status;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
