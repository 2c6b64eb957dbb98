// fused_expand_adc: the PQ twin of fused_expand. One pass over a (B, M)
// candidate batch emits
//   dists[b, m]     = sum_s lut[b, s, codes[id, s]]       (+inf for id < 0)
//   satisfied[b, m] = valid & constraint(meta[id]) & !tombstoned(id)
//   fresh[b, m]     = valid & visited bit (b, id) clear
//
// Replaces the TPU kernel repro/kernels/fused_expand/fused_expand.py
// (fused_expand_adc_kernel, body _make_adc_kernel). Its bytes are few: per
// candidate one m_sub-word code row (64 bytes at m_sub = 16), a meta word, a
// visited word and m_sub LUT entries, each 4 bytes. At the search's 256 x 32
// candidates it is bound by latency, the chain of dependent memory trips
// from the candidate's id to its stores, not by bytes.
//
// Design: a block serves the candidates of one query, kLanes = 4 lanes a
// candidate (up to kMaxThreads / kLanes = 128 candidates a block; more take
// more blocks on grid x, and the queries ride grid y and z, grid.cuh). The
// block reads its ids and, unless all are padding, starts asynchronous
// 16-byte copies (cp.async; 4-byte ones where the table is not 16-byte
// aligned) of the query's whole (m_sub, n_cent) table and its constraint
// row into shared memory: 16 KB at m_sub = 16, n_cent = 256. A candidate's
// four lanes then read its code row as one 64-byte request (each lane one
// 16-byte load of 4 codes) while its owner lane issues the probe loads
// (probe.cuh, shared with fused_expand.cu), so the table's trip runs beside
// the code-row trip instead of after it. One barrier; then each lane looks
// up its 4 codes in shared memory, the owner gathers the 16 values of the
// step by shuffles and adds them in subspace order, and reads the label
// word or the range bounds in shared memory.
//
// The padding vote pays where the walk runs: there the tables are mostly
// out of L2 and the rows of finished queries are all padding (41% of them
// over a serve_256_pq_fused batch), so skipping their copies saves more
// than copying before the ids arrive would. With one table kept in L2 and
// no padding the vote costs about 0.3 us a launch (PERF.md, Findings,
// tools/fused_expand_adc_ab.py).
//
// A table over 48 KB opts in to more dynamic shared memory; one that, with
// the constraint row, exceeds a block's 227 KB takes the same kernel with
// its lookups and constraint word in device memory (the reference has no
// limit on the table's size). The TPU kernel's DMA ring, scalar prefetch
// and one-hot compare-select do not carry over.
//
// The distance adds its m_sub entries left to right, s = 0, 1, ..., one
// rounded add at a time: the order of the unfused plain formula
// (kernels/pq_adc.py::adc_lookup) and of pq_adc.cu, so fused and unfused
// PQ traversals give the same bits on the card. A code outside [0, n_cent)
// reads entry n_cent - 1 (an unsigned clamp), as in pq_adc.cu.
#include <cuda_runtime.h>

#include "grid.cuh"
#include "probe.cuh"
#include "sqdist.cuh"

namespace {

using repro_torch::aligned16;
using repro_torch::kFullMask;
using repro_torch::kLabel;
using repro_torch::kRange;

constexpr int kLanes = 4;                 // lanes a candidate
constexpr int kPer = 4;                   // codes a lane looks up a step (one 16-byte load)
constexpr int kStep = kLanes * kPer;      // subspaces a candidate covers a step
constexpr int kMaxThreads = 512;          // threads a block: kMaxThreads / kLanes candidates
constexpr size_t kSmemDefault = 48 * 1024;  // dynamic shared memory without an opt-in
constexpr size_t kSmemLimit = 232448;     // bytes of shared memory one block may use (sm_90)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

// Codes s .. s + kPer - 1 of a code row (0 past m_sub). vec4: m_sub % 4 == 0
// and the codes 16-byte aligned (s is a multiple of kPer = 4).
__device__ __forceinline__ void load_codes(const int* __restrict__ crow, int s, int m_sub,
                                           bool vec4, int (&dst)[kPer]) {
  if (vec4 && s < m_sub) {
    const int4 w = __ldg(reinterpret_cast<const int4*>(crow + s));
    dst[0] = w.x;
    dst[1] = w.y;
    dst[2] = w.z;
    dst[3] = w.w;
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) dst[i] = s + i < m_sub ? __ldg(crow + s + i) : 0;
  }
}

// One step of a candidate's sum: every lane of its group looks up its kPer
// codes c of subspaces s0 + kPer * g ..., and the owner (g = 0) gathers the
// step's kStep values by shuffles and adds them to acc in subspace order.
// Every lane of the warp calls it. A code outside [0, n_cent) is clamped
// into it: no read leaves the table.
template <bool STAGED>
__device__ __forceinline__ float step_sum(const float* slut, const float* __restrict__ qlut,
                                          const int (&c)[kPer], int s0, int g, int m_sub,
                                          int n_cent, unsigned top, int base, float acc) {
  float val[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int s = s0 + kPer * g + i;
    const unsigned code = min(static_cast<unsigned>(c[i]), top);
    val[i] = 0.0f;
    if (s < m_sub) {
      val[i] = STAGED ? slut[s * n_cent + static_cast<int>(code)]
                      : __ldg(qlut + static_cast<size_t>(s) * n_cent + code);
    }
  }
#pragma unroll
  for (int gg = 0; gg < kLanes; ++gg) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float v = __shfl_sync(kFullMask, val[i], base + gg);
      const int s = s0 + kPer * gg + i;
      if (s < m_sub) acc = s == 0 ? v : __fadd_rn(acc, v);
    }
  }
  return acc;
}

// STAGED: the table and the constraint row are copied into shared memory;
// otherwise both are read in device memory.
template <int FAMILY, bool WITH_TOMB, bool STAGED>
__global__ void __launch_bounds__(kMaxThreads)
fused_expand_adc_kernel(const float* __restrict__ lut, const int* __restrict__ codes,
                        const int* __restrict__ ids, const int* __restrict__ visited,
                        const int* __restrict__ meta, const int* __restrict__ cons,
                        const int* __restrict__ tomb, float* __restrict__ dists,
                        bool* __restrict__ sat, bool* __restrict__ fresh, int B, int M,
                        int m_sub, int n_cent, int W, int Lw, bool codes16, bool lut16) {
  extern __shared__ float4 smem4[];
  const long long b = repro_torch::grid_row();
  if (b >= B) return;  // the whole block
  const int g = threadIdx.x % kLanes;  // the lane's place in its candidate's group
  const int m = blockIdx.x * (blockDim.x / kLanes) + threadIdx.x / kLanes;
  const bool live = m < M;
  const size_t slot = static_cast<size_t>(b) * M + m;
  const int id = live ? __ldg(ids + slot) : -1;
  // A block whose candidates are all padding (a finished query of the walk)
  // stages nothing: it writes its padding outputs and leaves.
  if (STAGED && !__syncthreads_or(id >= 0)) {
    if (live && g == 0) {
      dists[slot] = __int_as_float(0x7f800000);
      sat[slot] = false;
      fresh[slot] = false;
    }
    return;
  }

  const size_t table = static_cast<size_t>(m_sub) * n_cent;
  const int ncons = repro_torch::cons_words(FAMILY, Lw);
  const float* qlut = lut + static_cast<size_t>(b) * table;
  const int* qcons = cons + static_cast<size_t>(b) * ncons;
  float* slut = reinterpret_cast<float*>(smem4);
  int* scons = reinterpret_cast<int*>(slut + ((table + 3) & ~static_cast<size_t>(3)));
  if (STAGED) {
    if (lut16) {
      for (int e = threadIdx.x; e < static_cast<int>(table / 4); e += blockDim.x) {
        cp_async16(slut + 4 * e, qlut + 4 * e);
      }
    } else {
      for (int e = threadIdx.x; e < static_cast<int>(table); e += blockDim.x) {
        cp_async4(slut + e, qlut + e);
      }
    }
    for (int e = threadIdx.x; e < ncons; e += blockDim.x) cp_async4(scons + e, qcons + e);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // The group's kLanes lanes read kStep consecutive codes of the row (one
  // 64-byte request at m_sub = 16); the owner (g = 0) issues the probes.
  repro_torch::Probe p{};
  int c[kPer] = {};
  const int* crow = codes + static_cast<size_t>(max(id, 0)) * m_sub;
  if (id >= 0) {
    if (g == 0) p = repro_torch::probe_load<WITH_TOMB>(visited, meta, tomb, b, W, id);
    load_codes(crow, kPer * g, m_sub, codes16, c);
  }
  if (STAGED) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  }
  // The constraint word (label) or bounds (range): in device memory issued
  // before the sums, in shared memory read after them, off the lookups' path.
  const int* qc = STAGED ? scons : qcons;
  float lo = 0.0f, hi = 0.0f;
  auto constraint = [&]() {
    if (FAMILY == kLabel) p.cword = repro_torch::label_word(qc, Lw, p.mval);
    if (FAMILY == kRange) {
      lo = __int_as_float(qc[0]);
      hi = __int_as_float(qc[1]);
    }
  };
  if (!STAGED && g == 0) constraint();

  const unsigned top = static_cast<unsigned>(n_cent - 1);
  const int base = (threadIdx.x & 31) & ~(kLanes - 1);
  float acc = step_sum<STAGED>(slut, qlut, c, 0, g, m_sub, n_cent, top, base, 0.0f);
  for (int s0 = kStep; s0 < m_sub; s0 += kStep) {
    if (id >= 0) load_codes(crow, s0 + kPer * g, m_sub, codes16, c);
    acc = step_sum<STAGED>(slut, qlut, c, s0, g, m_sub, n_cent, top, base, acc);
  }
  if (!live || g != 0) return;  // after the warp's last shuffle
  if (id < 0) {
    dists[slot] = __int_as_float(0x7f800000);
    sat[slot] = false;
    fresh[slot] = false;
    return;
  }
  if (STAGED) constraint();
  bool ok, fr;
  repro_torch::probe_verdicts<FAMILY, WITH_TOMB>(p, lo, hi, id, &ok, &fr);
  dists[slot] = acc;
  sat[slot] = ok;
  fresh[slot] = fr;
}

template <int FAMILY, bool WITH_TOMB, bool STAGED>
int launch(const float* lut, const int* codes, const int* ids, const int* visited,
           const int* meta, const int* cons, const int* tomb, float* dists, bool* sat,
           bool* fresh, int B, int M, int m_sub, int n_cent, int W, int Lw, bool codes16,
           bool lut16, size_t smem, cudaStream_t s) {
  auto* kernel = fused_expand_adc_kernel<FAMILY, WITH_TOMB, STAGED>;
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long lanes = static_cast<long long>(M) * kLanes;
  const int threads = lanes >= kMaxThreads ? kMaxThreads : static_cast<int>((lanes + 31) / 32 * 32);
  const int per_block = threads / kLanes;
  const dim3 grid = repro_torch::rows_grid((M + per_block - 1) / per_block, B);
  kernel<<<grid, threads, smem, s>>>(lut, codes, ids, visited, meta, cons, tomb, dists, sat,
                                     fresh, B, M, m_sub, n_cent, W, Lw, codes16, lut16);
  return 0;
}

}  // namespace

// lut (B, m_sub, n_cent) float32, codes (n, m_sub) int32; the rest as
// repro_fused_expand (fused_expand.cu).
extern "C" int repro_fused_expand_adc(const float* lut, const int* codes, const int* ids,
                                      const int* visited, const void* meta, const void* cons,
                                      const int* tomb, float* dists, bool* sat, bool* fresh,
                                      int B, int M, int m_sub, int n_cent, int W, int Lw,
                                      int family, int with_tomb, void* stream) {
  if (B == 0 || M == 0) return 0;
  if (m_sub < 1 || n_cent < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* mt = static_cast<const int*>(meta);
  const int* cs = static_cast<const int*>(cons);
  const size_t table = static_cast<size_t>(m_sub) * n_cent;
  const bool codes16 = m_sub % 4 == 0 && aligned16(codes);
  const bool lut16 = table % 4 == 0 && aligned16(lut);
  const size_t smem =
      (((table + 3) & ~static_cast<size_t>(3)) + repro_torch::cons_words(family, Lw)) *
      sizeof(float);
  const bool staged = smem <= kSmemLimit;
  int launched = 0;
  const int status = repro_torch::with_family(family, with_tomb, [&](auto fam, auto tmb) {
    constexpr int F = decltype(fam)::value;
    constexpr bool T = decltype(tmb)::value;
    launched = staged ? launch<F, T, true>(lut, codes, ids, visited, mt, cs, tomb, dists, sat,
                                           fresh, B, M, m_sub, n_cent, W, Lw, codes16, lut16,
                                           smem, s)
                      : launch<F, T, false>(lut, codes, ids, visited, mt, cs, tomb, dists, sat,
                                            fresh, B, M, m_sub, n_cent, W, Lw, codes16, lut16,
                                            0, s);
  });
  if (status != 0) return status;
  if (launched != 0) return launched;
  return static_cast<int>(cudaGetLastError());
}
