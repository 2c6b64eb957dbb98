// The per-candidate verdicts shared by fused_expand.cu and fused_expand_adc.cu:
//   satisfied = constraint(meta[id]) && !tombstoned(id)
//   fresh     = visited bit (b, id) clear
// for a valid id (>= 0). Both fused kernels call these two functions, so
// they evaluate the visited word, the three constraint families, the
// tombstone bit and bit 31 of every word with one piece of code.
//
// The loads (probe_load) are split from the tests (probe_verdicts) so a
// kernel can issue them before its distance work and let their latency
// hide behind it.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace repro_torch {

// meta: int32 labels (label), float32 values as bits (range), int32
// verdicts (udf). cons: (B, Lw) int32 label words, (B, 2) float32 bounds
// as bits, or unused.
enum Family : int { kLabel = 0, kRange = 1, kUdf = 2 };

struct Probe {
  int vword;  // visited word (b, id >> 5)
  int mval;   // meta[id]
  int tword;  // tombstone word id >> 5 (0 without tombstones)
};

template <bool WITH_TOMB>
__device__ __forceinline__ Probe probe_load(const int* __restrict__ visited,
                                            const int* __restrict__ meta,
                                            const int* __restrict__ tomb, int b, int W, int id) {
  Probe p;
  p.vword = __ldg(visited + static_cast<size_t>(b) * W + (id >> 5));
  p.mval = __ldg(meta + id);
  p.tword = WITH_TOMB ? __ldg(tomb + (id >> 5)) : 0;
  return p;
}

template <int FAMILY, bool WITH_TOMB>
__device__ __forceinline__ void probe_verdicts(const Probe& p, const int* __restrict__ cons,
                                               int b, int Lw, int id, bool* ok_out,
                                               bool* fresh_out) {
  const unsigned bit = static_cast<unsigned>(id) & 31u;
  bool ok;
  if (FAMILY == kLabel) {
    const int lab = p.mval;
    ok = false;
    if (lab >= 0 && (lab >> 5) < Lw) {
      const unsigned cw =
          static_cast<unsigned>(__ldg(cons + static_cast<size_t>(b) * Lw + (lab >> 5)));
      ok = ((cw >> (static_cast<unsigned>(lab) & 31u)) & 1u) != 0u;
    }
  } else if (FAMILY == kRange) {
    const float v = __int_as_float(p.mval);
    const float lo = __int_as_float(__ldg(cons + 2 * b));
    const float hi = __int_as_float(__ldg(cons + 2 * b + 1));
    ok = (v >= lo) && (v <= hi);
  } else {
    ok = p.mval != 0;
  }
  if (WITH_TOMB) ok = ok && (((static_cast<unsigned>(p.tword) >> bit) & 1u) == 0u);
  *ok_out = ok;
  *fresh_out = ((static_cast<unsigned>(p.vword) >> bit) & 1u) == 0u;
}

// Words of cons per query row: Lw label words, 2 range bounds, none for udf.
inline size_t cons_words(int family, int Lw) {
  return family == kLabel ? static_cast<size_t>(Lw) : family == kRange ? 2 : 0;
}

// Call launch(std::integral_constant<int, FAMILY>, std::bool_constant<WITH_TOMB>)
// for the runtime (family, with_tomb); cudaErrorInvalidValue for an
// unknown family, else 0 (the caller then reads cudaGetLastError()).
template <typename Launch>
inline int with_family(int family, int with_tomb, Launch&& launch) {
  using L = std::integral_constant<int, kLabel>;
  using R = std::integral_constant<int, kRange>;
  using U = std::integral_constant<int, kUdf>;
  const bool t = with_tomb != 0;
  switch (family) {
    case kLabel: t ? launch(L{}, std::true_type{}) : launch(L{}, std::false_type{}); break;
    case kRange: t ? launch(R{}, std::true_type{}) : launch(R{}, std::false_type{}); break;
    case kUdf: t ? launch(U{}, std::true_type{}) : launch(U{}, std::false_type{}); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace repro_torch
