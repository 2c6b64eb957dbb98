// The per-candidate verdicts shared by fused_expand.cu and fused_expand_adc.cu:
//   satisfied = constraint(meta[id]) && !tombstoned(id)
//   fresh     = visited bit (b, id) clear
// for a valid id (>= 0). Both fused kernels call probe_verdicts, so they
// evaluate the visited word, the three constraint families, the tombstone
// bit and bit 31 of every word with one piece of code.
//
// The loads are the kernels' own, so each issues them where its latency
// hides best: probe_load (visited, meta and tombstone words) beside the
// candidate's row or code loads; the label family's constraint word
// (Probe::cword, word lab >> 5 of the query's row) as soon as meta[id]
// arrives, from wherever the kernel keeps the query's row (registers,
// shared memory or device memory) and before its distance is reduced; the
// range family's two bounds once per query.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace repro_torch {

// meta: int32 labels (label), float32 values as bits (range), int32
// verdicts (udf). cons: (B, Lw) int32 label words, (B, 2) float32 bounds
// as bits, or unused.
enum Family : int { kLabel = 0, kRange = 1, kUdf = 2 };

struct Probe {
  int vword;       // visited word (b, id >> 5)
  int mval;        // meta[id]
  int tword;       // tombstone word id >> 5 (0 without tombstones)
  unsigned cword;  // label family: word mval >> 5 of the query's row, 0 outside the row
};

template <bool WITH_TOMB>
__device__ __forceinline__ Probe probe_load(const int* __restrict__ visited,
                                            const int* __restrict__ meta,
                                            const int* __restrict__ tomb, long long b, int W,
                                            int id) {
  Probe p;
  p.vword = __ldg(visited + static_cast<size_t>(b) * W + (id >> 5));
  p.mval = __ldg(meta + id);
  p.tword = WITH_TOMB ? __ldg(tomb + (id >> 5)) : 0;
  p.cword = 0u;
  return p;
}

// Whether label lab has a bit in a row of Lw words.
__device__ __forceinline__ bool label_in_row(int lab, int Lw) {
  return lab >= 0 && (lab >> 5) < Lw;
}

// Word lab >> 5 of a row of Lw words (shared or device memory), 0 outside it.
__device__ __forceinline__ unsigned label_word(const int* row, int Lw, int lab) {
  return label_in_row(lab, Lw) ? static_cast<unsigned>(row[lab >> 5]) : 0u;
}

// lo, hi: the range family's bounds for the query (unused otherwise).
template <int FAMILY, bool WITH_TOMB>
__device__ __forceinline__ void probe_verdicts(const Probe& p, float lo, float hi, int id,
                                               bool* ok_out, bool* fresh_out) {
  const unsigned bit = static_cast<unsigned>(id) & 31u;
  bool ok;
  if (FAMILY == kLabel) {
    ok = ((p.cword >> (static_cast<unsigned>(p.mval) & 31u)) & 1u) != 0u;
  } else if (FAMILY == kRange) {
    const float v = __int_as_float(p.mval);
    ok = (v >= lo) && (v <= hi);
  } else {
    ok = p.mval != 0;
  }
  if (WITH_TOMB) ok = ok && (((static_cast<unsigned>(p.tword) >> bit) & 1u) == 0u);
  *ok_out = ok;
  *fresh_out = ((static_cast<unsigned>(p.vword) >> bit) & 1u) == 0u;
}

// Words of cons per query row: Lw label words, 2 range bounds, none for udf.
__host__ __device__ __forceinline__ int cons_words(int family, int Lw) {
  return family == kLabel ? Lw : family == kRange ? 2 : 0;
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
