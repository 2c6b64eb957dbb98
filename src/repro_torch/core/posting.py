"""Posting lists + brute-force posting-set scan executor (port of
``repro.core.posting``).

At <= 1% selectivity the graph walk spends its iterations on vertices that
fail; there the plan is no walk at all: gather the constraint's posting
set (the ids that can satisfy) and score exactly those with one batched
distance call. The scan uses the traversal's ``DistanceBackend.distances``,
so the exact, ``gather_distance`` kernel (``use_kernel``) and PQ backends
all work; the PQ path prunes with ADC and re-ranks its survivors exactly,
as the engine's post-loop re-rank does.

Host side, ``PostingLists`` keeps the per-label live id sets (updated by
the streaming layer beside the histograms) and ``RangeIndex`` a per-column
value-sorted id array (rebuilt lazily per epoch).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.common.bits import WORD_BITS
from repro_torch.core.engine.context import ExactBackend, build_context
from repro_torch.core.engine.loop import _best
from repro_torch.core.types import Corpus, SearchParams, SearchResult, SearchStats

PAD = -1


# ---------------------------------------------------------------------------
# host-side posting maintenance
# ---------------------------------------------------------------------------


class PostingLists:
    """Per-label LIVE id sets with cached sorted-array views.

    Mutations are O(1) set ops; ``ids_for_label`` materialises (and caches)
    the sorted int32 array a scan gathers with; the cache drops a label on
    the first mutation touching it.
    """

    def __init__(self, n_labels: int):
        self._sets: List[set] = [set() for _ in range(max(int(n_labels), 1))]
        self._cache: Dict[int, np.ndarray] = {}

    @classmethod
    def from_arrays(
        cls,
        labels: np.ndarray,
        live_mask: Optional[np.ndarray] = None,
        n_labels: Optional[int] = None,
    ) -> "PostingLists":
        labels = np.asarray(labels)
        nl = int(n_labels) if n_labels is not None else (
            int(labels.max()) + 1 if labels.size else 1
        )
        p = cls(nl)
        ids = np.arange(labels.shape[0])
        if live_mask is not None:
            ids = ids[np.asarray(live_mask, bool)]
        # One stable sort by label in place of a Python loop over the ids:
        # the same sets, each label's ids a contiguous run.
        lab = labels[ids].astype(np.int64)
        order = np.argsort(lab, kind="stable")
        lab, ids = lab[order], ids[order]
        p._grow(int(lab[-1]) if lab.size else 0)
        cuts = np.flatnonzero(np.diff(lab)) + 1
        for run_lab, run_ids in zip(lab[np.r_[0, cuts]] if lab.size else [],
                                    np.split(ids, cuts)):
            p._sets[int(run_lab)].update(run_ids.tolist())
        return p

    def _grow(self, label: int) -> None:
        while label >= len(self._sets):
            self._sets.append(set())

    def on_insert(self, label: int, slot: int) -> None:
        label = int(label)
        self._grow(label)
        self._sets[label].add(int(slot))
        self._cache.pop(label, None)

    def on_delete(self, label: int, slot: int) -> None:
        label = int(label)
        self._grow(label)
        self._sets[label].discard(int(slot))
        self._cache.pop(label, None)

    def count_label(self, label: int) -> int:
        label = int(label)
        return len(self._sets[label]) if label < len(self._sets) else 0

    def count_words(self, words: np.ndarray) -> int:
        """Posting-set size for a label-bitmask operand row."""
        return sum(self.count_label(lab) for lab in _labels_of_words(words))

    def ids_for_label(self, label: int) -> np.ndarray:
        label = int(label)
        if label >= len(self._sets):
            return np.empty((0,), np.int32)
        arr = self._cache.get(label)
        if arr is None:
            arr = np.fromiter(self._sets[label], np.int32, len(self._sets[label]))
            arr.sort()
            self._cache[label] = arr
        return arr

    def ids_for_words(self, words: np.ndarray) -> np.ndarray:
        """Sorted union of postings across every set bit of the operand."""
        labs = _labels_of_words(words)
        if not labs:
            return np.empty((0,), np.int32)
        if len(labs) == 1:
            return self.ids_for_label(labs[0])
        parts = [self.ids_for_label(lab) for lab in labs]
        return np.unique(np.concatenate(parts)).astype(np.int32)


def _labels_of_words(words: np.ndarray) -> List[int]:
    """Set bits of a label-bitmask row (uint32 words, or int32 with the same
    bits) as label ids, ascending."""
    labs: List[int] = []
    for w, word in enumerate(np.asarray(words).astype(np.uint32).reshape(-1)):
        word = int(word)
        while word:
            bit = (word & -word).bit_length() - 1
            labs.append(w * WORD_BITS + bit)
            word &= word - 1
    return labs


class RangeIndex:
    """Per-column value-sorted LIVE ids; a [lo, hi] posting is one slice.

    Rebuilt lazily: callers pass a ``version`` (the streaming layer passes
    its epoch) and the sort re-runs only when it moved; a lookup is then two
    binary searches.
    """

    def __init__(self):
        self.version = -1
        self._order: Dict[int, np.ndarray] = {}  # col -> ids sorted by value
        self._vals: Dict[int, np.ndarray] = {}  # col -> sorted values

    def refresh(self, attrs: np.ndarray, live_mask: np.ndarray, version: int) -> None:
        if version == self.version:
            return
        attrs = np.asarray(attrs)
        live = np.nonzero(np.asarray(live_mask, bool))[0].astype(np.int32)
        self._order.clear()
        self._vals.clear()
        for c in range(attrs.shape[1]):
            v = attrs[live, c]
            o = np.argsort(v, kind="stable")
            self._order[c] = live[o]
            self._vals[c] = v[o]
        self.version = version

    def ids_for_range(self, lo: float, hi: float, col: int) -> np.ndarray:
        vals = self._vals.get(int(col))
        if vals is None:
            return np.empty((0,), np.int32)
        a = int(np.searchsorted(vals, lo, side="left"))
        b = int(np.searchsorted(vals, hi, side="right"))
        out = self._order[int(col)][a:b]
        return np.sort(out).astype(np.int32)

    def count_range(self, lo: float, hi: float, col: int) -> int:
        vals = self._vals.get(int(col))
        if vals is None:
            return 0
        return int(np.searchsorted(vals, hi, side="right")) - int(
            np.searchsorted(vals, lo, side="left")
        )


def pad_posting(ids: np.ndarray, bucket: int) -> np.ndarray:
    """Pad a posting array to ``bucket`` with PAD (-1) for shape reuse."""
    out = np.full((bucket,), PAD, np.int32)
    out[: ids.shape[0]] = ids
    return out


def posting_bucket(count: int, ladder=(256, 1024, 4096, 16384)) -> int:
    """Smallest ladder bucket holding ``count`` postings, else ``count``."""
    for b in ladder:
        if count <= b:
            return b
    return int(count)


# ---------------------------------------------------------------------------
# the scan itself
# ---------------------------------------------------------------------------


def posting_scan_with_context(ctx, corpus: Corpus, queries, posting_ids,
                              params: SearchParams) -> SearchResult:
    """Brute-force top-k over a padded posting set via the context backend.

    posting_ids: (P,) int32, PAD (-1) entries ignored, shared across the
    batch. The constraint closure still runs over the postings: it masks
    pads, tombstones and any id a multi-label or range posting union
    over-included. An all-PAD set returns all-unfilled (+inf, -1) rows.

    Approximate backends (PQ / ADC) prune to ``result_capacity`` and then
    re-rank exactly, the engine's post-loop contract.
    """
    b = queries.shape[0]
    p = posting_ids.shape[0]
    ids_b = posting_ids.to(torch.int32)[None, :].expand(b, p).contiguous()
    d = ctx.backend.distances(queries, ids_b)  # (B, P)
    ok = ctx.satisfied(ids_b)  # masks pads, tombstones, constraint
    d = torch.where(ok, d, float("inf"))
    ids_live = torch.where(ok, ids_b, PAD)

    if ctx.backend.approximate:
        r = min(params.result_capacity, p)
        _, pos = _best(d, r)
        cand_ids = ids_live.gather(1, pos).contiguous()
        exact_d = ExactBackend(vectors=corpus.vectors).distances(queries, cand_ids)
        d = torch.where(cand_ids >= 0, exact_d, float("inf"))
        ids_live = cand_ids
        p = r

    k = params.k
    if p < k:
        d = torch.nn.functional.pad(d, (0, k - p), value=float("inf"))
        ids_live = torch.nn.functional.pad(ids_live, (0, k - p), value=PAD)
    out_d, pos = _best(d, k)
    out_i = ids_live.gather(1, pos)
    out_i = torch.where(torch.isfinite(out_d), out_i, PAD)

    n_real = (posting_ids >= 0).sum(dtype=torch.int32)
    stats = SearchStats(
        dist_evals=n_real.expand(b).clone(),
        hops=torch.zeros((b,), dtype=torch.int32, device=queries.device),
        visited=ok.sum(-1, dtype=torch.int32),
        iters=torch.zeros((), dtype=torch.int32, device=queries.device),
    )
    return SearchResult(dists=out_d, ids=out_i, stats=stats)


def posting_search(corpus: Corpus, queries, constraint, posting_ids, params: SearchParams,
                   pq_index=None) -> SearchResult:
    """Posting-set brute-force constrained top-k.

    The calling convention of ``constrained_search`` plus the (P,) padded
    posting ids (int32, on the queries' device). ``params.use_kernel``
    scores through ``gather_distance``; ``approx="pq"`` needs ``pq_index``.
    """
    ctx = build_context(corpus, constraint, queries, params, pq_index)
    return posting_scan_with_context(ctx, corpus, queries, posting_ids, params)
