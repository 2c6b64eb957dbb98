"""Label-subgraph overlays: cached sub-indexes over hot posting sets (port
of ``repro.core.overlay``).

Between ~1% and ~5% selectivity the full-graph walk still wastes most
expansions on vertices that fail, yet the posting set is too large to
scan per request. For a hot label the answer is a small proximity graph
over exactly its posting set, built on first use (the exact kNN graph,
through ``l2_matmul``), cached, and walked by the standard engine: every
vertex satisfies.

An overlay is pinned to the streaming epoch it was built from;
``OverlayCache.get`` rebuilds on an epoch mismatch, so a stale overlay is
never served. Sub-corpora pad to a size ladder with tombstoned pad slots.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.common.bits import WORD_BITS, tail_bits, to_i32
from repro_torch.common.device import check_generator, resolve_device
from repro_torch.core.constraints import LabelSetConstraint
from repro_torch.core.types import Corpus, GraphIndex, SearchParams, SearchResult

PAD = -1

OVERLAY_BUCKETS = (256, 1024, 4096, 16384)


def overlay_bucket(count: int, ladder=OVERLAY_BUCKETS) -> int:
    for b in ladder:
        if count <= b:
            return b
    return int(count)


@dataclass(frozen=True)
class LabelOverlay:
    """One label's cached sub-index (tensors on one device)."""

    corpus: Corpus  # (bucket, d) rows; pad slots tombstoned
    graph: GraphIndex  # (bucket, deg) local adjacency; pad rows all-PAD
    ids_dev: torch.Tensor  # (bucket,) int32 local -> global slot map; PAD pads
    label: int = 0
    epoch: int = 0
    n_real: int = 0


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))


def build_overlay(label: int, posting_ids: np.ndarray, vectors, epoch: int, *,
                  generator: Optional[torch.Generator] = None, sample=None,
                  degree: int = 12, sample_size: int = 64, bucket: Optional[int] = None,
                  device="cuda") -> LabelOverlay:
    """Build one label's overlay from its LIVE posting ids.

    ``vectors``: the (n, d) corpus rows, a tensor or numpy array (moved to
    ``device``). Needs P >= 2 postings. The sub-corpus pads to the ladder
    ``bucket`` with zero rows, tombstoned and labelled -2, so they fail
    the equal-label constraint two ways. The sub-index is
    ``build_index(method="exact")``'s: the kNN graph of degree
    min(degree, P - 1) (``l2_matmul``, one launch per 1024 rows) with
    reverse edges, the medoid entry (one more launch), and a sample of
    min(sample_size, P) local ids drawn without replacement: ``sample``
    where given (the tests pass the reference's draw, which comes from
    ``jax.random.PRNGKey((label * 1_000_003 + epoch) & 0x7FFFFFFF)``),
    else from ``generator``.
    """
    from repro_torch.graph.build import add_reverse_edges, build_knn_graph, medoid

    dev = resolve_device(device)
    posting_ids = np.asarray(posting_ids, np.int32)
    p = int(posting_ids.shape[0])
    if p < 2:
        raise ValueError(f"overlay needs >= 2 postings, got {p}")
    b = int(bucket) if bucket is not None else overlay_bucket(p)
    vectors = _as_tensor(vectors)
    ids_t = torch.from_numpy(posting_ids).to(vectors.device).long()
    real = vectors[ids_t].to(device=dev, dtype=torch.float32).contiguous()
    d = real.shape[1]
    deg = min(int(degree), p - 1)
    n_sample = min(int(sample_size), p)

    sub_nbrs = add_reverse_edges(build_knn_graph(real, deg), real, deg)
    if sample is None:
        if generator is None:
            raise ValueError("build_overlay needs a generator or the sample")
        check_generator(generator, dev)
        sample = torch.randperm(p, generator=generator, device=dev)[:n_sample]
    sample = _as_tensor(sample).to(device=dev, dtype=torch.int32).reshape(-1)
    if sample.shape[0] != n_sample:
        raise ValueError(f"sample holds {sample.shape[0]} ids, expected {n_sample}")

    rows = torch.zeros((b, d), dtype=torch.float32, device=dev)
    rows[:p] = real
    labels = torch.full((b,), -2, dtype=torch.int32, device=dev)
    labels[:p] = int(label)
    # Adjacency pads to the REQUESTED degree and the sample to a fixed
    # length (cycling its ids, as np.resize does; the engine's seeding
    # dedups repeats), so every overlay in a bucket shares its shapes.
    nbrs = torch.full((b, int(degree)), PAD, dtype=torch.int32, device=dev)
    nbrs[:p, :deg] = sub_nbrs
    reps = math.ceil(int(sample_size) / n_sample)
    sample = sample.repeat(reps)[: int(sample_size)]
    ids_map = torch.full((b,), PAD, dtype=torch.int32, device=dev)
    ids_map[:p] = ids_t.to(device=dev, dtype=torch.int32)
    corpus = Corpus(vectors=rows, labels=labels,
                    tombstones=torch.from_numpy(tail_bits(p, b).view(np.int32)).to(dev))
    graph = GraphIndex(neighbors=nbrs, sample_ids=sample, entry_point=medoid(real))
    return LabelOverlay(corpus=corpus, graph=graph, ids_dev=ids_map, label=int(label),
                        epoch=int(epoch), n_real=p)


def overlay_search(overlay: LabelOverlay, queries, params: SearchParams) -> SearchResult:
    """Traversal over the overlay's sub-graph; global ids out.

    The constraint is the overlay's own equal-label mask: every real
    sub-row satisfies, pad rows fail by tombstone and label. Local result
    ids map back through ``ids_dev``.
    """
    from repro_torch.core.engine.loop import constrained_search

    bq = queries.shape[0]
    lab = overlay.label
    words = torch.zeros((bq, lab // WORD_BITS + 1), dtype=torch.int64, device=queries.device)
    words[:, lab // WORD_BITS] = 1 << (lab % WORD_BITS)
    constraint = LabelSetConstraint(words=to_i32(words))
    res = constrained_search(overlay.corpus, overlay.graph, queries, constraint, params)
    local = res.ids
    global_ids = torch.where(local >= 0, overlay.ids_dev[local.clamp_min(0).long()], PAD)
    return SearchResult(dists=res.dists, ids=global_ids, stats=res.stats)


class OverlayCache:
    """LRU cache of built overlays, keyed by label, pinned to an epoch.

    ``get`` returns a fresh overlay for (label, epoch): a cached overlay
    from an older epoch is dropped and rebuilt. ``build_fn(label, epoch)``
    supplies the rebuild (the serving layer closes it over the current
    snapshot's postings and vectors).
    """

    def __init__(self, max_overlays: int = 8):
        self.max_overlays = int(max_overlays)
        self._cache: "OrderedDict[int, LabelOverlay]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.builds = 0
        self.invalidations = 0

    def get(self, label: int, epoch: int,
            build_fn: Callable[[int, int], Optional[LabelOverlay]]) -> Optional[LabelOverlay]:
        label = int(label)
        cached = self._cache.get(label)
        if cached is not None:
            if cached.epoch == int(epoch):
                self.hits += 1
                self._cache.move_to_end(label)
                return cached
            # the epoch moved under us: never serve stale
            self.invalidations += 1
            del self._cache[label]
        self.misses += 1
        overlay = build_fn(label, int(epoch))
        if overlay is None:
            return None
        if overlay.epoch != int(epoch):
            raise ValueError(f"build_fn returned epoch {overlay.epoch}, expected {epoch}")
        self.builds += 1
        self._cache[label] = overlay
        self._cache.move_to_end(label)
        while len(self._cache) > self.max_overlays:
            self._cache.popitem(last=False)
        return overlay

    def stats(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "builds": self.builds,
            "invalidations": self.invalidations,
            "resident": len(self._cache),
        }
