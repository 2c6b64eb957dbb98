"""The original three-stage pipeline (paper Fig. 1, upper path); port of
``repro.core.pipeline``.

Stage 1: unconstrained ANN retrieves ``s`` candidates; stage 2 filters them
by the constraint; stage 3 re-ranks the survivors to top-k. This is the
baseline AIRSHIP replaces: ``n_survived < k`` is the failure the paper
motivates with.
"""
from __future__ import annotations

import torch

from repro_torch.core.constraints import LabelSetConstraint, make_satisfied_fn
from repro_torch.core.engine.loop import constrained_search
from repro_torch.core.types import Corpus, GraphIndex, SearchParams


def _allpass_constraint(batch: int, device, n_label_words: int = 64) -> LabelSetConstraint:
    """Bitmask accepting every label id < 64 * 32 = 2048 (stage 1); the
    reference's 0xFFFFFFFF words are int32 -1 here."""
    return LabelSetConstraint(
        words=torch.full((batch, n_label_words), -1, dtype=torch.int32, device=device))


def three_stage_pipeline(corpus: Corpus, graph: GraphIndex, queries, constraint, s: int, k: int,
                         ef: int = 0):
    """Returns (dists (B, k), ids (B, k), n_survived (B,) int32)."""
    ef = ef or max(2 * s, 64)
    # Stage 1: unconstrained top-s (vanilla search with an all-pass filter).
    params = SearchParams(mode="vanilla", k=s, ef_result=max(s, 64), ef_sat=8, ef_other=ef,
                          max_iters=4 * ef)
    res = constrained_search(corpus, graph, queries,
                             _allpass_constraint(queries.shape[0], queries.device), params)
    # Stage 2: filter the s candidates.
    satisfied = make_satisfied_fn(constraint, corpus)
    ok = satisfied(res.ids) & (res.ids >= 0)
    n_survived = ok.sum(-1, dtype=torch.int32)
    # Stage 3: the survivors, already distance-sorted, cut to k; the stable
    # sort keeps the reference's top_k order among equal distances.
    d = torch.where(ok, res.dists, float("inf"))
    d, pos = torch.sort(d, dim=-1, stable=True)
    d, pos = d[:, :k], pos[:, :k]
    ids = res.ids.gather(1, pos)
    ids = torch.where(torch.isfinite(d), ids, -1)
    return d, ids, n_survived
