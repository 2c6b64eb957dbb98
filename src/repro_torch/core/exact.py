"""Exact (brute-force) constrained search: the recall oracle (port of
``repro.core.exact``)."""
from __future__ import annotations

import torch

from repro_torch.common.distances import squared_l2
from repro_torch.core.constraints import make_satisfied_fn
from repro_torch.core.types import Corpus


def exact_constrained_search(corpus: Corpus, queries, constraint, k: int, block: int = 65536):
    """Blocked exact constrained top-k -> ((B, k) dists, (B, k) int32 ids).

    Streams the corpus in ``block``-row chunks; the running top-k merges
    each block through a stable sort, so ties keep the lower id first, as
    the reference's ``lax.top_k`` does.
    """
    satisfied = make_satisfied_fn(constraint, corpus)
    b = queries.shape[0]
    dev = queries.device
    best_d = torch.full((b, k), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    for start in range(0, corpus.n, block):
        rows = corpus.vectors[start : start + block]
        ids = torch.arange(start, start + rows.shape[0], dtype=torch.int32, device=dev)
        ids_b = ids[None, :].expand(b, -1)
        d = torch.where(satisfied(ids_b), squared_l2(queries, rows), float("inf"))
        merged_d = torch.cat([best_d, d], -1)
        merged_i = torch.cat([best_i, ids_b], -1)
        sd, pos = torch.sort(merged_d, dim=-1, stable=True)
        best_d, best_i = sd[:, :k], merged_i.gather(1, pos[:, :k])
    best_i = torch.where(torch.isfinite(best_d), best_i, -1)
    return best_d, best_i


def recall(found_ids, true_ids) -> torch.Tensor:
    """Paper §3 recall: |A ∩ B| / |B| per query, averaged; padding (-1) in
    ``true_ids`` is excluded from B."""
    hits = (found_ids[:, :, None] == true_ids[:, None, :]) & (true_ids[:, None, :] >= 0)
    inter = hits.any(1).sum(-1)
    denom = (true_ids >= 0).sum(-1).clamp_min(1)
    return (inter / denom).float().mean()
