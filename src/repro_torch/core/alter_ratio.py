"""alter_ratio estimation, paper §2.4 Eq. 1 (port of ``repro.core.alter_ratio``).

Adjacency rows are distance-sorted at build time, so the first ``k`` edges
of a vertex are its approximate k nearest neighbours:

    alter_ratio = mean over sampled satisfied vertices v of
                  |{satisfied u : u in top-k edges of v}| / k
"""
from __future__ import annotations

import torch

from repro_torch.core.types import GraphIndex, SatisfiedFn


def estimate_alter_ratio(
    graph: GraphIndex,
    satisfied: SatisfiedFn,
    sample_sat_mask: torch.Tensor,
    k: int,
    default: float = 0.5,
) -> torch.Tensor:
    """(B,) float32 per-query estimate in [0, 1]; ``default`` where no
    sample vertex satisfies the query's constraint.

    sample_sat_mask: (B, S) bool, which of ``graph.sample_ids`` satisfy
    each query (``estimator.sample_satisfied_mask``).
    """
    sample = graph.sample_ids.long()
    b, s = sample_sat_mask.shape
    k = min(k, graph.degree)
    nbrs = graph.neighbors[sample, :k]  # (S, k)
    nbrs_b = nbrs[None].expand(b, s, k)
    nb_sat = satisfied(nbrs_b.reshape(b, -1)).reshape(b, s, k)
    valid = nbrs_b >= 0
    frac = (nb_sat & valid).float().sum(-1) / valid.float().sum(-1).clamp_min(1.0)
    m = sample_sat_mask.float()
    n_sat = m.sum(-1)
    est = pinned_sum(frac * m) / n_sat.clamp_min(1.0)
    return torch.where(n_sat > 0, est, default)


def pinned_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in one fixed order on every device: zero-pad
    to a power of two, then add the upper half onto the lower until one
    column is left. ``torch.sum`` reduces in each device's own order, so
    the card and the CPU would round a sum of inexact fractions (c / 12)
    differently and their walks would part."""
    width = 1 << max(0, (x.shape[-1] - 1).bit_length())
    x = torch.nn.functional.pad(x, (0, width - x.shape[-1]))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]
