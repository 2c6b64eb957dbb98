"""alter_ratio estimation, paper §2.4 Eq. 1 (port of ``repro.core.alter_ratio``).

Adjacency rows are distance-sorted at build time, so the first ``k`` edges
of a vertex are its approximate k nearest neighbours:

    alter_ratio = mean over sampled satisfied vertices v of
                  |{satisfied u : u in top-k edges of v}| / k
"""
from __future__ import annotations

import torch

from repro_torch.core.types import GraphIndex, SatisfiedFn

_CHUNK = 32  # the width of XLA's CPU row reduce, which pinned_sum reproduces


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
    """Sum over the last axis in one fixed order on every device, the order
    of the reference's XLA CPU reduce: view the axis as (S / 32, 32), sum
    each 32-wide chunk left to right, one column add at a time, then the
    chunk sums left to right. ``torch.sum`` reduces in each device's own
    order, so the card and the CPU would round a sum of inexact fractions
    (c / 12) differently and their walks would part.

    A width that is not a multiple of 32 is padded with +0.0 to one (an
    exact no-op on these non-negative terms), which keeps one order on every
    device; there the reference's order is not known (measured at width 100
    it is neither this one nor left to right), so such widths match it only
    where the arithmetic is exact."""
    s = x.shape[-1]
    width = max(_CHUNK, -(-s // _CHUNK) * _CHUNK)
    x = torch.nn.functional.pad(x, (0, width - s)).unflatten(-1, (-1, _CHUNK))
    chunk = x[..., 0]
    for j in range(1, _CHUNK):
        chunk = chunk + x[..., j]
    total = chunk[..., 0]
    for i in range(1, chunk.shape[-1]):
        total = total + chunk[..., i]
    return total
