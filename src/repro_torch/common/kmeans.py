"""Lloyd's k-means (port of ``repro.common.kmeans``), used by the synthetic
labelling that reproduces the paper's SIFT labels."""
from __future__ import annotations

import torch

from repro_torch.common.distances import squared_l2


def kmeans(generator: torch.Generator, x, k: int, iters: int = 25):
    """Returns (centroids (k, d), assignment (n,) int32)."""
    n = x.shape[0]
    init_idx = torch.randperm(n, generator=generator, device=x.device)[:k]
    cent = x[init_idx].float()
    xf = x.float()
    for _ in range(iters):
        assign = squared_l2(xf, cent).argmin(-1)
        one_hot = torch.nn.functional.one_hot(assign, k).float()  # (n, k)
        counts = one_hot.sum(0)
        new = (one_hot.T @ xf) / counts[:, None].clamp_min(1.0)
        # Empty clusters stay where they were.
        cent = torch.where(counts[:, None] > 0, new, cent)
    assign = squared_l2(xf, cent).argmin(-1).to(torch.int32)
    return cent, assign
