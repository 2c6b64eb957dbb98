"""Proximity-graph construction (port of ``repro.graph.build``).

``build_knn_graph`` is the blocked exact kNN graph; ``add_reverse_edges``
symmetrises it under the degree bound. Both emit the invariants the
searcher and the Eq.-1 estimator rely on: rows distance-ascending,
self-free, duplicate-free, padded with -1. ``nn_descent`` is not ported
yet.
"""
from __future__ import annotations

import torch

from repro_torch.common.distances import squared_l2
from repro_torch.core.queue import _dist_bits

PAD = -1


def build_knn_graph(vectors, degree: int, block: int = 1024):
    """Exact kNN adjacency (n, degree) int32, distance-ascending, self excluded.

    Ties in distance may order differently from the reference (``topk``
    does not promise an order among equal keys).
    """
    n = vectors.shape[0]
    out = torch.empty((n, degree), dtype=torch.int32, device=vectors.device)
    for start in range(0, n, block):
        rows = vectors[start : start + block]
        d = squared_l2(rows, vectors)  # (blk, n)
        rid = torch.arange(start, start + rows.shape[0], device=vectors.device)
        d[torch.arange(rows.shape[0], device=vectors.device), rid] = float("inf")  # no self
        dist, idx = torch.topk(d, degree, dim=-1, largest=False, sorted=True)
        out[start : start + rows.shape[0]] = torch.where(torch.isfinite(dist), idx, PAD)
        del d
    return out


def _edge_sqdist(vectors, rows, cands, chunk: int = 1 << 20):
    """||x_cand - x_row||^2 per edge, as the reference's row-wise sum."""
    out = torch.empty(rows.shape[0], dtype=torch.float32, device=vectors.device)
    for s in range(0, rows.shape[0], chunk):
        diff = vectors[cands[s : s + chunk]].float() - vectors[rows[s : s + chunk]].float()
        out[s : s + chunk] = (diff * diff).sum(-1)
    return out


def add_reverse_edges(neighbors, vectors, degree: int):
    """Symmetrise under the degree bound, vectorised over the edge list.

    Row v's candidates are its own edges and every u with an edge u -> v.
    They are deduplicated and the ``degree`` closest kept, ordered by
    (distance, id): the reference's order, whose stable sorts break
    distance ties by ascending id.
    """
    n, deg = neighbors.shape
    dev = neighbors.device
    src = torch.arange(n, device=dev).repeat_interleave(deg)
    dst = neighbors.reshape(-1).long()
    keep = (dst >= 0) & (dst != src)
    src, dst = src[keep], dst[keep]
    d = _edge_sqdist(vectors, src, dst)  # the same bits for (u, v) and (v, u)
    rows = torch.cat([src, dst])
    cands = torch.cat([dst, src])
    dist = torch.cat([d, d])
    # Order by (row, dist, cand): a stable sort on (dist-bits, cand), then
    # a stable sort on row.
    order = torch.sort((_dist_bits(dist) << 32) | cands, stable=True).indices
    order = order[torch.sort(rows[order], stable=True).indices]
    rows, cands, dist = rows[order], cands[order], dist[order]
    first = torch.ones_like(rows, dtype=torch.bool)
    first[1:] = (rows[1:] != rows[:-1]) | (cands[1:] != cands[:-1])
    rows, cands, dist = rows[first], cands[first], dist[first]
    keep = torch.isfinite(dist)
    rows, cands = rows[keep], cands[keep]
    # Rank within each row's segment.
    counts = torch.bincount(rows, minlength=n)
    seg_start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(rows.shape[0], device=dev) - seg_start[rows]
    sel = rank < degree
    out = torch.full((n, degree), PAD, dtype=torch.int32, device=dev)
    out[rows[sel], rank[sel]] = cands[sel].to(torch.int32)
    return out


def medoid(vectors):
    """Approximate medoid: the vector closest to the corpus mean, () int32."""
    mean = vectors.float().mean(0, keepdim=True)
    return squared_l2(mean, vectors)[0].argmin().to(torch.int32)
