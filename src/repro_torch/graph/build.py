"""Proximity-graph construction (port of ``repro.graph.build``).

Two builders, one contract: ``build_knn_graph`` is the blocked exact kNN
graph, whose pairwise blocks come from the ``l2_matmul`` kernel
(``kernels/l2_matmul.py::pairwise_sqdist``); ``nn_descent`` is the
reference's neighbour-of-neighbour refinement, whose row-wise distances
come from the ``gather_distance`` kernel. ``add_reverse_edges`` symmetrises
either under the degree bound. All emit the invariants the searcher and the
Eq.-1 estimator rely on: rows distance-ascending, self-free,
duplicate-free, padded with -1.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch

from repro_torch.common.device import check_generator, resolve_device
from repro_torch.core.queue import _dist_bits
from repro_torch.kernels.gather_distance import gather_distance
from repro_torch.kernels.l2_matmul import pairwise_sqdist

PAD = -1
INT32_MAX = 2**31 - 1
PLAIN_GATHER_ELEMS = 1 << 24  # elements of one (rows, C, d) gather on the CPU


@contextmanager
def span(spans: Optional[Dict[str, List]], name: str, device: torch.device):
    """Record the span's device time under ``spans[name]``: a pair of CUDA
    events on the card, seconds of host time on the CPU. No-op for None."""
    if spans is None:
        yield
        return
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        spans.setdefault(name, []).append((start, end))
    else:
        t0 = time.perf_counter()
        yield
        spans.setdefault(name, []).append(time.perf_counter() - t0)


def span_seconds(spans: Dict[str, List]) -> Dict[str, float]:
    """Total seconds per span name (synchronises the card first)."""
    if any(isinstance(v, tuple) for vals in spans.values() for v in vals):
        torch.cuda.synchronize()
    return {name: sum(v[0].elapsed_time(v[1]) / 1e3 if isinstance(v, tuple) else v for v in vals)
            for name, vals in spans.items()}


def build_knn_graph(vectors, degree: int, block: int = 1024, *, spans=None):
    """Exact kNN adjacency (n, degree) int32, distance-ascending, self excluded.

    Ties in distance may order differently from the reference (``topk``
    does not promise an order among equal keys). The self mask stays
    explicit: the expansion does not give exactly 0 on the diagonal for
    float data. ``spans`` (a dict, optional) collects the device time of
    the products ("products") and of the masks and top-k ("topk").
    """
    vectors = vectors.float().contiguous()
    n = vectors.shape[0]
    dev = vectors.device
    out = torch.empty((n, degree), dtype=torch.int32, device=dev)
    for start in range(0, n, block):
        rows = vectors[start : start + block]
        with span(spans, "products", dev):
            d = pairwise_sqdist(rows, vectors)  # (blk, n)
        with span(spans, "topk", dev):
            rid = torch.arange(start, start + rows.shape[0], device=dev)
            d[torch.arange(rows.shape[0], device=dev), rid] = float("inf")  # no self
            dist, idx = torch.topk(d, degree, dim=-1, largest=False, sorted=True)
            out[start : start + rows.shape[0]] = torch.where(torch.isfinite(dist), idx, PAD)
        del d
    return out


def _dedup_sorted_by_dist(ids, dists, degree: int):
    """Per row: drop duplicate and invalid ids, keep the ``degree`` closest.

    ids: (n, C) int32 (PAD for invalid), dists: (n, C) float32. The
    reference's two stable argsorts, as ``torch.sort(stable=True)``: by id
    (invalid keyed as int32 max), so duplicates meet and all but the first
    become +inf; then by distance, ties in ascending id.
    """
    invalid = ids < 0
    d = torch.where(invalid, float("inf"), dists)
    key = torch.where(invalid, INT32_MAX, ids)
    id_order = torch.sort(key, dim=-1, stable=True).indices
    ids_s = ids.gather(-1, id_order)
    d_s = d.gather(-1, id_order)
    dup = torch.zeros_like(invalid)
    dup[:, 1:] = ids_s[:, 1:] == ids_s[:, :-1]
    d_s = torch.where(dup, float("inf"), d_s)
    order = torch.sort(d_s, dim=-1, stable=True).indices[:, :degree]
    ids_f = ids_s.gather(-1, order)
    d_f = d_s.gather(-1, order)
    return torch.where(torch.isfinite(d_f), ids_f, PAD), d_f


def _row_dists(vectors, cand):
    """(n, C) candidate ids -> ||x_cand - x_row||^2, +inf for self and PAD.

    The rows go through ``gather_distance`` with their own vectors as
    queries, so the (n, C, d) gather is never whole on the card (64 GB at
    n = 1M, C = 128, d = 128): one launch over all n rows. On the CPU, whose
    plain version materialises the gather, in chunks of
    ``PLAIN_GATHER_ELEMS`` gathered elements.
    """
    n, c = cand.shape
    dev = vectors.device
    chunk = n if dev.type == "cuda" else PLAIN_GATHER_ELEMS // (c * vectors.shape[1])
    chunk = max(1, chunk)
    out = torch.empty((n, c), dtype=torch.float32, device=dev)
    for s in range(0, n, chunk):
        ids = cand[s : s + chunk]
        d = gather_distance(vectors[s : s + chunk], vectors, ids)
        rid = torch.arange(s, s + ids.shape[0], device=dev, dtype=torch.int32)[:, None]
        out[s : s + chunk] = torch.where(ids == rid, float("inf"), d)
    return out


def round_candidates(nbrs, cols, rand):
    """One NN-descent round's (n, degree * (1 + n_extra) + degree) candidate
    ids: the current neighbours, ``nbrs[nbrs[i, j], cols[i, j, e]]`` (the
    neighbours of neighbours, by flat index, without the (n, degree, degree)
    gather; a PAD neighbour reads row 0, as in the reference), and ``rand``."""
    n, degree = nbrs.shape
    dev = nbrs.device
    safe = nbrs.clamp_min(0).long()
    flat = safe[:, :, None] * degree + cols.to(device=dev).long()
    nn2 = nbrs.reshape(-1)[flat.reshape(n, -1)]
    del flat, safe
    return torch.cat([nbrs, nn2, rand.to(device=dev, dtype=torch.int32)], dim=-1)


def nn_descent(generator: torch.Generator, vectors, degree: int, iters: int = 8,
               n_extra: int = 2, *, draws: Optional[Dict[str, object]] = None,
               device="cuda", spans=None):
    """NN-descent approximate kNN graph (n, degree) int32 (port of
    ``repro.graph.build.nn_descent``).

    Each round considers, per vertex: its current neighbours, ``n_extra``
    edges of each neighbour (neighbours of neighbours), and ``degree``
    fresh random vertices; it keeps the ``degree`` closest.

    ``draws`` replaces the random ints with given ones: ``k0`` (n, degree)
    in [0, n), and per round ``cols[r]`` (n, degree, n_extra) in
    [0, degree) and ``rand[r]`` (n, degree) in [0, n), integer tensors on
    any device. Without it they are drawn from ``generator``. The graph is
    built on ``device``, where ``vectors`` must lie. ``spans`` (a dict,
    optional) collects the device time of the row distances ("distances")
    and of the dedup sorts ("sorts"), as in ``build_knn_graph``.
    """
    n = vectors.shape[0]
    dev = resolve_device(device)
    if vectors.device.type != dev.type:
        raise ValueError(f"vectors are on {vectors.device}, the graph goes to {dev}")
    vectors = vectors.float().contiguous()
    if draws is None:
        check_generator(generator, dev)

        def randint(high, shape):
            return torch.randint(0, high, shape, generator=generator, device=dev,
                                 dtype=torch.int32)

        k0 = randint(n, (n, degree))
    else:
        k0, cols_r, rand_r = draws["k0"], draws["cols"], draws["rand"]
        if len(cols_r) != iters or len(rand_r) != iters:
            raise ValueError(f"draws hold {len(cols_r)} / {len(rand_r)} rounds, iters={iters}")

    def refine(cand):
        with span(spans, "distances", dev):
            dists = _row_dists(vectors, cand)
        with span(spans, "sorts", dev):
            return _dedup_sorted_by_dist(cand, dists, degree)[0]

    nbrs = refine(k0.to(device=dev, dtype=torch.int32).contiguous())
    for r in range(iters):
        if draws is None:
            cols, rand = randint(degree, (n, degree, n_extra)), randint(n, (n, degree))
        else:
            cols, rand = cols_r[r], rand_r[r]
        nbrs = refine(round_candidates(nbrs, cols, rand))
    return nbrs


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
    return pairwise_sqdist(mean, vectors.float().contiguous())[0].argmin().to(torch.int32)
