"""Uniform-fanout neighbour sampler over CSR adjacency, GraphSAGE-style (port
of ``repro.models.gnn.sampler``).

For seed nodes (B,), layer-wise uniform sampling with fanouts (f1, f2,
...) yields fixed-shape sampled subgraphs: the node set and a padded edge
list in local ids. Neighbours are drawn with replacement (a draw modulo
the degree); a node of degree 0 samples itself.

The reference draws each layer's (M, fanout) integers in [0, 2^30) with
``jax.random.randint(fold_in(rng, layer))``; ``draws`` takes those arrays
(one a layer) so that the port samples the same ids, and without them
the port draws from ``generator`` on the graph's device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

DRAW_HIGH = 1 << 30


def sample_neighbors(indptr, indices, nodes, fanout: int, *, draws=None,
                     generator: Optional[torch.Generator] = None):
    """``fanout`` neighbours of each node (M,), uniform with replacement ->
    (M, fanout) int32 (the node itself where its degree is 0)."""
    nodes = nodes.long()
    start = indptr[nodes].long()
    deg = indptr[nodes + 1].long() - start
    if draws is None:
        draws = torch.randint(0, DRAW_HIGH, (nodes.shape[0], fanout), generator=generator,
                              device=indices.device)
    offs = draws.to(indices.device).long() % torch.clamp_min(deg, 1)[:, None]
    nbr = indices[start[:, None] + offs].long()
    return torch.where(deg[:, None] > 0, nbr, nodes[:, None]).to(torch.int32)


def sample_subgraph(indptr, indices, seeds, fanouts: Sequence[int], *,
                    draws: Optional[Sequence] = None,
                    generator: Optional[torch.Generator] = None) -> dict:
    """Layered fanout sampling -> {"nodes" (N_sub,) the frontiers in order,
    seeds first; "senders" / "receivers" (E_sub,) local indices into
    ``nodes``: each layer's receivers are its frontier, its senders the
    next}. Shapes are fixed by (len(seeds), fanouts) (``subgraph_sizes``)."""
    dev = indices.device
    frontiers = [seeds.to(dev, torch.int32)]
    senders, receivers = [], []
    offset, next_offset = 0, seeds.shape[0]
    for li, f in enumerate(fanouts):
        cur = frontiers[-1]
        nbr = sample_neighbors(indptr, indices, cur, f, generator=generator,
                               draws=None if draws is None else draws[li])
        m = cur.shape[0]
        receivers.append(torch.repeat_interleave(
            torch.arange(m, dtype=torch.int32, device=dev) + offset, f))
        senders.append(torch.arange(m * f, dtype=torch.int32, device=dev) + next_offset)
        frontiers.append(nbr.reshape(-1))
        offset = next_offset
        next_offset += m * f
    return {"nodes": torch.cat(frontiers), "senders": torch.cat(senders),
            "receivers": torch.cat(receivers)}


def subgraph_sizes(n_seeds: int, fanouts: Sequence[int]) -> tuple[int, int]:
    """(n_nodes, n_edges) of the padded sampled subgraph."""
    n_nodes, n_edges, m = n_seeds, 0, n_seeds
    for f in fanouts:
        n_edges += m * f
        m = m * f
        n_nodes += m
    return n_nodes, n_edges
