"""Index assembly: graph + pre-drawn sample + entry point, and the
row-partitioned layout of the distributed scatter-search-merge path (port
of ``repro.graph.index``)."""
from __future__ import annotations

import torch

from repro_torch.common.device import check_generator, resolve_device
from repro_torch.core.types import Corpus, GraphIndex
from repro_torch.graph.build import (
    add_reverse_edges,
    build_knn_graph,
    medoid,
    nn_descent,
    span,
)


def build_index(generator: torch.Generator, corpus: Corpus, degree: int = 16,
                sample_size: int = 256, *, method: str = "exact", reverse_edges: bool = True,
                nn_descent_iters: int = 8, device="cuda", spans=None) -> GraphIndex:
    """Build a searchable single-shard index over ``corpus`` (on ``device``).

    ``method``: "exact" (blocked brute-force kNN) or "nn_descent"
    (``nn_descent_iters`` rounds, random ints from ``generator``). The
    AIRSHIP-Start sample (§2.2) is drawn uniformly without replacement from
    ``generator`` after the graph, with no knowledge of queries. ``spans``
    (a dict, optional) collects the device time of the build's parts:
    "products" and "topk" of the exact graph, "nn_descent" (within it
    "distances" and "sorts"), "reverse_edges"
    (read them with ``graph.build.span_seconds``).
    """
    dev = resolve_device(device)
    check_generator(generator, dev)
    if corpus.vectors.device.type != dev.type:
        raise ValueError(f"corpus is on {corpus.vectors.device}, index goes to {dev}")
    if method == "exact":
        nbrs = build_knn_graph(corpus.vectors, degree, spans=spans)
    elif method == "nn_descent":
        with span(spans, "nn_descent", dev):
            nbrs = nn_descent(generator, corpus.vectors, degree, iters=nn_descent_iters,
                              device=dev, spans=spans)
    else:
        raise ValueError(f"unknown build method: {method}")
    if reverse_edges:
        with span(spans, "reverse_edges", dev):
            nbrs = add_reverse_edges(nbrs, corpus.vectors, degree)
    sample_size = min(sample_size, corpus.n)
    sample = torch.randperm(corpus.n, generator=generator, device=dev)[:sample_size]
    return GraphIndex(neighbors=nbrs, sample_ids=sample.to(torch.int32),
                      entry_point=medoid(corpus.vectors))


def build_partitioned_index(generator: torch.Generator, corpus: Corpus, n_shards: int,
                            degree: int = 16, sample_size_per_shard: int = 128, *,
                            device="cuda", **kwargs) -> tuple[Corpus, GraphIndex]:
    """Row-partition the corpus into ``n_shards`` independent subgraphs.

    Shard ``s`` owns rows [s*n_local, (s+1)*n_local) of the returned
    corpus; its neighbour, sample and entry ids are local to it, and
    ``entry_point`` has shape (n_shards,). The corpus is padded to a
    multiple of ``n_shards`` by repeating its leading rows, so the last
    shard may hold exact duplicates of rows of shard 0. Each shard builds
    with its own generator, seeded from ``generator`` (the reference folds
    the shard number into its key). ``kwargs`` go to ``build_index``.
    """
    dev = resolve_device(device)
    check_generator(generator, dev)
    n = corpus.n
    n_local = (n + n_shards - 1) // n_shards
    pad = n_local * n_shards - n

    def padded(t):
        return torch.cat([t, t[:pad]], dim=0) if t is not None and pad else t

    vecs, labs, attrs = padded(corpus.vectors), padded(corpus.labels), padded(corpus.attrs)
    seeds = torch.randint(0, 2**62, (n_shards,), generator=generator, device=dev).tolist()
    nbrs, samples, entries = [], [], []
    for s in range(n_shards):
        g = torch.Generator(device=dev).manual_seed(seeds[s])
        lo = s * n_local
        sub = Corpus(vectors=vecs[lo : lo + n_local], labels=labs[lo : lo + n_local])
        idx = build_index(g, sub, degree=degree, sample_size=sample_size_per_shard,
                          device=dev, **kwargs)
        nbrs.append(idx.neighbors)
        samples.append(idx.sample_ids)
        entries.append(idx.entry_point.reshape(1))
    graph = GraphIndex(neighbors=torch.cat(nbrs), sample_ids=torch.cat(samples),
                       entry_point=torch.cat(entries))
    return Corpus(vectors=vecs, labels=labs, attrs=attrs), graph
