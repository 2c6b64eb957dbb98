"""Index assembly: graph + pre-drawn sample + entry point (port of
``repro.graph.index.build_index``; the partitioned layout waits with the
distributed layer)."""
from __future__ import annotations

import torch

from repro_torch.common.device import check_generator, resolve_device
from repro_torch.core.types import Corpus, GraphIndex
from repro_torch.graph.build import add_reverse_edges, build_knn_graph, medoid


def build_index(generator: torch.Generator, corpus: Corpus, degree: int = 16,
                sample_size: int = 256, *, method: str = "exact", reverse_edges: bool = True,
                device="cuda") -> GraphIndex:
    """Build a searchable single-shard index over ``corpus`` (on ``device``).

    The AIRSHIP-Start sample (§2.2) is drawn uniformly without replacement
    from ``generator``, with no knowledge of queries.
    """
    dev = resolve_device(device)
    check_generator(generator, dev)
    if corpus.vectors.device.type != dev.type:
        raise ValueError(f"corpus is on {corpus.vectors.device}, index goes to {dev}")
    if method == "nn_descent":
        raise NotImplementedError("nn_descent is not ported yet")
    if method != "exact":
        raise ValueError(f"unknown build method: {method}")
    nbrs = build_knn_graph(corpus.vectors, degree)
    if reverse_edges:
        nbrs = add_reverse_edges(nbrs, corpus.vectors, degree)
    sample_size = min(sample_size, corpus.n)
    sample = torch.randperm(corpus.n, generator=generator, device=dev)[:sample_size]
    return GraphIndex(neighbors=nbrs, sample_ids=sample.to(torch.int32),
                      entry_point=medoid(corpus.vectors))
