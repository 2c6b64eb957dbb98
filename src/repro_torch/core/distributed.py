"""Distributed constrained search: scatter-search-merge over a device mesh
(port of ``repro.core.distributed``).

Layout (see DESIGN.md §4):
  * corpus rows + their *local* proximity subgraph are split over the
    ``model`` axis (each shard owns an independent subgraph whose neighbor
    ids are local, the layout of ``graph.index.build_partitioned_index``),
  * the query batch is split over the ``data`` (and optionally ``pod``)
    axes and replicated within each model group,
  * every shard builds its own ``TraversalContext`` — the distance
    backend's tensors (corpus rows, or PQ codes + the shard's per-query
    LUT) split with the corpus rows; the per-query constraint operand
    splits with the batch — runs the full AIRSHIP search on its rows via
    ``search_with_context``, and the global top-k is one gather of every
    shard's (B, K) result + a local merge per batch group.

One controller drives the mesh (the reference's model: one process, one
function call per search). A ``DeviceMesh`` is a grid of
``torch.device``s; the "all_gather" is a move of each shard's (B, K)
distances and ids to the first device of its model group, followed by
``merge_topk`` there, and the stats reduce the same way (``dist_evals``,
``visited`` and ``beam_expansions`` summed over the shards, ``hops`` and
``iters`` their maximum). Shards run one after another on the host
thread, so a batch costs the sum of its shards' walks; a grid position may
repeat a device, and then its shards share that device.

Local ids become global ids as ``id + shard * n_local`` (-1 stays -1), so
the corpus rows must split evenly over the model axis and the batch over
the batch axes. Backend splitting is generic: ``params.approx`` decides
which backend payload rides along (the PQ code matrix splits by rows like
the vectors; codebooks are shared), with no per-backend special cases in
the search body.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.constraints import LabelSetConstraint, RangeConstraint
from repro_torch.core.engine.context import build_context
from repro_torch.core.engine.loop import search_with_context
from repro_torch.core.pq import PQIndex
from repro_torch.core.types import Corpus, GraphIndex, SearchParams, SearchResult, SearchStats
from repro_torch.distributed.meshinfo import DeviceMesh
from repro_torch.roofline import collectives

Splitter = Callable[..., object]


def merge_topk(dists: torch.Tensor, ids: torch.Tensor, k: int):
    """Merge per-shard results: (B, P, K) -> (B, k) global best.

    Equal distances keep ``lax.top_k``'s order (a stable ascending sort:
    the lower flat position first), and a slot whose distance is not
    finite gets id -1."""
    b = dists.shape[0]
    flat_d = dists.reshape(b, -1)
    flat_i = ids.reshape(b, -1)
    out_d, pos = torch.sort(flat_d, dim=-1, stable=True)
    out_d, pos = out_d[:, :k], pos[:, :k]
    out_i = flat_i.gather(1, pos)
    return out_d, torch.where(torch.isfinite(out_d), out_i, torch.full_like(out_i, -1))


def constraint_in_spec(constraint_type: type, batch_axes: Sequence[str]) -> Splitter:
    """Per-family split rule: per-query operands split with the batch over
    ``batch_axes`` (the reference's shard_map in_spec). Returns
    ``split(constraint, rows, device)``: the constraint of the query rows
    ``rows`` (a slice) on ``device``.

    Registry-style so new data-constraint families extend the split path
    by adding one entry (UDF closures are code, not per-query data).
    """
    del batch_axes  # every per-query field splits over all of them at once
    if constraint_type is LabelSetConstraint:
        return lambda c, rows, dev: LabelSetConstraint(words=c.words[rows].to(dev))
    if constraint_type is RangeConstraint:
        return lambda c, rows, dev: RangeConstraint(lo=c.lo[rows].to(dev),
                                                    hi=c.hi[rows].to(dev), col=c.col)
    raise TypeError(
        f"no split rule for constraint type {constraint_type!r}; "
        "register it in core.distributed.constraint_in_spec"
    )


def backend_in_specs(params: SearchParams, corpus_axis: str) -> tuple:
    """Split rules for the distance backend's payload, from params.approx.

    Exact / kernel backends score the corpus rows already split by the
    corpus rule — no extra payload. PQ adds the code matrix (split by rows
    like the vectors) + shared codebooks, as ``split(pq_index, rows,
    device)``; each shard builds its own LUT inside ``build_context``.
    """
    del corpus_axis
    if params.approx == "pq":
        return (lambda pq, rows, dev: PQIndex(codebooks=pq.codebooks.to(dev),
                                              codes=pq.codes[rows].to(dev)),)
    return ()


@dataclass(frozen=True)
class ShardedIndex:
    """A corpus and its partitioned graph placed on a mesh: ``shards[m]``
    maps each distinct device of model column ``m`` to that column's row
    shard there, as a (Corpus, GraphIndex) pair."""

    corpus: Corpus  # the global rows, as given
    n_shards: int
    shards: Tuple[Dict[torch.device, Tuple[Corpus, GraphIndex]], ...]
    graph: Optional[GraphIndex] = None  # the global partitioned graph, as given

    @property
    def dim(self) -> int:
        return self.corpus.dim

    @property
    def n_local(self) -> int:
        return self.corpus.n // self.n_shards


def shard_corpus_for_mesh(corpus: Corpus, graph: GraphIndex, mesh: DeviceMesh,
                          corpus_axis: str = "model") -> ShardedIndex:
    """Place the row shards of ``corpus`` and ``graph`` (the layout of
    ``build_partitioned_index``) on the mesh: shard m on every distinct
    device of mesh column m. A shard already on its device is a view of the
    global tensors, not a copy."""
    p = mesh.shape[corpus_axis]
    n, s = corpus.n, graph.sample_ids.shape[0]
    if n % p or s % p or graph.entry_point.numel() != p:
        raise ValueError(f"{n} rows, {s} sample ids and {graph.entry_point.numel()} entry "
                         f"points do not split into {p} shards")
    n_local, s_local = n // p, s // p
    entries = graph.entry_point.reshape(p)
    columns = mesh.groups(corpus_axis)  # (groups, p)
    shards = []
    for m in range(p):
        rows, samples = slice(m * n_local, (m + 1) * n_local), slice(m * s_local, (m + 1) * s_local)
        placed = {}
        for dev in dict.fromkeys(columns[:, m]):

            def to(t, rows=rows):
                return None if t is None else t[rows].to(dev)

            placed[dev] = (
                Corpus(vectors=to(corpus.vectors), labels=to(corpus.labels),
                       attrs=to(corpus.attrs)),
                GraphIndex(neighbors=to(graph.neighbors),
                           sample_ids=graph.sample_ids[samples].to(dev),
                           entry_point=entries[m : m + 1].to(dev)),
            )
        shards.append(placed)
    return ShardedIndex(corpus=corpus, n_shards=p, shards=tuple(shards), graph=graph)


def make_distributed_search(
    mesh: DeviceMesh,
    params: SearchParams,
    *,
    corpus_axis: str = "model",
    batch_axes: Sequence[str] = ("data",),
    constraint_type: type = LabelSetConstraint,
):
    """Build a distributed search fn for a given mesh.

    The returned fn takes ``(index_s, queries, constraint,
    pq_index=None)``: ``index_s`` is the ``ShardedIndex`` of
    ``shard_corpus_for_mesh`` (the reference's ``corpus_s, graph_s`` pair
    in one object); queries and constraint are the global batch, which
    splits over ``batch_axes``. ``constraint_type`` selects the family's
    split rule (LabelSet by default; Range splits [lo, hi] with the batch,
    and only a range search reads the attrs column). With
    ``params.approx == "pq"`` the PQ code matrix splits with the corpus rows
    and codebooks are shared — the trailing ``pq_index`` is then required;
    otherwise it must stay None. The result lands on the mesh's first
    device. ``shard_walls``, a list, collects the host wall of each shard's
    walk as ``(data group, shard, seconds)``, each ended by a device sync
    (off by default: the syncs cost a little on a card).
    """
    batch_axes = tuple(batch_axes)
    with_attrs = constraint_type is RangeConstraint
    split_constraint = constraint_in_spec(constraint_type, batch_axes)
    split_backend = backend_in_specs(params, corpus_axis)
    needs_pq = params.approx == "pq"
    # (data groups, model shards): batch axes flattened in mesh order.
    other = [a for a in mesh.axis_names if a != corpus_axis]
    if sorted(other) != sorted(batch_axes):
        raise ValueError(f"batch axes {batch_axes} + corpus axis {corpus_axis!r} must name "
                         f"every mesh axis {mesh.axis_names}")
    grid = mesh.groups(corpus_axis)
    n_groups, p = grid.shape
    out_dev = mesh.devices[0]

    def shard_search(corpus, graph, queries, constraint, pq_index):
        if not with_attrs:
            corpus = Corpus(vectors=corpus.vectors, labels=corpus.labels)
        ctx = build_context(corpus, constraint, queries, params, pq_index,
                            degree=graph.neighbors.shape[1])
        return search_with_context(ctx, corpus, graph, queries, params)

    def search(index: ShardedIndex, queries, constraint, pq_index=None, *,
               shard_walls: Optional[list] = None) -> SearchResult:
        if needs_pq and pq_index is None:
            raise ValueError("params.approx='pq' requires a pq_index argument")
        if not needs_pq and pq_index is not None:
            raise ValueError(
                "pq_index passed but params.approx != 'pq'; the exact search "
                "would silently ignore it"
            )
        if index.n_shards != p:
            raise ValueError(f"index has {index.n_shards} shards, the mesh {p}")
        b = queries.shape[0]
        if b % n_groups:
            raise ValueError(f"batch {b} does not split over {n_groups} data groups")
        b_local = b // n_groups
        outs = []
        for g in range(n_groups):
            with collectives.group(g):
                outs.append(group_search(index, g, slice(g * b_local, (g + 1) * b_local),
                                         queries, constraint, pq_index, shard_walls))

        def cat(tensors):
            return torch.cat([t.to(out_dev) for t in tensors])

        stats = [s for _, _, s in outs]
        return SearchResult(
            dists=cat([d for d, _, _ in outs]),
            ids=cat([i for _, i, _ in outs]),
            stats=SearchStats(
                dist_evals=cat([s.dist_evals for s in stats]),
                hops=cat([s.hops for s in stats]),
                visited=cat([s.visited for s in stats]),
                # One value for the whole batch: the first data group's, as
                # the reference's replicated out_spec reads it.
                iters=stats[0].iters.to(out_dev),
                beam_expansions=cat([s.beam_expansions for s in stats]),
            ),
        )

    def group_search(index, g, rows, queries, constraint, pq_index, shard_walls):
        """Data group ``g``'s query rows on every shard, merged on the
        group's first device -> (dists, ids, stats)."""
        n_local = index.n_local
        head = grid[g, 0]
        parts = []
        for m in range(p):
            dev = grid[g, m]
            corpus, sub = index.shards[m][dev]
            codes_rows = slice(m * n_local, (m + 1) * n_local)
            pq = split_backend[0](pq_index, codes_rows, dev) if split_backend else None
            if shard_walls is not None:
                _sync(dev)
                t0 = time.perf_counter()
            res = shard_search(corpus, sub, queries[rows].to(dev),
                               split_constraint(constraint, rows, dev), pq)
            if shard_walls is not None:
                _sync(dev)
                shard_walls.append((g, m, time.perf_counter() - t0))
            # Local ids -> global ids (row-split partition => offset).
            gids = torch.where(res.ids >= 0, res.ids + m * n_local, res.ids)
            parts.append((res, gids))
        # One gather: every shard's K best to the group's first device.
        all_d = torch.stack([r.dists.to(head) for r, _ in parts], 1)  # (B, P, K)
        all_i = torch.stack([i.to(head) for _, i in parts], 1)
        collectives.record("all-gather", all_d, all_i)
        return (*merge_topk(all_d, all_i, params.k),
                _combine_stats([r.stats for r, _ in parts], head))

    return search


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _combine_stats(stats: Sequence[SearchStats], dev: torch.device) -> SearchStats:
    """One model group's stats on ``dev``: ``dist_evals``, ``visited`` and
    the per-slot ``beam_expansions`` summed over the shards (each shard
    walks its own subgraph with the full beam), ``hops`` and ``iters``
    their maximum."""
    def stacked(field):
        return torch.stack([getattr(s, field).to(dev) for s in stats])

    out = SearchStats(
        dist_evals=stacked("dist_evals").sum(0, dtype=torch.int32),
        hops=stacked("hops").amax(0),
        visited=stacked("visited").sum(0, dtype=torch.int32),
        iters=stacked("iters").amax(0),
        beam_expansions=stacked("beam_expansions").sum(0, dtype=torch.int32),
    )
    collectives.record("all-reduce", *(getattr(out, f.name) for f in dataclasses.fields(out)))
    return out
