"""The traversal loop: state, termination, stats (port of
``repro.core.engine.loop``).

A Python ``while`` loop advances the whole query batch in lock-step, in
place of the reference's ``lax.while_loop``. Its condition, "any query not
done and iters < max_iters", reads one flag from the device each iteration:
one host sync per iteration, kept so that ``iters`` matches the reference.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

from repro_torch.core import queue as q
from repro_torch.core import visited as vis
from repro_torch.core.alter_ratio import estimate_alter_ratio
from repro_torch.core.engine.context import ExactBackend, TraversalContext, build_context
from repro_torch.core.engine.expand import (
    expand_beam,
    expand_beam_fused,
    mask_first_occurrence,
    pop_frontier_beam,
)
from repro_torch.core.engine.policy import is_two_queue
from repro_torch.core.estimator import sample_satisfied_mask
from repro_torch.core.types import Corpus, GraphIndex, SearchParams, SearchResult, SearchStats


@dataclass(frozen=True)
class TraversalState:
    sat: q.BatchedQueue
    oth: q.BatchedQueue
    topk: q.BatchedQueue
    visited: torch.Tensor  # (B, W) int32
    cnt_sat: torch.Tensor  # (B,) int32
    cnt_total: torch.Tensor  # (B,) int32
    dist_evals: torch.Tensor  # (B,) int32
    hops: torch.Tensor  # (B,) int32
    beam_expanded: torch.Tensor  # (B, beam_width) int32
    done: torch.Tensor  # (B,) bool


def _best(d, n: int):
    """The n smallest of each row, ascending, ties lower index first (the
    order of the reference's ``lax.top_k`` of negated keys)."""
    d_sorted, pos = torch.sort(d, dim=-1, stable=True)
    return d_sorted[:, :n], pos[:, :n]


def seed_state(corpus: Corpus, graph: GraphIndex, queries, ctx: TraversalContext,
               params: SearchParams, entry: Optional[torch.Tensor] = None):
    """Initialise queues and visited per mode; returns (state, alter_ratio (B,)).

    ``entry`` (B,) int32 replaces the global entry vertex; the reference
    draws it at random for vanilla mode.
    """
    b = queries.shape[0]
    dev = queries.device
    zeros = torch.zeros((b,), dtype=torch.int32, device=dev)
    ones = torch.ones((b, 1), dtype=torch.bool, device=dev)
    state = TraversalState(
        sat=q.queue_init(b, params.ef_sat, dev),
        oth=q.queue_init(b, params.ef_other, dev),
        topk=q.queue_init(b, params.result_capacity, dev),
        visited=vis.visited_init(b, corpus.n, dev),
        cnt_sat=zeros, cnt_total=zeros, dist_evals=zeros, hops=zeros,
        beam_expanded=torch.zeros((b, params.beam_width), dtype=torch.int32, device=dev),
        done=torch.zeros((b,), dtype=torch.bool, device=dev),
    )

    # Global entry vertex: always seeded (exploration anchor and fallback).
    if entry is None:
        entry = graph.entry_point.to(torch.int32).reshape(1).expand(b)
    entry = entry.to(torch.int32).reshape(b, 1).contiguous()
    d_entry = ctx.backend.distances(queries, entry)
    state = replace(
        state,
        oth=q.queue_push(state.oth, d_entry, entry, ones),
        visited=vis.visited_set(state.visited, entry, ones),
        dist_evals=state.dist_evals + 1,
    )

    ratio = torch.full((b,), params.alter_ratio or 0.5, dtype=torch.float32, device=dev)
    sample = graph.sample_ids
    s = sample.shape[0]
    sample_ids_b = sample[None, :].expand(b, s)
    d_sample = ctx.backend.sample_distances(queries, sample)
    n_start = min(params.n_start, s)

    if params.mode == "vanilla":
        # Multi-start from the build sample, unconstrained (the paper's
        # baseline semantics).
        start_d, top_pos = _best(d_sample, n_start)
        start_ids = sample_ids_b.gather(1, top_pos)
        fresh = ~vis.visited_test(state.visited, start_ids)
        # Keep only the first copy of a repeated sample id (no-op for a
        # sample drawn without replacement).
        fresh = mask_first_occurrence(start_ids, fresh)
        state = replace(
            state,
            oth=q.queue_push(state.oth, start_d, start_ids, fresh),
            visited=vis.visited_set(state.visited, start_ids, fresh),
            dist_evals=state.dist_evals + s,
        )
        return state, ratio

    # AIRSHIP-Start: filter the pre-drawn sample by the constraint; the same
    # mask feeds the Eq.-1 alter_ratio estimate.
    sample_sat = sample_satisfied_mask(ctx.satisfied, sample, b)
    d_masked = torch.where(sample_sat, d_sample, float("inf"))
    start_d, top_pos = _best(d_masked, n_start)
    start_ids = sample_ids_b.gather(1, top_pos)
    fresh = torch.isfinite(start_d) & ~vis.visited_test(state.visited, start_ids)
    fresh = mask_first_occurrence(start_ids, fresh)
    target = "oth" if params.mode == "start" else "sat"
    state = replace(
        state,
        **{target: q.queue_push(getattr(state, target), start_d, start_ids, fresh)},
        visited=vis.visited_set(state.visited, start_ids, fresh),
        dist_evals=state.dist_evals + s,  # the sample scan costs S distances
    )
    if params.mode in ("alter", "prefer") and params.alter_ratio is None:
        ratio = estimate_alter_ratio(graph, ctx.satisfied, sample_sat, params.alter_ratio_k)
    return state, ratio


def _step(st: TraversalState, ctx: TraversalContext, graph: GraphIndex, queries,
          params: SearchParams, ratio) -> TraversalState:
    """One lock-step iteration of the whole batch."""
    two_queue = is_two_queue(params.mode)
    # Alg. 1/2 termination bound, captured at iteration start.
    thr = q.topk_threshold(st.topk, params.result_capacity)
    sat, oth, now_d, now_i, sel_sat, expand, done, cnt_sat, cnt_total = pop_frontier_beam(
        params.mode, st.sat, st.oth, st.done, st.cnt_sat, st.cnt_total, ratio, thr,
        params.beam_width)
    # The sat frontier only ever holds satisfied vertices.
    upd = expand & sel_sat if two_queue else expand & ctx.satisfied(now_i)

    if ctx.fuse:
        # Distances, verdicts and freshness in one kernel pass; one stable
        # partition sort feeds every frontier through sorted merges.
        nbrs, d_nb, nb_sat_all, fresh = expand_beam_fused(
            graph.neighbors, queries, now_i, expand, st.visited, ctx)
        m = nbrs.shape[-1]
        if two_queue:
            nb_sat = nb_sat_all & fresh
            run_sat, run_oth = q.partition_sorted_runs(
                d_nb, nbrs, nb_sat, fresh & ~nb_sat, sat.capacity, oth.capacity)
            sat = q.queue_merge_sorted(sat, *run_sat)
            oth = q.queue_merge_sorted(oth, *run_oth)
        else:
            run_d, run_i = q.sort_run(d_nb, nbrs, fresh)
            r = min(m, oth.capacity)
            oth = q.queue_merge_sorted(oth, run_d[:, :r], run_i[:, :r])
        trun_d, trun_i = q.sort_run(now_d, now_i, upd)
        topk = q.queue_merge_sorted(st.topk, trun_d, trun_i)
    else:
        topk = q.queue_push(st.topk, now_d, now_i, upd)
        nbrs, d_nb, fresh = expand_beam(graph.neighbors, queries, now_i, expand, st.visited, ctx)
        if two_queue:
            nb_sat = ctx.satisfied(nbrs) & fresh
            sat = q.queue_push(sat, d_nb, nbrs, nb_sat)
            oth = q.queue_push(oth, d_nb, nbrs, fresh & ~nb_sat)
        else:
            oth = q.queue_push(oth, d_nb, nbrs, fresh)

    return TraversalState(
        sat=sat, oth=oth, topk=topk,
        visited=vis.visited_set(st.visited, nbrs, fresh),
        cnt_sat=cnt_sat, cnt_total=cnt_total,
        dist_evals=st.dist_evals + fresh.sum(-1, dtype=torch.int32),
        hops=st.hops + expand.sum(-1, dtype=torch.int32),
        beam_expanded=st.beam_expanded + expand.to(torch.int32),
        done=done,
    )


def search_with_context(ctx: TraversalContext, corpus: Corpus, graph: GraphIndex, queries,
                        params: SearchParams, entry: Optional[torch.Tensor] = None
                        ) -> SearchResult:
    """Run the traversal loop against an already-built ``TraversalContext``."""
    st, ratio = seed_state(corpus, graph, queries, ctx, params, entry)
    iters = 0
    while iters < params.max_iters and bool((~st.done).any()):
        st = _step(st, ctx, graph, queries, params, ratio)
        iters += 1
    stats = SearchStats(
        dist_evals=st.dist_evals,
        hops=st.hops,
        visited=vis.visited_count(st.visited),
        iters=torch.tensor(iters, dtype=torch.int32, device=queries.device),
        beam_expansions=st.beam_expanded,
    )
    out_d, out_i = st.topk.dists, st.topk.ids
    if ctx.backend.approximate:
        # Exact re-rank of the ef_result survivors: the approximate backend
        # ordered the walk, exact distances order the answer. The sort is
        # stable, as the reference's argsort.
        exact_d = ExactBackend(vectors=corpus.vectors).distances(queries, out_i)
        exact_d = torch.where(out_i >= 0, exact_d, float("inf"))
        out_d, order = torch.sort(exact_d, dim=-1, stable=True)
        out_i = out_i.gather(1, order)
        out_i = torch.where(torch.isfinite(out_d), out_i, -1)
    # The ef_result-sized list is cut to the requested top-k.
    return SearchResult(dists=out_d[:, : params.k], ids=out_i[:, : params.k], stats=stats)


def constrained_search(corpus: Corpus, graph: GraphIndex, queries, constraint,
                       params: SearchParams, *, entry: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       pq_index=None) -> SearchResult:
    """Top-k constrained similarity search for a (B, d) batch of queries.

    Returns ascending (B, K) distances and ids; unreachable slots hold
    (+inf, -1). ``constraint`` is a ``LabelSetConstraint``, a
    ``RangeConstraint`` or a vectorised UDF (core/constraints.py).

    Vanilla mode enters at a random vertex per query: ``entry`` (B,) gives
    those vertices explicitly (the tests pass the reference's draw),
    otherwise they are drawn from ``generator``; with neither, and in the
    other modes, every query enters at ``graph.entry_point``.

    With ``params.approx == "pq"``, ``pq_index`` (``core.pq.PQIndex``)
    drives the walk with ADC distances (``PQBackend``) and the ef_result
    survivors are re-ranked exactly before the cut to k.
    """
    b = queries.shape[0]
    if params.mode != "vanilla":
        entry = None
    elif entry is None and generator is not None:
        entry = torch.randint(0, corpus.n, (b,), generator=generator, dtype=torch.int32,
                              device=queries.device)
    ctx = build_context(corpus, constraint, queries, params, pq_index,
                        degree=graph.neighbors.shape[1])
    return search_with_context(ctx, corpus, graph, queries, params, entry)
