"""Beam expansion: pop ``beam_width`` vertices per query, gather once
(port of ``repro.core.engine.expand``).

Two vertices popped in one beam may share an unvisited neighbour, so the
flattened id list can hold duplicates; the visited scatter-ADD needs
duplicate-free rows and the frontiers must not hold a vertex twice, so
``mask_first_occurrence`` keeps only the first copy (skipped at beam 1,
where adjacency rows are duplicate-free).
"""
from __future__ import annotations

import torch

from repro_torch.core import queue as q
from repro_torch.core import visited as vis
from repro_torch.core.engine.context import TraversalContext
from repro_torch.core.engine.policy import get_policy, is_two_queue


def mask_first_occurrence(ids, valid):
    """Clear ``valid`` on all but the first valid copy of each id per row.

    Pairwise (B, M, M) compare up to M = 128, the sort-based dedup beyond.
    """
    m = ids.shape[-1]
    if m > 128:
        return mask_first_occurrence_sorted(ids, valid)
    eq = ids[:, :, None] == ids[:, None, :]
    earlier = torch.tril(torch.ones((m, m), dtype=torch.bool, device=ids.device), diagonal=-1)
    dup = (eq & earlier[None] & valid[:, None, :]).any(-1)
    return valid & ~dup


def mask_first_occurrence_sorted(ids, valid):
    """Sort-based dedup, O(M log M): a stable argsort groups equal ids in
    slot order; a segmented count of valid slots flags each group's first
    valid one. Earlier invalid copies never suppress later valid ones."""
    b, m = ids.shape
    order = torch.argsort(ids, dim=-1, stable=True)
    sid = ids.gather(1, order)
    sval = valid.gather(1, order)
    seg_start = torch.cat(
        [torch.ones((b, 1), dtype=torch.bool, device=ids.device), sid[:, 1:] != sid[:, :-1]], -1)
    nval = sval.to(torch.int32)
    before = nval.cumsum(-1, dtype=torch.int32) - nval
    pos = torch.arange(m, device=ids.device)[None, :]
    start_pos = torch.where(seg_start, pos, 0).cummax(dim=1).values
    keep_sorted = sval & (before == before.gather(1, start_pos))
    return torch.zeros_like(valid).scatter(1, order, keep_sorted)


def pop_frontier_beam(mode, sat, oth, done, cnt_sat, cnt_total, ratio, thr, beam_width):
    """Pop up to ``beam_width`` vertices per query under the mode's policy.

    Termination is Alg. 1/2's threshold test against ``thr``, the top-k
    bound at the start of the iteration. Returns (sat, oth, now_d (B, W),
    now_i (B, W), sel_sat (B, W), expand (B, W), done (B,), cnt_sat,
    cnt_total); counters count actual pops, including the one that trips
    the threshold.
    """
    if not is_two_queue(mode):
        done_now = done | ~(q.queue_nonempty(sat) | q.queue_nonempty(oth))
        live = ~done_now
        oth, now_d, now_i = q.queue_pop_n(oth, beam_width, live)
        popped = live[:, None] & torch.isfinite(now_d)
        over = popped & (now_d > thr[:, None])
        # Pops come out ascending: once a slot exceeds thr (or hits padding)
        # every later slot does too.
        stop = (over | ~popped).to(torch.int32).cumsum(-1) > 0
        expand = live[:, None] & ~stop
        done = done_now | over.any(-1)
        cnt_total = cnt_total + popped.sum(-1, dtype=torch.int32)
        sel_sat = torch.zeros_like(expand)
        return sat, oth, now_d, now_i, sel_sat, expand, done, cnt_sat, cnt_total

    # Two frontiers: the policy re-reads heads and counters after every pop.
    policy = get_policy(mode)
    slots_d, slots_i, slots_sel, slots_expand = [], [], [], []
    for j in range(beam_width):
        empty = ~(q.queue_nonempty(sat) | q.queue_nonempty(oth))
        if j == 0:
            # Empty at iteration start is final.
            done = done | empty
            blocked = done
        else:
            # Empty mid-beam only skips the remaining slots: this iteration's
            # expansion may refill the frontiers.
            blocked = done | empty
        sel = policy(sat, oth, cnt_sat, cnt_total, ratio)
        live = ~blocked
        sat, sat_d, sat_i = q.queue_pop(sat, sel & live)
        oth, oth_d, oth_i = q.queue_pop(oth, ~sel & live)
        now_d = torch.where(sel, sat_d, oth_d)
        now_i = torch.where(sel, sat_i, oth_i)
        cnt_total = cnt_total + live.to(torch.int32)
        cnt_sat = cnt_sat + (sel & live).to(torch.int32)
        over = live & (now_d > thr)
        done = done | over
        slots_d.append(now_d)
        slots_i.append(now_i)
        slots_sel.append(sel)
        slots_expand.append(live & ~over)
    return (sat, oth, torch.stack(slots_d, -1), torch.stack(slots_i, -1),
            torch.stack(slots_sel, -1), torch.stack(slots_expand, -1), done, cnt_sat, cnt_total)


def _beam_neighbors(neighbors, now_i):
    b, w = now_i.shape
    return neighbors[now_i.clamp_min(0).long()].reshape(b, w * neighbors.shape[-1])


def expand_beam(neighbors, queries, now_i, expand, visited, ctx: TraversalContext):
    """Flatten the beam's adjacency into one (B, beam*deg) candidate batch.

    Returns (nbrs, d_nb, fresh): ids, distances, and the push mask (valid,
    unvisited, first occurrence). One backend call per iteration.
    """
    deg = neighbors.shape[-1]
    nbrs = _beam_neighbors(neighbors, now_i)
    nb_valid = (nbrs >= 0) & expand.repeat_interleave(deg, dim=-1)
    fresh = nb_valid & ~vis.visited_test(visited, nbrs)
    if now_i.shape[1] > 1:
        fresh = mask_first_occurrence(nbrs, fresh)
    d_nb = ctx.backend.distances(queries, nbrs)
    return nbrs, d_nb, fresh


def expand_beam_fused(neighbors, queries, now_i, expand, visited, ctx: TraversalContext):
    """Fused twin of ``expand_beam``: one kernel pass emits distances,
    constraint verdicts and freshness. Non-expanding slots become padding
    ids first. Returns (nbrs, d_nb, sat, fresh); ``sat`` is masked by
    ``fresh`` at the push site."""
    deg = neighbors.shape[-1]
    nbrs = _beam_neighbors(neighbors, now_i)
    nbrs = torch.where(expand.repeat_interleave(deg, dim=-1), nbrs, -1)
    d_nb, sat, fresh = ctx.backend.fused_expand(queries, nbrs, visited, ctx.tables)
    if now_i.shape[1] > 1:
        fresh = mask_first_occurrence(nbrs, fresh)
    return nbrs, d_nb, sat, fresh
