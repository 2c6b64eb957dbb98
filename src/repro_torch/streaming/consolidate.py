"""Background consolidation: splice tombstoned vertices out of the graph
(port of ``repro.streaming.consolidate``).

A deleted vertex stays wired in as a routing node until this pass, which:

  * rewrites every in-neighbour ``u`` of a target ``t``: ``u`` drops its
    ``u -> t`` edge and takes ``t``'s out-edges as replacement candidates
    (paths through ``t`` survive as direct edges), re-ranked with ``u``'s
    surviving edges under the degree bound;
  * clears ``t``'s own row to -1 and only then returns the slot to the
    free list, so a recycled id is never the target of a stale edge;
  * re-points the entry vertex and the AIRSHIP-Start sample at live
    vertices where they died.

The reference rewrites the hit rows one at a time in Python. A row's
candidates come only from its own row and from target rows, which the pass
does not rewrite, so the rows are independent; the port builds every hit
row's candidates at once on the device, in the reference's order (the
surviving edges in row order, then each dead edge's out-row in row order,
first occurrence kept), scores them in one ``gather_distance`` launch a
chunk and keeps the ``degree`` closest by a stable sort.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.gather_distance import gather_distance
from repro_torch.streaming.slots import PAD, StreamingIndex

INT32_MAX = 2**31 - 1
# Candidate elements (hit rows x candidate width, the width degree x (1 +
# the most dead edges of a hit row)) a chunk of rows builds, sorts and
# scores at once: 1% deletes at n = 1M fit in one chunk, a heavier pass
# takes several.
CHUNK_ELEMS = 1 << 28


def _first_occurrence(cand: torch.Tensor) -> torch.Tensor:
    """-1 over every repeat of an id within its row (the first copy stays),
    as ``dict.fromkeys`` keeps insertion order: a stable sort by id puts
    copies together in column order."""
    key = torch.where(cand >= 0, cand, INT32_MAX)
    srt, order = torch.sort(key, dim=1, stable=True)
    repeat = torch.zeros_like(cand, dtype=torch.bool)
    repeat[:, 1:] = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] != INT32_MAX)
    dup = torch.zeros_like(repeat).scatter_(1, order, repeat)
    return torch.where(dup, PAD, cand)


def _rewrite_rows(index: StreamingIndex, u: torch.Tensor, dead_slot: torch.Tensor) -> None:
    """Rewrite the rows ``u`` (distinct, not targets) in place."""
    nbrs = index.neighbors
    deg = index.degree
    row = nbrs[u]  # (U, deg)
    dead = (row >= 0) & dead_slot[row.clamp_min(0).long()]
    keep = torch.where((row >= 0) & ~dead, row, PAD)
    # Dead edges first, in row order; only as many columns as the row with
    # the most dead edges needs.
    m = int(dead.sum(1).max())
    pos = torch.sort((~dead).to(torch.int8), dim=1, stable=True).indices[:, :m]
    dead_e = torch.where(dead.gather(1, pos), row.gather(1, pos), PAD)  # (U, m)
    spliced = nbrs[dead_e.clamp_min(0).long()]  # (U, m, deg)
    ok = ((dead_e >= 0)[:, :, None] & (spliced >= 0)
          & ~dead_slot[spliced.clamp_min(0).long()] & (spliced != u[:, None, None]))
    spliced = torch.where(ok, spliced, PAD).reshape(u.shape[0], m * deg)
    cand = _first_occurrence(torch.cat([keep, spliced], dim=1)).contiguous()
    vectors = index.pool.vectors
    d = gather_distance(vectors[u].contiguous(), vectors, cand)  # +inf for -1
    d_sorted, order = torch.sort(d, dim=1, stable=True)
    out = cand.gather(1, order[:, :deg])
    nbrs[u] = torch.where(torch.isfinite(d_sorted[:, :deg]), out, PAD)


def consolidate(index: StreamingIndex, max_slots: Optional[int] = None) -> int:
    """Splice out up to ``max_slots`` pending tombstones; returns the count."""
    pool = index.pool
    targets = list(pool.pending if max_slots is None else pool.pending[:max_slots])
    if not targets:
        return 0
    dev = index.device
    nbrs = index.neighbors
    t = torch.tensor(targets, dtype=torch.long, device=dev)
    dead_slot = torch.zeros((index.capacity,), dtype=torch.bool, device=dev)
    dead_slot[t] = True

    # In-neighbour scan: one membership test over the adjacency.
    hit = ((nbrs >= 0) & dead_slot[nbrs.clamp_min(0).long()]).any(dim=1) & ~dead_slot
    u_all = torch.nonzero(hit).flatten()
    if u_all.numel():
        row = nbrs[u_all]
        most_dead = int(((row >= 0) & dead_slot[row.clamp_min(0).long()]).sum(1).max())
        step = max(1, CHUNK_ELEMS // (index.degree * (1 + most_dead)))
        for s in range(0, u_all.shape[0], step):
            _rewrite_rows(index, u_all[s : s + step], dead_slot)

    nbrs[t] = PAD
    for slot in targets:
        pool.reclaim(slot)

    # Re-point dead seeds at the live set (the tombstone mask already keeps
    # them out of results; this keeps SEEDING useful). The mean is numpy's,
    # over the live rows on the host, as the reference takes it: a device
    # mean adds in another order and could pick another vertex.
    live = pool.live_ids()
    if live.shape[0]:
        if not pool.is_live(index.entry_point):
            vec = pool.vectors[torch.from_numpy(live).to(dev).long()].cpu().numpy()
            mean = vec.mean(axis=0)
            diffs = vec - mean
            index.entry_point = int(live[np.argmin(np.sum(diffs * diffs, -1))])
        dead_sample = ~np.isin(index.sample_ids, live, assume_unique=False)
        if dead_sample.any():
            # Replacements come from live ids NOT already sampled: the sample
            # stays duplicate-free.
            pool_ids = np.setdiff1d(live, index.sample_ids)
            n_new = int(dead_sample.sum())
            if pool_ids.shape[0] >= n_new:
                repl = index.rng.choice(pool_ids, size=n_new, replace=False)
            else:
                repl = index.rng.choice(live, size=n_new, replace=True)
            index.sample_ids[dead_sample] = repl.astype(np.int32)

    index.consolidations += 1
    index.mark_dirty()
    pool.check_accounting()
    return len(targets)
