"""Online insert: beam-search-guided neighbour selection + edge patching
(port of ``repro.streaming.mutate``).

An insert is two writes under graph/build.py's adjacency contract (rows
distance-ascending, self-free, duplicate-free, -1 padded):

  1. the new slot's OWN row: the ``degree`` closest LIVE vertices a walk
     over the current snapshot finds (tombstoned routing nodes and free
     slots fail the tombstone mask);
  2. degree-bounded PATCHES of those neighbours' rows: the new id merges
     into each selected row, evicting its worst edge when the row is full.

Each patch touches only its own row and the selected rows are distinct,
so the port scores the old edges of every selected row in one
``gather_distance`` launch and merges all rows in one stable sort.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine.loop import constrained_search
from repro_torch.core.types import SearchParams
from repro_torch.kernels.gather_distance import gather_distance
from repro_torch.streaming.slots import PAD, StreamingIndex


def _match_all(labels, attrs):
    """Match-all UDF: tombstone masking alone decides returnability."""
    del attrs
    return labels == labels


def _insert_params(index: StreamingIndex) -> SearchParams:
    # vanilla mode with no entry draw walks from the fixed entry vertex with
    # unconstrained multi-start; the constraint only filters the result
    # list, and the tombstone mask keeps dead slots out of it.
    return SearchParams(
        mode="vanilla",
        k=index.degree,
        ef_result=max(index.ef_insert, index.degree),
        ef_other=max(index.ef_insert, 2 * index.degree),
        n_start=min(16, index.ef_insert),
        max_iters=max(64, 4 * index.ef_insert),
    )


def patch_neighbor_rows(index: StreamingIndex, rows: torch.Tensor, new_id: int,
                        d_new: torch.Tensor) -> None:
    """Merge ``new_id`` into each row of ``rows`` (distinct slot ids), at
    distance ``d_new[i]`` from row i's vertex.

    Degree-bounded: a full row evicts its worst edge iff the new edge is
    closer. The old edges' distances are recomputed from the pool vectors
    (one ``gather_distance`` launch: queries the rows' vectors, ids their
    edges, +inf for -1), so the ascending invariant is exact. A row that
    already holds ``new_id`` (a recycled slot id) is left as it is.
    """
    if rows.numel() == 0:
        return
    vectors = index.pool.vectors
    rows = rows.to(device=index.device, dtype=torch.long)
    old = index.neighbors[rows]  # (s, deg)
    d_old = gather_distance(vectors[rows].contiguous(), vectors, old.contiguous())
    s, deg = old.shape
    new_col = torch.full((s, 1), new_id, dtype=torch.int32, device=old.device)
    ids = torch.cat([old, new_col], dim=1)
    # Live edges keep their row order ahead of the new id, -1 sorts last at
    # +inf: a stable sort gives the reference's argsort over [live..., new].
    dists = torch.cat([d_old, d_new.to(device=old.device, dtype=torch.float32)[:, None]], dim=1)
    d_sorted, order = torch.sort(dists, dim=1, stable=True)
    merged = ids.gather(1, order[:, :deg])
    merged = torch.where(torch.isfinite(d_sorted[:, :deg]), merged, PAD)
    noop = (old == new_id).any(dim=1, keepdim=True)
    index.neighbors[rows] = torch.where(noop, old, merged)


def patch_neighbor_row(index: StreamingIndex, v: int, new_id: int, d_new: float) -> None:
    """Merge ``new_id`` (at distance ``d_new`` from ``v``) into v's row."""
    patch_neighbor_rows(index, torch.tensor([int(v)]), new_id,
                        torch.tensor([d_new], dtype=torch.float32))


def insert_one(index: StreamingIndex, vector, label=0, attrs=None) -> int:
    """Insert one vector; returns its slot id."""
    dev = index.device
    vec = torch.as_tensor(vector).to(device=dev, dtype=torch.float32).reshape(index.dim)
    snap = index.snapshot()  # the pre-insert epoch guides the neighbour search

    res = constrained_search(snap.corpus, snap.graph, vec[None], _match_all,
                             _insert_params(index))
    cand_ids = res.ids[0].cpu().numpy()
    cand_d = res.dists[0].cpu().numpy()
    keep = cand_ids >= 0
    cand_ids, cand_d = cand_ids[keep], cand_d[keep]
    # Defensive dedup (keeps ascending order): the row's duplicate-free
    # invariant must not hinge on the searcher's.
    _, uniq = np.unique(cand_ids, return_index=True)
    uniq.sort()
    cand_ids, cand_d = cand_ids[uniq], cand_d[uniq]

    pool = index.pool
    slot = pool.alloc()
    pool.write_row(slot, vec, label, attrs)

    # Own row: the search's ascending, duplicate-free live top-k IS the row.
    sel = cand_ids[: index.degree]
    row = np.full((index.degree,), PAD, np.int32)
    row[: sel.shape[0]] = sel
    index.neighbors[slot] = torch.from_numpy(row).to(dev)

    # Reverse wiring: every selected neighbour's row, in one batch.
    patch_neighbor_rows(index, torch.from_numpy(sel.astype(np.int64)), slot,
                        torch.from_numpy(cand_d[: index.degree]))

    pool.commit(slot)
    index.on_slot_committed(slot)  # histograms / postings gain the new row
    # Keep AIRSHIP-Start's sample drifting with the live set: occasionally
    # point a random sample slot at the new vertex (a fresh slot id cannot
    # already be sampled, so the sample stays duplicate-free).
    if index.sample_ids.shape[0] and slot not in index.sample_ids and (
        index.rng.rand() < index.sample_ids.shape[0] / max(pool.n_live, 1)
    ):
        index.sample_ids[index.rng.randint(index.sample_ids.shape[0])] = slot
    index.mark_dirty()
    return slot
