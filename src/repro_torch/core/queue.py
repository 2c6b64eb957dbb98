"""Fixed-capacity batched priority queues as sorted tensors (port of
``repro.core.queue``).

Each row is a distance-ascending array of static capacity C; empty slots
hold (+inf, -1). Every selection goes through ``torch.sort(stable=True)``:
``torch.topk`` does not promise the reference's tie order (``lax.top_k``
returns tied keys lower index first), and a stable ascending sort does.

The sorted-run functions give the reference's outputs bit for bit. The
reference builds them from a bitonic network over (dist-bits, position)
pairs; here each is one stable sort on the dist-bits key, whose tie order
is the position order the network encodes. Keys are int64, so the padding
key 0xFFFFFFFF and the partition bit 0x80000000 stay positive.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.common.device import resolve_device

INF = float("inf")
PAD_ID = -1

_INF_BITS = 0x7F800000  # +inf as its float32 bit pattern
_PAD_KEY = 0xFFFFFFFF


@dataclass(frozen=True)
class BatchedQueue:
    """A batch of fixed-capacity min-queues (sorted ascending by distance)."""

    dists: torch.Tensor  # (B, C) float32, +inf padded, ascending
    ids: torch.Tensor  # (B, C) int32, -1 padded

    @property
    def capacity(self) -> int:
        return self.dists.shape[-1]

    @property
    def batch(self) -> int:
        return self.dists.shape[0]


def queue_init(batch: int, capacity: int, device="cuda") -> BatchedQueue:
    device = resolve_device(device)
    return BatchedQueue(
        dists=torch.full((batch, capacity), INF, dtype=torch.float32, device=device),
        ids=torch.full((batch, capacity), PAD_ID, dtype=torch.int32, device=device),
    )


def queue_head(q: BatchedQueue) -> tuple[torch.Tensor, torch.Tensor]:
    """Best (distance, id) per row; (+inf, -1) when empty."""
    return q.dists[:, 0], q.ids[:, 0]


def queue_nonempty(q: BatchedQueue) -> torch.Tensor:
    """(B,) bool: does each row hold at least one live element."""
    return torch.isfinite(q.dists[:, 0])


def queue_size(q: BatchedQueue) -> torch.Tensor:
    """(B,) int32 number of live elements."""
    return torch.isfinite(q.dists).sum(-1, dtype=torch.int32)


def queue_pop(q: BatchedQueue, do_pop: torch.Tensor):
    """Pop the head of each row where ``do_pop`` (B,) is set.

    Rows with ``do_pop`` False are returned unchanged; their head is still
    reported (callers mask on ``do_pop``).
    """
    new, head_d, head_i = queue_pop_n(q, 1, do_pop)
    return new, head_d[:, 0], head_i[:, 0]


def queue_pop_n(q: BatchedQueue, n: int, do_pop: torch.Tensor):
    """Pop the best ``n`` elements of each row where ``do_pop`` is set.

    Returns (new_queue, (B, n) dists, (B, n) ids), ascending per row, with
    (+inf, -1) where a row holds fewer than ``n`` live elements.
    """
    c = q.capacity
    pad_d = torch.full((q.batch, n), INF, dtype=q.dists.dtype, device=q.dists.device)
    pad_i = torch.full((q.batch, n), PAD_ID, dtype=q.ids.dtype, device=q.ids.device)
    if n >= c:
        head_d = torch.cat([q.dists, pad_d[:, : n - c]], -1)
        head_i = torch.cat([q.ids, pad_i[:, : n - c]], -1)
        shifted_d = torch.full_like(q.dists, INF)
        shifted_i = torch.full_like(q.ids, PAD_ID)
    else:
        head_d, head_i = q.dists[:, :n], q.ids[:, :n]
        shifted_d = torch.cat([q.dists[:, n:], pad_d], -1)
        shifted_i = torch.cat([q.ids[:, n:], pad_i], -1)
    pop = do_pop[:, None]
    new = BatchedQueue(
        dists=torch.where(pop, shifted_d, q.dists),
        ids=torch.where(pop, shifted_i, q.ids),
    )
    return new, head_d, head_i


def queue_push(q: BatchedQueue, new_d, new_i, valid) -> BatchedQueue:
    """Insert up to M new elements per row; keep the best C.

    Invalid entries are masked to (+inf, -1) first. Ties keep queue
    elements first, then candidate order, as ``lax.top_k`` of the negated
    keys does in the reference.
    """
    nd = torch.where(valid, new_d, INF).to(q.dists.dtype)
    ni = torch.where(valid, new_i, PAD_ID).to(q.ids.dtype)
    all_d = torch.cat([q.dists, nd], -1)
    all_i = torch.cat([q.ids, ni], -1)
    d, pos = torch.sort(all_d, dim=-1, stable=True)
    c = q.capacity
    return BatchedQueue(dists=d[:, :c], ids=all_i.gather(1, pos[:, :c]))


def _dist_bits(d: torch.Tensor) -> torch.Tensor:
    """Non-negative float32 (incl. +inf) -> order-preserving uint32 key, as int64.

    ``+ 0.0`` turns -0.0 (bits 0x80000000, which would order above +inf)
    into +0.0 before the reinterpretation.
    """
    return (d.float() + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _bits_dist(key: torch.Tensor) -> torch.Tensor:
    return key.to(torch.int32).view(torch.float32)


def sort_run(d, i, valid):
    """Mask and sort a (B, M) batch into an ascending (+inf, -1)-padded run.

    Stable under distance ties (original index order): exactly the order
    ``queue_push`` would honour, so the output is a valid
    ``queue_merge_sorted`` run.
    """
    key = torch.where(valid, _dist_bits(d), _PAD_KEY)
    order = torch.sort(key, dim=-1, stable=True).indices
    m = d.shape[-1]
    n_valid = valid.sum(-1, keepdim=True)
    live = torch.arange(m, device=d.device)[None, :] < n_valid
    out_d = torch.where(live, d.gather(1, order), INF)
    out_i = torch.where(live, i.gather(1, order), PAD_ID)
    return out_d, out_i


def partition_sorted_runs(d, i, first, second, cap_first: int, cap_second: int):
    """Split a candidate batch into two ascending runs with ONE sort.

    ``first``/``second`` are disjoint membership masks; elements in neither
    are dropped. The partition rides in the top key bit (squared distances
    never set it), so one stable sort yields [first | second | dropped],
    each segment ascending and tie-stable in index order. Runs are cut to
    their queue's capacity and padded with (+inf, -1).
    """
    bits = _dist_bits(d)
    key = torch.where(first, bits, torch.where(second, bits + 0x80000000, _PAD_KEY))
    order = torch.sort(key, dim=-1, stable=True).indices
    m = d.shape[-1]
    n_first = first.sum(-1, keepdim=True)
    n_second = second.sum(-1, keepdim=True)

    def extract(offset, count, width):
        ar = torch.arange(width, device=d.device)[None, :]
        p = order.gather(1, (ar + offset).clamp(max=m - 1))
        live = ar < count
        return (torch.where(live, d.gather(1, p), INF),
                torch.where(live, i.gather(1, p), PAD_ID))

    run1 = extract(torch.zeros_like(n_first), n_first, min(m, cap_first))
    run2 = extract(n_first, n_second, min(m, cap_second))
    return run1, run2


def queue_merge_sorted(q: BatchedQueue, run_d, run_i) -> BatchedQueue:
    """Merge an ascending (+inf, -1)-padded run into the queue; keep best C.

    Bit for bit ``queue_push(q, run_d, run_i, isfinite(run_d))``, ties
    included (queue element first, then run order): both sides are sorted,
    so the C smallest of the union by (dist-bits, position) are the first C
    of one stable sort of their concatenation.
    """
    c = q.capacity
    key = torch.cat([_dist_bits(q.dists), _dist_bits(run_d)], -1)
    sk, pos = torch.sort(key, dim=-1, stable=True)
    out_d = _bits_dist(sk[:, :c].clamp(max=_INF_BITS))
    all_i = torch.cat([q.ids, run_i.to(q.ids.dtype)], -1)
    out_i = torch.where(torch.isfinite(out_d), all_i.gather(1, pos[:, :c]), PAD_ID)
    return BatchedQueue(dists=out_d, ids=out_i)


def queue_worst_finite(q: BatchedQueue) -> torch.Tensor:
    """(B,) distance of the worst live element; -inf when empty."""
    return torch.where(torch.isfinite(q.dists), q.dists, -INF).amax(-1)


def topk_threshold(q: BatchedQueue, k: int) -> torch.Tensor:
    """(B,) value of the last slot: +inf until the list is full.

    The result list's capacity is the threshold's k, so slot C-1 is the
    paper's ``topk.peek_max()`` with the ``|topk| = K`` test folded in.
    """
    del k  # the queue's capacity is k
    return q.dists[:, -1]
