"""Dynamic batcher: group compatible requests, pad to a bucket ladder (port
of ``repro.serving.batcher``, plain Python).

Search closures are built per batch shape, so per-request dispatch would
either build one closure per batch size (unbounded) or serialize everything
at batch=1 (no vectorization). The batcher quantizes instead: requests are
grouped by ``(family[, range col], tier)`` and shipped as microbatches
padded to a small ladder of batch sizes (default {8, 32, 128}) — so the
compile-cache key space is |ladder| x |families| x |tiers| no matter what
the stream looks like (DESIGN.md §7).

Flush policy per group:
  * whenever a group holds >= max(ladder) requests, full top-size buckets
    ship immediately (no timeout needed to reach peak throughput);
  * a group whose oldest enqueued request has waited ``max_wait`` — or
    whose earliest deadline has arrived — drains completely, greedily
    packing the largest ladder sizes that fill with real requests and
    padding only the final partial bucket up to the smallest size that
    admits it (padding waste < min(ladder) requests per flush);
  * ``force=True`` drains everything (used by ``ServingRuntime.drain``).

Padding repeats the last real request's query + operand so padded lanes
cost one realistic traversal each and are discarded on the way out.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Tuple

from repro_torch.serving.types import Request, deadline_due

BATCH_LADDER = (8, 32, 128)


@dataclasses.dataclass
class MicroBatch:
    group: tuple  # (family[, col])
    tier: int
    bucket: int  # padded batch size (a ladder entry)
    requests: List[Request]  # len <= bucket, all sharing (group, tier)
    # Monotonic dispatch id stamped by the runtime at flush time — the
    # correlation key between structured log records and Response.batch_id.
    batch_id: int = -1

    @property
    def family(self) -> str:
        return self.group[0]

    @property
    def strategy(self) -> str:
        """Executor strategy shared by the batch ("graph" unless the hybrid
        router stamped something else; group keys separate strategies)."""
        return self.requests[0].strategy if self.requests else "graph"

    @property
    def n_real(self) -> int:
        return len(self.requests)

    @property
    def n_padded(self) -> int:
        return self.bucket - len(self.requests)


def bucket_for(n: int, ladder: Tuple[int, ...]) -> int:
    """Smallest ladder size admitting n requests (n <= max(ladder))."""
    for b in ladder:
        if n <= b:
            return b
    raise ValueError(f"batch {n} exceeds ladder {ladder}")


class DynamicBatcher:
    def __init__(self, ladder: Tuple[int, ...] = BATCH_LADDER, max_wait: float = 0.002):
        if not ladder or list(ladder) != sorted(set(ladder)):
            raise ValueError(f"ladder must be sorted unique sizes: {ladder}")
        self.ladder = tuple(int(b) for b in ladder)
        self.max_wait = float(max_wait)
        self._pending: Dict[tuple, Deque[Request]] = {}

    def add(self, req: Request, now: float) -> None:
        req.enqueue_t = now
        key = (req.group(), req.tier)
        self._pending.setdefault(key, deque()).append(req)

    def pending_count(self) -> int:
        return sum(len(q) for q in self._pending.values())

    def occupancy(self) -> Dict[tuple, int]:
        """Pending requests per (group, tier) key — the bucket-occupancy
        gauge the metrics registry exposes (obs/adapters.py)."""
        return {key: len(q) for key, q in self._pending.items() if q}

    def _due(self, reqs: Deque[Request], now: float) -> bool:
        oldest = min(r.enqueue_t for r in reqs)
        if now - oldest >= self.max_wait:
            return True
        # Shared boundary semantics (types.deadline_due): at now ==
        # deadline the request ships — its last meetable instant.
        return any(deadline_due(r.deadline, now) for r in reqs)

    def _drain_group(self, reqs: Deque[Request]) -> List[Tuple[int, List[Request]]]:
        """Greedy ladder packing: largest fully-real buckets first, pad only
        the final partial one."""
        out: List[Tuple[int, List[Request]]] = []
        while reqs:
            n = len(reqs)
            full = [b for b in self.ladder if b <= n]
            take = max(full) if full else n
            chunk = [reqs.popleft() for _ in range(take)]
            out.append((bucket_for(take, self.ladder), chunk))
        return out

    def flush(self, now: float, force: bool = False) -> List[MicroBatch]:
        """Collect every microbatch due at ``now``; empty list when nothing
        is due (including the empty-batcher case)."""
        out: List[MicroBatch] = []
        top = self.ladder[-1]
        for key, reqs in list(self._pending.items()):
            group, tier = key
            # Full top-size buckets ship unconditionally.
            while len(reqs) >= top:
                chunk = [reqs.popleft() for _ in range(top)]
                out.append(MicroBatch(group=group, tier=tier, bucket=top, requests=chunk))
            if reqs and (force or self._due(reqs, now)):
                for bucket, chunk in self._drain_group(reqs):
                    out.append(
                        MicroBatch(group=group, tier=tier, bucket=bucket, requests=chunk)
                    )
            if not reqs:
                del self._pending[key]
        return out
