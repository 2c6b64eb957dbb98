"""Value types for the online serving runtime (DESIGN.md §7; port of
``repro.serving.types``, plain Python).

A *request* is one constrained query with its own ``k``, constraint family
and operand, and optional deadline — the heterogeneous unit the dynamic
batcher groups into bucket-shaped microbatches. A *response* is the
completed answer plus the telemetry the adaptive controller feeds on.

Requests are host-side mutable records (they move between batcher tiers as
the controller escalates them); everything that crosses to the device is
assembled per microbatch from their operands, on the executor's device
(runtime.py). Label operands stay numpy uint32 words here; they become the
port's int32 words, the same bits, only at assembly.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np

from repro_torch.obs.tracing import RequestTrace

FAMILIES = ("label", "range")
# Mutation "families" ride the SAME batcher as queries (their own groups,
# so they never share a microbatch with a search) but execute on the host
# against the streaming index — they never touch the compile cache, so the
# trace budget stays a pure query-shape quantity.
MUTATION_FAMILIES = ("upsert", "delete")


class AdmissionError(RuntimeError):
    """Raised by ``ServingRuntime.submit`` when the admission queue is full
    (backpressure: the caller must retry later or shed the request)."""


# --- deadline discipline (DESIGN.md §10) -----------------------------------
# A deadline is the LAST instant at which completion still counts: a
# response landing exactly at ``deadline`` is met. Everything that compares
# a deadline goes through these two helpers, so the batcher's "time to
# ship", the runtime's shed decision, and the completion verdict cannot
# drift apart (they once did: batcher flushed on ``deadline <= now`` while
# the runtime reported misses on ``now > deadline`` — consistent only by
# accident of both being exclusive at the boundary).


def deadline_due(deadline: Optional[float], now: float) -> bool:
    """The batcher must ship now: the deadline instant has arrived. At
    ``now == deadline`` the request is due AND still meetable — this is
    its last chance, not a miss."""
    return deadline is not None and now >= deadline


def deadline_missed(deadline: Optional[float], now: float) -> bool:
    """Completion (or shed-evaluation) strictly after the deadline is a
    miss; completing exactly at the deadline is met. Also the shed test:
    a request is expired-at-flush iff its deadline is already missed."""
    return deadline is not None and now > deadline


@dataclasses.dataclass
class Request:
    """One in-flight constrained query.

    operand: family == "label" -> (Lw,) uint32 allowed-label bitmask words;
             family == "range" -> (lo, hi, col) with col static per group.
    """

    req_id: int
    query: np.ndarray  # (d,) float32
    k: int
    family: str  # "label" | "range"
    operand: object
    deadline: Optional[float] = None  # absolute clock time, None = no deadline
    arrival_t: float = 0.0
    enqueue_t: float = 0.0  # last time it entered the batcher (escalations reset it)
    tier: int = 0
    escalations: int = 0
    fill_history: Tuple[int, ...] = ()  # filled count at each completed dispatch
    # Hybrid-routing verdict (DESIGN.md §9), stamped by the strategy router
    # at admission; defaults reproduce pre-hybrid behaviour exactly.
    strategy: str = "graph"  # "graph" | "posting" | "overlay"
    est_selectivity: Optional[float] = None
    sel_bucket: int = -1
    sel_source: str = "default"  # "histogram" | "sampled" | "default"
    overlay_label: Optional[int] = None  # single hot label, overlay routes
    # Fault-tolerance state (DESIGN.md §10): set while the degradation
    # ladder shapes this request (base tier forced / escalation capped /
    # cheap strategy preferred), and the executor-fault retry budget spent.
    degraded: bool = False
    fault_retries: int = 0
    # Observability (DESIGN.md §12): the span recorder riding this request
    # (None when the runtime serves with tracing off).
    trace: Optional[RequestTrace] = None

    def group(self) -> tuple:
        """Batcher compatibility key: requests in one microbatch must share
        it. The range column is per-batch traced data with a single value
        (RangeConstraint.col), so it joins the group; label operands are
        fully per-query.

        Graph-strategy keys are EXACTLY the pre-hybrid keys — the hybrid
        router only ever appends to the tuple for its own strategies, so
        existing traces, tests, and telemetry keyed on graph groups are
        untouched. Posting microbatches additionally share their operand
        (the scan gathers ONE posting set for the whole batch); overlay
        microbatches share their hot label (one sub-index per batch).
        """
        base = (
            (self.family, int(self.operand[2]))
            if self.family == "range"
            else (self.family,)
        )
        if self.strategy == "posting":
            return base + ("posting", self._operand_key())
        if self.strategy == "overlay":
            return base + ("overlay", int(self.overlay_label))
        return base

    def _operand_key(self) -> tuple:
        """Hashable identity of the operand (posting-group sharing)."""
        if self.family == "range":
            return (float(self.operand[0]), float(self.operand[1]))
        return (np.asarray(self.operand, np.uint32).tobytes(),)


@dataclasses.dataclass
class UpsertRequest(Request):
    """Insert one vector into the streaming index.

    ``query`` carries the new vector; ``operand`` is ``(label, attrs_row)``
    (attrs_row None when the corpus has no numeric attributes). The
    response's ``ids[0]`` is the assigned slot id.
    """

    def group(self) -> tuple:
        return ("upsert",)


@dataclasses.dataclass
class DeleteRequest(Request):
    """Tombstone one slot id (``operand``) in the streaming index.

    The response's ``filled`` is 1 when the slot was live and is now
    tombstoned, 0 when it was already dead (idempotent delete).
    """

    def group(self) -> tuple:
        return ("delete",)


@dataclasses.dataclass
class Response:
    req_id: int
    ids: np.ndarray  # (k,) int32, -1 padded
    dists: np.ndarray  # (k,) float32, +inf padded
    k: int
    filled: int  # slots with id >= 0 among the first k
    tier: int  # tier that produced the final answer
    escalations: int
    fill_history: Tuple[int, ...]  # filled at each dispatch incl. final
    arrival_t: float = 0.0
    complete_t: float = 0.0
    deadline_missed: bool = False
    # Index epoch the answer was computed against (streaming executors
    # only; None for static indexes). Queries in one flush share an epoch —
    # the snapshot swap is atomic at flush boundaries (DESIGN.md §8).
    epoch: Optional[int] = None
    # Hybrid-routing telemetry (DESIGN.md §9): the executor strategy that
    # produced this answer and the router's selectivity estimate for it.
    strategy: str = "graph"
    est_selectivity: Optional[float] = None
    # Fault-tolerance outcome (DESIGN.md §10). A response is exactly one
    # of: served (shed_reason None, error None), shed (shed_reason
    # "expired" — deadline already missed at flush — or "overload" — the
    # level-3 ladder predicted an unmeetable deadline), or failed (error
    # set: an executor fault exhausted its retry budget). ``degraded``
    # marks answers shaped by the ladder or hit by an injected latency
    # spike — the mark that makes a late completion accountable.
    shed_reason: Optional[str] = None
    degraded: bool = False
    faulted: bool = False  # an injected fault touched this dispatch
    error: Optional[str] = None
    # Observability (DESIGN.md §12): the span recorder's stage breakdown
    # (queue_wait | batch_wait | execute | overhead, summing to the
    # end-to-end latency) and the microbatch that produced the final
    # answer — None/-1 when the runtime serves with tracing off.
    trace: Optional[dict] = None
    batch_id: int = -1

    @property
    def ok(self) -> bool:
        """Served (possibly degraded/partial) — not shed, not failed."""
        return self.shed_reason is None and self.error is None

    @property
    def latency(self) -> float:
        return self.complete_t - self.arrival_t

    @property
    def fill_frac(self) -> float:
        return self.filled / max(self.k, 1)


class VirtualClock:
    """Injectable clock for deterministic tests and discrete-event replay.

    ``ServingRuntime`` timestamps via ``clock()``; drivers that simulate
    Poisson arrivals advance virtual time explicitly (arrival gaps) and the
    runtime adds each microbatch's *measured* execution wall time via
    ``advance`` — so latencies are arrival-to-completion in a consistent
    timeline even when the host replays the stream faster than real time.
    """

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> float:
        self.now += float(dt)
        return self.now

    def advance_to(self, t: float) -> float:
        self.now = max(self.now, float(t))
        return self.now


def wall_clock() -> float:
    return time.perf_counter()


def cpu_clock() -> float:
    """CPU seconds consumed by the calling thread.

    Dispatch *cost accounting* (ServingRuntime.busy_seconds) uses this
    instead of wall intervals: in a single-process multi-replica harness
    the GIL deschedules a dispatching pump while other replicas' threads
    run, and a wall interval would charge that contention to the replica
    — precisely what shared-nothing placement on separate cores removes.
    Timeline advancement (deadlines, virtual clocks) stays on
    ``wall_clock``.
    """
    return time.thread_time()
