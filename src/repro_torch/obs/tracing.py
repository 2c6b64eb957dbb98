"""Per-request span recorder (DESIGN.md §12; port of ``repro.obs.tracing``,
plain Python).

One ``RequestTrace`` rides each in-flight ``Request`` through the serving
runtime, stamping its lifecycle — admission → route verdict → batcher wait
→ flush/pack → executor dispatch → completion/shed — from the *injected*
clock only (this module never reads wall time itself, honoring the
``test_no_wall_clock`` discipline: every timestamp is handed in by the
runtime, which owns the clock).

The stage accumulators tile the request's whole life, escalations and
fault retries included (a request that re-enters the batcher keeps
accumulating into the same trace):

    queue_wait — time spent waiting in the batcher (enqueue → flush),
                 summed across escalation/retry passes;
    batch_wait — flush → executor dispatch start (EDF ordering, shed
                 checks, and earlier microbatches of the same flush);
    execute    — measured dispatch duration(s) charged to the timeline;
    overhead   — everything else (host bookkeeping between stamps),
                 computed as the residual so the stage sum equals the
                 end-to-end latency by construction.

``breakdown()`` is what lands on ``Response.trace``; per-stage histograms
are fed from it by ``Telemetry.on_complete``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

STAGES = ("queue_wait", "batch_wait", "execute", "overhead")

# Events are bounded per trace: a pathological escalation/retry loop must
# not grow a request's span list without bound (the stage accumulators
# keep counting past the cap; only the event detail stops).
MAX_EVENTS = 64


class RequestTrace:
    """Stage accumulators + a bounded event log for one request."""

    __slots__ = (
        "req_id", "arrival_t", "queue_wait", "batch_wait", "execute",
        "passes", "events", "_flush_t", "_truncated", "replica",
    )

    def __init__(
        self, req_id: int, arrival_t: float, replica: Optional[int] = None
    ):
        self.req_id = int(req_id)
        self.arrival_t = float(arrival_t)
        self.replica = replica  # which tier replica served this request
        self.queue_wait = 0.0
        self.batch_wait = 0.0
        self.execute = 0.0
        self.passes = 0  # dispatches this request participated in
        self.events: List[Tuple[str, float]] = [("admitted", self.arrival_t)]
        self._flush_t: Optional[float] = None
        self._truncated = False

    def mark(self, event: str, t: float) -> None:
        if len(self.events) < MAX_EVENTS:
            self.events.append((event, float(t)))
        else:
            self._truncated = True

    # --- lifecycle stamps (the runtime calls these) -----------------------
    def on_flush(self, enqueue_t: float, flush_t: float) -> None:
        """This request's group was pulled from the batcher: one batcher
        wait ends. Escalated/retried requests hit this once per pass."""
        self.queue_wait += max(float(flush_t) - float(enqueue_t), 0.0)
        self._flush_t = float(flush_t)
        self.mark("flushed", flush_t)

    def on_exec(self, start_t: float, end_t: float) -> None:
        """One executor dispatch covered [start_t, end_t] of the timeline;
        the gap since this pass's flush is batch_wait (EDF ordering plus
        earlier batches of the same flush)."""
        if self._flush_t is not None:
            self.batch_wait += max(float(start_t) - self._flush_t, 0.0)
            self._flush_t = None
        self.execute += max(float(end_t) - float(start_t), 0.0)
        self.passes += 1
        self.mark("executed", end_t)

    def breakdown(self, complete_t: float, outcome: str = "served") -> dict:
        """The ``Response.trace`` payload. ``overhead`` is the residual of
        the accounted stages against end-to-end latency, so the stage sum
        reproduces the latency exactly (clamped at zero against float
        dust)."""
        self.mark(outcome, complete_t)
        total = max(float(complete_t) - self.arrival_t, 0.0)
        accounted = self.queue_wait + self.batch_wait + self.execute
        out = {
            "queue_wait": self.queue_wait,
            "batch_wait": self.batch_wait,
            "execute": self.execute,
            "overhead": max(total - accounted, 0.0),
            "total": total,
            "passes": self.passes,
            "outcome": outcome,
            "events": list(self.events),
        }
        if self.replica is not None:
            out["replica"] = self.replica
        if self._truncated:
            out["events_truncated"] = True
        return out


def stage_sum(trace: dict) -> float:
    return sum(float(trace[s]) for s in STAGES)


def trace_consistent(trace: dict, rel_tol: float = 0.01) -> bool:
    """The acceptance predicate: the stage breakdown tiles the end-to-end
    latency to within ``rel_tol`` (1% by default; an absolute epsilon
    covers ~zero-latency sheds)."""
    total = float(trace["total"])
    return abs(stage_sum(trace) - total) <= max(rel_tol * total, 1e-9)
