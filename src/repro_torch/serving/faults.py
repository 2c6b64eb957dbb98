"""Seeded, deterministic fault injection for the serving runtime (port of
``repro.serving.faults``, plain Python and numpy).

Every recovery path in DESIGN.md §10 is driven by *injected* faults in
tests and in ``benchmarks/bench_slo.py`` — not hoped-for in production:

  * executor exceptions — a search-closure dispatch raises
    ``InjectedFault`` (an ``ExecutorFault``); the runtime retries the
    microbatch's requests through the batcher up to a per-request budget,
    then surfaces a *failed* ``Response`` (``error`` set) — never a hung
    or silently lost request;
  * latency spikes — a dispatch takes ``spike_s`` longer than measured;
    under virtual-time replay the spike advances the injected clock, so
    deadline misses caused by the spike are real in the timeline and the
    affected responses are marked ``faulted`` (and ``degraded``, so the
    "no unmarked late completion" invariant stays checkable);
  * stale-epoch snapshots — a streaming ``refresh()`` applies its
    mutations but *delays publishing* the new snapshot by one flush
    boundary: queries keep serving (and honestly reporting) the old
    epoch until the next swap catches up.

``FaultSchedule`` draws the fault sequence from one seeded RNG, so a
given (seed, rates) pair replays the identical fault pattern every run.
``FaultyExecutor`` wraps any executor (Local / StreamingLocal) and delegates everything it does not intercept, so the
runtime cannot tell it apart from the real thing — which is the point.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


class ExecutorFault(RuntimeError):
    """An executor-level failure the runtime is expected to survive
    (retry within budget, then surface as a failed ``Response``).
    Real executors should wrap infrastructure errors in this type to opt
    into the recovery path; anything else propagates as a bug."""


class InjectedFault(ExecutorFault):
    """An ``ExecutorFault`` raised by ``FaultyExecutor`` on schedule."""


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Rates are per *event*: error/spike per search-closure dispatch,
    stale per ``refresh()`` (epoch swap). All draws come from one seeded
    RNG in event order, so the schedule is deterministic."""

    seed: int = 0
    error_rate: float = 0.0
    spike_rate: float = 0.0
    spike_s: float = 0.05
    stale_epoch_rate: float = 0.0
    max_faults: Optional[int] = None  # stop injecting after this many


class FaultSchedule:
    def __init__(self, config: FaultConfig):
        self.config = config
        self._rng = np.random.RandomState(config.seed)
        self.injected = 0
        self.by_kind: dict = {"error": 0, "spike": 0, "stale_epoch": 0}

    def _budget_left(self) -> bool:
        mx = self.config.max_faults
        return mx is None or self.injected < mx

    def _count(self, kind: str) -> str:
        self.injected += 1
        self.by_kind[kind] += 1
        return kind

    def draw_dispatch(self) -> Optional[str]:
        """Fault verdict for one search-closure dispatch:
        "error" | "spike" | None."""
        r = float(self._rng.rand())
        if not self._budget_left():
            return None
        if r < self.config.error_rate:
            return self._count("error")
        if r < self.config.error_rate + self.config.spike_rate:
            return self._count("spike")
        return None

    def draw_refresh(self) -> bool:
        """True when this epoch swap should publish stale (delayed)."""
        r = float(self._rng.rand())
        if not self._budget_left():
            return False
        if r < self.config.stale_epoch_rate:
            self._count("stale_epoch")
            return True
        return False


class FaultClock:
    """Clock wrapper that owns spike time: reads delegate to the base
    clock, ``spike(dt)`` advances it (virtual clocks only) and accounts
    the injected seconds — so a test can assert exactly how much latency
    the schedule added to the timeline."""

    def __init__(self, base):
        self.base = base
        self.injected_s = 0.0

    def __call__(self) -> float:
        return self.base()

    def advance(self, dt: float) -> float:
        return self.base.advance(dt)

    def advance_to(self, t: float) -> float:
        return self.base.advance_to(t)

    def spike(self, dt: float) -> None:
        self.injected_s += float(dt)
        if hasattr(self.base, "advance"):
            self.base.advance(dt)
        # wall-clock base: the spike is accounted but cannot move real
        # time — dispatch-duration measurement will still include any
        # real slowness; injection is a virtual-time tool.


class FaultyExecutor:
    """Wraps an executor; injects the schedule's faults at its seams.

    Intercepts ``build`` (search-closure dispatches: errors + spikes)
    and ``refresh`` (streaming epoch swaps: stale publication). Every
    other attribute — ``dim``, ``corpus``, ``index``, ``apply_mutations``,
    ``epoch``, ``traces`` — delegates to the wrapped executor, so
    capability probes (``hasattr``) see exactly the inner executor's
    surface. Host-side posting/overlay dispatches bypass ``build`` and
    are therefore not faultable (they share the runtime's process; an
    executor fault seam there would be injecting into ourselves).

    ``pop_faults()`` hands the runtime the kinds injected since the last
    pop, so telemetry counts and per-response ``faulted`` marks come from
    the injector's ground truth, not a parallel guess.
    """

    def __init__(self, inner, schedule: FaultSchedule, clock: Optional[FaultClock] = None):
        self.inner = inner
        self.schedule = schedule
        self.clock = clock
        # ``armed=False`` passes everything through clean: warmup's dummy
        # dispatches must neither fault nor consume schedule draws (the
        # measured run's fault pattern stays a pure (seed, rates) function).
        self.armed = True
        self._pending_kinds: List[str] = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def pop_faults(self) -> List[str]:
        kinds, self._pending_kinds = self._pending_kinds, []
        return kinds

    def build(self, bucket: int, family: str, params):
        fn = self.inner.build(bucket, family, params)

        def faulty(queries, constraint):
            kind = self.schedule.draw_dispatch() if self.armed else None
            if kind == "error":
                self._pending_kinds.append(kind)
                raise InjectedFault(
                    f"injected executor fault #{self.schedule.injected} "
                    f"(bucket={bucket}, family={family})"
                )
            if kind == "spike":
                self._pending_kinds.append(kind)
                if self.clock is not None:
                    self.clock.spike(self.schedule.config.spike_s)
            return fn(queries, constraint)

        return faulty

    def refresh(self) -> int:
        if self.armed and self.schedule.draw_refresh():
            self._pending_kinds.append("stale_epoch")
            # Mutations (and any due consolidation) still apply; only the
            # snapshot publication is delayed one flush boundary — the
            # inner executor keeps serving, and honestly reporting, the
            # old epoch until the next refresh.
            stale = self.inner.snapshot
            self.inner.refresh()
            self.inner.snapshot = stale
            return stale.epoch
        return self.inner.refresh()
