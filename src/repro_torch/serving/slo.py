"""SLO degradation ladder: overload detection with hysteresis (DESIGN.md §10;
port of ``repro.serving.slo``, plain Python).

Under a traffic burst the runtime cannot serve every request at full
quality *and* on time; the ladder decides which to give up, stepwise:

    level 0  normal        — full tier ladder, escalations allowed
    level 1  capped        — new requests start at tier 0, under-fill
                             escalations to the retry tier are suppressed
                             (the single biggest compute saving: a retry
                             re-runs the query at 4x the budget)
    level 2  cheap-first   — additionally, the hybrid strategy router is
                             asked to prefer the host-side posting /
                             overlay executors wherever they are
                             applicable, keeping bursts off the compiled
                             graph path entirely
    level 3  shedding      — additionally, requests whose deadline is
                             provably unmeetable (sooner than the observed
                             service-latency EMA) are shed at flush time
                             with ``shed_reason="overload"`` instead of
                             burning a search they cannot use

The detector folds two signals into EMAs: the batcher's queue depth
(observed once per ``step``) and completed-response latency (observed per
response). A level moves only after the overloaded/calm condition holds
for ``hold_up``/``hold_down`` consecutive load observations — hysteresis,
so one slow batch does not flap the ladder and the ladder recovers after
the burst instead of latching degraded forever.

Everything here is pure bookkeeping: no clock access (latency samples
arrive from outside), no device work, so the ladder is trivially deterministic
under virtual-time replay and fault injection.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Overload thresholds + hysteresis for the degradation ladder."""

    # Observed arrival-to-completion latency above this is an SLO breach
    # signal (seconds; compare your workload's deadline).
    target_latency: float = 0.05
    # Queue depth (batcher pending + in flight) EMA >= high -> overloaded;
    # <= low (with latency also healthy) -> calm. low < high = hysteresis
    # band: between the two, the ladder holds its current level.
    queue_high: int = 64
    queue_low: int = 8
    ema_alpha: float = 0.25
    # Consecutive overloaded/calm load observations before a level moves.
    hold_up: int = 2
    hold_down: int = 4
    max_level: int = 3
    # Latency recovery margin: calm additionally needs the latency EMA
    # under margin * target (recovering at exactly the target would flap).
    recover_margin: float = 0.8
    # Load observations without a single completion before the latency EMA
    # stops counting as an overload signal. Without this the ladder can
    # death-spiral: level 3 sheds everything -> zero completions -> the EMA
    # freezes at its burst-era high -> level 3 latches forever. A stale EMA
    # means "we have no current latency evidence", not "still slow".
    lat_stale_after: int = 8


class DegradationLadder:
    """Hysteretic overload detector + the level the runtime acts on."""

    def __init__(self, config: Optional[SLOConfig] = None):
        self.config = config or SLOConfig()
        self.level = 0
        self.queue_ema: Optional[float] = None
        self.lat_ema: Optional[float] = None
        # Execution-only dispatch duration EMA: what one more dispatch
        # would cost *now*, free of the queue-wait that inflates lat_ema
        # during a burst — the honest basis for predictive shedding.
        self.service_ema: Optional[float] = None
        self._lat_obs_at = 0
        self._up_held = 0
        self._down_held = 0
        self.observations = 0
        # (observation index, old level, new level) — bounded; a ladder
        # that transitions thousands of times is flapping, which the
        # hysteresis test asserts against.
        self.transitions: List[Tuple[int, int, int]] = []

    # --- signal intake ----------------------------------------------------
    def observe_latency(self, latency: float) -> None:
        """Fold one completed response's latency into the EMA. Does NOT
        move the level — transitions happen at load observations only, so
        the hold counters count runtime steps, not responses."""
        a = self.config.ema_alpha
        self.lat_ema = (
            float(latency)
            if self.lat_ema is None
            else (1 - a) * self.lat_ema + a * float(latency)
        )
        self._lat_obs_at = self.observations

    def observe_service(self, duration: float) -> None:
        """Fold one dispatch's measured *execution* duration (no queue
        wait) into the service-time EMA used by ``predicted_miss``."""
        a = self.config.ema_alpha
        self.service_ema = (
            float(duration)
            if self.service_ema is None
            else (1 - a) * self.service_ema + a * float(duration)
        )

    def observe_load(self, queue_depth: int) -> int:
        """Fold one queue-depth sample, then step the level (with
        hysteresis) and return it. Called once per runtime ``step``."""
        a = self.config.ema_alpha
        self.queue_ema = (
            float(queue_depth)
            if self.queue_ema is None
            else (1 - a) * self.queue_ema + a * float(queue_depth)
        )
        self.observations += 1
        cfg = self.config
        # A latency EMA with no completion behind it for lat_stale_after
        # steps is evidence of *shedding*, not of slowness: it must not
        # keep the ladder pinned up (see SLOConfig.lat_stale_after).
        lat_stale = self.observations - self._lat_obs_at > cfg.lat_stale_after
        lat_known = self.lat_ema is not None and not lat_stale
        lat_hot = lat_known and self.lat_ema > cfg.target_latency
        lat_calm = (
            not lat_known
            or self.lat_ema <= cfg.recover_margin * cfg.target_latency
        )
        overloaded = self.queue_ema >= cfg.queue_high or lat_hot
        calm = self.queue_ema <= cfg.queue_low and lat_calm

        if overloaded:
            self._up_held += 1
            self._down_held = 0
            if self._up_held >= cfg.hold_up and self.level < cfg.max_level:
                self._move(self.level + 1)
                self._up_held = 0
        elif calm:
            self._down_held += 1
            self._up_held = 0
            if self._down_held >= cfg.hold_down and self.level > 0:
                self._move(self.level - 1)
                self._down_held = 0
        else:  # hysteresis band: hold the level, reset both counters
            self._up_held = 0
            self._down_held = 0
        return self.level

    def _move(self, new_level: int) -> None:
        self.transitions.append((self.observations, self.level, new_level))
        self.level = new_level

    # --- what the runtime acts on ----------------------------------------
    @property
    def force_base_tier(self) -> bool:
        """New requests start at tier 0 regardless of the family default."""
        return self.level >= 1

    @property
    def cap_escalations(self) -> bool:
        """Suppress under-fill escalations to the retry tier."""
        return self.level >= 1

    @property
    def prefer_cheap(self) -> bool:
        """Ask the strategy router to prefer posting/overlay executors."""
        return self.level >= 2

    @property
    def shed_predicted(self) -> bool:
        """Shed flush-time requests whose deadline the latency EMA says
        cannot be met (``shed_reason="overload"``)."""
        return self.level >= 3

    def predicted_miss(self, deadline: Optional[float], now: float) -> bool:
        """True when ``deadline`` is sooner than one more dispatch can
        possibly finish (only consulted at level 3). Uses the execution-only
        service EMA: the arrival-to-completion EMA would double-count the
        burst's queue wait, which a flush-time request no longer pays —
        predicting with it sheds requests that would in fact make it."""
        if deadline is None:
            return False
        est = self.service_ema if self.service_ema is not None else self.lat_ema
        if est is None:
            return False
        return now + est > deadline

    def snapshot(self) -> dict:
        return {
            "level": self.level,
            "queue_ema": None if self.queue_ema is None else round(self.queue_ema, 2),
            "lat_ema": None if self.lat_ema is None else round(self.lat_ema, 6),
            "service_ema": (
                None if self.service_ema is None else round(self.service_ema, 6)
            ),
            "observations": self.observations,
            "transitions": len(self.transitions),
        }
