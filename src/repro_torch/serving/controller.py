"""Adaptive search controller: tier ladder + under-fill escalation (port of
``repro.serving.controller`` over the port's ``SearchParams``).

The paper's offline fix for pipeline under-fill is "hope s is large
enough"; online, over-provisioning every query with a huge ``ef`` wastes
the common case. The controller keeps a small declared ladder of
``SearchParams`` *tiers* — same mode/k, growing ``ef_result`` /
``max_iters`` / ``n_start`` — and works at two timescales:

  * per request: a query that comes back with ``filled < k`` is escalated
    to the next tier and re-dispatched (through the batcher, so retries
    batch too) instead of returning padded slots;
  * per family: an EMA of fill fraction and loop-iteration headroom picks
    the *default* tier new requests start at — a family whose base tier
    keeps under-filling is promoted (first-dispatch fill, fewer retries), a
    family that fills easily with iteration headroom is demoted back.

Both knobs only ever select *within* the declared ladder, which is what
keeps the closure cache's trace budget a static quantity (cache.py).

With an ``SLOConfig`` the controller additionally runs the degradation
ladder (slo.py, DESIGN.md §10): queue-depth + observed-latency EMAs feed
a hysteretic overload level, and the two request-policy entry points that
already live here — ``tier_for`` (admission tier) and ``escalate``
(retry-tier re-runs) — consult it, so overload protection needs no new
wiring in the runtime's hot path.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core.types import SearchParams
from repro_torch.serving.slo import DegradationLadder, SLOConfig
from repro_torch.serving.types import Request


def make_tier_ladder(
    k_cap: int = 16,
    mode: str = "prefer",
    n_tiers: int = 2,
    base_ef: int = 64,
    base_iters: int = 128,
    base_n_start: int = 16,
    growth: int = 4,
) -> Tuple[SearchParams, ...]:
    """Geometric tier ladder. Tier 0 is lean (sized for the common case);
    each next tier multiplies the search budget by ``growth``. ``k`` is the
    static cap every compiled closure serves — per-request ``k <= k_cap``
    takes a prefix of the result list."""
    tiers = []
    for t in range(n_tiers):
        g = growth**t
        ef = max(base_ef * g, k_cap)
        tiers.append(
            SearchParams(
                mode=mode,
                k=k_cap,
                ef_result=ef,
                ef_sat=ef,
                ef_other=ef,
                n_start=base_n_start * g,
                max_iters=base_iters * g,
            )
        )
    return tuple(tiers)


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    ema_alpha: float = 0.25  # weight of the newest batch in the EMAs
    promote_below: float = 0.9  # default-tier fill EMA below this -> promote
    demote_above: float = 0.995  # fill EMA above this AND headroom -> demote
    # Demotion additionally requires the iteration EMA to fit comfortably in
    # the *lower* tier's budget (otherwise demoting would just re-underfill).
    demote_iter_headroom: float = 0.5
    min_batches: int = 4  # batches observed at a tier before retuning


@dataclasses.dataclass
class _FamilyState:
    default_tier: int = 0
    fill_ema: Optional[float] = None  # fill fraction at the default tier
    iter_ema: Optional[float] = None  # loop iterations at the default tier
    batches_at_tier: int = 0


@dataclasses.dataclass
class _StrategyStats:
    """Per-strategy EMAs within one (family, selectivity-bucket) key."""

    lat_ema: Optional[float] = None  # per-request latency at this strategy
    fill_ema: Optional[float] = None
    batches: int = 0


@dataclasses.dataclass
class _StrategyState:
    """Observed-performance state for one (family, sel-bucket) routing key.

    ``preferred`` is None until enough evidence accumulates — the router
    then uses its own lattice default. Retuning only ever *selects among*
    strategies the router's lattice row allows (the router re-checks
    membership + applicability before honouring the preference), so the
    controller cannot route outside the declared lattice.
    """

    preferred: Optional[str] = None
    stats: Dict[str, _StrategyStats] = dataclasses.field(default_factory=dict)
    # best-first ordering, recomputed at record time so the router's
    # per-request hot path reads a cached tuple instead of sorting
    ranking: Tuple[str, ...] = ()


class AdaptiveController:
    def __init__(
        self,
        tiers: Tuple[SearchParams, ...],
        config: ControllerConfig = ControllerConfig(),
        slo: Optional[SLOConfig] = None,
    ):
        if not tiers:
            raise ValueError("need at least one SearchParams tier")
        k_cap = tiers[0].k
        if any(t.k != k_cap for t in tiers):
            raise ValueError("all tiers must share the same k cap")
        self.tiers = tuple(tiers)
        self.config = config
        self._families: Dict[str, _FamilyState] = {}
        self._strategies: Dict[tuple, _StrategyState] = {}
        # bumped on every record_strategy; the router's plan cache keys
        # decision validity on it so retuning invalidates cached plans
        self.generation = 0
        # Degradation ladder (DESIGN.md §10): None = no overload policy,
        # the runtime without any overload policy.
        self.ladder = DegradationLadder(slo) if slo is not None else None

    @property
    def max_tier(self) -> int:
        return len(self.tiers) - 1

    @property
    def k_cap(self) -> int:
        return self.tiers[0].k

    def params_for(self, tier: int) -> SearchParams:
        return self.tiers[tier]

    # --- overload policy (DESIGN.md §10) ----------------------------------
    @property
    def degradation_level(self) -> int:
        return 0 if self.ladder is None else self.ladder.level

    def observe_load(self, queue_depth: int) -> int:
        """One runtime-step load sample into the ladder (no-op without an
        SLO config); returns the current degradation level."""
        if self.ladder is None:
            return 0
        return self.ladder.observe_load(queue_depth)

    def observe_latency(self, latency: float) -> None:
        """One completed response's latency into the ladder's EMA."""
        if self.ladder is not None:
            self.ladder.observe_latency(latency)

    def observe_service(self, duration: float) -> None:
        """One dispatch's measured execution duration into the ladder's
        service-time EMA (the predictive-shedding estimate)."""
        if self.ladder is not None:
            self.ladder.observe_service(duration)

    def tier_for(self, family: str) -> int:
        """Default tier for a newly admitted request of this family. While
        the ladder is degraded, every admission starts at the base tier —
        the family default is an *up*-tuning the overload cannot afford."""
        if self.ladder is not None and self.ladder.force_base_tier:
            return 0
        return self._families.setdefault(family, _FamilyState()).default_tier

    def escalate(self, req: Request) -> Optional[int]:
        """Next tier for an under-filled request, or None when maxed out —
        or when the degradation ladder has capped retry-tier escalations
        (a retry re-runs the query at a multiple of the budget; under
        overload that multiple is exactly what must not be spent)."""
        if self.ladder is not None and self.ladder.cap_escalations:
            return None
        return req.tier + 1 if req.tier < self.max_tier else None

    def record(
        self, family: str, tier: int, fill_frac: float, mean_iters: float
    ) -> None:
        """Fold one completed microbatch's telemetry into the family policy.

        Only the family's current default tier trains the EMAs — escalated
        retries measure the retry tier, not where new requests should start.
        """
        st = self._families.setdefault(family, _FamilyState())
        if tier != st.default_tier:
            return
        a = self.config.ema_alpha
        st.fill_ema = (
            fill_frac
            if st.fill_ema is None
            else (1 - a) * st.fill_ema + a * fill_frac
        )
        st.iter_ema = (
            mean_iters
            if st.iter_ema is None
            else (1 - a) * st.iter_ema + a * mean_iters
        )
        st.batches_at_tier += 1
        if st.batches_at_tier < self.config.min_batches:
            return
        if st.fill_ema < self.config.promote_below and st.default_tier < self.max_tier:
            st.default_tier += 1
            st.fill_ema = st.iter_ema = None
            st.batches_at_tier = 0
        elif st.default_tier > 0 and st.fill_ema >= self.config.demote_above:
            lower_budget = self.tiers[st.default_tier - 1].max_iters
            if st.iter_ema <= self.config.demote_iter_headroom * lower_budget:
                st.default_tier -= 1
                st.fill_ema = st.iter_ema = None
                st.batches_at_tier = 0

    # --- hybrid strategy retuning (DESIGN.md §9) --------------------------
    def strategy_for(self, key: tuple, default: str) -> str:
        """Preferred executor strategy for a (family, sel-bucket) routing
        key, or the router's lattice ``default`` before evidence exists.
        The router re-validates the preference against its lattice row and
        applicability gates — this is a hint, never an override beyond the
        declared lattice."""
        st = self._strategies.get(key)
        if st is None or st.preferred is None:
            return default
        return st.preferred

    def strategy_ranking(self, key: tuple) -> tuple:
        """All observed strategies for the key, best-first: adequately
        filling ones (within 1% of the best fill EMA) by ascending latency,
        then under-filling ones by ascending latency. Empty before any
        strategy has ``min_batches`` observations. The router walks this
        ranking so that when the globally fastest strategy is outside the
        bucket's lattice row (or inapplicable), the *next-best observed*
        strategy still wins over the static lattice default. Cached at
        record time — this sits on the per-request routing hot path."""
        st = self._strategies.get(key)
        return () if st is None else st.ranking

    def record_strategy(
        self, key: tuple, strategy: str, latency: float, fill_frac: float
    ) -> None:
        """Fold one completed microbatch's per-request latency + fill into
        the (family, sel-bucket) strategy EMAs, and retune the preference:
        the lowest-latency strategy among those that fill essentially as
        well as the best observed (within 1%), once every candidate has
        ``min_batches`` observations."""
        st = self._strategies.setdefault(key, _StrategyState())
        self.generation += 1
        s = st.stats.setdefault(strategy, _StrategyStats())
        a = self.config.ema_alpha
        s.lat_ema = (
            latency if s.lat_ema is None else (1 - a) * s.lat_ema + a * latency
        )
        s.fill_ema = (
            fill_frac
            if s.fill_ema is None
            else (1 - a) * s.fill_ema + a * fill_frac
        )
        s.batches += 1
        ready = {
            name: stats
            for name, stats in st.stats.items()
            if stats.batches >= self.config.min_batches
        }
        if not ready:
            return
        best_fill = max(stats.fill_ema for stats in ready.values())
        adequate = sorted(
            (name for name, s in ready.items() if s.fill_ema >= best_fill - 0.01),
            key=lambda name: ready[name].lat_ema,
        )
        lagging = sorted(
            (name for name, s in ready.items() if s.fill_ema < best_fill - 0.01),
            key=lambda name: ready[name].lat_ema,
        )
        st.ranking = tuple(adequate) + tuple(lagging)
        st.preferred = st.ranking[0]

    def snapshot(self) -> dict:
        out: dict = {
            fam: {
                "default_tier": st.default_tier,
                "fill_ema": None if st.fill_ema is None else round(st.fill_ema, 4),
                "iter_ema": None if st.iter_ema is None else round(st.iter_ema, 1),
            }
            for fam, st in self._families.items()
        }
        if self._strategies:
            out["strategies"] = {
                f"{key[0]}@bucket{key[1]}": {
                    "preferred": st.preferred,
                    "observed": {
                        name: {
                            "lat_ema": (
                                None
                                if s.lat_ema is None
                                else round(s.lat_ema, 6)
                            ),
                            "fill_ema": (
                                None
                                if s.fill_ema is None
                                else round(s.fill_ema, 4)
                            ),
                            "batches": s.batches,
                        }
                        for name, s in st.stats.items()
                    },
                }
                for key, st in self._strategies.items()
            }
        if self.ladder is not None:
            out["slo"] = self.ladder.snapshot()
        return out
