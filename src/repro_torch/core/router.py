"""Per-query strategy router: selectivity-adaptive hybrid execution (port
of ``repro.core.router``, host-side Python).

AIRSHIP's in-graph filtering wins mid-selectivity; a posting-set scan wins
when almost nothing satisfies; a label-subgraph overlay wins between them
for hot labels. The router picks per request, from a *cheap* host-side
selectivity estimate (core/estimator.py: incremental histograms, sampled
fallback) — never the O(n) scan. Decisions are constrained to a declared
strategy lattice per selectivity bucket, and the serving layer's
``AdaptiveController`` may retune *within* the lattice from observed
fill/latency EMAs (serving/controller.py); an inapplicable choice always
falls back to the universally-applicable graph walk.

Strategy lattice (DESIGN.md §9): bucket -> preference-ordered candidates.

    sel < 0.1%   : posting > overlay > graph   (scan a handful of ids)
    0.1% – 1%    : posting > overlay > graph   (scan still beats any walk)
    1% – 5%      : overlay > posting > graph   (sets too big to scan; a
                                                hot label's sub-graph walk
                                                touches only satisfiers)
    5% – 20%     : graph > overlay             (full walk finds satisfiers
                                                fast enough; overlay only
                                                if the label is hot)
    >= 20%       : graph                       (AIRSHIP's home regime)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.estimator import SelectivityEstimator

GRAPH, POSTING, OVERLAY = "graph", "posting", "overlay"
STRATEGIES = (GRAPH, POSTING, OVERLAY)


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Bucket edges + lattice + applicability gates."""

    # selectivity bucket upper edges; bucket i covers [edges[i-1], edges[i])
    bucket_edges: Tuple[float, ...] = (0.001, 0.01, 0.05, 0.2)
    # preference-ordered strategy candidates per bucket (len(edges)+1 rows)
    lattice: Tuple[Tuple[str, ...], ...] = (
        (POSTING, OVERLAY, GRAPH),
        (POSTING, OVERLAY, GRAPH),
        (OVERLAY, POSTING, GRAPH),
        (GRAPH, OVERLAY),
        (GRAPH,),
    )
    # posting scan applicability: set size cap (None -> max(256, n // 32))
    posting_cap: Optional[int] = None
    # overlay applicability: label must have been routed this many times
    # within the current epoch before paying the sub-index build
    overlay_hot_after: int = 2
    # smallest posting set an overlay build accepts (graph needs >= 2 rows)
    overlay_min_postings: int = 2

    def resolved_posting_cap(self, n: int) -> int:
        if self.posting_cap is not None:
            return int(self.posting_cap)
        return max(256, n // 32)


@dataclasses.dataclass(frozen=True)
class RouteDecision:
    """One request's routing verdict (rides Response telemetry)."""

    strategy: str
    est_selectivity: Optional[float]
    bucket: int
    source: str  # "histogram" | "sampled" | "default"
    label: Optional[int] = None  # single-label operand, when detected


def single_label_of_words(words) -> Optional[int]:
    """The label id if the bitmask operand allows exactly one label."""
    words = np.asarray(words, np.uint32).reshape(-1)
    found = None
    for w, word in enumerate(words):
        word = int(word)
        while word:
            bit = (word & -word).bit_length() - 1
            if found is not None:
                return None  # second bit -> multi-label
            found = w * 32 + bit
            word &= word - 1
    return found


class StrategyRouter:
    """Host-side per-request dispatcher over {graph, posting, overlay}.

    ``postings`` / ``range_index`` (core/posting.py) gate applicability:
    posting needs a materializable set under the cap; overlay needs a
    single hot label with enough postings. ``controller`` (optional,
    serving/controller.py) may override the lattice default *within* the
    bucket's lattice row. With no estimate at all (UDF and no sampled
    fallback armed) every request routes to graph — the universal plan.
    """

    def __init__(
        self,
        estimator: SelectivityEstimator,
        n: int,
        config: Optional[RouterConfig] = None,
        postings=None,
        range_index=None,
        controller=None,
    ):
        self.estimator = estimator
        self.n = int(n)
        self.config = config or RouterConfig()
        self.postings = postings
        self.range_index = range_index
        self.controller = controller
        self._cap = self.config.resolved_posting_cap(self.n)
        self._hot: Dict[int, int] = {}  # label -> routes seen this epoch
        self._hot_epoch = -1
        # plan cache: operand key -> (validity, hot_at_compute, decision).
        # Steady-state traffic repeats operands; recomputing the estimate,
        # the gates and the ranking walk every request costs ~10us where a
        # cached decision costs ~2us — a visible fraction of a sub-100us
        # posting scan. Invalidated by epoch moves and controller retunes
        # (validity tag) and by a label's cold->hot transition (recheck).
        self._plans: Dict[tuple, tuple] = {}

    # --- epoch plumbing ---------------------------------------------------
    def on_epoch(self, epoch: int) -> None:
        """Reset hotness counters when the index epoch moves (the overlay
        cache invalidates itself; hotness re-accumulates per epoch)."""
        if epoch != self._hot_epoch:
            self._hot.clear()
            self._plans.clear()
            self._hot_epoch = epoch

    # --- bucketing --------------------------------------------------------
    def bucket_of(self, est: float) -> int:
        for i, edge in enumerate(self.config.bucket_edges):
            if est < edge:
                return i
        return len(self.config.bucket_edges)

    # --- applicability gates ----------------------------------------------
    def _posting_count(self, family: str, operand) -> Optional[int]:
        if family == "label" and self.postings is not None:
            return self.postings.count_words(operand)
        if family == "range" and self.range_index is not None:
            lo, hi, col = operand
            return self.range_index.count_range(float(lo), float(hi), int(col))
        return None

    def _applicable(
        self,
        strategy: str,
        family: str,
        operand,
        label: Optional[int],
        count: Optional[int] = None,
    ) -> bool:
        if strategy == GRAPH:
            return True
        if strategy == POSTING:
            if count is None:
                count = self._posting_count(family, operand)
            return count is not None and count <= self._cap
        if strategy == OVERLAY:
            if label is None or self.postings is None:
                return False
            count = self.postings.count_label(label)
            if count < self.config.overlay_min_postings:
                return False
            return self._hot.get(label, 0) >= self.config.overlay_hot_after
        return False

    # --- the decision -----------------------------------------------------
    def _validity(self) -> tuple:
        gen = (
            getattr(self.controller, "generation", None)
            if self.controller is not None
            else None
        )
        return (self._hot_epoch, gen)

    def _is_hot(self, label: Optional[int]) -> bool:
        if label is None:
            return False
        return self._hot.get(label, 0) >= self.config.overlay_hot_after

    def route(self, family: str, operand, prefer_cheap: bool = False) -> RouteDecision:
        """Route one request. ``prefer_cheap`` is the serving layer's
        overload override (DESIGN.md §10): the degradation ladder asks for
        the host-side posting/overlay executors ahead of the compiled
        graph walk wherever their applicability gates pass — the lattice's
        quality ordering yields to keeping the burst off the batcher."""
        label = (
            single_label_of_words(operand) if family == "label" else None
        )
        if label is not None:
            self._hot[label] = self._hot.get(label, 0) + 1
        if family == "label":
            plan_key = (family, prefer_cheap, np.asarray(operand, np.uint32).tobytes())
        elif family == "range":
            plan_key = (family, prefer_cheap, tuple(operand))
        else:
            plan_key = None
        validity = self._validity()
        if plan_key is not None:
            hit = self._plans.get(plan_key)
            # hotness accrues per route (bumped above); a cold->hot
            # transition changes overlay applicability, so a cached plan
            # is only reused while the label's hot phase is unchanged
            if (
                hit is not None
                and hit[0] == validity
                and hit[1] == self._is_hot(label)
            ):
                return hit[2]
        decision = self._route_uncached(family, operand, label, prefer_cheap)
        if plan_key is not None:
            if len(self._plans) >= 4096:  # distinct range operands can grow
                self._plans.clear()
            self._plans[plan_key] = (
                validity, self._is_hot(label), decision
            )
        return decision

    def _route_uncached(
        self,
        family: str,
        operand,
        label: Optional[int],
        prefer_cheap: bool = False,
    ) -> RouteDecision:
        est, source = self.estimator.estimate_operand(family, operand)

        if est is None:
            return RouteDecision(GRAPH, None, -1, "default", label)

        bucket = self.bucket_of(est)
        row = self.config.lattice[bucket]
        if prefer_cheap:
            # Overload override: cheapest-executor-first, applicability
            # gates (posting-set cap, overlay hotness) still apply — a
            # huge posting set is NOT cheap and still walks the graph.
            # Observed-performance retuning is skipped: its EMAs rank
            # normal-load latency, not burst survival.
            row = (POSTING, OVERLAY, GRAPH)
            count = self._posting_count(family, operand)
            for cand in row:
                if self._applicable(cand, family, operand, label, count):
                    return RouteDecision(cand, float(est), bucket, source, label)
            return RouteDecision(GRAPH, float(est), bucket, source, label)
        # one posting-count lookup feeds every gate check below
        count = (
            self._posting_count(family, operand)
            if POSTING in row
            else None
        )
        default = GRAPH
        for cand in row:
            if self._applicable(cand, family, operand, label, count):
                default = cand
                break
        chosen = default
        if self.controller is not None:
            key = (family, bucket)
            ranker = getattr(self.controller, "strategy_ranking", None)
            ranking = ranker(key) if ranker is not None else ()
            if not ranking:
                ranking = (self.controller.strategy_for(key, default),)
            # Best *admissible* observed strategy: the first ranked entry
            # inside this bucket's lattice row that passes its gate. When
            # the globally fastest strategy is outside the row, the next
            # one still beats the static lattice default.
            for pref in ranking:
                if pref in row and self._applicable(
                    pref, family, operand, label, count
                ):
                    chosen = pref
                    break
        return RouteDecision(chosen, float(est), bucket, source, label)

    def route_constraint(self, constraint, corpus=None) -> RouteDecision:
        """Route from a full constraint object (bench / UDF path): uses the
        shared estimator's histogram-or-sampled estimate; batch estimates
        collapse to their mean (a micro-batch shares one strategy)."""
        try:
            est_arr, source = self.estimator.estimate_constraint(
                constraint, corpus
            )
        except ValueError:
            return RouteDecision(GRAPH, None, -1, "default", None)
        est = float(np.mean(est_arr))
        bucket = self.bucket_of(est)
        row = self.config.lattice[bucket]
        for cand in row:
            if cand == GRAPH:
                return RouteDecision(GRAPH, est, bucket, source, None)
            # constraint-object routing has no operand gates: posting /
            # overlay need the serving layer's posting structures
        return RouteDecision(GRAPH, est, bucket, source, None)
