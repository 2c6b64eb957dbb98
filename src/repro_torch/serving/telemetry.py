"""Per-request and aggregate serving metrics (port of
``repro.serving.telemetry``, plain Python and numpy).

Everything the acceptance criteria and the adaptive controller read comes
through here: arrival-to-completion latency percentiles, fill rate split by
final tier (the escalation tier's worst-case fill is the "never return
padding" check), QPS over the completed window, dispatch/padding overhead,
and admission-rejection counts. Closure-cache hit rates live on the cache
itself (cache.py); ``ServingRuntime.report`` merges both.

The fault-tolerance ledger (DESIGN.md §10): every terminal
outcome is a counter — ``shed_expired`` / ``shed_overload`` (dropped at
flush time), ``degraded`` (served under the ladder), ``failed`` (executor
fault exhausted its retries), ``faults_injected`` + per-kind splits,
client ``retries`` and executor ``fault_retries``, and ``goodput`` (served
in-deadline with at least one filled slot — the number the SLO harness
optimizes). Latencies additionally land in a bucketed log-scale histogram
so p99 is readable from telemetry directly instead of recomputed from the
bounded response window.
"""
from __future__ import annotations

import math
from collections import Counter, deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.types import Response


def percentile(xs: Sequence[float], p: float) -> float:
    """np.percentile with an empty-input nan guard, p in [0, 100]."""
    if not xs:
        return float("nan")
    return float(np.percentile(np.asarray(xs, dtype=np.float64), p))


class LatencyHistogram:
    """Fixed log-spaced latency buckets: O(1) record, bounded memory, and
    quantiles that never look at individual samples — so a long-lived
    server's p99 covers its whole lifetime, not just the response window.

    Quantiles report the *upper edge* of the bucket holding the target
    rank (the conservative, Prometheus-style answer: the true quantile is
    at most this). Resolution is the bucket ratio (~12% per step at the
    default 96 buckets across 1µs..60s) — plenty against a 2x SLO bound.
    """

    def __init__(self, lo: float = 1e-6, hi: float = 60.0, n_buckets: int = 96):
        self.lo = float(lo)
        self.hi = float(hi)
        self.n_buckets = int(n_buckets)
        self._log_lo = math.log(self.lo)
        self._log_ratio = (math.log(self.hi) - self._log_lo) / self.n_buckets
        # + 2: underflow bucket [0, lo) and overflow bucket [hi, inf)
        self.counts = np.zeros((self.n_buckets + 2,), np.int64)
        self.total = 0
        self.sum = 0.0

    def _bucket_of(self, x: float) -> int:
        if x < self.lo:
            return 0
        if x >= self.hi:
            return self.n_buckets + 1
        # Clamp against float rounding at the edges: log() of a value one
        # ulp under ``hi`` can land exactly on n_buckets (indexing into
        # the overflow bucket for an in-range value), and log() of ``lo``
        # itself can come out one ulp below _log_lo (indexing bucket 0).
        b = 1 + int((math.log(x) - self._log_lo) / self._log_ratio)
        return min(max(b, 1), self.n_buckets)

    def upper_edge(self, bucket: int) -> float:
        if bucket <= 0:
            return self.lo
        if bucket > self.n_buckets:
            return float("inf")
        return math.exp(self._log_lo + bucket * self._log_ratio)

    def record(self, latency: float) -> None:
        self.counts[self._bucket_of(float(latency))] += 1
        self.total += 1
        self.sum += float(latency)

    def quantile(self, p: float) -> float:
        """Upper bucket edge at percentile ``p`` in [0, 100]; nan when
        empty."""
        if self.total == 0:
            return float("nan")
        rank = math.ceil(self.total * (p / 100.0))
        rank = min(max(rank, 1), self.total)
        cum = 0
        for b, c in enumerate(self.counts):
            cum += int(c)
            if cum >= rank:
                return self.upper_edge(b)
        return float("inf")  # unreachable

    def summary(self) -> dict:
        return {
            "count": int(self.total),
            "mean": round(self.sum / self.total, 6) if self.total else None,
            "p50": round(self.quantile(50), 6) if self.total else None,
            "p99": round(self.quantile(99), 6) if self.total else None,
            "overflow": int(self.counts[-1]),
        }


class Telemetry:
    """Counters are unbounded aggregates; per-response records are kept in
    a bounded window (``max_history`` newest) so a long-lived server's
    memory stays flat — ``summary()`` percentiles describe that window
    (the latency histogram covers the full lifetime)."""

    def __init__(self, max_history: int = 65_536) -> None:
        self.responses: Deque[Response] = deque(maxlen=max_history)
        self.counters: Counter = Counter()
        self.latency_hist = LatencyHistogram()
        # Per-stage latency histograms fed from Response.trace breakdowns
        # (queue_wait | batch_wait | execute | overhead) when the runtime
        # runs with tracing on — where a p99 outlier spent its time.
        self.stage_hists: Dict[str, LatencyHistogram] = {}

    # --- event hooks (runtime calls these) --------------------------------
    def on_submit(self) -> None:
        self.counters["submitted"] += 1

    def on_reject(self) -> None:
        self.counters["rejected"] += 1

    def on_dispatch(self, bucket: int, n_real: int) -> None:
        self.counters["batches"] += 1
        self.counters["dispatched_slots"] += bucket
        self.counters["dispatched_real"] += n_real
        self.counters["padded_slots"] += bucket - n_real

    def on_escalate(self) -> None:
        self.counters["escalations"] += 1

    def on_route(self, strategy: str) -> None:
        """Hybrid router verdicts: per-strategy admission counts."""
        self.counters[f"routed_{strategy}"] += 1

    def on_mutation(self, family: str, n: int) -> None:
        """Streaming mutations are counted, not mixed into the query
        latency/fill percentiles (they complete on the host, not through
        the compiled search path)."""
        self.counters[f"{family}s_applied"] += n

    def on_epoch_swap(self) -> None:
        self.counters["epoch_swaps"] += 1

    def on_shed(self, resp: Response) -> None:
        """A request dropped at flush time (``shed_reason`` "expired" |
        "overload"). Shed responses are pollable and counted, but stay out
        of the latency/fill window — a shed costs microseconds and would
        flatter every percentile it joined."""
        self.counters[f"shed_{resp.shed_reason}"] += 1
        self.counters["shed_total"] += 1
        if resp.deadline_missed:
            self.counters["deadline_missed"] += 1

    def on_fault(self, kind: str) -> None:
        """One injected (or real) executor fault observed by the runtime."""
        self.counters["faults_injected"] += 1
        self.counters[f"fault_{kind}"] += 1

    def on_fault_retry(self) -> None:
        """A faulted request re-queued within its executor-retry budget."""
        self.counters["fault_retries"] += 1

    def on_complete(self, resp: Response) -> None:
        self.counters["completed"] += 1
        if resp.deadline_missed:
            self.counters["deadline_missed"] += 1
        if resp.degraded:
            self.counters["degraded"] += 1
        if resp.error is not None:
            self.counters["failed"] += 1
        else:
            self.latency_hist.record(resp.latency)
            # Fill accounting as plain counters so "equal fill" is
            # measurable from a /metrics scrape alone (the replica-tier
            # bench reads filled_slots / requested_slots, never telemetry).
            self.counters["filled_slots"] += int(resp.filled)
            self.counters["requested_slots"] += int(resp.k)
            if resp.trace is not None:
                for stage in ("queue_wait", "batch_wait", "execute", "overhead"):
                    hist = self.stage_hists.get(stage)
                    if hist is None:
                        hist = self.stage_hists[stage] = LatencyHistogram()
                    hist.record(float(resp.trace[stage]))
        if self._is_goodput(resp):
            # Goodput: answers that arrived in time with something in
            # them — the quantity overload policy is allowed to optimize
            # (a fast shed and a late fill both score zero).
            self.counters["goodput"] += 1
        self.responses.append(resp)

    # --- aggregates -------------------------------------------------------
    @staticmethod
    def _is_goodput(resp: Response) -> bool:
        return resp.ok and not resp.deadline_missed and resp.filled > 0

    def goodput_in_window(self) -> int:
        """Goodput responses still inside the bounded response window."""
        return sum(1 for r in self.responses if self._is_goodput(r))

    def goodput_rate(self, window_s: Optional[float] = None) -> float:
        """Goodput per second of served time (completion-window span).

        Both numerator and denominator are WINDOW-scoped: the lifetime
        ``goodput`` counter over the bounded window's span would inflate
        the rate as soon as ``max_history`` evicts old responses (the
        counter keeps every served request forever; the span only covers
        the newest ``max_history``)."""
        if window_s is None:
            rs = self.responses
            if not rs:
                return 0.0
            window_s = max(r.complete_t for r in rs) - min(
                r.arrival_t for r in rs
            )
        return self.goodput_in_window() / window_s if window_s > 0 else 0.0

    def summary(self) -> dict:
        rs = self.responses
        out: Dict[str, object] = dict(self.counters)
        out["latency_hist"] = self.latency_hist.summary()
        if self.stage_hists:
            out["stages"] = {
                stage: hist.summary()
                for stage, hist in sorted(self.stage_hists.items())
            }
        if not rs:
            return out
        lat = [r.latency for r in rs]
        fills = [r.fill_frac for r in rs]
        makespan = max(r.complete_t for r in rs) - min(r.arrival_t for r in rs)
        out.update(
            qps=round(len(rs) / makespan, 1) if makespan > 0 else float("inf"),
            goodput_qps=(
                round(self.goodput_rate(makespan), 1)
                if makespan > 0
                else float("inf")
            ),
            latency_p50=round(percentile(lat, 50), 6),
            latency_p99=round(percentile(lat, 99), 6),
            mean_fill_frac=round(sum(fills) / len(fills), 4),
            # worst-case fill at 99% coverage: 99% of requests fill at least
            # this fraction of their k
            p99_fill_frac=round(percentile(fills, 1), 4),
            underfilled=sum(1 for r in rs if r.filled < r.k),
        )
        # Fill split by final tier: the escalation tiers must not return
        # padding (the online analogue of the paper's under-fill fix).
        by_tier: Dict[int, List[Response]] = {}
        for r in rs:
            by_tier.setdefault(r.tier, []).append(r)
        out["tiers"] = {
            str(tier): {
                "n": len(group),
                "mean_fill_frac": round(
                    sum(g.fill_frac for g in group) / len(group), 4
                ),
                "p99_fill_frac": round(
                    percentile([g.fill_frac for g in group], 1), 4
                ),
            }
            for tier, group in sorted(by_tier.items())
        }
        # Fill/latency split by executor strategy (hybrid routing): the
        # crossover evidence the adaptive controller retunes on.
        by_strategy: Dict[str, List[Response]] = {}
        for r in rs:
            by_strategy.setdefault(r.strategy, []).append(r)
        out["strategies"] = {
            strat: {
                "n": len(group),
                "latency_p50": round(
                    percentile([g.latency for g in group], 50), 6
                ),
                "mean_fill_frac": round(
                    sum(g.fill_frac for g in group) / len(group), 4
                ),
            }
            for strat, group in sorted(by_strategy.items())
        }
        return out

