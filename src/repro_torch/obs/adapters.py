"""Registry adapters over the serving runtime's existing state (port of
``repro.obs.adapters``, plain Python).

``instrument_runtime`` builds ONE ``MetricsRegistry`` whose families read
the live objects the runtime already maintains — telemetry counters, the
log-bucketed ``LatencyHistogram`` (exposed as a *native* Prometheus
histogram: its exact bucket edges as ``le`` labels, ``_sum``/``_count``
from the same fields ``summary()`` reports), per-stage trace histograms,
closure-cache hits/misses, batcher queue depth and per-group occupancy,
the degradation-ladder level and EMAs, streaming epoch/slot-pool gauges
(the slot pool's lifecycle state lives on the host, so a scrape reads no
device memory), and per-strategy router verdicts. Everything is pull-time
(``CallbackFamily``): the scrape reads the same counters the runtime
reports, so ``GET /metrics`` equals ``Telemetry.summary()`` by
construction, not by double bookkeeping.

``instrument_tier`` lifts the same surface over a ``ReplicaSet``
(DESIGN.md §13): every family keeps its single-runtime name but each
sample gains a ``replica="i"`` label, and the tier appends a rollup sample
per label set under ``replica="all"`` — the elementwise sum, so
per-replica histogram buckets stay cumulative and sum exactly to the
rollup. Sample callbacks take the tier's per-replica lock with a short
timeout so a scrape is consistent against a running pump but can never
deadlock behind a stuck replica; on timeout the family is read lock-free
(a torn-but-live scrape beats a hung one).

Duck-typed on purpose: this module imports nothing from
``repro_torch.serving`` (the serving layer imports obs, never the
reverse), so it works over any object shaped like a ``ServingRuntime`` /
``ReplicaSet``.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from repro_torch.obs.metrics import MetricsRegistry, Sample, format_value

Labels = Tuple[Tuple[str, str], ...]
FamilyFn = Callable[..., List[Sample]]


def latency_hist_samples(
    hist, labels: Tuple[Tuple[str, str], ...] = ()
) -> List[Sample]:
    """Native-histogram samples for a ``serving.telemetry.LatencyHistogram``.

    The log-spaced layout maps 1:1: the underflow bucket's upper edge is
    ``lo``, each log bucket keeps its exact ``upper_edge``, and the
    overflow bucket is ``+Inf`` — so cumulative counts, ``_sum`` and
    ``_count`` reproduce the in-process histogram bit-for-bit and the
    upper-edge quantile rule gives identical p99 answers on both sides."""
    out: List[Sample] = []
    cum = 0
    for b in range(hist.n_buckets + 2):
        cum += int(hist.counts[b])
        edge = hist.upper_edge(b) if b > 0 else hist.lo
        out.append(
            ("_bucket", labels + (("le", format_value(edge)),), float(cum))
        )
    out.append(("_sum", labels, float(hist.sum)))
    out.append(("_count", labels, float(hist.total)))
    return out


def runtime_families(
    runtime, namespace: str = "repro"
) -> List[Tuple[str, str, str, FamilyFn]]:
    """The full metric surface of one runtime as ``(name, type, help,
    fn)`` rows, where ``fn(labels)`` renders the family's samples with a
    label prefix. ``instrument_runtime`` registers them with the empty
    prefix (the single-runtime exposition); ``instrument_tier`` registers
    the same rows once and fans each ``fn`` out per replica."""
    ns = namespace
    tel = runtime.telemetry
    fams: List[Tuple[str, str, str, FamilyFn]] = []

    def counter_samples(labels: Labels = ()) -> List[Sample]:
        return [
            ("", labels + (("event", key),), float(tel.counters[key]))
            for key in sorted(tel.counters)
        ]

    fams.append((
        f"{ns}_serving_events_total", "counter",
        "Lifecycle event counters (Telemetry.counters): submitted, "
        "completed, goodput, shed_*, fault_*, routed_*, epoch_swaps, ...",
        counter_samples,
    ))

    def verdict_samples(labels: Labels = ()) -> List[Sample]:
        return [
            (
                "",
                labels + (("strategy", key[len("routed_"):]),),
                float(tel.counters[key]),
            )
            for key in sorted(tel.counters)
            if key.startswith("routed_")
        ]

    fams.append((
        f"{ns}_serving_route_verdicts_total", "counter",
        "Hybrid strategy-router admission verdicts by executor strategy",
        verdict_samples,
    ))

    fams.append((
        f"{ns}_serving_latency_seconds", "histogram",
        "Arrival-to-completion latency of served responses "
        "(log-bucketed; lifetime of the process)",
        lambda labels=(): latency_hist_samples(tel.latency_hist, labels),
    ))

    def stage_samples(labels: Labels = ()) -> List[Sample]:
        out: List[Sample] = []
        for stage in sorted(tel.stage_hists):
            out.extend(
                latency_hist_samples(
                    tel.stage_hists[stage], labels + (("stage", stage),)
                )
            )
        return out

    fams.append((
        f"{ns}_serving_stage_seconds", "histogram",
        "Per-request lifecycle stage durations from the span recorder "
        "(queue_wait | batch_wait | execute | overhead)",
        stage_samples,
    ))

    cache = runtime.cache
    fams.append((
        f"{ns}_serving_compile_cache_hits_total", "counter",
        "Compile-cache lookups served by an already-traced closure",
        lambda labels=(): [("", labels, float(cache.hits))],
    ))
    fams.append((
        f"{ns}_serving_compile_cache_misses_total", "counter",
        "Compile-cache lookups that traced a new closure",
        lambda labels=(): [("", labels, float(cache.misses))],
    ))
    fams.append((
        f"{ns}_serving_compile_cache_traces", "gauge",
        "Compiled closures resident (hard-bounded by the trace budget)",
        lambda labels=(): [("", labels, float(cache.trace_count))],
    ))
    fams.append((
        f"{ns}_serving_trace_budget", "gauge",
        "Declared compile budget: |ladder| x |families| x |tiers|",
        lambda labels=(): [("", labels, float(runtime.trace_budget))],
    ))

    batcher = runtime.batcher
    fams.append((
        f"{ns}_serving_queue_depth", "gauge",
        "Requests waiting in the dynamic batcher (all groups)",
        lambda labels=(): [("", labels, float(batcher.pending_count()))],
    ))

    def occupancy_samples(labels: Labels = ()) -> List[Sample]:
        out: List[Sample] = []
        for (group, tier), n in sorted(
            batcher.occupancy().items(), key=lambda kv: (str(kv[0][0]), kv[0][1])
        ):
            out.append((
                "",
                labels + (
                    ("family", str(group[0])),
                    ("tier", str(tier)),
                    ("group", repr(group)),
                ),
                float(n),
            ))
        return out

    fams.append((
        f"{ns}_serving_group_pending", "gauge",
        "Batcher bucket occupancy per (compatibility group, tier)",
        occupancy_samples,
    ))

    fams.append((
        f"{ns}_serving_in_flight", "gauge",
        "Admitted requests not yet completed/shed (backpressure quantity)",
        lambda labels=(): [("", labels, float(runtime.in_flight))],
    ))

    fams.append((
        f"{ns}_serving_busy_seconds_total", "counter",
        "Dispatch CPU seconds consumed by this runtime — one charge per "
        "microbatch (queries and mutations) on the dispatching thread's "
        "CPU clock: the replica's true busy time on its own core, not "
        "per-request wall batch charges",
        lambda labels=(): [("", labels, float(runtime.busy_seconds))],
    ))

    controller = runtime.controller
    fams.append((
        f"{ns}_serving_degradation_level", "gauge",
        "SLO degradation-ladder level (0 normal .. 3 shedding; 0 when "
        "no ladder is configured)",
        lambda labels=(): [("", labels, float(controller.degradation_level))],
    ))

    def ladder_ema_samples(labels: Labels = ()) -> List[Sample]:
        ladder = controller.ladder
        if ladder is None:
            return []
        out: List[Sample] = []
        for name, v in (
            ("queue", ladder.queue_ema),
            ("latency", ladder.lat_ema),
            ("service", ladder.service_ema),
        ):
            if v is not None and not math.isnan(v):
                out.append(("", labels + (("signal", name),), float(v)))
        return out

    fams.append((
        f"{ns}_serving_slo_ema", "gauge",
        "Degradation-ladder EMAs: queue depth, completion latency (s), "
        "execution-only service time (s)",
        ladder_ema_samples,
    ))

    if hasattr(runtime.executor, "apply_mutations"):  # streaming executor
        index = runtime.executor.index
        executor = runtime.executor
        fams.append((
            f"{ns}_streaming_epoch", "gauge",
            "Published index epoch (queries in one flush share it)",
            lambda labels=(): [("", labels, float(executor.epoch))],
        ))

        def slot_samples(labels: Labels = ()) -> List[Sample]:
            stats = index.pool.stats()
            return [
                ("", labels + (("state", state),), float(stats[state]))
                for state in ("live", "pending", "free")
            ]

        fams.append((
            f"{ns}_streaming_slots", "gauge",
            "Slot-pool occupancy by state (live + pending + free = capacity)",
            slot_samples,
        ))
        fams.append((
            f"{ns}_streaming_capacity", "gauge",
            "Slot-pool capacity (fixed at build time)",
            lambda labels=(): [("", labels, float(index.capacity))],
        ))
        fams.append((
            f"{ns}_streaming_consolidations_total", "counter",
            "Tombstone consolidation passes run",
            lambda labels=(): [("", labels, float(index.consolidations))],
        ))
    return fams


def instrument_runtime(
    runtime,
    registry: Optional[MetricsRegistry] = None,
    namespace: str = "repro",
) -> MetricsRegistry:
    """Register the full serving metric surface for one runtime."""
    reg = registry if registry is not None else MetricsRegistry()
    for name, mtype, help_text, fn in runtime_families(runtime, namespace):
        reg.callback(name, mtype, help_text, fn)
    return reg


def rollup_samples(samples: Iterable[Sample]) -> List[Sample]:
    """Tier rollups: per (suffix, labels-minus-replica) group, the sum of
    all replicas' values re-emitted under ``replica="all"``. Summing works
    for every family here — counters and gauges add, and cumulative
    histogram buckets summed per ``le`` stay cumulative (all replicas
    share identical ``LatencyHistogram`` edges)."""
    groups: "OrderedDict[Tuple[str, Labels], float]" = OrderedDict()
    for suffix, labels, value in samples:
        rest = tuple(kv for kv in labels if kv[0] != "replica")
        key = (suffix, rest)
        groups[key] = groups.get(key, 0.0) + float(value)
    return [
        (suffix, (("replica", "all"),) + rest, value)
        for (suffix, rest), value in groups.items()
    ]


def instrument_tier(
    tier,
    registry: Optional[MetricsRegistry] = None,
    namespace: str = "repro",
    lock_timeout: float = 0.25,
) -> MetricsRegistry:
    """Register the metric surface of a ``ReplicaSet``: same family names
    as ``instrument_runtime``, each sample labeled ``replica="i"``, plus a
    ``replica="all"`` rollup per label set, plus tier-level families."""
    reg = registry if registry is not None else MetricsRegistry()
    per_replica: List[Tuple[int, object, Dict[str, FamilyFn]]] = []
    meta: "OrderedDict[str, Tuple[str, str]]" = OrderedDict()
    for i, rt in enumerate(tier.replicas):
        fns: Dict[str, FamilyFn] = {}
        for name, mtype, help_text, fn in runtime_families(rt, namespace):
            fns[name] = fn
            meta.setdefault(name, (mtype, help_text))
        per_replica.append((i, tier.locks[i], fns))

    def make_family(name: str) -> Callable[[], List[Sample]]:
        def family_samples() -> List[Sample]:
            out: List[Sample] = []
            for i, lock, fns in per_replica:
                fn = fns.get(name)
                if fn is None:
                    continue
                prefix: Labels = (("replica", str(i)),)
                got = lock.acquire(timeout=lock_timeout)
                try:
                    out.extend(fn(prefix))
                except RuntimeError:
                    # Lock-free fallback raced a mutating pump (e.g. the
                    # batcher dict grew mid-iteration) — skip this
                    # replica's family for this scrape rather than hang.
                    pass
                finally:
                    if got:
                        lock.release()
            out.extend(rollup_samples(out))
            return out

        return family_samples

    for name, (mtype, help_text) in meta.items():
        reg.callback(name, mtype, help_text, make_family(name))

    ns = namespace
    reg.callback(
        f"{ns}_tier_replicas", "gauge",
        "Shared-nothing runtime replicas behind this front-end",
        lambda: [("", (), float(tier.n_replicas))],
    )
    reg.callback(
        f"{ns}_tier_submitted_total", "counter",
        "Requests (queries + broadcast mutations) accepted by the tier "
        "router",
        lambda: [("", (), float(tier.submitted))],
    )
    reg.callback(
        f"{ns}_tier_router_info", "gauge",
        "Active replica-router policy (value is always 1)",
        lambda: [("", (("router", tier.router.name),), 1.0)],
    )
    return reg
