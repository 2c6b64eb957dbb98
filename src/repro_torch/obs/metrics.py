"""Metrics primitives + Prometheus text exposition (DESIGN.md §12; port of
``repro.obs.metrics``, plain Python, kept as its own copy).

One ``MetricsRegistry`` per server: ``Counter`` / ``Gauge`` / ``Histogram``
families with label sets, plus ``CallbackFamily`` for pull-time adapters
over state the serving runtime already maintains (telemetry counters, the
log-bucketed latency histogram, batcher occupancy, slot-pool gauges —
obs/adapters.py). ``render_prometheus()`` emits the text exposition format
(HELP/TYPE lines, cumulative ``le`` buckets with a ``+Inf`` edge,
``_sum``/``_count``) that ``GET /metrics`` serves and
``obs/promparse.py`` round-trips in tests. The same operations render the
same text as the reference, byte for byte.

Values render via ``format_value``: integral values as integers and
everything else as ``repr(float)`` — the shortest string that parses back
to the identical float, so a scrape is *bit-identical* to the in-process
counters it came from.

This module is dependency-free on purpose (no torch, no
repro_torch.serving imports): the serving layer imports obs, never the
reverse.
"""
from __future__ import annotations

import math
import re
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

METRIC_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")
LABEL_NAME_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*\Z")

# One exposition sample: (name suffix, ((label, value), ...), value).
# Suffix is "" for scalar samples, "_bucket"/"_sum"/"_count" for histograms.
Sample = Tuple[str, Tuple[Tuple[str, str], ...], float]


def format_value(v: float) -> str:
    """Exposition-format a sample value, round-trippably.

    Integral values print as integers (a counter scraped at 17 parses back
    to exactly 17); non-integral floats print via ``repr`` (guaranteed to
    parse back to the identical IEEE double since py3.1)."""
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if math.isnan(f):
        return "NaN"
    if f.is_integer() and abs(f) < 2**53:
        return str(int(f))
    return repr(f)


def escape_label_value(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def escape_help(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n")


def _check_name(name: str) -> str:
    if not METRIC_NAME_RE.match(name):
        raise ValueError(f"invalid metric name: {name!r}")
    return name


def _check_labels(names: Sequence[str]) -> Tuple[str, ...]:
    out = tuple(names)
    for n in out:
        if not LABEL_NAME_RE.match(n) or n.startswith("__"):
            raise ValueError(f"invalid label name: {n!r}")
    if len(set(out)) != len(out):
        raise ValueError(f"duplicate label names: {out}")
    return out


class MetricFamily:
    """Base: one named family, children keyed by label-value tuples."""

    mtype = "untyped"

    def __init__(self, name: str, help: str, label_names: Sequence[str] = ()):
        self.name = _check_name(name)
        self.help = str(help)
        self.label_names = _check_labels(label_names)
        self._children: Dict[Tuple[str, ...], object] = {}

    def _child_factory(self):
        raise NotImplementedError

    def labels(self, **kw) -> object:
        if set(kw) != set(self.label_names):
            raise ValueError(
                f"{self.name}: labels {sorted(kw)} != declared "
                f"{sorted(self.label_names)}"
            )
        key = tuple(str(kw[n]) for n in self.label_names)
        child = self._children.get(key)
        if child is None:
            child = self._child_factory()
            self._children[key] = child
        return child

    def _default_child(self):
        """The label-less singleton child (families declared without
        labels operate through it directly)."""
        if self.label_names:
            raise ValueError(f"{self.name} declares labels; use .labels()")
        return self.labels()

    def _label_pairs(self, key: Tuple[str, ...]) -> Tuple[Tuple[str, str], ...]:
        return tuple(zip(self.label_names, key))

    def samples(self) -> Iterable[Sample]:
        raise NotImplementedError


class _CounterChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up (inc by {amount})")
        self.value += float(amount)


class Counter(MetricFamily):
    mtype = "counter"
    _child_factory = _CounterChild

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    @property
    def value(self) -> float:
        return self._default_child().value

    def samples(self) -> Iterable[Sample]:
        for key, child in self._children.items():
            yield ("", self._label_pairs(key), child.value)


class _GaugeChild:
    __slots__ = ("value", "fn")

    def __init__(self):
        self.value = 0.0
        self.fn: Optional[Callable[[], float]] = None

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, amount: float = 1.0) -> None:
        self.value += float(amount)

    def dec(self, amount: float = 1.0) -> None:
        self.value -= float(amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        """Pull-time gauge: ``fn`` is evaluated at every collection."""
        self.fn = fn

    def current(self) -> float:
        return float(self.fn()) if self.fn is not None else self.value


class Gauge(MetricFamily):
    mtype = "gauge"
    _child_factory = _GaugeChild

    def set(self, v: float) -> None:
        self._default_child().set(v)

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default_child().dec(amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._default_child().set_function(fn)

    @property
    def value(self) -> float:
        return self._default_child().current()

    def samples(self) -> Iterable[Sample]:
        for key, child in self._children.items():
            yield ("", self._label_pairs(key), child.current())


class _HistogramChild:
    __slots__ = ("counts", "sum", "count", "edges")

    def __init__(self, edges: Tuple[float, ...]):
        self.edges = edges  # upper edges, ascending, last is +inf
        self.counts = [0] * len(edges)
        self.sum = 0.0
        self.count = 0

    def observe(self, x: float) -> None:
        x = float(x)
        self.sum += x
        self.count += 1
        # linear scan is fine: exposition histograms here have <= ~100
        # buckets and observe() is not on the per-candidate hot path.
        for i, edge in enumerate(self.edges):
            if x <= edge:
                self.counts[i] += 1
                return


DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class Histogram(MetricFamily):
    mtype = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        label_names: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ):
        super().__init__(name, help, label_names)
        edges = tuple(float(b) for b in buckets)
        if list(edges) != sorted(set(edges)):
            raise ValueError(f"bucket edges must be sorted unique: {edges}")
        if not edges or edges[-1] != float("inf"):
            edges = edges + (float("inf"),)
        self._edges = edges

    def _child_factory(self):
        return _HistogramChild(self._edges)

    def observe(self, x: float) -> None:
        self._default_child().observe(x)

    def samples(self) -> Iterable[Sample]:
        for key, child in self._children.items():
            pairs = self._label_pairs(key)
            cum = 0
            for edge, c in zip(child.edges, child.counts):
                cum += c
                yield (
                    "_bucket",
                    pairs + (("le", format_value(edge)),),
                    float(cum),
                )
            yield ("_sum", pairs, child.sum)
            yield ("_count", pairs, float(child.count))


class CallbackFamily(MetricFamily):
    """Pull-time family over external state: ``fn()`` returns the full
    sample list at collection time. This is how the adapters expose the
    runtime's existing counters/histograms without double-bookkeeping —
    the scrape reads the same objects the controller and benches read, so
    the exposition cannot drift from ``Telemetry.summary()``."""

    def __init__(
        self,
        name: str,
        mtype: str,
        help: str,
        fn: Callable[[], Iterable[Sample]],
    ):
        super().__init__(name, help, ())
        if mtype not in ("counter", "gauge", "histogram", "untyped"):
            raise ValueError(f"unknown metric type {mtype!r}")
        self.mtype = mtype
        self._fn = fn

    def samples(self) -> Iterable[Sample]:
        return self._fn()


class MetricsRegistry:
    """One registry per server: families registered once by unique name,
    collected in name order, rendered as the Prometheus text format."""

    def __init__(self):
        self._families: Dict[str, MetricFamily] = {}

    def register(self, family: MetricFamily) -> MetricFamily:
        if family.name in self._families:
            raise ValueError(f"metric {family.name!r} already registered")
        self._families[family.name] = family
        return family

    # --- convenience constructors ----------------------------------------
    def counter(self, name: str, help: str, labels: Sequence[str] = ()) -> Counter:
        return self.register(Counter(name, help, labels))  # type: ignore[return-value]

    def gauge(self, name: str, help: str, labels: Sequence[str] = ()) -> Gauge:
        return self.register(Gauge(name, help, labels))  # type: ignore[return-value]

    def histogram(
        self,
        name: str,
        help: str,
        labels: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self.register(Histogram(name, help, labels, buckets))  # type: ignore[return-value]

    def callback(
        self, name: str, mtype: str, help: str, fn: Callable[[], Iterable[Sample]]
    ) -> CallbackFamily:
        return self.register(CallbackFamily(name, mtype, help, fn))  # type: ignore[return-value]

    # --- collection -------------------------------------------------------
    def collect(self) -> List[MetricFamily]:
        return [self._families[n] for n in sorted(self._families)]

    def render_prometheus(self) -> str:
        """The ``GET /metrics`` payload: HELP/TYPE lines then samples, one
        family after another in name order."""
        lines: List[str] = []
        for fam in self.collect():
            lines.append(f"# HELP {fam.name} {escape_help(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.mtype}")
            for suffix, labels, value in fam.samples():
                name = fam.name + suffix
                if labels:
                    body = ",".join(
                        f'{k}="{escape_label_value(str(v))}"' for k, v in labels
                    )
                    lines.append(f"{name}{{{body}}} {format_value(value)}")
                else:
                    lines.append(f"{name} {format_value(value)}")
        return "\n".join(lines) + "\n"
