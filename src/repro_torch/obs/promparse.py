"""Minimal Prometheus text-format parser — the round-trip verifier (port of
``repro.obs.promparse``, plain Python).

Parses what ``MetricsRegistry.render_prometheus()`` (or any conformant
exporter) emits and *validates* it while doing so: metric-name charset,
HELP/TYPE placement (at most one each, before any sample of the family),
histogram structure (cumulative non-decreasing ``le`` buckets, a ``+Inf``
edge whose count equals ``_count``, a ``_sum`` sample). The exposition
tests and the card's smoke feed scraped ``/metrics`` text through this and
then assert the parsed values are bit-identical to the in-process
``Telemetry`` state.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Optional, Tuple

METRIC_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<value>\S+)"
    r"(?:\s+(?P<ts>-?\d+))?$"
)
_LABEL_RE = re.compile(r'\s*([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"\s*(,|$)')
_HIST_SUFFIXES = ("_bucket", "_sum", "_count")


class ExpositionParseError(ValueError):
    pass


def _parse_value(tok: str) -> float:
    if tok == "+Inf":
        return float("inf")
    if tok == "-Inf":
        return float("-inf")
    if tok == "NaN":
        return float("nan")
    try:
        return float(tok)
    except ValueError as e:
        raise ExpositionParseError(f"bad sample value {tok!r}") from e


def _unescape(v: str) -> str:
    return v.replace(r"\n", "\n").replace(r"\"", '"').replace(r"\\", "\\")


def _parse_labels(body: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    pos = 0
    while pos < len(body):
        m = _LABEL_RE.match(body, pos)
        if m is None:
            raise ExpositionParseError(f"bad label body {body!r} at {pos}")
        name, value = m.group(1), _unescape(m.group(2))
        if name in out:
            raise ExpositionParseError(f"duplicate label {name!r} in {body!r}")
        out[name] = value
        pos = m.end()
    return out


@dataclasses.dataclass
class ParsedSample:
    name: str  # full sample name (incl. _bucket/_sum/_count suffix)
    labels: Dict[str, str]
    value: float


@dataclasses.dataclass
class ParsedFamily:
    name: str
    mtype: str = "untyped"
    help: Optional[str] = None
    samples: List[ParsedSample] = dataclasses.field(default_factory=list)

    def _match(self, labels: Dict[str, str], sample: ParsedSample) -> bool:
        return all(sample.labels.get(k) == str(v) for k, v in labels.items())

    def value(self, **labels) -> float:
        hits = [
            s for s in self.samples
            if s.name == self.name and self._match(labels, s)
        ]
        if len(hits) != 1:
            raise KeyError(
                f"{self.name}{labels}: {len(hits)} matching samples"
            )
        return hits[0].value

    def label_values(self, label: str) -> List[str]:
        return [s.labels[label] for s in self.samples if label in s.labels]

    # --- histogram views --------------------------------------------------
    def buckets(self, **labels) -> List[Tuple[float, float]]:
        """(upper edge, cumulative count) pairs, ascending by edge."""
        if self.mtype != "histogram":
            raise TypeError(f"{self.name} is {self.mtype}, not histogram")
        out = []
        for s in self.samples:
            if s.name != self.name + "_bucket":
                continue
            rest = {k: v for k, v in s.labels.items() if k != "le"}
            if not self._match(labels, ParsedSample(s.name, rest, s.value)):
                continue
            out.append((_parse_value(s.labels["le"]), s.value))
        return sorted(out, key=lambda p: p[0])

    def hist_count(self, **labels) -> float:
        return self._suffixed("_count", labels)

    def hist_sum(self, **labels) -> float:
        return self._suffixed("_sum", labels)

    def _suffixed(self, suffix: str, labels: Dict[str, str]) -> float:
        hits = [
            s for s in self.samples
            if s.name == self.name + suffix and self._match(labels, s)
        ]
        if len(hits) != 1:
            raise KeyError(f"{self.name}{suffix}{labels}: {len(hits)} samples")
        return hits[0].value

    def quantile(self, p: float, **labels) -> float:
        """Upper-edge quantile over the cumulative buckets — the same
        conservative rule ``LatencyHistogram.quantile`` uses, so the two
        must agree exactly on the same data."""
        buckets = self.buckets(**labels)
        total = self.hist_count(**labels)
        if total == 0:
            return float("nan")
        rank = math.ceil(total * (p / 100.0))
        rank = min(max(rank, 1), total)
        for edge, cum in buckets:
            if cum >= rank:
                return edge
        return float("inf")


def _base_name(sample_name: str, families: Dict[str, ParsedFamily]) -> str:
    for suffix in _HIST_SUFFIXES:
        if sample_name.endswith(suffix):
            base = sample_name[: -len(suffix)]
            fam = families.get(base)
            if fam is not None and fam.mtype == "histogram":
                return base
    return sample_name


def parse_exposition(text: str) -> Dict[str, ParsedFamily]:
    """Parse + validate one exposition payload into families by name."""
    families: Dict[str, ParsedFamily] = {}
    seen_samples_of: set = set()

    def family(name: str) -> ParsedFamily:
        fam = families.get(name)
        if fam is None:
            fam = families[name] = ParsedFamily(name=name)
        return fam

    for lineno, raw in enumerate(text.split("\n"), start=1):
        line = raw.rstrip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                continue  # plain comment
            kind, name = parts[1], parts[2]
            if not METRIC_NAME_RE.match(name):
                raise ExpositionParseError(
                    f"line {lineno}: bad metric name {name!r} in {kind}"
                )
            fam = family(name)
            if name in seen_samples_of:
                raise ExpositionParseError(
                    f"line {lineno}: {kind} for {name} after its samples"
                )
            if kind == "HELP":
                if fam.help is not None:
                    raise ExpositionParseError(
                        f"line {lineno}: duplicate HELP for {name}"
                    )
                fam.help = _unescape(parts[3]) if len(parts) > 3 else ""
            else:
                if fam.mtype != "untyped":
                    raise ExpositionParseError(
                        f"line {lineno}: duplicate TYPE for {name}"
                    )
                if len(parts) < 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"
                ):
                    raise ExpositionParseError(
                        f"line {lineno}: bad TYPE line {line!r}"
                    )
                fam.mtype = parts[3]
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ExpositionParseError(f"line {lineno}: unparseable {line!r}")
        name = m.group("name")
        if not METRIC_NAME_RE.match(name):
            raise ExpositionParseError(f"line {lineno}: bad name {name!r}")
        labels = _parse_labels(m.group("labels")) if m.group("labels") else {}
        base = _base_name(name, families)
        fam = family(base)
        seen_samples_of.add(base)
        fam.samples.append(
            ParsedSample(name=name, labels=labels, value=_parse_value(m.group("value")))
        )

    for fam in families.values():
        if fam.mtype == "histogram":
            _validate_histogram(fam)
    return families


def _validate_histogram(fam: ParsedFamily) -> None:
    """Cumulative non-decreasing buckets, a +Inf edge equal to _count, and
    a _sum sample — per label set."""
    keys = set()
    for s in fam.samples:
        keys.add(tuple(sorted(
            (k, v) for k, v in s.labels.items() if k != "le"
        )))
    for key in keys:
        labels = dict(key)
        buckets = fam.buckets(**labels)
        if not buckets:
            raise ExpositionParseError(f"{fam.name}{labels}: no buckets")
        if not math.isinf(buckets[-1][0]):
            raise ExpositionParseError(f"{fam.name}{labels}: no +Inf bucket")
        counts = [c for _, c in buckets]
        if any(lo > hi for lo, hi in zip(counts, counts[1:])):
            raise ExpositionParseError(
                f"{fam.name}{labels}: buckets not cumulative: {counts}"
            )
        count = fam.hist_count(**labels)
        if counts[-1] != count:
            raise ExpositionParseError(
                f"{fam.name}{labels}: +Inf bucket {counts[-1]} != _count {count}"
            )
        fam.hist_sum(**labels)  # raises if missing
