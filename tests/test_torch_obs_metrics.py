"""The metrics registry, Prometheus exposition and runtime adapters, port
against reference.

The same operations on both packages' registries render the same text,
byte for byte; both parsers read it back the same and reject the same
malformed payloads; the latency histogram's native samples are equal bit
for bit to the reference's over the same records. Over a drained stream
on the integer world of ``test_torch_serving_runtime`` (the reference's
runtime beside the port's), the two expositions carry the same families,
help, types and label sets, and equal values wherever the value does not
read a clock; the port's scrape equals its own ``Telemetry`` exactly at
pull time; a tier's rollups are the sums of its replicas. Tolerance: none.
"""
import math
import re

import numpy as np
import pytest

import repro.obs as ref_obs
import repro_torch.obs as port_obs
from repro.serving import LatencyHistogram as RefLatencyHistogram
from repro_torch.obs import (
    ExpositionParseError,
    MetricsRegistry,
    format_value,
    instrument_runtime,
    instrument_tier,
    latency_hist_samples,
    parse_exposition,
    rollup_samples,
)
from repro_torch.serving import (
    LatencyHistogram,
    ReplicaSet,
    StreamingLocalExecutor,
    label_words_row,
    mixed_workload,
)
from repro_torch.streaming import StreamingIndex
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse)
from test_torch_serving_runtime import K_CHOICES, L, TIER_KW, served, world

# Families whose values read a clock (wall-measured execution, CPU time,
# EMAs of latencies): equal names, labels and help, not equal values.
CLOCKED = ("latency_seconds", "stage_seconds", "busy_seconds", "slo_ema")


def _operate(obs):
    """One sequence of registry operations, on either package's ``obs``."""
    reg = obs.MetricsRegistry()
    c = reg.counter("ops_total", "Operations by kind\nand \\ path", labels=("kind",))
    c.labels(kind="a").inc()
    c.labels(kind='q"uote\\back\nline').inc(2.5)
    c.labels(kind="big").inc(2.0**60)
    g = reg.gauge("depth", "Queue depth")
    g.set(7)
    g.dec(0.25)
    pulled = reg.gauge("pulled", "pull-time", labels=("shard",))
    pulled.labels(shard="0").set_function(lambda: 1 / 3)
    pulled.labels(shard="1").set(float("nan"))
    h = reg.histogram("lat_seconds", "latency", labels=("stage",), buckets=(0.001, 0.1, 1.0))
    for x in (0.0005, 0.05, 0.05, 0.7, 3.0, float("inf")):
        h.labels(stage="exec").observe(x)
    h.labels(stage="idle")
    reg.callback("cb", "gauge", "callback family", lambda: [
        ("", (("x", "1"),), -float("inf")), ("", (("x", "2"),), 1e-300)])
    return reg.render_prometheus()


def test_same_operations_render_the_same_text():
    text = _operate(port_obs)
    assert text == _operate(ref_obs)
    assert text.endswith("\n") and 'kind="q\\"uote\\\\back\\nline"' in text
    for v in (0.0, 17.0, -3.0, 0.1, 1e-6, 2.0**53, 2.0**60, 1 / 3, math.inf, -math.inf,
              math.nan):
        assert format_value(v) == ref_obs.format_value(v)


def test_parse_round_trips_like_the_reference():
    text = _operate(port_obs)
    got, want = parse_exposition(text), ref_obs.parse_exposition(text)
    assert sorted(got) == sorted(want)
    for name, fam in got.items():
        other = want[name]
        assert (fam.mtype, fam.help) == (other.mtype, other.help)
        assert [(s.name, s.labels) for s in fam.samples] == [
            (s.name, s.labels) for s in other.samples]
        for s, t in zip(fam.samples, other.samples):
            assert s.value == t.value or (math.isnan(s.value) and math.isnan(t.value))
    assert got["ops_total"].value(kind='q"uote\\back\nline') == 2.5
    assert got["ops_total"].value(kind="big") == 2.0**60
    assert got["ops_total"].help == "Operations by kind\nand \\ path"
    assert got["lat_seconds"].buckets(stage="exec") == [
        (0.001, 1.0), (0.1, 3.0), (1.0, 4.0), (math.inf, 6.0)]
    assert got["lat_seconds"].hist_count(stage="idle") == 0


MALFORMED = (
    "x_total{oops} 1\n",
    "x_total one\n",
    '# TYPE h histogram\nh_bucket{le="1"} 2\nh_bucket{le="+Inf"} 1\nh_sum 1\nh_count 1\n',
    '# TYPE h histogram\nh_bucket{le="1"} 1\nh_sum 1\nh_count 1\n',
    "# HELP a one\n# HELP a two\na 1\n",
    "a 1\n# TYPE a counter\n",
)


def test_parser_rejects_malformed_payloads():
    for payload in MALFORMED:
        with pytest.raises(ExpositionParseError):
            parse_exposition(payload)
        with pytest.raises(ref_obs.ExpositionParseError):
            ref_obs.parse_exposition(payload)


def test_registry_validation():
    reg = MetricsRegistry()
    reg.counter("a_total", "a")
    with pytest.raises(ValueError, match="already registered"):
        reg.counter("a_total", "again")
    with pytest.raises(ValueError, match="invalid metric name"):
        reg.gauge("1bad", "x")
    with pytest.raises(ValueError, match="invalid label name"):
        reg.gauge("g", "x", labels=("__reserved",))
    c = reg.counter("c_total", "c", labels=("k",))
    with pytest.raises(ValueError, match="labels"):
        c.labels(other="x")
    with pytest.raises(ValueError, match="only go up"):
        c.labels(k="x").inc(-1)
    with pytest.raises(ValueError, match="sorted unique"):
        reg.histogram("h", "h", buckets=(1.0, 0.5))
    with pytest.raises(ValueError, match="unknown metric type"):
        reg.callback("cb", "summary", "x", list)


def test_latency_hist_samples_bit_identical():
    """The native-histogram view of the port's LatencyHistogram equals the
    reference's over the same records, and reproduces the histogram:
    cumulative counts, _sum, _count and the quantile rule."""
    hist, ref_hist = LatencyHistogram(), RefLatencyHistogram()
    rng = np.random.default_rng(3)
    xs = [float(x) for x in np.exp(rng.uniform(math.log(1e-5), math.log(50.0), 500))]
    for x in xs + [0.0, 100.0]:
        hist.record(x)
        ref_hist.record(x)
    labels = (("stage", "execute"),)
    assert latency_hist_samples(hist, labels) == ref_obs.latency_hist_samples(ref_hist, labels)
    reg = MetricsRegistry()
    reg.callback("lh_seconds", "histogram", "h", lambda: latency_hist_samples(hist))
    fam = parse_exposition(reg.render_prometheus())["lh_seconds"]
    assert fam.hist_count() == hist.total and fam.hist_sum() == hist.sum
    assert fam.buckets()[-1] == (math.inf, hist.total)
    for p in (1, 50, 90, 99, 100):
        assert fam.quantile(p) == hist.quantile(p), p


def _families(text):
    """{family: [(sample name, labels, value)]} of an exposition."""
    out, help_type = {}, {}
    for line in text.splitlines():
        if line.startswith("#"):
            _, kind, name, rest = line.split(" ", 3)
            help_type[(kind, name)] = rest
            continue
        m = re.match(r"([^{ ]+)(\{.*\})? (\S+)$", line)
        out.setdefault(m.group(1), []).append((m.group(2), m.group(3)))
    return out, help_type


def test_runtime_exposition_matches_the_reference():
    """A drained stream on both packages: the same families, help, types
    and samples; equal values except where a family reads a clock."""
    ref, _, port, _, _ = served("mixed")
    got, got_meta = _families(instrument_runtime(port).render_prometheus())
    want, want_meta = _families(ref_obs.instrument_runtime(ref).render_prometheus())
    assert got_meta == want_meta
    assert sorted(got) == sorted(want)
    compared = 0
    for name, samples in got.items():
        assert [s for s, _ in samples] == [s for s, _ in want[name]], name
        if not any(c in name for c in CLOCKED):
            assert samples == want[name], name
            compared += 1
    assert compared >= 8


def test_scrape_matches_telemetry_exactly_at_pull_time():
    _, _, port, _, _ = served("mixed")
    reg = instrument_runtime(port)
    fams = parse_exposition(reg.render_prometheus())
    tel = port.telemetry
    events = fams["repro_serving_events_total"]
    for key, v in tel.counters.items():
        assert events.value(event=key) == v, key
    lat = fams["repro_serving_latency_seconds"]
    assert lat.hist_count() == tel.latency_hist.total
    assert lat.hist_sum() == tel.latency_hist.sum
    for p in (50, 99):
        assert lat.quantile(p) == tel.latency_hist.quantile(p)
    stages = fams["repro_serving_stage_seconds"]
    for stage, hist in tel.stage_hists.items():
        assert stages.hist_count(stage=stage) == hist.total
        assert stages.hist_sum(stage=stage) == hist.sum
    assert fams["repro_serving_compile_cache_hits_total"].value() == port.cache.hits
    assert fams["repro_serving_trace_budget"].value() == port.trace_budget
    assert fams["repro_serving_busy_seconds_total"].value() == port.busy_seconds
    assert fams["repro_serving_in_flight"].value() == 0
    # pull time: a new request moves the next render, no cache in between
    (_, _), (corpus, _) = world()
    port.submit(corpus.vectors[0].numpy(), 2, "label", label_words_row([3], L))
    depth = parse_exposition(reg.render_prometheus())["repro_serving_queue_depth"].value()
    port.drain()
    after = parse_exposition(reg.render_prometheus())
    assert depth == 1 and after["repro_serving_queue_depth"].value() == 0
    assert after["repro_serving_events_total"].value(event="completed") == (
        events.value(event="completed") + 1)


def test_tier_rollups_are_the_sums_of_the_replicas():
    from repro_torch.serving import ServingRuntime, VirtualClock, make_tier_ladder

    (_, _), (corpus, graph) = world()
    replicas = [
        ServingRuntime(StreamingLocalExecutor(StreamingIndex.from_static(
            corpus, graph, ef_insert=16, device="cpu")), n_labels=L,
            tiers=make_tier_ladder(**TIER_KW), ladder=(4, 8), clock=VirtualClock())
        for _ in range(2)]
    tier = ReplicaSet(replicas)
    for it in mixed_workload(7, corpus, 12, L, k_choices=K_CHOICES, jitter=0.0):
        tier.submit(it.query, it.k, it.family, it.operand)
    tier.submit_upsert(corpus.vectors[5].numpy() + 1, label=2)
    tier.drain()
    fams = parse_exposition(instrument_tier(tier).render_prometheus())
    events = fams["repro_serving_events_total"]
    assert set(events.label_values("replica")) == {"0", "1", "all"}
    for key in set(events.label_values("event")):
        assert events.value(event=key, replica="all") == sum(
            events.value(event=key, replica=str(i)) for i in (0, 1))
    lat = fams["repro_serving_latency_seconds"]
    per = [dict(lat.buckets(replica=str(i))) for i in (0, 1)]
    for edge, cum in lat.buckets(replica="all"):
        assert cum == per[0][edge] + per[1][edge]
    slots = fams["repro_streaming_slots"]
    for i, rt in enumerate(replicas):
        stats = rt.executor.index.pool.stats()
        for state in ("live", "pending", "free"):
            assert slots.value(state=state, replica=str(i)) == stats[state]
    assert fams["repro_streaming_epoch"].value(replica="0") == fams[
        "repro_streaming_epoch"].value(replica="1") == replicas[0].executor.epoch
    assert fams["repro_tier_replicas"].value() == 2
    assert fams["repro_tier_submitted_total"].value() == tier.submitted == 13
    assert fams["repro_tier_router_info"].value(router="hash") == 1
    rows = [("", (("replica", "0"), ("e", "a")), 1.0), ("", (("replica", "1"), ("e", "a")), 2.0)]
    assert rollup_samples(rows) == ref_obs.rollup_samples(rows) == [
        ("", (("replica", "all"), ("e", "a")), 3.0)]
