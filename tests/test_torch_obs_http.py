"""The HTTP front end, port against reference: a real ThreadingHTTPServer on
a loopback socket (127.0.0.1, port 0; every request has a timeout) over
virtual-clock runtimes whose pump threads supply the passage of time.

A port front end and a reference front end serve the same integer world
(``test_torch_serving_runtime``'s: integer rows, every distance exact in
float32) through streaming executors over the same index state (carried
across with ``interop.streaming_index_from_reference``). Sequential label
and range requests, one in flight at a time, then an upsert and a delete,
must give equal payloads on ids, dists (JSON carries ``float(d)`` of a
float32, which round-trips exactly: compared with ==), filled, tier and
epoch, and equal slots. Then, on the port alone: 400s and 404, the 429
under backpressure, ``/metrics`` against each replica's telemetry,
``/healthz`` and ``/metrics`` while a replica's lock is held, ``/varz``, a
graceful close of a 2-replica tier with zero loss, and the launcher's
``--serve-http 0 --replicas 2`` in a subprocess, driven by requests and
stopped by SIGTERM.
"""
import json
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro.obs.http import ServingFrontend as RefFrontend
from repro.serving import ServingRuntime as RefRuntime
from repro.serving import StreamingLocalExecutor as RefStreamingExecutor
from repro.serving import VirtualClock as RefClock
from repro.serving import make_tier_ladder as ref_tier_ladder
from repro.streaming import StreamingIndex as RefStreamingIndex
from repro_torch.interop import streaming_index_from_reference
from repro_torch.obs import JsonLogger, ServingFrontend, parse_exposition, trace_consistent
from repro_torch.serving import (
    LocalExecutor,
    ReplicaSet,
    ServingRuntime,
    StreamingLocalExecutor,
    VirtualClock,
    make_tier_ladder,
    mixed_workload,
)
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse)
from test_torch_serving_runtime import D, K_CHOICES, L, TIER_KW, world

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 30
PAYLOAD_FIELDS = ("ids", "dists", "filled", "tier", "epoch", "k", "escalations", "strategy")


def _post(addr, path, payload, timeout=TIMEOUT):
    req = urllib.request.Request(addr + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(addr, path, timeout=TIMEOUT):
    with urllib.request.urlopen(addr + path, timeout=timeout) as r:
        body = r.read().decode()
        return r.status, body, dict(r.headers)


def _streaming_pair():
    """A reference streaming executor over the integer world and the port's
    over the same state."""
    (ref_corpus, ref_graph), _ = world()
    ref = RefStreamingIndex.from_static(ref_corpus, ref_graph, ef_insert=16)
    rp = ref.pool
    port = streaming_index_from_reference(
        vectors=rp.vectors, labels=rp.labels, attrs=rp.attrs, tombstones=rp.tombstones,
        neighbors=ref.neighbors, sample_ids=ref.sample_ids, entry_point=ref.entry_point,
        free=rp.free, pending=rp.pending, n_live=rp.n_live, epoch=ref.epoch,
        ef_insert=ref.ef_insert, consolidations=ref.consolidations,
        rng_state=ref.rng.get_state(), dirty=ref._dirty, device="cpu")
    return RefStreamingExecutor(ref), StreamingLocalExecutor(port)


def _port_runtime(executor=None, **kw):
    if executor is None:
        _, (corpus, graph) = world()
        executor = LocalExecutor(corpus, graph)
    kw.setdefault("max_pending", 256)
    return ServingRuntime(executor, n_labels=L, tiers=make_tier_ladder(**TIER_KW), ladder=(4, 8),
                          max_wait=0.002, clock=VirtualClock(), **kw)


def _items(n):
    _, (corpus, _) = world()
    return mixed_workload(7, corpus, n, L, k_choices=K_CHOICES, jitter=0.0)


def _request(it):
    body = {"query": it.query.tolist(), "k": it.k, "family": it.family}
    if it.family == "label":
        words = np.asarray(it.operand, np.uint32)
        body["labels"] = [lab for lab in range(L) if words[lab // 32] >> (lab % 32) & 1]
    else:
        body["range"] = [float(it.operand[0]), float(it.operand[1]), int(it.operand[2])]
    return body


def test_sequential_payloads_equal_the_reference():
    ref_ex, port_ex = _streaming_pair()
    ref_rt = RefRuntime(ref_ex, n_labels=L, tiers=ref_tier_ladder(**TIER_KW), ladder=(4, 8),
                        max_wait=0.002, clock=RefClock())
    fronts = [RefFrontend(ref_rt), ServingFrontend(_port_runtime(port_ex))]
    addrs = [fe.start() for fe in fronts]
    try:
        items = _items(24)
        assert {it.family for it in items} == {"label", "range"}
        bit31 = 0
        for it in items:
            body = _request(it)
            bit31 += 31 in body.get("labels", ())
            (s0, want), (s1, got) = (_post(a, "/v1/search", body) for a in addrs)
            assert s0 == s1 == 200
            for field in PAYLOAD_FIELDS:
                assert got[field] == want[field], field
            assert got["replica"] is None and trace_consistent(got["trace"])
        assert bit31 > 0  # label 31: bit 31 of the first word
        vec = (items[0].query + 1).tolist()
        (s0, want), (s1, got) = (_post(a, "/v1/upsert", {"vector": vec, "label": 31})
                                 for a in addrs)
        assert s0 == s1 == 200 and got["ok"] and got == want
        (s0, want), (s1, got) = (_post(a, "/v1/delete", {"slot": got["slot"]}) for a in addrs)
        assert s0 == s1 == 200 and got["ok"] and got == want
        body = {"query": vec, "k": 4, "family": "label", "labels": [31]}
        (_, want), (_, got) = (_post(a, "/v1/search", body) for a in addrs)
        for field in PAYLOAD_FIELDS:
            assert got[field] == want[field], field
        assert got["epoch"] == want["epoch"] > 0
    finally:
        for fe in fronts:
            fe.close(drain=True)


def test_bad_requests_are_400_and_unknown_routes_404():
    fe = ServingFrontend(_port_runtime())
    addr = fe.start()
    try:
        q = [0.0] * D
        for payload in ({"query": q, "k": 4, "family": "nope"},
                        {"k": 4, "family": "label", "labels": [0]},
                        {"query": q, "k": 4, "family": "label"},
                        {"query": q, "k": 999, "family": "label", "labels": [0]},
                        {"query": q, "k": 4, "family": "range", "range": [0, 1]}):
            status, body = _post(addr, "/v1/search", payload)
            assert status == 400 and "bad request" in body["error"]
        req = urllib.request.Request(addr + "/v1/search", data=b"[1, 2",
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=TIMEOUT)
        assert e.value.code == 400
        # mutations need a streaming executor
        status, body = _post(addr, "/v1/upsert", {"vector": q})
        assert status == 400 and "streaming" in body["error"]
        assert _post(addr, "/nope", {})[0] == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(addr, "/nope")
        assert e.value.code == 404
    finally:
        fe.close(drain=True)


def test_backpressure_maps_to_429():
    fe = ServingFrontend(_port_runtime(max_pending=0))
    addr = fe.start()
    try:
        status, body = _post(addr, "/v1/search", {"query": [0.0] * D, "k": 4,
                                                  "family": "label", "labels": [0]})
        assert status == 429 and "max_pending" in body["error"]
        assert fe.runtime.telemetry.counters["rejected"] == 1
    finally:
        fe.close(drain=False)


def _tier(n=2, streaming=False):
    if streaming:
        return ReplicaSet([_port_runtime(_streaming_pair()[1]) for _ in range(n)])
    return ReplicaSet([_port_runtime() for _ in range(n)])


def test_metrics_match_each_replicas_telemetry():
    tier = _tier(streaming=True)
    logger = JsonLogger()
    fe = ServingFrontend(tier, logger=logger)
    addr = fe.start()
    try:
        seen = set()
        for it in _items(12):
            status, body = _post(addr, "/v1/search", _request(it))
            assert status == 200 and body["trace"]["replica"] == body["replica"]
            seen.add(body["replica"])
        assert seen == {0, 1}
        status, text, headers = _get(addr, "/metrics")
        assert status == 200 and headers["Content-Type"].startswith("text/plain; version=0.0.4")
        fams = parse_exposition(text)
        events = fams["repro_serving_events_total"]
        for i, rt in enumerate(tier.replicas):
            with tier.locks[i]:
                for key, v in rt.telemetry.counters.items():
                    assert events.value(event=key, replica=str(i)) == v, (i, key)
                assert fams["repro_serving_latency_seconds"].hist_count(
                    replica=str(i)) == rt.telemetry.latency_hist.total
        assert fams["repro_tier_replicas"].value() == 2
        assert fams["repro_streaming_epoch"].value(replica="0") == fams[
            "repro_streaming_epoch"].value(replica="1")
        status, text, _ = _get(addr, "/varz")
        varz = json.loads(text)
        assert varz["n_replicas"] == 2 and varz["router"] == "hash"
        assert varz["started_requests"] == 12 and len(set(varz["epochs"])) == 1
    finally:
        fe.close(drain=True)
    records = logger.sink.records()
    assert {r.get("replica") for r in records if "replica" in r} >= {0, 1}
    assert {"http_start", "http_shutdown"} <= {r["event"] for r in records}


def test_healthz_and_metrics_responsive_while_replica_locked():
    tier = _tier()
    fe = ServingFrontend(tier)
    addr = fe.start()
    release = threading.Event()

    def hog():
        with tier.locks[1]:
            release.wait(10.0)

    t = threading.Thread(target=hog, daemon=True)
    try:
        t.start()
        time.sleep(0.05)
        t0 = time.monotonic()
        status, text, _ = _get(addr, "/healthz")
        health = json.loads(text)
        assert status == 200 and health["status"] == "ok"
        assert [r["locked"] for r in health["replicas"]] == [False, True]
        status, text, _ = _get(addr, "/metrics")
        assert status == 200
        parse_exposition(text)
        assert time.monotonic() - t0 < 5.0  # not the 10 s the lock is held
    finally:
        release.set()
        t.join()
        fe.close(drain=True)


def test_graceful_close_loses_no_request():
    tier = _tier(streaming=True)
    fe = ServingFrontend(tier)
    addr = fe.start()
    statuses = []
    items = _items(16)
    vectors = [it.query.tolist() for it in items]

    def one(i):
        statuses.append(_post(addr, "/v1/search", {
            "query": vectors[i], "k": 4, "family": "range", "range": [0.1, 0.9, 0]})[0])

    threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    report = fe.close(drain=True)
    assert statuses == [200] * 8
    assert report["in_flight"] == 0 and report["replicas"] == 2
    for rt in tier.replicas:
        c = rt.telemetry.counters
        assert c["submitted"] == c["completed"] + c["shed_total"]
    assert sum(report["completed_per_replica"]) == 8
    assert not any(t.is_alive() for t in fe._threads if t.name.startswith("obs-http-pump"))
    status, _ = fe.handle_search({"query": vectors[0], "k": 4, "family": "label",
                                  "labels": [0]})
    assert status == 503


def test_launcher_serves_http_with_replicas_until_sigterm(tmp_path):
    log = tmp_path / "serve.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--n", "2000",
         "--serve-http", "0", "--replicas", "2", "--router", "least-loaded", "--log-json",
         str(log)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)
    try:
        addr = None
        deadline = time.monotonic() + 180
        lines = []
        while addr is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            assert line, proc.stderr.read()
            lines.append(line)
            if "serving on " in line:
                addr = line.split("serving on ")[1].strip()
        assert addr is not None, lines
        for i in range(4):
            status, body = _post(addr, "/v1/search", {
                "query": [0.1 * i] * 32, "k": 4, "family": "label", "labels": [i]})
            assert status == 200 and body["replica"] in (0, 1) and body["filled"] == 4
        status, text, _ = _get(addr, "/metrics")
        assert parse_exposition(text)["repro_tier_router_info"].value(
            router="least-loaded") == 1
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    report = json.loads(out[out.index("{"):])["shutdown"]
    assert report["in_flight"] == 0 and report["replicas"] == 2
    assert sum(report["completed_per_replica"]) == 4
    assert report["log_records_flushed"] == len(log.read_text().splitlines()) > 0
