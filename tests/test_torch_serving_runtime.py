"""The serving runtime, port against reference: one mixed stream (numpy
draws, so both sides get the same requests) drained under a virtual clock
with no deadlines, through the reference's ``ServingRuntime`` over
``repro`` and the port's over ``interop.from_reference_arrays``.

The world is integer-valued and the stream has no jitter, so every distance
is exact in float32 and each response must be equal bit for bit: ids,
dists, filled, tier, escalations, strategy and fill history, with equal
telemetry counters and trace counts. 40 labels (two label words; label 31
sets bit 31 of the first) on 400 rows leave ~10 rows a label, so a
starved tier 0 under-fills and escalates. The hybrid router's posting
routes are held bit for bit; its overlay routes to the live postings of
their label, ascending distances and the reference's fill (the overlay's
start sample is drawn by torch, not JAX, so its walk may differ; at these
posting sizes every overlay walk reaches its whole label).
"""
import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.types import Corpus as RefCorpus
from repro.graph.index import build_index as ref_build_index
from repro.serving import FaultConfig as RefFaultConfig
from repro.serving import FaultSchedule as RefFaultSchedule
from repro.serving import FaultyExecutor as RefFaultyExecutor
from repro.serving import LocalExecutor as RefLocalExecutor
from repro.serving import ServingRuntime as RefRuntime
from repro.serving import VirtualClock as RefClock
from repro.serving import make_serving_router as ref_make_router
from repro.serving import make_tier_ladder as ref_tier_ladder
from repro.serving import mixed_workload as ref_mixed_workload
from repro_torch.interop import from_reference_arrays
from repro_torch.obs import JsonLogger, trace_consistent
from repro_torch.serving import (
    FaultConfig,
    FaultSchedule,
    FaultyExecutor,
    LocalExecutor,
    ServingRuntime,
    VirtualClock,
    assemble_constraint,
    assemble_queries,
    label_words_row,
    make_serving_router,
    make_tier_ladder,
    mixed_workload,
    replay_poisson,
)
from repro_torch.serving.batcher import MicroBatch
from repro_torch.serving.runtime import read_back
from repro_torch.serving.types import Request
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse)

N, D, L = 400, 8, 40
LADDER = (4, 8)
N_REQ = 48
# Tier 0 starved (ef 8, 8 iterations), tier 1 at 4x: selective label
# constraints under-fill at tier 0 and escalate.
TIER_KW = dict(k_cap=8, base_ef=8, base_iters=8, base_n_start=4, n_tiers=2)
K_CHOICES = (2, 4, 8)
RESPONSE_FIELDS = ("filled", "tier", "escalations", "strategy", "fill_history", "epoch",
                   "batch_id", "shed_reason", "error", "faulted", "degraded")


@functools.lru_cache(maxsize=1)
def world():
    rng = np.random.default_rng(0)
    vec = rng.integers(-6, 7, size=(N, D)).astype(np.float32)
    lab = rng.integers(0, L, size=N).astype(np.int32)
    attrs = rng.random((N, 2)).astype(np.float32)
    ref_corpus = RefCorpus(vectors=jnp.asarray(vec), labels=jnp.asarray(lab),
                           attrs=jnp.asarray(attrs))
    graph = ref_build_index(jax.random.PRNGKey(1), ref_corpus, degree=8, sample_size=64)
    corpus, port_graph, _ = from_reference_arrays(
        vectors=vec, labels=lab, attrs=attrs, neighbors=np.asarray(graph.neighbors),
        sample_ids=np.asarray(graph.sample_ids), entry_point=np.asarray(graph.entry_point),
        device="cpu")
    return (ref_corpus, graph), (corpus, port_graph)


def _drain(runtime, items):
    ids = [runtime.submit(it.query, it.k, it.family, it.operand) for it in items]
    runtime.drain()
    return [runtime.poll(i) for i in ids]


@functools.lru_cache(maxsize=None)
def served(scenario: str):
    """(reference runtime, its responses, port runtime, its responses, items)
    for one scenario, run once per process."""
    (ref_corpus, ref_graph), (corpus, graph) = world()
    n_req = 64 if scenario == "hybrid" else N_REQ
    items = mixed_workload(7, corpus, n_req, L, k_choices=K_CHOICES, jitter=0.0)
    for a, b in zip(items, ref_mixed_workload(7, ref_corpus, n_req, L, k_choices=K_CHOICES,
                                              jitter=0.0)):
        assert (a.k, a.family, a.kind) == (b.k, b.family, b.kind)
        assert a.query.tobytes() == b.query.tobytes()
        assert np.array_equal(np.asarray(a.operand), np.asarray(b.operand))
    ref_ex, port_ex = RefLocalExecutor(ref_corpus, ref_graph), LocalExecutor(corpus, graph)
    clocks = RefClock(), VirtualClock()
    if scenario == "faults":
        cfg = dict(seed=5, error_rate=0.3)
        ref_ex = RefFaultyExecutor(ref_ex, RefFaultSchedule(RefFaultConfig(**cfg)))
        port_ex = FaultyExecutor(port_ex, FaultSchedule(FaultConfig(**cfg)))
    ref = RefRuntime(ref_ex, n_labels=L, tiers=ref_tier_ladder(**TIER_KW), ladder=LADDER,
                     clock=clocks[0], max_fault_retries=1)
    port = ServingRuntime(port_ex, n_labels=L, tiers=make_tier_ladder(**TIER_KW),
                          ladder=LADDER, clock=clocks[1], max_fault_retries=1,
                          logger=JsonLogger())
    if scenario == "hybrid":
        ref.router = ref_make_router(ref_ex, n_labels=L, controller=ref.controller)
        port.router = make_serving_router(port_ex, n_labels=L, controller=port.controller)
    if scenario == "mixed":
        assert ref.warmup() == port.warmup() == port.trace_budget
    return ref, _drain(ref, items), port, _drain(port, items), items


def _assert_same_response(a, b):
    assert a.req_id == b.req_id and a.k == b.k
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.dists, b.dists)
    assert a.ids.dtype == b.ids.dtype == np.int32
    assert a.dists.dtype == b.dists.dtype == np.float32
    for field in RESPONSE_FIELDS:
        assert getattr(a, field) == getattr(b, field), (a.req_id, field)


def _assert_same_runtime(ref, port):
    assert dict(ref.telemetry.counters) == dict(port.telemetry.counters)
    assert ref.cache.trace_count == port.cache.trace_count
    assert ref.cache.stats() == port.cache.stats()
    assert port.executor.traces == port.cache.trace_count
    # Latency EMAs are wall time; every other controller field must agree.
    assert _without_latency(ref.controller.snapshot()) == _without_latency(
        port.controller.snapshot())


def _without_latency(tree):
    if isinstance(tree, dict):
        return {k: _without_latency(v) for k, v in tree.items() if k != "lat_ema"}
    return tree


def test_mixed_stream_equals_reference_bit_for_bit():
    ref, ref_rs, port, port_rs, items = served("mixed")
    assert {it.family for it in items} == {"label", "range"}
    for a, b in zip(ref_rs, port_rs):
        _assert_same_response(a, b)
    _assert_same_runtime(ref, port)
    assert port.telemetry.counters["completed"] == N_REQ
    assert port.telemetry.counters["escalations"] > 0
    assert any(r.escalations and r.tier == 1 for r in port_rs)


def test_mixed_stream_covers_bit_31_words():
    """Some operands allow label 31 (bit 31 of the first uint32 word, a
    negative int32 word in the port): every label request, those too,
    returns only rows of an allowed label."""
    _, _, _, port_rs, items = served("mixed")
    (_, _), (corpus, _) = world()
    labels = corpus.labels.numpy()
    hit = 0
    for it, r in zip(items, port_rs):
        if it.family != "label":
            continue
        words = np.asarray(it.operand, np.uint32)
        assert words.shape == (2,)
        hit += bool(words[0] >> 31)
        got = r.ids[r.ids >= 0]
        assert all(words[lab // 32] >> np.uint32(lab % 32) & 1 for lab in labels[got])
    assert hit > 0


def test_warmup_builds_the_whole_trace_budget():
    ref, _, port, _, _ = served("mixed")
    budget = len(LADDER) * 2 * 2
    assert port.trace_budget == ref.trace_budget == budget
    assert port.cache.trace_count == port.executor.traces == budget
    assert port.cache.misses == 0  # warmup built every key; the stream only hit
    assert port.cache.hits == ref.cache.hits > 0


def test_hybrid_router_posting_bit_for_bit_overlay_on_its_label():
    ref, ref_rs, port, port_rs, items = served("hybrid")
    (_, _), (corpus, _) = world()
    labels = corpus.labels.numpy()
    mix = collections.Counter(r.strategy for r in port_rs)
    assert mix["posting"] > 0 and mix["overlay"] > 0 and mix["graph"] > 0
    assert [r.strategy for r in ref_rs] == [r.strategy for r in port_rs]
    for a, b, it in zip(ref_rs, port_rs, items):
        if b.strategy != "overlay":
            _assert_same_response(a, b)
            continue
        lab = int(np.flatnonzero(np.unpackbits(
            np.asarray(it.operand, np.uint32).view(np.uint8), bitorder="little"))[0])
        got = b.ids[b.ids >= 0]
        assert (labels[got] == lab).all() and len(set(got.tolist())) == got.size
        assert (np.diff(b.dists[: b.filled]) >= 0).all()
        assert np.isinf(b.dists[b.filled:]).all() and (b.ids[b.filled:] == -1).all()
        assert (a.filled, a.tier, a.escalations) == (b.filled, b.tier, b.escalations)
    _assert_same_runtime(ref, port)
    assert ref.overlays.stats() == port.overlays.stats()


def test_injected_faults_follow_the_same_schedule():
    """A seeded error schedule fails the same dispatches on both sides: the
    same requests retry, the same ones surface as failed responses."""
    ref, ref_rs, port, port_rs, _ = served("faults")
    for a, b in zip(ref_rs, port_rs):
        _assert_same_response(a, b)
    _assert_same_runtime(ref, port)
    c = port.telemetry.counters
    assert c["faults_injected"] > 0 and c["fault_retries"] > 0 and c["failed"] > 0
    assert c["completed"] == N_REQ


def test_logs_and_traces_account_every_request():
    _, _, port, port_rs, _ = served("mixed")
    records = port.logger.sink.records()
    admitted = {r["req_id"] for r in records if r["event"] == "admit"}
    completed = {r["req_id"] for r in records if r["event"] == "complete"}
    assert admitted == completed == {r.req_id for r in port_rs}
    batches = {r["batch_id"] for r in records if r["event"] == "dispatch"}
    assert {r.batch_id for r in port_rs} <= batches
    assert all(trace_consistent(r.trace) for r in port_rs)


def test_assembly_keeps_words_bits_and_the_device():
    words = label_words_row([0, 31, 39], L)
    assert words[0] == np.uint32(0x80000001) and words[1] == np.uint32(1 << 7)
    reqs = [Request(req_id=i, query=np.full((D,), i, np.float32), k=2, family="label",
                    operand=words) for i in range(3)]
    mb = MicroBatch(group=("label",), tier=0, bucket=4, requests=reqs)
    cons = assemble_constraint(mb, torch.device("cpu"))
    assert cons.words.dtype == torch.int32 and cons.words.shape == (4, 2)
    assert cons.words[3, 0].item() == np.uint32(0x80000001).view(np.int32) < 0
    q = assemble_queries(mb, D, torch.device("cpu"))
    assert q.device.type == "cpu" and q.dtype == torch.float32
    assert torch.equal(q[3], q[2])  # padding repeats the last real lane
    rreq = [Request(req_id=0, query=np.zeros((D,), np.float32), k=2, family="range",
                    operand=(0.1, 0.7, 1))]
    rc = assemble_constraint(MicroBatch(group=("range", 1), tier=0, bucket=4, requests=rreq),
                             torch.device("cpu"))
    assert rc.col == 1 and isinstance(rc.col, int)
    assert rc.lo.dtype == torch.float32 and float(rc.hi[3]) == np.float32(0.7)


def test_read_back_is_one_copy_of_the_same_bits():
    from repro_torch.core.types import SearchResult, SearchStats

    ids = torch.tensor([[3, -1], [7, 2]], dtype=torch.int32)
    dists = torch.tensor([[0.5, float("inf")], [-0.0, 1e-40]], dtype=torch.float32)
    zero = torch.zeros(2, dtype=torch.int32)
    res = SearchResult(dists=dists, ids=ids,
                       stats=SearchStats(zero, zero, zero, torch.tensor(9, dtype=torch.int32)))
    got_ids, got_d, filled, iters = read_back(res)
    np.testing.assert_array_equal(got_ids, ids.numpy())
    assert got_d.tobytes() == dists.numpy().tobytes()
    np.testing.assert_array_equal(filled, [1, 2])
    assert iters == 9


def test_poisson_replay_accounts_for_every_request():
    (_, _), (corpus, graph) = world()
    runtime = ServingRuntime(LocalExecutor(corpus, graph), n_labels=L,
                             tiers=make_tier_ladder(**TIER_KW), ladder=LADDER,
                             clock=VirtualClock(), max_pending=16, max_wait=0.005)
    items = mixed_workload(3, corpus, 40, L, k_choices=K_CHOICES)
    responses, rejected = replay_poisson(runtime, items, rate=20_000, seed=11)
    served_ = [r for r in responses if r is not None]
    assert len(served_) + rejected == len(items)
    assert runtime.telemetry.counters["submitted"] == len(served_)
    assert runtime.telemetry.counters["rejected"] == rejected
    assert runtime.in_flight == 0 and runtime.cache.trace_count <= runtime.trace_budget
    assert all(trace_consistent(r.trace) for r in served_)
    assert runtime.busy_seconds > 0


def test_executor_serves_on_the_corpus_device():
    (_, _), (corpus, graph) = world()
    ex = LocalExecutor(corpus, graph)
    assert ex.device == corpus.vectors.device and ex.dim == D
    runtime = ServingRuntime(ex, n_labels=L, tiers=make_tier_ladder(**TIER_KW),
                             ladder=(4,), clock=VirtualClock())
    rids = [runtime.submit(corpus.vectors[0].numpy(), 4, "label", label_words_row([1, 2], L)),
            runtime.submit(corpus.vectors[1].numpy(), 4, "range", (0.2, 0.9, 0))]
    runtime.drain()
    for rid in rids:
        r = runtime.poll(rid)
        assert r.ok and r.filled > 0 and isinstance(r.ids, np.ndarray)
