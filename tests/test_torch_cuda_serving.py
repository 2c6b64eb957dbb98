"""The serving runtime on the card against the same runtime on the CPU,
over an integer-valued world (every distance exact in float32, so the
kernels must give the plain versions' bits): one mixed stream with no
jitter, drained under a virtual clock, must give equal responses (ids,
dists, filled, tier, escalations, strategy) and equal telemetry counters,
with tiers through gather_distance, fused_expand and fused_expand_adc, and
with default tiers (the card runtime still launches gather_distance); the
hybrid router's posting and graph routes too (its overlays draw their
start sample from the device's generator, so they are held to their
label's live postings); and a churn stream through the streaming executor.

Marked ``cuda``; each test skips where there is no CUDA device. JAX-free:

    python -m pytest -m cuda tests/test_torch_cuda_serving.py
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch.serving import (
    LocalExecutor,
    ServingRuntime,
    StreamingLocalExecutor,
    VirtualClock,
    churn_workload,
    make_serving_router,
    make_tier_ladder,
    mixed_workload,
)
from test_torch_cuda import dev  # noqa: F401 (a fixture)

N, D, L = 3000, 16, 40
TIER_KW = dict(k_cap=8, base_ef=16, base_iters=24, base_n_start=8, n_tiers=2)
TIERS = {
    "kernel": dict(use_kernel=True),
    "fused": dict(use_kernel=True, fuse_expand="on"),
    "pq_fused": dict(approx="pq", fuse_expand="on"),
}


def _world(device):
    rng = np.random.default_rng(3)
    vec = torch.from_numpy(rng.integers(-6, 7, size=(N, D)).astype(np.float32))
    lab = torch.from_numpy(rng.integers(0, L, size=N).astype(np.int32))
    attrs = torch.from_numpy(rng.random((N, 2)).astype(np.float32))
    corpus = rt.Corpus(vectors=vec, labels=lab, attrs=attrs)
    graph = rt.build_index(torch.Generator().manual_seed(0), corpus, degree=16, sample_size=64,
                           device="cpu")
    m_sub, n_cent = 8, 16
    cb = torch.from_numpy(rng.integers(-6, 7, size=(m_sub, n_cent, D // m_sub)).astype(np.float32))
    codes = ((vec.reshape(N, m_sub, 1, -1) - cb[None]) ** 2).sum(-1).argmin(-1).to(torch.int32)
    move = (lambda t: t.to(device))
    corpus = rt.Corpus(*(move(t) for t in (vec, lab, attrs)))
    graph = rt.GraphIndex(*(move(t) for t in (graph.neighbors, graph.sample_ids,
                                              graph.entry_point)))
    return corpus, graph, rt.PQIndex(codebooks=move(cb), codes=move(codes.contiguous()))


def _tiers(extra):
    return tuple(dataclasses.replace(t, **extra) for t in make_tier_ladder(**TIER_KW))


def _drain(device, extra, hybrid=False):
    corpus, graph, pq = _world(device)
    ex = LocalExecutor(corpus, graph, pq)
    runtime = ServingRuntime(ex, n_labels=L, tiers=_tiers(extra), ladder=(8, 32),
                             clock=VirtualClock())
    if hybrid:
        runtime.router = make_serving_router(ex, n_labels=L, controller=runtime.controller)
    assert runtime.warmup() == runtime.trace_budget
    items = mixed_workload(7, corpus, 64, L, k_choices=(2, 4, 8), jitter=0.0)
    rids = [runtime.submit(it.query, it.k, it.family, it.operand) for it in items]
    runtime.drain()
    return runtime, [runtime.poll(r) for r in rids], corpus


def _same(a, b):
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.dists, b.dists)
    for field in ("filled", "tier", "escalations", "strategy", "fill_history", "epoch"):
        assert getattr(a, field) == getattr(b, field), field


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TIERS))
def test_card_serves_like_the_cpu(dev, name):
    card, card_rs, _ = _drain(dev, TIERS[name])
    host, host_rs, _ = _drain(torch.device("cpu"), TIERS[name])
    for a, b in zip(host_rs, card_rs):
        _same(a, b)
    assert dict(card.telemetry.counters) == dict(host.telemetry.counters)
    assert card.cache.trace_count == card.executor.traces == host.cache.trace_count
    assert card.telemetry.counters["escalations"] > 0


@pytest.mark.cuda
def test_card_runtime_scores_default_tiers_through_the_kernel(dev):
    """Tiers that leave use_kernel off still launch gather_distance on the
    card (the runtime sets it for a card executor) and give the bits the
    CPU's exact backend gives."""
    from repro_torch.kernels.gather_distance import gather_distance

    before = gather_distance.launches
    card, card_rs, _ = _drain(dev, {}, hybrid=True)
    assert gather_distance.launches > before
    assert not any(t.use_kernel for t in card.controller.tiers)
    host, host_rs, _ = _drain(torch.device("cpu"), {}, hybrid=True)
    for a, b in zip(host_rs, card_rs):
        if b.strategy != "overlay":
            _same(a, b)


@pytest.mark.cuda
def test_card_hybrid_routes_like_the_cpu(dev):
    card, card_rs, corpus = _drain(dev, TIERS["kernel"], hybrid=True)
    host, host_rs, _ = _drain(torch.device("cpu"), TIERS["kernel"], hybrid=True)
    labels = corpus.labels.cpu().numpy()
    assert [r.strategy for r in card_rs] == [r.strategy for r in host_rs]
    assert {r.strategy for r in card_rs} >= {"graph", "posting"}
    for a, b in zip(host_rs, card_rs):
        if b.strategy != "overlay":
            _same(a, b)
            continue
        got = b.ids[b.ids >= 0]
        assert len(set(labels[got].tolist())) <= 1 and (np.diff(b.dists[: b.filled]) >= 0).all()


@pytest.mark.cuda
def test_card_churn_serves_like_the_cpu(dev):
    def serve(device):
        corpus, graph, _ = _world(device)
        index = rt.StreamingIndex.from_static(corpus, graph, capacity=N + 200, seed=1,
                                              device=device)
        runtime = ServingRuntime(StreamingLocalExecutor(index, consolidate_after=8),
                                 n_labels=L, tiers=_tiers(TIERS["kernel"]), ladder=(8,),
                                 clock=VirtualClock())
        items = churn_workload(7, corpus, 96, L, mutation_frac=0.4, k_choices=(2, 4, 8),
                               jitter=0.0)
        rng = np.random.RandomState(11)
        live = list(range(N))
        out = []
        for start in range(0, len(items), 16):
            rids = []
            for it in items[start : start + 16]:
                if it.family == "upsert":
                    rids.append(runtime.submit_upsert(it.query, *it.operand))
                elif it.family == "delete":
                    rids.append(runtime.submit_delete(live.pop(rng.randint(len(live)))))
                else:
                    rids.append(runtime.submit(it.query, it.k, it.family, it.operand))
            runtime.drain()
            for it, rid in zip(items[start : start + 16], rids):
                r = runtime.poll(rid)
                if it.family == "upsert":
                    live.append(int(r.ids[0]))
                out.append(r)
        return runtime, out

    card, card_rs = serve(dev)
    host, host_rs = serve(torch.device("cpu"))
    for a, b in zip(host_rs, card_rs):
        _same(a, b)
    assert card.report()["index"] == host.report()["index"]
    assert card.executor.index.consolidations > 0
    assert torch.equal(card.executor.index.neighbors.cpu(), host.executor.index.neighbors)
