"""Scale-out on the card against the same code on the CPU, over an
integer-valued world (every distance and ADC sum exact in float32, so the
kernels must give the plain versions' bits):

  * a (1, 4) mesh of four shards on one card (``cuda:0``) equals the same
    mesh on the CPU — exact (gather_distance), fused (fused_expand), PQ
    fused (fused_expand_adc) and range — in ids, dists and every stat, and
    the card's shard walks launch their kernels;
  * two card replicas behind the HTTP front end answer sequential requests
    as two CPU replicas do (ids, dists, filled, tier, epoch);
  * a degree-12 walk (inexact alter-ratio fractions) on the card equals
    the CPU's, alter and prefer modes, label and range, samples 64 and 128;
  * the two-tower ``two_phase_topk`` on a (1, 4) card mesh equals the CPU's
    and the card's single-device top-100 up to ties: scores within 1e-5
    abs (the card's products may round differently), ids equal wherever a
    score is more than 2e-5 from its neighbours.

Marked ``cuda``; each test skips where there is no CUDA device. JAX-free:

    python -m pytest -m cuda tests/test_torch_cuda_scaleout.py
"""
import json
import urllib.request

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch.distributed import MeshInfo
from repro_torch.kernels.fused_expand import fused_expand, fused_expand_adc
from repro_torch.kernels.gather_distance import gather_distance
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.recsys import two_tower_init
from repro_torch.models.recsys.models import RecsysConfig, stable_topk
from repro_torch.obs import ServingFrontend
from repro_torch.serving import (
    ReplicaSet,
    ServingRuntime,
    StreamingLocalExecutor,
    VirtualClock,
    make_tier_ladder,
    mixed_workload,
)
from test_torch_cuda import dev  # noqa: F401 (a fixture)

N, D, L, B = 2000, 16, 40, 32
PARAMS = dict(mode="prefer", k=8, ef_result=32, ef_sat=32, ef_other=32, n_start=8,
              max_iters=200)
KINDS = {
    "exact": (dict(use_kernel=True), gather_distance),
    "fused": (dict(use_kernel=True, fuse_expand="on"), fused_expand),
    "pq_fused": (dict(approx="pq", fuse_expand="on"), fused_expand_adc),
    "range": (dict(use_kernel=True), gather_distance),
}


def _world():
    rng = np.random.default_rng(7)
    t = torch.from_numpy
    vec = rng.integers(-6, 7, size=(N, D)).astype(np.float32)
    corpus = rt.Corpus(vectors=t(vec), labels=t(rng.integers(0, L, size=N).astype(np.int32)),
                       attrs=t(rng.random((N, 2)).astype(np.float32)))
    corpus_p, graph_p = rt.build_partitioned_index(torch.Generator().manual_seed(0), corpus, 4,
                                                   degree=12, sample_size_per_shard=32,
                                                   device="cpu")
    m_sub, n_cent = 8, 16
    cb = rng.integers(-6, 7, size=(m_sub, n_cent, D // m_sub)).astype(np.float32)
    codes = ((corpus_p.vectors.numpy().reshape(N, m_sub, 1, -1) - cb[None]) ** 2).sum(-1)
    pq = rt.PQIndex(codebooks=t(cb), codes=t(codes.argmin(-1).astype(np.int32)))
    q = t(rng.integers(-6, 7, size=(B, D)).astype(np.float32))
    words = t(rng.integers(0, 2**31, size=(B, 2)).astype(np.int32) | np.int32(-2**31))
    lo = t((rng.random(B) * 0.6).astype(np.float32))
    return corpus_p, graph_p, pq, q, words, lo


def _on(device, corpus, graph):
    def move(x):
        return None if x is None else x.to(device)

    return (rt.Corpus(*(move(x) for x in (corpus.vectors, corpus.labels, corpus.attrs))),
            rt.GraphIndex(*(move(x) for x in (graph.neighbors, graph.sample_ids,
                                              graph.entry_point))))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_card_mesh_equals_cpu_mesh(dev, kind):
    corpus, graph, pq, q, words, lo = _world()
    extra, kernel = KINDS[kind]
    params = rt.SearchParams(**PARAMS, **extra)
    out = {}
    for device in ("cpu", "cuda:0"):
        mesh = make_test_mesh(4, model=4, device=device)
        c, g = _on(device, corpus, graph)
        p = rt.PQIndex(codebooks=pq.codebooks.to(device), codes=pq.codes.to(device))
        if kind == "range":
            cons, ctype = rt.RangeConstraint(lo=lo.to(device), hi=(lo + 0.3).to(device),
                                             col=1), rt.RangeConstraint
        else:
            cons, ctype = rt.LabelSetConstraint(words=words.to(device)), rt.LabelSetConstraint
        search = rt.make_distributed_search(mesh, params, constraint_type=ctype)
        kernel.launches = 0
        out[device] = search(rt.shard_corpus_for_mesh(c, g, mesh), q.to(device), cons,
                             p if params.approx == "pq" else None)
        if device != "cpu":
            torch.cuda.synchronize()
            assert kernel.launches >= 4  # every shard's walk
            assert all(d == torch.device("cuda", 0) for d in mesh.devices)
    a, b = out["cpu"], out["cuda:0"]
    assert torch.equal(a.ids, b.ids.cpu()) and torch.equal(a.dists, b.dists.cpu())
    for field in ("dist_evals", "hops", "visited", "iters", "beam_expansions"):
        assert torch.equal(getattr(a.stats, field), getattr(b.stats, field).cpu()), field
    assert (a.ids >= 0).sum() > B


@pytest.mark.cuda
@pytest.mark.parametrize("sample", (64, 128))
def test_card_degree12_walk_equals_cpu(dev, sample):
    """alter_ratio_k = min(16, 12): the Eq.-1 fractions c / 12 are inexact,
    so the alter ratio's sum order decides its last bit. The pinned order
    (``core/alter_ratio.py::pinned_sum``) gives the card the CPU's walk."""
    rng = np.random.default_rng(12)
    t = torch.from_numpy
    n, d = 2048, 8
    corpus = rt.Corpus(vectors=t(rng.integers(-6, 7, size=(n, d)).astype(np.float32)),
                       labels=t(rng.integers(0, L, size=n).astype(np.int32)),
                       attrs=t(rng.integers(0, 100, size=(n, 2)).astype(np.float32)))
    graph = rt.build_index(torch.Generator().manual_seed(0), corpus, degree=12,
                           sample_size=sample, device="cpu")
    q = t(rng.integers(-6, 7, size=(64, d)).astype(np.float32))
    words = t(rng.integers(0, 2**31, size=(64, 2)).astype(np.int32))
    lo = t(rng.integers(0, 60, 64).astype(np.float32))
    for mode in ("alter", "prefer"):
        params = rt.SearchParams(mode=mode, k=10, ef_result=32, ef_sat=32, ef_other=32,
                                 n_start=8, max_iters=96, alter_ratio_k=16, use_kernel=True)
        for family in ("label", "range"):
            out = {}
            for device in ("cpu", "cuda"):
                c, g = _on(device, corpus, graph)
                cons = (rt.LabelSetConstraint(words=words.to(device)) if family == "label" else
                        rt.RangeConstraint(lo=lo.to(device), hi=(lo + 40).to(device), col=1))
                out[device] = rt.constrained_search(c, g, q.to(device), cons, params)
            a, b = out["cpu"], out["cuda"]
            assert torch.equal(a.ids, b.ids.cpu()) and torch.equal(a.dists, b.dists.cpu())
            for field in ("dist_evals", "hops", "visited", "iters", "beam_expansions"):
                assert torch.equal(getattr(a.stats, field), getattr(b.stats, field).cpu()), \
                    (mode, family, field)


def _post(addr, payload):
    req = urllib.request.Request(addr + "/v1/search", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


@pytest.mark.cuda
def test_card_replicas_behind_http_equal_cpu_replicas(dev):
    corpus, graph, _, _, _, _ = _world()
    flat = rt.build_index(torch.Generator().manual_seed(1), corpus, degree=12, sample_size=64,
                          device="cpu")
    items = mixed_workload(7, corpus, 16, L, k_choices=(2, 4, 8), jitter=0.0)
    tiers = make_tier_ladder(k_cap=8, base_ef=16, base_iters=24, base_n_start=8, n_tiers=2)
    payloads = {}
    for device in ("cpu", "cuda"):
        c, g = _on(device, corpus, flat)
        replicas = [ServingRuntime(StreamingLocalExecutor(rt.StreamingIndex.from_static(
            c, g, ef_insert=16, device=device)), n_labels=L, tiers=tiers, ladder=(4, 8),
            max_wait=0.002, clock=VirtualClock()) for _ in range(2)]
        fe = ServingFrontend(ReplicaSet(replicas))
        addr = fe.start()
        try:
            got = []
            for it in items:
                body = {"query": it.query.tolist(), "k": it.k, "family": it.family}
                if it.family == "label":
                    w = np.asarray(it.operand, np.uint32)
                    body["labels"] = [x for x in range(L) if w[x // 32] >> (x % 32) & 1]
                else:
                    body["range"] = [float(it.operand[0]), float(it.operand[1]),
                                     int(it.operand[2])]
                r = _post(addr, body)
                got.append((r["replica"], r["ids"], r["dists"], r["filled"], r["tier"],
                            r["epoch"]))
        finally:
            report = fe.close(drain=True)
        assert report["in_flight"] == 0
        payloads[device] = got
    assert payloads["cpu"] == payloads["cuda"]


def _same_up_to_ties(top_a, ids_a, top_b, ids_b, tol) -> bool:
    """Scores within ``tol``; ids equal wherever a score is more than
    ``tol`` from both neighbours (a tie within ``tol`` may swap)."""
    if float((top_a - top_b).abs().max()) > tol:
        return False
    gap = torch.full_like(top_a, float("inf"))
    diff = (top_a[:, 1:] - top_a[:, :-1]).abs()
    gap[:, 1:] = diff
    gap[:, :-1] = torch.minimum(gap[:, :-1], diff)
    clear = gap > 2 * tol
    return bool((ids_a[clear] == ids_b[clear]).all())


@pytest.mark.cuda
def test_card_two_phase_topk_equals_cpu(dev):
    cfg = RecsysConfig(name="tt", model="two_tower", embed_dim=16, tower_mlp=(32, 8),
                       item_vocab=512, user_vocab=256, hist_len=4)
    rng = np.random.default_rng(2)
    batch = dict(user_id=torch.from_numpy(rng.integers(0, 256, size=8).astype(np.int32)),
                 hist=torch.from_numpy(rng.integers(-1, 512, size=(8, 4)).astype(np.int32)),
                 candidates=torch.from_numpy(rng.standard_normal((512, 8)).astype(np.float32)))
    model = two_tower_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    out = {}
    for device in ("cpu", "cuda"):
        model = model.to(device)
        mi = MeshInfo(mesh=make_test_mesh(4, model=4, device=device))
        b = {k: v.to(device) for k, v in batch.items()}
        out[device] = [t.cpu() for t in model.score_candidates(b, mi, two_phase_topk=True)]
    single = [t.cpu() for t in stable_topk(model.user(b) @ b["candidates"].T, 100)]
    (t_cpu, i_cpu), (t_gpu, i_gpu) = out["cpu"], out["cuda"]
    assert t_gpu.shape == (8, 100) and i_gpu.dtype == torch.int32
    assert _same_up_to_ties(t_cpu, i_cpu, t_gpu, i_gpu, 1e-5)
    assert _same_up_to_ties(single[0], single[1], t_gpu, i_gpu, 1e-5)
