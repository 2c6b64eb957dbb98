"""The streaming index and the posting scan on the card against the port on
the CPU, over an integer-valued world (every distance exact in float32, so
the card must give the same bits): the batched insert patches and the
batched consolidation re-rank (``gather_distance`` on the card, its plain
version on the CPU) leave the same adjacency, slots, sample and entry
vertex; the posting scan through the kernel (``use_kernel=True``) equals
the scan without it.

Marked ``cuda``; each test skips where there is no CUDA device. JAX-free:

    python -m pytest -m cuda tests/test_torch_cuda*.py
"""
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch.core.posting import pad_posting, posting_bucket
from repro_torch.kernels.gather_distance import gather_distance
from test_torch_cuda import dev  # noqa: F401 (a fixture)

N, D, L = 3000, 16, 6


def _world(device):
    rng = np.random.default_rng(1)
    vec = rng.integers(-6, 7, size=(N, D)).astype(np.float32)
    lab = rng.integers(0, L, size=N).astype(np.int32)
    attrs = rng.integers(0, 1000, size=(N, 2)).astype(np.float32)
    corpus = rt.Corpus(vectors=torch.from_numpy(vec), labels=torch.from_numpy(lab),
                       attrs=torch.from_numpy(attrs))
    graph = rt.build_index(torch.Generator().manual_seed(0), corpus, degree=16, sample_size=64,
                           device="cpu")
    return corpus, graph, vec, lab


def _same_state(a, b):
    assert torch.equal(a.neighbors.cpu(), b.neighbors.cpu())
    assert torch.equal(a.pool.vectors.cpu(), b.pool.vectors.cpu())
    np.testing.assert_array_equal(a.pool.tombstones, b.pool.tombstones)
    np.testing.assert_array_equal(a.sample_ids, b.sample_ids)
    assert (a.entry_point, a.pool.free, a.pool.pending) == (b.entry_point, b.pool.free,
                                                            b.pool.pending)


@pytest.mark.cuda
def test_streaming_ops_on_the_card_equal_the_cpu(dev):  # noqa: F811
    corpus, graph, vec, lab = _world("cpu")
    cpu = rt.StreamingIndex.from_static(corpus, graph, capacity=N + 300, seed=2, device="cpu")
    card = rt.StreamingIndex.from_static(corpus, graph, capacity=N + 300, seed=2, device=dev)
    rng = np.random.RandomState(3)
    before = gather_distance.launches
    for step in range(3):
        victims = [cpu.entry_point, *rng.choice(N, 120, replace=False).tolist()]
        for s in victims:
            assert cpu.delete(int(s)) == card.delete(int(s))
        for _ in range(40):
            p = rng.randint(N)
            v = vec[p] + rng.randint(-1, 2, size=D).astype(np.float32)
            assert cpu.insert(v, label=int(lab[p])) == card.insert(v, label=int(lab[p]))
        _same_state(cpu, card)
        kw = {"max_slots": 60} if step == 0 else {}
        assert cpu.consolidate(**kw) == card.consolidate(**kw)
        _same_state(cpu, card)
        card.check_stats_exact()
    # 120 inserts patch through one launch each; 3 consolidations one each.
    assert gather_distance.launches - before == 120 + 3


@pytest.mark.cuda
def test_posting_scan_with_the_kernel_equals_without(dev):  # noqa: F811
    corpus, _, vec, lab = _world("cpu")
    corpus = rt.Corpus(vectors=corpus.vectors.to(dev), labels=corpus.labels.to(dev),
                       attrs=corpus.attrs.to(dev))
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.integers(-6, 7, size=(64, D)).astype(np.float32)).to(dev)
    lo = torch.full((64,), 100.0, device=dev)
    for cons, ids in (
        (rt.equal_constraint(torch.full((64,), 2, dtype=torch.int32, device=dev), L),
         np.flatnonzero(lab == 2).astype(np.int32)),
        (rt.RangeConstraint(lo=lo, hi=lo + 150.0, col=0),
         np.flatnonzero((corpus.attrs[:, 0].cpu().numpy() >= 100.0)
                        & (corpus.attrs[:, 0].cpu().numpy() <= 250.0)).astype(np.int32)),
    ):
        padded = torch.from_numpy(pad_posting(ids, posting_bucket(ids.shape[0]))).to(dev)
        before = gather_distance.launches
        with_k = rt.posting_search(corpus, q, cons, padded, rt.SearchParams(k=10,
                                                                            use_kernel=True))
        assert gather_distance.launches - before == 1
        without = rt.posting_search(corpus, q, cons, padded, rt.SearchParams(k=10))
        assert torch.equal(with_k.ids, without.ids) and torch.equal(with_k.dists, without.dists)
        od, oi = rt.exact_constrained_search(corpus, q, cons, 10)
        assert torch.equal(with_k.dists, od)
