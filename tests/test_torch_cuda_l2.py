"""The l2_matmul CUDA kernel against its plain version, and the index build
through it, on the card.

Marked ``cuda``; each test skips where there is no CUDA device. This file
imports no JAX, so it also runs where only the port is installed:

    python -m pytest -m cuda tests/test_torch_cuda_l2.py

Distances are exact on integer-valued inputs (every product and partial
sum is exact in float32) and within 1e-5 * (|q|^2 + |x|^2) per element on
float inputs (the expansion cancels near 0 and the card adds in another
order). Over an integer world the build on the card equals the build on
the CPU: NN-descent with the same draws bit for bit, the exact kNN graphs
(alone and per shard of the partitioned layout) up to distance ties
(``topk`` orders ties freely).
"""
import math

import pytest
import torch

from repro_torch.core.types import Corpus
from repro_torch.graph import build_knn_graph, build_partitioned_index, nn_descent
from repro_torch.kernels.gather_distance import gather_distance
from repro_torch.kernels.l2_matmul import l2_matmul_cuda, l2_matmul_plain, pairwise_sqdist

# (M, N, d): the build's row block, M = 1, ragged M / N / d, d = 1.
SHAPES = ((1024, 20000, 128), (1, 777, 128), (130, 257, 13), (129, 131, 1), (200, 301, 37))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run only on the card")
    return torch.device("cuda")


def make(dev, m, n, d, integer, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    if integer:
        return (torch.randint(-8, 9, (m, d), generator=gen, device=dev).float(),
                torch.randint(-8, 9, (n, d), generator=gen, device=dev).float())
    return (torch.randn((m, d), generator=gen, device=dev),
            torch.randn((n, d), generator=gen, device=dev))


def assert_close_l2(got, want, q, x, integer):
    assert (got >= 0).all()
    if integer:
        assert torch.equal(got, want)
    else:
        tol = 1e-5 * ((q * q).sum(-1)[:, None] + (x * x).sum(-1)[None, :])
        assert ((got - want).abs() <= tol).all()


@pytest.mark.cuda
@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
def test_l2_matmul_kernel_matches_plain(dev, integer):
    for i, (m, n, d) in enumerate(SHAPES):
        q, x = make(dev, m, n, d, integer, seed=i)
        before = pairwise_sqdist.launches
        got = pairwise_sqdist(q, x)
        torch.cuda.synchronize()
        assert pairwise_sqdist.launches == before + 1
        assert got.shape == (m, n)
        assert_close_l2(got, l2_matmul_plain(q, x), q, x, integer)


@pytest.mark.cuda
def test_identical_rows_give_zero(dev):
    q, x = make(dev, 1, 300, 37, True, seed=5)
    got = l2_matmul_cuda(x[:150].contiguous(), x)
    assert torch.equal(torch.diagonal(got), torch.zeros(150, device=dev))
    _, xf = make(dev, 1, 300, 37, False, seed=5)
    got = l2_matmul_cuda(xf, xf)
    assert (got >= 0).all() and float(torch.diagonal(got).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_l2_wrapper_rejects_bad_inputs(dev):
    q, x = make(dev, 8, 64, 16, True)
    for bad_q, bad_x in ((q.double(), x), (q, x.t()), (q, x[:, :8]), (q, x.cpu())):
        with pytest.raises(ValueError):
            l2_matmul_cuda(bad_q, bad_x)
    assert l2_matmul_cuda(q[:0], x).shape == (0, 64)


def row_dists(vec, nbrs):
    d = ((vec[nbrs.clamp_min(0).long()] - vec[:, None, :]) ** 2).sum(-1)
    return torch.where(nbrs >= 0, d, float("inf"))


def assert_equal_up_to_ties(vec, want, got):
    want_d, got_d = row_dists(vec, want), row_dists(vec, got)
    assert torch.equal(want_d, got_d)
    strict = want_d < want_d[:, -1:]
    assert torch.equal(torch.where(strict, want, -1).sort(-1).values,
                       torch.where(strict, got, -1).sort(-1).values)


def int_world(dev, n, d=16, seed=3):
    gen = torch.Generator().manual_seed(seed)
    vec = torch.randint(-6, 7, (n, d), generator=gen).float()
    lab = torch.randint(0, 10, (n,), generator=gen, dtype=torch.int32)
    return vec.to(dev), lab.to(dev), vec, lab


@pytest.mark.cuda
def test_exact_build_card_equals_cpu(dev):
    vec, _, vec_cpu, _ = int_world(dev, 5000)
    before = pairwise_sqdist.launches
    card = build_knn_graph(vec, 16, block=1024)
    assert pairwise_sqdist.launches == before + math.ceil(5000 / 1024)
    assert_equal_up_to_ties(vec_cpu, build_knn_graph(vec_cpu, 16, block=1024), card.cpu())


@pytest.mark.cuda
def test_nn_descent_card_equals_cpu(dev):
    vec, _, vec_cpu, _ = int_world(dev, 3000)
    gen = torch.Generator().manual_seed(1)
    n, degree, iters = 3000, 16, 4
    draws = dict(k0=torch.randint(0, n, (n, degree), generator=gen, dtype=torch.int32),
                 cols=[torch.randint(0, degree, (n, degree, 2), generator=gen)
                       for _ in range(iters)],
                 rand=[torch.randint(0, n, (n, degree), generator=gen, dtype=torch.int32)
                       for _ in range(iters)])
    before = gather_distance.launches
    card = nn_descent(None, vec, degree, iters=iters, draws=draws, device=dev)
    assert gather_distance.launches == before + iters + 1
    cpu = nn_descent(None, vec_cpu, degree, iters=iters, draws=draws, device="cpu")
    assert torch.equal(card.cpu(), cpu)


@pytest.mark.cuda
def test_partitioned_build_card_equals_cpu(dev):
    vec, lab, vec_cpu, lab_cpu = int_world(dev, 4097)
    c_card, g_card = build_partitioned_index(torch.Generator(device=dev).manual_seed(0),
                                             Corpus(vectors=vec, labels=lab), 4, degree=16,
                                             sample_size_per_shard=32, reverse_edges=False,
                                             device=dev)
    c_cpu, g_cpu = build_partitioned_index(torch.Generator().manual_seed(0),
                                           Corpus(vectors=vec_cpu, labels=lab_cpu), 4,
                                           degree=16, sample_size_per_shard=32,
                                           reverse_edges=False, device="cpu")
    assert torch.equal(c_card.vectors.cpu(), c_cpu.vectors)
    assert torch.equal(c_card.labels.cpu(), c_cpu.labels)
    assert torch.equal(g_card.entry_point.cpu(), g_cpu.entry_point)
    n_local = c_cpu.n // 4
    for s in range(4):
        rows = slice(s * n_local, (s + 1) * n_local)
        assert_equal_up_to_ties(c_cpu.vectors[rows], g_cpu.neighbors[rows],
                                g_card.neighbors[rows].cpu())
