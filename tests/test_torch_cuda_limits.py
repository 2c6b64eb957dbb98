"""The CUDA kernels past the size limits of their first ports, on the card.

gather_distance, fused_expand and fused_expand_adc once put the batch on
grid y (at most 65,535 queries) and l2_matmul its corpus tiles there (at
most 8,388,480 rows). Now all four carry on into grid z (csrc/grid.cuh),
so they take any size, as the Pallas kernels do. Each output row depends only on its own inputs, so the rows past
the old limits are held to the plain versions exactly (integer inputs).

Marked ``cuda``; each test skips where there is no CUDA device. JAX-free:

    python -m pytest -m cuda tests/test_torch_cuda*.py
"""
import pytest
import torch

from repro_torch.common.bits import n_words
from repro_torch.kernels.fused_expand import (
    fused_expand_adc_cuda,
    fused_expand_adc_plain,
    fused_expand_cuda,
    fused_expand_plain,
)
from repro_torch.kernels.gather_distance import gather_distance_cuda, gather_distance_plain
from repro_torch.kernels.l2_matmul import l2_matmul_cuda, l2_matmul_plain

BIG_B = 65_536  # one past the old grid-y limit of 65,535 queries
BIG_N = 8_388_481  # one past the old 65,535 x 128 corpus rows


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run only on the card")
    return torch.device("cuda")


def batch_inputs(dev, n=1000, d=8, m=3, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randint(-8, 9, (BIG_B, d), generator=gen, device=dev).float()
    x = torch.randint(-8, 9, (n, d), generator=gen, device=dev).float()
    ids = torch.randint(-1, n, (BIG_B, m), generator=gen, dtype=torch.int32, device=dev)
    visited = torch.randint(-2**31, 2**31, (BIG_B, n_words(n)), generator=gen,
                            dtype=torch.int64, device=dev).to(torch.int32)
    meta = torch.randint(0, 40, (n,), generator=gen, dtype=torch.int32, device=dev)
    cons = torch.randint(-2**31, 2**31, (BIG_B, n_words(40)), generator=gen, dtype=torch.int64,
                         device=dev).to(torch.int32)
    return q, x, ids, visited, meta, cons


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["gather_distance", "fused_expand", "fused_expand_adc"])
def test_batch_past_old_grid_limit(dev, kernel):
    q, x, ids, visited, meta, cons = batch_inputs(dev)
    if kernel == "gather_distance":
        got, want = [gather_distance_cuda(q, x, ids)], [gather_distance_plain(q, x, ids)]
    elif kernel == "fused_expand":
        got = fused_expand_cuda(q, x, ids, visited, meta, cons, family="label")
        want = fused_expand_plain(q, x, ids, visited, meta, cons, family="label")
    else:
        gen = torch.Generator(device=dev).manual_seed(1)
        lut = torch.randint(0, 300, (BIG_B, 4, 16), generator=gen, device=dev).float()
        codes = torch.randint(0, 16, (x.shape[0], 4), generator=gen, dtype=torch.int32,
                              device=dev)
        got = fused_expand_adc_cuda(lut, codes, ids, visited, meta, cons, family="label")
        want = fused_expand_adc_plain(lut, codes, ids, visited, meta, cons, family="label")
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == (BIG_B, ids.shape[1])
        assert torch.equal(g, w)
        assert torch.equal(g[-1], w[-1])  # the row past the old limit


@pytest.mark.cuda
def test_l2_matmul_past_old_row_limit(dev):
    gen = torch.Generator(device=dev).manual_seed(2)
    q = torch.randint(-8, 9, (2, 4), generator=gen, device=dev).float()
    x = torch.randint(-8, 9, (BIG_N, 4), generator=gen, device=dev).float()
    got = l2_matmul_cuda(q, x)
    torch.cuda.synchronize()
    assert got.shape == (2, BIG_N)
    tail = slice(BIG_N - 70_000, BIG_N)  # the last columns, past the old limit
    assert torch.equal(got[:, tail], l2_matmul_plain(q, x[tail]))
    assert torch.equal(got[:, :1000], l2_matmul_plain(q, x[:1000]))
