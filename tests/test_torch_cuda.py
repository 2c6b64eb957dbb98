"""The CUDA kernels against their plain versions on the card
(fused_expand's matrix is in test_torch_cuda_fused.py).

Marked ``cuda``; each test skips where there is no CUDA device. These files
import no JAX, so they also run where only the port is installed:

    python -m pytest -m cuda tests/test_torch_cuda.py tests/test_torch_cuda_fused.py

Distances are exact on integer-valued inputs and within 1e-5 relative on
float inputs (the card sums in another order); masks are exact; the fused
kernel's distances equal gather_distance's bit for bit (one shared
reduction).
"""
import pytest
import torch

from repro_torch.common.bits import n_words
from repro_torch.kernels.fused_expand import fused_expand_cuda
from repro_torch.kernels.gather_distance import (
    gather_distance,
    gather_distance_cuda,
    gather_distance_plain,
)

B, N, L = 8, 5000, 40
MS = (1, 16, 45, 130)
DS = (128, 13)  # the float4 path and the scalar path (d % 4 != 0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run only on the card")
    return torch.device("cuda")


def _words(gen, shape, dev):
    return torch.randint(-2**31, 2**31, shape, generator=gen, dtype=torch.int64,
                         device=dev).to(torch.int32)


def make_inputs(dev, family, m, d, integer, tomb, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    if integer:
        q = torch.randint(-8, 9, (B, d), generator=gen, device=dev).float()
        x = torch.randint(-8, 9, (N, d), generator=gen, device=dev).float()
    else:
        q = torch.randn((B, d), generator=gen, device=dev)
        x = torch.randn((N, d), generator=gen, device=dev)
    ids = torch.randint(-2, N, (B, m), generator=gen, dtype=torch.int32, device=dev)
    ids[:, 0] = 31  # bit 31 of word 0
    visited = _words(gen, (B, n_words(N)), dev)
    if family == "label":
        meta = torch.randint(0, L, (N,), generator=gen, dtype=torch.int32, device=dev)
        meta[31] = 31
        cons = _words(gen, (B, n_words(L)), dev)
    elif family == "range":
        meta = torch.randint(0, 20, (N,), generator=gen, device=dev).float()
        lo = torch.randint(0, 10, (B,), generator=gen, device=dev).float()
        cons = torch.stack([lo, lo + 6], -1)
    else:
        meta = torch.randint(-1, 2, (N,), generator=gen, dtype=torch.int32, device=dev)
        cons = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    tombs = _words(gen, (n_words(N),), dev) if tomb else None
    return q, x, ids, visited, meta, cons, tombs


def assert_dists(got, want, integer):
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    if integer:
        assert torch.equal(got[fin], want[fin])
    else:
        torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("d", DS)
def test_gather_distance_kernel_matches_plain(dev, d, integer):
    for m in MS:
        q, x, ids = make_inputs(dev, "label", m, d, integer, False)[:3]
        before = gather_distance.launches
        out = gather_distance(q, x, ids)
        torch.cuda.synchronize()
        assert gather_distance.launches == before + 1
        assert_dists(out, gather_distance_plain(q, x, ids), integer)


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(dev):
    q, x, ids, visited, meta, cons, _ = make_inputs(dev, "label", 16, 128, True, False)
    with pytest.raises(ValueError):
        gather_distance_cuda(q, x, ids.long())
    with pytest.raises(ValueError):
        gather_distance_cuda(q, x.t(), ids)
    with pytest.raises(ValueError):
        fused_expand_cuda(q, x, ids, visited, meta.float(), cons, family="label")
    with pytest.raises(ValueError):
        fused_expand_cuda(q, x, ids, visited[:, :3], meta, cons, family="label")
    with pytest.raises(ValueError):
        gather_distance(q, x.cpu(), ids)


@pytest.mark.cuda
def test_empty_batch_launches_nothing_harmful(dev):
    q, x, ids, visited, meta, cons, _ = make_inputs(dev, "label", 16, 128, True, False)
    out = gather_distance_cuda(q, x, ids[:, :0])
    d, s, f = fused_expand_cuda(q, x, ids[:, :0].contiguous(), visited, meta, cons,
                                family="label")
    torch.cuda.synchronize()
    assert out.shape == (B, 0) and d.shape == (B, 0) and s.shape == (B, 0)
