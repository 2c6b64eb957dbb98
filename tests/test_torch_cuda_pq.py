"""The PQ CUDA kernels against their plain versions on the card.

Marked ``cuda``; each test skips where there is no CUDA device. JAX-free:

    python -m pytest -m cuda tests/test_torch_cuda*.py

Every path adds the m_sub LUT entries left to right, one rounded add at a
time (kernels/pq_adc.py), so the kernels equal their plain versions bit for
bit on float LUTs as well as integer ones; masks are exact; the fused
kernel's distances equal the unfused ``PQBackend.distances``. Tables of
every size fused_expand_adc meets: 16 KB (staged in shared memory), 64 KB
(staged after the opt-in past 48 KB), one that with its constraint row
just exceeds a block's 227 KB and one of 256 KB (both looked up in device
memory), and n_cent = 16.
"""
import pytest
import torch

from repro_torch.core.engine.context import PQBackend
from repro_torch.kernels.fused_expand import fused_expand_adc, fused_expand_adc_plain
from repro_torch.kernels.pq_adc import pq_adc, pq_adc_cuda, pq_adc_plain
from test_torch_cuda import MS, B, N, dev, make_inputs  # noqa: F401 (dev is a fixture)


def make_pq(dev, b, n, m_sub, n_cent, integer, seed=0):  # noqa: F811
    gen = torch.Generator(device=dev).manual_seed(seed)
    if integer:
        lut = torch.randint(0, 300, (b, m_sub, n_cent), generator=gen, device=dev).float()
    else:
        lut = torch.randn((b, m_sub, n_cent), generator=gen, device=dev) ** 2 * 50
    codes = torch.randint(0, n_cent, (n, m_sub), generator=gen, dtype=torch.int32, device=dev)
    codes[0], codes[1] = 0, n_cent - 1
    return lut, codes


@pytest.mark.cuda
@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
def test_pq_adc_kernel_matches_plain(dev, integer):  # noqa: F811
    for b, n, m_sub, n_cent in ((256, 3000, 16, 256), (1, 1000, 16, 256), (9, 1000, 16, 16),
                                (3, 777, 6, 256), (17, 5000, 32, 64)):
        lut, codes = make_pq(dev, b, n, m_sub, n_cent, integer)
        before = pq_adc.launches
        out = pq_adc(lut, codes)
        torch.cuda.synchronize()
        assert pq_adc.launches == before + 1
        assert torch.equal(out, pq_adc_plain(lut, codes)), (b, n, m_sub, n_cent)


@pytest.mark.cuda
@pytest.mark.parametrize("tomb", [False, True], ids=["no_tomb", "tomb"])
@pytest.mark.parametrize("family", ["label", "range", "udf"])
def test_fused_expand_adc_kernel_matches_plain(dev, family, tomb):  # noqa: F811
    for m in MS:
        for integer in (True, False):
            _, x, ids, visited, meta, cons, tombs = make_inputs(dev, family, m, 16, integer, tomb)
            lut, codes = make_pq(dev, B, x.shape[0], 16, 256, integer)
            args = (lut, codes, ids, visited, meta, cons, tombs)
            before = fused_expand_adc.launches
            d, s, f = fused_expand_adc(*args, family=family)
            torch.cuda.synchronize()
            assert fused_expand_adc.launches == before + 1
            pd, ps, pf = fused_expand_adc_plain(*args, family=family)
            assert torch.equal(d, pd)
            assert s.dtype == torch.bool and torch.equal(s, ps) and torch.equal(f, pf)
            unfused = PQBackend(codes=codes, lut=lut).distances(None, ids)
            assert torch.equal(d, torch.where(ids >= 0, unfused, float("inf")))


@pytest.mark.cuda
def test_pq_wrappers_reject_bad_inputs(dev):  # noqa: F811
    lut, codes = make_pq(dev, 4, 100, 16, 256, True)
    with pytest.raises(ValueError):
        pq_adc_cuda(lut, codes.long())
    with pytest.raises(ValueError):
        pq_adc_cuda(lut, codes[:, :8].contiguous())
    with pytest.raises(ValueError):
        big = torch.zeros((1, 64, 1024), device=dev)  # a 256 KB LUT: over the block's limit
        pq_adc_cuda(big, torch.zeros((10, 64), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        pq_adc(lut, codes.cpu())
    _, _, ids, visited, meta, cons, _ = make_inputs(dev, "label", 16, 16, True, False)
    lut, codes = make_pq(dev, B, 5000, 16, 256, True)
    with pytest.raises(ValueError):
        fused_expand_adc(lut, codes, ids, visited[:, :3], meta, cons, family="label")
    out = pq_adc_cuda(lut, codes[:0])
    d, _, _ = fused_expand_adc(lut, codes, ids[:, :0].contiguous(), visited, meta, cons,
                               family="label")
    torch.cuda.synchronize()
    assert out.shape == (B, 0) and d.shape == (B, 0)


@pytest.mark.cuda
def test_fused_expand_adc_table_sizes(dev):  # noqa: F811
    """Bit for bit against the plain version and against pq_adc_cuda's scan
    (which takes tables up to 227 KB), with codes at 0 and n_cent - 1."""
    for m_sub, n_cent in ((16, 256), (64, 256), (227, 256), (64, 1024), (16, 16)):
        for integer in (True, False):
            for family, tomb in (("label", False), ("range", True)):
                _, _, ids, visited, meta, cons, tombs = make_inputs(dev, family, 45, 16, integer,
                                                                    tomb, seed=m_sub)
                ids[:, 1], ids[:, 2] = 0, 1  # rows 0 and 1 hold the extreme codes
                ids[3] = -1  # a query row of padding only
                lut, codes = make_pq(dev, B, N, m_sub, n_cent, integer, seed=n_cent)
                args = (lut, codes, ids, visited, meta, cons, tombs)
                d, s, f = fused_expand_adc(*args, family=family)
                torch.cuda.synchronize()
                pd, ps, pf = fused_expand_adc_plain(*args, family=family)
                tag = (m_sub, n_cent, integer, family)
                assert torch.equal(d, pd), tag
                assert torch.equal(s, ps) and torch.equal(f, pf), tag
                assert torch.isinf(d[3]).all()
                if m_sub * n_cent * 4 <= 232_448:
                    scan = pq_adc_cuda(lut, codes).gather(1, ids.clamp_min(0).long())
                    assert torch.equal(d, torch.where(ids >= 0, scan, float("inf"))), tag
