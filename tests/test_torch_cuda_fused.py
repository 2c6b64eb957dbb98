"""fused_expand's CUDA kernel against its plain version and against
gather_distance's distances on the card.

The matrix: the three families x tombstones {none, bitmap} x M x integer /
float inputs (helpers in test_torch_cuda.py). The paths: d in {1, 3, 128,
256, 1000} covers the register path (d = 128, 256: sqdist.cuh's RowTile,
the query row in registers) and the shared-memory path (d = 1, 3, 1000,
and an unaligned query row at every d); the constraint rows: Lw = 1 label
word (taken by a shuffle from the lane that holds it) and Lw > 32 (about
2,000 labels, 63 words: the word loaded once the meta word arrives), each with a
label whose bit 31 is set. Both kernels run one gather-and-reduce core, so
the distances equal gather_distance's bit for bit on float inputs too; the
masks equal the plain version's.

Marked ``cuda``; each test skips where there is no CUDA device. JAX-free:

    python -m pytest -m cuda tests/test_torch_cuda*.py
"""
import pytest
import torch

from repro_torch.common.bits import n_words
from repro_torch.kernels.fused_expand import fused_expand, fused_expand_cuda, fused_expand_plain
from repro_torch.kernels.gather_distance import gather_distance_cuda
from test_torch_cuda import MS, assert_dists, dev, make_inputs  # noqa: F401 (dev is a fixture)
from test_torch_cuda_gather import unaligned


@pytest.mark.cuda
@pytest.mark.parametrize("tomb", [False, True], ids=["no_tomb", "tomb"])
@pytest.mark.parametrize("family", ["label", "range", "udf"])
def test_fused_expand_kernel_matches_plain(dev, family, tomb):  # noqa: F811
    for m in MS:
        for integer in (True, False):
            args = make_inputs(dev, family, m, 128, integer, tomb)
            before = fused_expand.launches
            d, s, f = fused_expand(*args, family=family)
            torch.cuda.synchronize()
            assert fused_expand.launches == before + 1
            pd, ps, pf = fused_expand_plain(*args, family=family)
            assert_dists(d, pd, integer)
            assert s.dtype == torch.bool and torch.equal(s, ps) and torch.equal(f, pf)
            # One reduction serves both kernels: identical distance bits.
            assert torch.equal(d, gather_distance_cuda(*args[:3]))


def check_against_gather(args, family):
    """fused_expand_cuda's distances == gather_distance_cuda's (bits), its
    masks == the plain version's."""
    d, s, f = fused_expand_cuda(*args, family=family)
    torch.cuda.synchronize()
    _, ps, pf = fused_expand_plain(*args, family=family)
    assert torch.equal(d, gather_distance_cuda(*args[:3]))
    assert torch.equal(s, ps) and torch.equal(f, pf)
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
def test_fused_expand_paths_match_gather_distance(dev, integer):  # noqa: F811
    for d in (1, 3, 128, 256, 1000):
        for m in (1, 45, 128):
            for family, tomb in (("label", False), ("range", True)):
                args = list(make_inputs(dev, family, m, d, integer, tomb, seed=d + m))
                args[2][1] = -1  # a query row of padding only
                got = check_against_gather(args, family)
                assert torch.isinf(got[1]).all()
                assert_dists(got, fused_expand_plain(*args, family=family)[0], integer)
                # The shared-memory path (an unaligned query row) gives the same bits.
                args[0] = unaligned(args[0])
                assert torch.equal(got, check_against_gather(args, family)), (d, m, family)


@pytest.mark.cuda
@pytest.mark.parametrize("n_labels", [32, 2016], ids=["lw1", "lw63"])
def test_fused_expand_label_rows(dev, n_labels):  # noqa: F811
    for d in (128, 13):
        for m in (1, 45, 128):
            q, x, ids, visited, _, _, tombs = make_inputs(dev, "label", m, d, False, False, seed=m)
            gen = torch.Generator(device=dev).manual_seed(n_labels + m)
            n = x.shape[0]
            meta = torch.randint(0, n_labels, (n,), generator=gen, dtype=torch.int32, device=dev)
            meta[31] = n_labels - 1  # bit 31 of the row's last word
            meta[32] = 31  # bit 31 of word 0
            ids[:, -1] = 32  # ids[:, 0] is 31 (make_inputs)
            cons = torch.randint(-2**31, 2**31, (q.shape[0], n_words(n_labels)), generator=gen,
                                 dtype=torch.int64, device=dev).to(torch.int32)
            cons[:, 0] |= -2**31  # bit 31 set: label 31 satisfies every query
            cons[:, -1] |= -2**31
            args = (q, x, ids, visited, meta, cons, tombs)
            check_against_gather(args, "label")
            _, sat, _ = fused_expand_cuda(q, x, ids, visited, meta, cons, family="label")
            valid = ids >= 0
            assert sat[:, 0][valid[:, 0]].all() and sat[:, -1][valid[:, -1]].all()
