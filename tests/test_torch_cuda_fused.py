"""fused_expand's CUDA kernel against its plain version on the card, over
the three families x tombstones {none, bitmap} x M x integer / float
inputs (helpers in test_torch_cuda.py). Marked ``cuda``; skips without a
card."""
import pytest
import torch

from repro_torch.kernels.fused_expand import fused_expand, fused_expand_plain
from repro_torch.kernels.gather_distance import gather_distance_cuda
from test_torch_cuda import MS, assert_dists, dev, make_inputs  # noqa: F401 (dev is a fixture)


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
