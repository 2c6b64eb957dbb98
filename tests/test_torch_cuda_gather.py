"""gather_distance's two paths against its plain version and against
fused_expand's distances, on the card.

The register path (d % 4 == 0, 16-byte aligned rows and queries,
d <= 256: a warp owns several candidates of one query) and the
shared-memory path (any other d, or an unaligned query row) both add in
sqdist.cuh's order, so they give the same bits as each other and as
fused_expand (which runs the same sqdist.cuh code) on float inputs too. Against the
plain version: exact on integer-valued inputs, within 1e-5 relative on
float inputs (another order of additions). M runs over counts that are
not multiples of the candidates a warp owns; one query row is all padding.

Marked ``cuda``; each test skips where there is no CUDA device. JAX-free:

    python -m pytest -m cuda tests/test_torch_cuda*.py
"""
import pytest
import torch

from repro_torch.kernels.fused_expand import fused_expand_cuda
from repro_torch.kernels.gather_distance import gather_distance_cuda, gather_distance_plain
from test_torch_cuda import assert_dists, dev  # noqa: F401 (dev is a fixture)

B, N = 12, 3000


def unaligned(t):
    """The same values at an address 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 128, 256, 1000])
def test_gather_distance_paths_match_plain_and_fused(dev, d):  # noqa: F811
    gen = torch.Generator(device=dev).manual_seed(d)
    for integer in (True, False):
        if integer:
            q = torch.randint(-8, 9, (B, d), generator=gen, device=dev).float()
            x = torch.randint(-8, 9, (N, d), generator=gen, device=dev).float()
        else:
            q = torch.randn((B, d), generator=gen, device=dev)
            x = torch.randn((N, d), generator=gen, device=dev)
        for m in (1, 3, 7, 9, 45, 130):
            ids = torch.randint(-2, N, (B, m), generator=gen, dtype=torch.int32, device=dev)
            ids[1] = -1  # a row of padding only
            got = gather_distance_cuda(q, x, ids)
            torch.cuda.synchronize()
            assert_dists(got, gather_distance_plain(q, x, ids), integer)
            assert torch.isinf(got[1]).all()
            # The shared-memory path (unaligned query rows) gives the same bits.
            assert torch.equal(got, gather_distance_cuda(unaligned(q), x, ids))
            visited = torch.zeros((B, (N + 31) // 32), dtype=torch.int32, device=dev)
            meta = torch.zeros(N, dtype=torch.int32, device=dev)
            cons = torch.ones((B, 1), dtype=torch.int32, device=dev)
            fd, _, _ = fused_expand_cuda(q, x, ids, visited, meta, cons, family="label")
            assert torch.equal(got, fd), (d, m, integer)
