"""pq_adc's scan against its plain version at the edges of its layout, on
the card: B not a multiple of a block's query group, B = 1, a small table
(m_sub = 8, n_cent = 16: 32 queries a group), larger ones (m_sub = 32, 64
and 128: 4, 2 and 1 queries a group), N not a multiple of a block's rows,
and codes outside [0, n_cent), which read entry n_cent - 1 (the kernel
compares them as unsigned and clamps).

Every path adds the m_sub entries left to right, so the kernel equals the
plain version bit for bit on integer and float LUTs alike.

Marked ``cuda``; each test skips where there is no CUDA device. JAX-free:

    python -m pytest -m cuda tests/test_torch_cuda*.py
"""
import pytest
import torch

from repro_torch.kernels.pq_adc import pq_adc_cuda, pq_adc_plain
from test_torch_cuda import dev  # noqa: F401 (dev is a fixture)
from test_torch_cuda_pq import make_pq

# name: (B, N, m_sub, n_cent)
CASES = {
    "ragged_group": (13, 5000, 16, 256),  # groups of 8 queries: 8 + 5
    "one_query": (1, 20000, 16, 256),
    "small_table": (37, 3001, 8, 16),  # groups of 32 queries: 32 + 5
    "ragged_rows": (9, 16384 * 2 + 7, 16, 256),  # a block walks 16,384 rows
    "out_of_range_codes": (10, 4000, 16, 256),
    "four_queries_a_group": (6, 2000, 32, 256),  # 32 KB tables: groups of 4, float4 lookups
    "two_queries_a_group": (3, 1500, 64, 256),  # 64 KB tables: groups of 2, float2 lookups
    "one_table_a_block": (3, 3000, 128, 256),  # a 128 KB table: 1 query a group
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_pq_adc_layout_edges(dev, name):  # noqa: F811
    b, n, m_sub, n_cent = CASES[name]
    for integer in (True, False):
        lut, codes = make_pq(dev, b, n, m_sub, n_cent, integer, seed=len(name))
        want_codes = codes
        if name == "out_of_range_codes":
            codes = codes.clone()
            codes[5, 0], codes[6, 3], codes[-1, -1] = -1, n_cent, 2**31 - 1
            codes[7] = -(2**31)
            # An unsigned clamp, as fused_expand_adc's: any code outside
            # [0, n_cent) reads entry n_cent - 1.
            want_codes = torch.where((codes < 0) | (codes >= n_cent), n_cent - 1, codes)
        got = pq_adc_cuda(lut, codes)
        torch.cuda.synchronize()
        assert got.shape == (b, n)
        assert torch.equal(got, pq_adc_plain(lut, want_codes)), (name, integer)
