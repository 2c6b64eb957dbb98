"""Port vs reference, PQ traversal (``approx="pq"``: ADC distances over the
integer PQ world of test_torch_pq_world.py, exact re-rank after the loop),
mode "prefer", beam 1: ids, dists and every stat equal bit for bit,
unfused (``PQBackend.distances``) and fused (``fused_expand_adc``); the
port's fused result also equals its own unfused result. The PQ matrix is
split over five files so that each stays well under a minute."""
import pytest

from test_torch_parity_world import (  # noqa: F401 (torch_threads is an autouse fixture)
    FAMILIES,
    assert_port_equal,
    assert_same,
    torch_threads,
)
from test_torch_pq_world import run_pq_pair, run_pq_port


@pytest.mark.parametrize("fuse", ("off", "on"))
@pytest.mark.parametrize("family", FAMILIES)
def test_pq_search_matches_reference(family, fuse):
    ref, port = run_pq_pair("prefer", family, 1, fuse)
    assert_same(ref, port)
    if fuse == "on":
        assert_port_equal(port, run_pq_port("prefer", family, 1, "off"))
