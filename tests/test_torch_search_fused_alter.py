"""Port vs reference, fused path (``fuse_expand="on"``: one fused_expand
pass per iteration and sorted-merge queue updates), mode "alter", beam
1 and 2: ids, dists and every stat equal on the integer world
(test_torch_parity_world.py). The port's fused result also equals its own
unfused result, the reference's own contract. The fused matrix is split
over eight files so that each stays well under a minute."""
import pytest

from test_torch_parity_world import (  # noqa: F401 (torch_threads is an autouse fixture)
    FAMILIES,
    assert_port_equal,
    assert_same,
    run_pair,
    run_port,
    torch_threads,
)


@pytest.mark.parametrize("beam", (1, 2))
@pytest.mark.parametrize("family", FAMILIES)
def test_fused_matches_reference(family, beam):
    ref, port = run_pair("alter", family, beam, "on")
    assert_same(ref, port)
    assert_port_equal(port, run_port("alter", family, beam, "off"))
