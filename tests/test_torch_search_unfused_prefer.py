"""Port vs reference, unfused path with the distance kernel
(``use_kernel=True``), mode "prefer": ids, dists and every stat equal on the
integer world (test_torch_parity_world.py)."""
import pytest

from test_torch_parity_world import (  # noqa: F401 (torch_threads is an autouse fixture)
    BEAMS,
    FAMILIES,
    assert_same,
    run_pair,
    torch_threads,
)


@pytest.mark.parametrize("beam", BEAMS)
@pytest.mark.parametrize("family", FAMILIES)
def test_unfused_matches_reference(family, beam):
    assert_same(*run_pair("prefer", family, beam, "off"))
