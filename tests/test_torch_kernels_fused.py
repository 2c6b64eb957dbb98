"""fused_expand's plain version against the reference kernel (interpret
mode) and its ``ref.py`` for the range and UDF families; the label family
and the shared fixture live in test_torch_kernels.py."""
import pytest

from test_torch_kernels import (  # noqa: F401 (torch_threads is an autouse fixture)
    check_fused_plain_against_reference,
    torch_threads,
)


@pytest.mark.parametrize("tomb", [False, True], ids=["no_tomb", "tomb"])
@pytest.mark.parametrize("family", ["range", "udf"])
def test_fused_expand_plain_matches_reference(family, tomb):
    check_fused_plain_against_reference(family, tomb)
