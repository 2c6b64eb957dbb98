"""The port's kernels against the reference's Pallas kernels.

On the CPU the port's wrappers take their plain versions; they are held
against the reference kernel run in interpret mode and against its
``ref.py``, across the three constraint families (range and UDF in
test_torch_kernels_fused.py) x tombstones {none, bitmap} x M in
{1, 16, 48, 130}, with padding ids and with visited, label
and tombstone words that have bit 31 set. Distances are exact on
integer-valued inputs and within 1e-6 relative on float inputs (the sums
run in another order); masks are always exact.

The CUDA kernels are held against these plain versions on the card by
test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_expand.fused_expand import fused_expand_kernel
from repro.kernels.fused_expand.ref import fused_expand_ref
from repro.kernels.gather_distance.gather_distance import gather_distance_kernel
from repro.kernels.gather_distance.ref import gather_distance_ref
from repro_torch.kernels import dispatch
from repro_torch.kernels.fused_expand import fused_expand, fused_expand_cuda, fused_expand_plain
from repro_torch.kernels.gather_distance import (
    gather_distance,
    gather_distance_cuda,
    gather_distance_plain,
)
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse fixture)

B, N, D, L = 3, 300, 16, 40
MS = (1, 16, 48, 130)


def _words(rng, shape):
    """uint32 words over the full range, so bit 31 is set in about half."""
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def make_inputs(family, m, integer, tomb, seed=0):
    """numpy inputs for both sides; ids hit bit 31 of their words and pad."""
    rng = np.random.default_rng(seed)
    if integer:
        q = rng.integers(-8, 9, size=(B, D)).astype(np.float32)
        x = rng.integers(-8, 9, size=(N, D)).astype(np.float32)
    else:
        q = rng.standard_normal((B, D)).astype(np.float32)
        x = rng.standard_normal((N, D)).astype(np.float32)
    ids = rng.integers(-2, N, size=(B, m)).astype(np.int32)
    ids[:, 0] = 31  # bit 31 of visited / tombstone word 0
    if m > 2:
        ids[:, 1] = -1
    visited = _words(rng, (B, (N + 31) // 32))
    if family == "label":
        meta = rng.integers(0, L, size=N).astype(np.int32)
        meta[31] = 31  # bit 31 of label word 0
        cons = _words(rng, (B, (L + 31) // 32))
    elif family == "range":
        meta = rng.integers(0, 20, size=N).astype(np.float32)
        lo = rng.integers(0, 10, size=B).astype(np.float32)
        cons = np.stack([lo, lo + 6], -1)
    else:
        meta = rng.integers(-1, 2, size=N).astype(np.int32)
        cons = np.zeros((1, 1), np.int32)
    tombs = _words(rng, ((N + 31) // 32,)) if tomb else None
    return q, x, ids, visited, meta, cons, tombs


def _port_args(q, x, ids, visited, meta, cons, tombs, device="cpu"):
    def t(a):
        a = np.asarray(a)
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a.copy()).to(device)

    return (t(q), t(x), t(ids), t(visited), t(meta), t(cons),
            None if tombs is None else t(tombs))


def _assert_dists(ref, port, integer):
    ref = np.asarray(ref)
    port = port.cpu().numpy()
    np.testing.assert_array_equal(np.isinf(ref), np.isinf(port))
    if integer:
        np.testing.assert_array_equal(ref, port)
    else:
        fin = np.isfinite(ref)
        np.testing.assert_allclose(port[fin], ref[fin], rtol=1e-6, atol=0)


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
def test_gather_distance_plain_matches_reference(integer):
    for m in MS:
        q, x, ids, *_ = make_inputs("label", m, integer, False)
        port = gather_distance(*_port_args(q, x, ids, *[np.zeros(1)] * 3, None)[:3])
        assert port.dtype == torch.float32 and port.shape == (B, m)
        kernel = gather_distance_kernel(jnp.asarray(q), jnp.asarray(x), jnp.asarray(ids),
                                        interpret=True)
        _assert_dists(kernel, port, integer)
        _assert_dists(gather_distance_ref(jnp.asarray(q), jnp.asarray(x), jnp.asarray(ids)),
                      port, integer)
        assert np.all(np.isinf(port.numpy()[ids < 0]))


def check_fused_plain_against_reference(family, tomb):
    """Every M of ``MS``, integer and float inputs, one family and tombstone
    setting."""
    for m in MS:
        for integer in (True, False):
            _check_fused_case(family, tomb, m, integer)


def _check_fused_case(family, tomb, m, integer):
    inputs = make_inputs(family, m, integer, tomb)
    q, x, ids, visited, meta, cons, tombs = inputs
    d, sat, fresh = fused_expand(*_port_args(*inputs), family=family)
    assert sat.dtype == torch.bool and fresh.dtype == torch.bool
    j = [jnp.asarray(a) for a in (q, x, ids, visited, meta, cons)]
    jt = None if tombs is None else jnp.asarray(tombs)
    dk, sk, fk = fused_expand_kernel(*j, jt, family=family, interpret=True)
    dr, sr, fr = fused_expand_ref(*j, jt, family=family)
    for ref_d, ref_s, ref_f in ((dk, sk, fk), (dr, sr, fr)):
        _assert_dists(ref_d, d, integer)
        np.testing.assert_array_equal(np.asarray(ref_s).astype(bool), sat.numpy())
        np.testing.assert_array_equal(np.asarray(ref_f).astype(bool), fresh.numpy())
    pad = ids < 0
    assert not sat.numpy()[pad].any() and not fresh.numpy()[pad].any()


@pytest.mark.parametrize("tomb", [False, True], ids=["no_tomb", "tomb"])
def test_fused_expand_label_plain_matches_reference(tomb):
    check_fused_plain_against_reference("label", tomb)


def test_fused_distances_equal_gather_distance_on_cpu():
    q, x, ids, visited, meta, cons, _ = _port_args(*make_inputs("label", 48, False, False))
    d, _, _ = fused_expand(q, x, ids, visited, meta, cons, family="label")
    torch.testing.assert_close(d, gather_distance(q, x, ids), rtol=0, atol=0)


def test_dispatch_takes_plain_version_on_cpu_and_raises_elsewhere():
    cpu = torch.device("cpu")
    assert dispatch(cpu, gather_distance_cuda, gather_distance_plain) is gather_distance_plain
    assert dispatch(torch.device("cuda"), fused_expand_cuda, fused_expand_plain) is \
        fused_expand_cuda
    # meta tensors (the dry run's shapes) take the plain version too
    assert dispatch(torch.device("meta"), gather_distance_cuda, gather_distance_plain) is \
        gather_distance_plain
    with pytest.raises(RuntimeError):
        dispatch(torch.device("mps"), gather_distance_cuda, gather_distance_plain)


def test_cpu_calls_do_not_count_launches():
    before = (gather_distance.launches, fused_expand.launches)
    args = _port_args(*make_inputs("udf", 16, True, False))
    gather_distance(*args[:3])
    fused_expand(*args, family="udf")
    assert (gather_distance.launches, fused_expand.launches) == before


def test_plain_fused_rejects_unknown_family():
    args = _port_args(*make_inputs("label", 16, True, False))
    with pytest.raises(ValueError):
        fused_expand(*args, family="bogus")
