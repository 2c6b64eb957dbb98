"""The port's PQ kernels against the reference's, on the CPU.

``pq_adc`` and ``fused_expand_adc`` take their plain versions here; they
are held against the reference's ``ref.py`` oracles and, on a few tiny
cases, its Pallas kernels in interpret mode, on shared numpy inputs: the
three constraint families x tombstones {none, bitmap} x M in {1, 16, 48,
130}, with padding ids, codes at 0 and n_cent - 1, and words with bit 31
set. Distances are exact on integer LUTs and within 1e-6 relative on float
LUTs (the reference's ``jnp.sum`` may add in another order than the port's
pinned left-to-right order); masks are always exact.

The CUDA kernels are held against these plain versions on the card by
test_torch_cuda_pq.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine.context import PQBackend as RefPQBackend
from repro.kernels.fused_expand.fused_expand import fused_expand_adc_kernel
from repro.kernels.fused_expand.ref import fused_expand_adc_ref
from repro.kernels.pq_adc.pq_adc import pq_adc_kernel
from repro.kernels.pq_adc.ref import pq_adc_ref
from repro_torch.core.engine.context import PQBackend
from repro_torch.kernels import dispatch
from repro_torch.kernels.fused_expand import (
    fused_expand_adc,
    fused_expand_adc_cuda,
    fused_expand_adc_plain,
)
from repro_torch.kernels.pq_adc import pq_adc, pq_adc_cuda, pq_adc_plain
from test_torch_kernels import B, MS, N, _assert_dists, _port_args, make_inputs
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse fixture)


def make_pq(rng, b, n, m_sub, n_cent, integer):
    """(lut (b, m_sub, n_cent), codes (n, m_sub)) with codes 0 and n_cent - 1
    in the first two rows."""
    if integer:
        lut = rng.integers(0, 300, size=(b, m_sub, n_cent)).astype(np.float32)
    else:
        lut = (rng.standard_normal((b, m_sub, n_cent)) ** 2 * 50).astype(np.float32)
    codes = rng.integers(0, n_cent, size=(n, m_sub)).astype(np.int32)
    codes[0], codes[1] = 0, n_cent - 1
    return lut, codes


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
def test_pq_adc_plain_matches_reference(integer, monkeypatch):
    rng = np.random.default_rng(0)
    for b, n, m_sub, n_cent in ((3, 257, 16, 256), (1, 1000, 8, 16), (4, 50, 4, 8)):
        lut, codes = make_pq(rng, b, n, m_sub, n_cent, integer)
        ref = pq_adc_ref(jnp.asarray(lut), jnp.asarray(codes))
        port = pq_adc(torch.from_numpy(lut), torch.from_numpy(codes))
        assert port.shape == (b, n) and port.dtype == torch.float32
        _assert_dists(ref, port, integer)
        if n == 50:  # one tiny case through the Pallas kernel, interpreted
            _assert_dists(pq_adc_kernel(jnp.asarray(lut), jnp.asarray(codes), bn=64,
                                        interpret=True), port, integer)
        # The reference's unfused scan formula gives the same numbers.
        _assert_dists(RefPQBackend(codes=jnp.asarray(codes), lut=jnp.asarray(lut)).scan_all(),
                      port, integer)
        # Chunks of rows give the same bits as one whole gather.
        monkeypatch.setattr("repro_torch.kernels.pq_adc.PLAIN_CHUNK_ELEMS", 7 * b * m_sub)
        torch.testing.assert_close(pq_adc(torch.from_numpy(lut), torch.from_numpy(codes)), port,
                                   rtol=0, atol=0)
        monkeypatch.undo()


def adc_inputs(family, m, integer, tomb, seed=0):
    """fused_expand's shared inputs (ids, visited, meta, cons, tombs) with a
    LUT and codes in place of the queries and corpus."""
    _, _, ids, visited, meta, cons, tombs = make_inputs(family, m, integer, tomb, seed)
    lut, codes = make_pq(np.random.default_rng(seed + 100), B, N, 16, 32, integer)
    return lut, codes, ids, visited, meta, cons, tombs


@pytest.mark.parametrize("tomb", [False, True], ids=["no_tomb", "tomb"])
@pytest.mark.parametrize("family", ["label", "range", "udf"])
def test_fused_expand_adc_plain_matches_reference(family, tomb):
    for m in MS:
        for integer in (True, False):
            inputs = adc_inputs(family, m, integer, tomb)
            lut, codes, ids, visited, meta, cons, tombs = inputs
            d, sat, fresh = fused_expand_adc(*_port_args(*inputs), family=family)
            assert sat.dtype == torch.bool and fresh.dtype == torch.bool
            j = [jnp.asarray(a) for a in (lut, codes, ids, visited, meta, cons)]
            jt = None if tombs is None else jnp.asarray(tombs)
            refs = [fused_expand_adc_ref(*j, jt, family=family)]
            if m == 16 and integer:
                refs.append(fused_expand_adc_kernel(*j, jt, family=family, interpret=True))
            for ref_d, ref_s, ref_f in refs:
                _assert_dists(ref_d, d, integer)
                np.testing.assert_array_equal(np.asarray(ref_s).astype(bool), sat.numpy())
                np.testing.assert_array_equal(np.asarray(ref_f).astype(bool), fresh.numpy())
            pad = ids < 0
            assert np.isinf(d.numpy()[pad]).all()
            assert not sat.numpy()[pad].any() and not fresh.numpy()[pad].any()


def test_fused_adc_distances_are_the_unfused_pq_distances():
    """The port's own contract, bit for bit on float LUTs: the fused
    distance is ``PQBackend.distances`` (which scores padding as row 0)
    with +inf on padding."""
    lut, codes, ids, visited, meta, cons, _ = _port_args(*adc_inputs("label", 48, False, False))
    d, _, _ = fused_expand_adc(lut, codes, ids, visited, meta, cons, family="label")
    unfused = PQBackend(codes=codes, lut=lut).distances(None, ids)
    torch.testing.assert_close(d, torch.where(ids >= 0, unfused, float("inf")), rtol=0, atol=0)
    row0 = PQBackend(codes=codes, lut=lut).distances(None, torch.zeros_like(ids))
    torch.testing.assert_close(unfused[ids < 0], row0[ids < 0], rtol=0, atol=0)


def test_pq_dispatch_and_cpu_calls_do_not_count_launches():
    cpu = torch.device("cpu")
    assert dispatch(cpu, pq_adc_cuda, pq_adc_plain) is pq_adc_plain
    assert dispatch(torch.device("cuda"), fused_expand_adc_cuda, fused_expand_adc_plain) is \
        fused_expand_adc_cuda
    before = (pq_adc.launches, fused_expand_adc.launches)
    args = _port_args(*adc_inputs("udf", 16, True, False))
    pq_adc(args[0], args[1])
    fused_expand_adc(*args, family="udf")
    assert (pq_adc.launches, fused_expand_adc.launches) == before
    with pytest.raises(ValueError):
        fused_expand_adc(*args, family="bogus")
