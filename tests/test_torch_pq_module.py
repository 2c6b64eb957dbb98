"""``repro_torch.core.pq`` and the PQ backend against the reference module
level: the ADC table, codebook training, ``default_m_sub``, the backend's
unfused distances and the carry-across of a reference ``PQIndex``.

``pq_train`` draws its k-means starts from a ``torch.Generator`` and the
reference from threefry keys, so the two train different codebooks on the
same data: the port's codes must be the argmin over its own codebooks, and
its mean quantisation error within 10% of the reference's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core.engine.context import PQBackend as RefPQBackend
from repro.core.pq import PQIndex as RefPQIndex
from repro.core.pq import adc_table as ref_adc_table
from repro.core.pq import default_m_sub as ref_default_m_sub
from repro.core.pq import pq_train as ref_pq_train
from repro_torch.core.pq import adc_table, default_m_sub
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse fixture)


@functools.lru_cache(maxsize=1)
def blobs():
    """(2000, 16) float32 Gaussian blobs around 8 centres."""
    rng = np.random.default_rng(3)
    centres = rng.standard_normal((8, 16))
    x = centres[rng.integers(0, 8, 2000)] + 0.3 * rng.standard_normal((2000, 16))
    return x.astype(np.float32)


def _decode(codebooks, codes):
    """(n, m_sub) codes -> (n, d) reconstruction."""
    return np.concatenate([codebooks[s][codes[:, s]] for s in range(codes.shape[1])], -1)


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
def test_adc_table_matches_reference(integer):
    rng = np.random.default_rng(4)
    for b, m_sub, n_cent, d_sub in ((5, 4, 16, 2), (3, 16, 256, 8)):
        if integer:
            cb = rng.integers(-6, 7, size=(m_sub, n_cent, d_sub)).astype(np.float32)
            q = rng.integers(-6, 7, size=(b, m_sub * d_sub)).astype(np.float32)
        else:
            cb = rng.standard_normal((m_sub, n_cent, d_sub)).astype(np.float32)
            q = rng.standard_normal((b, m_sub * d_sub)).astype(np.float32)
        codes = np.zeros((2, m_sub), np.int32)
        ref = np.asarray(jax.jit(ref_adc_table)(
            RefPQIndex(codebooks=jnp.asarray(cb), codes=jnp.asarray(codes)), jnp.asarray(q)))
        port = adc_table(rt.pq_index_from_reference(codebooks=cb, codes=codes, device="cpu"),
                         torch.from_numpy(q))
        assert port.shape == (b, m_sub, n_cent) and port.dtype == torch.float32
        if integer:
            np.testing.assert_array_equal(ref, port.numpy())
        else:
            np.testing.assert_allclose(port.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_pq_train_codes_are_argmin_and_error_matches_reference():
    x = blobs()
    m_sub, n_cent = 4, 16
    index = rt.pq_train(torch.Generator().manual_seed(0), torch.from_numpy(x), m_sub=m_sub,
                        n_cent=n_cent, iters=10)
    cb, codes = index.codebooks.numpy(), index.codes.numpy()
    assert cb.shape == (m_sub, n_cent, 4) and codes.shape == (2000, m_sub)
    assert index.codes.dtype == torch.int32 and index.codes.is_contiguous()
    sub = x.reshape(-1, m_sub, 1, 4)
    np.testing.assert_array_equal(codes, ((sub - cb[None]) ** 2).sum(-1).argmin(-1))
    ref = ref_pq_train(jax.random.PRNGKey(0), jnp.asarray(x), m_sub=m_sub, n_cent=n_cent,
                       iters=10)
    err = ((x - _decode(cb, codes)) ** 2).sum(-1).mean()
    ref_err = ((x - _decode(np.asarray(ref.codebooks), np.asarray(ref.codes))) ** 2).sum(-1).mean()
    assert abs(err - ref_err) <= 0.1 * ref_err, (err, ref_err)
    with pytest.raises(ValueError, match="divisible"):
        rt.pq_train(torch.Generator(), torch.from_numpy(x), m_sub=3)


def test_default_m_sub_matches_reference():
    for d in (128, 24, 12, 10, 7, 1):
        assert default_m_sub(d) == ref_default_m_sub(d)


def test_pq_backend_matches_reference_backend():
    """distances (padding scores row 0), sample_distances and scan_all on a
    float LUT: within 1e-6 relative of the reference's backend."""
    rng = np.random.default_rng(6)
    lut = (rng.standard_normal((4, 8, 32)) ** 2).astype(np.float32)
    codes = rng.integers(0, 32, size=(500, 8)).astype(np.int32)
    ids = rng.integers(-1, 500, size=(4, 40)).astype(np.int32)
    sample = rng.integers(0, 500, size=(17,)).astype(np.int32)
    ref = RefPQBackend(codes=jnp.asarray(codes), lut=jnp.asarray(lut))
    port = rt.PQBackend(codes=torch.from_numpy(codes), lut=torch.from_numpy(lut))
    assert port.fusable and port.approximate
    for r, p in ((ref.distances(None, jnp.asarray(ids)), port.distances(None, torch.from_numpy(ids))),
                 (ref.sample_distances(None, jnp.asarray(sample)),
                  port.sample_distances(None, torch.from_numpy(sample))),
                 (ref.scan_all(), port.scan_all())):
        assert p.shape == r.shape
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-6, atol=0)
