"""The integer-valued PQ world shared by the port's PQ parity tests, and the
PQ linear scan and three-stage pipeline held against the reference on it.

The world of test_torch_parity_world.py gets a ``PQIndex`` built in numpy:
small-integer codebooks (m_sub = 4, n_cent = 16, d_sub = 2) and codes set
to the argmin over them. Every LUT entry, ADC sum and re-rank distance is
then an exact integer in float32, so summation order cannot change a bit
and any difference between the reference and the port is a fault. The
same arrays go to the reference's ``PQIndex`` and, through
``pq_index_from_reference``, to the port's. The PQ search files import
``run_pq_pair`` and ``run_pq_port`` from here.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import SearchParams as RefParams
from repro.core import constrained_search as ref_search
from repro.core.pipeline import three_stage_pipeline as ref_pipeline
from repro.core.pq import PQIndex as RefPQIndex
from repro.core.pq import adc_table as ref_adc_table
from repro.core.pq import pq_constrained_search as ref_pq_search
from repro_torch.core.pq import adc_table
from test_torch_parity_world import (  # noqa: F401 (torch_threads is an autouse fixture)
    D,
    N,
    int_world,
    params_kw,
    torch_threads,
)

M_SUB, N_CENT = 4, 16


@functools.lru_cache(maxsize=1)
def pq_world():
    """(reference PQIndex, port PQIndex, codebooks, codes) over int_world()."""
    rng = np.random.default_rng(5)
    codebooks = rng.integers(-6, 7, size=(M_SUB, N_CENT, D // M_SUB)).astype(np.float32)
    vec = int_world()["port"][0].vectors.numpy()
    sub = vec.reshape(N, M_SUB, 1, D // M_SUB)
    codes = ((sub - codebooks[None]) ** 2).sum(-1).argmin(-1).astype(np.int32)
    codes[0], codes[1] = 0, N_CENT - 1  # the extreme codes, whatever the argmin says
    ref = RefPQIndex(codebooks=jnp.asarray(codebooks), codes=jnp.asarray(codes))
    port = rt.pq_index_from_reference(codebooks=codebooks, codes=codes, device="cpu")
    return ref, port, codebooks, codes


def pq_params(mode, beam, fuse):
    return dict(params_kw(mode, beam, fuse), approx="pq")


def run_pq_port(mode, family, beam, fuse):
    w = int_world()
    corpus, graph, queries = w["port"]
    return rt.constrained_search(corpus, graph, queries, w["cons"][family][1],
                                 rt.SearchParams(**pq_params(mode, beam, fuse)),
                                 entry=w["entry"], pq_index=pq_world()[1])


def run_pq_pair(mode, family, beam, fuse):
    """(reference result, port result) of one PQ configuration."""
    w = int_world()
    corpus, graph, queries = w["ref"]
    rng = jax.random.PRNGKey(7) if mode == "vanilla" else None
    ref = ref_search(corpus, graph, queries, w["cons"][family][0],
                     RefParams(**pq_params(mode, beam, fuse)), rng=rng, pq_index=pq_world()[0])
    return ref, run_pq_port(mode, family, beam, fuse)


def test_pq_world_is_integer_valued_and_carried_bit_for_bit():
    ref_pq, port_pq, codebooks, codes = pq_world()
    assert port_pq.codes.dtype == torch.int32 and port_pq.codebooks.dtype == torch.float32
    np.testing.assert_array_equal(port_pq.codes.numpy(), codes)
    np.testing.assert_array_equal(port_pq.codebooks.numpy(), np.asarray(ref_pq.codebooks))
    assert codes.min() == 0 and codes.max() == N_CENT - 1
    queries = int_world()["port"][2]
    lut = adc_table(port_pq, queries)
    assert lut.shape == (queries.shape[0], M_SUB, N_CENT)
    np.testing.assert_array_equal(lut.numpy(), np.round(lut.numpy()))
    np.testing.assert_array_equal(
        np.asarray(jax.jit(ref_adc_table)(ref_pq, jnp.asarray(queries.numpy()))), lut.numpy())


@pytest.mark.parametrize("family", ("label", "range"))
def test_pq_scan_matches_reference(family):
    """Ids, ADC distances and the order among the many exact ties equal the
    reference's, through the plain scan and the ``pq_adc`` path. (The
    reference's scan is jitted with the constraint as data, so it takes no
    UDF.)"""
    w = int_world()
    ref_corpus, _, ref_q = w["ref"]
    corpus, _, queries = w["port"]
    ref_pq, port_pq, _, _ = pq_world()
    k = 40
    ref_d, ref_i = ref_pq_search(ref_corpus, ref_pq, ref_q, w["cons"][family][0], k=k,
                                 use_kernel=True)
    ref_d, ref_i = np.asarray(ref_d), np.asarray(ref_i)
    assert (np.diff(ref_d[:, :k], axis=-1) == 0).any()  # ties are exercised
    for use_kernel in (False, True):
        d, i = rt.pq_constrained_search(corpus, port_pq, queries, w["cons"][family][1], k=k,
                                        use_kernel=use_kernel)
        assert i.dtype == torch.int32 and d.shape == (queries.shape[0], k)
        np.testing.assert_array_equal(ref_i, i.numpy())
        np.testing.assert_array_equal(ref_d, d.numpy())


@pytest.mark.parametrize("family", ("label", "range"))
def test_three_stage_pipeline_matches_reference(family):
    w = int_world()
    ref_corpus, ref_graph, ref_q = w["ref"]
    corpus, graph, queries = w["port"]
    for s, k in ((20, 10), (48, 8)):
        ref = ref_pipeline(ref_corpus, ref_graph, ref_q, w["cons"][family][0], s=s, k=k)
        port = rt.three_stage_pipeline(corpus, graph, queries, w["cons"][family][1], s=s, k=k)
        for a, b in zip(ref, port):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert port[2].dtype == torch.int32


def test_pq_search_needs_an_index():
    w = int_world()
    corpus, graph, queries = w["port"]
    with pytest.raises(ValueError, match="pq_index"):
        rt.constrained_search(corpus, graph, queries, w["cons"]["label"][1],
                              rt.SearchParams(**pq_params("prefer", 1, "off")))


def test_pq_result_is_reranked_exactly():
    """The answer's distances are exact squared L2 (not ADC), ascending,
    with (+inf, -1) only in unfilled slots."""
    res = run_pq_port("prefer", "label", 1, "off")
    corpus, _, queries = int_world()["port"]
    ids, dists = res.ids, res.dists
    valid = ids >= 0
    exact = ((corpus.vectors[ids.clamp_min(0).long()] - queries[:, None]) ** 2).sum(-1)
    torch.testing.assert_close(dists[valid], exact[valid], rtol=0, atol=0)
    assert torch.isinf(dists[~valid]).all()
    assert (dists[:, 1:] >= dists[:, :-1]).all()
