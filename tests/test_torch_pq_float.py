"""The port's PQ path against the reference on the float world of
tests/test_engine_beam.py (n = 4000, d = 24, 10 k-means labels, degree 16,
24 queries), with codebooks trained by the reference's ``pq_train``
(m_sub = 8, n_cent = 32) and carried across. Float LUTs and ADC sums are
added in another order in the two frameworks, so walks may part at a near
tie: the stated tolerance is that of the exact path (test_torch_search_
float.py), a mean top-10 id overlap of at least 0.95 and a recall@10
within 0.02 of the reference's, both against the reference's exact oracle.
"""
import functools

import jax
import numpy as np
import pytest

import repro_torch as rt
from repro.core import SearchParams as RefParams
from repro.core import constrained_search as ref_search
from repro.core import recall as ref_recall
from repro.core.pq import pq_constrained_search as ref_pq_search
from repro.core.pq import pq_train as ref_pq_train
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse fixture)
from test_torch_search_float import _overlap, _params, float_world


@functools.lru_cache(maxsize=1)
def float_pq():
    corpus = float_world()["ref"][0]
    ref = ref_pq_train(jax.random.PRNGKey(9), corpus.vectors, m_sub=8, n_cent=32)
    port = rt.pq_index_from_reference(codebooks=np.asarray(ref.codebooks),
                                      codes=np.asarray(ref.codes), device="cpu")
    return ref, port


def _close_enough(ref_ids, port_ids):
    true = float_world()["true_ids"]
    assert _overlap(port_ids, ref_ids) >= 0.95
    ref_r = float(ref_recall(jax.numpy.asarray(ref_ids), true))
    port_r = float(ref_recall(jax.numpy.asarray(port_ids), true))
    assert abs(port_r - ref_r) <= 0.02, (port_r, ref_r)


@pytest.mark.parametrize("mode,beam,fuse", [
    ("vanilla", 1, "off"), ("alter", 1, "off"), ("prefer", 1, "off"), ("prefer", 1, "on"),
    ("prefer", 4, "off"),
])
def test_float_pq_search_within_tolerance(mode, beam, fuse):
    w = float_world()
    corpus, graph, queries, cons = w["ref"]
    ref_pq, port_pq = float_pq()
    kw = dict(_params(mode, beam, fuse), approx="pq")
    rng = jax.random.PRNGKey(7) if mode == "vanilla" else None
    ref = ref_search(corpus, graph, queries, cons, RefParams(**kw), rng=rng, pq_index=ref_pq)
    t_corpus, t_graph, t_cons = w["port"]
    port = rt.constrained_search(t_corpus, t_graph, w["queries"], t_cons, rt.SearchParams(**kw),
                                 entry=w["entry"], pq_index=port_pq)
    _close_enough(np.asarray(ref.ids), port.ids.numpy())
    # Both answers are re-ranked exactly: distances agree where ids do.
    same = np.asarray(ref.ids) == port.ids.numpy()
    fin = same & np.isfinite(np.asarray(ref.dists))
    np.testing.assert_allclose(port.dists.numpy()[fin], np.asarray(ref.dists)[fin], rtol=1e-4)


def test_float_pq_scan_within_tolerance():
    w = float_world()
    corpus, _, queries, cons = w["ref"]
    ref_pq, port_pq = float_pq()
    ref_d, ref_i = ref_pq_search(corpus, ref_pq, queries, cons, k=10, use_kernel=True)
    t_corpus, _, t_cons = w["port"]
    port_d, port_i = rt.pq_constrained_search(t_corpus, port_pq, w["queries"], t_cons, k=10,
                                              use_kernel=True)
    _close_enough(np.asarray(ref_i), port_i.numpy())
    np.testing.assert_allclose(port_d.numpy(), np.asarray(ref_d), rtol=1e-5)
