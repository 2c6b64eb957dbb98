"""The port against the reference on the float world of
tests/test_engine_beam.py (n = 4000, d = 24, 10 k-means labels, degree 16,
24 queries). Float sums run in another order in the two frameworks, so
traversals may part at a near tie; the stated tolerance is a mean top-10 id
overlap of at least 0.95 and a recall@10 within 0.02 of the reference's,
both against the reference's exact oracle."""
import functools

import jax
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import SearchParams as RefParams
from repro.core import constrained_search as ref_search
from repro.core import equal_constraint as ref_equal
from repro.core import exact_constrained_search as ref_exact
from repro.core import recall as ref_recall
from repro.data.synthetic import make_labeled_corpus, make_queries
from repro.graph.index import build_index
from repro_torch.interop import from_reference_arrays
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse fixture)

N, D, L, NQ = 4000, 24, 10, 24


@functools.lru_cache(maxsize=1)
def float_world():
    corpus = make_labeled_corpus(jax.random.PRNGKey(0), n=N, d=D, n_labels=L)
    graph = build_index(jax.random.PRNGKey(1), corpus, degree=16, sample_size=256)
    queries, qlab = make_queries(jax.random.PRNGKey(2), corpus, NQ)
    cons = ref_equal(qlab, L)
    t_corpus, t_graph, t_cons = from_reference_arrays(
        vectors=np.asarray(corpus.vectors), labels=np.asarray(corpus.labels),
        neighbors=np.asarray(graph.neighbors), sample_ids=np.asarray(graph.sample_ids),
        entry_point=np.asarray(graph.entry_point), label_words=np.asarray(cons.words),
        device="cpu")
    _, true_ids = ref_exact(corpus, queries, cons, 10)
    entry = jax.random.randint(jax.random.PRNGKey(7), (NQ,), 0, N, dtype=jax.numpy.int32)
    return dict(ref=(corpus, graph, queries, cons), port=(t_corpus, t_graph, t_cons),
                queries=torch.from_numpy(np.array(queries)), true_ids=true_ids,
                entry=torch.from_numpy(np.array(entry)))


def _params(mode, beam, fuse):
    return dict(mode=mode, k=10, ef_result=128, ef_sat=128, ef_other=128, n_start=16,
                max_iters=800, beam_width=beam, fuse_expand=fuse, use_kernel=fuse == "off")


def _overlap(a, b):
    return np.mean([len(set(x[x >= 0]) & set(y[y >= 0])) / max(1, (y >= 0).sum())
                    for x, y in zip(a, b)])


@pytest.mark.parametrize("mode,beam,fuse", [
    ("vanilla", 1, "off"), ("start", 1, "off"), ("alter", 1, "off"), ("prefer", 1, "off"),
    ("prefer", 4, "off"), ("prefer", 1, "on"),
])
def test_float_world_within_tolerance(mode, beam, fuse):
    w = float_world()
    corpus, graph, queries, cons = w["ref"]
    rng = jax.random.PRNGKey(7) if mode == "vanilla" else None
    ref = ref_search(corpus, graph, queries, cons, RefParams(**_params(mode, beam, fuse)),
                     rng=rng)
    t_corpus, t_graph, t_cons = w["port"]
    port = rt.constrained_search(t_corpus, t_graph, w["queries"], t_cons,
                                 rt.SearchParams(**_params(mode, beam, fuse)), entry=w["entry"])
    ref_ids, port_ids = np.asarray(ref.ids), port.ids.numpy()
    assert _overlap(port_ids, ref_ids) >= 0.95
    true = w["true_ids"]
    ref_r = float(ref_recall(ref.ids, true))
    port_r = float(ref_recall(jax.numpy.asarray(port_ids), true))
    assert abs(port_r - ref_r) <= 0.02, (port_r, ref_r)
    fin = np.isfinite(np.asarray(ref.dists))
    np.testing.assert_allclose(port.dists.numpy()[fin], np.asarray(ref.dists)[fin], rtol=1e-4)


def test_port_exact_oracle_matches_reference_on_float_world():
    w = float_world()
    t_corpus, _, t_cons = w["port"]
    _, port_ids = rt.exact_constrained_search(t_corpus, w["queries"], t_cons, 10, block=1024)
    assert _overlap(port_ids.numpy(), np.asarray(w["true_ids"])) >= 0.99
    assert float(rt.recall(port_ids, torch.from_numpy(np.array(w["true_ids"])))) >= 0.99
