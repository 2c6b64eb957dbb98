"""The port's NN-descent against the reference's, on the CPU.

``nn_descent`` is held to ``repro.graph.build.nn_descent`` bit for bit on
integer-valued vectors (every squared distance exact in float32): the test
recreates the reference's ``jax.random`` draws exactly as the reference
makes them (``k0`` from the key, per round ``cols`` from
``fold_in(key, r)`` and ``rand`` from ``fold_in(fold_in(key, r), 1)``) and
hands them to the port as ``draws``. ``_dedup_sorted_by_dist`` is held to
the reference's directly, on rows with duplicates, padding and distance
ties. The port's own ``build_index(method="nn_descent")`` is held to the
graph invariants, and its kNN recall against the exact graph to the
reference's on float data.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph.build import _dedup_sorted_by_dist as ref_dedup
from repro.graph.build import nn_descent as ref_nn_descent
from repro_torch.data import make_labeled_corpus
from repro_torch.graph import build_index, build_knn_graph, nn_descent
from repro_torch.graph.build import _dedup_sorted_by_dist, span_seconds
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse fixture)


def reference_draws(key, n, degree, iters, n_extra):
    """The reference's random ints, drawn as repro/graph/build.py draws them."""
    k0 = jax.random.randint(key, (n, degree), 0, n, dtype=jnp.int32)
    cols, rand = [], []
    for r in range(iters):
        key_r = jax.random.fold_in(key, r)
        cols.append(jax.random.randint(key_r, (n, degree, n_extra), 0, degree))
        rand.append(jax.random.randint(jax.random.fold_in(key_r, 1), (n, degree), 0, n,
                                       dtype=jnp.int32))
    as_t = lambda a: torch.from_numpy(np.array(a))
    return dict(k0=as_t(k0), cols=[as_t(c) for c in cols], rand=[as_t(r) for r in rand])


def graph_invariants(vec, nbrs):
    """Self-free, duplicate-free, distance-ascending, padding only at the
    end of a row, no empty row."""
    n = vec.shape[0]
    assert nbrs.dtype == np.int32
    assert not (nbrs == np.arange(n)[:, None]).any()
    valid = nbrs >= 0
    assert (valid[:, :-1] | ~valid[:, 1:]).all()  # once PAD, PAD to the end
    assert valid[:, 0].all()
    for row in nbrs:
        ids = row[row >= 0]
        assert len(set(ids.tolist())) == len(ids)
    d = ((vec[np.maximum(nbrs, 0)] - vec[:, None, :]) ** 2).sum(-1)
    d = np.where(valid, d, np.inf)
    assert (d[:, 1:] >= d[:, :-1]).all()


@pytest.mark.parametrize("n,d,degree,iters,n_extra", [
    (203, 5, 8, 3, 2),
    (500, 7, 12, 8, 2),  # the reference's default rounds
    (300, 4, 8, 2, 1),
    (6, 2, 8, 2, 2),  # fewer vertices than degree: rows end in PAD
])
def test_nn_descent_equals_reference_bit_for_bit(n, d, degree, iters, n_extra):
    vec = np.random.default_rng(n).integers(-4, 5, size=(n, d)).astype(np.float32)
    key = jax.random.PRNGKey(n + iters)
    want = np.asarray(ref_nn_descent(key, jnp.asarray(vec), degree, iters=iters,
                                     n_extra=n_extra))
    got = nn_descent(None, torch.from_numpy(vec), degree, iters=iters, n_extra=n_extra,
                     draws=reference_draws(key, n, degree, iters, n_extra), device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    graph_invariants(vec, got.numpy())


def test_dedup_sorted_by_dist_equals_reference():
    rng = np.random.default_rng(7)
    ids = rng.integers(-1, 12, size=(64, 24)).astype(np.int32)  # duplicates and PAD
    # Distance ties; a duplicate id carries the same distance, as row-wise
    # distances do.
    dists = np.take_along_axis(rng.integers(0, 6, size=(64, 12)).astype(np.float32),
                               np.maximum(ids, 0), -1)
    dists[::5, 3] = np.inf
    ref = jax.jit(functools.partial(ref_dedup, degree=8))
    want_i, want_d = (np.asarray(a) for a in ref(jnp.asarray(ids), jnp.asarray(dists)))
    got_i, got_d = _dedup_sorted_by_dist(torch.from_numpy(ids), torch.from_numpy(dists), 8)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_d.numpy(), want_d)


def knn_recall(graph, exact):
    return sum(len(set(a) & set(b)) for a, b in zip(graph.tolist(), exact.tolist())) / exact.size


def test_build_index_nn_descent_invariants():
    g = torch.Generator().manual_seed(3)
    corpus = make_labeled_corpus(g, 700, 8, 10, device="cpu")
    vec = corpus.vectors.numpy()
    for reverse in (False, True):
        spans = {}
        index = build_index(g, corpus, degree=8, sample_size=32, method="nn_descent",
                            reverse_edges=reverse, nn_descent_iters=4, device="cpu",
                            spans=spans)
        seconds = span_seconds(spans)
        assert set(seconds) == ({"nn_descent", "distances", "sorts"}
                                | ({"reverse_edges"} if reverse else set()))
        assert all(t > 0 for t in seconds.values())
        assert index.neighbors.shape == (700, 8)
        graph_invariants(vec, index.neighbors.numpy())
        assert index.entry_point.dim() == 0 and len(torch.unique(index.sample_ids)) == 32
    with pytest.raises(ValueError, match="method"):
        build_index(g, corpus, method="hnsw", device="cpu")


def test_knn_recall_matches_reference():
    """Statistical parity on float clustered data: the two draw different
    random ints, so their graphs differ, but their kNN recall against the
    exact graph must not (within 0.05 over two seeds each)."""
    rng = np.random.default_rng(0)
    cent = rng.standard_normal((10, 8)).astype(np.float32)
    vec = (cent[rng.integers(0, 10, 600)] + 0.3 * rng.standard_normal((600, 8))).astype(
        np.float32)
    exact = build_knn_graph(torch.from_numpy(vec), 8).numpy()
    ref = [knn_recall(np.asarray(ref_nn_descent(jax.random.PRNGKey(s), jnp.asarray(vec), 8)),
                      exact) for s in range(2)]
    got = [knn_recall(nn_descent(torch.Generator().manual_seed(s), torch.from_numpy(vec), 8,
                                 device="cpu").numpy(), exact) for s in range(2)]
    assert abs(np.mean(got) - np.mean(ref)) <= 0.05, (got, ref)
    assert min(got) >= 0.5, got


def test_nn_descent_draws_and_generator():
    vec = torch.from_numpy(np.random.default_rng(1).integers(-3, 4, (120, 4)).astype(np.float32))
    a = nn_descent(torch.Generator().manual_seed(5), vec, 6, iters=3, device="cpu")
    b = nn_descent(torch.Generator().manual_seed(5), vec, 6, iters=3, device="cpu")
    assert torch.equal(a, b)  # one seed, one graph
    graph_invariants(vec.numpy(), a.numpy())
    draws = reference_draws(jax.random.PRNGKey(0), 120, 6, 2, 2)
    with pytest.raises(ValueError, match="rounds"):
        nn_descent(None, vec, 6, iters=3, draws=draws, device="cpu")
    with pytest.raises(ValueError, match="vectors are on"):
        nn_descent(torch.Generator(), vec.to("meta"), 6, iters=1, device="cpu")
