"""The port's index build against the reference: ``build_knn_graph``
(adjacency equal up to distance ties), ``add_reverse_edges`` (equal),
``medoid`` (equal) on integer-valued vectors, plus the invariants of the
port's own ``build_index`` (exact and NN-descent) and data generators on
the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph.build import add_reverse_edges as ref_reverse
from repro.graph.build import build_knn_graph as ref_knn
from repro.graph.build import medoid as ref_medoid
from repro_torch.data import make_labeled_corpus, make_queries
from repro_torch.graph import add_reverse_edges, build_index, build_knn_graph, medoid
from repro_torch.graph.build import span_seconds
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse fixture)


def _int_vectors(n=300, d=4, seed=0):
    return np.random.default_rng(seed).integers(-4, 5, size=(n, d)).astype(np.float32)


def _row_dists(vec, nbrs):
    safe = np.maximum(nbrs, 0)
    d = ((vec[safe] - vec[:, None, :]) ** 2).sum(-1)
    return np.where(nbrs >= 0, d, np.inf)


@pytest.mark.parametrize("block", [64, 1024])
def test_build_knn_graph_equal_up_to_ties(block):
    vec = _int_vectors()
    degree = 8
    ref = np.asarray(ref_knn(jnp.asarray(vec), degree))
    port = build_knn_graph(torch.from_numpy(vec), degree, block=block).numpy()
    assert port.dtype == np.int32 and port.shape == ref.shape
    ref_d, port_d = _row_dists(vec, ref), _row_dists(vec, port)
    # Same distance profile per row; ids equal wherever the distance is
    # strictly below the row's last (tie-breaking) distance.
    np.testing.assert_array_equal(ref_d, port_d)
    kth = ref_d[:, -1:]
    for r in range(vec.shape[0]):
        strict = ref_d[r] < kth[r]
        assert set(ref[r][strict]) == set(port[r][strict])
    assert not (port == np.arange(vec.shape[0])[:, None]).any()  # self-free
    assert all(len(set(row)) == degree for row in port)  # duplicate-free


@pytest.mark.parametrize("degree", [6, 8])
def test_add_reverse_edges_equals_reference(degree):
    vec = _int_vectors(seed=1)
    nbrs = np.array(ref_knn(jnp.asarray(vec), 8))
    nbrs[::7, -2:] = -1  # some padded rows
    ref = np.asarray(ref_reverse(jnp.asarray(nbrs), jnp.asarray(vec), degree))
    port = add_reverse_edges(torch.from_numpy(nbrs), torch.from_numpy(vec), degree).numpy()
    np.testing.assert_array_equal(ref, port)


def test_medoid_equals_reference():
    vec = _int_vectors(n=257, seed=2)
    assert int(medoid(torch.from_numpy(vec))) == int(ref_medoid(jnp.asarray(vec)))
    assert medoid(torch.from_numpy(vec)).dtype == torch.int32


def test_port_world_build_invariants_on_cpu():
    g = torch.Generator().manual_seed(0)
    corpus = make_labeled_corpus(g, 600, 8, 10, device="cpu")
    assert corpus.vectors.shape == (600, 8) and corpus.vectors.dtype == torch.float32
    assert corpus.labels.dtype == torch.int32
    assert 0 <= int(corpus.labels.min()) and int(corpus.labels.max()) < 10
    assert len(torch.unique(corpus.labels)) >= 5  # k-means labels spread out
    spans = {}
    index = build_index(g, corpus, degree=8, sample_size=64, device="cpu", spans=spans)
    assert set(span_seconds(spans)) == {"products", "topk", "reverse_edges"}
    assert len(spans["products"]) == 1  # one row block at n = 600
    nbrs = index.neighbors
    assert nbrs.shape == (600, 8) and nbrs.dtype == torch.int32
    assert not (nbrs == torch.arange(600)[:, None]).any()
    d = torch.from_numpy(_row_dists(corpus.vectors.numpy(), nbrs.numpy()))
    assert (d[:, 1:] >= d[:, :-1]).all()  # rows distance-ascending
    assert index.sample_ids.dtype == torch.int32 and len(torch.unique(index.sample_ids)) == 64
    assert index.entry_point.dim() == 0
    queries, qlab = make_queries(g, corpus, 12)
    assert queries.shape == (12, 8) and qlab.shape == (12,)
    nnd = build_index(g, corpus, degree=8, sample_size=64, method="nn_descent", device="cpu")
    nbrs = nnd.neighbors
    assert nbrs.shape == (600, 8) and nbrs.dtype == torch.int32
    assert not (nbrs == torch.arange(600)[:, None]).any()
    assert (nbrs[:, 0] >= 0).all()
    d = torch.from_numpy(_row_dists(corpus.vectors.numpy(), nbrs.numpy()))
    assert (d[:, 1:] >= d[:, :-1]).all()
