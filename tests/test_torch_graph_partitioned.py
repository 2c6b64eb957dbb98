"""The port's partitioned index against the reference's, on the CPU.

``build_partitioned_index`` pads the corpus by repeating its leading rows
to a multiple of ``n_shards`` and builds one independent subgraph per shard
with local ids. On integer-valued vectors (corpus sizes that are not a
multiple of ``n_shards``) the padded corpus equals the reference's, each
shard's adjacency equals the reference's up to distance ties (the check of
test_torch_graph.py), and the entries (local medoids) are equal. The
samples come from different generators, so they are held to their contract
instead: local, distinct, in range.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.types import Corpus as RefCorpus
from repro.graph.index import build_partitioned_index as ref_partitioned
from repro_torch.core.types import Corpus
from repro_torch.graph import build_partitioned_index
from test_torch_graph_nnd import graph_invariants
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse fixture)


def world(n, seed):
    rng = np.random.default_rng(seed)
    vec = rng.integers(-8, 9, size=(n, 6)).astype(np.float32)
    lab = rng.integers(0, 10, size=n).astype(np.int32)
    attrs = rng.integers(0, 100, size=(n, 2)).astype(np.float32)
    return vec, lab, attrs


def row_dists(vec, nbrs):
    d = ((vec[np.maximum(nbrs, 0)] - vec[:, None, :]) ** 2).sum(-1)
    return np.where(nbrs >= 0, d, np.inf)


def assert_equal_up_to_ties(vec, want, got):
    """Same distance profile per row; equal id sets strictly below each
    row's last distance."""
    want_d, got_d = row_dists(vec, want), row_dists(vec, got)
    np.testing.assert_array_equal(want_d, got_d)
    for r in range(vec.shape[0]):
        strict = want_d[r] < want_d[r, -1]
        assert set(want[r][strict]) == set(got[r][strict]), r


@pytest.mark.parametrize("n,n_shards,reverse", [
    (403, 4, True),
    (403, 3, False),
    (256, 4, True),  # a multiple of n_shards: no padding
])
def test_partitioned_index_matches_reference(n, n_shards, reverse):
    vec, lab, attrs = world(n, seed=n + n_shards)
    degree, sample = 8, 16
    ref_c, ref_g = ref_partitioned(
        jax.random.PRNGKey(0), RefCorpus(vectors=jnp.asarray(vec), labels=jnp.asarray(lab),
                                         attrs=jnp.asarray(attrs)),
        n_shards, degree=degree, sample_size_per_shard=sample, reverse_edges=reverse)
    corpus = Corpus(vectors=torch.from_numpy(vec), labels=torch.from_numpy(lab),
                    attrs=torch.from_numpy(attrs))
    got_c, got_g = build_partitioned_index(torch.Generator().manual_seed(0), corpus, n_shards,
                                           degree=degree, sample_size_per_shard=sample,
                                           reverse_edges=reverse, device="cpu")
    n_local = -(-n // n_shards)
    for name in ("vectors", "labels", "attrs"):
        np.testing.assert_array_equal(getattr(got_c, name).numpy(),
                                      np.asarray(getattr(ref_c, name)))
    assert got_c.n == n_local * n_shards
    np.testing.assert_array_equal(got_c.vectors[n:].numpy(), vec[: n_local * n_shards - n])
    assert got_g.entry_point.shape == (n_shards,) and got_g.entry_point.dtype == torch.int32
    np.testing.assert_array_equal(got_g.entry_point.numpy(), np.asarray(ref_g.entry_point))
    assert got_g.neighbors.shape == (n_local * n_shards, degree)
    pvec = got_c.vectors.numpy()
    ref_n = np.asarray(ref_g.neighbors)
    samples = got_g.sample_ids.numpy().reshape(n_shards, sample)
    for s in range(n_shards):
        rows = slice(s * n_local, (s + 1) * n_local)
        local = pvec[rows]
        assert_equal_up_to_ties(local, ref_n[rows], got_g.neighbors[rows].numpy())
        graph_invariants(local, got_g.neighbors[rows].numpy())
        assert len(set(samples[s].tolist())) == sample
        assert samples[s].min() >= 0 and samples[s].max() < n_local


def test_partitioned_nn_descent_and_shard_generators():
    vec, lab, _ = world(301, seed=9)
    corpus = Corpus(vectors=torch.from_numpy(vec), labels=torch.from_numpy(lab))
    kw = dict(degree=6, sample_size_per_shard=8, method="nn_descent", nn_descent_iters=3,
              device="cpu")
    c1, g1 = build_partitioned_index(torch.Generator().manual_seed(4), corpus, 4, **kw)
    _, g2 = build_partitioned_index(torch.Generator().manual_seed(4), corpus, 4, **kw)
    for a, b in zip((g1.neighbors, g1.sample_ids, g1.entry_point),
                    (g2.neighbors, g2.sample_ids, g2.entry_point)):
        assert torch.equal(a, b)  # one seed, one layout
    assert c1.attrs is None and c1.n == 304
    samples = g1.sample_ids.reshape(4, 8)
    assert not all(torch.equal(samples[0], samples[s]) for s in range(1, 4))  # own generators
    for s in range(4):
        graph_invariants(c1.vectors[s * 76 : (s + 1) * 76].numpy(),
                         g1.neighbors[s * 76 : (s + 1) * 76].numpy())
