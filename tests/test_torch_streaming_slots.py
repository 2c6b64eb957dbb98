"""The port's slot pool and streaming index state against the reference's
(``repro.streaming.slots``), on the CPU: the bitmap's bits (bit 31 of a
word included) and the slot accounting through alloc / commit / release /
reclaim; ``from_static``'s arrays, lists, histograms and postings; and the
immutability of a published snapshot under later mutations. Every check
is exact (integer-valued world, or no arithmetic at all)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.types import Corpus as RefCorpus
from repro.graph.index import build_index as ref_build_index
from repro.streaming import SlotPool as RefSlotPool
from repro.streaming import StreamingIndex as RefStreamingIndex
from repro_torch.interop import from_reference_arrays
from repro_torch.streaming import SlotPool, StreamingIndex
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse fixture)

N, D, L = 200, 6, 7


def _arrays(n=N, seed=0):
    rng = np.random.default_rng(seed)
    vec = rng.integers(-5, 6, size=(n, D)).astype(np.float32)
    lab = rng.integers(0, L, size=n).astype(np.int32)
    attrs = rng.integers(0, 50, size=(n, 2)).astype(np.float32)
    return vec, lab, attrs


def _assert_pools_equal(ref, port):
    np.testing.assert_array_equal(ref.tombstones, port.tombstones)
    np.testing.assert_array_equal(ref.live_ids(), port.live_ids())
    np.testing.assert_array_equal(ref.live_mask(), port.live_mask())
    assert ref.stats() == port.stats()
    assert ref.free == port.free and ref.pending == port.pending
    port.check_accounting()


@pytest.mark.parametrize("n0,capacity", [(33, 70), (32, 64), (0, 40), (70, 70)])
def test_bitmap_and_accounting_match_reference(n0, capacity):
    vec, lab, attrs = _arrays(n=n0)
    ref = RefSlotPool(vec, lab, attrs, capacity)
    port = SlotPool(vec, lab, attrs, capacity, device="cpu")
    _assert_pools_equal(ref, port)
    # Bit 31 of word 1 is slot 63: FREE (set) wherever 63 lies past n0.
    if capacity > 63:
        assert port.is_live(63) == ref.is_live(63) == (63 < n0)
    # alloc / commit / release / reclaim in the same order on both.
    claimed = []
    for _ in range(min(5, capacity - n0)):
        a, b = ref.alloc(), port.alloc()
        assert a == b
        ref.commit(a), port.commit(b)
        claimed.append(a)
        _assert_pools_equal(ref, port)
    for s in claimed[:3] + list(range(min(n0, 4))):
        assert ref.release(s) == port.release(s) is True
        assert ref.release(s) == port.release(s) is False  # idempotent
    _assert_pools_equal(ref, port)
    for s in list(ref.pending[:2]):
        ref.reclaim(s), port.reclaim(s)
    _assert_pools_equal(ref, port)
    if capacity > 63 and n0 <= 63:
        # Drive slot 63 through LIVE -> PENDING: bit 31 set and cleared.
        while 63 in port.free:
            s = port.alloc()
            assert s == ref.alloc()
            ref.commit(s), port.commit(s)
        assert port.is_live(63) and port.release(63) and ref.release(63)
        assert not port.is_live(63)
        assert port.tombstones[1] >> 31 == 1
        _assert_pools_equal(ref, port)
    with pytest.raises(ValueError, match="capacity"):
        SlotPool(vec, lab, attrs, n0 - 1, device="cpu")


def test_from_static_matches_reference():
    vec, lab, attrs = _arrays()
    corpus = RefCorpus(vectors=jnp.asarray(vec), labels=jnp.asarray(lab), attrs=jnp.asarray(attrs))
    graph = ref_build_index(jax.random.PRNGKey(2), corpus, degree=6, sample_size=24)
    ref = RefStreamingIndex.from_static(corpus, graph, ef_insert=16, seed=4)
    t_corpus, t_graph, _ = from_reference_arrays(
        vectors=vec, labels=lab, attrs=attrs, neighbors=np.asarray(graph.neighbors),
        sample_ids=np.asarray(graph.sample_ids), entry_point=np.asarray(graph.entry_point),
        device="cpu")
    port = StreamingIndex.from_static(t_corpus, t_graph, ef_insert=16, seed=4, device="cpu")
    assert port.capacity == ref.capacity == N + 100
    assert (port.dim, port.degree, port.ef_insert) == (ref.dim, ref.degree, ref.ef_insert)
    np.testing.assert_array_equal(ref.pool.vectors, port.pool.vectors.numpy())
    np.testing.assert_array_equal(ref.pool.labels, port.pool.labels_dev.numpy())
    np.testing.assert_array_equal(ref.pool.attrs, port.pool.attrs_dev.numpy())
    _assert_pools_equal(ref.pool, port.pool)
    np.testing.assert_array_equal(ref.neighbors, port.neighbors.numpy())
    assert port.neighbors.dtype == torch.int32
    np.testing.assert_array_equal(ref.sample_ids, port.sample_ids)
    assert ref.entry_point == port.entry_point
    assert ref.rng.rand() == port.rng.rand()  # the same numpy stream
    np.testing.assert_array_equal(ref.histograms.label_counts, port.histograms.label_counts)
    np.testing.assert_array_equal(ref.histograms.range_counts, port.histograms.range_counts)
    assert ref.postings._sets == port.postings._sets
    for lo, hi, col in ((3.0, 17.0, 0), (0.0, 49.0, 1), (20.0, 10.0, 0)):
        np.testing.assert_array_equal(ref.range_postings(lo, hi, col),
                                      port.range_postings(lo, hi, col))
    port.check_stats_exact()
    snap, ref_snap = port.snapshot(), ref.snapshot()
    assert snap.epoch == ref_snap.epoch == 1 and port.snapshot() is snap
    np.testing.assert_array_equal(np.asarray(ref_snap.corpus.tombstones).view(np.int32),
                                  snap.corpus.tombstones.numpy())
    assert snap.corpus.tombstones.dtype == torch.int32


def test_published_snapshot_unchanged_by_later_mutations():
    vec, lab, attrs = _arrays(seed=3)
    corpus = RefCorpus(vectors=jnp.asarray(vec), labels=jnp.asarray(lab), attrs=jnp.asarray(attrs))
    graph = ref_build_index(jax.random.PRNGKey(5), corpus, degree=6, sample_size=24)
    t_corpus, t_graph, _ = from_reference_arrays(
        vectors=vec, labels=lab, attrs=attrs, neighbors=np.asarray(graph.neighbors),
        sample_ids=np.asarray(graph.sample_ids), entry_point=np.asarray(graph.entry_point),
        device="cpu")
    index = StreamingIndex.from_static(t_corpus, t_graph, capacity=N + 8, seed=1, device="cpu")
    snap = index.snapshot()
    fields = dict(vectors=snap.corpus.vectors, labels=snap.corpus.labels,
                  attrs=snap.corpus.attrs, tombstones=snap.corpus.tombstones,
                  neighbors=snap.graph.neighbors, sample_ids=snap.graph.sample_ids,
                  entry_point=snap.graph.entry_point)
    before = {k: v.clone() for k, v in fields.items()}
    # Mutate every array a snapshot holds: the entry vertex and sampled
    # vertices die, inserts write rows and patch edges, consolidation
    # rewrites rows and re-points the seeds.
    for s in [index.entry_point, *index.sample_ids[:3].tolist(), 10, 11, 12]:
        assert index.delete(int(s))
    slots = [index.insert(vec[i] + 1.0, label=int(lab[i]), attrs=attrs[i]) for i in range(6)]
    assert index.consolidate() == 7
    new = index.snapshot()
    assert new.epoch > snap.epoch == 1
    for k, v in fields.items():
        assert torch.equal(v, before[k]), k
    assert not torch.equal(new.graph.neighbors, snap.graph.neighbors)
    assert not torch.equal(new.corpus.vectors, snap.corpus.vectors)
    assert not torch.equal(new.corpus.tombstones, snap.corpus.tombstones)
    assert int(new.graph.entry_point) != int(snap.graph.entry_point)
    assert all(index.pool.is_live(s) for s in slots)
    # Writes to the live pool never reach a published tensor's storage.
    index.pool.vectors.add_(1.0)
    index.neighbors.fill_(-1)
    assert torch.equal(new.corpus.vectors + 1.0, index.pool.vectors)
    assert bool((new.graph.neighbors >= 0).any())
