"""One op sequence applied to the reference's streaming index and to the
port's (``repro_torch.streaming``, on the CPU): deletes (the entry vertex
and sampled vertices among them), inserts, ``consolidate(max_slots=...)``,
slot reuse and a full consolidation. After every step the two indexes hold
the same pool arrays and tombstones, adjacency, sample and entry vertex,
free and pending lists, epoch and consolidation count, histograms and
postings, bit for bit: the world is integer-valued, so every distance is
exact in float32 and both sides order ties alike.

A reference index carried across part-way through its life
(``streaming_index_from_reference``) continues identically.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.types import Corpus as RefCorpus
from repro.graph.index import build_index as ref_build_index
from repro.streaming import StreamingIndex as RefStreamingIndex
from repro_torch.interop import from_reference_arrays, streaming_index_from_reference
from repro_torch.streaming import StreamingIndex
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse fixture)

N, D, L, CAP = 300, 8, 5, 340


def int_world(seed=0):
    rng = np.random.default_rng(seed)
    vec = rng.integers(-6, 7, size=(N, D)).astype(np.float32)
    lab = rng.integers(0, L, size=N).astype(np.int32)
    attrs = rng.integers(0, 100, size=(N, 2)).astype(np.float32)
    corpus = RefCorpus(vectors=jnp.asarray(vec), labels=jnp.asarray(lab), attrs=jnp.asarray(attrs))
    graph = ref_build_index(jax.random.PRNGKey(1), corpus, degree=8, sample_size=32)
    return corpus, graph


def pair(corpus, graph, capacity=CAP, seed=3):
    ref = RefStreamingIndex.from_static(corpus, graph, capacity=capacity, seed=seed)
    t_corpus, t_graph, _ = from_reference_arrays(
        vectors=np.asarray(corpus.vectors), labels=np.asarray(corpus.labels),
        attrs=np.asarray(corpus.attrs), neighbors=np.asarray(graph.neighbors),
        sample_ids=np.asarray(graph.sample_ids), entry_point=np.asarray(graph.entry_point),
        device="cpu")
    port = StreamingIndex.from_static(t_corpus, t_graph, capacity=capacity, seed=seed,
                                      device="cpu")
    return ref, port


def assert_same_state(ref, port):
    rp, pp = ref.pool, port.pool
    np.testing.assert_array_equal(rp.vectors, pp.vectors.numpy())
    np.testing.assert_array_equal(rp.labels, pp.labels)
    np.testing.assert_array_equal(rp.labels, pp.labels_dev.numpy())
    np.testing.assert_array_equal(rp.attrs, pp.attrs)
    np.testing.assert_array_equal(rp.attrs, pp.attrs_dev.numpy())
    np.testing.assert_array_equal(rp.tombstones, pp.tombstones)
    assert pp.tombstones.dtype == np.uint32
    np.testing.assert_array_equal(ref.neighbors, port.neighbors.numpy())
    np.testing.assert_array_equal(ref.sample_ids, port.sample_ids)
    assert ref.entry_point == port.entry_point
    assert rp.free == pp.free and rp.pending == pp.pending
    assert rp.n_live == pp.n_live
    assert (ref.epoch, ref.consolidations) == (port.epoch, port.consolidations)
    rh, ph = ref.histograms, port.histograms
    np.testing.assert_array_equal(rh.label_counts, ph.label_counts)
    np.testing.assert_array_equal(rh.range_counts, ph.range_counts)
    np.testing.assert_array_equal(rh.attr_edges, ph.attr_edges)
    assert rh.n_live == ph.n_live
    assert ref.postings._sets == port.postings._sets
    port.pool.check_accounting()
    port.check_stats_exact()


def _insert_both(ref, port, rng, base, labels, count):
    slots = []
    for _ in range(count):
        p = rng.randint(N)
        vec = base[p] + rng.randint(-1, 2, size=D).astype(np.float32)
        attrs = rng.randint(0, 100, size=2).astype(np.float32)
        lab = int(labels[p])
        a = ref.insert(vec, label=lab, attrs=attrs)
        b = port.insert(vec, label=lab, attrs=attrs)
        assert a == b
        slots.append(a)
    return slots


def _delete_both(ref, port, slots):
    for s in slots:
        assert ref.delete(int(s)) == port.delete(int(s))


def test_op_sequence_matches_reference_step_by_step():
    corpus, graph = int_world()
    ref, port = pair(corpus, graph)
    assert_same_state(ref, port)
    base = np.asarray(corpus.vectors)
    labels = np.asarray(corpus.labels)
    rng = np.random.RandomState(11)

    # Deletes: the entry vertex, four sampled vertices, random others.
    victims = [ref.entry_point, *ref.sample_ids[:4].tolist(),
               *rng.choice(N, 20, replace=False).tolist()]
    _delete_both(ref, port, victims)
    assert_same_state(ref, port)
    first = _insert_both(ref, port, rng, base, labels, 12)
    assert_same_state(ref, port)
    # A partial consolidation: the entry vertex and the sample re-point.
    assert ref.consolidate(max_slots=9) == port.consolidate(max_slots=9) == 9
    assert_same_state(ref, port)
    assert port.pool.is_live(port.entry_point)
    # Reuse: the freed slots come back LIFO.
    _insert_both(ref, port, rng, base, labels, 20)
    assert_same_state(ref, port)
    _delete_both(ref, port, first[:5] + rng.choice(N, 15, replace=False).tolist())
    reclaimed = list(port.pool.pending)
    assert ref.consolidate() == port.consolidate() == len(reclaimed)
    assert_same_state(ref, port)
    again = _insert_both(ref, port, rng, base, labels, 14)
    assert_same_state(ref, port)
    assert again == reclaimed[::-1][:14]  # reclaimed slots come back LIFO
    ref.snapshot(), port.snapshot()
    assert_same_state(ref, port)


def test_pool_runs_dry_like_the_reference():
    corpus, graph = int_world(seed=2)
    ref, port = pair(corpus, graph, capacity=N + 3)
    rng = np.random.RandomState(5)
    _insert_both(ref, port, rng, np.asarray(corpus.vectors), np.asarray(corpus.labels), 3)
    with pytest.raises(RuntimeError, match="exhausted"):
        port.insert(np.zeros(D, np.float32))
    # The failed insert published a snapshot but claimed no slot, as the
    # reference's does.
    with pytest.raises(RuntimeError, match="exhausted"):
        ref.insert(np.zeros(D, np.float32))
    assert_same_state(ref, port)


@pytest.mark.parametrize("dirty", [True, False])
def test_carried_across_index_continues_identically(dirty):
    corpus, graph = int_world(seed=1)
    ref, _ = pair(corpus, graph)
    rng = np.random.RandomState(3)
    base, labels = np.asarray(corpus.vectors), np.asarray(corpus.labels)
    for s in rng.choice(N, 12, replace=False):
        ref.delete(int(s))
    for _ in range(6):
        p = rng.randint(N)
        ref.insert(base[p] + 1.0, label=int(labels[p]), attrs=np.asarray([1.0, 2.0], np.float32))
    ref.consolidate(max_slots=5)
    if not dirty:
        ref.snapshot()
    rp = ref.pool
    port = streaming_index_from_reference(
        vectors=rp.vectors, labels=rp.labels, attrs=rp.attrs, tombstones=rp.tombstones,
        neighbors=ref.neighbors, sample_ids=ref.sample_ids, entry_point=ref.entry_point,
        free=rp.free, pending=rp.pending, n_live=rp.n_live, epoch=ref.epoch,
        ef_insert=ref.ef_insert, consolidations=ref.consolidations,
        rng_state=ref.rng.get_state(), dirty=ref._dirty, device="cpu")
    assert port.snapshot().epoch == ref.snapshot().epoch
    for _ in range(8):
        p = rng.randint(N)
        vec = base[p] - 1.0
        assert ref.insert(vec, label=int(labels[p])) == port.insert(vec, label=int(labels[p]))
    _delete_both(ref, port, rng.choice(N, 6, replace=False).tolist())
    assert ref.consolidate() == port.consolidate()
    np.testing.assert_array_equal(ref.neighbors, port.neighbors.numpy())
    np.testing.assert_array_equal(ref.sample_ids, port.sample_ids)
    np.testing.assert_array_equal(rp.tombstones, port.pool.tombstones)
    assert (ref.entry_point, ref.epoch, rp.free, rp.pending) == (
        port.entry_point, port.epoch, port.pool.free, port.pool.pending)
    np.testing.assert_array_equal(ref.histograms.label_counts, port.histograms.label_counts)
    assert ref.postings._sets[: len(port.postings._sets)] == port.postings._sets[
        : len(ref.postings._sets)]
    port.check_stats_exact()
