"""The serving runtime over the streaming index, port against reference: one
churn stream (queries, upserts and deletes from ``churn_workload``'s numpy
draws) served in rounds through ``StreamingLocalExecutor`` on both sides.

The reference index takes a few deletes first and is then carried across
with ``interop.streaming_index_from_reference``, as the streaming tests do.
Each round submits its items (a delete targets a live slot drawn from one
seeded RandomState on each side), then drains under a virtual clock with
no deadlines. The world is integer-valued and the stream has no jitter, so
every response must be equal bit for bit (ids, dists, filled, tier,
escalations, epoch; an upsert's slot), every epoch swap and consolidation
must happen at the same flush, and the indexes must end equal field by
field. No query may return a slot tombstoned at its response's epoch.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.types import Corpus as RefCorpus
from repro.graph.index import build_index as ref_build_index
from repro.serving import ServingRuntime as RefRuntime
from repro.serving import StreamingLocalExecutor as RefStreamingExecutor
from repro.serving import VirtualClock as RefClock
from repro.serving import make_tier_ladder as ref_tier_ladder
from repro.streaming import StreamingIndex as RefStreamingIndex
from repro_torch import Corpus
from repro_torch.interop import streaming_index_from_reference
from repro_torch.serving import (
    ServingRuntime,
    StreamingLocalExecutor,
    VirtualClock,
    churn_workload,
    make_serving_router,
    make_tier_ladder,
)
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse)

N, D, L, CAP = 300, 8, 5, 380
ROUND = 8
N_ITEMS = 64
TIER_KW = dict(k_cap=8, base_ef=16, base_iters=24, base_n_start=8, n_tiers=2)


@functools.lru_cache(maxsize=1)
def world():
    rng = np.random.default_rng(5)
    vec = rng.integers(-6, 7, size=(N, D)).astype(np.float32)
    lab = rng.integers(0, L, size=N).astype(np.int32)
    attrs = rng.random((N, 2)).astype(np.float32)
    corpus = RefCorpus(vectors=jnp.asarray(vec), labels=jnp.asarray(lab),
                       attrs=jnp.asarray(attrs))
    graph = ref_build_index(jax.random.PRNGKey(1), corpus, degree=8, sample_size=32)
    ref = RefStreamingIndex.from_static(corpus, graph, capacity=CAP, seed=3)
    for slot in np.random.RandomState(2).choice(N, 10, replace=False).tolist():
        assert ref.delete(slot)
    rp = ref.pool
    port = streaming_index_from_reference(
        vectors=rp.vectors, labels=rp.labels, attrs=rp.attrs, tombstones=rp.tombstones,
        neighbors=ref.neighbors, sample_ids=ref.sample_ids, entry_point=ref.entry_point,
        free=rp.free, pending=rp.pending, n_live=rp.n_live, epoch=ref.epoch,
        ef_insert=ref.ef_insert, consolidations=ref.consolidations,
        rng_state=ref.rng.get_state(), dirty=ref._dirty, device="cpu")
    items = churn_workload(7, Corpus(vectors=torch.from_numpy(vec), labels=torch.from_numpy(lab),
                                     attrs=torch.from_numpy(attrs)), N_ITEMS, L, mutation_frac=0.4,
                           k_choices=(2, 4, 8), jitter=0.0)
    return ref, port, items


def _serve(runtime, items):
    """Rounds of ROUND items, each submitted then drained; returns
    [(item, response, epoch at the end of its round, that epoch's uint32
    tombstone words)]."""
    rng = np.random.RandomState(11)
    live = sorted(int(s) for s in np.flatnonzero(runtime.executor.index.pool.live_mask()))
    out = []
    for start in range(0, len(items), ROUND):
        rids = []
        for it in items[start : start + ROUND]:
            if it.family == "upsert":
                rids.append(runtime.submit_upsert(it.query, *it.operand))
            elif it.family == "delete":
                rids.append(runtime.submit_delete(live.pop(rng.randint(len(live)))))
            else:
                rids.append(runtime.submit(it.query, it.k, it.family, it.operand))
        runtime.drain()
        epoch = runtime.executor.epoch
        tomb = np.array(np.asarray(runtime.executor.snapshot.corpus.tombstones)).view(np.uint32)
        for it, rid in zip(items[start : start + ROUND], rids):
            resp = runtime.poll(rid)
            if it.family == "upsert" and resp.filled:
                live.append(int(resp.ids[0]))
            out.append((it, resp, epoch, tomb))
    return out


@functools.lru_cache(maxsize=1)
def served():
    ref_index, port_index, items = world()
    ref_ex = RefStreamingExecutor(ref_index, consolidate_after=8)
    port_ex = StreamingLocalExecutor(port_index, consolidate_after=8)
    ref = RefRuntime(ref_ex, n_labels=L, tiers=ref_tier_ladder(**TIER_KW), ladder=(4, 8),
                     clock=RefClock())
    port = ServingRuntime(port_ex, n_labels=L, tiers=make_tier_ladder(**TIER_KW),
                          ladder=(4, 8), clock=VirtualClock())
    return ref, _serve(ref, items), port, _serve(port, items)


def test_churn_stream_equals_reference_bit_for_bit():
    ref, ref_out, port, port_out = served()
    kinds = {it.family for it, *_ in port_out}
    assert kinds == {"label", "range", "upsert", "delete"}
    for (it, a, ea, _), (_, b, eb, _) in zip(ref_out, port_out):
        assert ea == eb
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.dists, b.dists)
        for field in ("filled", "tier", "escalations", "epoch", "strategy", "fill_history"):
            assert getattr(a, field) == getattr(b, field), (it.family, field)
    assert dict(ref.telemetry.counters) == dict(port.telemetry.counters)
    assert ref.cache.trace_count == port.cache.trace_count == port.executor.traces
    assert ref.report()["index"] == port.report()["index"]


def test_epochs_advance_once_per_mutating_flush():
    _, _, port, port_out = served()
    epochs = [e for _, _, e, _ in port_out]
    assert epochs == sorted(epochs)
    rounds_with_mutations = sum(
        any(it.family in ("upsert", "delete") for it, *_ in port_out[s : s + ROUND])
        for s in range(0, len(port_out), ROUND))
    assert port.telemetry.counters["epoch_swaps"] == rounds_with_mutations
    for it, r, e, _ in port_out:
        if it.family in ("upsert", "delete"):
            assert r.epoch == e and r.filled == 1  # applied and visible in its round
        else:
            assert r.epoch == e


def test_no_query_returns_a_slot_dead_at_its_epoch():
    """Each query's ids against the tombstone words of the epoch its
    response names (the snapshot its round's queries read)."""
    _, _, _, port_out = served()
    checked = 0
    for it, r, e, tomb in port_out:
        if it.family not in ("label", "range"):
            continue
        ids = r.ids[r.ids >= 0].astype(np.int64)
        assert r.epoch == e and r.filled == ids.size
        assert not ((tomb[ids // 32] >> (ids % 32).astype(np.uint32)) & 1).any()
        checked += ids.size
    assert checked > 0


def test_slot_accounting_and_stats_hold_after_the_stream():
    ref, _, port, port_out = served()
    index = port.executor.index
    index.pool.check_accounting()
    index.check_stats_exact()
    rp, pp = ref.executor.index.pool, index.pool
    np.testing.assert_array_equal(rp.tombstones, pp.tombstones)
    np.testing.assert_array_equal(ref.executor.index.neighbors, index.neighbors.numpy())
    assert (rp.free, rp.pending, rp.n_live) == (pp.free, pp.pending, pp.n_live)
    assert ref.executor.index.consolidations == index.consolidations > 0
    # every upserted slot not deleted later in the stream is live at the end
    alive = {}
    for it, r, *_ in port_out:
        if it.family == "upsert":
            alive[int(r.ids[0])] = True
        elif it.family == "delete":
            alive[int(r.ids[0])] = False
    upserted = [s for s, ok in alive.items() if ok]
    assert upserted and all(pp.is_live(s) for s in upserted)


def test_streaming_router_reads_each_epochs_postings():
    """A router over the streaming executor (port only): label postings and
    range postings through EpochRangeView hold only live slots at every
    epoch, and a posting route serves only live, satisfying ids."""
    _, _, port, _ = served()
    index = port.executor.index
    # a runtime and executor of its own: the cached runtime's counters stay
    executor = StreamingLocalExecutor(index, consolidate_after=0)
    runtime = ServingRuntime(executor, n_labels=L, tiers=make_tier_ladder(**TIER_KW),
                             ladder=(4,), clock=VirtualClock())
    router = make_serving_router(executor, n_labels=L, controller=runtime.controller)
    live = index.pool.live_mask()
    for lab in range(L):
        ids = router.postings.ids_for_label(lab)
        assert live[ids].all() and (index.pool.labels[ids] == lab).all()
    ids = router.range_index.ids_for_range(0.2, 0.4, 0)
    assert live[ids].all() and ((index.pool.attrs[ids, 0] >= np.float32(0.2))
                                & (index.pool.attrs[ids, 0] <= np.float32(0.4))).all()
    runtime.router = router
    rid = runtime.submit(index.pool.vectors[int(ids[0])].numpy(), 4, "range", (0.2, 0.21, 0))
    runtime.drain()
    r = runtime.poll(rid)
    assert r.strategy == "posting" and r.epoch == executor.epoch == index.epoch
    got = r.ids[r.ids >= 0]
    assert got.size and live[got].all()
