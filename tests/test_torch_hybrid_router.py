"""The port's hybrid execution against the reference, on the CPU: the
histograms and postings under streaming churn, the selectivity estimator
(scan, sampled, UDF fallback) and ``selectivity``, the strategy router
(lattice, hotness, epoch reset, UDF default, a controller kept inside the
lattice) and the label overlays.

Worlds are integer-valued, so the scans, estimates and decisions are
compared exactly. The overlay built from the reference's sample has the
reference's rows, labels, tombstones, id map, sample and entry vertex,
and its adjacency up to distance ties (the kNN build orders ties
freely); over the reference's adjacency its walk returns the reference's
ids, distances and stats bit for bit. An overlay's walk stays inside its
posting set and reaches recall >= 0.9 against the exact oracle.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import AttributeHistograms as RefHistograms
from repro.core import PostingLists as RefPostingLists
from repro.core import RangeIndex as RefRangeIndex
from repro.core import RouterConfig as RefRouterConfig
from repro.core import SearchParams as RefParams
from repro.core import SelectivityEstimator as RefEstimator
from repro.core import StrategyRouter as RefRouter
from repro.core import build_overlay as ref_build_overlay
from repro.core import overlay_search as ref_overlay_search
from repro.core import scan_selectivity as ref_scan
from repro.core import selectivity as ref_selectivity
from repro.core.types import Corpus as RefCorpus
from repro.graph.index import build_index as ref_build_index
from repro.streaming import StreamingIndex as RefStreamingIndex
from repro_torch.core.router import GRAPH, OVERLAY, POSTING
from repro_torch.interop import from_reference_arrays
from test_torch_hybrid_posting import B, D, K, L, N, constraints, corpora, world
from test_torch_parity_world import STAT_FIELDS, torch_threads  # noqa: F401 (autouse)


def equal_up_to_ties(vec, want, got):
    """The same distance profile per row, and the same ids strictly below
    each row's last distance (integer vectors: exact distances)."""
    def dists(nbrs):
        d = ((vec[nbrs.clamp_min(0).long()] - vec[:, None, :]) ** 2).sum(-1)
        return torch.where(nbrs >= 0, d, float("inf"))

    want_d, got_d = dists(want), dists(got)
    strict = want_d < want_d[:, -1:]
    return torch.equal(want_d, got_d) and torch.equal(
        torch.where(strict, want, -1).sort(-1).values, torch.where(strict, got, -1).sort(-1).values)


def _words(labels):
    w = np.zeros((1,), np.uint32)
    for lab in labels:
        w[0] |= np.uint32(1) << np.uint32(lab)
    return w


def _decision(d):
    return (d.strategy, d.est_selectivity, d.bucket, d.source, d.label)


def test_histograms_and_postings_exact_under_churn():
    w = world()
    corpus = RefCorpus(vectors=jnp.asarray(w["vec"]), labels=jnp.asarray(w["labels"]),
                       attrs=jnp.asarray(w["attrs"]))
    graph = ref_build_index(jax.random.PRNGKey(1), corpus, degree=12, sample_size=128)
    ref = RefStreamingIndex.from_static(corpus, graph, capacity=N + 256)
    t_corpus, t_graph, _ = from_reference_arrays(
        vectors=w["vec"], labels=w["labels"], attrs=w["attrs"],
        neighbors=np.asarray(graph.neighbors), sample_ids=np.asarray(graph.sample_ids),
        entry_point=np.asarray(graph.entry_point), device="cpu")
    port = rt.StreamingIndex.from_static(t_corpus, t_graph, capacity=N + 256, device="cpu")
    rng = np.random.RandomState(11)
    for i in range(90):
        if rng.rand() < 0.5:
            vec = rng.randint(-5, 6, size=D).astype(np.float32)
            lab, attrs = int(rng.randint(L)), rng.randint(0, 1000, size=2).astype(np.float32)
            assert ref.insert(vec, label=lab, attrs=attrs) == port.insert(vec, lab, attrs)
        else:
            slot = int(rng.randint(port.capacity))
            assert ref.delete(slot) == port.delete(slot)
        if i % 30 == 29:
            assert ref.consolidate() == port.consolidate()
            assert ref.snapshot().epoch == port.snapshot().epoch
    port.check_stats_exact()
    np.testing.assert_array_equal(ref.histograms.label_counts, port.histograms.label_counts)
    np.testing.assert_array_equal(ref.histograms.range_counts, port.histograms.range_counts)
    assert ref.postings._sets == port.postings._sets
    np.testing.assert_array_equal(ref.neighbors, port.neighbors.numpy())
    for lo, hi, col in ((100.0, 300.0, 0), (0.0, 50.0, 1)):
        np.testing.assert_array_equal(ref.range_postings(lo, hi, col),
                                      port.range_postings(lo, hi, col))
        assert port.histograms.estimate("range", (lo, hi, col)) == ref.histograms.estimate(
            "range", (lo, hi, col))
    # The label estimate is the live fraction the scan sees (the scan
    # divides by the capacity, the histogram by n_live).
    snap = port.snapshot()
    cons = rt.equal_constraint(torch.tensor([3], dtype=torch.int32), L)
    scan = float(rt.scan_selectivity(cons, snap.corpus)[0])
    est = port.histograms.estimate("label", _words([3]))
    assert abs(est * port.pool.n_live / port.capacity - scan) < 1e-6


@pytest.mark.parametrize("tombstoned", [False, True])
def test_scan_sampled_and_selectivity_match_reference(tombstoned):
    ref_corpus, port_corpus = corpora(tombstoned)
    sample = np.random.default_rng(2).choice(N, 128, replace=False).astype(np.int32)
    for family in ("label", "range"):
        ref_cons, port_cons = constraints(family)
        for chunk in (1 << 16, 500):  # 500: a ragged last window
            want = np.asarray(ref_scan(ref_cons, ref_corpus, chunk=chunk))
            got = rt.scan_selectivity(port_cons, port_corpus, chunk=chunk)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(want, got.numpy())
        np.testing.assert_array_equal(np.asarray(ref_selectivity(ref_cons, ref_corpus)),
                                      rt.selectivity(port_cons, port_corpus).numpy())
        # The sampled estimate over the build sample.
        ref_est = RefEstimator(corpus=ref_corpus, sample_ids=jnp.asarray(sample))
        port_est = rt.SelectivityEstimator(corpus=port_corpus,
                                           sample_ids=torch.from_numpy(sample))
        (rv, rs), (pv, ps) = (ref_est.estimate_constraint(ref_cons),
                              port_est.estimate_constraint(port_cons))
        assert rs == ps == "sampled"
        np.testing.assert_array_equal(np.asarray(rv), pv)

    # A UDF has no histogram: the sampled fallback, or a ValueError unarmed.
    def ref_udf(label, attrs_row):
        return label == 1

    def port_udf(labels, attrs):
        return labels == 1

    w = world()
    hist = rt.AttributeHistograms.from_arrays(w["labels"], w["attrs"], n_labels=L)
    ref_hist = RefHistograms.from_arrays(w["labels"], w["attrs"], n_labels=L)
    port_est = rt.SelectivityEstimator(histograms=hist, corpus=port_corpus,
                                       sample_ids=torch.from_numpy(sample))
    ref_est = RefEstimator(histograms=ref_hist, corpus=ref_corpus,
                           sample_ids=jnp.asarray(sample))
    pv, ps = port_est.estimate_constraint(port_udf)
    rv, rs = ref_est.estimate_constraint(ref_udf)
    assert ps == rs == "sampled"
    np.testing.assert_array_equal(np.asarray(rv), pv)
    np.testing.assert_array_equal(np.asarray(ref_scan(ref_udf, ref_corpus)),
                                  rt.scan_selectivity(port_udf, port_corpus).numpy())
    with pytest.raises(ValueError, match="sampled fallback"):
        rt.SelectivityEstimator(histograms=hist).estimate_constraint(port_udf)
    for family in ("label", "range"):
        ref_cons, port_cons = constraints(family)
        (rv, rs), (pv, ps) = (ref_est.estimate_constraint(ref_cons),
                              port_est.estimate_constraint(port_cons))
        assert rs == ps == "histogram"
        np.testing.assert_array_equal(np.asarray(rv), pv)
    assert port_est.estimate_operand("label", _words([4])) == ref_est.estimate_operand(
        "label", _words([4]))
    assert port_est.estimate_operand("udf", None) == (None, "none")


def _routers(config_kw, controller=None):
    w = world()
    out = []
    for mod in ((RefHistograms, RefPostingLists, RefRangeIndex, RefEstimator, RefRouter,
                 RefRouterConfig),
                (rt.AttributeHistograms, rt.PostingLists, rt.RangeIndex,
                 rt.SelectivityEstimator, rt.StrategyRouter, rt.RouterConfig)):
        hist_c, post_c, ri_c, est_c, router_c, cfg_c = mod
        hist = hist_c.from_arrays(w["labels"], w["attrs"], n_labels=L)
        ri = ri_c()
        ri.refresh(w["attrs"], np.ones(N, bool), 0)
        out.append(router_c(est_c(histograms=hist), n=N, config=cfg_c(**config_kw),
                            postings=post_c.from_arrays(w["labels"], n_labels=L),
                            range_index=ri, controller=controller))
    return out


def test_router_decisions_match_reference():
    w = world()
    counts = np.bincount(w["labels"], minlength=L)
    rare = int(np.argmin(counts))

    class ForcingController:
        def strategy_for(self, key, default):
            return "posting"

    requests = [("range", (200.0, 205.0, 0)), ("range", (0.0, 999.0, 0)),
                ("range", (100.0, 160.0, 1)), ("label", _words([0])),
                ("label", _words([rare])), ("label", _words([rare])),
                ("label", _words([rare])), ("label", _words([2, 5])),
                ("udf", object())]
    for config_kw, controller in (({"overlay_hot_after": 10_000}, None),
                                  ({"overlay_hot_after": 2, "posting_cap": 1}, None),
                                  ({}, ForcingController())):
        ref, port = _routers(config_kw, controller)
        for epoch in (1, 1, 2):  # an epoch move resets hotness
            ref.on_epoch(epoch), port.on_epoch(epoch)
            for family, operand in requests:
                for cheap in (False, True):
                    assert _decision(port.route(family, operand, cheap)) == _decision(
                        ref.route(family, operand, cheap))
    # The lattice itself, as the reference's tests read it.
    port = _routers({"overlay_hot_after": 2, "posting_cap": 1})[1]
    port.on_epoch(1)
    w_rare = _words([rare])
    assert [port.route("label", w_rare).strategy for _ in range(3)] == [GRAPH, OVERLAY, OVERLAY]
    port.on_epoch(2)
    assert port.route("label", w_rare).strategy == GRAPH
    port = _routers({"overlay_hot_after": 10_000})[1]
    d = port.route("range", (200.0, 205.0, 0))
    assert d.strategy == POSTING and d.bucket <= 1 and d.source == "histogram"
    assert port.route("range", (0.0, 999.0, 0)).strategy == GRAPH
    d = port.route("udf", object())
    assert (d.strategy, d.est_selectivity, d.source) == (GRAPH, None, "default")
    port_corpus = corpora(False)[1]
    assert port.route_constraint(constraints("label")[1], port_corpus).strategy == GRAPH
    assert rt.core.single_label_of_words(_words([7])) == 7
    assert rt.core.single_label_of_words(_words([2, 7])) is None


def test_overlay_matches_reference_with_its_sample():
    w = world()
    lab = 5
    ids = np.flatnonzero(w["labels"] == lab).astype(np.int32)
    ref = ref_build_overlay(lab, ids, w["vec"], epoch=7)
    # The reference's sample comes from jax.random inside build_index; it
    # is passed across (the overlay pads it by cycling, so its head is it).
    sample = np.asarray(ref.graph.sample_ids)[: min(64, ids.shape[0])]
    port = rt.build_overlay(lab, ids, w["vec"], 7, sample=sample, device="cpu")
    assert (port.label, port.epoch, port.n_real) == (ref.label, ref.epoch, ref.n_real)
    np.testing.assert_array_equal(np.asarray(ref.corpus.vectors), port.corpus.vectors.numpy())
    np.testing.assert_array_equal(np.asarray(ref.corpus.labels), port.corpus.labels.numpy())
    np.testing.assert_array_equal(np.asarray(ref.corpus.tombstones).view(np.int32),
                                  port.corpus.tombstones.numpy())
    np.testing.assert_array_equal(np.asarray(ref.ids_dev), port.ids_dev.numpy())
    np.testing.assert_array_equal(np.asarray(ref.graph.sample_ids), port.graph.sample_ids.numpy())
    assert int(ref.graph.entry_point) == int(port.graph.entry_point)
    # The kNN graph orders distance ties freely (graph/build.py): equal up
    # to ties, then the walk runs over the reference's adjacency.
    want_nbrs = np.array(ref.graph.neighbors)
    assert equal_up_to_ties(port.corpus.vectors, torch.from_numpy(want_nbrs),
                            port.graph.neighbors)
    port = dataclasses.replace(port, graph=dataclasses.replace(
        port.graph, neighbors=torch.from_numpy(want_nbrs)))
    q = w["queries"]
    kw = dict(mode="prefer", k=K, ef_result=64, ef_sat=32, ef_other=32, n_start=8,
              max_iters=128)
    want = ref_overlay_search(ref, jnp.asarray(q), RefParams(**kw))
    got = rt.overlay_search(port, torch.from_numpy(q), rt.SearchParams(**kw))
    np.testing.assert_array_equal(np.asarray(want.ids), got.ids.numpy())
    np.testing.assert_array_equal(np.asarray(want.dists), got.dists.numpy())
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(want.stats, f)),
                                      getattr(got.stats, f).numpy(), err_msg=f)


def test_overlay_confined_to_postings_and_rejects_singletons():
    w = world()
    port_corpus = corpora(False)[1]
    lab = 3
    ids = np.flatnonzero(w["labels"] == lab).astype(np.int32)
    g = torch.Generator().manual_seed(0)
    ov = rt.build_overlay(lab, torch.from_numpy(ids), torch.from_numpy(w["vec"]), 2,
                          generator=g, device="cpu")
    assert ov.corpus.n == 256 and ov.n_real == ids.shape[0]  # the ladder's first bucket
    q = torch.from_numpy(w["queries"])
    res = rt.overlay_search(ov, q, rt.SearchParams(mode="prefer", k=K, ef_result=64,
                                                   max_iters=128))
    got = res.ids
    assert bool(torch.isin(got[got >= 0], torch.from_numpy(ids)).all())
    cons = rt.equal_constraint(torch.full((B,), lab, dtype=torch.int32), L)
    _, oi = rt.exact_constrained_search(port_corpus, q, cons, K)
    assert float(rt.recall(got, oi)) >= 0.9
    with pytest.raises(ValueError, match=">= 2"):
        rt.build_overlay(0, np.asarray([3], np.int32), w["vec"], 0, generator=g, device="cpu")
    with pytest.raises(ValueError, match="generator"):
        rt.build_overlay(0, ids, w["vec"], 0, device="cpu")
    # The cache rebuilds on an epoch move and never serves a stale overlay.
    cache = rt.OverlayCache(max_overlays=1)
    built = []

    def build(label, epoch):
        built.append((label, epoch))
        return rt.build_overlay(label, ids, w["vec"], epoch, generator=g, device="cpu")

    assert cache.get(lab, 2, build).epoch == 2
    assert cache.get(lab, 2, build).epoch == 2
    assert cache.get(lab, 3, build).epoch == 3
    assert cache.get(lab + 1, 3, build).label == lab + 1  # evicts lab (LRU of 1)
    assert built == [(lab, 2), (lab, 3), (lab + 1, 3)]
    assert cache.stats() == {"hits": 1, "misses": 3, "builds": 3, "invalidations": 1,
                             "resident": 1}
