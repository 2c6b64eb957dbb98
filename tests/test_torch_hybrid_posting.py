"""The port's posting structures and posting-set scan against the reference
(``repro.core.posting``), on the CPU.

The scan runs label / range x plain / tombstoned x exact / L2 kernel
(``use_kernel``) / PQ over an integer-valued world with skewed label
frequencies (the PQ index integer too), so it must return the reference's
ids, distances and stats bit for bit; the exact and kernel backends must
also equal the exact constrained oracle. Then the empty set and P < k,
and ``PostingLists`` / ``RangeIndex`` / ``pad_posting`` / ``posting_bucket``
against the reference's on the same arrays.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import LabelSetConstraint as RefLabelSet
from repro.core import RangeConstraint as RefRange
from repro.core import SearchParams as RefParams
from repro.core import posting_search as ref_posting_search
from repro.core.posting import PostingLists as RefPostingLists
from repro.core.posting import RangeIndex as RefRangeIndex
from repro.core.posting import pad_posting as ref_pad
from repro.core.posting import posting_bucket as ref_bucket
from repro.core.pq import PQIndex as RefPQIndex
from repro.core.types import Corpus as RefCorpus
from repro_torch.core.posting import pad_posting, posting_bucket
from repro_torch.interop import pq_index_from_reference
from test_torch_parity_world import STAT_FIELDS, torch_threads  # noqa: F401 (autouse)

N, D, L, B, K = 1200, 16, 12, 4, 8
LABEL_COUNTS = (600, 240, 120, 84, 48, 36, 24, 18, 12, 8, 6, 4)
M_SUB, N_CENT = 4, 16


@functools.lru_cache(maxsize=1)
def world():
    rng = np.random.default_rng(0)
    vec = rng.integers(-5, 6, size=(N, D)).astype(np.float32)
    labels = np.repeat(np.arange(L, dtype=np.int32), LABEL_COUNTS)
    rng.shuffle(labels)
    attrs = rng.integers(0, 1000, size=(N, 2)).astype(np.float32)
    queries = rng.integers(-5, 6, size=(B, D)).astype(np.float32)
    dead = rng.choice(N, size=N // 10, replace=False)
    words = np.zeros(((N + 31) // 32,), np.uint32)
    for s in dead:
        words[s // 32] |= np.uint32(1) << np.uint32(s % 32)
    codebooks = rng.integers(-5, 6, size=(M_SUB, N_CENT, D // M_SUB)).astype(np.float32)
    sub = vec.reshape(N, M_SUB, 1, D // M_SUB)
    codes = ((sub - codebooks[None]) ** 2).sum(-1).argmin(-1).astype(np.int32)
    return dict(vec=vec, labels=labels, attrs=attrs, queries=queries, words=words,
                codebooks=codebooks, codes=codes)


def corpora(tombstoned):
    w = world()
    tomb = w["words"] if tombstoned else None
    ref = RefCorpus(vectors=jnp.asarray(w["vec"]), labels=jnp.asarray(w["labels"]),
                    attrs=jnp.asarray(w["attrs"]),
                    tombstones=None if tomb is None else jnp.asarray(tomb))
    port = rt.Corpus(vectors=torch.from_numpy(w["vec"]), labels=torch.from_numpy(w["labels"]),
                     attrs=torch.from_numpy(w["attrs"]),
                     tombstones=None if tomb is None else torch.from_numpy(tomb.view(np.int32)))
    return ref, port


def constraints(family):
    if family == "label":
        words = np.zeros((B, 1), np.uint32)
        words[:, 0] = (1 << 2) | (1 << 5)  # labels 2 and 5: a two-label union
        return (RefLabelSet(words=jnp.asarray(words)),
                rt.LabelSetConstraint(words=torch.from_numpy(words.view(np.int32))))
    lo = np.asarray([100, 200, 300, 400], np.float32)
    hi = lo + 80.0
    return (RefRange(lo=jnp.asarray(lo), hi=jnp.asarray(hi), col=jnp.int32(1)),
            rt.RangeConstraint(lo=torch.from_numpy(lo), hi=torch.from_numpy(hi), col=1))


def posting_ids(family):
    """The operand's posting set as the router gathers it: the label union,
    or the union of the batch's windows (the closure masks the rest)."""
    w = world()
    if family == "label":
        return RefPostingLists.from_arrays(w["labels"]).ids_for_words(
            np.asarray([(1 << 2) | (1 << 5)], np.uint32))
    ri = RefRangeIndex()
    ri.refresh(w["attrs"], np.ones(N, bool), 0)
    return ri.ids_for_range(100.0, 480.0, 1)


def assert_same_result(ref, port):
    np.testing.assert_array_equal(np.asarray(ref.ids), port.ids.numpy())
    np.testing.assert_array_equal(np.asarray(ref.dists), port.dists.numpy())
    for f in STAT_FIELDS[:4]:
        np.testing.assert_array_equal(np.asarray(getattr(ref.stats, f)),
                                      getattr(port.stats, f).numpy(), err_msg=f)


@pytest.mark.parametrize("backend", ["exact", "kernel", "pq"])
@pytest.mark.parametrize("tombstoned", [False, True])
@pytest.mark.parametrize("family", ["label", "range"])
def test_posting_scan_matches_reference(family, tombstoned, backend):
    ref_corpus, port_corpus = corpora(tombstoned)
    ref_cons, port_cons = constraints(family)
    ids = posting_ids(family)
    padded = pad_posting(ids, posting_bucket(ids.shape[0]))
    kw = dict(mode="prefer", k=K, ef_result=32 if backend != "pq" else 64, ef_sat=32,
              ef_other=32, n_start=8, max_iters=64, use_kernel=backend == "kernel",
              approx="pq" if backend == "pq" else "exact")
    w = world()
    pq = (RefPQIndex(codebooks=jnp.asarray(w["codebooks"]), codes=jnp.asarray(w["codes"])),
          pq_index_from_reference(codebooks=w["codebooks"], codes=w["codes"], device="cpu"))
    q = w["queries"]
    ref = ref_posting_search(ref_corpus, jnp.asarray(q), ref_cons, jnp.asarray(padded),
                             RefParams(**kw), pq[0] if backend == "pq" else None)
    port = rt.posting_search(port_corpus, torch.from_numpy(q), port_cons,
                             torch.from_numpy(padded), rt.SearchParams(**kw),
                             pq[1] if backend == "pq" else None)
    assert_same_result(ref, port)
    assert port.ids.dtype == torch.int32 and port.stats.iters.dtype == torch.int32
    if backend != "pq":
        od, oi = rt.exact_constrained_search(port_corpus, torch.from_numpy(q), port_cons, K)
        assert torch.equal(port.ids, oi) and torch.equal(port.dists, od)


def test_posting_scan_empty_set_and_fewer_than_k():
    ref_corpus, port_corpus = corpora(False)
    ref_cons, port_cons = constraints("label")
    q = world()["queries"]
    kw = dict(k=K, ef_result=32)
    empty = np.full((256,), -1, np.int32)
    res = rt.posting_search(port_corpus, torch.from_numpy(q), port_cons, torch.from_numpy(empty),
                            rt.SearchParams(**kw))
    assert (res.ids == -1).all() and torch.isinf(res.dists).all()
    assert (res.filled == 0).all() and (res.stats.dist_evals == 0).all()
    three = posting_ids("label")[:3]
    ref = ref_posting_search(ref_corpus, jnp.asarray(q), ref_cons, jnp.asarray(three),
                             RefParams(**kw))
    res = rt.posting_search(port_corpus, torch.from_numpy(q), port_cons,
                            torch.from_numpy(three), rt.SearchParams(**kw))
    assert_same_result(ref, res)
    assert (res.filled == 3).all()


def test_posting_lists_and_range_index_match_reference():
    w = world()
    rng = np.random.default_rng(9)
    live = rng.random(N) > 0.2
    for mask in (None, live):
        ref = RefPostingLists.from_arrays(w["labels"], mask)
        port = rt.PostingLists.from_arrays(w["labels"], mask)
        assert ref._sets == port._sets
        for lab in range(L + 2):
            np.testing.assert_array_equal(ref.ids_for_label(lab), port.ids_for_label(lab))
            assert ref.count_label(lab) == port.count_label(lab)
        for row in ([0x5], [0x0], [0x800], [0xFFFFFFFF, 0x1], [0x80000000]):
            wd = np.asarray(row, np.uint32)
            np.testing.assert_array_equal(ref.ids_for_words(wd), port.ids_for_words(wd))
            assert ref.count_words(wd) == port.count_words(wd)
            # int32 words with the same bits give the same postings
            np.testing.assert_array_equal(port.ids_for_words(wd.view(np.int32)),
                                          port.ids_for_words(wd))
    assert rt.PostingLists.from_arrays(np.zeros(0, np.int32))._sets == [set()]
    # incremental maintenance, cache invalidation included
    port = rt.PostingLists.from_arrays(w["labels"], live, n_labels=L)
    ref = RefPostingLists.from_arrays(w["labels"], live, n_labels=L)
    port.ids_for_label(3), ref.ids_for_label(3)
    for op, lab, slot in (("ins", 3, 5000), ("del", 3, int(np.flatnonzero(live)[0])),
                          ("ins", 40, 7), ("del", 41, 8)):
        for p in (port, ref):
            (p.on_insert if op == "ins" else p.on_delete)(lab, slot)
    assert ref._sets == port._sets
    np.testing.assert_array_equal(ref.ids_for_label(3), port.ids_for_label(3))

    ref_ri, port_ri = RefRangeIndex(), rt.RangeIndex()
    for version, mask in ((0, np.ones(N, bool)), (1, live)):
        ref_ri.refresh(w["attrs"], mask, version)
        port_ri.refresh(w["attrs"], mask, version)
        for lo, hi, col in ((0.0, 10.0, 0), (100.0, 480.0, 1), (500.0, 499.0, 0),
                            (0.0, 1e9, 1), (3.0, 4.0, 7)):
            np.testing.assert_array_equal(ref_ri.ids_for_range(lo, hi, col),
                                          port_ri.ids_for_range(lo, hi, col))
            assert ref_ri.count_range(lo, hi, col) == port_ri.count_range(lo, hi, col)
    for count in (0, 1, 256, 257, 4096, 16384, 16385, 10**6):
        assert posting_bucket(count) == ref_bucket(count)
    ids = np.asarray([4, 9, 11], np.int32)
    np.testing.assert_array_equal(pad_posting(ids, 8), ref_pad(ids, 8))
