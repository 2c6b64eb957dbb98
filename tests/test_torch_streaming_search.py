"""Walks over a churned streaming index: the no-dead-id matrix of the
reference's streaming tests (family x backend x fuse, and the four modes),
port against reference.

The world is integer-valued (the PQ index too: integer codebooks, codes at
the argmin), so every distance is exact in float32; the deletes take each
query's two nearest satisfiers (the walk will visit them) and a random
slice. The port's index is built from the reference's arrays and takes
the same deletes; each walk over its published snapshot must return the
reference's ids, distances and every stat bit for bit, and no tombstoned
id.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import RangeConstraint as RefRange
from repro.core import SearchParams as RefParams
from repro.core import constrained_search as ref_search
from repro.core import equal_constraint as ref_equal
from repro.core.pq import PQIndex as RefPQIndex
from repro.core.types import Corpus as RefCorpus
from repro.graph.index import build_index as ref_build_index
from repro.streaming import StreamingIndex as RefStreamingIndex
from repro_torch.interop import from_reference_arrays, pq_index_from_reference
from test_torch_parity_world import assert_same, torch_threads  # noqa: F401 (autouse)

N, D, L, NQ, CAP = 400, 8, 4, 6, 464
M_SUB, N_CENT = 4, 16
BACKENDS = ("exact", "kernel", "pq")
MATRIX = [(f, b, fuse) for f in ("label", "range", "udf") for b in BACKENDS
          for fuse in ("off", "on") if not (f == "udf" and fuse == "on")]


def ref_udf(label, attrs_row):
    del attrs_row
    return label >= 0


def port_udf(labels, attrs):
    del attrs
    return labels >= 0


@functools.lru_cache(maxsize=1)
def churned():
    """(reference snapshot, port snapshot, dead ids, queries, PQ indexes)."""
    rng = np.random.default_rng(4)
    vec = rng.integers(-6, 7, size=(N, D)).astype(np.float32)
    lab = rng.integers(0, L, size=N).astype(np.int32)
    attrs = rng.integers(0, 100, size=(N, 2)).astype(np.float32)
    qv = rng.integers(-6, 7, size=(NQ, D)).astype(np.float32)
    ql = rng.integers(0, L, size=NQ).astype(np.int32)
    corpus = RefCorpus(vectors=jnp.asarray(vec), labels=jnp.asarray(lab), attrs=jnp.asarray(attrs))
    graph = ref_build_index(jax.random.PRNGKey(1), corpus, degree=8, sample_size=64)
    ref = RefStreamingIndex.from_static(corpus, graph, capacity=CAP, seed=3)
    t_corpus, t_graph, _ = from_reference_arrays(
        vectors=vec, labels=lab, attrs=attrs, neighbors=np.asarray(graph.neighbors),
        sample_ids=np.asarray(graph.sample_ids), entry_point=np.asarray(graph.entry_point),
        device="cpu")
    port = rt.StreamingIndex.from_static(t_corpus, t_graph, capacity=CAP, seed=3, device="cpu")

    params = RefParams(mode="prefer", k=6, ef_result=32, n_start=16, max_iters=64)
    res = ref_search(corpus, graph, jnp.asarray(qv), ref_equal(jnp.asarray(ql), L), params)
    dead = {int(i) for i in np.asarray(res.ids)[:, :2].ravel() if i >= 0}
    dead |= set(np.random.RandomState(7).choice(N, 40, replace=False).tolist())
    for t in sorted(dead):
        assert ref.delete(t) and port.delete(t)
    ref_snap, port_snap = ref.snapshot(), port.snapshot()

    svec = np.asarray(ref_snap.corpus.vectors)
    codebooks = rng.integers(-6, 7, size=(M_SUB, N_CENT, D // M_SUB)).astype(np.float32)
    sub = svec.reshape(CAP, M_SUB, 1, D // M_SUB)
    codes = ((sub - codebooks[None]) ** 2).sum(-1).argmin(-1).astype(np.int32)
    pq = (RefPQIndex(codebooks=jnp.asarray(codebooks), codes=jnp.asarray(codes)),
          pq_index_from_reference(codebooks=codebooks, codes=codes, device="cpu"))
    return ref_snap, port_snap, dead, qv, ql, pq


def _t(a, dtype):
    return torch.from_numpy(np.array(a, dtype=dtype))


def _constraints(family, ql):
    if family == "label":
        ref = ref_equal(jnp.asarray(ql), L)
        return ref, rt.LabelSetConstraint(words=_t(np.asarray(ref.words).view(np.int32), np.int32))
    if family == "range":
        lo = np.full((NQ,), 10.0, np.float32)
        hi = np.full((NQ,), 70.0, np.float32)
        ref = RefRange(lo=jnp.asarray(lo), hi=jnp.asarray(hi), col=jnp.int32(0))
        return ref, rt.RangeConstraint(lo=_t(lo, np.float32), hi=_t(hi, np.float32), col=0)
    return ref_udf, port_udf


def _run(mode, family, backend, fuse):
    ref_snap, port_snap, dead, qv, ql, pq = churned()
    ref_cons, port_cons = _constraints(family, ql)
    kw = dict(mode=mode, k=6, ef_result=32, n_start=16, max_iters=64,
              use_kernel=backend == "kernel", approx="pq" if backend == "pq" else "exact",
              fuse_expand=fuse)
    rng = jax.random.PRNGKey(11)
    ref = ref_search(ref_snap.corpus, ref_snap.graph, jnp.asarray(qv), ref_cons, RefParams(**kw),
                     rng=rng, pq_index=pq[0] if backend == "pq" else None)
    entry = None
    if mode == "vanilla":
        entry = _t(jax.random.randint(rng, (NQ,), 0, CAP, dtype=jnp.int32), np.int32)
    port = rt.constrained_search(port_snap.corpus, port_snap.graph,
                                 _t(qv, np.float32), port_cons,
                                 rt.SearchParams(**kw), entry=entry,
                                 pq_index=pq[1] if backend == "pq" else None)
    assert_same(ref, port)
    ids = {int(i) for i in port.ids.flatten().tolist() if i >= 0}
    assert not ids & dead, f"tombstoned ids returned: {sorted(ids & dead)}"
    assert int(port.filled.min()) > 0
    return port


@pytest.mark.parametrize("family,backend,fuse", MATRIX)
def test_no_tombstoned_id_and_reference_parity(family, backend, fuse):
    _run("prefer", family, backend, fuse)


@pytest.mark.parametrize("mode", ["vanilla", "start", "alter", "prefer"])
def test_no_tombstoned_id_any_mode(mode):
    _run(mode, "label", "kernel", "off")
