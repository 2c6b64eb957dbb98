"""The integer-valued world shared by the port's search parity tests.

Small-integer vectors make every squared distance and partial sum exact in
float32, so reduction order cannot change a bit: any difference between
the reference (``repro``) and the port (``repro_torch``) is a traversal
fault. The reference builds the world; ``from_reference_arrays`` carries
its numpy arrays across. The search parity files import ``run_pair`` and
``assert_same`` from here.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import SearchParams as RefParams
from repro.core import constrained_search as ref_search
from repro.core import unequal_pct_constraint as ref_unequal
from repro.core.constraints import RangeConstraint as RefRange
from repro.core.types import Corpus as RefCorpus
from repro.graph.index import build_index as ref_build_index
from repro_torch.interop import from_reference_arrays

N, D, L, NQ = 1024, 8, 40, 16
FAMILIES = ("label", "range", "udf")
BEAMS = (1, 2, 4)
STAT_FIELDS = ("dist_evals", "hops", "visited", "iters", "beam_expansions")


def ref_udf(label, attrs_row):
    return (label % 3 == 0) | (attrs_row[1] > 50.0)


def port_udf(labels, attrs):
    return (labels % 3 == 0) | (attrs[:, 1] > 50.0)


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    """Two torch threads per test process: the workers share the host's cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=1)
def int_world():
    """Reference and port views of one integer-valued world (built once per
    process)."""
    rng = np.random.default_rng(0)
    vec = rng.integers(-6, 7, size=(N, D)).astype(np.float32)
    lab = rng.integers(0, L, size=N).astype(np.int32)
    attrs = rng.integers(0, 100, size=(N, 2)).astype(np.float32)
    qv = rng.integers(-6, 7, size=(NQ, D)).astype(np.float32)
    ql = rng.integers(0, L, NQ).astype(np.int32)
    lo = rng.integers(0, 60, NQ).astype(np.float32)
    hi = lo + 40.0

    corpus = RefCorpus(vectors=jnp.asarray(vec), labels=jnp.asarray(lab), attrs=jnp.asarray(attrs))
    graph = ref_build_index(jax.random.PRNGKey(1), corpus, degree=8, sample_size=64)
    label_cons = ref_unequal(jax.random.PRNGKey(3), jnp.asarray(ql), L, 25.0)
    range_cons = RefRange(lo=jnp.asarray(lo), hi=jnp.asarray(hi), col=jnp.int32(1))

    arrays = dict(vectors=vec, labels=lab, attrs=attrs, neighbors=np.asarray(graph.neighbors),
                  sample_ids=np.asarray(graph.sample_ids),
                  entry_point=np.asarray(graph.entry_point), device="cpu")
    t_corpus, t_graph, t_label = from_reference_arrays(
        **arrays, label_words=np.asarray(label_cons.words))
    _, _, t_range = from_reference_arrays(**arrays, lo=lo, hi=hi, col=1)
    # The reference draws vanilla's entry vertices inside constrained_search
    # (engine/loop.py); the port is handed the same draw.
    entry = np.asarray(jax.random.randint(jax.random.PRNGKey(7), (NQ,), 0, N, dtype=jnp.int32))
    return dict(
        ref=(corpus, graph, jnp.asarray(qv)),
        port=(t_corpus, t_graph, torch.from_numpy(qv)),
        cons={"label": (label_cons, t_label), "range": (range_cons, t_range),
              "udf": (ref_udf, port_udf)},
        entry=torch.from_numpy(entry),
    )


def params_kw(mode, beam, fuse):
    return dict(mode=mode, k=10, ef_result=32, ef_sat=32, ef_other=32, n_start=8,
                max_iters=96, beam_width=beam, alter_ratio_k=8, fuse_expand=fuse,
                use_kernel=fuse == "off")


def run_port(mode, family, beam, fuse):
    w = int_world()
    corpus, graph, queries = w["port"]
    return rt.constrained_search(corpus, graph, queries, w["cons"][family][1],
                                 rt.SearchParams(**params_kw(mode, beam, fuse)),
                                 entry=w["entry"])


def run_pair(mode, family, beam, fuse):
    """(reference result, port result) for one configuration. The unfused
    runs take the distance-kernel backend (``use_kernel=True``), which the
    reference serves on the CPU through its ``gather_distance/ref.py``."""
    w = int_world()
    corpus, graph, queries = w["ref"]
    rng = jax.random.PRNGKey(7) if mode == "vanilla" else None
    ref = ref_search(corpus, graph, queries, w["cons"][family][0],
                     RefParams(**params_kw(mode, beam, fuse)), rng=rng)
    return ref, run_port(mode, family, beam, fuse)


def assert_same(ref, port):
    """Ids, distances and every stat equal, bit for bit."""
    np.testing.assert_array_equal(np.asarray(ref.ids), port.ids.numpy())
    np.testing.assert_array_equal(np.asarray(ref.dists), port.dists.numpy())
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ref.stats, f)),
                                      getattr(port.stats, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(np.asarray(ref.filled), port.filled.numpy())


def assert_port_equal(a, b):
    torch.testing.assert_close(a.ids, b.ids, rtol=0, atol=0)
    torch.testing.assert_close(a.dists, b.dists, rtol=0, atol=0)
    for f in STAT_FIELDS:
        torch.testing.assert_close(getattr(a.stats, f), getattr(b.stats, f), rtol=0, atol=0)


def test_world_is_integer_valued_and_carried_bit_for_bit():
    w = int_world()
    ref_corpus, ref_graph, ref_q = w["ref"]
    corpus, graph, queries = w["port"]
    vec = corpus.vectors.numpy()
    assert np.array_equal(vec, np.round(vec)) and np.abs(vec).max() <= 6
    np.testing.assert_array_equal(np.asarray(ref_corpus.vectors), vec)
    np.testing.assert_array_equal(np.asarray(ref_graph.neighbors), graph.neighbors.numpy())
    assert int(graph.entry_point) == int(ref_graph.entry_point)
    ref_words = np.asarray(w["cons"]["label"][0].words)
    port_words = w["cons"]["label"][1].words.numpy()
    assert ref_words.dtype == np.uint32 and port_words.dtype == np.int32
    np.testing.assert_array_equal(port_words.view(np.uint32), ref_words)
    np.testing.assert_array_equal(ref_q, queries.numpy())


def test_port_search_reports_filled_and_shapes():
    res = run_port("prefer", "label", 1, "off")
    assert res.ids.shape == (NQ, 10) and res.ids.dtype == torch.int32
    assert res.dists.dtype == torch.float32
    assert res.stats.iters.dtype == torch.int32 and res.stats.iters.dim() == 0
    assert res.stats.beam_expansions.shape == (NQ, 1)
    torch.testing.assert_close(res.stats.beam_expansions.sum(-1, dtype=torch.int32),
                               res.stats.hops)
    assert torch.equal(res.filled, (res.ids >= 0).sum(-1, dtype=torch.int32))
