"""The alter ratio's sum order against the live reference, at degree 12.

``estimate_alter_ratio`` averages Eq.-1 fractions c / k over the build
sample. With ``alter_ratio_k = min(16, degree) = 12`` the fractions are
inexact in float32, so the order of the sum decides the estimate's last
bit, and with it the walk. The reference sums with XLA's CPU reduce; the
port's ``pinned_sum`` reproduces that order (32-wide chunks left to right,
then the chunk sums left to right) on every device. Here an integer-valued
world (n = 2048, d = 8, degree 12) is searched by both packages under the
label and range families, alter and prefer modes, build samples of 64 and
128 and two seeds: ids, distances and every stat must be equal bit for bit.
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
from repro_torch.core.alter_ratio import pinned_sum
from repro_torch.interop import from_reference_arrays
from test_torch_parity_world import assert_same

N, D, L, NQ, DEGREE = 2048, 8, 40, 64, 12
SEEDS = (0, 1)


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    """Two torch threads per test process: the workers share the host's cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=4)
def world(sample: int, seed: int):
    """Reference and port views of one integer-valued degree-12 world."""
    rng = np.random.default_rng(100 + seed)
    vec = rng.integers(-6, 7, size=(N, D)).astype(np.float32)
    lab = rng.integers(0, L, size=N).astype(np.int32)
    attrs = rng.integers(0, 100, size=(N, 2)).astype(np.float32)
    qv = rng.integers(-6, 7, size=(NQ, D)).astype(np.float32)
    ql = rng.integers(0, L, NQ).astype(np.int32)
    lo = rng.integers(0, 60, NQ).astype(np.float32)

    corpus = RefCorpus(vectors=jnp.asarray(vec), labels=jnp.asarray(lab), attrs=jnp.asarray(attrs))
    graph = ref_build_index(jax.random.PRNGKey(seed), corpus, degree=DEGREE, sample_size=sample)
    label_cons = ref_unequal(jax.random.PRNGKey(3 + seed), jnp.asarray(ql), L, 25.0)
    range_cons = RefRange(lo=jnp.asarray(lo), hi=jnp.asarray(lo + 40.0), col=jnp.int32(1))
    arrays = dict(vectors=vec, labels=lab, attrs=attrs, neighbors=np.asarray(graph.neighbors),
                  sample_ids=np.asarray(graph.sample_ids),
                  entry_point=np.asarray(graph.entry_point), device="cpu")
    t_corpus, t_graph, t_label = from_reference_arrays(
        **arrays, label_words=np.asarray(label_cons.words))
    _, _, t_range = from_reference_arrays(**arrays, lo=lo, hi=lo + 40.0, col=1)
    return dict(ref=(corpus, graph, jnp.asarray(qv)),
                port=(t_corpus, t_graph, torch.from_numpy(qv)),
                cons={"label": (label_cons, t_label), "range": (range_cons, t_range)})


def params_kw(mode):
    return dict(mode=mode, k=10, ef_result=32, ef_sat=32, ef_other=32, n_start=8, max_iters=96,
                alter_ratio_k=16, use_kernel=True)


@pytest.mark.parametrize("sample", (64, 128))
@pytest.mark.parametrize("mode", ("alter", "prefer"))
@pytest.mark.parametrize("family", ("label", "range"))
def test_degree12_walk_equals_reference_bit_for_bit(family, mode, sample):
    for seed in SEEDS:
        w = world(sample, seed)
        ref_corpus, ref_graph, ref_q = w["ref"]
        corpus, graph, queries = w["port"]
        ref_cons, port_cons = w["cons"][family]
        assert int(graph.neighbors.shape[1]) == DEGREE
        ref = ref_search(ref_corpus, ref_graph, ref_q, ref_cons, RefParams(**params_kw(mode)))
        port = rt.constrained_search(corpus, graph, queries, port_cons,
                                     rt.SearchParams(**params_kw(mode)))
        assert_same(ref, port)


def chunked_sum(x: np.ndarray) -> np.ndarray:
    """Each 32-wide chunk left to right, then the chunk sums left to right."""
    c = x.reshape(x.shape[0], -1, 32)
    acc = c[:, :, 0].copy()
    for j in range(1, 32):
        acc = (acc + c[:, :, j]).astype(np.float32)
    total = acc[:, 0].copy()
    for i in range(1, acc.shape[1]):
        total = (total + acc[:, i]).astype(np.float32)
    return total


def test_pinned_sum_is_the_chunked_order_and_jnp_sum():
    ref_sum = jax.jit(lambda a: jnp.sum(a, axis=-1))
    for width in (64, 128, 256):
        x = np.random.default_rng(width).random((200, width)).astype(np.float32)
        got = pinned_sum(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, chunked_sum(x), err_msg=f"width {width}")
        np.testing.assert_array_equal(got, np.asarray(ref_sum(x)), err_msg=f"width {width}")
