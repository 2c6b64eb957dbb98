"""The port's sorted-run merge on subnormal distances, and NN-descent's
time spans, on the CPU.

``sort_run`` + ``queue_merge_sorted`` must equal ``queue_push`` bit for bit
on any batch. On subnormal distances the reference's own merge does not: it
flushes them to 0 and then orders the ties otherwise
(tests/test_queue.py::test_merge_sorted_bit_for_bit_equals_push fails on
cap 2, live [1.4e-45], new [0.0], valid [False]). So the port's merge and
push are held to the reference's ``queue_push``, on numpy inputs, at that
case and at three more with subnormals among ties, invalid entries and
overflow (the cases live in tests/test_torch_cuda_queue.py, which holds
them on the card).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import queue as rq
from repro_torch.core.types import Corpus
from repro_torch.graph import build_index, nn_descent
from repro_torch.graph.build import span_seconds
from test_torch_cuda_queue import SUBNORMAL_CASES, merge_and_push
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse fixture)


def reference_push(case):
    cap, live, new, valid = case
    q = rq.queue_init(1, cap)
    if live:
        q = rq.queue_push(q, jnp.asarray([live], jnp.float32),
                          jnp.arange(len(live), dtype=jnp.int32)[None],
                          jnp.ones((1, len(live)), bool))
    q = rq.queue_push(q, jnp.asarray([new], jnp.float32),
                      jnp.arange(100, 100 + len(new), dtype=jnp.int32)[None],
                      jnp.asarray([valid]))
    return np.asarray(q.dists), np.asarray(q.ids)


@pytest.mark.parametrize("name", sorted(SUBNORMAL_CASES))
def test_merge_equals_push_on_subnormals(name):
    case = SUBNORMAL_CASES[name]
    (md, mi), (pd, pi) = merge_and_push(case)
    want_d, want_i = reference_push(case)
    # Bit patterns, so a subnormal flushed to 0 (or -0.0) shows.
    np.testing.assert_array_equal(md.view(np.int32), want_d.view(np.int32))
    np.testing.assert_array_equal(pd.view(np.int32), want_d.view(np.int32))
    np.testing.assert_array_equal(mi, want_i)
    np.testing.assert_array_equal(pi, want_i)
    assert np.any((want_d > 0) & (want_d < np.finfo(np.float32).tiny)), "no subnormal kept"


def test_nn_descent_spans_split_the_build():
    gen = torch.Generator().manual_seed(5)
    n, degree, iters = 600, 8, 3
    vec = torch.randint(-6, 7, (n, 8), generator=gen).float()
    draws = dict(k0=torch.randint(0, n, (n, degree), generator=gen, dtype=torch.int32),
                 cols=[torch.randint(0, degree, (n, degree, 2), generator=gen)
                       for _ in range(iters)],
                 rand=[torch.randint(0, n, (n, degree), generator=gen, dtype=torch.int32)
                       for _ in range(iters)])
    spans = {}
    got = nn_descent(None, vec, degree, iters=iters, draws=draws, device="cpu", spans=spans)
    want = nn_descent(None, vec, degree, iters=iters, draws=draws, device="cpu")
    assert torch.equal(got, want)
    assert set(spans) == {"distances", "sorts"}
    assert len(spans["distances"]) == len(spans["sorts"]) == iters + 1
    assert all(t > 0 for t in span_seconds(spans).values())

    # build_index records them inside its "nn_descent" span.
    spans = {}
    corpus = Corpus(vectors=vec, labels=torch.zeros(n, dtype=torch.int32))
    build_index(torch.Generator().manual_seed(1), corpus, degree=degree, sample_size=16,
                method="nn_descent", reverse_edges=False, nn_descent_iters=iters, device="cpu",
                spans=spans)
    sec = span_seconds(spans)
    assert set(sec) == {"nn_descent", "distances", "sorts"}
    assert sec["distances"] + sec["sorts"] <= sec["nn_descent"]
