"""The port's primitives against the reference on the same numpy inputs:
distances, the visited bitset (bit 31 included), the queues and their
sorted-run machinery. Dedup masks, constraints, the Eq.-1 estimator,
policies and the exact oracle are in test_torch_constraints.py.

Inputs are integer-valued and hold no subnormals, so every comparison is
exact. (The reference's own merge and push disagree on a subnormal
distance: tests/test_queue.py::test_merge_sorted_bit_for_bit_equals_push.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import distances as ref_dist
from repro.core import queue as rq
from repro.core import visited as ref_vis
from repro_torch.common import distances as port_dist
from repro_torch.core import queue as pq
from repro_torch.core import visited as port_vis
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse fixture)


def T(a):
    """numpy -> torch, uint32 words reinterpreted as int32 (same bits)."""
    a = np.asarray(a)
    return torch.from_numpy(np.array(a.view(np.int32) if a.dtype == np.uint32 else a))


def eq(ref, port):
    ref = np.asarray(ref)
    port = port.numpy()
    if ref.dtype == np.uint32:
        port = port.view(np.uint32)
    np.testing.assert_array_equal(ref, port)


def int_dists(rng, shape, hi=6, inf_frac=0.1):
    """Small integer distances (many ties), some +inf."""
    d = rng.integers(0, hi, size=shape).astype(np.float32)
    d[rng.random(shape) < inf_frac] = np.inf
    return d


def sorted_queue(rng, b, c):
    d = np.sort(int_dists(rng, (b, c)), axis=-1)
    i = np.where(np.isfinite(d), rng.integers(0, 1000, size=(b, c)), -1).astype(np.int32)
    return d, i


# --------------------------------------------------------------------------- distances


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
def test_squared_l2_and_rowwise(integer):
    rng = np.random.default_rng(0)
    if integer:
        a = rng.integers(-9, 10, size=(7, 12)).astype(np.float32)
        b = rng.integers(-9, 10, size=(11, 12)).astype(np.float32)
        rows = rng.integers(-9, 10, size=(7, 5, 12)).astype(np.float32)
    else:
        a, b = rng.standard_normal((7, 12), np.float32), rng.standard_normal((11, 12), np.float32)
        rows = rng.standard_normal((7, 5, 12), np.float32)
    got = port_dist.squared_l2(T(a), T(b))
    want = ref_dist.squared_l2(jnp.asarray(a), jnp.asarray(b))
    got_r = port_dist.batched_rowwise_sqdist(T(a), T(rows))
    want_r = ref_dist.batched_rowwise_sqdist(jnp.asarray(a), jnp.asarray(rows))
    if integer:
        eq(want, got)
        eq(want_r, got_r)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), rtol=1e-6)
    assert (port_dist.squared_l2(T(a), T(a)) >= 0).all()


# --------------------------------------------------------------------------- visited


def test_visited_set_test_count_with_bit31():
    rng = np.random.default_rng(1)
    n, b = 200, 4
    words_r = ref_vis.visited_init(b, n)
    words_p = port_vis.visited_init(b, n, "cpu")
    for step in range(3):
        ids = rng.permutation(n)[: 3 * 24].reshape(3, 24)[step % 3]
        ids = np.tile(ids, (b, 1)).astype(np.int32)
        ids[:, 0] = 31 + 32 * step  # bit 31 of a word
        ids[:, 1] = -1
        mask = rng.random((b, 24)) < 0.6
        mask[:, 0] = True
        fresh_r = ~ref_vis.visited_test(words_r, jnp.asarray(ids)) & jnp.asarray(mask)
        fresh_p = ~port_vis.visited_test(words_p, T(ids)) & T(mask)
        eq(fresh_r, fresh_p)
        words_r = ref_vis.visited_set(words_r, jnp.asarray(ids), fresh_r)
        words_p = port_vis.visited_set(words_p, T(ids), fresh_p)
        eq(words_r, words_p)
        eq(ref_vis.visited_count(words_r), port_vis.visited_count(words_p))
    assert (words_p.numpy().view(np.uint32) >> 31).any()
    assert port_vis.visited_test(words_p, T(np.array([[-1, 31]] * b, np.int32)))[:, 0].all()
    words = np.array([[0xFFFFFFFF, 0x80000001, 0]], np.uint32)
    eq(ref_vis.visited_count(jnp.asarray(words)), port_vis.visited_count(T(words)))
    assert int(port_vis.visited_count(T(words))[0]) == 34


# --------------------------------------------------------------------------- queues


def _ref_queue(d, i):
    return rq.BatchedQueue(dists=jnp.asarray(d), ids=jnp.asarray(i))


def _port_queue(d, i):
    return pq.BatchedQueue(dists=T(d), ids=T(i))


def assert_queue(ref, port):
    eq(ref.dists, port.dists)
    eq(ref.ids, port.ids)


def test_queue_push_tie_order():
    for seed in range(4):
        rng = np.random.default_rng(seed)
        b, c, m = 5, 16, 40
        d, i = sorted_queue(rng, b, c)
        nd = int_dists(rng, (b, m), hi=4)
        ni = rng.integers(0, 1000, size=(b, m)).astype(np.int32)
        valid = rng.random((b, m)) < 0.7
        ref = rq.queue_push(_ref_queue(d, i), jnp.asarray(nd), jnp.asarray(ni),
                            jnp.asarray(valid))
        port = pq.queue_push(_port_queue(d, i), T(nd), T(ni), T(valid))
        assert_queue(ref, port)


def test_queue_pop_n():
    for n in (1, 3, 16, 20):
        rng = np.random.default_rng(n)
        d, i = sorted_queue(rng, 6, 16)
        do_pop = np.array([True, False, True, True, False, True])
        r_new, r_d, r_i = rq.queue_pop_n(_ref_queue(d, i), n, jnp.asarray(do_pop))
        p_new, p_d, p_i = pq.queue_pop_n(_port_queue(d, i), n, T(do_pop))
        assert_queue(r_new, p_new)
        eq(r_d, p_d)
        eq(r_i, p_i)
    r1 = rq.queue_pop(_ref_queue(d, i), jnp.asarray(do_pop))
    p1 = pq.queue_pop(_port_queue(d, i), T(do_pop))
    assert_queue(r1[0], p1[0])
    eq(r1[1], p1[1])
    eq(r1[2], p1[2])


def test_queue_inspectors():
    rng = np.random.default_rng(5)
    d, i = sorted_queue(rng, 6, 8)
    d[0] = np.inf
    i[0] = -1
    rqq, pqq = _ref_queue(d, i), _port_queue(d, i)
    eq(rq.queue_nonempty(rqq), pq.queue_nonempty(pqq))
    eq(rq.queue_size(rqq), pq.queue_size(pqq))
    eq(rq.queue_worst_finite(rqq), pq.queue_worst_finite(pqq))
    eq(rq.topk_threshold(rqq, 8), pq.topk_threshold(pqq, 8))
    for a, b in zip(rq.queue_head(rqq), pq.queue_head(pqq)):
        eq(a, b)
    assert_queue(rq.queue_init(3, 4), pq.queue_init(3, 4, "cpu"))


def test_sort_run():
    for m in (1, 3, 8, 13, 32):
        rng = np.random.default_rng(m)
        d = int_dists(rng, (5, m), hi=3)
        i = rng.integers(0, 1000, size=(5, m)).astype(np.int32)
        valid = rng.random((5, m)) < 0.7
        ref = jax.jit(rq.sort_run)(jnp.asarray(d), jnp.asarray(i), jnp.asarray(valid))
        for a, b in zip(ref, pq.sort_run(T(d), T(i), T(valid))):
            eq(a, b)


def test_partition_sorted_runs():
    ref_fn = jax.jit(rq.partition_sorted_runs, static_argnums=(4, 5))
    for m, caps in [(1, (4, 4)), (12, (4, 16)), (32, (8, 8)), (40, (64, 3))]:
        rng = np.random.default_rng(m)
        d = int_dists(rng, (5, m), hi=3)
        i = rng.integers(0, 1000, size=(5, m)).astype(np.int32)
        r = rng.random((5, m))
        first, second = r < 0.4, (r >= 0.4) & (r < 0.8)
        ref = ref_fn(jnp.asarray(d), jnp.asarray(i), jnp.asarray(first), jnp.asarray(second),
                     *caps)
        port = pq.partition_sorted_runs(T(d), T(i), T(first), T(second), *caps)
        for run_r, run_p in zip(ref, port):
            for a, b in zip(run_r, run_p):
                eq(a, b)


def test_queue_merge_sorted_equals_reference_and_push():
    for c, r in [(2, 1), (8, 5), (16, 16), (8, 24)]:
        rng = np.random.default_rng(c * 100 + r)
        d, i = sorted_queue(rng, 6, c)
        rd = int_dists(rng, (6, r), hi=4)
        ri = rng.integers(0, 1000, size=(6, r)).astype(np.int32)
        valid = rng.random((6, r)) < 0.7
        run_d, run_i = pq.sort_run(T(rd), T(ri), T(valid))
        ref_run = jax.jit(rq.sort_run)(jnp.asarray(rd), jnp.asarray(ri), jnp.asarray(valid))
        ref = jax.jit(rq.queue_merge_sorted)(_ref_queue(d, i), *ref_run)
        port = pq.queue_merge_sorted(_port_queue(d, i), run_d, run_i)
        assert_queue(ref, port)
        pushed = pq.queue_push(_port_queue(d, i), run_d, run_i, torch.isfinite(run_d))
        assert torch.equal(port.dists, pushed.dists) and torch.equal(port.ids, pushed.ids)


def test_dist_bits_canonicalises_negative_zero():
    d = torch.tensor([[-0.0, 0.0, 1.0, float("inf")]])
    keys = pq._dist_bits(d)
    assert keys[0, 0] == keys[0, 1] == 0 and keys[0, 3] == 0x7F800000
    assert keys.dtype == torch.int64
