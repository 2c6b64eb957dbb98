"""The port's ``embedding_bag`` against the reference's, on the CPU.

``embedding_bag`` takes its plain version here (``embedding_bag_plain``:
each bag's valid rows added left to right from +0.0). It is held on shared
numpy inputs against the reference's Pallas kernel in interpret mode (tiny
cases: interpret mode runs one grid step per (bag, slot)), its oracle
``embedding_bag_ref``, its wrapper ``ops.embedding_bag`` in mean mode and
the model's ``embedding_bag_sum``, over integer and float tables, bags of
padding only, L = 1 and D in {1, 10, 16}.

Tolerances: bit for bit on integer-valued tables (every partial sum is
exact in float32); bit for bit against the interpreted Pallas kernel on
float tables too, since its grid adds the rows left to right from 0 as the
port does; within 1e-6 of the bag's sum of |rows| per element against the
jnp oracles on float tables, whose ``jnp.sum`` may add in another order.

The CUDA kernel is held against this plain version on the card by
test_torch_cuda_embedding_bag.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag.embedding_bag import embedding_bag_kernel
from repro.kernels.embedding_bag.ops import embedding_bag as ref_embedding_bag
from repro.kernels.embedding_bag.ref import embedding_bag_ref
from repro.models.recsys.models import embedding_bag_sum as ref_bag_sum
from repro_torch.kernels import KERNEL_STEMS, dispatch
from repro_torch.kernels.embedding_bag import (
    embedding_bag,
    embedding_bag_cuda,
    embedding_bag_plain,
)
from repro_torch.models.recsys import embedding_bag_sum
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse fixture)

# (V, D, B, L): B * L <= 64 grid steps for the interpreted kernel.
CASES = [(50, 16, 4, 8), (30, 10, 6, 5), (20, 1, 8, 3), (40, 16, 16, 1), (25, 10, 3, 12)]
_interp = jax.jit(lambda t, i: embedding_bag_kernel(t, i, interpret=True))
_oracle = jax.jit(embedding_bag_ref)
_model_sum = jax.jit(ref_bag_sum)
_mean = jax.jit(lambda t, i: ref_embedding_bag(t, i, mode="mean"))


def make(v, d, b, length, integer, seed=0):
    """Table and ids with about a third padding, bag 0 all padding and
    bag 1 holding row 0 and row V - 1."""
    rng = np.random.default_rng(seed)
    if integer:
        table = rng.integers(-8, 9, size=(v, d)).astype(np.float32)
    else:
        table = rng.standard_normal((v, d)).astype(np.float32)
    ids = rng.integers(0, v, size=(b, length)).astype(np.int32)
    ids[rng.random(ids.shape) < 0.3] = -1
    ids[0] = -1
    if b > 1:
        ids[1, 0] = 0
        ids[1, -1] = v - 1
    return table, ids


def port(table, ids, mode="sum"):
    before = embedding_bag.launches
    out = embedding_bag(torch.from_numpy(table), torch.from_numpy(ids), mode=mode)
    assert embedding_bag.launches == before  # CPU tensors launch nothing
    assert out.dtype == torch.float32 and out.shape == (ids.shape[0], table.shape[1])
    return out.numpy()


def abs_sum(table, ids):
    """Per element, the sum of |rows| of the bag's valid ids (float64)."""
    rows = np.abs(table[np.maximum(ids, 0)].astype(np.float64))
    return (rows * (ids >= 0)[..., None]).sum(1)


def assert_within(got, want, scale, tol):
    err = np.abs(got.astype(np.float64) - np.asarray(want, np.float64))
    assert (err <= tol * scale).all(), float((err - tol * scale).max())


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
def test_plain_matches_interpret_kernel_bit_for_bit(integer):
    for i, (v, d, b, length) in enumerate(CASES):
        table, ids = make(v, d, b, length, integer, seed=i)
        got = port(table, ids)
        want = np.asarray(_interp(jnp.asarray(table), jnp.asarray(ids)))
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), (v, d, b, length)
        # A bag of padding only is +0.0 in both.
        assert np.array_equal(got[0].view(np.int32), np.zeros(d, np.int32))


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
def test_plain_matches_ref_and_model_sum(integer):
    for i, (v, d, b, length) in enumerate(CASES + [(300, 16, 40, 50), (100, 10, 9, 1)]):
        table, ids = make(v, d, b, length, integer, seed=10 + i)
        got = port(table, ids)
        t, x = jnp.asarray(table), jnp.asarray(ids)
        port_model = embedding_bag_sum(torch.from_numpy(table), torch.from_numpy(ids)).numpy()
        assert np.array_equal(port_model, got)
        for want in (np.asarray(_oracle(t, x)), np.asarray(_model_sum(t, x))):
            if integer:
                assert np.array_equal(got, want)
            else:
                assert_within(got, want, abs_sum(table, ids), 1e-6)


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
def test_mean_mode_matches_ops(integer):
    for i, (v, d, b, length) in enumerate(CASES):
        table, ids = make(v, d, b, length, integer, seed=20 + i)
        got = port(table, ids, mode="mean")
        want = np.asarray(_mean(jnp.asarray(table), jnp.asarray(ids)))
        counts = np.maximum((ids >= 0).sum(-1, keepdims=True), 1)
        if integer:  # a sum of integers over an integer count: one rounding
            assert np.array_equal(got, want)
        else:
            assert_within(got, want, abs_sum(table, ids) / counts, 1e-6)
        assert np.array_equal(got[0], np.zeros(d, np.float32))  # max(count, 1)
        # mean is the port's own sum over the count, in float32
        assert np.array_equal(got, port(table, ids) / counts.astype(np.float32))


def test_modes_and_dispatch():
    table, ids = make(20, 4, 3, 4, True)
    t, x = torch.from_numpy(table), torch.from_numpy(ids)
    with pytest.raises(ValueError, match="unknown mode"):
        embedding_bag(t, x, mode="max")
    with pytest.raises(ValueError):
        ref_embedding_bag(jnp.asarray(table), jnp.asarray(ids), mode="max")
    assert "embedding_bag" in KERNEL_STEMS
    assert dispatch(t.device, embedding_bag_cuda, embedding_bag_plain) is embedding_bag_plain
    assert dispatch(torch.device("cuda"), embedding_bag_cuda,
                    embedding_bag_plain) is embedding_bag_cuda
    # The kernel's wrapper checks its inputs before it builds anything.
    with pytest.raises(ValueError):
        embedding_bag_cuda(t, x.long())
    with pytest.raises(ValueError):
        embedding_bag_cuda(t.double(), x)
    with pytest.raises(ValueError):
        embedding_bag_cuda(t.T, x)
    # L = 0 and B = 0
    assert torch.equal(embedding_bag(t, x[:, :0]), torch.zeros((3, 4)))
    assert embedding_bag(t, x[:0]).shape == (0, 4)
