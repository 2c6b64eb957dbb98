"""The gradient of the port's ``embedding_bag`` against the reference's, on
the CPU.

The reference has no TPU kernel for the backward: it differentiates the
jnp take + mask + sum (``models/recsys/models.py::embedding_bag_sum``),
which XLA scatters into a dense (V, D) table, and its wrapper's mean mode
(``kernels/embedding_bag/ops.py``, the jnp oracle on the CPU). The port's
``embedding_bag_backward_plain`` sorts the flattened ids stably and adds
each row's contributions in row-major (b, l) order from +0.0, the CUDA
kernel's order (``csrc/embedding_bag_backward.cu``; card == plain is
tests/test_torch_cuda_train.py).

Tolerances: bit for bit in sum mode on integer-valued upstream gradients
(every partial sum is exact in float32); within 1e-6 of the largest
element otherwise: on float gradients XLA's scatter may add a row's
contributions in another order, and mean mode's g / count is inexact.
``torch.autograd.gradcheck`` holds the plain forward and backward to
finite differences in float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag.ops import embedding_bag as ref_embedding_bag
from repro.models.recsys.models import embedding_bag_sum as ref_bag_sum
from repro_torch.kernels.embedding_bag import (
    embedding_bag,
    embedding_bag_backward,
    embedding_bag_backward_plain,
    embedding_bag_plain,
    sorted_keys,
)
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse fixture)

# (V, D, B, L): repeated ids (V small against B * L), D = 1, 10, 13, 16.
CASES = [(12, 16, 9, 8), (30, 10, 6, 5), (5, 13, 20, 7), (40, 1, 16, 1), (7, 16, 3, 40)]


def make(v, d, b, length, integer, seed=0):
    """ids with about a third padding, bag 0 all padding, bag 1 holding row
    0, row V - 1 and a repeat of row 0; an upstream gradient g (B, D)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, v, size=(b, length)).astype(np.int32)
    ids[rng.random(ids.shape) < 0.3] = -1
    ids[0] = -1
    if b > 1:
        ids[1, 0], ids[1, -1] = 0, v - 1
        if length > 2:
            ids[1, 1] = 0
    if integer:
        g = rng.integers(-8, 9, size=(b, d)).astype(np.float32)
    else:
        g = rng.standard_normal((b, d)).astype(np.float32)
    return ids, g


def ref_grad(ids, g, v, mode):
    """The reference's d_table: the vjp of its bag at a zero table."""
    d = g.shape[1]
    fn = (ref_bag_sum if mode == "sum"
          else lambda t, i: ref_embedding_bag(t, i, mode="mean"))
    _, vjp = jax.vjp(lambda t: fn(t, jnp.asarray(ids)), jnp.zeros((v, d), jnp.float32))
    return np.asarray(jax.jit(vjp)(jnp.asarray(g))[0])


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_plain_backward_matches_reference_grad(mode, integer):
    for i, (v, d, b, length) in enumerate(CASES):
        ids, g = make(v, d, b, length, integer, seed=i)
        want = ref_grad(ids, g, v, mode)
        got = embedding_bag_backward_plain(torch.from_numpy(ids), torch.from_numpy(g), v, mode)
        assert got.shape == (v, d) and got.dtype == torch.float32
        if integer and mode == "sum":
            assert np.array_equal(got.numpy(), want), (v, d, b, length)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())
        untouched = np.setdiff1d(np.arange(v), ids[ids >= 0])
        assert not got.numpy()[untouched].any()  # rows no bag reads stay +0.0


def test_autograd_function_gives_the_plain_backward():
    """``embedding_bag`` on a table that needs a gradient records the
    Function: its forward is the plain bag bit for bit and its backward
    ``embedding_bag_backward``; without a gradient it is the plain bag."""
    v, d, b, length = 12, 16, 9, 8
    ids, g = make(v, d, b, length, integer=False)
    rng = np.random.default_rng(7)
    table = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32)).requires_grad_()
    tid, tg = torch.from_numpy(ids), torch.from_numpy(g)
    for mode in ("sum", "mean"):
        out = embedding_bag(table, tid, mode=mode)
        assert out.requires_grad
        assert torch.equal(out.detach(), embedding_bag_plain(table.detach(), tid, mode))
        (grad,) = torch.autograd.grad(out, table, tg)
        assert torch.equal(grad, embedding_bag_backward(tid, tg, v, mode=mode))
        with torch.inference_mode():
            served = embedding_bag(table, tid, mode=mode)
        assert not served.requires_grad and torch.equal(served, out.detach())
    assert embedding_bag_backward.launches == 0  # the CPU never counts a launch


def test_gradcheck_float64():
    """Finite differences against the Function's backward in float64, both
    modes, with repeated ids and an all-padding bag."""
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(np.array([[0, 2, 2, -1], [-1, -1, -1, -1], [4, 0, -1, 1]], np.int32))
    for mode in ("sum", "mean"):
        table = torch.from_numpy(rng.standard_normal((5, 3))).requires_grad_()
        assert torch.autograd.gradcheck(lambda t, m=mode: embedding_bag(t, ids, mode=m),
                                        (table,), eps=1e-6, atol=1e-9)


def test_sorted_keys_order_and_clamp():
    """Padding sorts last as V, ids at or above V clamp to V - 1, equal ids
    keep their row-major (b, l) positions in order."""
    ids = torch.tensor([[3, -1, 9, 3], [1, 3, -1, 12]], dtype=torch.int32)
    keys, pos = sorted_keys(ids, 10)
    assert keys.tolist() == [1, 3, 3, 3, 9, 9, 10, 10]
    assert pos.tolist() == [4, 0, 3, 5, 2, 7, 1, 6]
    g = torch.arange(8, dtype=torch.float32).reshape(2, 4)
    out = embedding_bag_backward_plain(ids, g, 10)
    assert torch.equal(out[9], g[0] + g[1]) and torch.equal(out[3], g[0] + g[0] + g[1])
    assert torch.equal(out[1], g[1]) and not out[[0, 2, 4, 5, 6, 7, 8]].any()
