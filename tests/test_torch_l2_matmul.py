"""The port's ``l2_matmul`` against the reference's, on the CPU.

``pairwise_sqdist`` takes its plain version here (``l2_matmul_plain``, the
reference's own non-kernel path ``squared_l2``). It is held against the
reference's Pallas kernel in interpret mode, with small blocks so several
k tiles, row tiles and column tiles run, and against its elementwise
oracle ``l2_matmul_ref``, on shared numpy inputs with ragged M, N and d.
Integer-valued inputs agree bit for bit (every product and partial sum is
exact in float32); float inputs within 1e-5 * (|q|^2 + |x|^2) per element,
because the expansion cancels near 0 and the kernel adds its norms per k
tile in another order.

The CUDA kernel is held against this plain version on the card by
test_torch_cuda_l2.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.l2_matmul.l2_matmul import l2_matmul as ref_l2_matmul
from repro.kernels.l2_matmul.ref import l2_matmul_ref
from repro_torch.kernels import KERNEL_STEMS, dispatch
from repro_torch.kernels.l2_matmul import l2_matmul_cuda, l2_matmul_plain, pairwise_sqdist
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse fixture)

SHAPES = [(7, 13, 8), (33, 70, 37), (1, 5, 3), (40, 9, 1), (17, 129, 20)]
BLOCKS = dict(bm=16, bn=32, bk=8)
_interp = jax.jit(lambda q, x: ref_l2_matmul(q, x, interpret=True, **BLOCKS))
_oracle = jax.jit(l2_matmul_ref)


def make(m, n, d, integer, seed=0):
    rng = np.random.default_rng(seed)
    if integer:
        return (rng.integers(-8, 9, size=(m, d)).astype(np.float32),
                rng.integers(-8, 9, size=(n, d)).astype(np.float32))
    return (rng.standard_normal((m, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32))


def tolerance(q, x):
    """1e-5 * (|q_i|^2 + |x_j|^2), per element."""
    q2 = (q.astype(np.float64) ** 2).sum(-1)
    x2 = (x.astype(np.float64) ** 2).sum(-1)
    return 1e-5 * (q2[:, None] + x2[None, :])


def port(q, x):
    before = pairwise_sqdist.launches
    out = pairwise_sqdist(torch.from_numpy(q), torch.from_numpy(x))
    assert pairwise_sqdist.launches == before  # CPU tensors launch nothing
    assert out.dtype == torch.float32 and out.shape == (q.shape[0], x.shape[0])
    return out.numpy()


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
def test_plain_matches_interpret_kernel(integer):
    for i, (m, n, d) in enumerate(SHAPES):
        q, x = make(m, n, d, integer, seed=i)
        got = port(q, x)
        want = np.asarray(_interp(jnp.asarray(q), jnp.asarray(x)))
        if integer:
            np.testing.assert_array_equal(got, want)
        else:
            assert (np.abs(got - want) <= tolerance(q, x)).all(), (m, n, d)
        assert (got >= 0).all()


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
def test_plain_matches_elementwise_oracle(integer):
    for i, (m, n, d) in enumerate(SHAPES):
        q, x = make(m, n, d, integer, seed=10 + i)
        got = port(q, x)
        want = np.asarray(_oracle(jnp.asarray(q), jnp.asarray(x)))
        if integer:
            np.testing.assert_array_equal(got, want)
        else:
            assert (np.abs(got - want) <= tolerance(q, x)).all(), (m, n, d)


def test_identical_rows_give_zero_and_nothing_negative():
    x, _ = make(20, 1, 16, False, seed=4)
    got = port(x, x)
    want = np.asarray(_interp(jnp.asarray(x), jnp.asarray(x)))
    assert (got >= 0).all() and (want >= 0).all()
    np.testing.assert_allclose(np.diag(got), 0.0, atol=1e-4)
    xi, _ = make(20, 1, 16, True, seed=4)
    np.testing.assert_array_equal(np.diag(port(xi, xi)), 0.0)  # exact on integers


def test_dispatch_and_registration():
    assert "l2_matmul" in KERNEL_STEMS
    assert dispatch(torch.device("cpu"), l2_matmul_cuda, l2_matmul_plain) is l2_matmul_plain
    assert dispatch(torch.device("cuda"), l2_matmul_cuda, l2_matmul_plain) is l2_matmul_cuda
    with pytest.raises(ValueError):  # the CUDA wrapper checks before it builds
        l2_matmul_cuda(torch.zeros(3, 4), torch.zeros(5, 3))
