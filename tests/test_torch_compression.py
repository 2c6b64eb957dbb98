"""Int8 gradient compression (``train/compression.py``) against the
reference's (``repro.train.compression``) on the same numpy inputs: the
quantization and its error bound (``tests/test_runtime.py:86``), error
feedback conserving the gradient mass over steps (``:96``), and the
compressed mean over 8 positions against the exact mean
(``tests/test_distributed_multidev.py:68-74``, relative error < 0.02).

The reference's ``psum`` runs under ``jax.vmap`` with an axis name (8
positions on one host device); the port's mean is an in-order sum of the
positions' dequantized tensors. Quantization is bit for bit (``round``
is half to even in both); the means within 1e-6 of their largest element
(the sums' order), the residuals bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.train import compression as ref
from repro_torch.train.compression import (
    compressed_psum_mean,
    compressed_tree_psum_mean,
    dequantize_int8,
    quantize_int8,
)
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse)


def normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def test_int8_quantization_error_bound_and_reference_bits():
    x = normal(0, (16, 64), 3.0)
    x[3, 5] = 0.0
    x[4] = 0.0  # an all-zero row takes the 1e-12 floor
    q, s = quantize_int8(torch.from_numpy(x))
    rq, rs = ref.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    err = (dequantize_int8(q, s) - torch.from_numpy(x)).abs()
    assert bool((err.amax(-1) <= s[:, 0] * 0.5 + 1e-6).all())
    np.testing.assert_array_equal(dequantize_int8(q, s).numpy(),
                                  np.asarray(ref.dequantize_int8(rq, rs)))


def test_error_feedback_conserves_mass():
    """sum(dequantized) + residual == sum(true gradients) over 5 steps of
    decaying scale, and every step equals the reference's."""
    total_true = torch.zeros(4, 8)
    total_deq = torch.zeros(4, 8)
    err = torch.zeros(4, 8)
    ref_err = jnp.zeros((4, 8))
    for i in range(5):
        g = normal(i, (4, 8), 10.0 ** -i)
        total_true += torch.from_numpy(g)
        q, s = quantize_int8(torch.from_numpy(g) + err)
        deq = dequantize_int8(q, s)
        err = (torch.from_numpy(g) + err) - deq
        total_deq += deq
        rq, rs = ref.quantize_int8(jnp.asarray(g) + ref_err)
        ref_err = (jnp.asarray(g) + ref_err) - ref.dequantize_int8(rq, rs)
        np.testing.assert_array_equal(err.numpy(), np.asarray(ref_err))
    np.testing.assert_allclose((total_deq + err).numpy(), total_true.numpy(), rtol=1e-5,
                               atol=1e-6)


def _reference_mean(g, errs=None):
    """The reference's compressed_tree_psum_mean over a leading axis of
    positions (vmap with the axis name "dp")."""
    if errs is None:
        return jax.vmap(lambda x: ref.compressed_tree_psum_mean(x, "dp"), axis_name="dp")(g)
    return jax.vmap(lambda x, e: ref.compressed_tree_psum_mean(x, "dp", e), axis_name="dp")(
        g, errs)


def test_compressed_mean_over_8_positions_against_exact_and_reference():
    g = normal(3, (8, 32))  # one row a position, as the reference's 8-way "dp" mesh splits it
    shards = [{"w": torch.from_numpy(g[i : i + 1])} for i in range(8)]
    red, errs = compressed_tree_psum_mean(shards)
    exact = torch.from_numpy(g).mean(0, keepdim=True)
    rel = float((red["w"] - exact).abs().max() / (exact.abs().max() + 1e-9))
    assert rel < 0.02, rel
    ref_red, ref_errs = _reference_mean({"w": jnp.asarray(g[:, None])})
    want = np.asarray(ref_red["w"][0])
    np.testing.assert_allclose(red["w"].numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
    for i in range(8):
        np.testing.assert_array_equal(errs[i]["w"].numpy(), np.asarray(ref_errs["w"][i]))


def test_compressed_mean_carries_error_feedback_between_steps():
    """Two steps, the first's residuals fed to the second: the port's means
    and residuals equal the reference's, and a plain compressed_psum_mean
    of one leaf equals the tree form's."""
    g1, g2 = normal(5, (4, 3, 16)), normal(6, (4, 3, 16), 1e-3)
    _, errs = compressed_tree_psum_mean([{"w": torch.from_numpy(x)} for x in g1])
    red, errs2 = compressed_tree_psum_mean([{"w": torch.from_numpy(x)} for x in g2], errs)
    _, ref_errs = _reference_mean({"w": jnp.asarray(g1)})
    ref_red, ref_errs2 = _reference_mean({"w": jnp.asarray(g2)}, ref_errs)
    want = np.asarray(ref_red["w"][0])
    np.testing.assert_allclose(red["w"].numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
    for i in range(4):
        np.testing.assert_array_equal(errs2[i]["w"].numpy(), np.asarray(ref_errs2["w"][i]))
    mean, leaf_errs = compressed_psum_mean([torch.from_numpy(x) for x in g2],
                                           [e["w"] for e in errs])
    assert torch.equal(mean, red["w"])
    assert all(torch.equal(a, b["w"]) for a, b in zip(leaf_errs, errs2))
