"""The port's flash attention (``repro_torch.models.common.flash``) against
the reference's (``repro.models.common.flash``), on the CPU, on inputs
drawn from a numpy seed.

- the forward and its lse against the reference's ``_fwd_core``, and the
  gradients of sum(out * w) against ``jax.grad`` of the reference's
  ``flash_attention`` (its custom VJP): within 2e-6 absolute (float32
  products and sums of at most a few hundred terms, added in other orders;
  the values are O(1)), lse's -inf rows at the same places;
- cases: causal and not, a q_offset that leaves the first rows fully
  masked (lse -inf, output and gradients 0), a padded tail chunk, a soft
  cap, GQA with g = 1, 2 and 4, a chunk longer than Skv, bf16 inputs
  (within one bf16 ulp of the output's scale);
- the gradients of sum(cos(attention)) against a naive softmax attention
  (the reference's ``tests/test_models.py`` check), in the port and in
  the reference: within 2e-5, the reference's own tolerance.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.common import flash as ref_flash
from repro.models.common.modules import chunked_attention as ref_chunked_attention
from repro_torch.models.common.flash import AttnMeta, _fwd_core, flash_attention
from repro_torch.models.common.modules import chunked_attention
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse fixture)

# (causal, q_offset, chunk, soft_cap, g, sq, skv, dtype)
CASES = {
    "causal_g2": (True, 0, 5, 0.0, 2, 16, 16, "float32"),
    "full_padded_tail": (False, 0, 7, 0.0, 1, 9, 20, "float32"),
    "offset_masked_rows": (True, -3, 4, 0.0, 2, 10, 10, "float32"),
    "soft_cap_offset": (True, 4, 6, 3.0, 2, 8, 12, "float32"),
    "g4_one_chunk": (True, 0, 512, 0.0, 4, 33, 33, "float32"),
    "bf16": (True, 0, 8, 0.0, 2, 24, 24, "bfloat16"),
}
ATOL = 2e-6


def inputs(seed, g, sq, skv, dtype, hkv=2, dh=8, b=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hkv * g, dh)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, dh)).astype(np.float32)
    w = rng.standard_normal((b, sq, hkv * g, dh)).astype(np.float32)
    jx = [jnp.asarray(a, jnp.dtype(dtype)) for a in (q, k, v)]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    return jx, tx, w


@pytest.mark.parametrize("case", list(CASES))
def test_forward_lse_and_grads_match_reference(case):
    causal, off, chunk, cap, g, sq, skv, dtype = CASES[case]
    (jq, jk, jv), (tq, tk, tv), w = inputs(list(CASES).index(case), g, sq, skv, dtype)
    rmeta = ref_flash.AttnMeta(causal, off, chunk, cap, None)
    meta = AttnMeta(causal, off, chunk, cap)
    ref_out, ref_lse = jax.jit(lambda a, b, c: ref_flash._fwd_core(a, b, c, rmeta))(jq, jk, jv)
    out, lse = _fwd_core(tq, tk, tv, meta)
    assert out.dtype == tq.dtype and tuple(out.shape) == ref_out.shape
    ref_out = np.asarray(ref_out.astype(jnp.float32))
    ref_lse = np.asarray(ref_lse)
    # bf16: the output is rounded to bf16 (relative 2^-8 of values up to ~3)
    out_tol = ATOL if dtype == "float32" else 2.0 ** -8 * 4
    np.testing.assert_allclose(out.float().numpy(), ref_out, atol=out_tol, rtol=0)
    finite = np.isfinite(ref_lse)
    assert np.array_equal(finite, np.isfinite(lse.numpy()))
    np.testing.assert_allclose(lse.numpy()[finite], ref_lse[finite], atol=ATOL, rtol=0)
    if case == "offset_masked_rows":
        assert not finite.all() and not np.abs(ref_out[:, :3]).any()
    if dtype != "float32":
        return
    ref_g = jax.jit(jax.grad(
        lambda a, b, c: jnp.sum(ref_flash.flash_attention(a, b, c, rmeta) * w),
        argnums=(0, 1, 2)))(jq, jk, jv)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    (flash_attention(*leaves, meta) * torch.from_numpy(w)).sum().backward()
    for name, want, got in zip("qkv", ref_g, leaves):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), atol=ATOL, rtol=0,
                                   err_msg=f"d{name}")


def naive_torch(q, k, v):
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) / math.sqrt(dh)
    mask = torch.tril(torch.ones((sq, sq), dtype=torch.bool))
    p = torch.softmax(s.masked_fill(~mask, -math.inf), dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh)


def naive_jax(q, k, v):
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, dh)
    s = jnp.einsum("bqhgd,bkhd->bhgqk", qg, k) / jnp.sqrt(dh)
    s = jnp.where(jnp.tril(jnp.ones((sq, sq), bool))[None, None, None], s, -jnp.inf)
    o = jnp.einsum("bhgqk,bkhd->bhgqd", jax.nn.softmax(s, axis=-1), v)
    return o.transpose(0, 3, 1, 2, 4).reshape(b, sq, h, dh)


def test_grads_match_naive_softmax():
    """tests/test_models.py's check (B 2, S 16, H 4, Hkv 2, dh 8, chunk 5),
    the port's gradients against both naive versions and the reference's."""
    (jq, jk, jv), (tq, tk, tv), _ = inputs(7, 2, 16, 16, "float32")
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    torch.cos(chunked_attention(*leaves, causal=True, chunk=5)).sum().backward()
    naive = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    torch.cos(naive_torch(*naive)).sum().backward()
    f_ref = lambda *a: jnp.sum(jnp.cos(ref_chunked_attention(*a, causal=True, chunk=5)))
    f_naive = lambda *a: jnp.sum(jnp.cos(naive_jax(*a)))
    g_ref = jax.grad(f_ref, argnums=(0, 1, 2))(jq, jk, jv)
    g_naive = jax.grad(f_naive, argnums=(0, 1, 2))(jq, jk, jv)
    for got, nv, want, want_naive in zip(leaves, naive, g_ref, g_naive):
        np.testing.assert_allclose(got.grad.numpy(), nv.grad.numpy(), atol=2e-5)
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want_naive), atol=2e-5)
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), atol=ATOL)


def test_chunking_and_inference_mode():
    """The chunk length changes nothing but the order of the online sums
    (within 2e-6 of one chunk); under inference_mode no graph is kept."""
    _, (tq, tk, tv), _ = inputs(3, 2, 40, 40, "float32")
    whole = chunked_attention(tq, tk, tv, causal=True, chunk=64)
    for chunk in (1, 7, 16):
        got = chunked_attention(tq, tk, tv, causal=True, chunk=chunk)
        np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=ATOL)
    with torch.inference_mode():
        out = chunked_attention(tq.requires_grad_(), tk, tv, causal=False)
    assert not out.requires_grad
