"""MLA (DeepSeek multi-head latent attention) in the port against the
reference's, on the CPU.

The reference's parameters (``init_params`` of ``smoke-mla-moe`` at
PRNGKey(0)) cross through ``interop.lm_params_from_reference``; the
attention under test is the first dense layer's. Checked:

- ``mla_train`` (the expanded prefill path) against the reference's, with
  and without a q LoRA (``wq_a`` / ``q_norm`` / ``wq_b`` or ``wq``):
  float32 within 1e-5 of the output's largest element;
- ``mla_decode_attend`` (absorbed W_uk / W_uv over the latent cache)
  against the reference's with ``seq_axis=None``, over a 16-row cache and
  a 16,384-row one (two 8,192-row chunks): the output within 1e-5 of its
  largest, the written cache within 1e-5 of its largest;
- a bf16 case (published dtypes at smoke widths): both paths within 3e-2
  of the largest output element, the written row within 2^-7 (bf16 keeps
  8 bits of mantissa, and the two packages may round their products in
  other orders; equal bits seen at these inputs);
- the latent cache is written in place: the same storage, only row
  ``pos`` changed; over four sequence shards only the shard holding
  ``pos`` writes, and the log-sum-exp combination equals the one-shard
  result within 1e-6 of its largest;
- decode equals teacher forcing on a dense MLA config (``smoke-mla-moe``
  with no experts) within the reference's 2e-3 (``tests/test_models.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.archs.base import get_arch as ref_get_arch
from repro.distributed.meshinfo import single_device_meshinfo
from repro.models.transformer import attention as ref_attn
from repro.models.transformer import model as ref_tm
from repro_torch.interop import lm_params_from_reference
from repro_torch.models.transformer import decode_step, forward_hidden, init_cache, init_params
from repro_torch.models.transformer.attention import mla_decode_attend, mla_train
from test_torch_lm import close, port_cfg, tokens
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse fixture)

MI = single_device_meshinfo()
BF16_TOL = 3e-2  # of the largest output element


def setup(dtype=jnp.float32, **overrides):
    ref_cfg = dataclasses.replace(ref_get_arch("smoke-mla-moe").cfg, param_dtype=dtype,
                                  compute_dtype=dtype, **overrides)
    params = ref_tm.init_params(jax.random.PRNGKey(0), ref_cfg)
    cfg = port_cfg(ref_cfg)
    model = lm_params_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")
    model.requires_grad_(False)
    ref_ap = jax.tree.map(lambda a: a[0], params["dense_layers"])["attn"]
    return ref_cfg, ref_ap, cfg, model.dense_layers[0].attn


def normal(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32).astype(dtype)


def to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("q_lora", [32, 0], ids=["q_lora", "wq"])
def test_mla_train_matches_reference(q_lora):
    ref_cfg, ref_ap, cfg, ap = setup(q_lora_rank=q_lora)
    assert hasattr(ap, "wq_a") == bool(q_lora) and hasattr(ap, "wq") != bool(q_lora)
    x = normal((2, 8, cfg.d_model), 1)
    pos = np.arange(8)
    want = jax.jit(lambda p, x: ref_attn.mla_train(p, ref_cfg, MI, x, jnp.asarray(pos)))(ref_ap, x)
    got = mla_train(ap, cfg, torch.from_numpy(x), torch.from_numpy(pos))
    assert got.shape == (2, 8, cfg.d_model)
    close(got.numpy(), want)


def ref_decode(ref_cfg, ref_ap, x, cache, pos):
    fn = jax.jit(lambda p, x, c: ref_attn.mla_decode_attend(
        p, ref_cfg, x, c, jnp.int32(pos), seq_axis=None, shard_idx=jnp.int32(0)))
    return fn(ref_ap, x, cache)


@pytest.mark.parametrize("q_lora,s", [(32, 16), (0, 16), (32, 16384)],
                         ids=["q_lora", "wq", "two_chunks"])
def test_mla_decode_attend_matches_reference(q_lora, s):
    ref_cfg, ref_ap, cfg, ap = setup(q_lora_rank=q_lora)
    row = cfg.kv_lora_rank + cfg.d_rope
    x, cache, pos = normal((2, cfg.d_model), 2), normal((2, s, row), 3), s - 11
    want, want_cache = ref_decode(ref_cfg, ref_ap, x, cache, pos)
    c = torch.from_numpy(cache.copy())
    got, got_cache = mla_decode_attend(ap, cfg, torch.from_numpy(x), c, torch.tensor(pos))
    assert got_cache is c and got.shape == (2, cfg.d_model)
    close(got.numpy(), want)
    close(c.numpy(), want_cache)


def test_mla_bf16_matches_reference():
    ref_cfg, ref_ap, cfg, ap = setup(jnp.bfloat16)
    assert ap.wkv_b.weight.dtype == torch.bfloat16
    x = normal((2, 8, cfg.d_model), 4, jnp.bfloat16)
    pos = np.arange(8)
    want = np.asarray(jax.jit(lambda p, x: ref_attn.mla_train(
        p, ref_cfg, MI, x, jnp.asarray(pos)))(ref_ap, x), np.float32)
    got = mla_train(ap, cfg, to_torch(x), torch.from_numpy(pos)).float().numpy()
    close(got, want, rtol=BF16_TOL)
    row = cfg.kv_lora_rank + cfg.d_rope
    xt, cache = normal((2, cfg.d_model), 5, jnp.bfloat16), normal((2, 16, row), 6, jnp.bfloat16)
    want, want_cache = ref_decode(ref_cfg, ref_ap, xt, cache, 7)
    c = to_torch(cache)
    got, _ = mla_decode_attend(ap, cfg, to_torch(xt), c, torch.tensor(7))
    assert got.dtype == torch.bfloat16 and c.dtype == torch.bfloat16
    close(got.float().numpy(), np.asarray(want, np.float32), rtol=BF16_TOL)
    # the written row: one bf16 rounding of the latent projection apart
    close(c.float().numpy(), np.asarray(want_cache, np.float32), rtol=2**-7)


def test_latent_cache_written_in_place_and_sharded():
    _, _, cfg, ap = setup()
    row = cfg.kv_lora_rank + cfg.d_rope
    x, cache = torch.from_numpy(normal((2, cfg.d_model), 7)), normal((2, 32, row), 8)
    pos = torch.tensor(13)
    whole = torch.from_numpy(cache.copy())
    ptr = whole.data_ptr()
    out, got = mla_decode_attend(ap, cfg, x, whole, pos)
    assert got is whole and whole.data_ptr() == ptr
    changed = (whole.numpy() != cache).any(axis=(0, 2))
    assert changed.nonzero()[0].tolist() == [13]
    # four sequence shards of 8 rows: shard 1 holds position 13 (its row 5)
    shards = [torch.from_numpy(cache[:, i * 8 : (i + 1) * 8].copy()) for i in range(4)]
    out_s, got_s = mla_decode_attend(ap, cfg, x, shards, pos)
    assert got_s is shards
    for i, sh in enumerate(shards):
        rows = (sh.numpy() != cache[:, i * 8 : (i + 1) * 8]).any(axis=(0, 2)).nonzero()[0]
        assert rows.tolist() == ([5] if i == 1 else [])
    np.testing.assert_array_equal(torch.cat(shards, dim=1).numpy(), whole.numpy())
    close(out_s.numpy(), out.numpy(), rtol=1e-6)


def test_decode_equals_teacher_forcing_dense_mla():
    cfg = dataclasses.replace(port_cfg(ref_get_arch("smoke-mla-moe").cfg), n_experts=0,
                              mtp=False)
    assert cfg.n_dense == 2 and cfg.n_moe == 0
    model = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    model.requires_grad_(False)
    toks = torch.from_numpy(tokens(2, 12, cfg.vocab_size, seed=3))
    ref = model.lm_head(forward_hidden(model, toks)).float()
    cache = init_cache(cfg, 2, 16, device="cpu")
    c = cache["c"]
    outs = []
    for t in range(12):
        lg, cache = decode_step(model, cache, toks[:, t])
        outs.append(lg)
        assert cache["c"] is c and not c[:, :, t + 1 :].any()
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), ref.numpy(), atol=2e-3)
