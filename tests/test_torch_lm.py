"""The dense GQA transformer in the port against the reference's, on the CPU.

The reference's parameters (``init_params`` at PRNGKey(0), layers stacked
on a leading axis) cross through ``interop.lm_params_from_reference``, bf16
leaves through their uint16 bits. Checked:

- ``smoke-gqa`` (float32): ``prefill_logits`` against the reference's
  within 1e-5 relative of the logits' largest; eight decode steps, one
  token at a time from a zero cache, against the reference's
  ``decode_step``: every step's logits within the same tolerance and the
  cache's k / v within 1e-5 of their largest; decode equal to teacher
  forcing (``forward_hidden`` @ lm_head at every position) within the
  reference's own 2e-3 (``tests/test_models.py``);
- the cache is written in place: the same tensors, rows past ``pos``
  untouched, ``pos`` + 1;
- a bf16 case (``smoke-gqa`` widths, bf16 params and compute, as the
  published configs): prefill and two decode steps against the
  reference within 0.06 absolute on logits up to ~2.2 (a few bf16
  roundings of the residual stream in other orders; 0.017 seen);
- ``param_count`` equal to the reference's for granite-3-2b,
  command-r-35b and command-r-plus-104b; the configs equal field for
  field; the LM roofline terms equal the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.archs.base import get_arch as ref_get_arch
from repro.distributed.meshinfo import single_device_meshinfo
from repro.models.transformer import model as ref_tm
from repro.roofline import model as ref_roof
from repro_torch.archs import get_arch
from repro_torch.configs import NOT_PORTED
from repro_torch.interop import lm_params_from_reference
from repro_torch.models.transformer import (
    TransformerConfig,
    decode_step,
    forward_hidden,
    init_cache,
    prefill_logits,
)
from repro_torch.roofline import model as roof
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse fixture)

MI = single_device_meshinfo()
GQA_NAMES = ("granite-3-2b", "command-r-35b", "command-r-plus-104b", "smoke-gqa")


def port_cfg(ref_cfg) -> TransformerConfig:
    kw = {f.name: getattr(ref_cfg, f.name) for f in dataclasses.fields(ref_cfg)}
    for k in ("param_dtype", "compute_dtype"):
        kw[k] = getattr(torch, np.dtype(kw[k]).name)
    return TransformerConfig(**kw)


def setup(dtype=jnp.float32):
    ref_cfg = dataclasses.replace(ref_get_arch("smoke-gqa").cfg, param_dtype=dtype,
                                  compute_dtype=dtype)
    params = ref_tm.init_params(jax.random.PRNGKey(0), ref_cfg)
    cfg = port_cfg(ref_cfg)
    model = lm_params_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")
    model.requires_grad_(False)
    return ref_cfg, params, cfg, model


def close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rtol * max(float(np.abs(want).max()), 1e-30))


def tokens(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


def test_configs_match_reference():
    for name in GQA_NAMES:
        ref_arch, arch = ref_get_arch(name), get_arch(name)
        assert arch.cfg == port_cfg(ref_arch.cfg), name
        assert (arch.shapes, arch.optimizer_name, arch.grad_accum) == (
            ref_arch.shapes, ref_arch.optimizer_name, ref_arch.grad_accum), name
    # the MLA / MoE configs are held field for field in test_torch_lm_deepseek.py
    for name in ("deepseek-v2-236b", "deepseek-v3-671b", "smoke-mla-moe"):
        assert name not in NOT_PORTED
        assert get_arch(name).cfg == port_cfg(ref_get_arch(name).cfg)
    # train_4k builds its step (held to the reference's in test_torch_lm_train.py)
    assert get_arch("smoke-gqa").make_cell("train_4k").kind == "train"


@pytest.mark.parametrize("name", GQA_NAMES[:3])
def test_param_count_matches_reference(name):
    ref_cfg = ref_get_arch(name).cfg
    cfg = port_cfg(ref_cfg)
    assert cfg.param_count() == ref_cfg.param_count()
    assert cfg.active_param_count() == ref_cfg.active_param_count()
    assert roof._lm_matmul_params(cfg) == ref_roof._lm_matmul_params(ref_cfg)
    for b, s in ((1, 32768), (32, 32768), (256, 4096)):
        assert roof.lm_prefill_terms(cfg, b, s, 1) == ref_roof.lm_prefill_terms(ref_cfg, b, s, 1)
        assert roof.lm_decode_terms(cfg, b, s, 4) == ref_roof.lm_decode_terms(ref_cfg, b, s, 4)
    bound = roof.lm_serve_bound(cfg, "decode", 16, 32768)
    assert bound["bound_by"] == "bytes" and bound["hbm_bytes"] == ref_roof.lm_decode_terms(
        ref_cfg, 16, 32768, 1)[1]


def test_prefill_and_decode_match_reference():
    ref_cfg, params, cfg, model = setup()
    toks = tokens(2, 8, cfg.vocab_size)
    want = jax.jit(lambda p, t: ref_tm.prefill_logits(p, ref_cfg, MI, t))(params, toks)
    got = prefill_logits(model, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, cfg.vocab_padded)
    close(got.numpy(), want)

    ref_step = jax.jit(lambda p, c, t: ref_tm.decode_step(p, ref_cfg, MI, c, t))
    ref_cache = ref_tm.init_cache(ref_cfg, 2, 8)
    cache = init_cache(cfg, 2, 8, device="cpu")
    k_ptr = cache["k"].data_ptr()
    for t in range(8):
        want, ref_cache = ref_step(params, ref_cache, toks[:, t])
        got, cache = decode_step(model, cache, torch.from_numpy(toks[:, t]))
        close(got.numpy(), want)
        for key in ("k", "v"):
            close(cache[key].numpy(), ref_cache[key])
        assert int(cache["pos"]) == int(ref_cache["pos"]) == t + 1
    assert cache["k"].data_ptr() == k_ptr


def test_decode_equals_teacher_forcing_and_writes_in_place():
    _, _, cfg, model = setup()
    toks = torch.from_numpy(tokens(2, 12, cfg.vocab_size, seed=3))
    ref = model.lm_head(forward_hidden(model, toks)).float()
    cache = init_cache(cfg, 2, 16, device="cpu")
    k, v = cache["k"], cache["v"]
    outs = []
    for t in range(12):
        lg, cache = decode_step(model, cache, toks[:, t])
        outs.append(lg)
        assert cache["k"] is k and cache["v"] is v
        assert not k[:, :, t + 1 :].any() and k[:, :, t].abs().sum() > 0
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), ref.numpy(), atol=2e-3)
    # the cells run the same path under inference_mode
    arch = get_arch("smoke-gqa")
    model2, cache2, tok = arch.make_cell("decode_32k").make_inputs(0, "cpu")
    logits, cache2 = arch.make_cell("decode_32k").fn(model2, cache2, tok)
    assert logits.shape == (4, cfg.vocab_padded) and int(cache2["pos"]) == 1
    model3, toks3 = arch.make_cell("prefill_32k").make_inputs(0, "cpu")
    assert toks3.shape == (2, 64) and arch.make_cell("prefill_32k").fn(model3, toks3).shape == (
        2, cfg.vocab_padded)


def test_bf16_matches_reference():
    ref_cfg, params, cfg, model = setup(jnp.bfloat16)
    assert model.lm_head.weight.dtype == torch.bfloat16
    assert torch.equal(model.lm_head.weight.T.float(),
                       torch.from_numpy(np.asarray(params["lm_head"]["w"], np.float32)))
    toks = tokens(2, 8, cfg.vocab_size, seed=4)
    want = np.asarray(jax.jit(lambda p, t: ref_tm.prefill_logits(p, ref_cfg, MI, t))(
        params, toks))
    got = prefill_logits(model, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=0.06, rtol=0)
    ref_step = jax.jit(lambda p, c, t: ref_tm.decode_step(p, ref_cfg, MI, c, t))
    ref_cache = ref_tm.init_cache(ref_cfg, 2, 8)
    cache = init_cache(cfg, 2, 8, device="cpu")
    assert cache["k"].dtype == torch.bfloat16
    for t in range(2):
        want, ref_cache = ref_step(params, ref_cache, toks[:, t])
        got, cache = decode_step(model, cache, torch.from_numpy(toks[:, t]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0.06, rtol=0)
