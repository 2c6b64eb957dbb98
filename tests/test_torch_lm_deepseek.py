"""The MLA / MoE transformer (the DeepSeek family) in the port against the
reference's, on the CPU.

The reference's ``smoke-mla-moe`` parameters (one dense and one MoE layer,
MLA with a q LoRA, 8 experts top-2 with a shared expert, MTP; PRNGKey(0))
cross through ``interop.lm_params_from_reference``. Checked:

- ``smoke-mla-moe`` (float32): ``prefill_logits`` against the reference's,
  and eight decode steps from a zero cache against the reference's
  ``decode_step``: logits within 1e-5 of their largest, the latent cache
  within 1e-5 of its largest, ``pos`` + 1 a step, the cache in place;
- a bf16 case (the published dtypes at smoke widths): prefill and four
  decode steps within 0.06 absolute on logits up to ~2.3 (a few bf16
  roundings in other orders; 0.013 seen), as the GQA case holds, except
  a decode row whose router had a near tie at the threshold (the k-th and
  next bf16 probabilities within 2 ulps: step 0's second row here, 0.076
  apart): the two packages' MoE inputs differ by roundings, so such a row
  may route to another expert; it is held only to be finite;
- ``param_count`` and ``active_param_count`` equal to the reference's for
  deepseek-v2-236b (235.74e9) and deepseek-v3-671b (671.72e9), the MTP
  block's parameters loaded as the reference's;
- the three configs equal the reference's field for field, with their
  shapes, optimizer and grad_accum;
- the LM roofline terms (``_lm_matmul_params``, ``lm_prefill_terms``,
  ``lm_decode_terms``) equal the reference's for both DeepSeek configs;
- the cells: ``make_cell`` serves ``smoke-mla-moe`` on one device and over
  a (1, 4) mesh of the CPU (the cache laid out as four sequence shards);
  train_4k builds its step on one device and over the mesh, where the
  cell carries a layout for every parameter (the steps are held to the
  reference's in test_torch_lm_train.py and, over meshes,
  test_torch_train_mesh_lm.py).
"""
import copy
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
from repro_torch.distributed import MeshInfo
from repro_torch.distributed.layout import whole_leaves
from repro_torch.interop import lm_params_from_reference
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.transformer import decode_step, init_cache, prefill_logits
from repro_torch.models.transformer.moe import _router_probs
from repro_torch.roofline import model as roof
from repro_torch.train import reference_layout
from test_torch_lm import close, port_cfg, tokens
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse fixture)

MI = single_device_meshinfo()
DEEPSEEK = ("deepseek-v2-236b", "deepseek-v3-671b")
NEAR_TIE_ULPS = 2


def setup(dtype=jnp.float32):
    ref_cfg = dataclasses.replace(ref_get_arch("smoke-mla-moe").cfg, param_dtype=dtype,
                                  compute_dtype=dtype)
    params = ref_tm.init_params(jax.random.PRNGKey(0), ref_cfg)
    cfg = port_cfg(ref_cfg)
    model = lm_params_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")
    model.requires_grad_(False)
    return ref_cfg, params, cfg, model


def test_prefill_and_decode_match_reference():
    ref_cfg, params, cfg, model = setup()
    assert (cfg.n_dense, cfg.n_moe, cfg.attn_type, cfg.mtp) == (1, 1, "mla", True)
    toks = tokens(2, 8, cfg.vocab_size)
    want = jax.jit(lambda p, t: ref_tm.prefill_logits(p, ref_cfg, MI, t))(params, toks)
    got = prefill_logits(model, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, cfg.vocab_padded)
    close(got.numpy(), want)

    ref_step = jax.jit(lambda p, c, t: ref_tm.decode_step(p, ref_cfg, MI, c, t))
    ref_cache = ref_tm.init_cache(ref_cfg, 2, 8)
    cache = init_cache(cfg, 2, 8, device="cpu")
    c = cache["c"]
    assert tuple(c.shape) == (2, 2, 8, cfg.kv_lora_rank + cfg.d_rope) and set(cache) == {"c", "pos"}
    for t in range(8):
        want, ref_cache = ref_step(params, ref_cache, toks[:, t])
        got, cache = decode_step(model, cache, torch.from_numpy(toks[:, t]))
        close(got.numpy(), want)
        close(cache["c"].numpy(), ref_cache["c"])
        assert cache["c"] is c and int(cache["pos"]) == int(ref_cache["pos"]) == t + 1


def near_ties(mp, cfg, sink):
    """A pre-hook on the MoE ``mp`` adding to ``sink`` the rows whose top_k-th
    and next router probabilities (bf16) lie within NEAR_TIE_ULPS ulps."""
    def hook(module, args):
        x = args[0]
        p = _router_probs(mp, x).to(x.dtype).float().reshape(x.shape[0], -1)
        top = p.sort(-1, descending=True).values
        kth, nxt = top[:, cfg.top_k - 1], top[:, cfg.top_k]
        ulp = torch.exp2(torch.floor(torch.log2(kth)) - 7)
        sink.update((kth - nxt <= NEAR_TIE_ULPS * ulp).nonzero()[:, 0].tolist())
    return mp.register_forward_pre_hook(hook)


def test_bf16_matches_reference():
    """Logits within 0.06; a decode row whose MoE router had a near tie at
    the threshold (the k-th and next probabilities within 2 bf16 ulps) may
    route to another expert than the reference's, whose MoE input carries
    other roundings: such rows are counted and held only to be finite."""
    ref_cfg, params, cfg, model = setup(jnp.bfloat16)
    assert model.moe_layers[0].ffn.experts.w1.dtype == torch.bfloat16
    assert model.moe_layers[0].ffn.router.weight.dtype == torch.float32
    toks = tokens(2, 8, cfg.vocab_size, seed=4)
    want = np.asarray(jax.jit(lambda p, t: ref_tm.prefill_logits(p, ref_cfg, MI, t))(
        params, toks))
    got = prefill_logits(model, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=0.06, rtol=0)
    ref_step = jax.jit(lambda p, c, t: ref_tm.decode_step(p, ref_cfg, MI, c, t))
    ref_cache = ref_tm.init_cache(ref_cfg, 2, 8)
    cache = init_cache(cfg, 2, 8, device="cpu")
    assert cache["c"].dtype == torch.bfloat16
    held = 0
    for t in range(4):
        tied = set()
        hook = near_ties(model.moe_layers[0].ffn, cfg, tied)
        want, ref_cache = ref_step(params, ref_cache, toks[:, t])
        got, cache = decode_step(model, cache, torch.from_numpy(toks[:, t]))
        hook.remove()
        assert np.isfinite(got.numpy()).all()
        for row in set(range(2)) - tied:
            np.testing.assert_allclose(got[row].numpy(), np.asarray(want)[row], atol=0.06, rtol=0)
            held += 1
    assert held >= 6


@pytest.mark.parametrize("name,billions", [("deepseek-v2-236b", 235.74),
                                           ("deepseek-v3-671b", 671.72)])
def test_param_count_matches_reference(name, billions):
    ref_cfg = ref_get_arch(name).cfg
    cfg = port_cfg(ref_cfg)
    assert cfg.param_count() == ref_cfg.param_count()
    assert round(cfg.param_count() / 1e9, 2) == billions
    assert cfg.active_param_count() == ref_cfg.active_param_count()


def test_mtp_parameters_load_as_the_reference():
    _, params, _, model = setup()
    got = {k: v.detach() for k, v in model.mtp.named_parameters()}
    mtp = jax.tree.map(np.array, params["mtp"])
    assert torch.equal(got["proj.weight"].T, torch.from_numpy(mtp["proj"]["w"]))
    assert torch.equal(got["layer.attn.wkv_b.weight"].T,
                       torch.from_numpy(mtp["layer"]["attn"]["wkv_b"]["w"]))
    assert torch.equal(got["norm.scale"], torch.from_numpy(mtp["norm"]["scale"]))
    assert len(got) == len(jax.tree.leaves(params["mtp"]))


def test_configs_match_reference():
    for name in DEEPSEEK + ("smoke-mla-moe",):
        ref_arch, arch = ref_get_arch(name), get_arch(name)
        assert name not in NOT_PORTED
        assert arch.cfg == port_cfg(ref_arch.cfg), name
        assert (arch.shapes, arch.optimizer_name, arch.grad_accum) == (
            ref_arch.shapes, ref_arch.optimizer_name, ref_arch.grad_accum), name


@pytest.mark.parametrize("name", DEEPSEEK)
def test_roofline_terms_match_reference(name):
    ref_cfg = ref_get_arch(name).cfg
    cfg = port_cfg(ref_cfg)
    assert roof._lm_matmul_params(cfg) == ref_roof._lm_matmul_params(ref_cfg)
    for b, s in ((1, 32768), (128, 32768), (1, 524288), (256, 4096)):
        assert roof.lm_prefill_terms(cfg, b, s, 1) == ref_roof.lm_prefill_terms(ref_cfg, b, s, 1)
        assert roof.lm_decode_terms(cfg, b, s, 4) == ref_roof.lm_decode_terms(ref_cfg, b, s, 4)
    bound = roof.lm_serve_bound(cfg, "decode", 1, 524288)
    assert bound["hbm_bytes"] == ref_roof.lm_decode_terms(ref_cfg, 1, 524288, 1)[1]


def test_cells_serve_on_one_device_and_a_mesh():
    """The serve cells over a (1, 4) mesh turn a whole model resident at
    their first call (``make_resident``, in place: a copy of the one-device
    model here) and serve it tensor-parallel, equal to one device's."""
    arch = get_arch("smoke-mla-moe")
    cfg = arch.cfg
    model, toks = arch.make_cell("prefill_32k").make_inputs(0, "cpu")
    assert toks.shape == (2, 64)
    want = arch.make_cell("prefill_32k").fn(model, toks)
    mi = MeshInfo(mesh=make_test_mesh(4, model=4, device="cpu"))
    resident = copy.deepcopy(model)
    close(arch.make_cell("prefill_32k", mi).fn(resident, toks).numpy(), want.numpy(), rtol=1e-6)
    assert not whole_leaves(resident)
    _, cache, tok = arch.make_cell("decode_32k").make_inputs(0, "cpu")
    _, mesh_cache, _ = arch.make_cell("decode_32k", mi).make_inputs(0, "cpu")
    assert len(mesh_cache["c"]) == 1 and len(mesh_cache["c"][0]) == 4
    assert tuple(mesh_cache["c"][0][0].shape) == (cfg.n_layers, 4, 16, 24)
    logits, cache = arch.make_cell("decode_32k").fn(model, cache, tok)
    mesh_logits, mesh_cache = arch.make_cell("decode_32k", mi).fn(resident, mesh_cache, tok)
    assert logits.shape == (4, cfg.vocab_padded) and int(mesh_cache["pos"]) == 1
    close(mesh_logits.numpy(), logits.numpy(), rtol=1e-6)
    with pytest.raises(ValueError, match="layout"):
        decode_step(model, cache, tok, mi)
    assert arch.make_cell("train_4k").kind == "train"
    assert arch.make_cell("train_4k").specs is None
    assert set(arch.make_cell("train_4k", mi).specs) == set(reference_layout(model))
