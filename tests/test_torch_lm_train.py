"""LM training in the port against the reference's, on the CPU (float32).

The reference's parameters cross through ``interop.lm_params_from_reference``
(PRNGKey(0)); tokens come from one numpy generator. Checked:

- ``lm_loss``'s ``loss`` / ``ce`` (and ``mtp_ce``, ``router_aux`` where the
  config has them) within 1e-5 relative of ``jax.value_and_grad`` of the
  reference's ``lm_loss``, and every parameter's gradient, a stacked leaf
  at a time in the reference's layout, within 1e-4 of its leaf's largest
  (2e-6 seen): on smoke-gqa, smoke-mla (the reference's ``smoke_lm("mla")``)
  and smoke-mla-moe with MTP and ``router_aux_coef`` 0.01;
- ``_chunked_ce`` against a CE over the whole (B, S, V) logits, and the
  loss and gradients equal under ``remat`` "none", "full" and "dots"
  (the checkpoints recompute the same products);
- one train_4k step (``LMArch.make_cell``) against the reference's jitted
  step from the same weights and batch: smoke-gqa with AdamW, and
  smoke-mla-moe with Adafactor (momentum 0.9) and ``grad_accum`` 2. The
  metrics (``loss``, ``ce``, ``grad_norm``, ...) within 1e-5 relative;
  each new parameter within 1e-6 + 1e-3 lr of the reference's wherever
  the reference's gradient exceeds 1e-3 of its leaf's largest, and within
  2 lr + 1e-6 everywhere (the first update of either optimizer is about
  -lr g / |g|, so an element whose gradient is at rounding level may move
  the other way);
- the counterparts of the reference's ``test_moe_lm_trains_and_routes``
  (the routed experts, the shared experts and the router get gradient
  through the port's dispatch) and ``test_train_cells_change_params``;
- ``StackedLayers``: after ``Module.to`` and ``copy.deepcopy`` each layer's
  parameter is still a row of its stacked leaf, so a step writes it.
"""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.archs import lm as ref_lm
from repro.archs.base import get_arch as ref_get_arch
from repro.configs import lm_configs as ref_lmc
from repro.data import pipeline as ref_pipe
from repro.distributed.meshinfo import single_device_meshinfo
from repro.models.transformer import model as ref_tm
from repro_torch.archs import get_arch
from repro_torch.archs.lm import LMArch
from repro_torch.interop import _leaves, _port_name, lm_params_from_reference
from repro_torch.models.transformer import model as tm
from repro_torch.train import train_step as ts
from test_torch_lm import close, port_cfg
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse fixture)

MI = single_device_meshinfo()
GRAD_TOL = 1e-4
LR = {"adamw": 3e-4, "adafactor": 1e-3}


def ref_config(name):
    if name == "smoke-mla":
        return ref_lmc.smoke_lm("mla").cfg
    cfg = ref_get_arch("smoke-mla-moe" if name == "smoke-mla-moe-aux" else name).cfg
    return dataclasses.replace(cfg, router_aux_coef=0.01) if name.endswith("-aux") else cfg


def setup(ref_cfg):
    params = ref_tm.init_params(jax.random.PRNGKey(0), ref_cfg)
    model = lm_params_from_reference(jax.tree.map(np.asarray, params), port_cfg(ref_cfg),
                                     device="cpu")
    return params, model


def tokens(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


def by_port_name(tree):
    return {_port_name(p): np.asarray(a) for p, a in _leaves(jax.tree.map(np.asarray, tree))}


@pytest.mark.parametrize("name", ["smoke-gqa", "smoke-mla", "smoke-mla-moe-aux"])
def test_lm_loss_and_gradients_match_reference(name):
    ref_cfg = ref_config(name)
    params, model = setup(ref_cfg)
    toks = tokens(2, 32, ref_cfg.vocab_size)
    (want, ref_metrics), ref_g = jax.jit(jax.value_and_grad(
        lambda p, t: ref_tm.lm_loss(p, ref_cfg, MI, {"tokens": t}), has_aux=True))(params, toks)
    loss, metrics = tm.lm_loss(model, {"tokens": torch.from_numpy(toks)})
    assert set(metrics) == set(ref_metrics)
    if name.endswith("-aux"):
        assert {"mtp_ce", "router_aux"} <= set(metrics)
    for k in ref_metrics:
        close(metrics[k].detach().numpy(), ref_metrics[k])
    got, ref_g = ts.gradients(model, loss), by_port_name(ref_g)
    assert set(got) == set(ref_g)
    for k, g in got.items():
        close(g.numpy(), ref_g[k], rtol=GRAD_TOL)


def test_chunked_ce_and_remat_modes():
    base = port_cfg(ref_config("smoke-mla-moe-aux"))
    gen = torch.Generator().manual_seed(0)
    h = torch.randn((2, 32, base.d_model), generator=gen)
    model = tm.init_params(torch.Generator().manual_seed(0), base, device="cpu")
    labels = torch.randint(0, base.vocab_size, (2, 32), generator=gen, dtype=torch.int32)
    weights = (torch.rand((2, 32), generator=gen) > 0.2).float()
    logits = model.lm_head(h).float()
    whole = (torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                                labels.long().reshape(-1), reduction="none")
             * weights.reshape(-1)).sum() / weights.sum()
    for chunk in (4, 16, 32):
        got = tm._chunked_ce(dataclasses.replace(base, ce_chunk=chunk), h, model.lm_head, labels,
                             weights)
        close(got.detach().numpy(), whole.detach().numpy(), rtol=1e-6)
    batch = {"tokens": torch.from_numpy(tokens(2, 32, base.vocab_size))}
    runs = {}
    for remat in ("none", "full", "dots"):
        model.cfg = dataclasses.replace(base, remat=remat)
        loss, _ = tm.lm_loss(model, batch)
        runs[remat] = (loss.detach(), ts.gradients(model, loss))
    for remat in ("full", "dots"):
        assert torch.equal(runs[remat][0], runs["none"][0]), remat
        for k, g in runs[remat][1].items():
            torch.testing.assert_close(g, runs["none"][1][k], rtol=0, atol=1e-6)


def arches(name, optimizer, grad_accum):
    ref_cfg = ref_config(name)
    shapes = ref_get_arch("smoke-gqa").shapes
    return (ref_lm.LMArch(ref_cfg, optimizer, shapes, grad_accum),
            LMArch(port_cfg(ref_cfg), optimizer, shapes, grad_accum))


@pytest.mark.parametrize("name,optimizer,grad_accum",
                         [("smoke-gqa", "adamw", 1), ("smoke-mla-moe-aux", "adafactor", 2)])
def test_train_4k_step_matches_reference(name, optimizer, grad_accum):
    ref_arch, arch = arches(name, optimizer, grad_accum)
    sh = ref_arch.shapes["train_4k"]
    ref_cell = ref_arch.make_cell("train_4k", MI)
    params, model = setup(ref_arch.cfg)
    ref_state = ref_arch._optimizer().init(params)
    ref_batch = ref_pipe.lm_batch(0, 0, sh["global_batch"], sh["seq_len"],
                                  ref_arch.cfg.vocab_size)
    ref_grads = by_port_name(jax.jit(jax.grad(
        lambda p, b: ref_tm.lm_loss(p, ref_arch.cfg, MI, b)[0]))(params, ref_batch))
    new_params, _, ref_metrics = jax.jit(ref_cell.fn)(params, ref_state, ref_batch)

    cell = arch.make_cell("train_4k")
    _, state, batch = cell.make_inputs(0, "cpu")
    assert np.array_equal(batch["tokens"].numpy(), np.asarray(ref_batch["tokens"]))
    state = arch.optimizer().init(ts.reference_layout(model))
    model, state, metrics = cell.fn(model, state, batch)
    assert int(state["count"]) == 1 and set(metrics) == set(ref_metrics)
    for k in ref_metrics:
        close(metrics[k].numpy(), ref_metrics[k])
    lr, want = LR[optimizer], by_port_name(new_params)
    for k, view in ts.reference_layout(model).items():
        got, w = view.detach().numpy(), want[k]
        np.testing.assert_allclose(got, w, rtol=0, atol=2 * lr + 1e-6, err_msg=k)
        g = np.abs(ref_grads[k])
        big = g > 1e-3 * g.max()
        np.testing.assert_allclose(got[big], w[big], rtol=0, atol=1e-6 + 1e-3 * lr, err_msg=k)


def test_moe_lm_trains_and_routes():
    ref_cfg = ref_config("smoke-mla-moe-aux")
    _, model = setup(ref_cfg)
    loss, metrics = tm.lm_loss(model, {"tokens": torch.from_numpy(tokens(2, 16, 64))})
    assert np.isfinite(float(loss.detach())) and "mtp_ce" in metrics
    g = ts.gradients(model, loss)
    for k in ("moe_layers.ffn.experts.w1", "moe_layers.ffn.experts.w2",
              "moe_layers.ffn.shared.w1.weight", "moe_layers.ffn.router.weight"):
        assert float(g[k].norm()) > 0, k


def test_train_cells_change_params():
    cell = get_arch("smoke-gqa").make_cell("train_4k")
    model, state, batch = cell.make_inputs(0, "cpu")
    before = {k: v.detach().clone() for k, v in ts.reference_layout(model).items()}
    model, state, metrics = cell.fn(model, state, batch)
    after = ts.reference_layout(model)
    assert all(not torch.equal(after[k], v) for k, v in before.items())
    assert np.isfinite(float(metrics["loss"]))
    # over a (2, 1) mesh (no MoE to split) the same step from the same start
    from repro_torch.distributed import MeshInfo
    from repro_torch.launch.mesh import make_test_mesh

    mesh_cell = get_arch("smoke-gqa").make_cell("train_4k",
                                                MeshInfo(make_test_mesh(2, device="cpu")))
    model2, state2, batch2 = mesh_cell.make_inputs(0, "cpu")
    _, _, metrics2 = mesh_cell.fn(model2, state2, batch2)
    assert float(metrics2["loss"]) == float(metrics["loss"])
    assert all(torch.equal(ts.reference_layout(model2)[k], v) for k, v in after.items())


def test_stacked_layers_survive_to_and_deepcopy():
    model, _, _ = get_arch("smoke-mla-moe").make_cell("train_4k").make_inputs(0, "cpu")
    want = {k: v.detach().clone() for k, v in ts.reference_layout(model).items()}
    for out in (copy.deepcopy(model), copy.deepcopy(model).to(torch.float64)):
        layers = out.dense_layers
        got = ts.reference_layout(out)
        assert set(got) == set(want) and got["dense_layers.attn.wq_a.weight"].shape[0] == len(layers)
        assert all(torch.equal(got[k].to(v.dtype), v) for k, v in want.items())
        with torch.no_grad():
            got["dense_layers.ln1.scale"].add_(1.0)  # a write into the stacked leaf
        assert all(torch.equal(layer.ln1.scale, layers.stacked["ln1.scale"][i])
                   for i, layer in enumerate(layers))
        assert float(layers[0].ln1.scale[0].detach()) == float(want["dense_layers.ln1.scale"][0, 0]) + 1
