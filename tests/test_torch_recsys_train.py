"""Recsys training in the port against the reference's, on the CPU, at the
reference's smoke configs (``smoke-dlrm``, ``smoke-deepfm``,
``smoke-two-tower``).

The reference's parameters (``*_init`` at PRNGKey(0)) and AdamW state
cross into the port through ``interop``; batches are the numpy draws of
``data/pipeline.py``, equal value for value. Checked:

- forward, loss and every gradient against ``jax.value_and_grad`` of the
  reference's loss: within 1e-5 relative and 1e-5 of each leaf's largest
  element (products, bmm and reductions add in other orders);
- the two-tower loss on both branches (B <= neg_chunk, and a neg_chunk of
  4 that streams 4 chunks under ``torch.utils.checkpoint``), loss and
  gradients as above, the streamed loss within 1e-6 of the port's whole
  logsumexp;
- three AdamW steps of the train_batch cell (``get_arch(...).make_cell``)
  against the reference's cell: losses within 1e-5 relative; after the
  first step every parameter within 2 lr + 1e-6 of the reference's (AdamW's
  first update is -lr g / (|g| + eps): an element whose gradient sits at
  rounding level may take the opposite sign, 2 lr apart) and within 1e-6
  wherever the reference's |g| exceeds 1e-4 of its leaf's largest;
- ``dlrm_batch`` and ``deepfm_batch`` equal to the reference's;
- the DLRM and DeepFM serve cells (serve_p99, serve_bulk, retrieval_cand's
  bulk scoring) within 1e-6 of the reference's sigmoid.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.archs.base import get_arch as ref_get_arch
from repro.data.pipeline import deepfm_batch as ref_deepfm_batch
from repro.data.pipeline import dlrm_batch as ref_dlrm_batch
from repro.data.pipeline import two_tower_batch as ref_two_tower_batch
from repro.distributed.meshinfo import single_device_meshinfo
from repro.models.recsys import models as rs
from repro.train.optimizer import adamw as ref_adamw
from repro_torch.archs import get_arch
from repro_torch.archs.recsys import shape_batch
from repro_torch.data import deepfm_batch, dlrm_batch
from repro_torch.interop import adamw_state_from_reference, recsys_params_from_reference
from repro_torch.models.recsys import RecsysConfig, two_tower_loss
from repro_torch.train import reference_key, reference_layout
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse fixture)

MI = single_device_meshinfo()
ARCHS = {"dlrm": "smoke-dlrm", "deepfm": "smoke-deepfm", "two_tower": "smoke-two-tower"}
LR = 1e-3


def port_cfg(ref_cfg):
    fields = {f.name: getattr(ref_cfg, f.name) for f in dataclasses.fields(ref_cfg)
              if f.name not in ("param_dtype", "compute_dtype")}
    return RecsysConfig(**fields)


@functools.lru_cache(maxsize=None)
def reference(model):
    """(reference arch, its params at PRNGKey(0))."""
    arch = ref_get_arch(ARCHS[model])
    init = {"dlrm": rs.dlrm_init, "deepfm": rs.deepfm_init, "two_tower": rs.two_tower_init}
    return arch, init[model](jax.random.PRNGKey(0), arch.cfg)


def port_model(model):
    arch, params = reference(model)
    return recsys_params_from_reference(jax.tree.map(np.asarray, params), port_cfg(arch.cfg),
                                        device="cpu")


def ref_batch(model, seed, step, b):
    cfg = reference(model)[0].cfg
    if model == "dlrm":
        return ref_dlrm_batch(seed, step, b, cfg.n_dense, cfg.vocab_sizes)
    if model == "deepfm":
        return ref_deepfm_batch(seed, step, b, cfg.vocab_sizes)
    return ref_two_tower_batch(seed, step, b, cfg.user_vocab, cfg.item_vocab, cfg.hist_len)


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max()), 1e-30))


def port_grads(model, loss):
    views = reference_layout(model)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, [named[k] for k in views])
    return {k: (g.T if g.dim() == 2 and k.endswith("weight") else g)
            for k, g in zip(views, grads)}


def ref_leaves(model_params, views):
    """The reference tree's leaves keyed by the port's names."""
    return dict(zip(sorted(views, key=reference_key), jax.tree.leaves(model_params)))


@pytest.mark.parametrize("model", list(ARCHS))
def test_loss_and_gradients_match_reference(model):
    arch, params = reference(model)
    cfg = arch.cfg
    loss_fn = {"dlrm": rs.dlrm_loss, "deepfm": rs.deepfm_loss,
               "two_tower": rs.two_tower_loss}[model]
    batch = ref_batch(model, 11, 0, 16)
    (ref_loss, _), ref_g = jax.jit(jax.value_and_grad(
        lambda p, b: loss_fn(p, cfg, MI, b), has_aux=True))(params, batch)
    m = port_model(model)
    tb = to_torch(batch)
    if model == "two_tower":
        u_ref = jax.jit(lambda p, b: rs.two_tower_user(p, cfg, MI, b))(params, batch)
        close(m.user(tb).detach().numpy(), u_ref)
    else:
        fwd = rs.dlrm_forward if model == "dlrm" else rs.deepfm_forward
        close(m(tb).detach().numpy(), jax.jit(lambda p, b: fwd(p, cfg, MI, b))(params, batch))
    loss, metrics = get_arch(ARCHS[model]).loss(m, tb)
    close(float(loss.detach()), float(ref_loss))
    assert metrics["loss"] is loss
    grads = port_grads(m, loss)
    want = ref_leaves(ref_g, grads)
    assert len(want) == len(grads) == len(jax.tree.leaves(ref_g))
    for k, g in grads.items():
        assert tuple(g.shape) == want[k].shape, k
        close(g.numpy(), want[k])


@pytest.mark.parametrize("neg_chunk", [4096, 4], ids=["whole", "streamed"])
def test_two_tower_loss_both_branches(neg_chunk):
    arch, params = reference("two_tower")
    cfg = arch.cfg
    batch = ref_batch("two_tower", 2, 5, 16)
    (ref_loss, _), ref_g = jax.jit(jax.value_and_grad(
        lambda p, b: rs.two_tower_loss(p, cfg, MI, b, neg_chunk=neg_chunk),
        has_aux=True))(params, batch)
    m = port_model("two_tower")
    tb = to_torch(batch)
    loss, _ = two_tower_loss(m, tb, neg_chunk=neg_chunk)
    close(float(loss.detach()), float(ref_loss))
    grads = port_grads(m, loss)
    want = ref_leaves(ref_g, grads)
    for k, g in grads.items():
        close(g.numpy(), want[k])
    whole, _ = two_tower_loss(m, tb)
    np.testing.assert_allclose(float(loss.detach()), float(whole.detach()), rtol=1e-6)
    with pytest.raises(ValueError, match="multiple"):
        two_tower_loss(m, {k: v[:10] for k, v in tb.items()}, neg_chunk=4)


@pytest.mark.parametrize("model", list(ARCHS))
def test_three_adamw_steps_of_the_train_cell(model):
    arch, params = reference(model)
    ref_step = jax.jit(arch.make_cell("train_batch", MI).fn)
    ref_state = ref_adamw(lr=LR).init(params)
    m = port_model(model)
    cell = get_arch(ARCHS[model]).make_cell("train_batch")
    assert (cell.name, cell.kind) == (f"{ARCHS[model]}:train_batch", "train")
    state = adamw_state_from_reference(jax.tree.map(np.asarray, ref_state), m, device="cpu")
    b = arch.shapes["train_batch"]["batch"]
    grad0 = None
    for step in range(3):
        batch = ref_batch(model, 4, step, b)
        tb = shape_batch(m.cfg, "train_batch", 4, step, shapes=cell_shapes(model), device="cpu")
        assert all(np.array_equal(tb[k].numpy(), np.asarray(v)) for k, v in batch.items())
        if step == 0:
            grad0 = jax.jit(jax.grad(lambda p, bb: arch_loss(model)(p, arch.cfg, MI, bb)[0]))(
                params, batch)
        before = {k: v.detach().clone() for k, v in reference_layout(m).items()}
        params, ref_state, ref_met = ref_step(params, ref_state, batch)
        m, state, met = cell.fn(m, state, tb)
        close(float(met["loss"]), float(ref_met["loss"]))
        views = reference_layout(m)
        assert any(not torch.equal(views[k], before[k]) for k in views)
        if step == 0:
            want, g0 = ref_leaves(params, views), ref_leaves(grad0, views)
            for k, view in views.items():
                diff = np.abs(view.detach().numpy() - np.asarray(want[k]))
                assert diff.max() <= 2 * LR + 1e-6, k
                g = np.abs(np.asarray(g0[k]))
                firm = g > 1e-4 * g.max()
                assert diff[firm].max(initial=0.0) <= 1e-6, k
    assert int(state["count"]) == int(ref_state["count"]) == 3


def cell_shapes(model):
    return get_arch(ARCHS[model]).shapes


def arch_loss(model):
    return {"dlrm": rs.dlrm_loss, "deepfm": rs.deepfm_loss, "two_tower": rs.two_tower_loss}[model]


def test_dlrm_and_deepfm_batches_equal_reference():
    vocabs = (100, 3, 4_000_000, 1024)
    for seed, step, batch in ((0, 0, 8), (3, 17, 300)):
        want = ref_dlrm_batch(seed, step, batch, 13, vocabs)
        got = dlrm_batch(seed, step, batch, 13, vocabs, device="cpu")
        assert set(got) == set(want) == {"dense", "sparse", "label"}
        want_f = ref_deepfm_batch(seed, step, batch, vocabs)
        got_f = deepfm_batch(seed, step, batch, vocabs, device="cpu")
        assert set(got_f) == set(want_f) == {"sparse", "label"}
        for g, w in ((got, want), (got_f, want_f)):
            for k, v in w.items():
                v = np.asarray(v)
                assert g[k].dtype == {np.dtype(np.int32): torch.int32,
                                      np.dtype(np.float32): torch.float32}[v.dtype], k
                assert np.array_equal(g[k].numpy(), v), k
        assert set(np.unique(got["label"].numpy())) <= {0.0, 1.0}


def test_ranking_serve_cells_match_reference():
    for model in ("dlrm", "deepfm"):
        arch, params = reference(model)
        m = port_model(model)
        port_arch = get_arch(ARCHS[model])
        for shape in ("serve_p99", "serve_bulk", "retrieval_cand"):
            sh = arch.shapes[shape]
            rows = sh.get("n_candidates", sh["batch"])
            batch = ref_batch(model, 6, 1, rows)
            del batch["label"]
            want = np.asarray(jax.jit(arch.make_cell(shape, MI).fn)(params, batch))
            tb = shape_batch(m.cfg, shape, 6, 1, shapes=port_arch.shapes, device="cpu")
            assert set(tb) == set(batch) and tb["sparse"].shape[0] == rows
            got = port_arch.make_cell(shape).fn(m, tb)
            assert got.shape == (rows,) and not got.requires_grad
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
