"""SASRec in the port against the reference's, on the CPU: at ``smoke-sasrec``
and at the published widths (arXiv 1808.09781: dim 50, 2 blocks, 1 head,
seq 50) with a 4,096-row item vocab.

The reference's parameters (``sasrec_init`` at PRNGKey(0), blocks stacked
on a leading axis) cross through ``interop.sasrec_params_from_reference``;
batches are the numpy draws of ``data/pipeline.py``, equal value for
value. Checked, within 1e-5 relative and 1e-5 of each array's largest
element (float32 products and sums in other orders):

- ``hidden``, ``sasrec_loss`` and every gradient against
  ``jax.value_and_grad`` of the reference's loss (the gradients carried
  back through the same interop, so stacked leaves meet their blocks);
- ``sasrec_serve`` against the reference's;
- one AdamW step of the train_batch cell against the reference's cell from
  a carried state (``adamw_state_from_reference``): the loss, and every
  parameter within 2 lr + 1e-6 (an element whose gradient sits at
  rounding level may step the other way) and within 1e-6 where the
  reference's |g| exceeds 1e-4 of its leaf's largest;
- ``sasrec_batch`` and ``lm_batch`` equal to the reference's; the serve
  cells' shapes, and the configs equal to the reference's.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.archs.base import get_arch as ref_get_arch
from repro.configs import other_configs as ref_oc
from repro.data.pipeline import lm_batch as ref_lm_batch
from repro.data.pipeline import sasrec_batch as ref_sasrec_batch
from repro.distributed.meshinfo import single_device_meshinfo
from repro.models.recsys import models as rs
from repro.train.optimizer import adamw as ref_adamw
from repro_torch.archs import get_arch
from repro_torch.archs.recsys import RECSYS_SHAPES, shape_batch
from repro_torch.configs import sasrec, smoke_sasrec
from repro_torch.data import lm_batch, sasrec_batch
from repro_torch.interop import adamw_state_from_reference, sasrec_params_from_reference
from repro_torch.models.recsys import RecsysConfig, SASRec, sasrec_loss, sasrec_serve
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse fixture)

MI = single_device_meshinfo()
LR = 1e-3
CONFIGS = {"smoke": (smoke_sasrec, 16), "published": (lambda: dataclasses.replace(
    sasrec(), item_vocab=4096), 24)}


def ref_cfg_of(cfg: RecsysConfig):
    return rs.RecsysConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                              if f.name not in ("param_dtype", "compute_dtype")})


@functools.lru_cache(maxsize=None)
def reference(which):
    cfg = CONFIGS[which][0]()
    ref_cfg = ref_cfg_of(cfg)
    return cfg, ref_cfg, rs.sasrec_init(jax.random.PRNGKey(0), ref_cfg)


def port_model(which) -> SASRec:
    cfg, _, params = reference(which)
    return sasrec_params_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("which", list(CONFIGS))
def test_hidden_loss_serve_and_gradients_match_reference(which):
    cfg, ref_cfg, params = reference(which)
    b = CONFIGS[which][1]
    batch = ref_sasrec_batch(5, 2, b, cfg.seq_len, cfg.item_vocab)
    (ref_loss, _), ref_g = jax.jit(jax.value_and_grad(
        lambda p, bb: rs.sasrec_loss(p, ref_cfg, MI, bb), has_aux=True))(params, batch)
    ref_h = jax.jit(lambda p, s: rs.sasrec_hidden(p, ref_cfg, MI, s))(params, batch["seq"])
    m = port_model(which)
    tb = to_torch(batch)
    close(m.hidden(tb["seq"]).detach().numpy(), ref_h)
    loss, metrics = sasrec_loss(m, tb)
    close(float(loss.detach()), float(ref_loss))
    assert metrics["loss"] is loss
    names = [k for k, _ in m.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(m.parameters()))))
    want = dict(sasrec_params_from_reference(jax.tree.map(np.asarray, ref_g), cfg,
                                             device="cpu").named_parameters())
    assert set(grads) == set(want) and len(grads) == 4 + 10 * cfg.n_blocks
    for k, g in grads.items():
        close(g.numpy(), want[k].detach().numpy())
    rng = np.random.default_rng(1)
    cand = rng.integers(1, cfg.item_vocab, size=(b, 7)).astype(np.int32)
    serve = {"seq": batch["seq"], "candidates": cand}
    ref_s = jax.jit(lambda p, bb: rs.sasrec_serve(p, ref_cfg, MI, bb))(params, serve)
    with torch.inference_mode():
        close(sasrec_serve(m, to_torch(serve)).numpy(), ref_s)


def test_one_adamw_step_of_the_train_cell():
    cfg, ref_cfg, params = reference("smoke")
    arch = ref_get_arch("smoke-sasrec")
    ref_state = ref_adamw(lr=LR).init(params)
    m = port_model("smoke")
    cell = get_arch("smoke-sasrec").make_cell("train_batch")
    state = adamw_state_from_reference(jax.tree.map(np.asarray, ref_state), m, device="cpu")
    b = arch.shapes["train_batch"]["batch"]
    batch = ref_sasrec_batch(4, 0, b, cfg.seq_len, cfg.item_vocab)
    tb = shape_batch(cfg, "train_batch", 4, 0, shapes=arch.shapes, device="cpu")
    assert set(tb) == set(batch)
    assert all(np.array_equal(tb[k].numpy(), np.asarray(v)) for k, v in batch.items())
    g0 = jax.jit(jax.grad(lambda p, bb: rs.sasrec_loss(p, ref_cfg, MI, bb)[0]))(params, batch)
    params, ref_state, ref_met = jax.jit(arch.make_cell("train_batch", MI).fn)(
        params, ref_state, batch)
    m, state, met = cell.fn(m, state, tb)
    close(float(met["loss"]), float(ref_met["loss"]))
    want = dict(sasrec_params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                             device="cpu").named_parameters())
    grad = dict(sasrec_params_from_reference(jax.tree.map(np.asarray, g0), cfg,
                                             device="cpu").named_parameters())
    for k, p in m.named_parameters():
        diff = np.abs(p.detach().numpy() - want[k].detach().numpy())
        assert diff.max() <= 2 * LR + 1e-6, k
        g = np.abs(grad[k].detach().numpy())
        assert diff[g > 1e-4 * g.max()].max(initial=0.0) <= 1e-6, k
    assert int(state["count"]) == int(ref_state["count"]) == 1


@pytest.mark.parametrize("seed,step,batch,seq,vocab", [(0, 0, 4, 10, 200), (3, 9, 64, 50, 10**6)])
def test_sasrec_and_lm_batches_bit_for_bit(seed, step, batch, seq, vocab):
    want = ref_sasrec_batch(seed, step, batch, seq, vocab)
    got = sasrec_batch(seed, step, batch, seq, vocab, device="cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.int32 and np.array_equal(got[k].numpy(), np.asarray(v)), k
    want = np.asarray(ref_lm_batch(seed, step, batch, seq, vocab)["tokens"])
    got = lm_batch(seed, step, batch, seq, vocab, device="cpu")["tokens"]
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert want.max() == vocab - 1 or batch * seq < 1000  # the zipf tail clamps


def test_configs_and_serve_cells():
    ref_pairs = {"sasrec": ref_oc.sasrec(), "smoke-sasrec": ref_oc.smoke_recsys("sasrec")}
    for name, ref_arch in ref_pairs.items():
        arch = get_arch(name)
        assert ref_cfg_of(arch.cfg) == ref_arch.cfg and arch.shapes == ref_arch.shapes, name
    assert get_arch("sasrec").shapes == RECSYS_SHAPES
    arch = get_arch("smoke-sasrec")
    cfg = arch.cfg
    for shape in ("serve_p99", "serve_bulk", "retrieval_cand"):
        cell = arch.make_cell(shape)
        model, batch = cell.make_inputs(0, "cpu")
        sh = arch.shapes[shape]
        c = sh.get("n_candidates", 100)
        assert batch["seq"].shape == (sh["batch"], cfg.seq_len)
        assert batch["candidates"].shape == (sh["batch"], c)
        assert int(batch["candidates"].min()) >= 1
        assert int(batch["candidates"].max()) < cfg.item_vocab
        scores = cell.fn(model, batch)
        assert scores.shape == (sh["batch"], c) and scores.dtype == torch.float32
        assert torch.isfinite(scores).all() and not scores.requires_grad
