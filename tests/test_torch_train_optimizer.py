"""The port's training core against the reference's, on the CPU: AdamW,
Adafactor, the global norm and clipping in the reference's leaf order, and
``make_train_step`` with gradient accumulation and clipping.

Inputs are numpy draws from a seed, handed to both. Tolerances:

- AdamW against the reference's arithmetic as written (``jax.disable_jit``:
  every op rounds on its own, in the port's order): the moments bit for
  bit, each update within 1 ulp, 2 with weight decay. The ulp is PyTorch's
  CPU ``sqrt``, which is not correctly rounded (its vectorised path misses
  the IEEE result by 1 ulp on about 0.6% of inputs); with decay, ``step +
  wd * p`` can cancel half of the step and double that ulp.
- AdamW against the jitted reference: moments within 4 ulps, updates
  within 8 ulps of the leaf's largest update. XLA's CPU code contracts
  ``b1 * m + (1 - b1) * g`` into a fused multiply-add and rewrites
  ``(m / c1) / (sqrt(vhat) + eps)`` into ``m / (c1 * (sqrt(vhat) + eps))``,
  so single elements near a cancellation differ by many of their own ulps.
- Adafactor (as written and jitted): each update within 16 ulps of the
  leaf's largest update, the factored moments within 1e-6 relative, the
  bf16 momentum within one bf16 ulp of the leaf's largest: the row and
  column means and the RMS are reductions whose summation order differs
  from XLA's, and ``0.9 m + step`` (contracted by XLA) can cancel.
- ``global_norm``: the leaves' squares summed in the reference's leaf order,
  within 1e-6 relative (each leaf's own sum has XLA's order).
- ``make_train_step(grad_accum=2, clip_norm)``: the new parameters within
  1e-6 absolute (lr 1e-3 updates of unit-scale parameters) after two steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.other_configs import smoke_recsys
from repro.data.pipeline import dlrm_batch as ref_dlrm_batch
from repro.distributed.meshinfo import single_device_meshinfo
from repro.models.recsys import models as rs
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_ts
from repro_torch.interop import recsys_params_from_reference
from repro_torch.models.recsys import RecsysConfig, dlrm_loss
from repro_torch.train import (
    adafactor,
    adamw,
    clip_by_global_norm,
    global_norm,
    make_train_step,
    reference_key,
    reference_layout,
)
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse fixture)

MI = single_device_meshinfo()
SHAPES = {"a": (7, 5), "b": (5,), "c": (3, 4, 6), "t10": (9, 3), "t2": (4,)}
F32_EPS = float(np.finfo(np.float32).eps)


def draws(seed=0, steps=5):
    """Params near 1 and per-step grads over 8 decades (a few ulps of eps)."""
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.integers(-6, 2)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(steps)]
    return params, grads


def ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def to_torch(tree):
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in tree.items()}


def run_both(ref, port, steps, jit=True):
    """Both optimizers over the same grads, each on its own state. Yields
    (reference updates, port updates, reference state, port state)."""
    params, grads = draws(steps=steps)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    rstate = ref.init(rp)
    pp = to_torch(params)
    pstate = port.init(pp)
    upd = jax.jit(ref.update) if jit else ref.update
    for g in grads:
        if jit:
            ru, rstate = upd({k: jnp.asarray(v) for k, v in g.items()}, rstate, rp)
        else:
            with jax.disable_jit():
                ru, rstate = upd({k: jnp.asarray(v) for k, v in g.items()}, rstate, rp)
        pu, pstate = port.update(to_torch(g), pstate, pp)
        rp = {k: rp[k] + ru[k] for k in rp}
        for k in pp:
            pp[k].add_(pu[k])
        yield ru, pu, rstate, pstate


@pytest.mark.parametrize("wd", [0.0, 0.1], ids=["no_decay", "decay"])
@pytest.mark.parametrize("jit", [False, True], ids=["as_written", "jitted"])
def test_adamw_matches_reference(wd, jit):
    n = 0
    for ru, pu, rstate, pstate in run_both(ref_opt.adamw(weight_decay=wd),
                                           adamw(weight_decay=wd), 5, jit):
        n += 1
        assert int(pstate["count"]) == int(rstate["count"]) == n
        for k in SHAPES:
            for key in ("m", "v"):
                moment = ulps(pstate[key][k].numpy(), rstate[key][k]).max()
                assert moment <= (4 if jit else 0), (key, k, n)
            want = np.asarray(ru[k])
            if jit:
                np.testing.assert_allclose(pu[k].numpy(), want, rtol=0,
                                           atol=8 * F32_EPS * np.abs(want).max())
            else:
                assert ulps(pu[k].numpy(), want).max() <= (2 if wd else 1), (k, n)
    assert n == 5


@pytest.mark.parametrize("momentum", [None, 0.9], ids=["plain", "momentum"])
@pytest.mark.parametrize("jit", [False, True], ids=["as_written", "jitted"])
def test_adafactor_matches_reference(momentum, jit):
    n = 0
    for ru, pu, rstate, pstate in run_both(ref_opt.adafactor(momentum=momentum),
                                           adafactor(momentum=momentum), 5, jit):
        n += 1
        assert int(pstate["count"]) == int(rstate["count"]) == n
        for k, shape in SHAPES.items():
            want = np.asarray(ru[k])
            np.testing.assert_allclose(pu[k].numpy(), want, rtol=0,
                                       atol=16 * F32_EPS * np.abs(want).max())
            for key in ("vr", "vc"):
                np.testing.assert_allclose(pstate[key][k].numpy(), np.asarray(rstate[key][k]),
                                           rtol=1e-6, atol=0)
            factored = len(shape) >= 2
            assert tuple(pstate["vr"][k].shape) == (shape[:-1] if factored else shape)
            assert tuple(pstate["vc"][k].shape) == (shape[:-2] + shape[-1:] if factored else (1,))
            if momentum is not None:
                assert pstate["m"][k].dtype == torch.bfloat16
                m_ref = np.asarray(rstate["m"][k].astype(jnp.float32))
                np.testing.assert_allclose(pstate["m"][k].float().numpy(), m_ref, rtol=0,
                                           atol=2**-8 * np.abs(m_ref).max())
    assert n == 5


def test_global_norm_and_clipping_in_reference_leaf_order():
    """Leaves keyed as the reference's tree flattens them (t10 before t2) and
    the port's norm and clip against ``global_norm`` / ``clip_by_global_norm``
    of the same dict."""
    names = ["top.layers.0.weight", "bot.layers.1.bias", "tables.t2", "tables.t10",
             "bot.layers.0.weight", "bias", "norm.bias"]
    assert sorted(names, key=reference_key) == [
        "bias", "bot.layers.0.weight", "bot.layers.1.bias", "norm.bias", "tables.t10",
        "tables.t2", "top.layers.0.weight"]
    assert reference_key("bot.layers.1.bias") == ("bot", "layers", 1, "b")
    assert reference_key("norm.bias") == ("norm", "bias")
    params, grads = draws(seed=3, steps=1)
    tree = {k: v * 40.0 for k, v in grads[0].items()}
    want = float(jax.jit(ref_ts.global_norm)(tree))
    got = global_norm(to_torch(tree))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    for max_norm in (0.5 * want, 2.0 * want):
        ref_clipped, ref_norm = jax.jit(ref_ts.clip_by_global_norm, static_argnums=1)(
            tree, max_norm)
        clipped, norm = clip_by_global_norm(to_torch(tree), max_norm)
        np.testing.assert_allclose(float(norm), float(ref_norm), rtol=1e-6)
        for k in tree:
            np.testing.assert_allclose(clipped[k].numpy(), np.asarray(ref_clipped[k]),
                                       rtol=2e-6, atol=0)
        if max_norm > want:
            assert all(np.array_equal(clipped[k].numpy(), tree[k]) for k in tree)


def port_cfg(ref_cfg):
    fields = {f.name: getattr(ref_cfg, f.name) for f in dataclasses.fields(ref_cfg)
              if f.name not in ("param_dtype", "compute_dtype")}
    return RecsysConfig(**fields)


def test_make_train_step_matches_reference():
    """Two steps of smoke-dlrm's loss through both builders with AdamW (lr
    1e-3), grad_accum 2 and clip_norm 0.05 (below the gradients' norm, so
    the clip acts): the new parameters within 1e-6 absolute, the loss and
    grad_norm metrics within 1e-6 relative."""
    grad_accum, clip_norm = 2, 0.05
    ref_cfg = smoke_recsys("dlrm").cfg
    cfg = port_cfg(ref_cfg)
    params = rs.dlrm_init(jax.random.PRNGKey(3), ref_cfg)
    model = recsys_params_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")
    ref_step = jax.jit(ref_ts.make_train_step(lambda p, b: rs.dlrm_loss(p, ref_cfg, MI, b),
                                              ref_opt.adamw(lr=1e-3), grad_accum=grad_accum,
                                              clip_norm=clip_norm))
    opt = adamw(lr=1e-3)
    step = make_train_step(dlrm_loss, opt, grad_accum=grad_accum, clip_norm=clip_norm)
    rstate = ref_opt.adamw(lr=1e-3).init(params)
    pstate = opt.init(reference_layout(model))
    for i in range(2):
        batch = ref_dlrm_batch(5, i, 16, ref_cfg.n_dense, ref_cfg.vocab_sizes)
        params, rstate, rmet = ref_step(params, rstate, batch)
        model, pstate, pmet = step(model, pstate, {k: torch.from_numpy(np.array(v))
                                                   for k, v in batch.items()})
        assert set(pmet) == set(rmet) == {"loss", "grad_norm"}
        assert float(pmet["grad_norm"]) > clip_norm
        for k in rmet:
            assert not pmet[k].requires_grad
            np.testing.assert_allclose(float(pmet[k]), float(rmet[k]), rtol=1e-6)
    views = reference_layout(model)
    ref_leaves = dict(zip(sorted(views, key=reference_key), jax.tree.leaves(params)))
    for k, view in views.items():
        np.testing.assert_allclose(view.detach().numpy(), np.asarray(ref_leaves[k]), rtol=0,
                                   atol=1e-6)
    assert int(pstate["count"]) == 2
