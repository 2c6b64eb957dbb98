"""Fault tolerance of the port's training driver (``launch/train.py``), the
port of ``tests/test_fault_tolerance.py``, and its batch functions.

A run killed after a checkpoint and resumed from it ends where an
uninterrupted run ends, bit for bit on the CPU: the port labels a
checkpoint by the steps it holds and resumes at the next one, so every
step is applied once (the reference's test allows a tolerance because its
driver takes the checkpointed step twice). This holds in process (the
reference test's 2-layer "ft" config, AdamW lr 1e-3, checkpoints every 5
steps, killed at 11, resumed from 10) and for the driver as subprocesses
(``--device cpu``: 8 steps, then a second process resuming to 16, against
one process of 16). The NaN guard leaves every parameter and every moment
bit for bit as it was; the straggler limit, driven by a patched clock,
checkpoints and exits with 17. ``make_batch_fn``'s batches have the names,
shapes and dtypes of each smoke arch's cell inputs and the reference's
values.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.archs.base import get_arch as ref_get_arch
from repro.launch.train import make_batch_fn as ref_make_batch_fn
from repro_torch import ckpt
from repro_torch.archs import get_arch
from repro_torch.data import lm_batch
from repro_torch.launch import train
from repro_torch.models.transformer.model import TransformerConfig, init_params, lm_loss
from repro_torch.train import adamw, make_train_step, reference_layout
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg():
    return TransformerConfig(name="ft", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                             head_dim=16, d_ff=64, vocab_size=128, param_dtype=torch.float32,
                             compute_dtype=torch.float32, attn_chunk=8, ce_chunk=8, remat="none")


def _state(model, opt_state):
    return {"params": reference_layout(model), "opt": opt_state}


def _run(steps, start=0, restored=None, ckpt_dir=None, ckpt_every=5):
    cfg = _cfg()
    opt = adamw(1e-3)
    model = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    opt_state = opt.init(reference_layout(model))
    if restored is not None:
        with torch.no_grad():
            for dst, src in zip(train._leaves(_state(model, opt_state)), train._leaves(restored)):
                dst.copy_(src)
    step_fn = make_train_step(lm_loss, opt)
    saved = {}
    for step in range(start, steps):
        batch = lm_batch(13, step, 2, 16, cfg.vocab_size, device="cpu")
        model, opt_state, metrics = step_fn(model, opt_state, batch)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, step + 1, _state(model, opt_state))
            saved[step + 1] = {k: v.clone() for k, v in reference_layout(model).items()}
    return model, opt_state, float(metrics["loss"]), saved


def test_kill_and_resume_matches_uninterrupted(tmp_path):
    m_ref, o_ref, loss_ref, _ = _run(12)
    d = str(tmp_path / "ck")
    _, _, _, saved = _run(11, ckpt_dir=d)  # "preempted" after step 11, checkpoints at 5 and 10
    last = ckpt.latest_step(d)
    assert last == 10
    cfg = _cfg()
    like = _state(init_params(torch.Generator().manual_seed(1), cfg, device="cpu"),
                  adamw(1e-3).init(reference_layout(init_params(torch.Generator(), cfg,
                                                                device="cpu"))))
    restored = ckpt.restore(d, last, like)
    for k, v in saved[10].items():
        assert torch.equal(restored["params"][k], v), k
    m_res, o_res, loss_res, _ = _run(12, start=last, restored=restored)
    assert loss_res == loss_ref
    for k, v in reference_layout(m_ref).items():
        assert torch.equal(reference_layout(m_res)[k], v), k
        assert torch.equal(o_res["m"][k], o_ref["m"][k]) and torch.equal(o_res["v"][k],
                                                                          o_ref["v"][k])
    assert int(o_res["count"]) == int(o_ref["count"]) == 12


def _driver(args, d):
    env = dict(os.environ, PYTHONPATH="src")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                           "smoke-gqa", "--device", "cpu", "--ckpt-dir", d, "--ckpt-every", "4"]
                          + args, capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)


def test_driver_subprocess_kill_resume(tmp_path):
    """The driver: 8 steps, then a second process resuming to 16, whose
    banner names step 8; its final checkpoint equals one process's 16 steps
    file for file."""
    d, whole = str(tmp_path / "drv"), str(tmp_path / "whole")
    r1 = _driver(["--steps", "8"], d)
    assert r1.returncode == 0, r1.stdout + r1.stderr
    r2 = _driver(["--steps", "16"], d)
    assert r2.returncode == 0, r2.stdout + r2.stderr
    assert "[resume] restoring step 8" in r2.stdout, r2.stdout
    assert "training complete" in r2.stdout
    r3 = _driver(["--steps", "16"], whole)
    assert r3.returncode == 0 and "[resume]" not in r3.stdout, r3.stdout + r3.stderr
    a, b = os.path.join(d, "step_00000016"), os.path.join(whole, "step_00000016")
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


def test_nan_guard_leaves_parameters_and_moments_untouched():
    cell = get_arch("smoke-dlrm").make_cell("train_batch")
    model, state, batch = cell.make_inputs(0, "cpu")
    model, state, _ = cell.fn(model, state, batch)  # moments nonzero
    before = {k: v.clone() for k, v in reference_layout(model).items()}
    m0 = {k: v.clone() for k, v in state["m"].items()}
    v0 = {k: v.clone() for k, v in state["v"].items()}
    count = int(state["count"])
    bad = dict(batch, dense=torch.full_like(batch["dense"], float("nan")))
    model, state, metrics = cell.fn(model, state, bad, skip_nonfinite=True)
    assert not torch.isfinite(metrics["loss"])
    for k, v in reference_layout(model).items():
        assert torch.equal(v, before[k]), k
        assert torch.equal(state["m"][k], m0[k]) and torch.equal(state["v"][k], v0[k]), k
    assert int(state["count"]) == count
    model, state, _ = cell.fn(model, state, bad)  # unguarded, the update is taken
    assert int(state["count"]) == count + 1
    assert not all(torch.isfinite(v).all() for v in reference_layout(model).values())


def test_straggler_limit_checkpoints_and_exits_17(tmp_path, monkeypatch, capsys):
    """Steps of 1 s, then 10 s each (a patched clock): with a 3x deadline and
    two straggles allowed, step 4 is the second straggle; the driver saves
    the state after it (step_00000005) and exits with 17."""
    ticks = iter([0, 1, 1, 2, 2, 3, 3, 13, 13, 23])
    monkeypatch.setattr(train, "clock", lambda: next(ticks))
    d = str(tmp_path / "ck")
    with pytest.raises(SystemExit) as exit_:
        train.main(["--arch", "smoke-dlrm", "--device", "cpu", "--steps", "20", "--ckpt-dir", d,
                    "--ckpt-every", "50", "--max-straggles", "2"])
    assert exit_.value.code == 17
    out = capsys.readouterr().out
    assert "[straggler] step 3" in out and "[straggler] step 4" in out and "[2/2]" in out
    assert ckpt.latest_step(d) == 5 and "training complete" not in out


SMOKE = ("smoke-gqa", "smoke-dlrm", "smoke-deepfm", "smoke-sasrec", "smoke-two-tower",
         "smoke-mace")


@pytest.mark.parametrize("name", SMOKE)
def test_batch_fn_matches_the_cells(name):
    """``make_batch_fn`` at step 0 gives the cell's own batch (names, shapes,
    dtypes and values) for every train shape of the arch, and the
    reference's values where the reference's batch function gives the
    cell's inputs (the LM, the recsys models, the GNN's simple mode)."""
    arch, ref_arch = get_arch(name), ref_get_arch(name)
    shapes = [s for s in arch.shape_names() if arch.shapes[s]["kind"] == "train"]
    for shape in shapes:
        cell = arch.make_cell(shape)
        want = cell.make_inputs(7, "cpu")[2]
        got = train.make_batch_fn(arch, shape, "cpu")(7, 0)
        assert set(got) == set(want), shape
        for k, v in want.items():
            if isinstance(v, torch.Tensor):
                assert got[k].shape == v.shape and got[k].dtype == v.dtype, (shape, k)
                assert torch.equal(got[k], v), (shape, k)
        if arch.family != "gnn" or arch.shapes[shape]["mode"] == "simple":
            ref = ref_make_batch_fn(ref_arch, ref_arch.shapes[shape])(7, 0)
            for k, v in ref.items():
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
