"""LM training and MACE on the card against the CPU.

Marked ``cuda``; each test skips where there is no CUDA device. This file
imports no JAX, so it also runs where only the port is installed:

    python -m pytest -m cuda tests/test_torch_cuda_train_lm_gnn.py

Two train steps from the same weights, optimizer state and batch on the
card and on the CPU (smoke configs, float32 unless the cell computes in
bf16, PyTorch's default of no TF32; the card's steps under deterministic
algorithms, ``train.parity.deterministic``): smoke-gqa's train_4k (AdamW),
smoke-mla-moe's with the router's aux loss (Adafactor, grad_accum 2), and
every smoke-mace cell. The readings and limits are ``train.parity``'s:
every metric of both steps within ``LOSS_RTOL`` relative (1e-4 float32,
2e-3 for smoke-mace's ogb_products, which computes in bf16); every new
parameter within 2 lr + 1e-6 of the CPU's, and at most
``LEAF_FAR_SHARE`` of each leaf's elements beyond 1e-3 lr + 1e-6 (1e-2
float32, 0.3 bf16); each limit below its control (one update's change
of the loss; a leaf's update dropped or sign-flipped).

smoke-mla-moe's train_4k (Adafactor) over (1, 4) and (2, 2) meshes of
cuda:0, every leaf resident as its parts on the card, against the same
mesh of CPU positions from the same weights, by the same limits; the
parts and Adafactor's statistics keep their storage across the steps.
"""
import copy
import dataclasses

import pytest
import torch

from repro_torch.archs import get_arch
from repro_torch.archs.lm import LMArch
from repro_torch.data import lm_batch
from repro_torch.distributed import MeshInfo
from repro_torch.distributed.layout import Blocks
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.transformer import model as tm
from repro_torch.train import init_state, param_leaves
from repro_torch.train.parity import deterministic, failures, readings, snapshot, step_readings

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("name,opt,accum", [("smoke-gqa", "adamw", 1),
                                            ("smoke-mla-moe", "adafactor", 2)])
def test_lm_train_step_card_equals_cpu(dev, name, opt, accum):
    base = get_arch(name)
    cfg = dataclasses.replace(base.cfg, router_aux_coef=0.01) if base.cfg.is_moe else base.cfg
    cell = LMArch(cfg, opt, base.shapes, accum).make_cell("train_4k")
    lr = {"adamw": 3e-4, "adafactor": 1e-3}[opt]
    assert failures(step_readings(cell, dev, 0, lr), lr, "float32") == []


@pytest.mark.parametrize("shape", ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"])
def test_mace_step_card_equals_cpu(dev, shape):
    arch = get_arch("smoke-mace")
    dtype = str(arch.cfg_for(shape).compute_dtype).split(".")[1]
    assert failures(step_readings(arch.make_cell(shape), dev, 0, 1e-3), 1e-3, dtype) == []


def _ptrs(model, state) -> list:
    leaves = param_leaves(model)
    return [[p.data_ptr() for p in v.parts] for tree in (leaves, state["vr"], state["vc"],
                                                         state["m"])
            for v in tree.values() if isinstance(v, Blocks)]


@pytest.mark.parametrize("grid", [(1, 4), (2, 2)])
def test_resident_experts_on_a_card_mesh_equal_the_cpu_mesh(dev, grid):
    base = get_arch("smoke-mla-moe")
    arch = LMArch(dataclasses.replace(base.cfg, router_aux_coef=0.01), "adafactor", base.shapes)
    card = torch.device("cuda", 0)
    whole, _, batch = arch.make_cell("train_4k").make_inputs(0, "cpu")
    start = snapshot(whole)
    nxt = lm_batch(0, 1, 4, 32, arch.cfg.vocab_size, device="cpu")
    runs = {}
    for where, device in (("cpu", "cpu"), ("card", card)):
        mi = MeshInfo(make_test_mesh(4, model=grid[1], device=device))
        cell = arch.make_cell("train_4k", mi)
        model = tm.make_resident(copy.deepcopy(whole).to(device), mi)
        state = init_state(arch.optimizer(), model)
        before = _ptrs(model, state)
        # every leaf of the cell resident, each with vr, vc and m
        assert len(before) == 4 * len(tm.param_specs(arch.cfg, mi))
        with deterministic():
            model, state, m1 = cell.fn(model, state, {k: v.to(device) for k, v in batch.items()})
            p1 = snapshot(model)
            model, state, m2 = cell.fn(model, state, {k: v.to(device) for k, v in nxt.items()})
        assert _ptrs(model, state) == before
        runs[where] = (p1, (m1, m2))
    r = readings(start, runs["cpu"][0], runs["card"][0], runs["cpu"][1], runs["card"][1], 1e-3)
    assert failures(r, 1e-3, "float32") == []
