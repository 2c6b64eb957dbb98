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
"""
import dataclasses

import pytest
import torch

from repro_torch.archs import get_arch
from repro_torch.archs.lm import LMArch
from repro_torch.train.parity import failures, step_readings

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
