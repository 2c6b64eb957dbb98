"""Recsys training on the card: the embedding bag's backward kernel against
its plain version, and one train step per model on the card against the
CPU.

Marked ``cuda``; each test skips where there is no CUDA device. This file
imports no JAX, so it also runs where only the port is installed:

    python -m pytest -m cuda tests/test_torch_cuda_train.py

The backward kernel and its plain version add each row's contributions in
row-major (b, l) order from +0.0 after one stable sort, so they agree bit
for bit on float gradients too (row offsets past 2**31 elements included).
A train step on the card and on the CPU, from the same weights and batch
(smoke configs; float32 products, PyTorch's default of no TF32): the losses within 1e-5 relative; every new
parameter within 2 lr + 1e-6 of the CPU's (AdamW's first update is
-lr g / (|g| + eps), so an element whose gradient is at rounding level may
move the other way) and within 1e-5 wherever the CPU's |g| exceeds 1e-4
of its leaf's largest.
"""
import copy

import pytest
import torch

from repro_torch.archs import get_arch
from repro_torch.kernels.embedding_bag import (
    embedding_bag,
    embedding_bag_backward,
    embedding_bag_backward_cuda,
    embedding_bag_backward_plain,
)
from repro_torch.train import reference_layout

LR = 1e-3
# (V, D, B, L): the two-tower bag; heavy repeats; the scalar path (D = 10,
# 13); D = 128; three rows for 64 bags; a table past 2**31 elements.
SHAPES = ((100_000, 256, 1024, 50), (1000, 10, 512, 50), (50, 128, 300, 20),
          (5000, 13, 77, 33), (3, 256, 64, 40), (8_400_000, 256, 16, 8))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run only on the card")
    return torch.device("cuda")


def inputs(dev, v, d, b, length, integer, seed=0):
    """30% padding, bag 0 all padding, bag 1 holding row 0 twice, row V - 1
    and two ids past V; the last bag reads rows near the top of the table."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, v, (b, length), generator=gen, dtype=torch.int32, device=dev)
    ids[torch.rand((b, length), generator=gen, device=dev) < 0.3] = -1
    ids[0] = -1
    ids[1, :5] = torch.tensor([0, 0, v - 1, v, v + 7], dtype=torch.int32)
    ids[-1, :3] = torch.tensor([v - 1, v - 2, v - 1], dtype=torch.int32)
    if integer:
        g = torch.randint(-8, 9, (b, d), generator=gen, device=dev).float()
    else:
        g = torch.randn((b, d), generator=gen, device=dev)
    return ids, g


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
def test_backward_kernel_equals_plain(dev, integer, mode):
    for i, (v, d, b, length) in enumerate(SHAPES):
        ids, g = inputs(dev, v, d, b, length, integer, seed=i)
        before = embedding_bag_backward.launches
        got = embedding_bag_backward(ids, g, v, mode=mode)
        torch.cuda.synchronize()
        assert embedding_bag_backward.launches == before + 1
        want = embedding_bag_backward_plain(ids, g, v, mode)
        assert got.shape == (v, d) and torch.equal(got, want), (v, d, b, length)
        del got, want
    with pytest.raises(ValueError):
        embedding_bag_backward_cuda(ids.long(), g, v)
    with pytest.raises(ValueError):
        embedding_bag_backward_cuda(ids, g.double(), v)


@pytest.mark.cuda
def test_autograd_runs_both_bag_kernels(dev):
    """A table on the card that needs a gradient: the forward bag kernel and
    the backward kernel launch once each, and the gradient equals the CPU's
    bit for bit."""
    ids, g = inputs(dev, 5000, 256, 512, 50, integer=False)
    ids = ids.clamp_max(4999)  # the plain forward's gather takes no id >= V
    table = torch.randn((5000, 256), device=dev, requires_grad=True)
    f0, b0 = embedding_bag.launches, embedding_bag_backward.launches
    out = embedding_bag(table, ids)
    (grad,) = torch.autograd.grad(out, table, g)
    torch.cuda.synchronize()
    assert (embedding_bag.launches, embedding_bag_backward.launches) == (f0 + 1, b0 + 1)
    host = table.detach().cpu().requires_grad_()
    (want,) = torch.autograd.grad(embedding_bag(host, ids.cpu()), host, g.cpu())
    assert torch.equal(grad.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["smoke-dlrm", "smoke-deepfm", "smoke-two-tower"])
def test_train_step_card_matches_cpu(dev, name):
    arch = get_arch(name)
    cell = arch.make_cell("train_batch")
    host, host_state, batch = cell.make_inputs(0, "cpu")
    card = copy.deepcopy(host).to(dev)
    card_state = {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict) else v.to(dev))
                  for k, v in host_state.items()}
    grads = {}
    loss_cpu, _ = arch.loss(host, batch)
    views = reference_layout(host)
    named = dict(host.named_parameters())
    for (k, view), g in zip(views.items(),
                            torch.autograd.grad(loss_cpu, [named[k] for k in views])):
        grads[k] = g.T if view.dim() == 2 and k.endswith("weight") else g
    f0, b0 = embedding_bag.launches, embedding_bag_backward.launches
    card_batch = {k: t.to(dev) for k, t in batch.items()}
    card, card_state, met_card = cell.fn(card, card_state, card_batch)
    torch.cuda.synchronize()
    bags = 1 if arch.cfg.model == "two_tower" else 0
    assert embedding_bag.launches - f0 == bags and embedding_bag_backward.launches - b0 == bags
    host, host_state, met_host = cell.fn(host, host_state, batch)
    assert abs(float(met_card["loss"]) - float(met_host["loss"])) <= 1e-5 * abs(
        float(met_host["loss"]))
    card_views = reference_layout(card)
    for k, view in reference_layout(host).items():
        diff = (card_views[k].detach().cpu() - view.detach()).abs()
        assert float(diff.max()) <= 2 * LR + 1e-6, k
        g = grads[k].abs()
        firm = g > 1e-4 * g.max()
        if bool(firm.any()):
            assert float(diff[firm].max()) <= 1e-5, k
