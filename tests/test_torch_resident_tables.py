"""Recsys tables resident as their blocks over a mesh.

A train cell over a mesh of more than one position makes every table a
``Resident`` (``models/recsys/models.py::make_resident``): its
``table_spec`` blocks on their positions from ``make_inputs`` on, one part
for each distinct block on each device, each position's block of the
reference's ``NamedSharding`` shard shape. The step reads the blocks in
place, its gradients land on them, and AdamW's moments are ``Blocks`` of
the same layout, each part updated where it lives: across two (2, 2) CPU
steps every part of every table and moment keeps its storage and no
whole table is placed after the first step. A checkpoint saved over the
mesh writes the same bytes as the whole tables would and restores on one
device equal, leaf for leaf; restored onto the mesh it is placed as the
blocks again.
"""
import filecmp
import math

import pytest
import torch

from repro_torch.archs import get_arch
from repro_torch.archs.recsys import shape_batch
from repro_torch.ckpt import checkpoint as ck
from repro_torch.distributed import MeshInfo
from repro_torch.distributed import layout
from repro_torch.distributed.layout import Blocks, shard_shape
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.recsys import models as rs
from repro_torch.train import adafactor, global_norm, init_state, param_leaves, reference_layout
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse)

RECSYS = ("smoke-dlrm", "smoke-deepfm", "smoke-two-tower", "smoke-sasrec")


def mesh22() -> MeshInfo:
    return MeshInfo(make_test_mesh(4, model=2, device="cpu"))


def batches(arch):
    return [shape_batch(arch.cfg, "train_batch", 0, s, shapes=arch.shapes, device="cpu")
            for s in (0, 1)]


def ptrs(tree) -> dict:
    return {k: [p.data_ptr() for p in v.parts] for k, v in tree.items() if isinstance(v, Blocks)}


@pytest.mark.parametrize("name", RECSYS)
def test_blocks_and_moments_stay_in_place_across_steps(name, monkeypatch):
    arch, mi = get_arch(name), mesh22()
    cell = arch.make_cell("train_batch", mi)
    model, state, _ = cell.make_inputs(0, "cpu")
    leaves = param_leaves(model)
    tables = [k for k in leaves if isinstance(leaves[k], Blocks)]
    assert tables and set(tables) == {k for k, s in cell.specs.items() if s and s[0] == "model"}
    before = (ptrs(leaves), ptrs(state["m"]), ptrs(state["v"]))
    start = {k: leaves[k].whole() for k in tables}
    placed = []
    real = layout.place

    def counting(t, spec, mesh):
        placed.append(tuple(t.shape))
        return real(t, spec, mesh)

    monkeypatch.setattr(layout, "place", counting)
    monkeypatch.setattr(rs, "place", counting)
    for i, batch in enumerate(batches(arch)):
        model, state, metrics = cell.fn(model, state, batch)
        assert math.isfinite(float(metrics["loss"]))
        if i == 0:
            placed.clear()
    assert placed == [], f"whole tables placed after the first step: {placed}"
    after = param_leaves(model)
    assert (ptrs(after), ptrs(state["m"]), ptrs(state["v"])) == before
    for k in tables:
        assert not torch.equal(after[k].whole(), start[k]), k  # the blocks were updated


@pytest.mark.parametrize("name", ("smoke-dlrm", "smoke-deepfm"))
def test_each_position_holds_its_block_and_no_more(name):
    arch, mi = get_arch(name), mesh22()
    cell = arch.make_cell("train_batch", mi)
    model, _, _ = cell.make_inputs(0, "cpu")
    for k, v in param_leaves(model).items():
        if not isinstance(v, Blocks):
            continue
        block = shard_shape(v.shape, cell.specs[k], mi)
        assert all(tuple(p.shape) == block for p in v.positions()), k
        # one device: one part a distinct block, shared by the positions
        # that hold it (DeepFM's width-1 tables are whole over the data axis)
        n_blocks = math.prod(s // b for s, b in zip(v.shape, block))
        assert len(v.parts) == n_blocks and all(p.is_contiguous() for p in v.parts), k
    whole = reference_layout(model)
    assert all(not isinstance(t, Blocks) for t in whole.values())


def test_a_whole_model_turns_resident_at_its_first_mesh_step():
    """A model built whole (as the reference's parameters load) steps over
    the mesh equal to the cell's own resident model from those
    parameters."""
    arch, mi = get_arch("smoke-dlrm"), mesh22()
    cell = arch.make_cell("train_batch", mi)
    whole, _, batch = arch.make_cell("train_batch").make_inputs(3, "cpu")
    res, state_r, _ = cell.make_inputs(3, "cpu")
    _, state_w, _ = cell.make_inputs(3, "cpu")
    for k, v in param_leaves(res).items():
        assert torch.equal(v.whole() if isinstance(v, Blocks) else v, reference_layout(whole)[k])
    whole, state_w, _ = cell.fn(whole, state_w, batch)
    res, state_r, _ = cell.fn(res, state_r, batch)
    assert isinstance(param_leaves(whole)["tables.t0"], Blocks)
    for k, v in reference_layout(res).items():
        assert torch.equal(v, reference_layout(whole)[k]), k


def test_norm_over_blocks_and_an_elementwise_optimizer():
    """The norm over the blocks is the whole leaves' norm. AdamW's moments
    are laid out as their tables; Adafactor, which is not elementwise, lays
    its statistics out by its own ``state_specs``: ``vr`` by the table's
    spec without its last entry, ``vc`` without its second-to-last."""
    arch, mi = get_arch("smoke-two-tower"), mesh22()
    model, _, _ = arch.make_cell("train_batch", mi).make_inputs(0, "cpu")
    leaves = param_leaves(model)
    whole = reference_layout(model)
    torch.testing.assert_close(global_norm(leaves), global_norm(whole), rtol=1e-6, atol=0)
    tables = {k: v for k, v in leaves.items() if isinstance(v, Blocks)}
    state = init_state(adafactor(lr=1e-3), model)
    for k, b in tables.items():
        spec = tuple(b.layout.spec)
        vr, vc = state["vr"][k], state["vc"][k]
        assert isinstance(vr, Blocks) and isinstance(vc, Blocks), k
        assert (vr.layout.spec, vc.layout.spec) == (spec[:-1], spec[:-2] + spec[-1:]), k
        assert (vr.shape, vc.shape) == (b.shape[:-1], b.shape[:-2] + b.shape[-1:]), k


def test_mesh_checkpoint_restores_on_one_device(tmp_path):
    arch, mi = get_arch("smoke-deepfm"), mesh22()
    cell = arch.make_cell("train_batch", mi)
    model, state, batch = cell.make_inputs(0, "cpu")
    model, state, _ = cell.fn(model, state, batch)
    ck.save(str(tmp_path / "blocks"), 1, {"params": param_leaves(model), "opt": state})

    def whole(tree):
        return {k: whole(v) if isinstance(v, dict) else (v.whole() if isinstance(v, Blocks) else v)
                for k, v in tree.items()}

    want = {"params": reference_layout(model), "opt": whole(state)}
    ck.save(str(tmp_path / "whole"), 1, want)
    d1, d2 = tmp_path / "blocks" / "step_00000001", tmp_path / "whole" / "step_00000001"
    names = sorted(p.name for p in d1.iterdir())
    assert names == sorted(p.name for p in d2.iterdir())
    assert filecmp.cmpfiles(d1, d2, names, shallow=False)[0] == names  # byte for byte
    one_model, one_state, _ = arch.make_cell("train_batch").make_inputs(1, "cpu")
    like = {"params": reference_layout(one_model), "opt": one_state}
    got = ck.restore(str(tmp_path / "blocks"), 1, like)
    for part in ("params", "opt"):
        flat_w, flat_g = ck._flat(want[part]), ck._flat(got[part])
        assert [k for k, _ in flat_w] == [k for k, _ in flat_g]
        for (k, a), (_, b) in zip(flat_w, flat_g):
            assert torch.equal(a, b), k
    # restored onto the mesh: Blocks of the live layout, equal to the saved ones
    live = {"params": param_leaves(model), "opt": state}
    back = ck.restore(str(tmp_path / "blocks"), 1, live)
    b = back["params"]["tables.t0"]
    assert isinstance(b, Blocks) and b.layout == live["params"]["tables.t0"].layout
    assert torch.equal(b.whole(), want["params"]["tables.t0"])
    # the driver's resume writes the restored blocks into the live ones
    live_t0 = live["params"]["tables.t0"]
    for p in live_t0.parts:
        p.data.zero_()
    live_t0.copy_(b)
    assert torch.equal(param_leaves(model)["tables.t0"].whole(), want["params"]["tables.t0"])
