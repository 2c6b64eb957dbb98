"""Replicated blocks sum only the rows their reads touched.

A table whose columns the data axes cannot split (smoke-deepfm's width-5
tables and width-1 linear tables) is whole over the data axis: on a (4,
1) mesh every position holds the whole table, on a (2, 2) mesh each model
shard's row block is held by both data positions. On a mesh whose
positions are distinct devices each position holds a replica (here
distinct CPU devices, "cpu:0".."cpu:3", as four cards would), and each
replica's gradient holds only its data group's rows. The step adds
the replicas' gradients in part order on the first replica's device, over
the union of the rows the groups read (``train_step._sum_replicas`` with
the rows ``mesh_lookup`` reported), and writes the sum into each replica.
An untouched row is +0.0 in every replica, so the sparse sum has the bits
of the dense sum of every row; the tests hold it so, bit for bit (+0.0
and -0.0 apart), and the parts after a whole AdamW step equal the dense
path's.
"""
import copy

import pytest
import torch

from repro_torch.archs import get_arch
from repro_torch.archs.recsys import shape_batch
from repro_torch.distributed import DeviceMesh, MeshInfo
from repro_torch.distributed.layout import Blocks, Resident
from repro_torch.train import param_leaves
from repro_torch.train.train_step import _layout, _sum_replicas
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse)

NAME = "smoke-deepfm"
GRIDS = {"4x1": (4, 1), "2x2": (2, 2)}


def distinct(grid) -> MeshInfo:
    return MeshInfo(DeviceMesh.create([f"cpu:{i}" for i in range(4)], grid, ("data", "model")))


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_sparse_replica_sum_equals_the_dense_sum_bit_for_bit(grid):
    """Every replicated table's replica gradients: the sum over the touched
    rows equals the sum of every row, part for part, bit for bit; the
    replicas' own gradients differ (each its group's rows), and a row no
    group read is +0.0 in each."""
    arch, mi = get_arch(NAME), distinct(GRIDS[grid])
    n_replicas = GRIDS[grid][0]
    model, _, batch = arch.make_cell("train_batch", mi).make_inputs(0, "cpu")
    leaves = {k: leaf for k, leaf in _layout(model).items() if isinstance(leaf.value, Blocks)}
    replicated = {k for k, leaf in leaves.items()
                  if len(leaf.value.layout.replicas()[0]) == n_replicas}
    assert replicated
    with torch.enable_grad():
        loss, _ = arch.loss(model, batch, mi)
    named = dict(model.named_parameters())
    names = [n for leaf in leaves.values() for n in leaf.names]
    raw = list(torch.autograd.grad(loss, [named[n] for n in names]))
    for k, leaf in leaves.items():
        parts, raw = raw[: len(leaf.names)], raw[len(leaf.names):]
        rows = leaf.resident.take_rows()
        dense = _sum_replicas(Blocks(leaf.value.layout, parts), None)
        sparse = _sum_replicas(Blocks(leaf.value.layout, [p.clone() for p in parts]), rows)
        for a, b in zip(dense.parts, sparse.parts):
            assert torch.equal(bits(a), bits(b)), k
        if k not in replicated:
            continue
        differ = False
        for group in leaf.value.layout.replicas():
            ps = [parts[i] for i in group]
            differ |= any(not torch.equal(ps[0], p) for p in ps[1:])
            read = torch.unique(torch.cat([rows[i] for i in group]).long())
            untouched = torch.ones(ps[0].shape[0], dtype=torch.bool)
            untouched[read] = False
            assert all(torch.equal(bits(p[untouched]), torch.zeros_like(bits(p[untouched])))
                       for p in ps), k
        assert differ, k


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_updated_parts_equal_the_dense_path_bit_for_bit(grid, monkeypatch):
    """Two steps of the cell: the parts and AdamW's moments after them
    equal, bit for bit, those of the same steps with the dense replica sum
    (no rows reported)."""
    arch, mi = get_arch(NAME), distinct(GRIDS[grid])
    cell = arch.make_cell("train_batch", mi)
    model, state, batch = cell.make_inputs(0, "cpu")
    dense_model, dense_state = copy.deepcopy(model), copy.deepcopy(state)
    nxt = shape_batch(arch.cfg, "train_batch", 0, 1, shapes=arch.shapes, device="cpu")
    for b in (batch, nxt):
        model, state, _ = cell.fn(model, state, b)
    with monkeypatch.context() as mp:
        mp.setattr(Resident, "take_rows", lambda self: None)
        for b in (batch, nxt):
            dense_model, dense_state, _ = cell.fn(dense_model, dense_state, b)
    got, want = param_leaves(model), param_leaves(dense_model)
    for k, v in got.items():
        for a, b in zip(v.parts if isinstance(v, Blocks) else [v],
                        want[k].parts if isinstance(v, Blocks) else [want[k]]):
            assert torch.equal(bits(a), bits(b)), k
    for name_ in ("m", "v"):
        for k, v in state[name_].items():
            if isinstance(v, Blocks):
                assert all(torch.equal(bits(a), bits(b))
                           for a, b in zip(v.parts, dense_state[name_][k].parts)), k
