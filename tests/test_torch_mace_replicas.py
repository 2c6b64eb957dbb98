"""MACE's parameters as replicas over a mesh (the dst-partitioned layout).

``GNNArch.make_cell("ogb_products", mi)`` over a mesh of more than one
position holds every MACE parameter as ``Resident`` replicas of its
reference spec (whole), one part a distinct device of the mesh
(``models/gnn/distributed.py::make_replicas``), with AdamW's moments as
``Blocks`` of the same layout; each graph shard reads its device's part
in place (``on_device``), and the step sums the replicas' gradients in
part order and updates each part on its device. Here the mesh's four
positions name distinct CPU devices ("cpu:0".."cpu:3"), as four cards
would, so every leaf has four replicas.

Ground truth is the reference's jitted step on 4 virtual host devices
(``test_torch_train_mesh_recsys.py``'s MACE cases: smoke-mace's
ogb_products in float32, self-loop edges padded out), held by
``train/parity.py``'s float32 limits; across the two steps every part and
moment keeps its storage and the replicas stay equal bit for bit.
"""
import dataclasses

import pytest
import torch

from repro_torch.archs import get_arch
from repro_torch.distributed import DeviceMesh, MeshInfo
from repro_torch.distributed.layout import Blocks
from repro_torch.models.gnn.distributed import dst_partitioned_loss, make_replicas
from repro_torch.train import adamw, make_train_step, param_leaves
from repro_torch.train.parity import failures, readings
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse)
from test_torch_train_mesh_recsys import (
    LR,
    MACE_MESHES,
    mace_case,
    mace_reference,
    metrics_of,
    port_cell_run,
    reference_leaves,
)


def distinct(shape) -> MeshInfo:
    n = shape[0] * shape[1]
    return MeshInfo(DeviceMesh.create([f"cpu:{i}" for i in range(n)], shape, ("data", "model")))


def ptrs(tree: dict) -> dict:
    return {k: [p.data_ptr() for p in v.parts] for k, v in tree.items()}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return mace_reference(str(tmp_path_factory.mktemp("mace_replicas")))


@pytest.mark.parametrize("mesh_name", sorted(MACE_MESHES))
def test_mace_replicas_stay_in_place_and_the_step_equals_reference(ref, mesh_name):
    cfg, _, model, batches = mace_case(MACE_MESHES[mesh_name])
    mi = distinct(MACE_MESHES[mesh_name])
    cell = get_arch("smoke-mace").make_cell("ogb_products", mi)
    made, state, _ = cell.make_inputs(0, "cpu")
    leaves = param_leaves(made)
    assert all(isinstance(v, Blocks) and len(v.parts) == 4 for v in leaves.values())
    assert set(state["m"]) == set(leaves)
    step = make_train_step(lambda m, b: dst_partitioned_loss(m, cfg, mi, b), adamw(lr=LR),
                           clip_norm=1.0)
    fn = lambda m, s, b: step(make_replicas(m, cfg, mi), s, b)  # noqa: E731
    start, p1, got = port_cell_run(dataclasses.replace(cell, fn=fn), model, batches)
    case = f"mace-{mesh_name}"
    want_p = reference_leaves(ref, f"{case}|p1|", mace_case(MACE_MESHES[mesh_name])[2])
    r = readings(start, want_p, p1, (metrics_of(ref, case, 1), metrics_of(ref, case, 2)), got,
                 LR)
    assert not failures(r, LR, "float32"), r
    # the cell's own model and state across two steps: in place, replicas equal
    before = (ptrs(leaves), ptrs(state["m"]), ptrs(state["v"]))
    for b in batches:
        made, state, _ = fn(made, state, b)
    after = param_leaves(made)
    assert (ptrs(after), ptrs(state["m"]), ptrs(state["v"])) == before
    for k, v in after.items():
        assert all(torch.equal(p, v.parts[0]) for p in v.parts[1:]), k
