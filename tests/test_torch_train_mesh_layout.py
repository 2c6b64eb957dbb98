"""The pieces of training over a mesh on the CPU: ``shard_batch`` against the
reference's layout of a batch, ``distributed/layout.py``'s blocks against
``NamedSharding`` (tuple axes of a pod mesh included), the optimizers'
``state_specs`` against the reference's, and ``mesh_lookup`` (a table's
blocks read on their positions) against the one-device read, reading
only the blocks its spec names.

The reference's shard shapes come from an ``AbstractMesh`` (no devices):
``NamedSharding(mesh, spec).shard_shape``. The lookups are exact: a row
block's gather returns the row or zero, and x + 0 = x; a bag's partial
sums add in another order, so bags are held to 1e-6 of their largest.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.archs.base import get_arch as ref_get_arch
from repro.distributed.meshinfo import MeshInfo as RefMeshInfo
from repro.models.transformer import model as ref_tm
from repro.train.optimizer import adafactor as ref_adafactor
from repro_torch.archs import get_arch
from repro_torch.data import shard_batch
from repro_torch.distributed import DeviceMesh, MeshInfo
from repro_torch.distributed.layout import gather, place, port_name, shard_shape
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.recsys import models as rm
from repro_torch.models.recsys.models import mesh_lookup
from repro_torch.train import adafactor, adamw, reference_layout
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse)


def abstract(grid, names=("data", "model")):
    return AbstractMesh(tuple(grid), tuple(names), axis_types=(AxisType.Auto,) * len(grid))


@pytest.mark.parametrize("grid", [(2, 2), (4, 1), (1, 4)])
def test_shard_batch_matches_the_reference_layout(grid):
    """Leaves whose leading axis the data axes divide split into one block a
    data group (the reference's shard shape), in group order on the
    group's first device; others go whole to every group."""
    mi = MeshInfo(make_test_mesh(4, model=grid[1], device="cpu"))
    ref_mi = RefMeshInfo(mesh=abstract(grid))
    batch = {"dense": torch.arange(16 * 3, dtype=torch.float32).reshape(16, 3),
             "odd": torch.arange(3), "scalar": torch.tensor(2.0), "n_graphs": 5}
    groups = shard_batch(batch, mi)
    assert len(groups) == grid[0]
    for k, x in batch.items():
        if not isinstance(x, torch.Tensor):
            assert all(g[k] == x for g in groups)
            continue
        spec = ref_mi.axes_if_divisible(x.shape[0], ref_mi.dp_axes) if x.dim() else None
        want = NamedSharding(ref_mi.mesh, P(spec)).shard_shape(tuple(x.shape))
        assert all(tuple(g[k].shape) == want for g in groups), k
        joined = torch.cat([g[k] for g in groups]) if spec else groups[0][k]
        assert torch.equal(joined, x), k


def test_place_and_gather_against_named_sharding_on_a_pod_mesh():
    """A (2, 1, 2) pod mesh: tuple axes split a dimension over their
    product, the first outermost; every position's block has the
    reference's shard shape and the blocks put back the leaf."""
    mesh = DeviceMesh.create(["cpu"] * 4, (2, 1, 2), ("pod", "data", "model"))
    amesh = abstract((2, 1, 2), ("pod", "data", "model"))
    t = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    for spec in [(("pod", "data"), "model"), ("model", None, "pod"), (None,), (),
                 (("pod", "model"),)]:
        blocks = place(t, spec, mesh)
        want = NamedSharding(amesh, P(*spec)).shard_shape(tuple(t.shape))
        assert shard_shape(t.shape, spec, mesh) == want
        assert len(blocks) == 4 and all(tuple(b.shape) == want for b in blocks), spec
        assert torch.equal(gather(blocks, spec, mesh, t.shape), t), spec
    # position (pod 1, data 0, model 0) holds rows 4..7 of a ("pod", "data") split
    assert torch.equal(place(t, (("pod", "data"),), mesh)[2], t[4:])
    with pytest.raises(ValueError, match="splits a dimension"):
        shard_shape((6,), ("pod", ), DeviceMesh.create(["cpu"] * 4, (4, 1), ("pod", "model")))


def by_name(tree, is_leaf=None) -> dict:
    """A reference tree's leaves keyed by the port's parameter names."""
    return {port_name(tuple(getattr(p, "key", getattr(p, "idx", p)) for p in path)): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


@pytest.mark.parametrize("grid", [(2, 2), (1, 4)])
def test_optimizer_state_specs_match_the_reference(grid):
    """smoke-gqa's AdamW and Adafactor (momentum) state laid out from the
    parameters' specs: every leaf's shard shape is the reference's
    ``state_specs``'."""
    mi = MeshInfo(make_test_mesh(4, model=grid[1], device="cpu"))
    cell = get_arch("smoke-gqa").make_cell("train_4k", mi)
    params = reference_layout(cell.make_inputs(0, "cpu")[0])
    cfg = ref_get_arch("smoke-gqa").cfg
    ref_mi = RefMeshInfo(mesh=abstract(grid))
    ref_params = jax.eval_shape(lambda: ref_tm.init_params(jax.random.PRNGKey(0), cfg))
    ref_specs = ref_tm.param_specs(cfg, ref_mi)
    opt, ref_opt = adafactor(lr=1e-3, momentum=0.9), ref_adafactor(lr=1e-3, momentum=0.9)
    state = opt.init(params)
    want_specs = ref_opt.state_specs(ref_specs, ref_params)
    ref_state = jax.eval_shape(ref_opt.init, ref_params)
    got_specs = opt.state_specs(cell.specs, params)
    for key in ("vr", "vc", "m"):
        shapes = by_name(ref_state[key])
        specs = by_name(want_specs[key], is_leaf=lambda x: isinstance(x, P))
        want = {k: NamedSharding(ref_mi.mesh, specs[k]).shard_shape(v.shape)
                for k, v in shapes.items()}
        got = {k: shard_shape(v.shape, got_specs[key][k], mi) for k, v in state[key].items()}
        assert got == want, key
    assert adamw().state_specs(cell.specs, params)["m"] == cell.specs


@pytest.mark.parametrize("grid", [(2, 2), (1, 4)])
def test_mesh_lookup_equals_the_one_device_read(grid):
    """Rows and bags read over the mesh equal the whole table's read: a
    batch the data axes divide and one they do not (3 rows), -1 padding in
    the bags, ids in every row block."""
    mi = MeshInfo(make_test_mesh(4, model=grid[1], device="cpu"))
    g = torch.Generator().manual_seed(0)
    table = torch.randn((512, 8), generator=g, requires_grad=True)
    for b in (8, 3):
        ids = torch.randint(0, 512, (b,), generator=g, dtype=torch.int32)
        assert torch.equal(mesh_lookup(table, ids, mi), mesh_lookup(table, ids))
        bag = torch.randint(0, 512, (b, 5), generator=g, dtype=torch.int32)
        bag[0, 1:] = -1
        got, want = mesh_lookup(table, bag, mi, bag=True), mesh_lookup(table, bag, bag=True)
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=0,
                                   atol=1e-6 * float(want.detach().abs().max()))
    # the gradient reaches every row block of the whole table
    ids = torch.arange(0, 512, 64, dtype=torch.int32)
    (grad,) = torch.autograd.grad(mesh_lookup(table, ids, mi).sum(), table)
    assert torch.equal(grad.sum(1) != 0, torch.zeros(512, dtype=torch.bool).index_fill_(
        0, ids.long(), True))


@pytest.mark.parametrize("grid", [(2, 2), (4, 1), (1, 4)])
@pytest.mark.parametrize("width", [8, 1])
def test_mesh_lookup_reads_the_blocks_its_spec_names(monkeypatch, grid, width):
    """Every read of a table over the mesh is of one block of ``place``'s
    layout under ``table_spec`` (the spec the cells carry): rows over the
    model axis, columns over the data axes where they divide the width; no
    read sees a wider or taller block."""
    mi = MeshInfo(make_test_mesh(4, model=grid[1], device="cpu"))
    table = torch.randn((512, width), generator=torch.Generator().manual_seed(1))
    spec = rm.table_spec(width, mi)
    assert spec == ("model", "data" if width % grid[0] == 0 else None)
    block = shard_shape(table.shape, spec, mi)
    assert [tuple(b.shape) for b in place(table, spec, mi)] == [block] * 4
    seen = []
    read = rm._masked_rows
    monkeypatch.setattr(rm, "_masked_rows", lambda t, ids: seen.append(tuple(t.shape))
                        or read(t, ids))
    ids = torch.randint(0, 512, (8,), generator=torch.Generator().manual_seed(2),
                        dtype=torch.int32)
    assert torch.equal(mesh_lookup(table, ids, mi), mesh_lookup(table, ids))
    # one read a (group, row block, column block)
    assert seen == [block] * (grid[0] * grid[1] * (table.shape[1] // block[1]))
