"""The port's checkpoints (``repro_torch.ckpt``) against the reference's
(``repro.ckpt``): the cases of ``tests/test_runtime.py`` (round trip and
atomicity, a shape mismatch raising, the data pipeline's restart
determinism), a stale ``.tmp`` left by a killed writer, a bf16 tree, the
two packages reading each other's checkpoints at smoke-gqa (parameters and
AdamW state, float32) and in bf16, and the elastic restore onto a mesh.

The port writes the reference's layout byte for byte: the same manifest,
the same file for every leaf (a bf16 leaf under the header ``ml_dtypes``
gives it, ``'<V2'``). The reference's own ``restore`` cannot cast a
``'<V2'`` array to bf16 (``ValueError: No cast function available``, its
own checkpoint or the port's alike), so the bf16 files are held equal
byte for byte and read back through ``ml_dtypes`` as the reference's
arrays.
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.archs.base import get_arch as ref_get_arch
from repro.ckpt import checkpoint as ref_ck
from repro.data.pipeline import lm_batch as ref_lm_batch
from repro.distributed.meshinfo import MeshInfo as RefMeshInfo
from repro.models.transformer import model as ref_tm
from repro.train.optimizer import adamw as ref_adamw
from repro_torch import ckpt
from repro_torch.archs import get_arch
from repro_torch.data import lm_batch
from repro_torch.distributed import MeshInfo
from repro_torch.distributed.layout import gather
from repro_torch.interop import adamw_state_from_reference, lm_params_from_reference
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.train import adamw, reference_layout
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse)


def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.tensor([1, 2, 3], dtype=torch.int32)}}
    d = str(tmp_path / "ckpt")
    ckpt.save(d, 5, tree)
    ckpt.save(d, 9, {"a": tree["a"] + 1, "nested": {"b": tree["nested"]["b"] + 1}})
    assert ckpt.latest_step(d) == 9
    like = {"a": torch.empty(3, 4), "nested": {"b": torch.empty(3, dtype=torch.int32)}}
    restored = ckpt.restore(d, 9, like)
    assert torch.equal(restored["a"], tree["a"] + 1)
    assert restored["nested"]["b"].dtype == torch.int32
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
    ckpt.prune_old(d, keep=1)
    assert ckpt.latest_step(d) == 9 and len(os.listdir(d)) == 1


def test_checkpoint_shape_mismatch_raises(tmp_path):
    d = str(tmp_path / "ckpt")
    ckpt.save(d, 1, {"w": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(d, 1, {"w": torch.empty(5)})


def test_restart_determinism_of_data_pipeline():
    a, b, c = (lm_batch(7, s, 4, 16, 1000, device="cpu")["tokens"] for s in (123, 123, 124))
    assert torch.equal(a, b) and not torch.equal(a, c)
    want = np.asarray(ref_lm_batch(7, 123, 4, 16, 1000)["tokens"])
    np.testing.assert_array_equal(a.numpy(), want)


def test_stale_tmp_is_ignored_then_cleared(tmp_path):
    """A writer killed mid-save leaves ``step_<N>.tmp``: ``latest_step`` does
    not see it, and the next save of that step clears it before writing."""
    d = str(tmp_path / "ckpt")
    ckpt.save(d, 4, {"w": torch.ones(3)})
    stale = os.path.join(d, "step_00000008.tmp")
    os.makedirs(stale)
    with open(os.path.join(stale, "leaf_00000.npy"), "wb") as f:
        f.write(b"half a file")
    assert ckpt.latest_step(d) == 4
    ckpt.save(d, 8, {"w": torch.full((3,), 2.0)})
    assert sorted(os.listdir(d)) == ["step_00000004", "step_00000008"]
    assert torch.equal(ckpt.restore(d, 8, {"w": torch.empty(3)})["w"], torch.full((3,), 2.0))


def test_bf16_tree_round_trip(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn((5, 7), generator=g).to(torch.bfloat16),
            "s": torch.randn((3,), generator=g).to(torch.bfloat16), "f": torch.randn(2)}
    d = str(tmp_path / "ckpt")
    ckpt.save(d, 2, tree)
    manifest = json.load(open(os.path.join(d, "step_00000002", "manifest.json")))
    assert {x["key"]: x["dtype"] for x in manifest["leaves"]} == {
        "f": "float32", "s": "bfloat16", "w": "bfloat16"}
    got = ckpt.restore(d, 2, {k: torch.empty_like(v) for k, v in tree.items()})
    for k, v in tree.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def smoke_gqa_state():
    """smoke-gqa's PRNGKey(0) parameters and an AdamW state part-way (m and v
    nonzero, count 3) in both packages."""
    cfg = ref_get_arch("smoke-gqa").cfg
    params = ref_tm.init_params(jax.random.PRNGKey(0), cfg)
    state = ref_adamw(3e-4).init(params)
    state = {"m": jax.tree.map(lambda p: p * 0.5, params),
             "v": jax.tree.map(lambda p: p * p, params), "count": state["count"] + 3}
    model = lm_params_from_reference(jax.tree.map(np.asarray, params),
                                     get_arch("smoke-gqa").cfg, device="cpu")
    port_state = adamw_state_from_reference(jax.tree.map(np.asarray, state), model, device="cpu")
    return {"params": params, "opt": state}, {"params": reference_layout(model), "opt": port_state}


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    ref_tree, port_tree = smoke_gqa_state()
    d = str(tmp_path / "ref")
    ref_ck.save(d, 7, ref_tree)
    like = {"params": {k: torch.empty_like(v) for k, v in port_tree["params"].items()},
            "opt": {"m": {k: torch.empty_like(v) for k, v in port_tree["opt"]["m"].items()},
                    "v": {k: torch.empty_like(v) for k, v in port_tree["opt"]["v"].items()},
                    "count": torch.empty((), dtype=torch.int32)}}
    got = ckpt.restore(d, 7, like)
    for k, v in port_tree["params"].items():
        assert torch.equal(got["params"][k], v), k
    for key in ("m", "v"):
        for k, v in port_tree["opt"][key].items():
            assert torch.equal(got["opt"][key][k], v), (key, k)
    assert int(got["opt"]["count"]) == 3


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    """The port's checkpoint of the same state is the reference's, file for
    file, and the reference's ``restore`` reads it back bit for bit."""
    ref_tree, port_tree = smoke_gqa_state()
    ckpt.save(str(tmp_path / "port"), 7, port_tree)
    ref_ck.save(str(tmp_path / "ref"), 7, ref_tree)
    for name in os.listdir(tmp_path / "ref" / "step_00000007"):
        assert (tmp_path / "port" / "step_00000007" / name).read_bytes() == (
            tmp_path / "ref" / "step_00000007" / name).read_bytes(), name
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), ref_tree)
    got = ref_ck.restore(str(tmp_path / "port"), 7, like)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref_tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bf16_checkpoints_cross_both_ways(tmp_path):
    """bf16 leaves: the reference's file restores into the port bit for bit,
    and the port's file for the same tree is the reference's byte for byte,
    read back through ``ml_dtypes`` as the reference's arrays."""
    rng = np.random.default_rng(0)
    arrays = {"w": rng.normal(size=(4, 6)).astype(ml_dtypes.bfloat16),
              "layers": {"scale": rng.normal(size=(3,)).astype(ml_dtypes.bfloat16)}}
    ref_ck.save(str(tmp_path / "ref"), 1, jax.tree.map(jnp.asarray, arrays))
    port = {"w": torch.from_numpy(arrays["w"].view(np.int16)).view(torch.bfloat16),
            "layers": {"scale": torch.from_numpy(arrays["layers"]["scale"].view(np.int16)
                                                 ).view(torch.bfloat16)}}
    got = ckpt.restore(str(tmp_path / "ref"), 1, port)
    assert torch.equal(got["w"].view(torch.int16), port["w"].view(torch.int16))
    assert torch.equal(got["layers"]["scale"].view(torch.int16),
                       port["layers"]["scale"].view(torch.int16))
    ckpt.save(str(tmp_path / "port"), 1, port)
    step = "step_00000001"
    for name in os.listdir(tmp_path / "ref" / step):
        assert (tmp_path / "port" / step / name).read_bytes() == (
            tmp_path / "ref" / step / name).read_bytes(), name
    back = np.load(tmp_path / "port" / step / "leaf_00001.npy").view(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(back.view(np.uint16), arrays["w"].view(np.uint16))


@pytest.mark.parametrize("grid", [(2, 2), (1, 4)])
def test_restore_onto_a_mesh_is_the_elastic_restart(tmp_path, grid):
    """A one-device checkpoint restored onto a mesh in the LM's layout: each
    leaf comes back as one block a position with the reference's
    ``NamedSharding`` shard shape, and the blocks put together equal the
    saved leaf bit for bit (parameters and AdamW's moments)."""
    _, port_tree = smoke_gqa_state()
    d = str(tmp_path / "ckpt")
    ckpt.save(d, 3, port_tree)
    mi = MeshInfo(make_test_mesh(4, model=grid[1], device="cpu"))
    cell = get_arch("smoke-gqa").make_cell("train_4k", mi)
    specs = {"params": cell.specs, "opt": adamw().state_specs(cell.specs, port_tree["params"])}
    got = ckpt.restore(d, 3, port_tree, layout=(mi, specs))
    amesh = AbstractMesh(grid, ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
    ref_specs = ref_tm.param_specs(ref_get_arch("smoke-gqa").cfg, RefMeshInfo(mesh=amesh))
    assert ref_specs["lm_head"]["w"] == P(*cell.specs["lm_head.weight"])
    for tree, want, spec_tree in ((got["params"], port_tree["params"], specs["params"]),
                                  (got["opt"]["m"], port_tree["opt"]["m"], specs["opt"]["m"])):
        for k, blocks in tree.items():
            assert len(blocks) == 4
            shape = NamedSharding(amesh, P(*spec_tree[k])).shard_shape(tuple(want[k].shape))
            assert all(tuple(b.shape) == shape for b in blocks), k
            assert torch.equal(gather(blocks, spec_tree[k], mi, want[k].shape), want[k]), k
    assert [int(b) for b in got["opt"]["count"]] == [3] * 4
