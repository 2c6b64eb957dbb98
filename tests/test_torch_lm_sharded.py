"""The sequence-sharded decode and the expert-parallel MoE on multi-shard
meshes, port against reference.

The reference runs in a subprocess with 4 virtual host devices (jax fixes
its device count at its first initialisation, so this cannot run
in-process), on meshes of ``AxisType.Auto`` axes with its inputs placed
replicated (``device_put(..., NamedSharding(mesh, P()))``): with jax
0.9's default ``Explicit`` axes its ``with_sharding_constraint`` fails
(``distributed/meshinfo.py:100``). For ``smoke-gqa`` and ``smoke-mla-moe``
(PRNGKey(0) parameters) on (1, 4) and (2, 2) meshes, and ``smoke-mla-moe``
also on (4, 1), it runs
``prefill_logits`` on (2, 8) tokens and eight ``decode_step``s from a zero
8-token cache at batch 4 (split over the data axis on (2, 2)) and at batch
1 (which the data axis does not split), and writes every logit and the
final caches to an npz. Its own timeout is 120 s.

The port runs the same grids on the CPU (a ``DeviceMesh`` whose positions
all hold the CPU): the cache laid out by ``init_cache(..., mi=mi)`` as a
grid of blocks, the MoE expert-parallel. Each mesh's result must equal the
reference's on that mesh within 1e-5 of the largest element (float32;
the log-sum-exp and the shard sums add in other orders), not the (1, 1)
result: on (2, 2) each data group computes its own MoE capacity, and
``smoke-mla-moe``'s decode then differs from its (1, 1) decode.

On (4, 1) the reference's MoE has no expert-parallel branch (it needs a
model axis > 1) and gives all tokens one capacity: the port's decode cell
keeps ``smoke-mla-moe`` whole there and equals the reference.

The same decode steps of a model made resident on the mesh
(``models/transformer/model.py::make_resident``: every leaf its blocks,
the step tensor-parallel) are held to the same reference values by the
same tolerance (``tests/test_torch_resident_decode.py`` holds them to the
port's whole-parameter decode and counts their collectives).
"""
import functools
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.archs.base import get_arch as ref_get_arch
from repro.models.transformer import model as ref_tm
from repro_torch.archs import get_arch
from repro_torch.archs.lm import LMArch
from repro_torch.configs.lm_configs import SMOKE_LM_SHAPES
from repro_torch.distributed import MeshInfo
from repro_torch.distributed.layout import whole_leaves
from repro_torch.interop import lm_params_from_reference
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.transformer import (
    decode_step,
    gather_cache,
    init_cache,
    make_resident,
    prefill_logits,
)
from test_torch_lm import close
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
NAMES = ("smoke-gqa", "smoke-mla-moe")
STEPS = 8

SCRIPT = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro.archs.base import get_arch
    from repro.distributed.meshinfo import MeshInfo
    from repro.models.transformer import model as tm

    assert len(jax.devices()) == 4
    out_path, steps = sys.argv[1], int(sys.argv[2])
    toks = np.random.default_rng(0).integers(0, 512, size=(4, steps)).astype(np.int32)
    out = {"tokens": toks}
    for name in ("smoke-gqa", "smoke-mla-moe"):
        cfg = get_arch(name).cfg
        params = tm.init_params(jax.random.PRNGKey(0), cfg)
        meshes = (("1x4", (1, 4)), ("2x2", (2, 2)))
        if name == "smoke-mla-moe":  # no expert-parallel branch on a model axis of 1
            meshes += (("4x1", (4, 1)),)
        for mesh_name, shape in meshes:
            mesh = jax.make_mesh(shape, ("data", "model"),
                                 axis_types=(AxisType.Auto, AxisType.Auto))
            mi = MeshInfo(mesh=mesh)
            rep = lambda x: jax.device_put(x, NamedSharding(mesh, P()))
            p = jax.tree.map(rep, params)
            key = f"{name}_{mesh_name}"
            prefill = jax.jit(lambda p, t: tm.prefill_logits(p, cfg, mi, t))
            out[f"{key}_prefill"] = np.asarray(prefill(p, rep(toks[:2])))
            step = jax.jit(lambda p, c, t: tm.decode_step(p, cfg, mi, c, t))
            for b in (4, 1):
                cache = jax.tree.map(rep, tm.init_cache(cfg, b, steps))
                for t in range(steps):
                    logits, cache = step(p, cache, rep(toks[:b, t]))
                    out[f"{key}_b{b}_step{t}"] = np.asarray(logits)
                for k, v in cache.items():
                    out[f"{key}_b{b}_cache_{k}"] = np.asarray(v)
    np.savez(out_path, **out)
    print("MESH_DECODE_REFERENCE_OK")
    """
)


@functools.lru_cache(maxsize=1)
def reference(tmp_dir: str):
    path = pathlib.Path(tmp_dir) / "mesh_decode_reference.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(path), str(STEPS)],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "MESH_DECODE_REFERENCE_OK" in proc.stdout
    return dict(np.load(path))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference(str(tmp_path_factory.mktemp("mesh_decode")))


def fresh_model(name: str):
    cfg = get_arch(name).cfg
    params = ref_tm.init_params(jax.random.PRNGKey(0), ref_get_arch(name).cfg)
    model = lm_params_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return model.requires_grad_(False)


@functools.lru_cache(maxsize=2)
def port_model(name: str):
    return fresh_model(name)


def mesh_info(mesh_name: str) -> MeshInfo:
    data, model = MESHES[mesh_name]
    return MeshInfo(mesh=make_test_mesh(data * model, model=model, device="cpu"))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_mesh_prefill_and_decode_equal_reference(ref, name, mesh_name):
    """Prefill, eight decode steps at batch 4 and at batch 1, and the final
    caches, against the reference on the same mesh (tolerance: 1e-5 of
    the largest element)."""
    model, mi = port_model(name), mesh_info(mesh_name)
    key = f"{name}_{mesh_name}"
    toks = torch.from_numpy(ref["tokens"])
    close(prefill_logits(model, toks[:2], mi).numpy(), ref[f"{key}_prefill"])
    data = MESHES[mesh_name][0]
    for b in (4, 1):
        cache = init_cache(model.cfg, b, STEPS, mi=mi)
        grid = next(v for k, v in cache.items() if k != "pos")
        assert (len(grid), len(grid[0])) == ((data if b % data == 0 else 1), mi.tp_size)
        blocks = [blk for row in grid for blk in row]
        ptrs = [blk.data_ptr() for blk in blocks]
        for t in range(STEPS):
            logits, cache = decode_step(model, cache, toks[:b, t], mi)
            close(logits.numpy(), ref[f"{key}_b{b}_step{t}"])
        assert [blk.data_ptr() for row in grid for blk in row] == ptrs
        for k, v in gather_cache(cache).items():
            close(v.numpy(), ref[f"{key}_b{b}_cache_{k}"])


def test_per_group_capacity_changes_the_result(ref):
    """At batch 4 on (2, 2) each data group of two tokens competes for its
    own capacity (max(1, int(1.25 * 2 * 2 / 8)) = 1 a group, not one over
    all four tokens): the reference's decode parts from its (1, 4) decode
    (whose data axis does not split), and the port's from its one-device
    decode, by the same logits."""
    model, mi = port_model("smoke-mla-moe"), mesh_info("2x2")
    toks = torch.from_numpy(ref["tokens"])
    one = init_cache(model.cfg, 4, STEPS, device="cpu")
    mesh = init_cache(model.cfg, 4, STEPS, mi=mi)
    for t in range(STEPS):
        want = ref[f"smoke-mla-moe_2x2_b4_step{t}"]
        assert np.abs(want - ref[f"smoke-mla-moe_1x4_b4_step{t}"]).max() > 1e-2
        got_one, one = decode_step(model, one, toks[:, t])
        got_mesh, mesh = decode_step(model, mesh, toks[:, t], mi)
        assert np.abs(got_mesh.numpy() - got_one.numpy()).max() > 1e-2
        close(got_mesh.numpy(), want)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_resident_decode_equals_reference_on_the_mesh(ref, name, mesh_name):
    """Eight decode steps of the model made resident on the mesh, at batch 4
    and at batch 1, and the final caches, against the reference on the
    same mesh (tolerance: 1e-5 of the largest element); the cache's blocks
    are written in place."""
    mi = mesh_info(mesh_name)
    model = make_resident(fresh_model(name), mi)
    key = f"{name}_{mesh_name}"
    toks = torch.from_numpy(ref["tokens"])
    for b in (4, 1):
        cache = init_cache(model.cfg, b, STEPS, mi=mi)
        grid = next(v for k, v in cache.items() if k != "pos")
        ptrs = [blk.data_ptr() for row in grid for blk in row]
        with torch.inference_mode():
            for t in range(STEPS):
                logits, cache = decode_step(model, cache, toks[:b, t], mi)
                close(logits.numpy(), ref[f"{key}_b{b}_step{t}"])
        assert [blk.data_ptr() for row in grid for blk in row] == ptrs
        for k, v in gather_cache(cache).items():
            close(v.numpy(), ref[f"{key}_b{b}_cache_{k}"])


def test_moe_decode_cell_on_a_data_mesh_equals_reference(ref):
    """The decode cell of ``LMArch.make_cell`` over a (4, 1) mesh keeps
    smoke-mla-moe whole (``archs/lm.py::resident_mesh``: the whole path
    gives all tokens one capacity there, as the reference does); its eight
    steps at batch 4 and at batch 1, and the final caches, equal the
    reference's on that mesh (tolerance: 1e-5 of the largest element)."""
    model = fresh_model("smoke-mla-moe")
    mi = MeshInfo(mesh=make_test_mesh(4, model=1, device="cpu"))
    cell = LMArch(model.cfg, "adamw", SMOKE_LM_SHAPES).make_cell("decode_32k", mi)
    toks = torch.from_numpy(ref["tokens"])
    for b in (4, 1):
        cache = init_cache(model.cfg, b, STEPS, mi=mi)
        for t in range(STEPS):
            logits, cache = cell.fn(model, cache, toks[:b, t])
            close(logits.numpy(), ref[f"smoke-mla-moe_4x1_b{b}_step{t}"])
        for k, v in cache.items():  # one-device tensors: a model axis of 1
            close(v.numpy(), ref[f"smoke-mla-moe_4x1_b{b}_cache_{k}"])
    assert whole_leaves(model)
