"""Training over a mesh, recsys and MACE, port against reference.

The recsys train cells over a (2, 2) mesh: ``make_cell("train_batch", mi)``
carries the reference's layout of every parameter (``specs``: tables rows
over ``model`` and columns over ``data`` where that divides the width;
each leaf's block shape equal to the reference's ``NamedSharding``
shard shape), and its step reads each table's blocks of that layout on
their positions (``models/recsys/models.py::mesh_lookup``).

Ground truth is the reference's jitted step, run in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` on meshes of
``AxisType.Auto`` axes (``tests/test_torch_lm_sharded.py`` says why), with
its parameters, optimizer state and batch laid out by the cell's own
``in_specs`` (a case may name the arch's optimizer and config fields to
replace). Both sides start from the reference's PRNGKey(0) parameters
(carried across by ``interop``) and take two steps on the batches of
steps 0 and 1 (the port's generators, which equal the reference's bit for
bit). The limits are ``train/parity.py``'s float32 ones, each against its
control: the metrics of both steps within 1e-4 relative; after the first
step every element within 2 lr + 1e-6 and at most 1% of a leaf's
elements past 1e-3 lr + 1e-6 (lr 1e-3). The reference's two-tower train
step runs on its 4-device mesh (only its scorer's branch that is not
two-phase fails there, ``tests/test_distributed_multidev.py``), so every
recsys cell is held to the reference's (2, 2) step.

MACE's ogb_products shape (smoke size, 128 x 512, d_feat 8) in the
dst-partitioned layout over a (1, 4) and a (2, 2) mesh: four graph
shards, each on its position reading the parameters' replica there (the
step makes the whole model's parameters replicas at its first step, as
the cell's does). Self-loop
edges are padded out of the batch in both packages
(``tests/test_torch_mace.py`` says why). The cell computes in bf16, which
XLA and PyTorch round at different points (the first step's metrics
part by 4.7e-2 relative, past even ``parity``'s bf16 limit of 2e-3,
whatever the layout), so the step runs in float32 on both sides
(``compute_dtype`` replaced) and is held to the float32 limits.
"""
import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.archs import recsys as ref_recsys
from repro.archs.base import get_arch as ref_get_arch
from repro.distributed.meshinfo import MeshInfo as RefMeshInfo
from repro.models.gnn import mace as ref_gm
from repro_torch.archs import get_arch
from repro_torch.distributed import MeshInfo
from repro_torch.distributed.layout import shard_shape
from repro_torch.interop import _by_port_name, _unstacked, mace_params_from_reference
from repro_torch.interop import recsys_params_from_reference
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.gnn.distributed import (
    dst_partitioned_loss,
    make_replicas,
    shard_devices,
)
from repro_torch.train import adamw, make_train_step, reference_layout
from repro_torch.train.parity import failures, readings, snapshot
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
RECSYS = ("smoke-dlrm", "smoke-deepfm", "smoke-two-tower", "smoke-sasrec")
LR = 1e-3

SCRIPT = textwrap.dedent(
    """
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro.archs import recsys as rs_arch
    from repro.archs.base import get_arch
    from repro.distributed.meshinfo import MeshInfo
    from repro.models.gnn import mace as gm
    from repro.models.gnn.distributed import dst_partitioned_loss
    from repro.models.transformer import model as tm
    from repro.train.optimizer import adamw
    from repro.train.train_step import make_train_step

    assert len(jax.devices()) == 4
    cases_path, in_path, out_path = sys.argv[1:4]
    cases, inputs, out = json.load(open(cases_path)), np.load(in_path), {}
    is_spec = lambda x: isinstance(x, P)

    def flat(tree, prefix):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
            out[prefix + key] = np.asarray(leaf.astype(jnp.float32))

    for c in cases:
        name = c["case"]
        mesh = jax.make_mesh(tuple(c["mesh"]), ("data", "model"),
                             axis_types=(AxisType.Auto, AxisType.Auto))
        mi = MeshInfo(mesh=mesh)
        arch = get_arch(c["arch"])
        key = jax.random.PRNGKey(0)
        batches = [{k.split("|")[2]: inputs[k] for k in inputs.files
                    if k.startswith(f"{name}|{s}|")} for s in (0, 1)]
        if arch.family == "gnn":
            cfg = dataclasses.replace(arch._cfg_for(arch.shapes[c["shape"]]),
                                      compute_dtype=getattr(jnp, c["dtype"]))
            params = gm.init_params(key, cfg)
            opt = adamw(lr=1e-3)
            fn = make_train_step(lambda p, b: dst_partitioned_loss(p, cfg, mi, b), opt,
                                 clip_norm=1.0)
            pspecs = gm.param_specs(cfg, mi)
            edge = P(mi.dp_axes + (mi.tp_axis,))
            specs = (pspecs, opt.state_specs(pspecs, params),
                     {k: edge if k in ("senders", "receivers_local") else P()
                      for k in batches[0]})
        else:
            if c.get("router_aux_coef"):
                arch.cfg = dataclasses.replace(arch.cfg, router_aux_coef=c["router_aux_coef"])
            if c.get("cfg"):
                arch.cfg = dataclasses.replace(arch.cfg, **c["cfg"])
            if c.get("optimizer"):
                arch.optimizer_name = c["optimizer"]
            cell = arch.make_cell(c["shape"], mi)
            init = (tm.init_params if arch.family == "lm"
                    else rs_arch._INIT[arch.cfg.model])
            params = init(key, arch.cfg)
            fn, specs = cell.fn, cell.in_specs
        if arch.family == "gnn":
            opt_state = opt.init(params)
        else:
            opt_state = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), cell.args[1])
        shard = jax.tree.map(lambda s: NamedSharding(mesh, s), specs, is_leaf=is_spec)
        step = jax.jit(fn, in_shardings=shard)
        p1, o1, m1 = step(*jax.device_put((params, opt_state, batches[0]), shard))
        _, _, m2 = step(*jax.device_put((p1, o1, batches[1]), shard))
        flat(p1, f"{name}|p1|")
        for i, m in ((1, m1), (2, m2)):
            for k, v in m.items():
                out[f"{name}|m{i}|{k}"] = np.asarray(v)
    np.savez(out_path, **out)
    print("MESH_TRAIN_REFERENCE_OK")
    """
)


def run_reference(tmp: pathlib.Path, cases: list, batches: dict) -> dict:
    """The reference's two steps of each case (``SCRIPT``) on 4 virtual host
    devices; ``batches`` {"<case>|<step>|<key>": numpy array}."""
    (tmp / "cases.json").write_text(json.dumps(cases))
    np.savez(tmp / "inputs.npz", **batches)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp / "cases.json"),
                           str(tmp / "inputs.npz"), str(tmp / "out.npz")],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-4000:]
    assert "MESH_TRAIN_REFERENCE_OK" in proc.stdout
    return dict(np.load(tmp / "out.npz"))


def numpy_batch(batch: dict) -> dict:
    return {k: v.numpy() for k, v in batch.items() if isinstance(v, torch.Tensor)}


def reference_leaves(ref: dict, prefix: str, model) -> dict:
    """The reference's leaves under ``prefix`` ("<case>|p1|") keyed by the
    port's names (stacked blocks split where the port holds a module list)."""
    tree: dict = {}
    for k, v in ref.items():
        if not k.startswith(prefix):
            continue
        node = tree
        parts = [int(p) if p.isdigit() else p for p in k[len(prefix):].split("/")]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in _by_port_name(_unstacked(tree, model), prefix).items()}


def metrics_of(ref: dict, case: str, i: int) -> dict:
    pre = f"{case}|m{i}|"
    return {k[len(pre):]: float(v) for k, v in ref.items() if k.startswith(pre)}


def mesh(shape) -> MeshInfo:
    return MeshInfo(make_test_mesh(shape[0] * shape[1], model=shape[1], device="cpu"))


def abstract_meshinfo(shape) -> RefMeshInfo:
    return RefMeshInfo(mesh=AbstractMesh(tuple(shape), ("data", "model"),
                                         axis_types=(AxisType.Auto, AxisType.Auto)))


def ref_shard_shapes(params, pspecs, shape, model) -> dict:
    """The reference's ``NamedSharding(mesh, spec).shard_shape`` of every
    leaf, keyed by the port's names; a stacked block list's shapes without
    the layer axis where the port holds one module a block."""
    amesh = abstract_meshinfo(shape).mesh
    shapes = jax.tree.map(lambda p, s: np.empty(NamedSharding(amesh, s).shard_shape(p.shape),
                                                np.int8),
                          params, pspecs, is_leaf=lambda x: isinstance(x, P))
    return {k: tuple(v.shape) for k, v in _by_port_name(_unstacked(shapes, model), "").items()}


def port_cell_run(cell, model, batches) -> tuple:
    """Two steps of ``cell`` from ``model`` and a zero state -> (start, leaves
    after step 1, (metrics 1, metrics 2))."""
    _, state, _ = cell.make_inputs(0, "cpu")
    start = snapshot(model)
    model, state, m1 = cell.fn(model, state, batches[0])
    p1 = snapshot(model)
    _, _, m2 = cell.fn(model, state, batches[1])
    return start, p1, (m1, m2)


def recsys_batches(name: str) -> list:
    arch = get_arch(name)
    from repro_torch.archs.recsys import shape_batch

    return [shape_batch(arch.cfg, "train_batch", 0, s, shapes=arch.shapes, device="cpu")
            for s in (0, 1)]


@functools.lru_cache(maxsize=1)
def recsys_reference(tmp: str) -> dict:
    cases = [dict(case=n, arch=n, shape="train_batch", mesh=[2, 2]) for n in RECSYS]
    batches = {f"{n}|{s}|{k}": v for n in RECSYS
               for s, b in enumerate(recsys_batches(n)) for k, v in numpy_batch(b).items()}
    return run_reference(pathlib.Path(tmp), cases, batches)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return recsys_reference(str(tmp_path_factory.mktemp("mesh_train_recsys")))


def ref_params(name: str):
    cfg = ref_get_arch(name).cfg
    return jax.tree.map(np.asarray, ref_recsys._INIT[cfg.model](jax.random.PRNGKey(0), cfg))


@pytest.mark.parametrize("name", RECSYS)
def test_recsys_train_cell_is_laid_out_over_the_mesh(name):
    """The (2, 2) cell's specs are the reference's, leaf for leaf, and each
    leaf's blocks have the reference's shard shapes; a one-device cell has
    no layout."""
    arch, ref_arch = get_arch(name), ref_get_arch(name)
    cell = arch.make_cell("train_batch", mesh((2, 2)))
    assert arch.make_cell("train_batch").specs is None
    model = recsys_params_from_reference(ref_params(name), arch.cfg, device="cpu")
    views = reference_layout(model)
    assert set(cell.specs) == set(views)
    ref_cell = ref_arch.make_cell("train_batch", abstract_meshinfo((2, 2)))
    want = ref_shard_shapes(ref_cell.args[0], ref_cell.in_specs[0], (2, 2), model)
    got = {k: shard_shape(v.shape, cell.specs[k], mesh((2, 2))) for k, v in views.items()}
    assert got == want
    tables = [k for k in views if k.startswith(("tables.", "user_emb", "item_emb", "items"))]
    assert tables and all(cell.specs[k][0] == "model" for k in tables)


@pytest.mark.parametrize("name", RECSYS)
def test_recsys_mesh_step_equals_reference(ref, name):
    """Two steps over (2, 2) against the reference's (2, 2) steps, by
    ``parity``'s float32 limits (module docstring)."""
    arch = get_arch(name)
    model = recsys_params_from_reference(ref_params(name), arch.cfg, device="cpu")
    start, p1, got = port_cell_run(arch.make_cell("train_batch", mesh((2, 2))), model,
                                   recsys_batches(name))
    want_p = reference_leaves(ref, f"{name}|p1|", model)
    r = readings(start, want_p, p1, (metrics_of(ref, name, 1), metrics_of(ref, name, 2)), got,
                 LR)
    assert not failures(r, LR, "float32"), r


def mace_case(shape):
    """smoke-mace's ogb_products cfg in float32, a port mesh of ``shape``,
    the port model from the reference's PRNGKey(0) parameters and the
    batches of steps 0 and 1 with self-loop edges padded out."""
    arch = get_arch("smoke-mace")
    cfg = dataclasses.replace(arch.cfg_for("ogb_products"), compute_dtype=torch.float32)
    ref_arch = ref_get_arch("smoke-mace")
    ref_cfg = ref_arch._cfg_for(ref_arch.shapes["ogb_products"])
    params = jax.tree.map(np.asarray, ref_gm.init_params(jax.random.PRNGKey(0), ref_cfg))
    model = mace_params_from_reference(params, cfg, device="cpu")
    mi = mesh(shape)
    batches = []
    for s in (0, 1):
        b = arch.batch("ogb_products", 0, s, "cpu", mi)
        n_local = b["positions"].shape[0] // 4
        lo = torch.arange(4).repeat_interleave(b["senders"].shape[0] // 4) * n_local
        loop = b["senders"] == b["receivers_local"] + lo
        b["senders"] = torch.where(loop, -1, b["senders"])
        b["receivers_local"] = torch.where(loop, -1, b["receivers_local"])
        batches.append(b)
    return cfg, mi, model, batches


MACE_MESHES = {"1x4": (1, 4), "2x2": (2, 2)}


@functools.lru_cache(maxsize=1)
def mace_reference(tmp: str) -> dict:
    cases, batches = [], {}
    for name, shape in MACE_MESHES.items():
        case = f"mace-{name}"
        cases.append(dict(case=case, arch="smoke-mace", shape="ogb_products", mesh=list(shape),
                          dtype="float32"))
        for s, b in enumerate(mace_case(shape)[3]):
            batches.update({f"{case}|{s}|{k}": v for k, v in numpy_batch(b).items()})
    return run_reference(pathlib.Path(tmp), cases, batches)


@pytest.mark.parametrize("mesh_name", sorted(MACE_MESHES))
def test_mace_dst_partitioned_mesh_step_equals_reference(tmp_path_factory, mesh_name):
    """ogb_products' layout over four positions, each shard on its own: two
    steps against the reference's steps on the same mesh by ``parity``'s
    float32 limits, MACE's specs (every leaf whole) as the reference's."""
    ref = mace_reference(str(tmp_path_factory.mktemp("mesh_train_mace")))
    cfg, mi, model, batches = mace_case(MACE_MESHES[mesh_name])
    assert len(shard_devices(mi)) == 4
    cell = get_arch("smoke-mace").make_cell("ogb_products", mi)
    assert cell.specs and all(all(e is None for e in s) for s in cell.specs.values())
    assert set(cell.specs) == set(reference_layout(model))
    step = make_train_step(lambda m, b: dst_partitioned_loss(m, cfg, mi, b), adamw(lr=LR),
                           clip_norm=1.0)
    fn = lambda m, state, b: step(make_replicas(m, cfg, mi), state, b)  # noqa: E731
    start, p1, got = port_cell_run(dataclasses.replace(cell, fn=fn), model, batches)
    case = f"mace-{mesh_name}"
    want_p = reference_leaves(ref, f"{case}|p1|", model)
    r = readings(start, want_p, p1, (metrics_of(ref, case, 1), metrics_of(ref, case, 2)), got,
                 LR)
    assert not failures(r, LR, "float32"), r
