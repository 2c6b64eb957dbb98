"""LM training over a mesh, port against reference: train_4k of smoke-gqa and
smoke-mla-moe (MTP, router_aux_coef 0.01) over (1, 4) and (2, 2) meshes
of CPU positions.

``LMArch.make_cell("train_4k", mi)`` runs ``lm_loss`` with the MoE's
expert-parallel branch forward and backward, each data group computing
its own capacity as the reference's ``shard_map`` does, and carries the
reference's parameter layout (``specs``, ``model.param_specs``): every
leaf's block shape on the mesh equals the reference's ``NamedSharding``
shard shape (an ``AbstractMesh``, no devices needed).

Ground truth is the reference's jitted step on 4 virtual host devices
(``tests/test_torch_train_mesh_recsys.py``'s subprocess) from PRNGKey(0)
parameters, two AdamW steps (lr 3e-4) on ``lm_batch``'s batches of
steps 0 and 1, held by ``train/parity.py``'s float32 limits: the metrics
of both steps within 1e-4 relative, after the first step every element
within 2 lr + 1e-6 and at most 1% of a leaf's elements past 1e-3 lr +
1e-6, each limit against its control. On (2, 2) smoke-mla-moe's step
equals the reference's (2, 2) step and parts from the one-device step.
"""
import dataclasses
import functools
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.archs.base import get_arch as ref_get_arch
from repro.models.transformer import model as ref_tm
from repro_torch.archs import get_arch
from repro_torch.archs.lm import LMArch
from repro_torch.configs.lm_configs import SMOKE_LM_SHAPES
from repro_torch.data import lm_batch
from repro_torch.distributed.layout import shard_shape
from repro_torch.interop import lm_params_from_reference
from repro_torch.train import reference_layout
from repro_torch.train.parity import failures, readings
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse)
from test_torch_train_mesh_recsys import (
    abstract_meshinfo,
    mesh,
    metrics_of,
    numpy_batch,
    port_cell_run,
    ref_shard_shapes,
    reference_leaves,
    run_reference,
)

NAMES = ("smoke-gqa", "smoke-mla-moe")
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
AUX = {"smoke-gqa": 0.0, "smoke-mla-moe": 0.01}
LR = 3e-4


def port_arch(name: str) -> LMArch:
    arch = get_arch(name)
    return LMArch(dataclasses.replace(arch.cfg, router_aux_coef=AUX[name]), "adamw",
                  SMOKE_LM_SHAPES)


def batches(name: str) -> list:
    cfg = port_arch(name).cfg
    return [lm_batch(0, s, 4, 32, cfg.vocab_size, device="cpu") for s in (0, 1)]


@functools.lru_cache(maxsize=2)
def ref_params(name: str):
    return jax.tree.map(np.asarray, ref_tm.init_params(jax.random.PRNGKey(0),
                                                       ref_get_arch(name).cfg))


def port_model(name: str):
    return lm_params_from_reference(ref_params(name), port_arch(name).cfg, device="cpu")


@functools.lru_cache(maxsize=1)
def lm_reference(tmp: str) -> dict:
    cases, inputs = [], {}
    for name in NAMES:
        for mesh_name, shape in MESHES.items():
            case = f"{name}-{mesh_name}"
            cases.append(dict(case=case, arch=name, shape="train_4k", mesh=list(shape),
                              router_aux_coef=AUX[name]))
            for s, b in enumerate(batches(name)):
                inputs.update({f"{case}|{s}|{k}": v for k, v in numpy_batch(b).items()})
    return run_reference(pathlib.Path(tmp), cases, inputs)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return lm_reference(str(tmp_path_factory.mktemp("mesh_train_lm")))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_lm_train_cell_is_laid_out_over_the_mesh(name, mesh_name):
    """The cell's specs name every parameter, and each leaf's blocks have
    the reference's shard shapes (stacked layer lists included)."""
    shape = MESHES[mesh_name]
    cell = port_arch(name).make_cell("train_4k", mesh(shape))
    model = port_model(name)
    views = reference_layout(model)
    assert set(cell.specs) == set(views)
    ref_arch = ref_get_arch(name)
    ref_cell = ref_arch.make_cell("train_4k", abstract_meshinfo(shape))
    want = ref_shard_shapes(ref_cell.args[0], ref_cell.in_specs[0], shape, model)
    got = {k: shard_shape(v.shape, cell.specs[k], mesh(shape)) for k, v in views.items()}
    assert got == want


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_lm_mesh_step_equals_reference(ref, name, mesh_name):
    """Two train_4k steps over the mesh against the reference's steps on the
    same mesh, by ``parity``'s float32 limits."""
    cell = port_arch(name).make_cell("train_4k", mesh(MESHES[mesh_name]))
    start, p1, got = port_cell_run(cell, port_model(name), batches(name))
    case = f"{name}-{mesh_name}"
    want_p = reference_leaves(ref, f"{case}|p1|", port_model(name))
    r = readings(start, want_p, p1, (metrics_of(ref, case, 1), metrics_of(ref, case, 2)), got,
                 LR)
    assert not failures(r, LR, "float32"), r
    assert {"ce", "loss"} <= set(got[0]) and ("router_aux" in got[0]) == (AUX[name] > 0)


def test_per_group_capacity_changes_the_mesh_step(ref):
    """On (2, 2) each data group of two sequences computes its own MoE
    capacity: the reference's (2, 2) loss parts from its (1, 4) loss (whose
    data axis is 1), and the port's (2, 2) step from its one-device step,
    while each equals the reference on its own mesh (above)."""
    name = "smoke-mla-moe"
    want_22, want_14 = (metrics_of(ref, f"{name}-{m}", 1)["loss"] for m in ("2x2", "1x4"))
    assert abs(want_22 - want_14) > 1e-4 * abs(want_14)
    one = port_arch(name).make_cell("train_4k")
    _, _, got_one = port_cell_run(one, port_model(name), batches(name))
    two = port_arch(name).make_cell("train_4k", mesh((2, 2)))
    _, _, got_two = port_cell_run(two, port_model(name), batches(name))
    loss_one, loss_two = float(got_one[0]["loss"]), float(got_two[0]["loss"])
    assert abs(loss_two - loss_one) > 1e-4 * abs(loss_one)
    assert abs(loss_two - want_22) <= 1e-4 * abs(want_22)
    assert torch.isfinite(got_two[1]["loss"])
