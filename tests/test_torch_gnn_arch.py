"""The GNN cells of the port (``archs/gnn.py``) on the CPU: every smoke-mace
cell takes an AdamW step through ``make_cell``, stays finite and moves
every parameter leaf; ``gnn_batch`` equals the reference's arrays; the
registry, the configs and ``GNN_SHAPES`` equal the reference's; and one
step of the molecule cell (float32, per-graph energies) against the
reference's jitted cell from the same weights and batch, self-loop edges
padded out in both (tests/test_torch_mace.py says why): the metrics within
1e-5 relative, each new parameter within 2 lr + 1e-6 of the reference's
and within 1e-6 + 1e-3 lr wherever the reference's gradient exceeds 1e-3
of its leaf's largest, as tests/test_torch_lm_train.py holds AdamW.

``train.parity``, which holds the card to the CPU, is held to its
controls here with the CPU on both sides: it passes a sound copy, and it
fails a copy whose first step left one leaf's update out or flipped its
sign.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.archs import gnn as ref_gnn
from repro.archs.base import get_arch as ref_get_arch
from repro.data import pipeline as ref_pipe
from repro.distributed.meshinfo import single_device_meshinfo
from repro.models.gnn import mace as ref_gm
from repro.models.gnn.sampler import subgraph_sizes as ref_subgraph_sizes
from repro_torch.archs import get_arch
from repro_torch.archs.gnn import GNN_SHAPES, graph_size
from repro_torch.configs import NOT_PORTED
from repro_torch.data import gnn_batch
from repro_torch.interop import mace_params_from_reference
from repro_torch.train import reference_layout
from repro_torch.train.parity import failures, step_readings
from test_torch_lm import close
from test_torch_lm_train import by_port_name
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse fixture)

MI = single_device_meshinfo()
LR = 1e-3


@pytest.mark.parametrize("shape", list(GNN_SHAPES))
def test_smoke_mace_cells_run_finite_and_move_every_leaf(shape):
    cell = get_arch("smoke-mace").make_cell(shape)
    model, state, batch = cell.make_inputs(0, "cpu")
    before = {k: v.detach().clone() for k, v in reference_layout(model).items()}
    model, state, metrics = cell.fn(model, state, batch)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert {"loss", "e_loss", "f_loss", "grad_norm"} == set(metrics)
    after = reference_layout(model)
    assert all(not torch.equal(after[k], v) for k, v in before.items())
    if shape == "ogb_products":
        assert "receivers_local" in batch and get_arch("smoke-mace").cfg_for(
            shape).compute_dtype == torch.bfloat16


def test_gnn_batch_equals_reference():
    for args in ((0, 0, 64, 256, 32, 16, 1), (3, 2, 24, 48, 32, 0, 4), (1, 5, 10, 7, 5, 0, 1)):
        want = ref_pipe.gnn_batch(*args)
        got = gnn_batch(*args, device="cpu")
        assert set(got) == set(want)
        for k, v in want.items():
            if k == "n_graphs":
                assert got[k] == v
                continue
            g = got[k].numpy()
            assert g.dtype == np.asarray(v).dtype and np.array_equal(g, np.asarray(v)), k


def test_registry_configs_and_shapes_match_reference():
    assert "mace" not in NOT_PORTED and "smoke-mace" not in NOT_PORTED
    assert GNN_SHAPES == ref_gnn.GNN_SHAPES
    for name in ("mace", "smoke-mace"):
        arch, ref_arch = get_arch(name), ref_get_arch(name)
        assert arch.shapes == ref_arch.shapes and arch.shape_names() == ref_arch.shape_names()
        for shape, sh in arch.shapes.items():
            want = ref_arch._cfg_for(sh)
            got = arch.cfg_for(shape)
            for f in dataclasses.fields(want):
                w, g = getattr(want, f.name), getattr(got, f.name)
                if f.name.endswith("dtype"):
                    w, g = np.dtype(w).name, str(g).split(".")[1]
                assert w == g, (name, shape, f.name)
            if shape == "minibatch_lg":
                assert graph_size(sh) == ref_subgraph_sizes(sh["batch_nodes"], sh["fanouts"])


def test_molecule_step_matches_reference():
    arch, ref_arch = get_arch("smoke-mace"), ref_get_arch("smoke-mace")
    sh = arch.shapes["molecule"]
    ref_cfg = ref_arch._cfg_for(sh)
    ref_cell = ref_arch.make_cell("molecule", MI)
    params = ref_gm.init_params(jax.random.PRNGKey(0), ref_cfg)
    n, e = graph_size(sh)
    ref_b = ref_pipe.gnn_batch(0, 0, n, e, ref_cfg.n_species, ref_cfg.d_feat, sh["batch"])
    s = np.asarray(ref_b["senders"])
    s = np.where(s == np.asarray(ref_b["receivers"]), -1, s).astype(np.int32)
    ref_b = {k: v for k, v in ref_b.items() if k != "n_graphs"} | {"senders": jnp.asarray(s)}
    ref_grads = by_port_name(jax.jit(jax.grad(lambda p, b: ref_gm.loss(
        p, ref_cfg, dict(b, n_graphs=sh["batch"]))[0]))(params, ref_b))
    new_params, _, ref_metrics = jax.jit(ref_cell.fn)(params, ref_gnn.adamw(lr=LR).init(params),
                                                      ref_b)
    cell = arch.make_cell("molecule")
    _, state, batch = cell.make_inputs(0, "cpu")
    batch = dict(batch, senders=torch.from_numpy(s))
    model = mace_params_from_reference(jax.tree.map(np.asarray, params), arch.cfg_for("molecule"),
                                       device="cpu")
    state = {"m": {k: torch.zeros_like(v) for k, v in state["m"].items()},
             "v": {k: torch.zeros_like(v) for k, v in state["v"].items()},
             "count": state["count"]}
    model, state, metrics = cell.fn(model, state, batch)
    for k in ref_metrics:
        close(metrics[k].numpy(), ref_metrics[k])
    want = by_port_name(new_params)
    for k, view in reference_layout(model).items():
        got, w = view.detach().numpy(), want[k]
        np.testing.assert_allclose(got, w, rtol=0, atol=2 * LR + 1e-6, err_msg=k)
        g = np.abs(ref_grads[k])
        big = g > 1e-3 * g.max()
        np.testing.assert_allclose(got[big], w[big], rtol=0, atol=1e-6 + 1e-3 * LR, err_msg=k)


class BrokenCopy:
    """``cell`` whose second step (the copy's first in ``step_readings``)
    drops or sign-flips ``leaf``'s update."""

    def __init__(self, cell, leaf, how):
        self.cell, self.leaf, self.how, self.calls = cell, leaf, how, 0
        self.make_inputs = cell.make_inputs

    def fn(self, model, state, batch):
        start = reference_layout(model)[self.leaf].detach().clone()
        out = self.cell.fn(model, state, batch)
        self.calls += 1
        if self.calls == 2:
            with torch.no_grad():
                p = reference_layout(model)[self.leaf]
                p.copy_(start if self.how == "drop" else 2 * start - p)
        return out


@pytest.mark.parametrize("how", [None, "drop", "flip"])
def test_parity_check_passes_a_sound_copy_and_fails_a_broken_update(how):
    cell = get_arch("smoke-mace").make_cell("full_graph_sm")
    leaf = "readout.layers.1.bias"  # one element: far below any share of all elements
    r = step_readings(cell if how is None else BrokenCopy(cell, leaf, how), "cpu", 0, LR)
    got = failures(r, LR, "float32")
    if how is None:
        assert got == [] and r["rel"] == 0.0 and r["far"] == 0
    else:
        assert r["leaf_far_name"] == leaf and r["leaf_far"] == 1.0
        assert any(leaf in msg for msg in got) and any("metrics differ" in msg for msg in got)
