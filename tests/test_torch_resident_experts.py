"""The LM's routed experts resident as their blocks over a mesh, and
Adafactor on blocks.

``LMArch.make_cell("train_4k", mi)`` over a mesh of more than one position
whose model axis divides E holds every MoE layer's ``w1`` / ``w3`` /
``w2`` as the reference's blocks (``moe_specs`` with the stacked leading
None: (None, tp, fs, None) and (None, tp, None, fs)), one part a
position, from ``make_inputs`` on (``models/transformer/model.py::
make_resident``); no whole expert tensor is left. The step reads the
parts in place; on (2, 2) each data group gathers its model shard's
blocks over the data positions (all-gather) and the backward sums the
groups' gradients back onto the blocks (reduce-scatter), both in the
collective tally. Adafactor's ``vr`` / ``vc`` live as blocks by its own
``state_specs``, and its reductions across blocks add the blocks'
partial sums in part order (``train/optimizer.py``).

Ground truth for the step is the reference's jitted train_4k step of
smoke-mla-moe with Adafactor (lr 1e-3, momentum 0.9, router_aux_coef
0.01) on 4 virtual host devices (``test_torch_train_mesh_recsys.py``'s
subprocess), held by ``train/parity.py``'s float32 limits, each against
its control. Adafactor on one leaf split 1, 2 and 4 ways (and held as
two replicas of two blocks) is held to the whole leaf's update: split 1
way bit for bit, else within 1e-6 of the update's largest element (the
whole leaf takes ``mean``, the blocks a sum of partial sums).
"""
import dataclasses
import functools
import pathlib

import pytest
import torch
from jax.sharding import NamedSharding

from repro.archs.base import get_arch as ref_get_arch
from repro_torch.archs import get_arch
from repro_torch.archs.lm import LMArch
from repro_torch.ckpt import checkpoint as ck
from repro_torch.configs.lm_configs import SMOKE_LM_SHAPES
from repro_torch.data import lm_batch
from repro_torch.distributed import DeviceMesh, MeshInfo
from repro_torch.distributed.layout import Blocks
from repro_torch.interop import lm_params_from_reference
from repro_torch.models.transformer import model as tm
from repro_torch.roofline import collectives
from repro_torch.train import adafactor, apply_updates, param_leaves, reference_layout
from repro_torch.train.parity import failures, readings, snapshot
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse)
from test_torch_train_mesh_lm import ref_params
from test_torch_train_mesh_recsys import (
    abstract_meshinfo,
    mesh,
    metrics_of,
    numpy_batch,
    port_cell_run,
    reference_leaves,
    run_reference,
)

NAME = "smoke-mla-moe"
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
LR = 1e-3
EXPERTS = [f"moe_layers.ffn.experts.{w}" for w in ("w1", "w3", "w2")]


def arch(**fields) -> LMArch:
    cfg = dataclasses.replace(get_arch(NAME).cfg, router_aux_coef=0.01, **fields)
    return LMArch(cfg, "adafactor", SMOKE_LM_SHAPES)


def batches(n: int = 2) -> list:
    return [lm_batch(0, s, 4, 32, arch().cfg.vocab_size, device="cpu") for s in range(n)]


def ptrs(tree: dict) -> dict:
    return {k: [p.data_ptr() for p in v.parts] for k, v in tree.items() if isinstance(v, Blocks)}


@functools.lru_cache(maxsize=1)
def adafactor_reference(tmp: str) -> dict:
    cases, inputs = [], {}
    for mesh_name, shape in MESHES.items():
        case = f"adafactor-{mesh_name}"
        cases.append(dict(case=case, arch=NAME, shape="train_4k", mesh=list(shape),
                          router_aux_coef=0.01, optimizer="adafactor"))
        for s, b in enumerate(batches()):
            inputs.update({f"{case}|{s}|{k}": v for k, v in numpy_batch(b).items()})
    return run_reference(pathlib.Path(tmp), cases, inputs)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return adafactor_reference(str(tmp_path_factory.mktemp("resident_experts")))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_expert_parts_have_the_reference_shard_shapes(mesh_name):
    """Each expert leaf is four parts, one a position, of the reference's
    ``NamedSharding`` shard shape, its Adafactor statistics blocks of their
    own specs, and the model holds no whole expert tensor."""
    shape = MESHES[mesh_name]
    mi = mesh(shape)
    model, state, _ = arch().make_cell("train_4k", mi).make_inputs(0, "cpu")
    cfg = model.cfg
    leaves = param_leaves(model)
    ref_cell = ref_get_arch(NAME).make_cell("train_4k", abstract_meshinfo(shape))
    amesh = abstract_meshinfo(shape).mesh
    ref_specs = ref_cell.in_specs[0]["moe_layers"]["ffn"]["experts"]
    ref_args = ref_cell.args[0]["moe_layers"]["ffn"]["experts"]
    for name in EXPERTS:
        w = name.rpartition(".")[2]
        b = leaves[name]
        assert isinstance(b, Blocks) and tuple(b.shape) == tuple(ref_args[w].shape), name
        want = NamedSharding(amesh, ref_specs[w]).shard_shape(ref_args[w].shape)
        assert len(b.parts) == 4 and all(tuple(p.shape) == want for p in b.positions()), name
        spec = tuple(b.layout.spec)
        assert state["vr"][name].layout.spec == spec[:-1], name
        assert state["vc"][name].layout.spec == spec[:-2] + spec[-1:], name
        assert state["m"][name].layout == b.layout, name
    whole = {(cfg.n_experts, cfg.d_model, cfg.d_ff_expert),
             (cfg.n_experts, cfg.d_ff_expert, cfg.d_model)}
    held = list(model.parameters()) + [t for layers in (model.dense_layers, model.moe_layers)
                                       for t in layers.stacked.values()]
    assert not [tuple(t.shape) for t in held if tuple(t.shape[-3:]) in whole]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_parts_and_adafactor_state_keep_their_storage(mesh_name):
    """Across two steps every expert part and each of its ``vr`` / ``vc`` /
    momentum parts keeps its storage, and the parts were updated."""
    cell = arch().make_cell("train_4k", mesh(MESHES[mesh_name]))
    model, state, _ = cell.make_inputs(0, "cpu")
    leaves = param_leaves(model)
    before = [ptrs(leaves)] + [ptrs(state[s]) for s in ("vr", "vc", "m")]
    start = {k: leaves[k].whole() for k in EXPERTS}
    for b in batches():
        model, state, _ = cell.fn(model, state, b)
    after = param_leaves(model)
    assert [ptrs(after)] + [ptrs(state[s]) for s in ("vr", "vc", "m")] == before
    for k in EXPERTS:
        assert not torch.equal(after[k].whole(), start[k]), k


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_mesh_adafactor_step_equals_reference(ref, mesh_name):
    """Two Adafactor steps over the mesh, from the reference's parameters
    (whole, made resident at the first step), against the reference's
    jitted steps on the same mesh, by ``parity``'s float32 limits."""
    a = arch()
    model = lm_params_from_reference(ref_params(NAME), a.cfg, device="cpu")
    cell = a.make_cell("train_4k", mesh(MESHES[mesh_name]))
    start, p1, got = port_cell_run(cell, model, batches())
    assert all(isinstance(param_leaves(model)[k], Blocks) for k in EXPERTS)
    case = f"adafactor-{mesh_name}"
    want_p = reference_leaves(ref, f"{case}|p1|",
                              lm_params_from_reference(ref_params(NAME), a.cfg, device="cpu"))
    r = readings(start, want_p, p1, (metrics_of(ref, case, 1), metrics_of(ref, case, 2)), got,
                 LR)
    assert not failures(r, LR, "float32"), r


def distinct_cpu_mesh(grid) -> MeshInfo:
    """A mesh whose positions name distinct CPU devices ("cpu:i"), so that a
    block held whole over an axis has one replica a position."""
    n = grid[0] * grid[1]
    return MeshInfo(DeviceMesh.create([f"cpu:{i}" for i in range(n)], grid, ("data", "model")))


SPLITS = [((1, 1), (None, None, None, None)), ((1, 2), (None, None, None, "model")),
          ((2, 1), (None, None, "data", None)), ((2, 2), (None, None, "data", "model")),
          ((1, 4), (None, "model", None, None)), ((2, 2), (None, "model", None, None))]


def test_adafactor_on_a_split_leaf_equals_the_whole_leaf():
    """Two Adafactor steps (momentum 0.9 in float32) of one (2, 8, 16, 12)
    leaf held as its blocks, split 1, 2 and 4 ways (over the last, the
    second-to-last, both, or the leading dimensions; the last case two
    replicas of two blocks), against the whole leaf's: split 1 way bit for
    bit; else the updates and the statistics within 1e-6 of their largest
    element, and each block's replicas equal."""
    gen = torch.Generator().manual_seed(0)
    shape = (2, 8, 16, 12)
    p0 = torch.randn(shape, generator=gen)
    grads = [torch.randn(shape, generator=gen) * s for s in (1.0, 0.3)]
    opt = adafactor(lr=LR, momentum=0.9, momentum_dtype=torch.float32)
    p = {"w": p0.clone()}
    state = opt.init(p)
    want = []
    for g in grads:
        u, state = opt.update({"w": g.clone()}, state, p)
        apply_updates(p, u)
        want.append((u["w"], {n: state[n]["w"].clone() for n in ("vr", "vc", "m")}))
    meta = {"w": torch.empty(shape, device="meta")}
    shapes = opt.init(meta)
    for grid, spec in SPLITS:
        mi = distinct_cpu_mesh(grid)
        pb = Blocks.place(p0, spec, mi)
        specs = opt.state_specs({"w": spec}, meta)
        sb = {n: {"w": Blocks.zeros(sub["w"].shape, specs[n]["w"], mi, sub["w"].dtype)}
              for n, sub in shapes.items() if isinstance(sub, dict)}
        sb["count"] = torch.zeros((), dtype=torch.int32)
        for g, (u_want, s_want) in zip(grads, want):
            u, sb = opt.update({"w": Blocks.place(g, spec, mi)}, sb, {"w": pb})
            apply_updates({"w": pb}, u)
            got = [(u["w"].whole(), u_want)] + [(sb[n]["w"].whole(), s_want[n]) for n in s_want]
            for x, y in got:
                if grid == (1, 1):
                    assert torch.equal(x, y), (grid, spec)
                else:
                    assert float((x - y).abs().max()) <= 1e-6 * float(y.abs().max()), (grid, spec)
            for group in u["w"].layout.replicas():
                assert all(torch.equal(u["w"].parts[i], u["w"].parts[group[0]]) for i in group)


def test_a_2x2_checkpoint_restores_on_one_device_and_continues(tmp_path):
    """After one (2, 2) step the checkpoint holds the reference's whole
    leaves (parameters and Adafactor's state); restored on one device they
    equal the blocks bit for bit, and the next two steps there equal the
    uninterrupted mesh run's by ``parity``'s float32 limits (capacity at
    every token, so that the per-group capacity drops nothing)."""
    a = arch(capacity_factor=float(get_arch(NAME).cfg.n_experts))
    cell, one = a.make_cell("train_4k", mesh((2, 2))), a.make_cell("train_4k")
    bs = batches(3)
    model, state, _ = cell.make_inputs(0, "cpu")
    model, state, _ = cell.fn(model, state, bs[0])
    ck.save(str(tmp_path), 1, {"params": param_leaves(model), "opt": state})
    start = snapshot(model)
    saved = {(n, k): state[n][k].whole() for k in EXPERTS for n in ("vr", "vc", "m")}
    model, state, want1 = cell.fn(model, state, bs[1])
    want_p = snapshot(model)
    _, _, want2 = cell.fn(model, state, bs[2])
    one_model, one_state, _ = one.make_inputs(1, "cpu")
    back = ck.restore(str(tmp_path), 1, {"params": reference_layout(one_model), "opt": one_state})
    with torch.no_grad():
        for k, v in reference_layout(one_model).items():
            v.copy_(back["params"][k])
    assert all(torch.equal(v, start[k]) for k, v in snapshot(one_model).items())
    for (n, k), v in saved.items():
        assert torch.equal(back["opt"][n][k], v), (n, k)
    one_model, one_state, got1 = one.fn(one_model, back["opt"], bs[1])
    got_p = snapshot(one_model)
    _, _, got2 = one.fn(one_model, one_state, bs[2])
    r = readings(start, want_p, got_p, (want1, want2), (got1, got2), LR)
    assert not failures(r, LR, "float32"), r


def test_tally_counts_the_experts_gather_where_the_data_axes_split_them():
    """One step's weight moves (``Tally.weight_counts``): on (2, 2) the
    model shard of every leaf that the data axes split (the experts among
    them, and every dense leaf but the norms, the router and the embedding,
    whose rows each data position reads from its own block) is gathered
    from the two data positions (all-gather, one a leaf, layer and shard)
    and its gradient summed back (reduce-scatter, one block: a leaf's bytes
    over the two data positions in all; the activations' gathers add
    reduce-scatters of their own in the backward); on (1, 4) no weight
    moves."""
    cfg = arch().cfg
    counts, weights = {}, {}
    wbytes = None
    for mesh_name, (dp, tp) in MESHES.items():
        cell = arch().make_cell("train_4k", mesh((dp, tp)))
        model, state, _ = cell.make_inputs(0, "cpu")
        with collectives.tally() as t:
            cell.fn(model, state, batches(1)[0])
        counts[mesh_name], weights[mesh_name] = t.result(), dict(t.weight_counts)
        wbytes = dict(t.weight_bytes)
    assert not weights["1x4"]
    specs = tm.param_specs(cfg, mesh((2, 2)))
    leaves = {k: v for k, v in param_leaves(tm.Transformer(cfg, device="meta")).items()
              if "data" in specs[k] and k != "embed.table"}  # the table's rows are read in place
    assert {k for k in EXPERTS} <= set(leaves)
    layers = {k: v.shape[0] if k.split(".")[0] in ("dense_layers", "moe_layers") else 1
              for k, v in leaves.items()}
    n = 2 * sum(layers.values())  # model shards x (leaf, layer)
    got = counts["2x2"]
    assert weights["2x2"] == {"all-gather": n, "reduce-scatter": n}
    # each gather's backward reduce-scatters, but for the cross-entropy's 4
    # joins of per-token terms (2 chunks, the loss's and MTP's)
    assert got["per_op_counts"]["reduce-scatter"] == got["per_op_counts"]["all-gather"] - 4
    assert wbytes["reduce-scatter"] == sum(v.numel() * 4 for v in leaves.values()) // 2


def test_whole_experts_over_the_mesh_raise():
    """A mesh step's loss that finds the experts whole where its layout
    holds them as blocks raises; made resident, it runs."""
    a = arch()
    mi = mesh((1, 4))
    model = lm_params_from_reference(ref_params(NAME), a.cfg, device="cpu")
    with pytest.raises(ValueError, match="resident"):
        tm.lm_loss(model, batches(1)[0], mi)
    loss, _ = tm.lm_loss(tm.make_resident(model, mi), batches(1)[0], mi)
    assert torch.isfinite(loss)
