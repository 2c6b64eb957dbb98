"""The LM's dense layers resident as their (fs, tp) blocks over a mesh, with
tensor-parallel attention and feed-forwards and a vocabulary-parallel
embedding and head.

``LMArch.make_cell("train_4k", mi)`` over a mesh of more than one position
holds every leaf of the train cell as the reference's blocks
(``models/transformer/model.py::make_resident``): the split leaves one part
a position, the ``P(None)`` leaves (norm scales, the router) one replica a
device. The step runs each data group on its row of devices and each
model position on its own heads, feed-forward columns and vocabulary
block (``distributed/tensor_parallel.py``).

The reference's shard shapes come from ``NamedSharding`` on an
``AbstractMesh`` (``tests/test_torch_train_mesh_recsys.py``); the steps
against the reference's jitted step are in
``tests/test_torch_train_mesh_lm.py``. Here: the layout, the parts and
their optimizer state in place, one step's collective tally against its
derivation, the vocabulary-parallel cross-entropy and the resident
prefill against the one-device ones, the refusal of whole leaves, a
fully resident (2, 2) checkpoint restored on one device, and the
replicated scales' gradient sums.
"""
import copy
import dataclasses

import pytest
import torch

from repro.archs.base import get_arch as ref_get_arch
from repro_torch.archs import get_arch
from repro_torch.archs.lm import LMArch
from repro_torch.ckpt import checkpoint as ck
from repro_torch.configs.lm_configs import SMOKE_LM_SHAPES
from repro_torch.data import lm_batch
from repro_torch.distributed import DeviceMesh, MeshInfo
from repro_torch.distributed import tensor_parallel as tpar
from repro_torch.distributed.layout import Blocks, Resident, whole_leaves
from repro_torch.interop import lm_params_from_reference
from repro_torch.models.transformer import model as tm
from repro_torch.roofline import collectives
from repro_torch.train import gradients, param_leaves, reference_layout
from repro_torch.train.parity import failures, readings, snapshot
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse)
from test_torch_train_mesh_lm import ref_params
from test_torch_train_mesh_recsys import abstract_meshinfo, mesh, ref_shard_shapes

NAMES = ("smoke-gqa", "smoke-mla-moe")
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}


def arch(name: str, optimizer: str = "adamw", **fields) -> LMArch:
    aux = 0.01 if name == "smoke-mla-moe" else 0.0
    cfg = dataclasses.replace(get_arch(name).cfg, router_aux_coef=aux, **fields)
    return LMArch(cfg, optimizer, SMOKE_LM_SHAPES)


def batches(name: str, n: int = 2) -> list:
    return [lm_batch(0, s, 4, 32, arch(name).cfg.vocab_size, device="cpu") for s in range(n)]


def whole_model(name: str, **fields):
    return lm_params_from_reference(ref_params(name), arch(name, **fields).cfg, device="cpu")


def ptrs(tree: dict) -> dict:
    return {k: [p.data_ptr() for p in v.parts] for k, v in tree.items() if isinstance(v, Blocks)}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_every_leaf_is_resident_as_the_reference_lays_it_out(name, mesh_name):
    """Every leaf of the train cell is ``Blocks``: each position's part has
    the reference's ``NamedSharding`` shard shape, lies on that position's
    device and holds that position's block of the whole leaf; the model
    holds no whole leaf."""
    shape = MESHES[mesh_name]
    mi = mesh(shape)
    model = tm.make_resident(whole_model(name), mi)
    assert whole_leaves(model) == []
    leaves = param_leaves(model)
    assert set(leaves) == set(reference_layout(whole_model(name)))
    ref_cell = ref_get_arch(name).make_cell("train_4k", abstract_meshinfo(shape))
    want = ref_shard_shapes(ref_cell.args[0], ref_cell.in_specs[0], shape, model)
    whole = reference_layout(whole_model(name))
    for k, b in leaves.items():
        assert isinstance(b, Blocks), k
        placed = Blocks.place(whole[k], b.layout.spec, mi).positions()
        for pos, (part, dev) in enumerate(zip(b.positions(), mi.mesh.devices)):
            assert tuple(part.shape) == want[k] and part.device == dev, (k, pos)
            assert torch.equal(part, placed[pos]), (k, pos)


@pytest.mark.parametrize("name,optimizer,mesh_name", [("smoke-gqa", "adamw", "1x4"),
                                                      ("smoke-mla-moe", "adafactor", "2x2")])
def test_parts_and_optimizer_state_keep_their_storage(name, optimizer, mesh_name):
    """Across two steps every part and every part of its optimizer state
    keeps its storage, and every leaf moved. The optimizer's ``state_specs``
    reads the leaves as ``Blocks`` too (the dry run's argument bytes) and
    gives the layouts of the state's blocks."""
    cell = arch(name, optimizer).make_cell("train_4k", mesh(MESHES[mesh_name]))
    model, state, _ = cell.make_inputs(0, "cpu")
    leaves = param_leaves(model)
    assert all(isinstance(v, Blocks) for v in leaves.values())
    stats = [k for k, v in state.items() if isinstance(v, dict)]
    assert all(set(state[s]) == set(leaves) for s in stats)
    specs = arch(name, optimizer).optimizer().state_specs(
        {k: v.layout.spec for k, v in leaves.items()}, leaves)
    assert all(state[s][k].layout.spec == tuple(specs[s][k]) for s in stats for k in leaves)
    before = [ptrs(leaves)] + [ptrs(state[s]) for s in stats]
    start = {k: v.whole() for k, v in leaves.items()}
    for b in batches(name):
        model, state, _ = cell.fn(model, state, b)
    after = param_leaves(model)
    assert [ptrs(after)] + [ptrs(state[s]) for s in stats] == before
    assert not [k for k, v in after.items() if torch.equal(v.whole(), start[k])]


# smoke-gqa: 2 dense layers, H 4, Hkv 2, D 64, B 4, S 32, ce_chunk 16 (2 chunks)
TALLY = {
    "1x4": {"all-gather": 4, "all-reduce": 16, "reduce-scatter": 4},
    "2x2": {"all-gather": 33, "all-reduce": 16, "reduce-scatter": 31},
}
WEIGHT_MOVES = {"1x4": {}, "2x2": {"all-gather": 30, "reduce-scatter": 30}}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_one_step_tally_has_the_derived_counts(mesh_name):
    """One smoke-gqa step's collectives, forward and backward (AdamW,
    clipping; each count once a data group, as the reference's groups run
    at once):

    (1, 4), one data group. Forward: the embedding's reads summed over the
    4 model positions (1 all-reduce); per layer k and v gathered over the
    model positions, as 4 positions do not divide 2 kv heads (2
    all-gathers), and ``wo``'s and ``w2``'s row-parallel partials summed (2
    all-reduces); the cross-entropy's max, sum and label logit per chunk
    (3 all-reduces x 2 chunks). Backward: each placed sum's gradient
    summed over the model positions (the embedding's and 2 a layer: 5
    all-reduces), each activation gather's gradient summed back onto its
    blocks (4 reduce-scatters). 2 x 2 = 4 all-gathers, 1 + 2 x 2 + 6 + 5 =
    16 all-reduces, 4 reduce-scatters. The data axis has one position: no
    weight moves.

    (2, 2), two data groups of 2 sequences. Forward: the embedding's
    column blocks read on the 2 data positions and joined (1 all-gather)
    and summed over the model positions (1 all-reduce); per layer the 7
    products' (wq, wk, wv, wo, w1, w3, w2) model shards gathered over the
    data positions (7 x 2 all-gathers) and ``lm_head``'s (2), 2 x 14 + 2 =
    30 weight all-gathers; 2 kv heads over 2 positions need no gather; 2
    row sums a layer; 6 for the cross-entropy, whose per-token terms are
    joined over the two groups (1 all-gather a chunk). Backward: the 30
    weight gathers' reduce-scatters and the embedding join's (31), the 5
    placed sums' all-reduces. 1 + 30 + 2 = 33 all-gathers, 1 + 4 + 6 + 5 =
    16 all-reduces, 31 reduce-scatters.

    A mesh that repeats one device (here) and one of distinct devices
    count alike: the moves are the design's, not the devices'."""
    cell = arch("smoke-gqa").make_cell("train_4k", mesh(MESHES[mesh_name]))
    model, state, _ = cell.make_inputs(0, "cpu")
    with collectives.tally() as t:
        cell.fn(model, state, batches("smoke-gqa", 1)[0])
    assert t.result()["per_op_counts"] == TALLY[mesh_name]
    assert dict(t.weight_counts) == WEIGHT_MOVES[mesh_name]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_vocab_parallel_ce_equals_the_one_device_ce(mesh_name):
    """``_chunked_ce_tp`` over the vocabulary blocks of a resident
    ``lm_head`` against ``_chunked_ce`` of the whole head on the same
    float32 hidden states, labels and weights: the loss and its gradients
    (hidden states and head) within 2e-6 of the loss and of each
    gradient's largest element (the blocks combine max and sums in another
    order, and the hidden states' gradient adds the 4 blocks' products in
    another order: a few float32 roundings of the largest element)."""
    mi = mesh(MESHES[mesh_name])
    cfg = arch("smoke-gqa").cfg
    gen = torch.Generator().manual_seed(3)
    h = torch.randn(4, 32, cfg.d_model, generator=gen, requires_grad=True)
    labels = torch.randint(0, cfg.vocab_size, (4, 32), generator=gen)
    weights = (torch.rand(4, 32, generator=gen) > 0.2).float()
    whole = whole_model("smoke-gqa")
    want = tm._chunked_ce(cfg, h, whole.lm_head, labels, weights)
    want_g = torch.autograd.grad(want, [h, whole.lm_head.weight])
    model = tm.make_resident(whole_model("smoke-gqa"), mi)
    grid = tpar.Grid(mi, tpar.n_groups(mi, 4))
    got = tm._chunked_ce_tp(cfg, grid, grid.split(h), grid.products(model.lm_head), labels,
                            weights)
    got_h, = torch.autograd.grad(got, [h], retain_graph=True)
    got_w = gradients(model, got)["lm_head.weight"].whole().T
    assert abs(float(got.detach()) - float(want.detach())) <= 2e-6 * abs(float(want.detach()))
    for x, y in ((got_h, want_g[0]), (got_w, want_g[1])):
        assert float((x - y).abs().max()) <= 2e-6 * float(y.abs().max())


@pytest.mark.parametrize("name", NAMES)
def test_resident_prefill_equals_the_one_device_logits(name):
    """``prefill_logits`` of a resident model over (1, 4), under
    ``inference_mode``, against the whole model's on one device: float32,
    within 1e-5 (the row-parallel sums add the heads' and columns'
    partials in another order)."""
    mi = mesh((1, 4))
    toks = lm_batch(0, 0, 2, 32, arch(name).cfg.vocab_size, device="cpu")["tokens"]
    model = tm.make_resident(whole_model(name), mi)
    with torch.inference_mode():
        got = tm.prefill_logits(model, toks, mi)
        want = tm.prefill_logits(whole_model(name), toks)
    assert got.shape == want.shape == (2, arch(name).cfg.vocab_padded)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_whole_dense_leaves_over_the_mesh_raise():
    """``lm_loss`` over a mesh refuses a model with any whole leaf (all
    whole, or all resident but one); a resident model refuses another mesh
    and no mesh. Its decode step over the mesh gives finite logits equal
    to the whole model's on the same mesh (within 1e-5 of the largest),
    and refuses a cache laid out for one device or for another mesh."""
    mi = mesh((1, 4))
    b = batches("smoke-mla-moe", 1)[0]
    with pytest.raises(ValueError, match="resident"):
        tm.lm_loss(whole_model("smoke-mla-moe"), b, mi)
    model = tm.make_resident(whole_model("smoke-mla-moe"), mi)
    one = copy.deepcopy(model)
    one.lm_head.weight = torch.nn.Parameter(torch.zeros(one.lm_head.weight.shape))
    with pytest.raises(ValueError, match="lm_head.weight"):
        tm.lm_loss(one, b, mi)
    for other in (None, mesh((2, 2))):
        with pytest.raises(ValueError, match="mesh"):
            tm.lm_loss(model, b, other)
    cache = tm.init_cache(model.cfg, 4, 64, device="cpu", mi=mi)
    with torch.inference_mode():
        got, _ = tm.decode_step(model, cache, b["tokens"][:, 0], mi)
        want, _ = tm.decode_step(whole_model("smoke-mla-moe"),
                                 tm.init_cache(model.cfg, 4, 64, device="cpu", mi=mi),
                                 b["tokens"][:, 0], mi)
    assert bool(torch.isfinite(got).all()) and got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    for other in (tm.init_cache(model.cfg, 4, 64, device="cpu"),
                  tm.init_cache(model.cfg, 4, 64, device="cpu", mi=mesh((2, 2)))):
        with pytest.raises(ValueError, match="layout"):
            tm.decode_step(model, other, b["tokens"][:, 0], mi)
    loss, _ = tm.lm_loss(model, b, mi)
    assert torch.isfinite(loss)


def test_a_fully_resident_2x2_checkpoint_restores_on_one_device_and_continues(tmp_path):
    """After one (2, 2) smoke-gqa step the checkpoint holds every leaf and
    its AdamW moments whole; restored on one device they equal the blocks
    bit for bit, and the next two steps there equal the mesh run's by
    ``parity``'s float32 limits."""
    a = arch("smoke-gqa")
    lr = 3e-4
    cell, one = a.make_cell("train_4k", mesh((2, 2))), a.make_cell("train_4k")
    bs = batches("smoke-gqa", 3)
    model, state, _ = cell.make_inputs(0, "cpu")
    model, state, _ = cell.fn(model, state, bs[0])
    ck.save(str(tmp_path), 1, {"params": param_leaves(model), "opt": state})
    start = snapshot(model)
    saved = {(n, k): v.whole() for n in ("m", "v") for k, v in state[n].items()}
    model, state, want1 = cell.fn(model, state, bs[1])
    want_p = snapshot(model)
    _, _, want2 = cell.fn(model, state, bs[2])
    one_model, one_state, _ = one.make_inputs(1, "cpu")
    back = ck.restore(str(tmp_path), 1, {"params": reference_layout(one_model), "opt": one_state})
    with torch.no_grad():
        for k, v in reference_layout(one_model).items():
            v.copy_(back["params"][k])
    assert all(torch.equal(v, start[k]) for k, v in snapshot(one_model).items())
    assert all(torch.equal(back["opt"][n][k], v) for (n, k), v in saved.items())
    one_model, one_state, got1 = one.fn(one_model, back["opt"], bs[1])
    got_p = snapshot(one_model)
    _, _, got2 = one.fn(one_model, one_state, bs[2])
    r = readings(start, want_p, got_p, (want1, want2), (got1, got2), lr)
    assert not failures(r, lr, "float32"), r


def test_replicated_scales_sum_their_replicas_densely():
    """On a (1, 4) mesh of distinct CPU devices (one replica a position, as
    on four cards) each norm scale and the router is four replicas; the
    step's gradient of each is the sum of the replicas' gradients, equal
    on every replica and within 1e-5 of the whole model's (of its largest
    element: a scale's gradient adds every token's term, in another order
    over the positions), taken by the dense sum (no read reports touched
    rows)."""
    mi = MeshInfo(DeviceMesh.create([f"cpu:{i}" for i in range(4)], (1, 4), ("data", "model")))
    b = batches("smoke-mla-moe", 1)[0]
    whole = whole_model("smoke-mla-moe")
    want = gradients(whole, tm.lm_loss(whole, b)[0])
    model = tm.make_resident(whole_model("smoke-mla-moe"), mi)
    replicated = [k for k, v in param_leaves(model).items() if not any(v.layout.spec)]
    assert {"final_norm.scale", "moe_layers.ffn.router.weight", "mtp.norm.scale"} <= set(replicated)
    loss = tm.lm_loss(model, b, mi)[0]
    assert all(r._rows is None for r in model.modules() if isinstance(r, Resident))
    got = gradients(model, loss)
    for k in replicated:
        g = got[k]
        assert len(g.parts) == 4 and all(torch.equal(p, g.parts[0]) for p in g.parts), k
        y = want[k]
        assert float((g.parts[0] - y).abs().max()) <= 1e-5 * float(y.abs().max()), k
