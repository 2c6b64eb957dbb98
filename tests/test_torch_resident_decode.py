"""The decode step of an LM whose parameters are resident as their (fs, tp)
blocks over a mesh (``models/transformer/model.py::_decode_tp``): the
vocabulary-parallel embedding, tensor-parallel projections, each model
position scoring its own sequence shard of the cache (``attention.py``:
``gqa_decode_tp``, ``mla_decode_tp``), the shards' partials combined by the
log-sum-exp rule, ``wo`` and the feed-forwards row-parallel, the head's
vocabulary blocks gathered.

Against the reference on the same mesh: ``tests/test_torch_lm_sharded.py``.
Here, against the port's whole-parameter decode on the same mesh (which
that file holds to the reference): smoke-gqa and smoke-mla-moe on (1, 4)
and (2, 2), and with 6 heads, which 4 model positions do not divide; one
step's collective tally against its derivation; the LM serve cells over a
mesh holding the model resident; a mesh of distinct CPU devices (one part
a position, as four cards).

Tolerance: 1e-5 of the largest element, float32 (the row-parallel sums and
the shards' combine add in another order), as the module above.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.archs import get_arch
from repro_torch.archs.lm import LMArch
from repro_torch.configs.lm_configs import SMOKE_LM_SHAPES
from repro_torch.distributed import DeviceMesh, MeshInfo
from repro_torch.distributed.layout import whole_leaves
from repro_torch.models.transformer import model as tm
from repro_torch.roofline import collectives
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse)
from test_torch_train_mesh_recsys import mesh

STEPS = 8


def model_of(cfg, mi=None):
    """smoke weights drawn from seed 0; resident over ``mi`` where given."""
    model = tm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    return tm.make_resident(model.requires_grad_(False), mi)


def close(got, want):
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def decode(model, cfg, mi, toks):
    """``STEPS`` decode steps from a zero cache laid out over ``mi`` ->
    (each step's logits, the final cache gathered whole); the cache's
    blocks never move."""
    cache = tm.init_cache(cfg, toks.shape[0], STEPS, device="cpu", mi=mi)
    blocks = [b for row in next(v for k, v in cache.items() if k != "pos") for b in row]
    ptrs = [b.data_ptr() for b in blocks]
    out = []
    with torch.inference_mode():
        for t in range(STEPS):
            logits, cache = tm.decode_step(model, cache, toks[:, t], mi)
            out.append(logits)
    assert [b.data_ptr() for b in blocks] == ptrs and int(cache["pos"]) == STEPS
    return out, tm.gather_cache(cache)


def tokens(b: int, vocab: int):
    return torch.from_numpy(np.random.default_rng(0).integers(0, vocab, size=(b, STEPS))
                            .astype(np.int32))


@pytest.mark.parametrize("name,shape,heads", [
    ("smoke-gqa", (1, 4), 4), ("smoke-gqa", (2, 2), 4), ("smoke-gqa", (1, 4), 6),
    ("smoke-mla-moe", (1, 4), 4), ("smoke-mla-moe", (2, 2), 4), ("smoke-mla-moe", (1, 4), 6)])
def test_resident_decode_equals_the_whole_parameter_decode(name, shape, heads):
    """Eight steps at batch 4 and 1 from the same weights, resident and
    whole, on the same mesh: logits and final caches. With 6 heads over 4
    model positions GQA's gathered heads need no split, and MLA's blocks of
    ``wkv_b`` straddle heads (padded to whole heads, summed)."""
    cfg = dataclasses.replace(get_arch(name).cfg, n_heads=heads)
    mi = mesh(shape)
    resident, whole = model_of(cfg, mi), model_of(cfg)
    assert not whole_leaves(resident)
    for b in (4, 1):
        toks = tokens(b, cfg.vocab_size)
        got, got_cache = decode(resident, cfg, mi, toks)
        want, want_cache = decode(whole, cfg, mi, toks)
        for g, w in zip(got, want):
            assert bool(torch.isfinite(g).all())
            close(g, w)
        for k in want_cache:
            if k != "pos":
                close(got_cache[k], want_cache[k])


# smoke-gqa: 2 dense layers, H 4, Hkv 2, D 64, d_ff 128, B 4
GQA_TALLY = {
    (1, 4): ({"all-gather": 3, "all-reduce": 11}, {}),
    (2, 2): ({"all-gather": 34, "all-reduce": 11}, {"all-gather": 30}),
}


@pytest.mark.parametrize("shape", sorted(GQA_TALLY))
def test_one_decode_step_tally_has_the_derived_counts(shape):
    """One smoke-gqa decode step's collectives (each once, for data group 0,
    as the reference's groups run at once):

    (1, 4), one data group. The embedding's reads summed over the 4 model
    positions (1 all-reduce); per layer the new token's q / k / v blocks
    gathered over the positions (1 all-gather), the shards' max, sum and
    output combined (3 all-reduces), ``wo``'s and ``w2``'s row-parallel
    partials summed (2 all-reduces); the head's vocabulary blocks gathered
    (1 all-gather). 2 + 1 = 3 all-gathers, 1 + 2 x 5 = 11 all-reduces. The
    data axis has one position: no weight moves.

    (2, 2), two data groups of 2 sequences. As above, and: the
    embedding's column blocks read on the 2 data positions and joined (1
    all-gather); per layer the 7 products' (wq, wk, wv, wo, w1, w3, w2)
    model shards gathered over the data positions (7 x 2 weight
    all-gathers) and ``lm_head``'s (2): 30 weight all-gathers, each of half
    a leaf (a model shard: no leaf is gathered whole), so their bytes are
    those of the 15 leaves once. 30 + 1 + 3 = 34 all-gathers, 11
    all-reduces.

    smoke-mla-moe on (1, 4) (1 dense + 1 MoE layer): per layer ``wq_a``'s
    and ``wkv_a``'s outputs and [q_nope W_uk ; q_rope] gathered (3
    all-gathers), the combine (3 all-reduces) and ``wo`` (1); the dense
    FFN's row sum (1), the MoE's gate sums, outputs and shared experts' row
    sum (3): 2 x 3 + 1 = 7 all-gathers, 1 + 2 x 4 + 1 + 3 = 13
    all-reduces, no weight moves."""
    cfg = get_arch("smoke-gqa").cfg
    mi = mesh(shape)
    model = model_of(cfg, mi)
    cache = tm.init_cache(cfg, 4, STEPS, device="cpu", mi=mi)
    with torch.inference_mode(), collectives.tally() as t:
        tm.decode_step(model, cache, tokens(4, cfg.vocab_size)[:, 0], mi)
    counts, weights = GQA_TALLY[shape]
    assert t.result()["per_op_counts"] == counts
    assert dict(t.weight_counts) == weights
    if weights:
        whole = model_of(cfg)
        products = [p for k, p in whole.named_parameters() if p.dim() == 2 and "embed" not in k]
        assert dict(t.weight_bytes) == {"all-gather": sum(p.numel() * 4 for p in products)}
    mla = get_arch("smoke-mla-moe").cfg
    mi = mesh((1, 4))
    model = model_of(mla, mi)
    cache = tm.init_cache(mla, 4, STEPS, device="cpu", mi=mi)
    with torch.inference_mode(), collectives.tally() as t:
        tm.decode_step(model, cache, tokens(4, mla.vocab_size)[:, 0], mi)
    assert t.result()["per_op_counts"] == {"all-gather": 7, "all-reduce": 13}
    assert dict(t.weight_counts) == {}


def test_serve_cells_over_a_mesh_hold_the_model_resident():
    """``LMArch.make_cell`` over a (1, 4) mesh: the decode and prefill cells'
    ``make_inputs`` give a resident model, their ``fn`` turns a whole model
    resident at its first call (in place) and serves it equal to the whole
    model on the mesh; over a mesh that does not divide a leaf (``wkv_a``'s
    24 columns over 16 model positions) the model stays whole."""
    arch = LMArch(get_arch("smoke-mla-moe").cfg, "adamw", SMOKE_LM_SHAPES)
    mi = mesh((1, 4))
    cell = arch.make_cell("decode_32k", mi)
    model, cache, tok = cell.make_inputs(0, "cpu")
    assert not whole_leaves(model) and len(cache["c"][0]) == 4
    got, _ = cell.fn(model, cache, tok)
    one, _, _ = arch.make_cell("decode_32k").make_inputs(0, "cpu")  # the same draws, whole
    assert whole_leaves(one)
    with torch.inference_mode():
        want, _ = tm.decode_step(one, cell.make_inputs(0, "cpu")[1], tok, mi)
    close(got, want)
    turned, _ = cell.fn(one, cell.make_inputs(0, "cpu")[1], tok)
    assert not whole_leaves(one)
    close(turned, want)
    prefill = arch.make_cell("prefill_32k", mi)
    model, toks = prefill.make_inputs(0, "cpu")
    assert not whole_leaves(model)
    one, _ = arch.make_cell("prefill_32k").make_inputs(0, "cpu")
    close(prefill.fn(model, toks), arch.make_cell("prefill_32k").fn(one, toks))
    wide = mesh((1, 16))
    model, _, _ = arch.make_cell("decode_32k", wide).make_inputs(0, "cpu")
    assert whole_leaves(model)


def test_resident_decode_over_distinct_devices():
    """On meshes whose positions name distinct CPU devices ("cpu:0" ..
    "cpu:3": one part a position, each cache block on its position's
    device, as on four cards) smoke-mla-moe's resident decode equals the
    whole-parameter decode on the mesh that repeats one device."""
    cfg = get_arch("smoke-mla-moe").cfg
    for shape in ((1, 4), (2, 2)):
        devs = [f"cpu:{i}" for i in range(4)]
        mi = MeshInfo(DeviceMesh.create(devs, shape, ("data", "model")))
        toks = tokens(4, cfg.vocab_size)
        got, got_cache = decode(model_of(cfg, mi), cfg, mi, toks)
        want, want_cache = decode(model_of(cfg), cfg, mesh(shape), toks)
        for g, w in zip(got, want):
            close(g, w)
        close(got_cache["c"], want_cache["c"])
