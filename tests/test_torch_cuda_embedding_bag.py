"""The embedding_bag CUDA kernel and its backward's kernels against their
plain versions, and the two-tower serving path through the bag, on the
card.

Marked ``cuda``; each test skips where there is no CUDA device. This file
imports no JAX, so it also runs where only the port is installed:

    python -m pytest -m cuda tests/test_torch_cuda_embedding_bag.py

Every path adds a bag's valid rows left to right from +0.0, one rounded add
at a time (kernels/embedding_bag.py), so the kernel equals its plain
version bit for bit on float tables as well as integer ones, in both
modes, on the float4 path (D % 4 == 0) and the scalar path; row offsets
past 2**31 elements are read at 64 bits.

The backward: a stable sort of the keys, the row-bounds kernel (each row's
run of the sorted order as CSR offsets, equal to ``torch.searchsorted``)
and the main kernel, which writes every row of the (V, D) gradient once
(an empty row as zeros, into ``torch.empty``), adding a row's
contributions in row-major (b, l) order from +0.0 as the plain version
does, so the two agree bit for bit: on rows no id hits, rows every
position hits, all-padding batches, V = 1, ids >= V (clamped), D = 3, 4,
256 and 300 (past a warp's span) and rows written past 2**31 elements.
"""
import pytest
import torch

from repro_torch.archs.recsys import serve_fn, shape_batch
from repro_torch.configs import SMOKE_RECSYS_SHAPES, smoke_two_tower
from repro_torch.kernels.embedding_bag import (
    backward_launches,
    dense_rows_cuda,
    embedding_bag,
    embedding_bag_backward,
    embedding_bag_backward_cuda,
    embedding_bag_backward_plain,
    embedding_bag_cuda,
    embedding_bag_plain,
    row_bounds_cuda,
    sorted_keys,
)
from repro_torch.models.recsys import two_tower_init

# (V, D, B, L): serve-like, the scalar path (D = 10, 50, 1, 13), L = 1,
# L > 32 (two ballots), B = 1, B not a multiple of the block's 8 bags, D
# wider than one warp's span (2 spans of 256 floats, 3 of 128).
SHAPES = ((5000, 256, 512, 50), (3000, 10, 77, 26), (3000, 50, 33, 50), (100, 1, 9, 7),
          (2000, 16, 64, 1), (700, 256, 1, 50), (900, 13, 5, 33), (400, 300, 19, 40),
          (400, 384, 3, 64))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run only on the card")
    return torch.device("cuda")


def make(dev, v, d, b, length, integer, seed=0):
    """Table and ids with 30% padding; bag 0 all padding, bag 1 (if any)
    holding row 0 and row V - 1."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if integer:
        table = torch.randint(-8, 9, (v, d), generator=gen, device=dev).float()
    else:
        table = torch.randn((v, d), generator=gen, device=dev)
    ids = torch.randint(0, v, (b, length), generator=gen, dtype=torch.int32, device=dev)
    ids[torch.rand((b, length), generator=gen, device=dev) < 0.3] = -1
    ids[0] = -1
    if b > 1:
        ids[1, 0], ids[1, -1] = 0, v - 1
    return table, ids


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
def test_embedding_bag_kernel_matches_plain(dev, integer, mode):
    for i, (v, d, b, length) in enumerate(SHAPES):
        table, ids = make(dev, v, d, b, length, integer, seed=i)
        before = embedding_bag.launches
        out = embedding_bag(table, ids, mode=mode)
        torch.cuda.synchronize()
        assert embedding_bag.launches == before + 1
        want = embedding_bag_plain(table, ids, mode)
        assert torch.equal(out, want), (v, d, b, length, mode)
        assert torch.equal(out[0].view(torch.int32), torch.zeros_like(out[0].view(torch.int32)))


@pytest.mark.cuda
def test_embedding_bag_offsets_past_2_31_elements(dev):
    """Rows at and above 2**31 / D read at 64-bit offsets: a (2**23 + 64,
    256) table holds 2**31 + 2**14 floats (8.6 GB)."""
    d = 256
    v = 2**23 + 64
    table = torch.empty((v, d), device=dev)
    top = torch.arange(v - 200, v, device=dev, dtype=torch.float32)
    table[:256] = 1.0
    table[v - 200 :] = top[:, None] + torch.arange(d, device=dev, dtype=torch.float32) / 1024
    ids = torch.stack([torch.arange(v - 200, v - 100, dtype=torch.int32, device=dev),
                       torch.arange(v - 100, v, dtype=torch.int32, device=dev)])
    ids[0, 3] = -1
    ids[1, :5] = torch.tensor([v - 1, -1, 0, v - 1, 2**23], dtype=torch.int32)
    table[2**23] = 7.0
    out = embedding_bag_cuda(table, ids)
    torch.cuda.synchronize()
    assert torch.equal(out, embedding_bag_plain(table, ids))
    # Row V - 1 as the only valid id.
    one = torch.tensor([[-1, v - 1, -1]], dtype=torch.int32, device=dev)
    assert torch.equal(embedding_bag_cuda(table, one)[0], table[v - 1])


@pytest.mark.cuda
def test_embedding_bag_wrapper_rejects_bad_inputs(dev):
    table, ids = make(dev, 100, 16, 4, 8, True)
    with pytest.raises(ValueError):
        embedding_bag_cuda(table, ids.long())
    with pytest.raises(ValueError):
        embedding_bag_cuda(table.double(), ids)
    with pytest.raises(ValueError):
        embedding_bag_cuda(table[:, ::2], ids)
    with pytest.raises(ValueError):
        embedding_bag(table, ids.cpu())
    with pytest.raises(ValueError, match="unknown mode"):
        embedding_bag(table, ids, mode="max")
    empty = embedding_bag_cuda(table, ids[:0])
    none = embedding_bag_cuda(table, ids[:, :0].contiguous())
    torch.cuda.synchronize()
    assert empty.shape == (0, 16) and torch.equal(none, torch.zeros((4, 16), device=dev))


@pytest.mark.cuda
def test_two_tower_serving_card_matches_cpu(dev):
    """The smoke two-tower config, the same weights on the card and the CPU:
    bags bit for bit, scores within 1e-5, the same top-k ids."""
    cfg = smoke_two_tower()
    cpu = torch.device("cpu")
    host = two_tower_init(torch.Generator().manual_seed(0), cfg, device=cpu)
    card = two_tower_init(torch.Generator().manual_seed(0), cfg, device=cpu).to(dev)
    for shape in ("serve_p99", "serve_bulk"):
        hb = shape_batch(cfg, shape, 3, 0, shapes=SMOKE_RECSYS_SHAPES, device=cpu)
        cb = {k: t.to(dev) for k, t in hb.items()}
        before = embedding_bag.launches
        got = serve_fn(cfg, shape, SMOKE_RECSYS_SHAPES)(card, cb)
        torch.cuda.synchronize()
        assert embedding_bag.launches == before + 1
        want = serve_fn(cfg, shape, SMOKE_RECSYS_SHAPES)(host, hb)
        assert (got.cpu() - want).abs().max() <= 1e-5
        assert torch.equal(embedding_bag(card.item_emb, cb["hist"]).cpu(),
                           embedding_bag(host.item_emb, hb["hist"]))
    with torch.inference_mode():
        cand = host.item(torch.arange(256, dtype=torch.int32))
    hb = shape_batch(cfg, "retrieval_cand", 4, 0, shapes=SMOKE_RECSYS_SHAPES, candidates=cand,
                     device=cpu)
    cb = {k: t.to(dev) for k, t in hb.items()}
    fn = serve_fn(cfg, "retrieval_cand", SMOKE_RECSYS_SHAPES)
    (gv, gi), (wv, wi) = fn(card, cb), fn(host, hb)
    assert (gv.cpu() - wv).abs().max() <= 1e-5
    gap = (wv[0, :-1] - wv[0, 1:]) > 1e-4
    # Wherever a rank is separated from the next by more than 1e-4, the
    # lists agree on the set of ids above it.
    for j in torch.nonzero(gap).flatten().tolist():
        assert set(gi[0, : j + 1].tolist()) == set(wi[0, : j + 1].tolist())


def backward_cases(dev, d, seed=0):
    """(name, ids, g, V): rows no id hits (V far above the ids), rows hit by
    every position (one id everywhere), an all-padding batch, V = 1 (and
    ids >= V clamped onto it), ids >= V among 30% padding, on float g."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def g_of(b):
        return torch.randn((b, d), generator=gen, device=dev)

    ids = torch.randint(0, 64, (96, 20), generator=gen, dtype=torch.int32, device=dev)
    yield "sparse", ids, g_of(96), 50_000
    yield "every position", torch.full((40, 30), 7, dtype=torch.int32, device=dev), g_of(40), 20
    yield "all padding", torch.full((33, 12), -1, dtype=torch.int32, device=dev), g_of(33), 500
    one = torch.randint(-1, 3, (17, 9), generator=gen, dtype=torch.int32, device=dev)
    yield "V = 1", one, g_of(17), 1
    mixed = torch.randint(0, 300, (128, 50), generator=gen, dtype=torch.int32, device=dev)
    mixed[torch.rand((128, 50), generator=gen, device=dev) < 0.3] = -1
    mixed[1, :4] = torch.tensor([299, 300, 301, 10**6], dtype=torch.int32)
    yield "ids >= V", mixed, g_of(128), 300


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 4, 256, 300])
def test_backward_kernels_equal_plain_on_edge_rows(dev, d):
    """The gradient written into ``torch.empty`` equals the plain version
    bit for bit in both modes; one count a kernel launch. The main kernel over
    column slabs of 128 (one launch each) writes the same bits."""
    for name, ids, g, v in backward_cases(dev, d, seed=d):
        for mode in ("sum", "mean"):
            before = embedding_bag_backward.launches
            got = embedding_bag_backward(ids, g, v, mode=mode)
            torch.cuda.synchronize()
            assert embedding_bag_backward.launches == before + backward_launches(*g.shape)
            want = embedding_bag_backward_plain(ids, g, v, mode)
            assert got.shape == (v, d) and torch.equal(got, want), (name, mode, d)
        if d > 128:
            keys, pos = sorted_keys(ids, v)
            slabs = dense_rows_cuda(row_bounds_cuda(keys, v), pos, g, ids.shape[1], slab=128)
            assert torch.equal(slabs, embedding_bag_backward_plain(ids, g, v)), name


@pytest.mark.cuda
def test_row_bounds_equal_searchsorted(dev):
    """The row-bounds kernel's offsets equal ``torch.searchsorted`` of 0..V
    into the sorted keys (left), gaps of one row and of more than a warp's
    32 alike, and on no keys at all."""
    gen = torch.Generator(device=dev).manual_seed(5)
    cases = [torch.randint(0, 4_000_000, (65_536, 50), generator=gen, dtype=torch.int32,
                           device=dev),
             torch.tensor([[3, 3, 70, -1, 1000, 70]], dtype=torch.int32, device=dev),
             torch.full((4, 4), -1, dtype=torch.int32, device=dev),
             torch.empty((0, 3), dtype=torch.int32, device=dev)]
    for ids, v in zip(cases, (4_000_000, 5000, 64, 10)):
        keys, _ = sorted_keys(ids, v)
        got = row_bounds_cuda(keys, v)
        torch.cuda.synchronize()
        want = torch.searchsorted(keys, torch.arange(v + 1, dtype=torch.int32, device=dev))
        assert torch.equal(got.long(), want), (tuple(ids.shape), v)


@pytest.mark.cuda
def test_backward_writes_rows_past_2_31_elements(dev):
    """A (2**23 + 64, 256) gradient (2**31 + 2**14 floats, 8.6 GB): rows at
    and above 2**31 / D written at 64-bit offsets, equal to the plain
    version bit for bit."""
    d, v = 256, 2**23 + 64
    gen = torch.Generator(device=dev).manual_seed(9)
    ids = torch.randint(v - 300, v, (64, 8), generator=gen, dtype=torch.int32, device=dev)
    ids[0, :3] = torch.tensor([0, 2**23, v + 5], dtype=torch.int32)
    g = torch.randn((64, d), generator=gen, device=dev)
    got = embedding_bag_backward_cuda(ids, g, v)
    torch.cuda.synchronize()
    want = embedding_bag_backward_plain(ids, g, v)
    assert torch.equal(got, want)
