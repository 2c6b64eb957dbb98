"""embedding_bag: sum-mode bags, out[b] = sum_l table[ids[b, l]] over ids >= 0.

Replaces the TPU kernel ``repro/kernels/embedding_bag/embedding_bag.py``
(``embedding_bag_kernel``) behind its public wrapper ``ops.py::
embedding_bag``: in the port it carries the two-tower user tower's history
bag (``models/recsys/models.py::embedding_bag_sum``).

Bound on the card: device-memory bytes. Each valid id reads one D-float row
(1 KB at D = 256) from a table far beyond L2 (51 GB at the published 50M
items), and adds it once; at serve_bulk (262,144 bags of 50 ids, 30%
padding) that is about 9 GB of scattered 1 KB reads against 0.3 GB of ids
and output. The CUDA kernel (``csrc/embedding_bag.cu``) gives one warp to a
bag: a ballot over the bag's ids skips padding rows without loading them,
lanes span D with float4 loads where D % 4 == 0 (one float otherwise),
four rows are in flight before any is added, and the sums stay in
registers until one coalesced store. Its row offsets are 64-bit.

Summation order is pinned: every path adds a bag's valid rows left to
right (l = 0, 1, ...) from +0.0, one rounded add at a time, as the Pallas
kernel's grid does, so the card's bags equal the CPU's bit for bit on float
tables too. Ids at or above V are clamped to V - 1 by the kernel (the plain
version's gather raises on them).

The gradient: ``embedding_bag`` is a ``torch.autograd.Function`` when the
table needs a gradient. Its backward, ``embedding_bag_backward``, writes
the dense (V, D) d_table the reference's ``jax.grad`` of
``embedding_bag_sum`` gives: d_table[r] = the sum of g[b] over every
(b, l) with ids[b, l] == r (g[b] divided by its bag's count first in mean
mode). No TPU kernel stands behind it (the reference differentiates the
jnp gather); on the card it is the CUDA kernels of
``csrc/embedding_bag_backward.cu``, bound by the bytes of the dense
output, which they write once: ``torch.sort`` orders the flattened ids
stably (padding last), a small kernel writes each row's run of the sorted
order as CSR offsets (``row_bounds_cuda``), and the main one writes every
row of the (V, D) output once, in row order (``torch.empty``: no zeroing
pass). Its order is pinned too: each row's contributions are added in
row-major (b, l) order from +0.0, one rounded add at a time, on the card
and in the plain version alike.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import dispatch, kernel_entry, launch, require

MODES = ("sum", "mean")
# table, ids, out; B, L, D; V; vec4, mean; stream
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_longlong]
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])
# keys, bounds; n, V; stream
_BOUNDS_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
# bounds, pos, g, out; L, D; V; vec4, slab; stream
_BWD_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
# The backward's main kernel reads random rows of g: it walks the columns in
# slabs whose share of g (B x slab floats) fits this much of the 50 MB L2.
SLAB_BYTES = 24 << 20


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode}")


def embedding_bag_plain(table, ids, mode: str = "sum"):
    """The reference's take + mask + sum, one bag column at a time, adding
    left to right from a zero accumulator (the Pallas kernel's order), so
    the (B, L, D) gather is never whole."""
    _check_mode(mode)
    dtype = torch.promote_types(table.dtype, torch.float32)  # float64 stays (gradcheck)
    acc = torch.zeros((ids.shape[0], table.shape[1]), dtype=dtype, device=table.device)
    for col in ids.T:
        rows = table.index_select(0, col.clamp_min(0).long()).to(dtype)
        acc = acc + torch.where((col >= 0)[:, None], rows, 0.0)
    if mode == "mean":  # divide by max(count of ids >= 0, 1), in float32
        acc = acc / _bag_counts(ids, dtype)
    return acc


def _bag_counts(ids, dtype):
    """(B, 1) max(count of ids >= 0, 1) in ``dtype``."""
    return (ids >= 0).sum(-1, keepdim=True).clamp_min(1).to(dtype)


def _check(table, ids) -> None:
    require(ids.device == table.device, f"ids is on {ids.device}, table on {table.device}")
    for name, t, dtype in (("table", table, torch.float32), ("ids", ids, torch.int32)):
        require(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
        require(t.dim() == 2, f"{name} must be 2-D")
        require(t.is_contiguous(), f"{name} must be contiguous")
    require(table.shape[0] >= 1, "the table needs at least one row")
    require(ids.shape[0] < 2**31 and ids.shape[1] < 2**31 and table.shape[1] < 2**31,
            "B, L and D must be < 2**31")


def embedding_bag_cuda(table, ids, mode: str = "sum"):
    """Launch the CUDA kernel on the current stream; does not synchronise."""
    _check_mode(mode)
    _check(table, ids)
    fn = kernel_entry("embedding_bag", "repro_embedding_bag", _ARGTYPES)
    v, d = table.shape
    b, length = ids.shape
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    vec4 = int(d % 4 == 0 and table.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    launch("embedding_bag", table.device, fn, table.data_ptr(), ids.data_ptr(), out.data_ptr(),
           b, length, d, v, vec4, int(mode == "mean"))
    embedding_bag.launches += 1
    return out


class _EmbeddingBag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, mode):
        ctx.save_for_backward(ids)
        ctx.mode, ctx.v = mode, table.shape[0]
        return dispatch(table.device, embedding_bag_cuda, embedding_bag_plain)(table, ids, mode)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return embedding_bag_backward(ids, g.contiguous(), ctx.v, mode=ctx.mode), None, None


def embedding_bag(table, ids, *, mode: str = "sum"):
    """(V, D) float32 table, (B, L) int32 ids (-1 pads) -> (B, D) float32.

    ``mode="mean"`` divides each bag by max(its count of ids >= 0, 1); any
    other mode but "sum" raises. CUDA tensors launch the kernel (or raise);
    CPU tensors take the plain version. Where the table needs a gradient,
    the call is recorded for autograd and its backward is
    ``embedding_bag_backward``. ``embedding_bag.launches`` counts kernel
    launches.
    """
    if torch.is_grad_enabled() and table.requires_grad:
        return _EmbeddingBag.apply(table, ids, mode)
    return dispatch(table.device, embedding_bag_cuda, embedding_bag_plain)(table, ids, mode)


embedding_bag.launches = 0


# --------------------------------------------------------------------------- backward


def _scaled_grad(ids, g, mode: str):
    """g, each bag's row divided by its count in mean mode (the gradient of
    the forward's division)."""
    _check_mode(mode)
    return g / _bag_counts(ids, g.dtype) if mode == "mean" else g


def sorted_keys(ids, v: int):
    """(keys, pos): the flattened ids with padding (< 0) as ``v`` and ids at
    or above ``v`` clamped to v - 1, sorted stably (int32), and each key's
    flat position b * L + l (int64): within a run of equal ids, row-major
    order."""
    flat = ids.reshape(-1)
    keys = torch.where(flat >= 0, flat.clamp_max(v - 1), torch.full_like(flat, v))
    out = torch.sort(keys, stable=True)
    return out.values, out.indices


def embedding_bag_backward_plain(ids, g, v: int, mode: str = "sum"):
    """The kernel's order in plain PyTorch: the stable sort, then a
    segmented sum of each run of equal ids, left to right from +0.0 (one
    add a run per pass; as many passes as the longest run)."""
    gs = _scaled_grad(ids, g, mode)
    keys, pos = sorted_keys(ids, v)
    n = int((keys < v).sum())
    keys, pos = keys[:n], pos[:n]
    out = torch.zeros((v, g.shape[1]), dtype=g.dtype, device=g.device)
    if n == 0:
        return out
    start = torch.ones(n, dtype=torch.bool, device=g.device)
    start[1:] = keys[1:] != keys[:-1]
    run = torch.cumsum(start, 0) - 1
    first = torch.nonzero(start).squeeze(1)
    rank = torch.arange(n, device=g.device) - first[run]
    bags = pos // ids.shape[1]
    acc = torch.zeros((first.numel(), g.shape[1]), dtype=g.dtype, device=g.device)
    for r in range(int(rank.max()) + 1):
        sel = torch.nonzero(rank == r).squeeze(1)
        idx = run[sel]
        acc[idx] = acc[idx] + gs[bags[sel]]
    out[keys[first].long()] = acc
    return out


def _check_backward(ids, g, v: int) -> None:
    require(ids.device == g.device, f"ids is on {ids.device}, g on {g.device}")
    for name, t, dtype in (("g", g, torch.float32), ("ids", ids, torch.int32)):
        require(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
        require(t.dim() == 2, f"{name} must be 2-D")
        require(t.is_contiguous(), f"{name} must be contiguous")
    require(g.shape[0] == ids.shape[0], f"g has {g.shape[0]} rows, ids {ids.shape[0]} bags")
    require(1 <= v < 2**31 - 1, "V must be in [1, 2**31 - 1): padding sorts as V in int32")
    require(ids.shape[1] >= 1 and g.shape[1] < 2**31, "L must be >= 1 and D < 2**31")


def row_bounds_cuda(keys, v: int):
    """``sorted_keys``' keys (n,) -> the (V + 1,) int32 CSR offsets of their
    runs, row r's being [bounds[r], bounds[r + 1]) (``torch.searchsorted``
    of 0..V into the keys), each entry written once by the row-bounds
    kernel; does not synchronise."""
    require(keys.numel() < 2**31 - 1, "B * L must be < 2**31 - 1: the offsets are int32")
    fn = kernel_entry("embedding_bag_backward", "repro_embedding_bag_row_bounds",
                      _BOUNDS_ARGTYPES)
    bounds = torch.empty(v + 1, dtype=torch.int32, device=keys.device)
    launch("embedding_bag_backward", keys.device, fn, keys.data_ptr(), bounds.data_ptr(),
           keys.numel(), v)
    embedding_bag_backward.launches += 1
    return bounds


def slab_width(b: int, d: int) -> int:
    """The main kernel's columns a launch: the most whose share of a (b, d)
    g fits ``SLAB_BYTES``, in whole warps' spans of float4 (128 columns),
    at least one span, at most d."""
    span = 128
    return min(d, max(span, SLAB_BYTES // (4 * max(b, 1)) // span * span))


def backward_launches(b: int, d: int) -> int:
    """The kernel launches of one ``embedding_bag_backward`` call on a card
    with a (b, d) upstream gradient: the row bounds, then a slab each."""
    return 1 + -(-d // slab_width(b, d))


def dense_rows_cuda(bounds, pos, gs, length: int, slab=None):
    """The (V, D) gradient from the runs' offsets (``row_bounds_cuda``), the
    sorted keys' flat positions and the (scaled) upstream gradient, every
    element written once by the main kernel, one launch a slab of ``slab``
    columns (``slab_width``); does not synchronise."""
    fn = kernel_entry("embedding_bag_backward", "repro_embedding_bag_backward", _BWD_ARGTYPES)
    v, (b, d) = bounds.numel() - 1, gs.shape
    out = torch.empty((v, d), dtype=torch.float32, device=gs.device)
    vec4 = int(d % 4 == 0 and gs.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    slab = slab_width(b, d) if slab is None else slab
    launch("embedding_bag_backward", gs.device, fn, bounds.data_ptr(), pos.data_ptr(),
           gs.data_ptr(), out.data_ptr(), length, d, v, vec4, slab)
    embedding_bag_backward.launches += -(-d // slab)  # the entry point's launches: a slab each
    return out


def embedding_bag_backward_cuda(ids, g, v: int, mode: str = "sum"):
    """The stable sort of the keys, then the row-bounds and the main kernel
    on the current stream; does not synchronise."""
    _check_backward(ids, g, v)
    gs = _scaled_grad(ids, g, mode).contiguous()
    keys, pos = sorted_keys(ids, v)
    return dense_rows_cuda(row_bounds_cuda(keys, v), pos, gs, ids.shape[1])


def embedding_bag_backward(ids, g, v: int, *, mode: str = "sum"):
    """(B, L) int32 ids (-1 pads), (B, D) float32 upstream gradient, V ->
    the dense (V, D) gradient of ``embedding_bag``'s table. CUDA tensors
    launch the kernels (or raise); CPU tensors take the plain version.
    ``embedding_bag_backward.launches`` counts the kernel launches: one of
    the row-bounds kernel a call, and one of the main kernel a column slab
    (``slab_width``; ``backward_launches`` a call in all)."""
    return dispatch(g.device, embedding_bag_backward_cuda, embedding_bag_backward_plain)(
        ids, g, v, mode)


embedding_bag_backward.launches = 0
