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
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import check_launch, current_stream_ptr, dispatch, kernel_entry, require

MODES = ("sum", "mean")
# table, ids, out; B, L, D; V; vec4, mean; stream
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_longlong]
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode}")


def embedding_bag_plain(table, ids, mode: str = "sum"):
    """The reference's take + mask + sum, one bag column at a time, adding
    left to right from a zero accumulator (the Pallas kernel's order), so
    the (B, L, D) gather is never whole."""
    _check_mode(mode)
    acc = torch.zeros((ids.shape[0], table.shape[1]), dtype=torch.float32, device=table.device)
    for col in ids.T:
        rows = table.index_select(0, col.clamp_min(0).long()).to(torch.float32)
        acc = acc + torch.where((col >= 0)[:, None], rows, 0.0)
    if mode == "mean":  # divide by max(count of ids >= 0, 1), in float32
        acc = acc / (ids >= 0).sum(-1, keepdim=True).clamp_min(1).to(torch.float32)
    return acc


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
    status = fn(table.data_ptr(), ids.data_ptr(), out.data_ptr(), b, length, d, v, vec4,
                int(mode == "mean"), current_stream_ptr(table.device))
    check_launch("embedding_bag", status)
    embedding_bag.launches += 1
    return out


def embedding_bag(table, ids, *, mode: str = "sum"):
    """(V, D) float32 table, (B, L) int32 ids (-1 pads) -> (B, D) float32.

    ``mode="mean"`` divides each bag by max(its count of ids >= 0, 1); any
    other mode but "sum" raises. CUDA tensors launch the kernel (or raise);
    CPU tensors take the plain version. ``embedding_bag.launches`` counts
    kernel launches.
    """
    return dispatch(table.device, embedding_bag_cuda, embedding_bag_plain)(table, ids, mode)


embedding_bag.launches = 0
