"""gather_distance: D[b, m] = ||q_b - corpus[ids[b, m]]||^2, +inf for ids < 0.

Replaces the TPU kernel ``repro/kernels/gather_distance/gather_distance.py``
(``gather_distance_kernel``), the unfused distance path of
``L2KernelBackend`` (``SearchParams.use_kernel``).

Bound on the card: device-memory bytes. Each candidate reads one d-float
corpus row (512 bytes at d = 128) and does 3*d operations, far below the
H100's ~20 operations a byte in float32, so the least time is the gathered
bytes over 3.35 TB/s. The CUDA kernel (``csrc/gather_distance.cu``) is
written for that: each warp owns a few candidates of one query, keeps the
query row in registers and issues all its candidates' coalesced 16-byte row
loads before any reduction (rows of any d, or unaligned ones, take a path
with the query row in shared memory, one warp a candidate); the (B, M, d)
gather is never written back to memory. The plain version below
materialises that gather and serves the CPU.

``config`` is the kernel's block shape, a point of the tuner's lattice
(``repro_torch.tune``: warps a block and rows in flight, read on the
register path only); None is
``DEFAULT_CONFIGS["gather_distance"]``, the shape the kernel had before
the tuner. Every point gives the same bits; one off the lattice raises.
The plain version ignores it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.common.distances import batched_rowwise_sqdist
from repro_torch.kernels import dispatch, kernel_entry, launch, require
from repro_torch.tune.config import DEFAULT_CONFIGS, KernelConfig

MAX_DIM = 12288  # the query row must fit the 48 KB of static shared memory
# queries, corpus, ids, out; B, M, d, tile_warps, rows_in_flight; stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def gather_distance_plain(queries, corpus, ids, config: Optional[KernelConfig] = None):
    """The reference's arithmetic (``gather_distance/ref.py``) in PyTorch;
    ``config`` is the kernel's and changes nothing here."""
    del config
    rows = corpus[ids.clamp_min(0).long()]
    return torch.where(ids >= 0, batched_rowwise_sqdist(queries, rows), float("inf"))


def _check(queries, corpus, ids) -> None:
    dev = queries.device
    for name, t, dtype in (("queries", queries, torch.float32), ("corpus", corpus, torch.float32),
                           ("ids", ids, torch.int32)):
        require(t.device == dev, f"{name} is on {t.device}, queries on {dev}")
        require(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
        require(t.is_contiguous(), f"{name} must be contiguous")
    require(queries.dim() == 2 and corpus.dim() == 2 and ids.dim() == 2, "expected 2-D tensors")
    require(corpus.shape[1] == queries.shape[1], "queries and corpus widths differ")
    require(ids.shape[0] == queries.shape[0], "ids and queries batch sizes differ")
    require(queries.shape[1] <= MAX_DIM, f"d must be <= {MAX_DIM}")
    require(ids.shape[0] < 2**31 and ids.shape[1] < 2**31, "B and M must be < 2**31")


def gather_distance_cuda(queries, corpus, ids, config: Optional[KernelConfig] = None):
    """Launch the CUDA kernel on the current stream; does not synchronise."""
    _check(queries, corpus, ids)
    cfg = config or DEFAULT_CONFIGS["gather_distance"]
    fn = kernel_entry("gather_distance", "repro_gather_distance", _ARGTYPES)
    b, d = queries.shape
    m = ids.shape[1]
    out = torch.empty((b, m), dtype=torch.float32, device=queries.device)
    launch("gather_distance", queries.device, fn, queries.data_ptr(), corpus.data_ptr(),
           ids.data_ptr(), out.data_ptr(), b, m, d, cfg.tile_warps, cfg.rows_in_flight)
    gather_distance.launches += 1
    return out


def gather_distance(queries, corpus, ids, config: Optional[KernelConfig] = None):
    """(B, d) float32, (n, d) float32, (B, M) int32 -> (B, M) float32.

    CUDA tensors launch the kernel at ``config`` (or raise); CPU tensors
    take the plain version. ``gather_distance.launches`` counts kernel
    launches.
    """
    return dispatch(queries.device, gather_distance_cuda, gather_distance_plain)(
        queries, corpus, ids, config)


gather_distance.launches = 0
