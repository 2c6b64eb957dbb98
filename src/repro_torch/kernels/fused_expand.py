"""fused_expand: gather + distance + constraint + tombstone + visited probe
in one pass over a (B, M) candidate batch -> (dists, satisfied, fresh).

Replaces the TPU kernel ``repro/kernels/fused_expand/fused_expand.py``
(``fused_expand_kernel``, exact rows), the fused main path
(``fuse_expand="on"``); ``fused_expand_adc`` replaces its PQ twin
``fused_expand_adc_kernel`` (code rows + LUT sums, ``approx="pq"``).

Bound on the card: at the search's 256 x 32 candidates, latency (the
chain of dependent memory trips from a candidate's id to its stores), not
the bytes (one d-float row or one code row, a 4-byte metadata word, a
visited word and a label word or two bounds per candidate). The CUDA
kernel (``csrc/fused_expand.cu``) runs ``gather_distance``'s register path
(``csrc/sqdist.cuh``: a warp owns several candidates of one query, the
query row in registers, every row load issued before any reduction), so
fused and unfused distances are the same bits by construction; lane c
issues candidate c's visited, meta and tombstone words beside the row
loads, takes the query's constraint word from a register (up to 32 label
words) or as soon as the meta word arrives, and writes candidate c's
distance and masks as coalesced stores. ``csrc/fused_expand_adc.cu`` gives
a block the candidates of one query, four lanes a candidate: unless all
its ids are padding, the query's LUT and constraint row are copied into
shared memory (``cp.async``) while the probes and code rows are in flight,
and the m_sub lookups read shared memory (a table too large for it is
read in device memory). The
masks are written straight into ``torch.bool`` tensors. Both kernels
evaluate the verdicts with one shared piece of code (``csrc/probe.cuh``).

  satisfied = valid & constraint(meta[id]) & not tombstoned(id)
  fresh     = valid & visited bit (b, id) clear
  padding ids (< 0) give (+inf, False, False)
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.common.bits import bit_of, n_words
from repro_torch.common.distances import batched_rowwise_sqdist
from repro_torch.kernels import dispatch, kernel_entry, launch, require
from repro_torch.kernels.gather_distance import MAX_DIM
from repro_torch.kernels.pq_adc import adc_lookup

FAMILIES = ("label", "range", "udf")
# queries, corpus, ids, visited, meta, cons, tomb, dists, sat, fresh;
# B, M, d, W, Lw, family, with_tomb; stream
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
# lut, codes, ids, visited, meta, cons, tomb, dists, sat, fresh;
# B, M, m_sub, n_cent, W, Lw, family, with_tomb; stream
_ADC_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def _fresh_and_sat(ids, visited, meta, cons, family, tomb=None):
    """(valid & unvisited, valid & constraint-ok), as the reference's
    ``fused_expand/ref.py::_fresh_and_sat``."""
    safe = ids.clamp_min(0).long()
    valid = ids >= 0
    fresh = valid & ~bit_of(visited.gather(1, safe >> 5), safe)
    if family == "label":
        lab = meta[safe].long()
        ok = bit_of(cons.gather(1, lab >> 5), lab)
    elif family == "range":
        val = meta.float()[safe]
        ok = (val >= cons[:, 0:1]) & (val <= cons[:, 1:2])
    elif family == "udf":
        ok = meta[safe] != 0
    else:
        raise ValueError(f"unsupported in-kernel constraint family: {family}")
    if tomb is not None:
        ok = ok & ~bit_of(tomb[safe >> 5], safe)
    return fresh, valid & ok


def fused_expand_plain(queries, corpus, ids, visited, meta, cons, tomb=None, *, family):
    """The reference's arithmetic (``fused_expand/ref.py``) in PyTorch."""
    rows = corpus[ids.clamp_min(0).long()]
    dists = torch.where(ids >= 0, batched_rowwise_sqdist(queries, rows), float("inf"))
    fresh, sat = _fresh_and_sat(ids, visited, meta, cons, family, tomb)
    return dists, sat, fresh


def _check_probe(dev, n, b, ids, visited, meta, cons, tomb, family) -> None:
    """The checks both fused kernels share: ids, visited, meta, cons, tomb."""
    require(family in FAMILIES, f"unsupported in-kernel constraint family: {family}")
    meta_dtype = torch.float32 if family == "range" else torch.int32
    cons_dtype = {"label": torch.int32, "range": torch.float32, "udf": cons.dtype}[family]
    tensors = [("ids", ids, torch.int32), ("visited", visited, torch.int32),
               ("meta", meta, meta_dtype), ("cons", cons, cons_dtype)]
    if tomb is not None:
        tensors.append(("tomb", tomb, torch.int32))
    for name, t, dtype in tensors:
        require(t.device == dev, f"{name} is on {t.device}, expected {dev}")
        require(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
        require(t.is_contiguous(), f"{name} must be contiguous")
    require(ids.dim() == 2 and ids.shape[0] == b, "ids must be (B, M)")
    require(b < 2**31 and ids.shape[1] < 2**31, "B and M must be < 2**31")
    require(visited.dim() == 2 and visited.shape[0] == b and visited.shape[1] >= n_words(n),
            "visited must be (B, >= ceil(n/32))")
    require(meta.shape == (n,), "meta must be (n,)")
    if family == "label":
        require(cons.dim() == 2 and cons.shape[0] == b, "label cons must be (B, Lw)")
    if family == "range":
        require(cons.shape == (b, 2), "range cons must be (B, 2)")
    if tomb is not None:
        require(tomb.dim() == 1 and tomb.shape[0] >= n_words(n), "tomb must be (>= ceil(n/32),)")


def _check(queries, corpus, ids, visited, meta, cons, tomb, family) -> None:
    dev = queries.device
    for name, t in (("queries", queries), ("corpus", corpus)):
        require(t.device == dev, f"{name} is on {t.device}, queries on {dev}")
        require(t.dtype == torch.float32, f"{name} must be torch.float32, got {t.dtype}")
        require(t.is_contiguous(), f"{name} must be contiguous")
    b, d = queries.shape
    require(corpus.dim() == 2 and corpus.shape[1] == d, "queries and corpus widths differ")
    require(d <= MAX_DIM, f"d must be <= {MAX_DIM}")
    _check_probe(dev, corpus.shape[0], b, ids, visited, meta, cons, tomb, family)


def fused_expand_cuda(queries, corpus, ids, visited, meta, cons, tomb=None, *, family):
    """Launch the CUDA kernel on the current stream; does not synchronise."""
    _check(queries, corpus, ids, visited, meta, cons, tomb, family)
    fn = kernel_entry("fused_expand", "repro_fused_expand", _ARGTYPES)
    b, d = queries.shape
    m = ids.shape[1]
    dev = queries.device
    dists = torch.empty((b, m), dtype=torch.float32, device=dev)
    sat = torch.empty((b, m), dtype=torch.bool, device=dev)
    fresh = torch.empty((b, m), dtype=torch.bool, device=dev)
    launch("fused_expand", dev, fn, queries.data_ptr(), corpus.data_ptr(), ids.data_ptr(),
           visited.data_ptr(), meta.data_ptr(), cons.data_ptr(),
           0 if tomb is None else tomb.data_ptr(), dists.data_ptr(), sat.data_ptr(),
           fresh.data_ptr(), b, m, d, visited.shape[1], cons.shape[-1], FAMILIES.index(family),
           int(tomb is not None))
    fused_expand.launches += 1
    return dists, sat, fresh


def fused_expand(queries, corpus, ids, visited, meta, cons, tomb=None, *, family):
    """(B, d) f32, (n, d) f32, (B, M) i32 ids, (B, W) i32 visited words,
    (n,) meta (int32 labels / float32 values / int32 verdicts), cons
    ((B, Lw) int32 words / (B, 2) float32 bounds / (1, 1) dummy), optional
    (Wt,) int32 tombstones -> ((B, M) f32, (B, M) bool, (B, M) bool).

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. ``fused_expand.launches`` counts kernel launches.
    """
    fn = dispatch(queries.device, fused_expand_cuda, fused_expand_plain)
    return fn(queries, corpus, ids, visited, meta, cons, tomb, family=family)


fused_expand.launches = 0


def fused_expand_adc_plain(lut, codes, ids, visited, meta, cons, tomb=None, *, family):
    """The reference's arithmetic (``fused_expand/ref.py::fused_expand_adc_ref``)
    in PyTorch: the unfused PQ distance (``adc_lookup``), +inf for padding."""
    crows = codes[ids.clamp_min(0).long()]
    dists = torch.where(ids >= 0, adc_lookup(lut, crows), float("inf"))
    fresh, sat = _fresh_and_sat(ids, visited, meta, cons, family, tomb)
    return dists, sat, fresh


def _check_adc(lut, codes, ids, visited, meta, cons, tomb, family) -> None:
    dev = lut.device
    for name, t, dtype in (("lut", lut, torch.float32), ("codes", codes, torch.int32)):
        require(t.device == dev, f"{name} is on {t.device}, lut on {dev}")
        require(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
        require(t.is_contiguous(), f"{name} must be contiguous")
    require(lut.dim() == 3 and codes.dim() == 2 and codes.shape[1] == lut.shape[1],
            "expected (B, m_sub, n_cent) lut and (n, m_sub) codes")
    _check_probe(dev, codes.shape[0], lut.shape[0], ids, visited, meta, cons, tomb, family)


def fused_expand_adc_cuda(lut, codes, ids, visited, meta, cons, tomb=None, *, family):
    """Launch the CUDA kernel on the current stream; does not synchronise.
    Codes outside [0, n_cent) read entry n_cent - 1 (an unsigned clamp;
    the plain version's gather raises on them)."""
    _check_adc(lut, codes, ids, visited, meta, cons, tomb, family)
    fn = kernel_entry("fused_expand_adc", "repro_fused_expand_adc", _ADC_ARGTYPES)
    b, m_sub, n_cent = lut.shape
    m = ids.shape[1]
    dev = lut.device
    dists = torch.empty((b, m), dtype=torch.float32, device=dev)
    sat = torch.empty((b, m), dtype=torch.bool, device=dev)
    fresh = torch.empty((b, m), dtype=torch.bool, device=dev)
    launch("fused_expand_adc", dev, fn, lut.data_ptr(), codes.data_ptr(), ids.data_ptr(),
           visited.data_ptr(), meta.data_ptr(), cons.data_ptr(),
           0 if tomb is None else tomb.data_ptr(), dists.data_ptr(), sat.data_ptr(),
           fresh.data_ptr(), b, m, m_sub, n_cent, visited.shape[1], cons.shape[-1],
           FAMILIES.index(family), int(tomb is not None))
    fused_expand_adc.launches += 1
    return dists, sat, fresh


def fused_expand_adc(lut, codes, ids, visited, meta, cons, tomb=None, *, family):
    """ADC twin of ``fused_expand``: (B, m_sub, n_cent) f32 LUT
    (``core/pq.py::adc_table``), (n, m_sub) i32 codes, then the same ids,
    visited, meta, cons and tomb -> ((B, M) f32, (B, M) bool, (B, M) bool).

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. ``fused_expand_adc.launches`` counts kernel launches.
    """
    fn = dispatch(lut.device, fused_expand_adc_cuda, fused_expand_adc_plain)
    return fn(lut, codes, ids, visited, meta, cons, tomb, family=family)


fused_expand_adc.launches = 0
