"""pq_adc: the full-corpus ADC scan ADC[b, v] = sum_s LUT[b, s, codes[v, s]].

Replaces the TPU kernel ``repro/kernels/pq_adc/pq_adc.py``
(``pq_adc_kernel``), the hot loop of the PQ linear-scan baseline
(``core/pq.py::adc_scan(use_kernel=True)``).

Bound on the card: device-memory bytes. The (B, N) float32 output
dominates (1 GB at B = 256, N = 1M) beside the (N, m_sub) codes read once
and the LUT read once; the m_sub adds a distance are ~1/16 operation a
byte. Its m_sub lookups a distance (16.4 GB of shared-memory reads at
B = 256, N = 1M) are the design's own floor, ~0.5 ms. The CUDA kernel
(``csrc/pq_adc.cu``) stages a group of queries' LUTs in shared memory as
[s][code][q] and runs a warp's lanes over queries, so the lanes that serve
one code row read consecutive words of one code's entry and few bank
conflicts remain. The TPU kernel's one-hot x LUT product on the matrix
unit does not carry over: a shared-memory lookup is the card's gather.

Summation order is pinned: every path adds the m_sub entries left to right
(s = 0, 1, ...), in the plain versions here and in both CUDA kernels, so
the card's scan, its fused traversal and its unfused traversal give the
same bits as the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import dispatch, kernel_entry, launch, require

SMEM_LIMIT = 232_448  # bytes of shared memory one block may use (sm_90)
# Elements of one (B, rows, m_sub) gather in the plain scan.
PLAIN_CHUNK_ELEMS = 1 << 26
# lut, codes, out; B, N, m_sub, n_cent, vec4; stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def ordered_sum(g):
    """Sum over the last axis, left to right: ((g0 + g1) + g2) + ...
    (``torch.sum`` has no fixed order on the card)."""
    acc = g[..., 0]
    for s in range(1, g.shape[-1]):
        acc = acc + g[..., s]
    return acc


def adc_lookup(lut, crows):
    """(B, m_sub, n_cent) LUT, (B, M, m_sub) code rows -> (B, M):
    sum_s lut[b, s, crows[b, m, s]], in ``ordered_sum``'s order. This is
    the unfused PQ distance (``PQBackend.distances``)."""
    b, m_sub, n_cent = lut.shape
    m = crows.shape[1]
    offs = torch.arange(m_sub, device=lut.device) * n_cent
    flat = (crows.long() + offs).reshape(b, m * m_sub)
    return ordered_sum(lut.reshape(b, m_sub * n_cent).gather(1, flat).reshape(b, m, m_sub))


def pq_adc_plain(lut, codes):
    """The reference's arithmetic (``pq_adc/ref.py``, ``PQBackend.scan_all``)
    in PyTorch, in chunks of corpus rows so the (B, N, m_sub) gather is never
    whole (16 GB at B = 256, N = 1M)."""
    b, m_sub, n_cent = lut.shape
    n = codes.shape[0]
    flat_lut = lut.reshape(b, m_sub * n_cent)
    offs = torch.arange(m_sub, device=lut.device) * n_cent
    out = torch.empty((b, n), dtype=torch.float32, device=lut.device)
    rows = max(1, PLAIN_CHUNK_ELEMS // max(1, b * m_sub))
    for v0 in range(0, n, rows):
        idx = (codes[v0 : v0 + rows].long() + offs).reshape(-1)
        g = flat_lut.index_select(1, idx).reshape(b, -1, m_sub)
        out[:, v0 : v0 + rows] = ordered_sum(g)
    return out


def _check(lut, codes) -> None:
    dev = lut.device
    for name, t, dtype in (("lut", lut, torch.float32), ("codes", codes, torch.int32)):
        require(t.device == dev, f"{name} is on {t.device}, lut on {dev}")
        require(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
        require(t.is_contiguous(), f"{name} must be contiguous")
    require(lut.dim() == 3 and codes.dim() == 2, "expected (B, m_sub, n_cent) and (N, m_sub)")
    require(codes.shape[1] == lut.shape[1], "lut and codes disagree on m_sub")
    require(lut.shape[1] * lut.shape[2] * 4 <= SMEM_LIMIT,
            "one query's LUT must fit a block's shared memory")
    require(codes.shape[0] <= 2**30, "N must be <= 2**30 (int row indices in the kernel)")


def pq_adc_cuda(lut, codes):
    """Launch the CUDA kernel on the current stream; does not synchronise.
    Codes outside [0, n_cent) read entry n_cent - 1 (an unsigned clamp;
    the plain version's gather raises on them)."""
    _check(lut, codes)
    fn = kernel_entry("pq_adc", "repro_pq_adc", _ARGTYPES)
    b, m_sub, n_cent = lut.shape
    n = codes.shape[0]
    out = torch.empty((b, n), dtype=torch.float32, device=lut.device)
    vec4 = int(m_sub % 4 == 0 and codes.data_ptr() % 16 == 0)
    launch("pq_adc", lut.device, fn, lut.data_ptr(), codes.data_ptr(), out.data_ptr(), b, n,
           m_sub, n_cent, vec4)
    pq_adc.launches += 1
    return out


def pq_adc(lut, codes):
    """(B, m_sub, n_cent) float32 LUT, (N, m_sub) int32 codes -> (B, N) float32.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. ``pq_adc.launches`` counts kernel launches.
    """
    return dispatch(lut.device, pq_adc_cuda, pq_adc_plain)(lut, codes)


pq_adc.launches = 0
