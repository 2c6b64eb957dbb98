"""l2_matmul: pairwise squared L2, out[i, j] = max(|q_i|^2 - 2 q_i.x_j + |x_j|^2, 0).

Replaces the TPU kernel ``repro/kernels/l2_matmul/l2_matmul.py``
(``l2_matmul``) behind its public wrapper ``ops.py::pairwise_sqdist``: the
pairwise blocks of the exact kNN graph (``graph/build.py::build_knn_graph``)
and of ``medoid``.

Bound on the card: operations. A (M, d) x (N, d) call does 2*M*N*d float32
operations and writes M*N*4 bytes; at the build's (1024, 1M, 128) that is
2.7e11 operations, 4.0 ms at the H100's 67 TFLOP/s outside the tensor
cores, against 1.2 ms for the 4.1 GB of output. The CUDA kernel
(``csrc/l2_matmul.cu``) is a plain float32 tiled product (128 x 128 output
tiles, 8 x 8 register tiles, double-buffered 8-wide slices of d in shared
memory) that adds the row norms in the same pass and clamps in its
epilogue. It stays in full float32 (no TF32, no tensor cores): the graph's
neighbour order depends on the last bits.

The plain version is the reference's own non-kernel path (``ops.py``
falls back to ``squared_l2``): the expansion with one matrix product.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.common.distances import squared_l2
from repro_torch.kernels import dispatch, kernel_entry, launch, require

TILE = 128  # output tile edge (csrc/l2_matmul.cu kBM, kBN)
# q, x, out; M, N, d, vec4, vec_out; stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def l2_matmul_plain(q, x):
    """``squared_l2``: the expansion with one matrix product, clamped at 0."""
    return squared_l2(q, x)


def _check(q, x) -> None:
    for name, t in (("q", q), ("x", x)):
        require(t.device == q.device, f"{name} is on {t.device}, q on {q.device}")
        require(t.dtype == torch.float32, f"{name} must be float32, got {t.dtype}")
        require(t.dim() == 2, f"{name} must be 2-D")
        require(t.is_contiguous(), f"{name} must be contiguous")
    require(q.shape[1] == x.shape[1], "q and x widths differ")
    require(q.shape[1] >= 1, "d must be >= 1")
    require(q.shape[0] < 2**31 and x.shape[0] < 2**31, "M and N must be < 2**31 (int rows)")


def l2_matmul_cuda(q, x):
    """Launch the CUDA kernel on the current stream; does not synchronise."""
    _check(q, x)
    fn = kernel_entry("l2_matmul", "repro_l2_matmul", _ARGTYPES)
    m, d = q.shape
    n = x.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=q.device)
    vec4 = int(d % 4 == 0 and q.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0)
    vec_out = int(n % 4 == 0 and out.data_ptr() % 16 == 0)
    launch("l2_matmul", q.device, fn, q.data_ptr(), x.data_ptr(), out.data_ptr(), m, n, d, vec4,
           vec_out)
    pairwise_sqdist.launches += 1
    return out


def pairwise_sqdist(q, x):
    """(M, d) float32, (N, d) float32 -> (M, N) float32 squared distances.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. ``pairwise_sqdist.launches`` counts kernel launches.
    """
    return dispatch(q.device, l2_matmul_cuda, l2_matmul_plain)(q, x)


pairwise_sqdist.launches = 0
