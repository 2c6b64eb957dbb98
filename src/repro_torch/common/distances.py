"""Distance primitives (port of ``repro.common.distances``): squared L2,
unless noted, and the inner-product and cosine variants of the MIPS-style
retrieval paths (two-tower).

Matrix products run in full float32: the port never enables TF32, because
the seeding distances and the exact oracle go through ``squared_l2``.

``squared_l2`` is also the plain version of the ``l2_matmul`` kernel
(``kernels/l2_matmul.py::pairwise_sqdist``), which carries the index
build's pairwise blocks on the card. The exact oracle
(``core/exact.py``), the seeding distances (``core/engine/context.py``) and
k-means stay on ``squared_l2`` on purpose: the yardstick of recall must not
share the kernel under test.
"""
from __future__ import annotations

import torch


def squared_l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise squared L2 between rows of ``a`` (A, d) and ``b`` (B, d).

    ``|a|^2 - 2 a.b + |b|^2`` clamped at 0, in float32. The terms are added
    in place on the product, which gives the same bits as the expression
    written out (negation and scaling by 2 are exact) with one (A, B)
    buffer instead of three.
    """
    a = a.float()
    b = b.float()
    a2 = (a * a).sum(-1, keepdim=True)  # (A, 1)
    b2 = (b * b).sum(-1, keepdim=True).T  # (1, B)
    d = a @ b.T
    return d.mul_(-2.0).add_(a2).add_(b2).clamp_(min=0.0)


def batched_rowwise_sqdist(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(B, d) queries vs (B, M, d) gathered rows -> (B, M) squared distances."""
    diff = rows.float() - q.float()[:, None, :]
    return (diff * diff).sum(-1)


def squared_l2_one_to_many(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Squared L2 between a single query (d,) and rows of ``x`` (N, d)."""
    diff = x.float() - q.float()[None, :]
    return (diff * diff).sum(-1)


def neg_inner_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Negative inner product (smaller is more similar), (A, d) x (B, d)."""
    return -(a.float() @ b.float().T)


def cosine_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """1 - cosine similarity, (A, d) x (B, d); norms offset by 1e-12."""
    an = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-12)
    bn = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True) + 1e-12)
    return 1.0 - an @ bn.T
