"""Product quantization (paper §3 'PQ', Jégou et al. 2011); port of
``repro.core.pq``.

Codebook training, the per-query ADC table and the paper's PQ baseline: a
constrained linear scan that ranks every vector satisfying the constraint
by its asymmetric distance (ADC). The scan's hot loop is the ``pq_adc``
kernel (``use_kernel=True``) or ``PQBackend.scan_all``, which shares its
(codes, LUT) bundle and formula with the PQ graph traversal
(``SearchParams.approx == "pq"``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.common.device import check_generator
from repro_torch.common.kmeans import kmeans
from repro_torch.core.constraints import make_satisfied_fn
from repro_torch.core.types import Corpus
from repro_torch.kernels.pq_adc import pq_adc


@dataclass(frozen=True)
class PQIndex:
    codebooks: torch.Tensor  # (m_sub, n_cent, d_sub) float32
    codes: torch.Tensor  # (n, m_sub) int32, values < n_cent


def default_m_sub(d: int, preferred: tuple[int, ...] = (16, 8, 4, 2)) -> int:
    """Largest conventional subspace count that divides ``d`` (fallback 1)."""
    for m in preferred:
        if d % m == 0:
            return m
    return 1


def pq_train(generator: torch.Generator, vectors, m_sub: int = 16, n_cent: int = 256,
             iters: int = 20) -> PQIndex:
    """k-means per subspace, one after another on ``generator`` (the
    reference vmaps over subspaces with split threefry keys, whose draws the
    port cannot reproduce: parity tests carry its codebooks across)."""
    n, d = vectors.shape
    if d % m_sub != 0:
        raise ValueError(f"d={d} not divisible by m_sub={m_sub}")
    check_generator(generator, vectors.device)
    d_sub = d // m_sub
    sub = vectors.float().reshape(n, m_sub, d_sub)
    cents, assigns = [], []
    for s in range(m_sub):
        c, a = kmeans(generator, sub[:, s].contiguous(), n_cent, iters)
        cents.append(c)
        assigns.append(a)
    return PQIndex(codebooks=torch.stack(cents), codes=torch.stack(assigns, -1).contiguous())


def adc_table(index: PQIndex, queries) -> torch.Tensor:
    """(B, d) -> (B, m_sub, n_cent) LUT of squared subspace distances."""
    b = queries.shape[0]
    m_sub, n_cent, d_sub = index.codebooks.shape
    qs = queries.float().reshape(b, m_sub, 1, d_sub)
    diff = qs - index.codebooks[None]  # (B, m_sub, n_cent, d_sub)
    return (diff * diff).sum(-1)


def adc_scan(index: PQIndex, lut, use_kernel: bool = False) -> torch.Tensor:
    """(B, m_sub, n_cent) LUT -> (B, n) approximate squared distances."""
    if use_kernel:
        return pq_adc(lut.contiguous(), index.codes)
    from repro_torch.core.engine.context import PQBackend  # the context imports this module

    return PQBackend(codes=index.codes, lut=lut).scan_all()


def pq_constrained_search(corpus: Corpus, index: PQIndex, queries, constraint, k: int,
                          use_kernel: bool = False):
    """Constrained linear PQ scan: filter all n vectors, rank by ADC.

    Returns ((B, k) ADC distances, (B, k) int32 ids), ascending; slots
    without a satisfying vector hold (+inf, -1). Equal distances keep the
    lower id first, the order of the reference's ``lax.top_k``.
    """
    satisfied = make_satisfied_fn(constraint, corpus)
    b = queries.shape[0]
    lut = adc_table(index, queries)
    d = adc_scan(index, lut, use_kernel=use_kernel)  # (B, n)
    ids = torch.arange(corpus.n, dtype=torch.int32, device=queries.device)
    d = torch.where(satisfied(ids[None, :].expand(b, -1)), d, float("inf"))
    dists, pos = torch.sort(d, dim=-1, stable=True)
    dists, pos = dists[:, :k], pos[:, :k]
    found = torch.where(torch.isfinite(dists), pos.to(torch.int32), -1)
    return dists, found
