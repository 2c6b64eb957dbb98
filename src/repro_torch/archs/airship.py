"""AIRSHIP serve shapes — the paper's own workload (port of
``repro.archs.airship``: ``AirshipServeConfig``, ``AIRSHIP_SHAPES`` and the
search of ``AirshipArch.make_cell``).

Corpus + per-shard subgraphs are split by rows over ``model``
(scatter-search-merge, core/distributed.py); query batches split over the
data axes. The serve step is the full constrained graph search
(mode=prefer) + one gather-and-merge of every shard's top-k. Plain
functions: no ``AirshipArch`` in the registry (``archs/base.py``) and no
abstract shapes; the dry run's AIRSHIP cells are ROADMAP item 14e, part 3.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core.distributed import make_distributed_search
from repro_torch.core.types import SearchParams
from repro_torch.distributed.meshinfo import MeshInfo


@dataclasses.dataclass(frozen=True)
class AirshipServeConfig:
    name: str = "airship-sift1m"
    n: int = 1_000_000
    dim: int = 128
    degree: int = 32
    n_labels: int = 10
    sample_per_shard: int = 128
    params: SearchParams = SearchParams(
        mode="prefer", k=10, ef_result=128, ef_sat=128, ef_other=128,
        n_start=32, max_iters=512,
    )


AIRSHIP_SHAPES: Dict[str, dict] = {
    "serve_256": dict(kind="serve", batch=256),
    "serve_bulk_8k": dict(kind="serve", batch=8192),
    # ADC traversal + exact re-rank; m_sub = 16 codes split with the
    # corpus rows.
    "serve_256_pq": dict(kind="serve", batch=256, pq=True),
    # Beam-parallel engine: 4 pops/query/iteration.
    "serve_256_beam4": dict(kind="serve", batch=256, beam=4),
    # The fused candidate pipeline forced on: one fused_expand pass per
    # iteration + sorted-merge frontier updates.
    "serve_256_fused": dict(kind="serve", batch=256, fuse="on"),
    # The PQ backend through the fused pipeline (fused_expand_adc).
    "serve_256_pq_fused": dict(kind="serve", batch=256, pq=True, fuse="on"),
}


def shape_params(cfg: AirshipServeConfig, shape: str, device=None) -> SearchParams:
    """``cfg.params`` with ``shape``'s backend, beam and fuse settings; on a
    CUDA ``device`` the unfused distances go through the gather_distance
    kernel (``use_kernel``)."""
    sh = AIRSHIP_SHAPES[shape]
    params = cfg.params
    if sh.get("pq", False):
        params = dataclasses.replace(params, approx="pq")
    if sh.get("beam", 0) > 1:
        params = dataclasses.replace(params, beam_width=sh["beam"])
    if sh.get("fuse"):
        params = dataclasses.replace(params, fuse_expand=sh["fuse"])
    if device is not None and torch.device(device).type == "cuda":
        params = dataclasses.replace(params, use_kernel=True)
    return params


def serve_search(cfg: AirshipServeConfig, shape: str, mi: MeshInfo, *, constraint_type=None):
    """The distributed search of ``shape`` over ``mi``'s mesh:
    ``fn(index_s, queries, constraint, pq_index=None)`` (see
    ``core.distributed.make_distributed_search``), queries split over the
    data axes. Label-set constraints unless ``constraint_type`` says
    otherwise."""
    params = shape_params(cfg, shape, mi.mesh.devices[0])
    kw = {} if constraint_type is None else dict(constraint_type=constraint_type)
    return make_distributed_search(mi.mesh, params, batch_axes=mi.dp_axes, **kw)
