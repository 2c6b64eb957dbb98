"""AIRSHIP serve Arch — the paper's own workload as a registry cell (port
of ``repro.archs.airship``).

Corpus + per-shard subgraphs are split by rows over ``model``
(scatter-search-merge, core/distributed.py); query batches split over the
data axes. The serve step is the full constrained graph search
(mode=prefer) + one gather-and-merge of every shard's top-k.
``AirshipArch.make_cell`` gives that step with a ``make_inputs`` that
builds the world it walks (on the meta device, tensors of its shapes and
nothing built) and the reference's layout of every argument in ``specs``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.archs.base import Arch, CellSpec
from repro_torch.common.device import resolve_device
from repro_torch.core.constraints import LabelSetConstraint, equal_constraint
from repro_torch.core.distributed import make_distributed_search, shard_corpus_for_mesh
from repro_torch.core.pq import PQIndex, default_m_sub, pq_train
from repro_torch.core.types import Corpus, GraphIndex, SearchParams
from repro_torch.data.synthetic import make_labeled_corpus, make_queries
from repro_torch.distributed.meshinfo import MeshInfo, single_device_meshinfo
from repro_torch.graph.index import build_partitioned_index


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


def shape_params(cfg: AirshipServeConfig, shape: str, device=None,
                 shapes: Optional[Dict[str, dict]] = None) -> SearchParams:
    """``cfg.params`` with ``shape``'s backend, beam and fuse settings (from
    ``shapes``, by default ``AIRSHIP_SHAPES``); on a CUDA ``device`` the
    unfused distances go through the gather_distance kernel
    (``use_kernel``)."""
    sh = (shapes or AIRSHIP_SHAPES)[shape]
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


def serve_search(cfg: AirshipServeConfig, shape: str, mi: MeshInfo, *, constraint_type=None,
                 shapes: Optional[Dict[str, dict]] = None):
    """The distributed search of ``shape`` over ``mi``'s mesh:
    ``fn(index_s, queries, constraint, pq_index=None)`` (see
    ``core.distributed.make_distributed_search``), queries split over the
    data axes. Label-set constraints unless ``constraint_type`` says
    otherwise."""
    params = shape_params(cfg, shape, mi.mesh.devices[0], shapes)
    kw = {} if constraint_type is None else dict(constraint_type=constraint_type)
    return make_distributed_search(mi.mesh, params, batch_axes=mi.dp_axes, **kw)


PQ_CENTROIDS = 256  # centroids a PQ subspace (the reference's PQIndex)
ARG_NAMES = ("index", "queries", "constraint", "pq_index")  # fn's positional arguments


class AirshipArch(Arch):
    family = "airship"

    def __init__(self, cfg: AirshipServeConfig, shapes: Optional[Dict[str, dict]] = None):
        self.name = cfg.name
        self.cfg = cfg
        self.shapes = shapes or AIRSHIP_SHAPES

    def shape_names(self):
        return list(self.shapes)

    def make_cell(self, shape: str, mi: Optional[MeshInfo] = None) -> CellSpec:
        """``fn(index, queries, constraint[, pq_index])``: ``serve_search``
        over ``mi`` (default: one CUDA device), the batch split over the data
        axes. ``make_inputs(seed, device)`` draws a labelled corpus of
        ``cfg.n`` rows rounded up to the model shards, builds each shard's
        exact subgraph (``build_partitioned_index``, through
        ``build_index``), the batch's queries with equal-label constraints
        and, for the PQ shapes, the PQ index (``pq_train``), and places the
        shards on ``mi`` (``shard_corpus_for_mesh``); on the meta device it
        returns tensors of those shapes and dtypes and builds nothing.
        ``specs`` gives the reference's in_specs of every argument tensor,
        keyed by its path from ``ARG_NAMES`` (``index.corpus.vectors``)."""
        cfg = self.cfg
        sh = self.shapes[shape]
        mi = mi or single_device_meshinfo()
        b = sh["batch"]
        use_pq = sh.get("pq", False)
        n_shards = mi.tp_size
        n = ((cfg.n + n_shards - 1) // n_shards) * n_shards
        n_words = (cfg.n_labels + 31) // 32
        m_sub = default_m_sub(cfg.dim)

        def make_inputs(seed: int = 0, device="cuda"):
            dev = resolve_device(device)
            if dev.type == "meta":
                def empty(*shape, dtype=torch.int32):
                    return torch.empty(shape, dtype=dtype, device=dev)

                corpus = Corpus(vectors=empty(n, cfg.dim, dtype=torch.float32), labels=empty(n))
                graph = GraphIndex(neighbors=empty(n, cfg.degree),
                                   sample_ids=empty(n_shards * cfg.sample_per_shard),
                                   entry_point=empty(n_shards))
                queries = empty(b, cfg.dim, dtype=torch.float32)
                cons = LabelSetConstraint(words=empty(b, n_words))
                pq = PQIndex(codebooks=empty(m_sub, PQ_CENTROIDS, cfg.dim // m_sub,
                                             dtype=torch.float32), codes=empty(n, m_sub))
            else:
                gen = torch.Generator(device=dev).manual_seed(seed)
                corpus = make_labeled_corpus(gen, cfg.n, cfg.dim, cfg.n_labels, device=dev)
                corpus, graph = build_partitioned_index(
                    gen, corpus, n_shards, degree=cfg.degree,
                    sample_size_per_shard=cfg.sample_per_shard, device=dev)
                queries, qlab = make_queries(gen, corpus, b)
                cons = equal_constraint(qlab, cfg.n_labels)
                pq = (pq_train(gen, corpus.vectors, m_sub=m_sub, n_cent=PQ_CENTROIDS)
                      if use_pq else None)
            args = (shard_corpus_for_mesh(corpus, graph, mi.mesh), queries, cons)
            return args + (pq,) if use_pq else args

        cspec = (mi.tp_axis,)
        bspec = (mi.axes_if_divisible(b, mi.dp_axes), None)
        specs = {**{f"index.corpus.{k}": cspec for k in ("vectors", "labels")},
                 **{f"index.graph.{k}": cspec
                    for k in ("neighbors", "sample_ids", "entry_point")},
                 "queries": bspec, "constraint.words": bspec}
        if use_pq:
            specs.update({"pq_index.codebooks": (), "pq_index.codes": cspec})
        return CellSpec(name=f"{self.name}:{shape}", kind="serve",
                        fn=serve_search(cfg, shape, mi, shapes=self.shapes),
                        make_inputs=make_inputs, specs=specs,
                        arg_names=ARG_NAMES[: 4 if use_pq else 3],
                        note="paper workload: constrained ANN serve (scatter-search-merge)"
                        + (" + PQ traversal (D4)" if use_pq else ""))
