"""GNN-family cells (port of ``repro.archs.gnn``): MACE in the four graph
regimes, each one AdamW step (lr 1e-3, gradients clipped at global norm
1.0) of the energy + force objective through ``make_train_step``.

  * full_graph_sm: cora-scale full batch;
  * minibatch_lg: reddit-scale sampled training, fixed-shape subgraphs of
    the fanout sampler's sizes (``models/gnn/sampler.py``);
  * ogb_products: 2.4M x 62M full batch in the dst-partitioned layout
    (``models/gnn/distributed.py``), in bf16;
  * molecule: batched small graphs (128 molecules), a per-graph energy.

Non-molecular graphs carry no 3-D coordinates; positions are synthesized
and ``d_feat`` enters through the feature projection. ``make_cell(shape,
mi)`` takes ``mi`` for the dst-partitioned layout's shards (default: one
shard), each on its mesh position's device; the other modes run on the
model's device, as the reference replicates them. A cell over a mesh
carries the reference's parameter layout in ``specs`` (every leaf whole);
in the dst-partitioned layout its parameters live as replicas, one part a
distinct device (``make_replicas``), from ``make_inputs`` on, or from a
whole model's first step, with their AdamW state beside them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.archs.base import Arch, CellSpec
from repro_torch.common.device import make_generator, resolve_device
from repro_torch.data.pipeline import gnn_batch
from repro_torch.distributed.meshinfo import single_device_meshinfo
from repro_torch.models.gnn import mace as gm
from repro_torch.models.gnn.distributed import (
    dst_partitioned_loss,
    make_replicas,
    partition_by_destination,
    shard_devices,
)
from repro_torch.models.gnn.sampler import subgraph_sizes
from repro_torch.train.optimizer import adamw
from repro_torch.train.train_step import init_state, make_train_step


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


GNN_SHAPES: Dict[str, dict] = {
    "full_graph_sm": dict(kind="train", n_nodes=2708, n_edges=10556, d_feat=1433, mode="simple"),
    "minibatch_lg": dict(kind="train", batch_nodes=1024, fanouts=(15, 10), d_feat=602,
                         mode="sampled"),
    "ogb_products": dict(kind="train", n_nodes=2_449_029, n_edges=61_859_140, d_feat=100,
                         mode="dst_partitioned"),
    "molecule": dict(kind="train", n_nodes=30, n_edges=64, batch=128, mode="batched"),
}


def graph_size(sh: dict, n_shards: int = 1) -> tuple[int, int]:
    """(nodes, edges) of a shape's batch: the sampled subgraph's sizes,
    ``batch`` molecules, or the graph's own, rounded up to the shards in
    the dst-partitioned layout."""
    mode = sh["mode"]
    if mode == "sampled":
        return subgraph_sizes(sh["batch_nodes"], sh["fanouts"])
    if mode == "batched":
        return sh["n_nodes"] * sh["batch"], sh["n_edges"] * sh["batch"]
    if mode == "dst_partitioned":
        return _round_up(sh["n_nodes"], n_shards), _round_up(sh["n_edges"], n_shards)
    return sh["n_nodes"], sh["n_edges"]


class GNNArch(Arch):
    family = "gnn"

    def __init__(self, cfg: gm.MACEConfig, shapes: Optional[Dict[str, dict]] = None):
        self.name = cfg.name
        self.base_cfg = cfg
        self.shapes = shapes or GNN_SHAPES

    def shape_names(self):
        return list(self.shapes)

    def cfg_for(self, shape: str) -> gm.MACEConfig:
        """The shape's config: its ``d_feat``; bf16 compute in the
        dst-partitioned layout, float32 otherwise."""
        sh = self.shapes[shape]
        compute = torch.bfloat16 if sh["mode"] == "dst_partitioned" else torch.float32
        return dataclasses.replace(self.base_cfg, d_feat=sh.get("d_feat", 0),
                                   compute_dtype=compute)

    def loss_fn(self, shape: str, mi=None):
        """(model, batch) -> (loss, metrics) of the shape's mode."""
        sh = self.shapes[shape]
        cfg = self.cfg_for(shape)
        if sh["mode"] == "dst_partitioned":
            def loss(model, batch):
                mesh = mi or single_device_meshinfo(model.embed.weight.device)
                return dst_partitioned_loss(model, cfg, mesh, batch)
            return loss
        if sh["mode"] == "batched":
            return lambda model, batch: gm.loss(model, cfg, dict(batch, n_graphs=sh["batch"]))
        return lambda model, batch: gm.loss(model, cfg, batch)

    def batch(self, shape: str, seed: int = 0, step: int = 0, device="cuda", mi=None) -> dict:
        """``gnn_batch`` at the shape's sizes (the dst-partitioned layout's
        edges grouped by destination shard, ``partition_by_destination``)."""
        sh = self.shapes[shape]
        cfg = self.cfg_for(shape)
        n_shards = len(shard_devices(mi)) if mi is not None else 1
        n, e = graph_size(sh, n_shards)
        batch = gnn_batch(seed, step, n, e, cfg.n_species, cfg.d_feat, sh.get("batch", 1),
                          device=device)
        if sh["mode"] == "dst_partitioned":
            batch = partition_by_destination(batch, n_shards)
        return batch

    def make_cell(self, shape: str, mi=None) -> CellSpec:
        """``fn(model, opt_state, batch) -> (model, opt_state, metrics)``;
        ``make_inputs(seed, device)`` draws the model from ``seed``
        (``init_params``), AdamW's initial state, and ``batch(shape, seed,
        0)``."""
        cfg = self.cfg_for(shape)
        opt = adamw(lr=1e-3)
        mesh = mi is not None and len(mi.mesh.devices) > 1
        replicas = mesh and self.shapes[shape]["mode"] == "dst_partitioned"

        def resident(model):
            return make_replicas(model, cfg, mi) if replicas else model

        def make_inputs(seed: int = 0, device="cuda"):
            dev = resolve_device(device)
            model = resident(gm.init_params(make_generator(dev, seed), cfg, device=dev))
            return model, init_state(opt, model), self.batch(shape, seed, 0, dev, mi)

        step = make_train_step(self.loss_fn(shape, mi), opt, clip_norm=1.0)

        def train_step(model, opt_state, batch, **kw):
            # a model built whole turns into replicas at its first mesh step
            return step(resident(model), opt_state, batch, **kw)

        return CellSpec(name=f"{self.name}:{shape}", kind="train",
                        fn=train_step if replicas else step, make_inputs=make_inputs,
                        specs=gm.param_specs(cfg, mi) if mesh else None)
