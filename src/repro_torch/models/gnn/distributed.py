"""Destination-partitioned MACE for full-graph training at ogb-products scale
(port of ``repro.models.gnn.distributed``), on one controller over a
``DeviceMesh``.

The layout: node state and destination nodes split into equal blocks, one
a shard, over the mesh's positions flattened in the reference's order
(the data axes, then the model axis); every edge lives on the shard that
owns its receiver, in an equal-length block of the edge arrays, with
shard-local receiver ids (``partition_by_destination`` builds such a
batch from a global edge list). Each layer reads the senders' features
from the whole of h, the reference's ``all_gather``, here the shards'
blocks concatenated in shard order on each shard's device; the A-basis
accumulates strictly locally. The shards' partial energies are summed in
shard order on the first shard's device (the reference's ``psum``).

Each shard's work runs on its mesh position's device with the parameters
there (``on_device``). A train cell over a mesh holds every parameter as
replicas, one part a distinct device (``make_replicas``: the reference's
specs leave every leaf whole), and a shard reads its device's part in
place; the step sums the replicas' gradients in part order and updates
each part on its device (``train/train_step.py``). A model whose
parameters are whole has them moved to the shard's device for the call
(a move to the device a parameter is on is the parameter itself). Its
block of nodes and edges and the gathered h are moved there too, and the
forces come by autograd back through every move. The shards run one
after another from one controller.

Memory: each (layer, shard) runs under its own checkpoint where autograd
records, so the forward holds one shard's edge tensors at a time and
keeps only the (N / shards, K) block states between them.
"""
from __future__ import annotations

import copy
import functools

import torch
from torch import nn

from repro_torch.distributed.layout import Resident, make_resident
from repro_torch.distributed.meshinfo import sum_in_order

from repro_torch.models.gnn.mace import (
    MACE,
    MACEConfig,
    edge_geometry,
    embed_inputs,
    forces_of,
    interaction,
    maybe_remat,
    mlp_apply,
    objective,
    param_specs,
)
from repro_torch.roofline import collectives


def shard_devices(mi) -> list:
    """The mesh's devices in the flattened shard order: the data axes, then
    the model axis, row-major."""
    return list(mi.mesh.groups(mi.tp_axis).reshape(-1))


def partition_by_destination(batch: dict, n_shards: int) -> dict:
    """A batch with global ``senders`` / ``receivers`` -> the same graph in the
    dst-partitioned layout: the edges grouped by their receiver's block of
    N / n_shards nodes (stable, in edge order), each group padded with -1
    to the longest, ``receivers_local`` the receivers' ids within their
    block; ``receivers`` dropped. N must split into n_shards blocks."""
    n = batch["positions"].shape[0]
    if n % n_shards:
        raise ValueError(f"{n} nodes do not split into {n_shards} shards")
    n_local = n // n_shards
    recv = batch["receivers"].long()
    send = batch["senders"].long()
    ok = (recv >= 0) & (send >= 0)
    shard = torch.where(ok, recv // n_local, torch.full_like(recv, n_shards))
    order = torch.sort(shard, stable=True).indices
    counts = torch.bincount(shard, minlength=n_shards + 1)[:n_shards]
    width = max(int(counts.max()), 1)
    starts = torch.cumsum(counts, 0) - counts
    dev = recv.device
    senders = torch.full((n_shards, width), -1, dtype=torch.int32, device=dev)
    local = torch.full((n_shards, width), -1, dtype=torch.int32, device=dev)
    for i in range(n_shards):
        rows = order[int(starts[i]) : int(starts[i]) + int(counts[i])]
        senders[i, : rows.numel()] = send[rows].int()
        local[i, : rows.numel()] = (recv[rows] - i * n_local).int()
    out = {k: v for k, v in batch.items() if k != "receivers"}
    out["senders"] = senders.reshape(-1)
    out["receivers_local"] = local.reshape(-1)
    return out


def make_replicas(model: MACE, cfg: MACEConfig, mi) -> MACE:
    """Over ``mi`` (a mesh of more than one position) every parameter of
    ``model`` becomes ``Resident`` replicas of its spec (whole), one part a
    distinct device of the mesh, in place; a model already so, or any model
    on one position, is left as it is."""
    specs = param_specs(cfg, mi)
    return make_resident(model, specs, mi, list(specs))


def _moved(module: nn.Module, dev) -> nn.Module:
    """A shallow copy of ``module`` (and of its submodules) whose parameters
    are on ``dev``: a resident parameter's part there, any other the
    original moved there; the original is left untouched."""
    clone = copy.copy(module)
    clone._parameters = {k: None if p is None else p.to(dev)
                         for k, p in module._parameters.items()}
    clone._modules = {}
    for k, m in module._modules.items():
        if isinstance(m, Resident):
            clone._parameters[k] = m.part_on(dev)
        else:
            clone._modules[k] = _moved(m, dev)
    return clone


def on_device(module: nn.Module, dev, fn, *args):
    """fn(module, *args) with ``module``'s parameters on ``dev``: the work of
    a mesh position reads its device's replica in place (``make_replicas``),
    or a copy of a whole weight, and the gradients flow back to them. The
    shallow copy shares nothing that changes with ``module``: autograd
    recomputes the shards' checkpoints on one thread a device, at once, and
    each builds its copy again."""
    return fn(_moved(module, dev), *args)


def _shard_layer(lp, h_local, h_global, positions, senders, receivers_local, *,
                 cfg: MACEConfig, lo: int):
    """One layer on one shard: its edges (global senders, local receivers)
    from the gathered h -> its block's new state."""
    n_local = h_local.shape[0]
    valid = (senders >= 0) & (receivers_local >= 0)
    s = torch.clamp_min(senders, 0).long()
    r = torch.clamp_min(receivers_local, 0).long()
    rbf, rhat, y2 = edge_geometry(cfg, positions[lo : lo + n_local][r], positions[s],
                                  r + lo == s, h_local.dtype)
    return h_local + interaction(lp, cfg, h_global, rbf, rhat, y2, s, r, valid, n_local)


def dst_partitioned_energy(model: MACE, cfg: MACEConfig, mi, batch: dict):
    """Total energy (a 0-d tensor on the first shard's device) with the
    dst-partitioned layout over ``mi``'s shards, each on its position's
    device."""
    devs = shard_devices(mi)
    n_shards = len(devs)
    feat = batch["node_feat"] if cfg.d_feat else batch["species"]
    positions = batch["positions"].to(cfg.compute_dtype)
    n_local = positions.shape[0] // n_shards
    e_local = batch["senders"].shape[0] // n_shards
    at = {dev: positions.to(dev) for dev in dict.fromkeys(devs)}
    edges = [(batch["senders"][i * e_local : (i + 1) * e_local].to(dev),
              batch["receivers_local"][i * e_local : (i + 1) * e_local].to(dev))
             for i, dev in enumerate(devs)]
    h = [on_device(model.embed, dev, lambda emb, f: emb(embed_inputs(cfg, f)),
                   feat[i * n_local : (i + 1) * n_local].to(dev))
         for i, dev in enumerate(devs)]
    for lp in model.layers:
        # the all-gather, in shard order, once a device
        h_global = {dev: torch.cat([x.to(dev) for x in h]) for dev in at}
        collectives.record("all-gather", next(iter(h_global.values())))
        h = [maybe_remat(cfg.remat_layers, functools.partial(
                 on_device, lp, dev, functools.partial(_shard_layer, cfg=cfg, lo=i * n_local)),
                 h[i], h_global[dev], at[dev], *edges[i])
             for i, dev in enumerate(devs)]
    parts = [on_device(model.readout, dev, lambda r, x: mlp_apply(r, x)[..., 0].sum(), h[i])
             for i, dev in enumerate(devs)]
    return sum_in_order(parts, devs[0])  # the psum, in shard order


def dst_partitioned_loss(model: MACE, cfg: MACEConfig, mi, batch: dict):
    """Energy + force objective under the dst-partitioned layout -> (total,
    {"loss", "e_loss", "f_loss"})."""
    e, f = forces_of(lambda pos: dst_partitioned_energy(model, cfg, mi,
                                                        dict(batch, positions=pos)),
                     batch["positions"])
    return objective(e, f, batch)
