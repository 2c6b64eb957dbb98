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

Memory: each (layer, shard) runs under its own checkpoint where autograd
records, so the forward holds one shard's edge tensors at a time and
keeps only the (N / shards, K) block states between them. The shards run
one after another on the parameters' device: every position of the mesh
must be that device (a mesh of one card).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.models.gnn.mace import (
    MACE,
    MACEConfig,
    edge_geometry,
    forces_of,
    interaction,
    maybe_remat,
    mlp_apply,
    node_features,
    objective,
)


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


def _shard_layer(lp, cfg: MACEConfig, h_local, h_global, positions, senders, receivers_local,
                 lo: int):
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
    """Total energy (a 0-d tensor) with the dst-partitioned layout over
    ``mi``'s shards. Every position of the mesh must be the parameters'
    device (one card holds every shard; spreading them over cards is
    training over a mesh, ROADMAP item 14e)."""
    dev = model.embed.weight.device
    n_shards = len(shard_devices(mi))
    if any(d != dev for d in shard_devices(mi)):
        raise ValueError(f"every shard must be on the parameters' device {dev}: "
                         f"{shard_devices(mi)}")
    feat = batch["node_feat"] if cfg.d_feat else batch["species"]
    positions = batch["positions"].to(cfg.compute_dtype)
    n_local = positions.shape[0] // n_shards
    e_local = batch["senders"].shape[0] // n_shards
    h = [node_features(model, cfg, feat[i * n_local : (i + 1) * n_local])
         for i in range(n_shards)]
    for lp in model.layers:
        h_global = torch.cat(h)  # the all-gather, in shard order
        h = [maybe_remat(cfg.remat_layers, functools.partial(_shard_layer, lp, cfg), h[i],
                         h_global, positions, batch["senders"][i * e_local : (i + 1) * e_local],
                         batch["receivers_local"][i * e_local : (i + 1) * e_local], i * n_local)
             for i in range(n_shards)]
    total = None
    for x in h:  # the psum, in shard order
        part = mlp_apply(model.readout, x)[..., 0].sum()
        total = part if total is None else total + part
    return total


def dst_partitioned_loss(model: MACE, cfg: MACEConfig, mi, batch: dict):
    """Energy + force objective under the dst-partitioned layout -> (total,
    {"loss", "e_loss", "f_loss"})."""
    e, f = forces_of(lambda pos: dst_partitioned_energy(model, cfg, mi,
                                                        dict(batch, positions=pos)),
                     batch["positions"])
    return objective(e, f, batch)
