"""Deterministic synthetic batches (port of ``repro.data.pipeline``): the LM,
DLRM, DeepFM, SASRec, two-tower and GNN generators, and ``shard_batch``,
which splits a batch over a mesh's data groups.

Every batch is a pure function of (seed, step), drawn with numpy exactly
as the reference draws it, so the port's batches equal the reference's
bit for bit; only the last step moves them to ``device``. A restarted run
that resumes at step N regenerates the batches it would have seen: no
data state is checkpointed.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.distributed.meshinfo import MeshInfo


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def _tensor(a: np.ndarray, dev: torch.device, dtype=np.int32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)


def _sparse(r: np.random.Generator, batch: int, vocabs) -> np.ndarray:
    return np.stack([r.integers(0, v, size=batch) for v in vocabs], axis=1)


def lm_batch(seed: int, step: int, batch: int, seq: int, vocab: int, device="cuda") -> dict:
    """{"tokens": (batch, seq) int32} on ``device``: a zipf(1.3) marginal
    over the vocab, clamped at vocab - 1."""
    dev = resolve_device(device)
    z = _rng(seed, step).zipf(1.3, size=(batch, seq)).astype(np.int64)
    return {"tokens": _tensor(np.minimum(z, vocab - 1), dev)}


def dlrm_batch(seed: int, step: int, batch: int, n_dense: int, vocabs, device="cuda") -> dict:
    """{"dense": (batch, n_dense) float32 normal, "sparse": (batch, F) int32
    uniform in each field's vocab, "label": (batch,) float32 0 / 1} on
    ``device``."""
    dev = resolve_device(device)
    r = _rng(seed, step)
    sparse = _sparse(r, batch, vocabs)
    return {
        "dense": _tensor(r.normal(size=(batch, n_dense)), dev, np.float32),
        "sparse": _tensor(sparse, dev),
        "label": _tensor(r.integers(0, 2, size=batch), dev, np.float32),
    }


def deepfm_batch(seed: int, step: int, batch: int, vocabs, device="cuda") -> dict:
    """{"sparse": (batch, F) int32, "label": (batch,) float32 0 / 1} on
    ``device``."""
    dev = resolve_device(device)
    r = _rng(seed, step)
    sparse = _sparse(r, batch, vocabs)
    return {
        "sparse": _tensor(sparse, dev),
        "label": _tensor(r.integers(0, 2, size=batch), dev, np.float32),
    }


def sasrec_batch(seed: int, step: int, batch: int, seq: int, vocab: int, device="cuda") -> dict:
    """{"seq", "pos", "neg"}: (batch, seq) int32 item ids in [1, vocab) on
    ``device``; ``pos`` is ``seq`` shifted by one (the next item), ``neg``
    drawn on its own."""
    dev = resolve_device(device)
    r = _rng(seed, step)
    seqs = r.integers(1, vocab, size=(batch, seq + 1)).astype(np.int32)
    return {
        "seq": _tensor(seqs[:, :-1], dev),
        "pos": _tensor(seqs[:, 1:], dev),
        "neg": _tensor(r.integers(1, vocab, size=(batch, seq)), dev),
    }


def sasrec_serve_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
                       n_candidates: int, device="cuda") -> dict:
    """{"seq": (batch, seq), "candidates": (batch, n_candidates)} int32 item
    ids in [1, vocab) on ``device``: ``seq`` is ``sasrec_batch``'s at the
    same (seed, step), the candidates are drawn after it. The reference
    gives the serve cells' inputs as shapes only; this is the port's draw."""
    dev = resolve_device(device)
    r = _rng(seed, step)
    seqs = r.integers(1, vocab, size=(batch, seq + 1)).astype(np.int32)
    return {
        "seq": _tensor(seqs[:, :-1], dev),
        "candidates": _tensor(r.integers(1, vocab, size=(batch, n_candidates)), dev),
    }


def two_tower_batch(seed: int, step: int, batch: int, user_vocab: int, item_vocab: int,
                    hist: int, device="cuda") -> dict:
    """{"user_id": (batch,), "hist": (batch, hist), "item_id": (batch,)}
    int32 on ``device``; about 30% of the history slots are -1 (ragged
    histories as padding)."""
    dev = resolve_device(device)
    r = _rng(seed, step)
    h = r.integers(0, item_vocab, size=(batch, hist)).astype(np.int32)
    h[r.random(size=h.shape) < 0.3] = -1
    return {
        "user_id": _tensor(r.integers(0, user_vocab, size=batch), dev),
        "hist": _tensor(h, dev),
        "item_id": _tensor(r.integers(0, item_vocab, size=batch), dev),
    }


def gnn_batch(seed: int, step: int, n_nodes: int, n_edges: int, n_species: int = 32,
              d_feat: int = 0, n_graphs: int = 1, device="cuda") -> dict:
    """A random graph on ``device``: ``positions`` (N, 3) normal,
    ``senders`` / ``receivers`` (E,) uniform, ``energy`` (G,) normal,
    ``forces`` (N, 3) normal * 0.1 (float32), then ``node_feat`` (N,
    d_feat) normal or ``species`` (N,) uniform, and with n_graphs > 1
    ``node_graph`` (N,) sorted graph ids and ``n_graphs``."""
    dev = resolve_device(device)
    if dev.type == "meta":  # the dry run's shapes: nothing drawn
        return _meta_gnn_batch(n_nodes, n_edges, d_feat, n_graphs, dev)
    r = _rng(seed, step)
    out = {
        "positions": _tensor(r.normal(size=(n_nodes, 3)), dev, np.float32),
        "senders": _tensor(r.integers(0, n_nodes, size=n_edges), dev),
        "receivers": _tensor(r.integers(0, n_nodes, size=n_edges), dev),
        "energy": _tensor(r.normal(size=(n_graphs,)), dev, np.float32),
        "forces": _tensor(r.normal(size=(n_nodes, 3)) * 0.1, dev, np.float32),
    }
    if d_feat:
        out["node_feat"] = _tensor(r.normal(size=(n_nodes, d_feat)), dev, np.float32)
    else:
        out["species"] = _tensor(r.integers(0, n_species, size=n_nodes), dev)
    if n_graphs > 1:
        out["node_graph"] = _tensor(np.sort(r.integers(0, n_graphs, size=n_nodes)), dev)
        out["n_graphs"] = n_graphs
    return out


def _meta_gnn_batch(n_nodes, n_edges, d_feat, n_graphs, dev) -> dict:
    """``gnn_batch``'s leaves as meta tensors of their shapes and dtypes."""
    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    f32 = torch.float32
    out = {"positions": empty(n_nodes, 3, dtype=f32), "senders": empty(n_edges),
           "receivers": empty(n_edges), "energy": empty(n_graphs, dtype=f32),
           "forces": empty(n_nodes, 3, dtype=f32)}
    if d_feat:
        out["node_feat"] = empty(n_nodes, d_feat, dtype=f32)
    else:
        out["species"] = empty(n_nodes)
    if n_graphs > 1:
        out["node_graph"] = empty(n_nodes)
        out["n_graphs"] = n_graphs
    return out


def shard_batch(batch: dict, mi: MeshInfo) -> list:
    """``batch`` over ``mi``'s data groups: one dict a group, in group order
    (the data axes flattened row-major, as ``DeviceMesh.groups`` orders
    them), on the group's first device. A leaf whose leading axis the data
    axes divide (``axes_if_divisible``) is split into equal blocks, block g
    to group g; any other leaf (a scalar, a leading axis they do not
    divide) goes whole to every group, as the reference replicates it. A
    block is a view where its group's device is the leaf's."""
    heads = mi.mesh.groups(mi.tp_axis)[:, 0]
    groups = [dict() for _ in heads]
    for k, x in batch.items():
        split = (isinstance(x, torch.Tensor) and x.dim() > 0
                 and mi.axes_if_divisible(x.shape[0], mi.dp_axes) is not None)
        rows = x.shape[0] // len(heads) if split else 0
        for g, dev in enumerate(heads):
            blk = x[g * rows : (g + 1) * rows] if split else x
            groups[g][k] = blk.to(dev) if isinstance(blk, torch.Tensor) else blk
    return groups
