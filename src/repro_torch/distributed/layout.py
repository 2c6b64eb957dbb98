"""Parameter layouts over a ``DeviceMesh`` (the port's counterpart of the
reference's ``PartitionSpec`` / ``NamedSharding`` of a leaf).

A spec is a tuple with one entry a dimension of a leaf: an axis name, a
tuple of axis names (the dimension split over their product, the first
outermost), or None (the dimension whole). A spec shorter than the leaf
leaves the trailing dimensions whole, as a ``PartitionSpec`` does.

``shard_shape`` is ``NamedSharding(mesh, spec).shard_shape(shape)``: it
raises where the axes do not divide a dimension. ``place`` gives every
mesh position, in the mesh's row-major order, its block of a tensor (a
view where the position is the tensor's device, else a copy there), and
``gather`` puts the blocks back together on the first position's device.
Positions that a spec does not split over hold the same block, as the
reference replicates it. ``grouped`` arranges ``place``'s blocks as
``DeviceMesh.groups`` arranges the devices.

The port's model code does not hold its parameters as blocks: one
controller keeps each parameter whole on the model's device, and the work
a position does reads its block through views and a ``.to`` (a model
shard's experts, a graph shard's layer). The recsys tables are read
through ``place`` with their specs, so a position receives the block its
spec names and no more (``models/recsys/models.py::mesh_lookup``);
``place`` and ``gather`` also carry a checkpoint onto a mesh
(``ckpt.checkpoint.restore(..., layout=...)``). ``place`` splits the
tensor dimension by dimension (``Tensor.split``), so the gradients of
all its blocks reach the tensor as one tensor of its shape.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.distributed.meshinfo import DeviceMesh, MeshInfo

Spec = Tuple  # one entry a dimension: None, an axis name or a tuple of names


def _mesh(mesh) -> DeviceMesh:
    return mesh.mesh if isinstance(mesh, MeshInfo) else mesh


def entry_axes(entry) -> tuple:
    """The axis names of one spec entry, flattened."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    out: tuple = ()
    for e in entry:
        out += entry_axes(e)
    return out


def _padded(spec: Spec, ndim: int) -> tuple:
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the leaf's {ndim} dimensions")
    return spec + (None,) * (ndim - len(spec))


def shard_shape(shape: Sequence[int], spec: Spec, mesh) -> tuple:
    """The shape of one block of a ``shape`` leaf laid out by ``spec``."""
    sizes = _mesh(mesh).shape
    out = []
    for dim, entry in zip(shape, _padded(spec, len(shape))):
        n = int(np.prod([sizes[a] for a in entry_axes(entry)], dtype=np.int64))
        if dim % n:
            raise ValueError(f"spec {spec} splits a dimension of {dim} into {n}: shape "
                             f"{tuple(shape)}")
        out.append(dim // n)
    return tuple(out)


def _block_index(ndim: int, spec: Spec, mesh: DeviceMesh, position: int) -> tuple:
    """The block coordinates, one a dimension, of ``position``'s block."""
    coords = dict(zip(mesh.axis_names, np.unravel_index(position, mesh.grid)))
    out = []
    for entry in _padded(spec, ndim):
        idx = 0
        for a in entry_axes(entry):
            idx = idx * mesh.shape[a] + int(coords[a])
        out.append(idx)
    return tuple(out)


def _block_slices(shape, spec: Spec, mesh: DeviceMesh, position: int) -> tuple:
    block = shard_shape(shape, spec, mesh)
    return tuple(slice(i * size, (i + 1) * size)
                 for i, size in zip(_block_index(len(shape), spec, mesh, position), block))


def _split(t: torch.Tensor, block: tuple) -> dict:
    """{block coordinates: view} of ``t`` cut into ``block``-shaped blocks,
    one ``Tensor.split`` a dimension."""
    out = {(): t}
    for d, size in enumerate(block):
        out = {idx + (i,): part for idx, x in out.items()
               for i, part in enumerate(x.split(size, d))}
    return out


def place(t: torch.Tensor, spec: Spec, mesh) -> list:
    """Each position's block of ``t`` under ``spec``, in the mesh's
    row-major order, on that position's device."""
    m = _mesh(mesh)
    blocks = _split(t, shard_shape(t.shape, spec, m))
    out = []
    for pos, dev in enumerate(m.devices):
        blk = blocks[_block_index(t.dim(), spec, m, pos)]
        out.append(blk if blk.device == dev else blk.to(dev))
    return out


def grouped(blocks: Sequence, mesh, axis: str) -> np.ndarray:
    """``place``'s blocks (or any one item a position, in row-major order) as
    an object array laid out as ``DeviceMesh.groups(axis)``: (the product of
    the other axes, the size of ``axis``)."""
    m = _mesh(mesh)
    grid = np.empty((len(blocks),), dtype=object)
    for i, b in enumerate(blocks):
        grid[i] = b
    grid = np.moveaxis(grid.reshape(m.grid), m.axis_names.index(axis), -1)
    return grid.reshape(-1, grid.shape[-1])


def gather(blocks: Sequence[torch.Tensor], spec: Spec, mesh, shape: Sequence[int]) -> torch.Tensor:
    """The whole leaf of ``shape`` from ``place``'s blocks, on the first
    block's device."""
    m = _mesh(mesh)
    out = torch.empty(tuple(shape), dtype=blocks[0].dtype, device=blocks[0].device)
    for pos, blk in enumerate(blocks):
        out[_block_slices(shape, spec, m, pos)] = blk.to(out.device)
    return out


def flat_specs(tree, prefix: str = "") -> Dict[str, Spec]:
    """A nested spec tree in the reference's structure ({"layers": [{"w":
    ..., "b": ...}]}) -> {the port's parameter name: spec}, names as
    ``train.reference_layout`` gives them (a layer's "w" -> ``weight``, its
    "b" -> ``bias``)."""
    out: Dict[str, Spec] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            out[port_name(path)] = tuple(node)

    walk(tree, tuple(prefix.split(".")) if prefix else ())
    return out


def port_name(path) -> str:
    """The port's parameter name of a reference tree path (the inverse of
    ``train.reference_key``): ("bot", "layers", 0, "w") ->
    ``bot.layers.0.weight``; a layer's "b" -> ``bias``."""
    parts = [str(p) for p in path]
    if parts[-1] == "w":
        parts[-1] = "weight"
    elif parts[-1] == "b" and len(path) > 1 and isinstance(path[-2], int):
        parts[-1] = "bias"
    return ".".join(parts)


def stacked(tree):
    """A layer's spec tree with a leading None on every leaf: the stacked
    (L, ...) leaves of a layer list (the reference's ``_prefix_none``)."""
    if isinstance(tree, dict):
        return {k: stacked(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [stacked(v) for v in tree]
    return (None,) + tuple(tree)
