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

The port's model code holds most parameters whole: one controller keeps
each on the model's device, and the work a position does reads its block
through views and a ``.to`` (a model shard's experts, a graph shard's
layer). The recsys tables are the exception: over a mesh each lives as
its blocks (``Blocks`` of a ``BlockLayout``, one part for each distinct
block on each device), resident on their positions from the train
cell's construction (``models/recsys/models.py::make_resident``), with
their gradients and optimizer moments as ``Blocks`` of the same layout.
``place`` and ``gather`` also carry a checkpoint onto a mesh and back
(``ckpt.checkpoint``). ``place`` splits the tensor dimension by dimension
(``Tensor.split``), so the gradients of all its blocks reach the tensor
as one tensor of its shape.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.distributed.meshinfo import DeviceMesh, MeshInfo
from repro_torch.roofline import collectives

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
    collectives.record("all-gather", out)
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


@dataclass(frozen=True)
class BlockLayout:
    """Where the blocks of a ``shape`` leaf under ``spec`` live on ``mesh``:
    one part for each distinct (block, device) pair, in the order of the
    positions that first hold it; ``index[pos]`` is position pos's part,
    ``block[i]`` part i's block coordinates (parts with equal coordinates
    on distinct devices are replicas of one block)."""

    shape: Tuple[int, ...]
    spec: Spec
    mesh: DeviceMesh
    index: Tuple[int, ...]
    block: Tuple[tuple, ...]
    devices: Tuple[torch.device, ...]

    @classmethod
    def of(cls, shape, spec: Spec, mesh) -> "BlockLayout":
        m = _mesh(mesh)
        shape = tuple(int(s) for s in shape)
        shard_shape(shape, spec, m)  # raises where the axes do not divide
        parts: Dict[tuple, int] = {}
        index, block, devices = [], [], []
        for pos, dev in enumerate(m.devices):
            coords = _block_index(len(shape), spec, m, pos)
            key = (coords, dev)
            if key not in parts:
                parts[key] = len(block)
                block.append(coords)
                devices.append(dev)
            index.append(parts[key])
        return cls(shape, tuple(spec), m, tuple(index), tuple(block), tuple(devices))

    def replicas(self) -> list:
        """The parts of each block, grouped, in part order."""
        groups: Dict[tuple, list] = {}
        for i, b in enumerate(self.block):
            groups.setdefault(b, []).append(i)
        return list(groups.values())


class Blocks:
    """A leaf held as its blocks on a mesh (``BlockLayout``): each part
    a tensor of the block's shape on its device. The optimizer's moments
    and the gradients of a resident table are ``Blocks`` of its layout."""

    def __init__(self, layout: BlockLayout, parts: Sequence[torch.Tensor]):
        if len(parts) != len(layout.block):
            raise ValueError(f"{len(parts)} parts for a layout of {len(layout.block)}")
        self.layout = layout
        self.parts = list(parts)

    @classmethod
    def place(cls, t: torch.Tensor, spec: Spec, mesh) -> "Blocks":
        """``t``'s blocks as parts of their own (contiguous copies: no part
        keeps ``t``'s storage alive)."""
        lay = BlockLayout.of(t.shape, spec, mesh)
        blocks = _split(t, shard_shape(t.shape, spec, lay.mesh))
        return cls(lay, [blocks[b].to(d, memory_format=torch.contiguous_format, copy=True)
                         for b, d in zip(lay.block, lay.devices)])

    @property
    def shape(self) -> torch.Size:
        return torch.Size(self.layout.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.layout.mesh.devices[0]

    def element_size(self) -> int:
        return self.parts[0].element_size()

    def positions(self) -> list:
        """Each position's part, in the mesh's row-major order."""
        return [self.parts[i] for i in self.layout.index]

    def whole(self) -> torch.Tensor:
        """The whole leaf on the first position's device (``gather``)."""
        return gather(self.positions(), self.layout.spec, self.layout.mesh, self.layout.shape)

    def map(self, fn) -> "Blocks":
        return Blocks(self.layout, [fn(p) for p in self.parts])

    @torch.no_grad()
    def copy_(self, src: "Blocks") -> "Blocks":
        """Write ``src``'s parts (``Blocks`` of this layout) into the parts."""
        for p, s in zip(self.parts, src.parts):
            p.copy_(s)
        return self
