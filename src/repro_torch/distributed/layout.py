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

Over a mesh of more than one position a train cell holds leaves as
their blocks (``Blocks`` of a ``BlockLayout``: one part for each distinct
block on each device), each part a parameter of a ``Resident`` module on
its position from the cell's construction (``make_resident``): the recsys
tables (``models/recsys/models.py``), every leaf of the LM
(``models/transformer/model.py``; its ``P(None)`` leaves one replica a
device) and MACE's parameters, one replica a device
(``models/gnn/distributed.py``). A stacked layer list's leaf is resident
as the (L, ...) blocks of its stacked spec, each layer reading its rows of
them. The step reads the parts in place (``tensor_parallel.py`` gathers a
model shard over the data positions where those split it, and runs the
positions one device holds as one batched call), their
gradients and optimizer state are ``Blocks`` of the same layout
(``train/train_step.py``), and a block held on several devices gets the
sum of its replicas' gradients. The recsys dense MLPs stay whole on the
model's device. ``place`` and ``gather`` also carry a checkpoint onto a
mesh and back (``ckpt.checkpoint``). ``place`` splits the tensor
dimension by dimension (``Tensor.split``), so the gradients of all its
blocks reach the tensor as one tensor of its shape.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch
from torch import nn

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
    collectives.record("all-gather", out, weights=True)
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
    def zeros(cls, shape, spec: Spec, mesh, dtype) -> "Blocks":
        """Zeros of a ``shape`` leaf laid out by ``spec``, each part on its
        device (an optimizer's state of a resident leaf)."""
        lay = BlockLayout.of(shape, spec, mesh)
        block = shard_shape(lay.shape, spec, lay.mesh)
        return cls(lay, [torch.zeros(block, dtype=dtype, device=d) for d in lay.devices])

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


@functools.lru_cache(maxsize=None)
def stacked_layout(layout: BlockLayout, n: int) -> BlockLayout:
    """The layout of ``n`` layers' ``layout`` leaves stacked on a leading
    whole axis: its parts are the layers' parts stacked, in the same order."""
    return BlockLayout.of((n,) + layout.shape, (None,) + tuple(layout.spec), layout.mesh)


class Resident(nn.Module):
    """A leaf held as its blocks over a mesh (``BlockLayout``): ``parts``,
    one trainable tensor for each distinct block on each device. A layer of
    a ``StackedLayers`` list holds its rows of the list's stacked parts.

    A read that knows which rows of a part it touches reports them
    (``touch``, a table's lookups); the step takes them with the part's
    gradient (``take_rows``), so that the replicas of a block add only
    those rows (``train_step``)."""

    def __init__(self, blocks: Blocks, requires_grad: bool = True):
        super().__init__()
        self.layout: BlockLayout = blocks.layout
        self.parts = nn.ParameterList([nn.Parameter(p, requires_grad=requires_grad)
                                       for p in blocks.parts])
        self._rows = None

    @property
    def shape(self) -> torch.Size:
        return torch.Size(self.layout.shape)

    @property
    def device(self) -> torch.device:
        return self.layout.mesh.devices[0]

    def blocks(self) -> Blocks:
        return Blocks(self.layout, list(self.parts))

    def grid(self, mi) -> np.ndarray:
        """Each position's part as ``DeviceMesh.groups(tp axis)`` lays out
        the devices: (data groups, model shards)."""
        return grouped(self.blocks().positions(), mi, mi.tp_axis)

    def part_on(self, dev) -> torch.Tensor:
        """The part on ``dev`` of a leaf that every position holds whole."""
        dev = torch.device(dev)
        if any(any(b) for b in self.layout.block):
            raise ValueError(f"a leaf split by {self.layout.spec} has no one part a device")
        return self.parts[self.layout.devices.index(dev)]

    def touch(self, part: int, rows: torch.Tensor) -> None:
        """Rows of part ``part`` that a read under autograd took, on the part's
        device (a superset does no harm: the replica sum adds every row it
        is given)."""
        p = self.parts[part]
        if torch.is_grad_enabled() and p.requires_grad:
            if self._rows is None:
                self._rows = {}
            self._rows.setdefault(part, []).append(rows.reshape(-1).to(p.device))

    def take_rows(self):
        """{part: the rows touched since the last call} or None where no read
        reported any."""
        rows, self._rows = self._rows, None
        return None if rows is None else {i: torch.cat(r) for i, r in rows.items()}


def whole_leaves(model: nn.Module) -> list:
    """The names of ``model``'s parameters that no ``Resident`` holds."""
    resident = {k for k, m in model.named_modules() if isinstance(m, Resident)}
    return [k for k, _ in model.named_parameters() if k.rsplit(".", 2)[0] not in resident]


def _rebind(parent: nn.Module, leaf: str, module: nn.Module) -> None:
    """``parent.<leaf>`` (a parameter) replaced by ``module``, in place; a
    ``ParameterDict`` keeps its keys' order."""
    if isinstance(parent, nn.ParameterDict):
        rest = {k: parent[k] for k in list(parent.keys())}
        for k in rest:
            del parent[k]
        for k, v in rest.items():
            parent[k] = module if k == leaf else v
    else:
        delattr(parent, leaf)
        parent.add_module(leaf, module)


def _port_spec(name: str, t: torch.Tensor, spec: Spec, stacked: bool = False) -> tuple:
    """``spec`` (of the reference's layout) for the port's tensor: a 2-D
    ``weight`` (``nn.Linear``, ``Dense``) is the reference's (in, out) ``w``
    transposed, so its last two entries swap."""
    full = _padded(spec, t.dim())
    if t.dim() == 2 + stacked and name.endswith("weight"):
        full = full[:-2] + (full[-1], full[-2])
    return full


def make_resident(model: nn.Module, specs: Dict[str, Spec], mi, names: Iterable[str]):
    """Each leaf of ``model`` that ``names`` names (as ``train.param_leaves``
    names it: a ``StackedLayers`` list's leaf as one, ``<list>.<parameter>``)
    becomes ``Resident`` blocks of ``specs[name]`` over ``mi``, in place, and
    its whole tensor is let go. A leaf already resident, and any model on
    one position, is left as it is."""
    from repro_torch.models.common.modules import StackedLayers

    if mi is None or len(_mesh(mi).devices) == 1:
        return model
    lists = {k + ".": m for k, m in model.named_modules() if isinstance(m, StackedLayers)}
    for name in names:
        pre = next((p for p in lists if name.startswith(p)), None)
        if pre is None:
            parent_name, _, leaf = name.rpartition(".")
            parent = model.get_submodule(parent_name) if parent_name else model
            p = getattr(parent, leaf)
            if isinstance(p, Resident):
                continue
            blocks = Blocks.place(p.detach(), _port_spec(name, p, specs[name]), mi)
            _rebind(parent, leaf, Resident(blocks, p.requires_grad))
            continue
        layers, rest = lists[pre], name[len(pre):]
        if rest not in layers.stacked:
            continue  # resident already
        stack = layers.stack(rest)
        requires = layers[0].get_parameter(rest).requires_grad
        blocks = Blocks.place(stack.detach(), _port_spec(name, stack, specs[name], True), mi)
        layer_layout = BlockLayout.of(stack.shape[1:], blocks.layout.spec[1:], mi)
        owner, _, leaf = rest.rpartition(".")
        for i, layer in enumerate(layers):
            parent = layer.get_submodule(owner) if owner else layer
            _rebind(parent, leaf, Resident(Blocks(layer_layout, [p[i] for p in blocks.parts]),
                                           requires))
        del layers.stacked[rest]
        for j, p in enumerate(blocks.parts):
            layers.stacked[f"{rest}.parts.{j}"] = p
        del stack
    return model
