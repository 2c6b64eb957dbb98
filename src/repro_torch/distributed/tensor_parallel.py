"""Tensor parallelism over a mesh's model axis on one controller: the moves
a train step over resident ``(fs, tp)`` blocks makes (the LM's layers,
``models/transformer``), where the reference lets GSPMD place them.

The work of a mesh is a grid of data groups by model positions: group g's
position m is ``DeviceMesh.groups(tp axis)[g, m]``. The data axes split
the batch where they divide it (``n_groups``), else one group holds it,
as the reference replicates a batch its data axes do not divide. Each
model position of a group holds the group's whole activation (the
residual stream) and computes its own block of every split product.

``Grid`` lays the positions out as the devices hold them: one ``Part`` a
device, the data groups by the model positions it holds, each part's work
one batched call. Four cards hold one position each; a mesh that repeats
one device (the CPU, the meta device of the dry run, a card standing in
for a mesh) holds them all in one part, so each op runs once for the whole
grid and not once a position. A value on a grid is one tensor a part: a
*group* value (a group's activation, alike on its model positions) has
the part's groups' rows, (groups x B, ...); a *position* value has each
position's rows, (groups x model positions x B, ...), position-major.
A ``Product`` is a split product's blocks as a part holds them.

The moves, each reported to the collective tally under the reference's
kind (``roofline/collectives.py``), once for group 0 as the reference
reports one device's:

  * ``GatherBlocks``: a resident leaf's model shard m over the data
    positions, joined in position order on each part that holds m (the
    all-gather of ZeRO's split, one op a shard). Its backward adds the
    parts' gradients in group order, each block's slice on that block's
    device (the reduce-scatter, one op a shard). Both are also counted as
    the tally's weight moves. A leaf the data axes do not split is read
    in place: its part on the position's device.
  * ``Grid.row_sum``: a row-parallel product's partials summed over a
    group's model positions in position order (one all-reduce) and placed
    on every model position; the backward adds the positions' gradients of
    the placed sum in position order (one all-reduce: the gradient of the
    residual stream before the next column-parallel product).
  * ``Grid.gather``: each position's block of an activation joined in
    position order along the last dimension on every model position (one
    all-gather); the backward sums each block's gradient over the
    positions that read it (one reduce-scatter).
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from repro_torch.distributed.layout import BlockLayout, Resident, entry_axes
from repro_torch.models.common.modules import Dense
from repro_torch.roofline import collectives


def n_groups(mi, batch: int) -> int:
    """The data groups of a batch of ``batch`` rows over ``mi``: the data
    axes' size where it divides the batch, else 1."""
    return mi.dp_size if mi.axes_if_divisible(batch, mi.dp_axes) else 1


def _axis_dim(layout: BlockLayout, axes) -> Optional[int]:
    axes = set(axes)
    return next((d for d, e in enumerate(layout.spec) if axes & set(entry_axes(e))), None)


def data_dim(layout: BlockLayout, mi) -> Optional[int]:
    """The dimension of a leaf that the data axes split, or None (the data
    axes have one position, or the spec does not name them)."""
    return None if mi.dp_size == 1 else _axis_dim(layout, mi.dp_axes)


def model_dim(layout: BlockLayout, mi) -> Optional[int]:
    """The dimension of a leaf that the model axis splits (in one block
    where it has one position), or None."""
    return _axis_dim(layout, (mi.tp_axis,))


@dataclass(frozen=True)
class Part:
    """The positions one device holds: data groups ``gs`` by model
    positions ``ms``, each in order."""

    device: torch.device
    gs: tuple
    ms: tuple


class GatherBlocks(torch.autograd.Function):
    """Model shard m's blocks over the data positions (``parts``, in
    position order) joined along ``dim`` on each of ``targets`` (the
    all-gather); the backward adds the targets' gradients in target order,
    each block's slice on that block's device (the reduce-scatter), and
    reports it to ``tallies``."""

    @staticmethod
    def forward(ctx, dim, targets, tallies, *parts):
        ctx.dim, ctx.tallies = dim, tallies
        ctx.blocks = [(p.device, p.shape[dim]) for p in parts]
        out = tuple(torch.cat([p.to(t) for p in parts], dim) for t in targets)
        collectives.record_into(tallies, "all-gather", out[0], weights=True)
        return out

    @staticmethod
    def backward(ctx, *grads):
        sizes = [size for _, size in ctx.blocks]
        pieces = [g.split(sizes, ctx.dim) for g in grads]
        out = []
        for i, (dev, _) in enumerate(ctx.blocks):
            total = None
            for p in pieces:  # the targets in order
                piece = p[i].to(dev)
                total = piece if total is None else total + piece
            out.append(total)
        collectives.record_into(ctx.tallies, "reduce-scatter", out[0], weights=True)
        return (None, None, None, *out)


def one(t: torch.Tensor, count: int) -> torch.Tensor:
    """The first 1 / ``count`` of ``t``'s elements: the size one position of
    ``count`` moves, for the tally."""
    return t.reshape(-1)[: t.numel() // count]


class _Place(torch.autograd.Function):
    """A total of ``count`` groups on its row's first device placed on each
    of ``devs``; the backward adds the placed copies' gradients in position
    order on that device and reports the all-reduce to ``tallies``."""

    @staticmethod
    def forward(ctx, tallies, devs, count, total):
        ctx.tallies, ctx.dev, ctx.count = tallies, total.device, count
        return tuple(total.to(d) if d != total.device else total.view_as(total) for d in devs)

    @staticmethod
    def backward(ctx, *grads):
        total = None
        for g in grads:
            if g is not None:
                total = g.to(ctx.dev) if total is None else total + g.to(ctx.dev)
        if total is not None:
            collectives.record_into(ctx.tallies, "all-reduce", one(total, ctx.count))
        return None, None, None, total


class _Gather(torch.autograd.Function):
    """Blocks of ``count`` positions' values each, in position order, joined
    along the last dimension on each of ``devs`` (the all-gather, reported
    to ``tallies``); the backward sums each block's gradient over the
    devices in order on the block's device and reports the reduce-scatter."""

    @staticmethod
    def forward(ctx, tallies, devs, count, *blocks):
        ctx.tallies, ctx.count = tallies, count
        ctx.at = [(b.device, b.shape[-1]) for b in blocks]
        out = tuple(torch.cat([b.to(d) for b in blocks], -1) for d in devs)
        collectives.record_into(tallies, "all-gather", one(out[0], count))
        return out

    @staticmethod
    def backward(ctx, *grads):
        pieces = [g.split([n for _, n in ctx.at], -1) for g in grads if g is not None]
        out = []
        for i, (dev, _) in enumerate(ctx.at):
            total = None
            for p in pieces:
                total = p[i].to(dev) if total is None else total + p[i].to(dev)
            out.append(total)
        collectives.record_into(ctx.tallies, "reduce-scatter", one(out[0], ctx.count))
        return (None, None, None, *out)


class _Join(torch.autograd.Function):
    """The identity on a grid's tensors whose backward is one autograd node.
    Under a checkpoint it reads a tensor it saved first, so the region is
    recomputed once, by the one thread that runs this node, before the
    devices' threads read what the region saved (two threads unpacking one
    frame at once would recompute it twice, interleaved)."""

    @staticmethod
    def forward(ctx, *xs):
        ctx.save_for_backward(xs[0])
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.saved_tensors  # noqa: B018 (the unpack recomputes a checkpointed region)
        return grads


def stacked(ws: list, dtype=None) -> torch.Tensor:
    """A part's model shards (a list, in position order) as one (Mp, ...)
    tensor, in ``dtype`` where given (one shard: a view of it)."""
    w = ws[0][None] if len(ws) == 1 else torch.stack(ws)
    return w if dtype is None else w.to(dtype)


def gather_into(tallies, dev, blocks: list, count: int) -> torch.Tensor:
    """``blocks`` (of ``count`` positions' values each) joined in order along
    the last dimension on ``dev`` (one all-gather; its backward one
    reduce-scatter)."""
    return _Gather.apply(tallies, [dev], count, *blocks)[0]


class Product(nn.Module):
    """A ``Dense`` whose weight the model axis splits, as a part holds it:
    ``ws`` its positions' (n, k) blocks. Column-parallel (the output
    features split, ``column``): a group value (G B, ..., k) -> a position
    value (G M B, ..., n), each position's output columns. Row-parallel
    (the input features split): a position value (G M B, ..., k) -> each
    position's partial (G M B, ..., n), to be summed over the model
    positions (``Grid.row_sum``). A part of one position: the plain
    product."""

    def __init__(self, ws: list, groups: int, column: bool):
        super().__init__()
        self.ws, self.groups, self.column = ws, groups, column

    def forward(self, x):
        if len(self.ws) == 1:
            return x @ self.ws[0].T.to(x.dtype)
        rest, k = x.shape[1:-1], x.shape[-1]
        w = stacked(self.ws, x.dtype)  # (M, n, k)
        x = x.reshape(self.groups, 1 if self.column else len(self.ws), -1, k)
        return torch.matmul(x, w.mT[None]).reshape(-1, *rest, w.shape[1])


class Grid:
    """The data groups by model positions of a batch over ``mi``
    (``n_groups``), as the devices hold them: ``parts``, one a device, in
    rows (the parts that hold the same groups, in position order). Each
    device must hold a rectangle of groups by positions."""

    def __init__(self, mi, groups: int):
        self.mi, self.groups, self.tp = mi, groups, mi.tp_size
        devs = mi.mesh.groups(mi.tp_axis)
        held: dict = {}
        for g in range(groups):
            for m in range(self.tp):
                held.setdefault(devs[g, m], []).append((g, m))
        rows: dict = {}
        for dev, pos in held.items():
            gs, ms = sorted({g for g, _ in pos}), sorted({m for _, m in pos})
            if len(pos) != len(gs) * len(ms) or gs != list(range(gs[0], gs[-1] + 1)) \
                    or ms != list(range(ms[0], ms[-1] + 1)):
                raise ValueError(f"the positions on {dev} are not a block of data groups by "
                                 f"model positions")
            rows.setdefault(tuple(gs), []).append(Part(dev, tuple(gs), tuple(ms)))
        self.parts, self.rows = [], []
        for gs in sorted(rows):
            row = sorted(rows[gs], key=lambda p: p.ms)
            if [m for p in row for m in p.ms] != list(range(self.tp)):
                raise ValueError(f"the model positions of groups {gs} overlap across devices")
            self.rows.append(list(range(len(self.parts), len(self.parts) + len(row))))
            self.parts.extend(row)

    def model_index(self, i: int, device) -> torch.Tensor:
        """Part i's model positions, made on ``device`` (no copy from the
        host, which would wait for the device)."""
        p = self.parts[i]
        return torch.arange(p.ms[0], p.ms[-1] + 1, device=device)

    # ------------------------------------------------------------ values
    def split(self, t: torch.Tensor) -> list:
        """A group value of a (groups x B, ...) tensor: each part's groups'
        rows on its device."""
        b = t.shape[0] // self.groups
        return [t[p.gs[0] * b : (p.gs[-1] + 1) * b].to(p.device) for p in self.parts]

    def join_groups(self, xs: list) -> torch.Tensor:
        """A group value's rows in group order on the first part's device."""
        dev = self.parts[0].device
        return torch.cat([xs[row[0]].to(dev) for row in self.rows], dim=0)

    def spread(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Part i's group value as a position value: each group's rows for
        each of its model positions (no copy where the part holds one)."""
        p = self.parts[i]
        if len(p.ms) == 1:
            return x
        g, rest = len(p.gs), x.shape[1:]
        return x.reshape(g, 1, -1, *rest).expand(g, len(p.ms), -1, *rest).reshape(-1, *rest)

    def slices(self, row: list, xs: list) -> list:
        """A row's position value as one (G, B, ...) tensor a model position,
        in position order."""
        out = []
        for i in row:
            p, x = self.parts[i], xs[i]
            x = x.reshape(len(p.gs), len(p.ms), -1, *x.shape[1:])
            out.extend(x[:, j] for j in range(len(p.ms)))
        return out

    def tallies(self, row: list) -> tuple:
        """The tallies a row's moves over the model positions report to:
        group 0's row counts, and nothing moves over one position."""
        return collectives.open_tallies() if self.tp > 1 and self.parts[row[0]].gs[0] == 0 else ()

    def place(self, row: list, total: torch.Tensor) -> list:
        """A row's group total on its first device placed on each of its
        parts (``_Place``: the backward's all-reduce)."""
        return list(_Place.apply(self.tallies(row), [self.parts[i].device for i in row],
                                 len(self.parts[row[0]].gs), total))

    def row_sum(self, partials: list, base: Optional[list] = None) -> list:
        """Position partials -> the group value of their sums over each
        group's model positions, in position order on the row's first
        device (one all-reduce), added to ``base``'s total of the row
        there where given, placed on every part of the row."""
        out = [None] * len(self.parts)
        for r, row in enumerate(self.rows):
            slices = self.slices(row, partials)
            dev = slices[0].device
            total = slices[0]
            for s in slices[1:]:
                total = total + s.to(dev)
            collectives.record_into(self.tallies(row), "all-reduce", total[0])
            total = total.reshape(-1, *total.shape[2:])
            if base is not None:
                total = base[r] + total
            for i, x in zip(row, self.place(row, total)):
                out[i] = x
        return out

    def gather(self, blocks: list) -> list:
        """A position value's blocks -> the group value of the blocks joined
        in position order along the last dimension (one all-gather)."""
        out = [None] * len(self.parts)
        for row in self.rows:
            slices = self.slices(row, blocks)
            joined = _Gather.apply(self.tallies(row), [self.parts[i].device for i in row],
                                   slices[0].shape[0], *slices)
            for i, x in zip(row, joined):
                out[i] = x.reshape(-1, *x.shape[2:])
        return out

    def join(self, xs: list) -> list:
        """The same tensors through one backward node (``_Join``): the
        outputs of a checkpointed region that spans several devices."""
        return list(_Join.apply(*xs)) if len(xs) > 1 else xs

    # ------------------------------------------------------------ weights
    def shards(self, w: Resident) -> list:
        """Each part's model shards of ``w``, a list in its position order
        (a leaf the model axis does not split: one tensor a part): in place
        where the data axes do not split the leaf, else the blocks over the
        data positions gathered (``GatherBlocks``)."""
        mi = self.mi
        grid = w.grid(mi)  # (data positions, model shards)
        split_m = model_dim(w.layout, mi) is not None
        dim = data_dim(w.layout, mi)
        if dim is None:
            got = [[grid[p.gs[0], m] for m in (p.ms if split_m else p.ms[:1])]
                   for p in self.parts]
        else:
            got = [[None] * (len(p.ms) if split_m else 1) for p in self.parts]
            for m in range(self.tp if split_m else 1):
                holders = [(i, p.ms.index(m) if split_m else 0) for i, p in enumerate(self.parts)
                           if m in p.ms or not split_m]
                tallies = collectives.open_tallies()
                out = GatherBlocks.apply(dim, [self.parts[i].device for i, _ in holders],
                                         tallies, *grid[:, m])
                for (i, j), t in zip(holders, out):
                    got[i][j] = t
        return got if split_m else [ws[0] for ws in got]

    def products(self, dense: Dense) -> list:
        """Each part's ``Product`` of a ``Dense`` whose weight is resident (a
        model axis of one position: its whole weight)."""
        dim = model_dim(dense.weight.layout, self.mi)
        return [Product(ws, len(p.gs), dim != 1)
                for p, ws in zip(self.parts, self.shards(dense.weight))]

    def views(self, module: nn.Module) -> list:
        """Each part's shallow copy of ``module`` whose resident leaves are
        the part's: a ``Dense`` that the model axis splits becomes a
        ``Product``, column- or row-parallel (its output or its input
        features split), any other split leaf the part's list of model
        shards, a whole leaf its replica on the part's device. ``module``
        is left as it is (autograd's device threads may recompute a
        checkpoint at once)."""
        local = {k: self.shards(r) for k, r in module.named_modules() if isinstance(r, Resident)}
        return [_view(module, local, self, i) for i in range(len(self.parts))]

    def each(self, fn, *values) -> list:
        """``fn`` of each part's entries of ``values``."""
        return [fn(*xs) for xs in zip(*values)]


def _view(module: nn.Module, local: dict, grid: Grid, i: int, prefix: str = "") -> nn.Module:
    clone = copy.copy(module)
    clone._parameters = dict(module._parameters)
    clone._modules = {}
    groups = len(grid.parts[i].gs)
    for k, sub in module._modules.items():
        name = prefix + k
        if name in local:
            clone._parameters[k] = local[name][i]
        elif isinstance(sub, Dense) and isinstance(local.get(name + ".weight", [None])[i], list):
            column = model_dim(sub.weight.layout, grid.mi) != 1
            clone._modules[k] = Product(local[name + ".weight"][i], groups, column)
        elif sub is not None:
            clone._modules[k] = _view(sub, local, grid, i, name + ".")
    return clone
