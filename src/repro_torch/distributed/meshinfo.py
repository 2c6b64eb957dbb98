"""Mesh metadata threaded through model code (port of
``repro.distributed.meshinfo``).

Axis roles:
  * ``pod``   — data parallelism across pods (outermost; optional)
  * ``data``  — data parallel: the query / user batch splits over it
  * ``model`` — the corpus or candidate rows split over it

The port runs a mesh from one controller (DESIGN.md §4): a ``DeviceMesh``
is a grid of ``torch.device``s with axis names, and a position of the grid
may repeat a device, so a (1, 4) mesh can put four shards on one card (the
stand-in for the reference's virtual host devices). A collective is a move
of each shard's small result to the first device of its group, followed by
a reduction there (``core/distributed.py``).

Models never hardcode axis names; they consume a ``MeshInfo`` and read
sizes relative to it, so the same code runs on the 1x1 test mesh, the
16x16 single pod and the 2x16x16 multi-pod mesh. The reference's
``sharding`` and ``constrain`` are GSPMD annotations (a ``NamedSharding``,
``with_sharding_constraint``) and have no meaning without it: they are
left out, and code that would constrain a layout places its shards
explicitly instead.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.roofline import collectives


@dataclass(frozen=True)
class DeviceMesh:
    """A grid of ``torch.device``s: ``devices`` row-major with shape
    ``grid``, one name per axis."""

    devices: Tuple[torch.device, ...]
    grid: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.grid) != len(self.axis_names):
            raise ValueError(f"grid {self.grid} vs axis names {self.axis_names}")
        if int(np.prod(self.grid)) != len(self.devices):
            raise ValueError(f"{len(self.devices)} devices for a {self.grid} grid")

    @classmethod
    def create(cls, devices: Sequence, grid: Sequence[int],
               axis_names: Sequence[str]) -> "DeviceMesh":
        return cls(tuple(torch.device(d) for d in devices), tuple(int(g) for g in grid),
                   tuple(axis_names))

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.grid))

    def groups(self, axis: str) -> np.ndarray:
        """The devices as an object array with ``axis`` moved last and every
        other axis flattened: (product of the other axes, size of ``axis``)."""
        grid = np.empty((len(self.devices),), dtype=object)
        grid[:] = self.devices
        grid = np.moveaxis(grid.reshape(self.grid), self.axis_names.index(axis), -1)
        return grid.reshape(-1, grid.shape[-1])


@dataclass(frozen=True)
class MeshInfo:
    mesh: DeviceMesh

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.mesh.axis_names)

    @property
    def has_pod(self) -> bool:
        return "pod" in self.axis_names

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return ("pod", "data") if self.has_pod else ("data",)

    @property
    def tp_axis(self) -> str:
        return "model"

    @property
    def dp_size(self) -> int:
        size = 1
        for a in self.dp_axes:
            size *= self.mesh.shape[a]
        return size

    @property
    def tp_size(self) -> int:
        return self.mesh.shape["model"]

    @property
    def fsdp_axis(self):
        """Parameter / optimizer-state split axes (ZeRO): every data axis, so
        a multi-pod mesh splits state across pods too."""
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]

    def axes_if_divisible(self, dim: int, axes):
        """Return ``axes`` when they evenly divide ``dim``, else None.

        Used to drop splits that cannot apply (e.g. batch=1 decode cannot
        split over the data axes).
        """
        if axes is None:
            return None

        def flat(a):
            if isinstance(a, str):
                return (a,)
            out = ()
            for x in a:
                out += flat(x)
            return out

        size = 1
        for a in flat(axes):
            size *= self.mesh.shape[a]
        return axes if dim % size == 0 else None


def sum_in_order(parts, dev):
    """The reference's ``psum`` over a mesh axis on one controller: ``parts``
    (one tensor a position, in shard order) moved to ``dev`` and added one
    after another, each add rounded to their dtype."""
    total = parts[0].to(dev)
    for p in parts[1:]:
        total = total + p.to(dev)
    collectives.record("all-reduce", total)
    return total


def single_device_meshinfo(device="cuda") -> MeshInfo:
    """1x1 mesh with the production axis names."""
    from repro_torch.common.device import resolve_device

    return MeshInfo(mesh=DeviceMesh.create([resolve_device(device)], (1, 1),
                                           ("data", "model")))
