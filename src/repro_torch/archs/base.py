"""Arch / cell registry (port of ``repro.archs.base``): every registered
architecture exposes, per input shape, a ``CellSpec``, its step function
plus a function that builds the step's inputs on a device.

The reference's ``CellSpec`` also carries abstract input shapes and their
PartitionSpecs, which its dry run lowers and compiles; the port runs
eagerly on one controller, so ``make_inputs`` takes their place. Names the
port lacks (the AIRSHIP cells of the dry run) raise with the ROADMAP item
that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict


@dataclasses.dataclass
class CellSpec:
    name: str  # "<arch>:<shape>"
    kind: str  # train | serve
    fn: Callable  # positional args: make_inputs' tuple
    make_inputs: Callable[..., tuple]  # (seed=0, device="cuda") -> fn's positional args


class Arch:
    """Family base; subclasses implement make_cell + shape_names."""

    name: str = ""
    family: str = ""

    def shape_names(self) -> list[str]:
        raise NotImplementedError

    def make_cell(self, shape: str, mi=None) -> CellSpec:
        raise NotImplementedError


_REGISTRY: Dict[str, Callable[[], Arch]] = {}


def register(name: str, factory: Callable[[], Arch]) -> None:
    _REGISTRY[name] = factory


def get_arch(name: str) -> Arch:
    if name not in _REGISTRY:
        import repro_torch.configs as configs  # populate the registry

        if name in configs.NOT_PORTED:
            raise NotImplementedError(
                f"{name} is not ported yet (ROADMAP item {configs.NOT_PORTED[name]})")
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401 (populate the registry)

    return sorted(_REGISTRY)
