"""Arch / cell registry (port of ``repro.archs.base``): every registered
architecture exposes, per input shape, a ``CellSpec``, its step function
plus a function that builds the step's inputs on a device.

The reference's ``CellSpec`` also carries abstract input shapes and their
PartitionSpecs, which its dry run lowers and compiles; the port runs
eagerly on one controller, so ``make_inputs`` takes the place of the
shapes (on the meta device, tensors without storage), and ``specs`` gives
the layout (``distributed/layout.py``): a train cell built over a mesh
keys its parameters' specs by name, an AIRSHIP cell its arguments' by
their paths from ``arg_names``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple


@dataclasses.dataclass
class CellSpec:
    name: str  # "<arch>:<shape>"
    kind: str  # train | serve
    fn: Callable  # positional args: make_inputs' tuple
    make_inputs: Callable[..., tuple]  # (seed=0, device="cuda") -> fn's positional args
    specs: Optional[Dict[str, tuple]] = None  # parameter name (or argument path) -> its spec
    arg_names: Optional[Tuple[str, ...]] = None  # fn's positional arguments, where specs name paths
    note: str = ""


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
        import repro_torch.configs  # noqa: F401 (populate the registry)

    return _REGISTRY[name]()


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401 (populate the registry)

    return sorted(_REGISTRY)
