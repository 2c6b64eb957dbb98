"""Arch-level entry points of the port (port of ``repro.archs``): the
registry (``base``), the recsys cells (train and serve) and the AIRSHIP
serve shapes."""
from repro_torch.archs.base import Arch, CellSpec, get_arch, list_archs, register

__all__ = ["Arch", "CellSpec", "get_arch", "list_archs", "register"]
