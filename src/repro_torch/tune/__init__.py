"""Kernel block-shape tuner (port of ``repro.tune``): an explicit
``KernelConfig`` lattice per CUDA kernel, gather_distance's the one with
more than its default (config.py), a committed tuning
table with a schema-validated loader and nearest-shape fallback
(table.py), and the roofline-pruned sweep that fills it on the card
(sweep.py, ``python -m repro_torch.tune.sweep --write``).
``build_context`` resolves gather_distance's config from the table once
per search.
"""
from repro_torch.tune.config import (
    DEFAULT_CONFIGS,
    KERNELS,
    LATTICE,
    KernelConfig,
    effective_m_blk,
    lattice_configs,
    validate_config,
)
from repro_torch.tune.table import load_table, lookup

__all__ = [
    "DEFAULT_CONFIGS",
    "KERNELS",
    "LATTICE",
    "KernelConfig",
    "effective_m_blk",
    "lattice_configs",
    "load_table",
    "lookup",
    "validate_config",
]
