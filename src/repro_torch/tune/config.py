"""KernelConfig: the block-shape parameter space of the CUDA kernels
(port of ``repro.tune.config``).

The reference's Pallas kernels expose ``m_blk`` (the output tile's width
cap), ``dma_depth`` (row copies in flight) and ``lut_tile`` (the ADC
table's reduction chunk). The CUDA kernels have their own degrees of
freedom, compile-time constants until now; ``KernelConfig`` names them so
that ``tune/sweep.py`` can search them and ``tune/table.json`` can pin a
winner per (kernel, platform, d, deg, beam) key:

  * ``tile_warps`` (``gather_distance``, register path): warps a block,
    each owning a tile of candidates of one query (``kTileWarps``). With
    ``rows_in_flight`` it sets the candidates a block covers, the role of
    Pallas's ``m_blk``.
  * ``rows_in_flight`` (the same): float4s a lane keeps in flight before
    its first reduction, NV * C (``kRowsSmall``), the role of Pallas's
    ``dma_depth``. It governs launches below ``kLargeLaunch`` candidates;
    from there on (NN-descent's 1M x 128 rounds, which no (d, deg, beam)
    key describes) ``kRowsLarge`` stays.

Every point is numerically invisible: every distance is computed per
candidate in one fixed order, a lane's float4s in ascending order, then
the fixed xor butterfly (``csrc/sqdist.cuh``), whatever the tile. A point
that would change a sum's order is not in the lattice.

The card settled the rest (the sweep's pooled pairs; PERF.md): the other
three kernels keep one shape, the constants of their sources, since no
other point beat it at the main path's keys. ``fused_exact`` is
``fused_expand.cu`` at ``sqdist.cuh``'s kTileWarps and kRowsSmall;
``fused_adc`` is ``fused_expand_adc.cu``'s kMaxThreads 512 and kLanes 4;
``pq_adc`` is ``pq_adc.cu``'s kThreads 1024 and kRowsPerBlock 16384; the
row kernels' shared-memory path (d not a multiple of 4, unaligned rows,
d > 256, which no swept key takes) keeps kSmemWarps 8. Their lattices are
the default alone; a dimension comes back when a key on a real path
chooses another value.

``LATTICE`` is per kernel: the dimensions a kernel consumes and their
values. ``csrc/gather_distance.cu`` instantiates exactly its points, and
refuses any other (a nonzero launch status). Dimensions a kernel does not
consume are pinned at the field's default.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Tuple

# Kernel names are the tuning-table key's first component (the reference's).
KERNELS = ("fused_exact", "fused_adc", "gather_distance", "pq_adc")

# The declared search lattice, per kernel: the only space the sweep
# searches and the only space table.json may hold. An empty one is the
# kernel's one shape.
LATTICE = {
    "fused_exact": {},
    "fused_adc": {},
    "gather_distance": {"tile_warps": (2, 4, 8), "rows_in_flight": (2, 4, 8)},
    "pq_adc": {},
}


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """One point of a kernel's lattice (frozen, hashable). The defaults are
    the constants the kernels were compiled with before the tuner."""

    tile_warps: int = 4
    rows_in_flight: int = 4

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "KernelConfig":
        return cls(**{f.name: int(d[f.name]) for f in dataclasses.fields(cls)})


FIELDS = tuple(f.name for f in dataclasses.fields(KernelConfig))
# The fixed shapes, for effective_m_blk: csrc/sqdist.cuh's kSmemWarps,
# fused_expand_adc.cu's kMaxThreads and kLanes, pq_adc.cu's kRowsPerBlock.
SMEM_WARPS = 8
ADC_THREADS = 512
ADC_LANES = 4
SCAN_ROWS_PER_BLOCK = 16384
_FIELD_DEFAULTS = KernelConfig().to_dict()

# The defaults reproduce the constants gather_distance had before the
# tuner exactly (sqdist.cuh's kTileWarps 4, kRowsSmall 4), so a missing
# table entry changes nothing; the other kernels consume no field.
DEFAULT_CONFIGS = {k: KernelConfig() for k in KERNELS}


def validate_config(kernel: str, config: KernelConfig) -> None:
    """Raise ValueError unless ``config`` is a declared lattice point for
    ``kernel``: every dimension the kernel consumes in its lattice, every
    other pinned at its default."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r} (expected one of {KERNELS})")
    dims = LATTICE[kernel]
    for name in FIELDS:
        value = getattr(config, name)
        if name in dims:
            if value not in dims[name]:
                raise ValueError(f"{kernel}: {name}={value} outside {dims[name]}")
        elif value != _FIELD_DEFAULTS[name]:
            raise ValueError(f"{kernel}: {name} is not a tunable of this kernel "
                             f"(pinned at {_FIELD_DEFAULTS[name]}, got {value})")


def lattice_configs(kernel: str) -> Tuple[KernelConfig, ...]:
    """Every lattice point of ``kernel``, the sweep space; the dimensions it
    does not consume stay at their defaults, so no duplicate is timed."""
    dims = LATTICE[kernel]
    return tuple(KernelConfig(**dict(zip(dims, values)))
                 for values in itertools.product(*dims.values()))


def register_path(d: int) -> bool:
    """Whether gather_distance and fused_expand serve rows of width d on
    their register path (d % 4 == 0, d <= 256; with 16-byte aligned rows,
    as torch allocates them), the only path that reads a config."""
    return d % 4 == 0 and d <= 256


def key_configs(kernel: str, d: int) -> Tuple[KernelConfig, ...]:
    """The lattice points that differ at a key of width d: off the register
    path gather_distance reads no config, so only the default is left and
    no sweep times one launch shape twice."""
    if kernel == "gather_distance" and not register_path(d):
        return (DEFAULT_CONFIGS[kernel],)
    return lattice_configs(kernel)


def effective_m_blk(config: KernelConfig, m: int, *, kernel: str = "gather_distance",
                    d: int = 128) -> int:
    """Candidates (corpus rows for ``pq_adc``) one block of ``kernel`` covers
    at a launch of ``m`` a query: the CUDA counterpart of the reference's
    resolved ``m_blk`` tile. ``d`` is the row width of the row kernels (it
    picks their path: the register path holds NV = ceil(d / 128) float4s a
    lane of the query, so a warp owns rows_in_flight / NV candidates)."""
    if kernel in ("gather_distance", "fused_exact"):
        if register_path(d):
            nv = -(-d // 128)
            cap = config.tile_warps * max(config.rows_in_flight // nv, 1)
        else:
            cap = SMEM_WARPS
    elif kernel == "fused_adc":
        cap = ADC_THREADS // ADC_LANES
    elif kernel == "pq_adc":
        cap = SCAN_ROWS_PER_BLOCK
    else:
        raise ValueError(f"unknown kernel {kernel!r}")
    return max(1, min(cap, m))
