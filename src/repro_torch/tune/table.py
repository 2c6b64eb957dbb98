"""Committed tuning table: schema-validated loader + nearest-shape fallback
(port of ``repro.tune.table``).

``table.json`` (next to this module) is written on the card by
``python -m repro_torch.tune.sweep --write`` and read by ``build_context``
once per search. Key scheme, the reference's: one entry per

    (kernel, platform, d, deg, beam)

where ``kernel`` is one of ``repro_torch.tune.config.KERNELS``,
``platform`` is the ``torch.device.type`` the sweep ran on ("cuda"),
``d`` the per-candidate payload width (vector dim for the row kernels,
m_sub for the ADC kernels) and ``deg`` / ``beam`` the graph degree and
beam width whose product is the candidate batch M. The document's
``device`` names the card and its power limit, as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gave them.

Fallback rules, in order (the reference's):

  1. exact key match -> that entry's config;
  2. same (kernel, platform) -> the entry at minimum log-shape distance
     sum(|log2(x / x_entry)|) over (d, deg, beam) (ties: first entry in
     file order);
  3. no (kernel, platform) entries -> ``DEFAULT_CONFIGS[kernel]``, the
     constants the kernels had before the tuner.

Every loaded entry is validated against the declared lattice.
``python -m repro_torch.tune.table --check`` runs the same validation
standalone.
"""
from __future__ import annotations

import functools
import json
import math
import os
from typing import Optional

from repro_torch.tune.config import (
    DEFAULT_CONFIGS,
    KERNELS,
    LATTICE,
    KernelConfig,
    validate_config,
)

TABLE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "table.json")

SCHEMA_VERSION = 1

_ENTRY_REQUIRED = ("kernel", "platform", "d", "deg", "beam", "config")


def lattice_doc() -> dict:
    """``LATTICE`` as the table stores it (lists, not tuples)."""
    return {k: {dim: list(v) for dim, v in dims.items()} for k, dims in LATTICE.items()}


def validate_table(doc: dict) -> None:
    """Raise ValueError on any schema or lattice violation."""
    if not isinstance(doc, dict):
        raise ValueError("tuning table: top level must be an object")
    if doc.get("version") != SCHEMA_VERSION:
        raise ValueError(f"tuning table: version {doc.get('version')!r} != {SCHEMA_VERSION}")
    if doc.get("lattice") != lattice_doc():
        raise ValueError(
            "tuning table: declared lattice differs from repro_torch.tune.config.LATTICE")
    entries = doc.get("entries")
    if not isinstance(entries, list):
        raise ValueError("tuning table: 'entries' must be a list")
    seen = set()
    for idx, e in enumerate(entries):
        if not isinstance(e, dict):
            raise ValueError(f"tuning table entry {idx}: not an object")
        missing = [k for k in _ENTRY_REQUIRED if k not in e]
        if missing:
            raise ValueError(f"tuning table entry {idx}: missing keys {missing}")
        if e["kernel"] not in KERNELS:
            raise ValueError(f"tuning table entry {idx}: unknown kernel {e['kernel']!r}")
        for k in ("d", "deg", "beam"):
            if not isinstance(e[k], int) or e[k] <= 0:
                raise ValueError(
                    f"tuning table entry {idx}: {k}={e[k]!r} must be a positive int")
        key = (e["kernel"], e["platform"], e["d"], e["deg"], e["beam"])
        if key in seen:
            raise ValueError(f"tuning table entry {idx}: duplicate key {key}")
        seen.add(key)
        try:
            cfg = KernelConfig.from_dict(e["config"])
        except (KeyError, TypeError) as err:
            raise ValueError(f"tuning table entry {idx}: bad config {e['config']!r}") from err
        validate_config(e["kernel"], cfg)  # in the lattice, applicable to the kernel


def _empty_table() -> dict:
    return {"version": SCHEMA_VERSION, "lattice": lattice_doc(), "entries": []}


@functools.lru_cache(maxsize=4)
def load_table(path: Optional[str] = None) -> dict:
    """Load and validate the tuning table; an absent file is an empty table
    (every lookup then resolves to the kernel's default config)."""
    path = path or TABLE_PATH
    if not os.path.exists(path):
        return _empty_table()
    with open(path) as fh:
        doc = json.load(fh)
    validate_table(doc)
    return doc


def _shape_distance(entry: dict, d: int, deg: int, beam: int) -> float:
    dist = 0.0
    for key, val in (("d", d), ("deg", deg), ("beam", beam)):
        if val is None or val <= 0:
            continue  # the caller does not know this dimension: no penalty
        dist += abs(math.log2(val / entry[key]))
    return dist


def lookup_index(kernel: str, *, d: int, deg: int = 0, beam: int = 0, platform: str,
                 path: Optional[str] = None) -> Optional[int]:
    """The index in the table's entries that ``lookup`` resolves to, or None
    where the default applies (no entry for (kernel, platform))."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}")
    entries = load_table(path)["entries"]
    candidates = [i for i, e in enumerate(entries)
                  if e["kernel"] == kernel and e["platform"] == platform]
    if not candidates:
        return None
    return min(candidates, key=lambda i: _shape_distance(entries[i], d, deg, beam))


def lookup(kernel: str, *, d: int, deg: int = 0, beam: int = 0, platform: str = "cuda",
           path: Optional[str] = None) -> KernelConfig:
    """Resolve one kernel's config for a shape key (module docstring).
    ``platform`` is the ``device.type`` of the tensors the kernel will run
    on. Pure host-side Python over the cached table."""
    idx = lookup_index(kernel, d=d, deg=deg, beam=beam, platform=platform, path=path)
    if idx is None:
        return DEFAULT_CONFIGS[kernel]
    return KernelConfig.from_dict(load_table(path)["entries"][idx]["config"])


def _main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Validate the committed tuning table.")
    ap.add_argument("--check", action="store_true", help="validate and exit")
    ap.add_argument("--path", default=TABLE_PATH)
    args = ap.parse_args()
    if not os.path.exists(args.path):
        print(f"tuning table: {args.path} not found")
        return 1
    with open(args.path) as fh:
        doc = json.load(fh)
    validate_table(doc)
    # The loader must resolve every entry's own key back to that entry's
    # config (exact match before nearest shape).
    for e in doc["entries"]:
        got = lookup(e["kernel"], d=e["d"], deg=e["deg"], beam=e["beam"],
                     platform=e["platform"], path=args.path)
        want = KernelConfig.from_dict(e["config"])
        if got != want:
            print(f"tuning table: loader resolves {e} to {got}, not {want}")
            return 1
    print(f"tuning table OK: {len(doc['entries'])} entries, schema v{doc['version']}, "
          f"lattice matches declaration; swept on {doc.get('device', 'no device recorded')}")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
