"""Lattice sweep on the card: enumerate -> roofline-prune -> check -> time
-> pick winners (port of ``repro.tune.sweep``).

One sweep point is a tuning-table key (kernel, d, deg, beam) on the card;
``gather_distance`` is the one kernel with a lattice to sweep (the others
have one shape, ``tune/config.py``). For each point the sweep enumerates
the kernel's lattice points that
differ at the key's width (``key_configs``), drops the configs the
roofline model predicts are memory-dominated-worse or do not fit a
block's shared memory
(``repro_torch.roofline.model.prune_configs``), checks that every
survivor's outputs equal the default config's bit for bit, then times them
all interleaved inside ONE window with a rotating start
(``timed_group``): each config's launches are captured once in a CUDA
graph (host launch overhead stays out), and every repeat replays each
graph once between CUDA events, so a repeat gives one reading of each
config and pairs each config's reading with the default's.

    python -m repro_torch.tune.sweep --write

runs the sweep in ``--calls`` separate processes (5 by default: the
fastest shape moved between processes where readings within one agreed
to 0.01 us), pools their pairs and keeps a config other than the default
only where ``choose`` finds it faster in nine tenths of the pairs and by
more than the default's own spread. It sweeps the main path's keys at
its shapes (B = 256 queries over n = 1M rows; ``SWEEP_POINTS``) and
writes ``tune/table.json`` with the card's name and power limit in its
header. The sweep needs a CUDA device; with tensors on the CPU every
config times the same plain version, which only rehearses the plumbing.
"""
from __future__ import annotations

import itertools
import json
import math
import statistics
import subprocess
import sys
import time
from typing import Callable, List, Optional, Sequence

import torch

from repro_torch.kernels.gather_distance import gather_distance
from repro_torch.roofline.model import kernel_bytes, kernel_roofline, prune_configs
from repro_torch.tune.config import DEFAULT_CONFIGS, KernelConfig, key_configs
from repro_torch.tune.table import SCHEMA_VERSION, TABLE_PATH, lattice_doc

L2_BYTES = 50 * 2**20  # the H100's L2: id sets cycle through twice this
# The main path's gather_distance keys (kernel, d, deg, beam) at B = 256,
# n = 1M: the exact walks at d = 128 (beam 1 and 4) and airship_tt_256's
# d = 256. A key left out takes its nearest entry's config, which can be
# slower than the default, so every walk's key is swept. Only B = 256 is
# swept; the key has no batch dimension, so the configs serve every batch
# size.
SWEEP_POINTS = (
    ("gather_distance", 128, 32, 1),
    ("gather_distance", 128, 32, 4),
    ("gather_distance", 256, 32, 1),
)
WIN_SHARE = 0.9  # of the pairs a config must win to replace the default


def timed_group(fns: Sequence[Callable[[], object]], repeats: int = 5, reps: int = 50,
                device="cuda") -> List[List[float]]:
    """Every reading (seconds a call) per fn, all measured interleaved inside
    ONE window.

    Each rep runs every fn once, the starting index rotating per rep so no
    config systematically pays the first-in-window cost. On a CUDA
    ``device`` each fn's ``reps`` calls are captured in one CUDA graph
    (after three untimed calls), and a rep is one replay between CUDA
    events; on the CPU a rep is ``reps`` calls on the host clock.
    """
    on_card = torch.device(device).type == "cuda"
    runs: List[Callable[[], None]] = []
    if on_card:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for fn in fns:
                for _ in range(3):
                    fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        for fn in fns:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(reps):
                    fn()
            graph.replay()
            runs.append(graph.replay)
        torch.cuda.synchronize()
    else:
        for fn in fns:
            fn()
            runs.append(lambda fn=fn: [fn() for _ in range(reps)])
    accs: List[List[float]] = [[] for _ in fns]
    n = len(fns)
    for rep in range(repeats):
        for off in range(n):
            j = (rep + off) % n
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                runs[j]()
                end.record()
                end.synchronize()
                accs[j].append(start.elapsed_time(end) * 1e-3 / reps)
            else:
                t0 = time.perf_counter()
                runs[j]()
                accs[j].append((time.perf_counter() - t0) / reps)
    return accs


def _operands(*, d: int, m: int, b: int, n: int, device, seed: int = 0) -> dict:
    """One gather_distance sweep point's inputs, made once and shared by
    every config: b queries of width d, m candidates each in several id
    sets (together at least twice the L2 cache, so each call finds its
    rows cold as the walk does; the reference's law, ids in [-1, n)), n
    corpus rows."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    per_call = sum(kernel_bytes("gather_distance", DEFAULT_CONFIGS["gather_distance"], b=b, m=m,
                                d=d).values())
    n_sets = max(2, math.ceil(2 * L2_BYTES / per_call))
    return {"ids": [torch.randint(-1, n, (b, m), generator=gen, dtype=torch.int32, device=dev)
                    for _ in range(n_sets)],
            "corpus": torch.randn((n, d), generator=gen, device=dev),
            "queries": torch.randn((b, d), generator=gen, device=dev)}


def _workload(config: KernelConfig, ops: dict) -> Callable[[], torch.Tensor]:
    """A zero-arg callable running one gather_distance launch at
    ``config``; each call takes the next id set."""
    id_sets = itertools.cycle(ops["ids"])
    return lambda: gather_distance(ops["queries"], ops["corpus"], next(id_sets), config=config)


def sweep_kernel(
    kernel: str,
    *,
    d: int,
    deg: int = 32,
    beam: int = 1,
    b: int = 256,
    n: int = 1_000_000,
    repeats: int = 10,
    device="cuda",
    configs: Optional[Sequence[KernelConfig]] = None,
) -> dict:
    """Sweep one (kernel, d, deg, beam) point in this process; return its
    record: every timed config's readings (us a launch, one a repeat) and
    bound. ``m`` (candidates a query) is deg * beam. Every timed config's
    outputs must equal the default's bit for bit (else ValueError). The
    default is always timed, first in the rows. Only gather_distance has a
    lattice to sweep; the other kernels have one shape (ValueError)."""
    if kernel != "gather_distance":
        raise ValueError(f"{kernel!r} has one shape: nothing to sweep")
    platform = torch.device(device).type
    m = max(deg, 1) * max(beam, 1)
    lattice = list(configs if configs is not None else key_configs(kernel, d))
    survivors, pruned = prune_configs(kernel, lattice, b=b, m=m, d=d, platform=platform)
    default = DEFAULT_CONFIGS[kernel]
    survivors = [default] + [c for c in survivors if c != default]
    pruned = [c for c in pruned if c != default]

    ops = _operands(d=d, m=m, b=b, n=n, device=device)
    want = _workload(default, ops)()
    for cfg in survivors:
        if not torch.equal(_workload(cfg, ops)(), want):
            raise ValueError(f"{kernel} at {cfg} differs from the default config's bits")
    readings = timed_group([_workload(cfg, ops) for cfg in survivors],
                           repeats=repeats, reps=100, device=device)
    rows = []
    for cfg, r in zip(survivors, readings):
        bound = kernel_roofline(kernel, cfg, b=b, m=m, d=d).time_bound(platform)
        rows.append({"config": cfg.to_dict(), "readings_us": [round(t * 1e6, 4) for t in r],
                     "bound_us": round(bound * 1e6, 4)})
    return {"kernel": kernel, "platform": platform, "d": d, "deg": deg, "beam": beam, "b": b,
            "m": m, "n": n, "rows": rows, "pruned": [c.to_dict() for c in pruned]}


def choose(records: Sequence[dict]) -> dict:
    """Pick one key's winner from its records of one or more sweep calls.

    A config is paired with the default reading for reading (same call,
    same repeat, so a shift of the whole call moves both). It replaces the
    default only where it is faster in at least ``WIN_SHARE`` of all pairs
    (ties count for neither) and the median of the pairs' differences is
    larger than the default's own spread (the distance between its
    readings' quartiles within a call, the median over calls); of those,
    the lowest median reading wins. Else the default stays: a lead inside
    the noise is no reason to leave the shape the kernels had.
    """
    def readings(rec: dict, config: dict) -> List[float]:
        return next(row["readings_us"] for row in rec["rows"] if row["config"] == config)

    def pooled(config: dict) -> List[float]:
        return [t for rec in records for t in readings(rec, config)]

    def iqr(xs: List[float]) -> float:
        q1, _, q3 = statistics.quantiles(xs, n=4) if len(xs) > 1 else (xs[0],) * 3
        return q3 - q1

    default = records[0]["rows"][0]["config"]
    base = pooled(default)
    med0 = statistics.median(base)
    spread = statistics.median(iqr(readings(rec, default)) for rec in records)
    best, best_med, stats = default, med0, []
    for row in records[0]["rows"]:
        cfg = row["config"]
        got = pooled(cfg)
        wins = sum(t < t0 for t, t0 in zip(got, base))
        gain = statistics.median(t0 - t for t, t0 in zip(got, base))
        med = statistics.median(got)
        ok = cfg != default and wins >= WIN_SHARE * len(base) and gain > spread
        stats.append({"config": cfg, "median_us": med, "pairs_won": wins,
                      "median_gain_us": gain, "qualifies": ok})
        if ok and med < best_med:
            best, best_med = cfg, med
    bound_us = next(r["bound_us"] for r in records[0]["rows"] if r["config"] == best)
    return {"winner": best, "winner_us": round(best_med, 4), "default_us": round(med0, 4),
            "default_spread_us": round(spread, 4), "speedup_vs_default": round(med0 / best_med, 4),
            "roofline_fraction": round(bound_us / best_med, 6), "calls": len(records),
            "pairs": len(base), "configs": stats}


def by_key(records: Sequence[dict]) -> dict:
    """Records grouped by table key (kernel, platform, d, deg, beam), in
    first-seen order."""
    keys: dict = {}
    for r in records:
        keys.setdefault((r["kernel"], r["platform"], r["d"], r["deg"], r["beam"]), []).append(r)
    return keys


def table_doc(records: Sequence[dict], device: str = "not recorded") -> dict:
    """Fold sweep records (one or more calls a key) into the committed
    table.json document, one entry a key in ``records``' order, its config
    ``choose``'s; ``device`` names the card and its power limit."""
    entries = []
    for (kernel, platform, d, deg, beam), recs in by_key(records).items():
        c = choose(recs)
        entries.append({
            "kernel": kernel, "platform": platform, "d": d, "deg": deg, "beam": beam,
            "config": c["winner"], "winner_us": c["winner_us"], "default_us": c["default_us"],
            "speedup_vs_default": c["speedup_vs_default"],
            "roofline_fraction": c["roofline_fraction"], "calls": c["calls"],
            "pairs": c["pairs"],
        })
    return {"version": SCHEMA_VERSION, "device": device, "lattice": lattice_doc(),
            "entries": entries}


def card_description() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _one_call(repeats: int) -> List[dict]:
    """Every SWEEP_POINTS record of one process, each printed as a JSON line."""
    records = []
    for kernel, d, deg, beam in SWEEP_POINTS:
        records.append(sweep_kernel(kernel, d=d, deg=deg, beam=beam, repeats=repeats))
        print(json.dumps({"record": records[-1]}), flush=True)
        torch.cuda.empty_cache()
    return records


def _main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Sweep the kernels' lattice on the card.")
    ap.add_argument("--write", action="store_true", help=f"write the table to {TABLE_PATH}")
    ap.add_argument("--out", default=TABLE_PATH, help="where --write writes the table")
    ap.add_argument("--repeats", type=int, default=10, help="pairs a config a call")
    ap.add_argument("--calls", type=int, default=5,
                    help="sweep processes whose pairs are pooled (1: this process)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("the sweep times the CUDA kernels: no CUDA device")
        return 1
    card = card_description()
    print(card, flush=True)
    if args.calls <= 1:
        records = _one_call(args.repeats)
    else:
        records = []
        for call in range(args.calls):
            t0 = time.perf_counter()
            out = subprocess.run([sys.executable, "-m", "repro_torch.tune.sweep", "--calls", "1",
                                  "--repeats", str(args.repeats)],
                                 capture_output=True, text=True, timeout=900)
            if out.returncode != 0:
                raise RuntimeError(f"sweep call {call} exited {out.returncode}: {out.stderr[-4000:]}")
            got = [json.loads(line)["record"] for line in out.stdout.splitlines()
                   if line.startswith('{"record"')]
            records += got
            for r in got:  # the raw readings, for the log
                print(json.dumps({"record": r}), flush=True)
            print(f"call {call}: {len(got)} records in {time.perf_counter() - t0:.1f} s",
                  flush=True)
    for key, recs in by_key(records).items():
        print(json.dumps({"key": key, **choose(recs)}), flush=True)
    doc = table_doc(records, card)
    if args.write:
        with open(args.out, "w") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
