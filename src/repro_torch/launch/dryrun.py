"""Dry run: every (architecture x input shape) cell on the production meshes,
with a record of each cell's memory, cost and collectives for the roofline
report (port of ``repro.launch.dryrun``).

Usage (no card needed):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \\
        --shape train_4k [--multi-pod] [--device meta|cpu] [--out artifacts/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

The reference lowers and compiles each cell's jitted step on abstract
inputs and reads XLA's memory and cost analyses and the HLO's
collectives. Eager PyTorch compiles nothing, so the port runs the step
instead, on tensors that hold no data:

  * **The mesh.** The production shapes, (16, 16) and (2, 16, 16)
    (``launch/mesh.py::make_production_mesh``), with one device filling
    every position, as the port's one controller drives a mesh.
  * **Arguments.** ``cell.make_inputs(device=...)``: on the ``meta`` device
    (the default) tensors of the right shapes and dtypes and nothing
    drawn or built; on ``cpu`` the real inputs, for the smoke
    configurations. ``argument_bytes`` is one position's share, the
    counterpart of XLA's ``argument_size_in_bytes``: each argument tensor
    by its block under the cell's ``specs`` (``layout.shard_shape``), the
    optimizer's state by the optimizer's ``state_specs`` of those, a batch
    leaf split over the data axes where they divide it, a grid of blocks
    (a cache laid out over the mesh) by one block, and any other leaf whole
    (replicated).
  * **The step.** ``cell.fn`` runs once under one ``TorchDispatchMode``
    (``StepCounter``) and the collective tally. The mode adds each op's
    flops by ``torch.utils.flop_counter``'s formulas, the ones
    ``FlopCounterMode`` applies (``cost.flops``; one mode instead of two
    halves the per-op cost of a walk's millions of small ops), each op's
    operand and result bytes (``cost.bytes_accessed``, view ops
    excluded), the elements that
    transcendental ops write (``cost.transcendentals``), and the bytes of
    every storage the step allocates while it lives (its peak is
    ``temp_bytes``); the tally is ``roofline/collectives.py``'s. The costs are the step's over every
    position, as the one controller runs them; the reference's are one
    position's. ``peak_bytes`` is the arguments the controller holds (all
    positions' blocks) plus ``temp_bytes``; ``output_bytes`` the step's
    results that are new storages.
  * **Host reads.** A step that reads a value on the host cannot run on
    meta tensors: the walk's ``bool((~st.done).any())``
    (``core/engine/loop.py``), and ops whose result shape depends on the
    data (a ``bincount``, a ``nonzero``). The record of such a cell says
    ``"source": "analytic"``, names the op that stopped the run in
    ``stopped_at``, takes ``cost`` from the roofline model
    (``roofline/report.py::terms_for_cell``: the step over every chip), and
    leaves what was not measured null; its collectives are null.
  * **``--device cpu``** runs the step for real (the smoke
    configurations): ``"source": "measured"``, every field measured.
  * **The record** has the reference's keys plus ``source``,
    ``stopped_at`` and ``device``. ``lower_s`` is the step's wall under the
    modes; ``compile_s`` is null (eager PyTorch compiles nothing);
    ``inputs_s`` is ``make_inputs``' wall.
  * **``--all``** covers ``ASSIGNED`` plus airship-sift1m, 46 cells;
    failures are reported and the run exits 1.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.archs.base import get_arch
from repro_torch.distributed.layout import shard_shape
from repro_torch.distributed.meshinfo import MeshInfo
from repro_torch.launch.mesh import make_production_meshinfo
from repro_torch.roofline import collectives

TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh", "sigmoid",
                  "sin", "cos", "rsqrt", "sqrt", "erf", "pow", "silu", "gelu", "softplus",
                  "_softmax", "_log_softmax", "logsumexp"}
NOT_ACCESS = {"detach", "alias", "lift_fresh", "_to_copy", "empty", "empty_like",
              "empty_strided", "new_empty", "new_empty_strided"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class StepCounter(TorchDispatchMode):
    """One dispatch mode for the step's counts: flops (each op through
    ``torch.utils.flop_counter``'s formula registry, the one
    ``FlopCounterMode`` reads), bytes accessed, transcendental elements, and
    the live bytes of the storages ops allocate (``peak``); storages
    registered with ``hold`` (the arguments) are not counted as allocated."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.accessed = 0
        self.transcendentals = 0
        self.live = 0
        self.peak = 0
        self.held = 0
        self._known: set = set()

    def hold(self, tensors) -> None:
        for t in tensors:
            key = _storage_key(t)
            if key not in self._known:
                self._known.add(key)
                self.held += t.untyped_storage().nbytes()

    def _release(self, key: int, n: int) -> None:
        self._known.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        formula = flop_registry.get(packet)
        if formula is None and func is not torch.ops.prim.device.default:
            # a composite op counts as the ops it decomposes into, as in
            # FlopCounterMode
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        outs = [t for t in (out if isinstance(out, (tuple, list)) else (out,))
                if isinstance(t, torch.Tensor)]
        name = packet.__name__
        if not func.is_view and name not in NOT_ACCESS:
            n = sum(_nbytes(t) for t in outs)
            for x in args:
                if isinstance(x, torch.Tensor):
                    n += _nbytes(x)
                elif isinstance(x, (tuple, list)):
                    n += sum(_nbytes(t) for t in x if isinstance(t, torch.Tensor))
            self.accessed += n
        if name in TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._known:
                continue
            n = st.nbytes()
            self._known.add(key)
            self.live += n
            if self.live > self.peak:
                self.peak = self.live
            weakref.finalize(st, self._release, key, n)
        return out


def _tensors(tree) -> list:
    """Every tensor of an argument tree: dicts, lists, tuples, dataclasses,
    modules (their parameters and buffers) and objects holding tensors."""
    out, seen = [], set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, torch.nn.Module):
            out.extend(x.parameters())
            out.extend(x.buffers())
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif hasattr(x, "__dict__") and id(x) not in seen:
            seen.add(id(x))
            for v in vars(x).values():
                walk(v)

    walk(tree)
    return out


def _resolve(args, names, path: str):
    head, *rest = path.split(".")
    x = args[names.index(head)]
    for p in rest:
        x = getattr(x, p)
    return x


def _block_bytes(t, spec, mi: MeshInfo) -> int:
    return math.prod(shard_shape(tuple(t.shape), spec, mi.mesh)) * t.element_size()


def _first_block(x):
    while isinstance(x, (list, tuple)):
        x = x[0]
    return x


def argument_bytes(cell, args, mi: MeshInfo, arch) -> int:
    """One position's bytes of the step's arguments (the module docstring)."""
    if cell.arg_names:  # specs keyed by argument paths
        return sum(_block_bytes(_resolve(args, cell.arg_names, k), spec, mi)
                   for k, spec in cell.specs.items())
    total = 0
    rest = list(args)
    if cell.kind == "train":
        from repro_torch.train.optimizer import adamw
        from repro_torch.train.train_step import param_leaves

        model, state, batch = args
        params = param_leaves(model)
        specs = {k: cell.specs.get(k, ()) for k in params} if cell.specs else \
            dict.fromkeys(params, ())
        total += sum(_block_bytes(p, specs[k], mi) for k, p in params.items())
        opt = arch.optimizer() if hasattr(arch, "optimizer") else adamw()
        sspecs = opt.state_specs(specs, params)
        for name, sub in state.items():
            if isinstance(sub, dict):
                total += sum(_block_bytes(v, sspecs[name][k], mi) for k, v in sub.items())
            else:
                total += _nbytes(sub)
        rest = [batch]
    for x in rest:
        leaves = x.values() if isinstance(x, dict) else [x]
        for leaf in leaves:
            if isinstance(leaf, (list, tuple)):  # a grid of blocks: one a position
                total += _nbytes(_first_block(leaf))
            elif isinstance(leaf, torch.Tensor):
                split = leaf.dim() > 0 and mi.axes_if_divisible(leaf.shape[0], mi.dp_axes)
                total += _block_bytes(leaf, (split,) if split else (), mi)
            else:
                total += sum(_nbytes(t) for t in _tensors(leaf))
    return total


def _host_read(err: BaseException, dev: torch.device) -> Optional[str]:
    """Where a meta run stopped on a host read or a data-dependent shape ->
    "file:line: source" of the port's frame that asked, else None."""
    msg = str(err)
    if dev.type != "meta" or not isinstance(err, (RuntimeError, NotImplementedError)):
        return None
    if "meta" not in msg.lower() and "data-dependent" not in msg.lower():
        return None
    frames = [f for f in traceback.extract_tb(err.__traceback__)
              if f"{os.sep}repro_torch{os.sep}" in f.filename and f.filename != __file__]
    where = frames[-1] if frames else traceback.extract_tb(err.__traceback__)[-1]
    path = where.filename.split(f"{os.sep}src{os.sep}")[-1]
    return f"{path}:{where.lineno}: {where.line} ({msg.splitlines()[0][:120]})"


def dryrun_cell(arch_name: str, shape: str, *, multi_pod: bool, out_dir: Optional[str],
                device: str = "meta") -> dict:
    dev = torch.device(device)
    mi = make_production_meshinfo(multi_pod=multi_pod, device=dev)
    mesh = mi.mesh
    arch = get_arch(arch_name)
    cell = arch.make_cell(shape, mi)
    record = {
        "cell": cell.name,
        "kind": cell.kind,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": len(mesh.devices),
        "note": cell.note,
        "device": dev.type,
        "source": "measured",
        "stopped_at": None,
        "inputs_s": None,
        "lower_s": None,
        "compile_s": None,
        "memory": dict.fromkeys(("argument_bytes", "output_bytes", "temp_bytes", "peak_bytes")),
        "cost": dict.fromkeys(("flops", "bytes_accessed", "transcendentals")),
        "collectives": None,
    }
    t0 = time.perf_counter()
    args = None
    try:
        args = cell.make_inputs(0, dev)
        record["inputs_s"] = time.perf_counter() - t0
        record["memory"]["argument_bytes"] = argument_bytes(cell, args, mi, arch)
        counter = StepCounter()
        counter.hold(_tensors(args))
        t0 = time.perf_counter()
        with collectives.tally() as tally, counter:
            out = cell.fn(*args)
        record["lower_s"] = time.perf_counter() - t0
        held = {_storage_key(a) for a in _tensors(args)}
        outs = [t for t in _tensors(out) if _storage_key(t) not in held]
        record["memory"].update(output_bytes=sum(_nbytes(t) for t in outs),
                                temp_bytes=counter.peak, peak_bytes=counter.held + counter.peak)
        record["cost"] = dict(flops=counter.flops, bytes_accessed=counter.accessed,
                              transcendentals=counter.transcendentals)
        record["collectives"] = tally.result()
        del out
    except (RuntimeError, NotImplementedError) as e:
        where = _host_read(e, dev)
        if where is None:
            raise
        from repro_torch.roofline.report import terms_for_cell

        t = terms_for_cell(arch_name, shape, len(mesh.devices))
        record.update(source="analytic", stopped_at=where)
        record["cost"] = dict(flops=t.flops, bytes_accessed=t.hbm_bytes, transcendentals=None)
    print(f"=== {cell.name} @ {record['mesh']} ({record['device']}, {record['source']}) ===")
    if record["stopped_at"]:
        print("stopped at:", record["stopped_at"])
    print("memory:", json.dumps(record["memory"]))
    print("cost: flops={flops} bytes={bytes_accessed}".format(**record["cost"]))
    if record["collectives"] is not None:
        print("collective_bytes:", json.dumps(record["collectives"]["per_op_bytes"]))
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{cell.name.replace(':', '_')}_{record['mesh'].replace('x', '-')}"
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(record, f, indent=2)
    return record


def all_cells() -> list:
    from repro_torch.configs import ASSIGNED

    cells = []
    for a in ASSIGNED + ("airship-sift1m",):
        for s in get_arch(a).shape_names():
            cells.append((a, s))
    return cells


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--device", default="meta", choices=("meta", "cpu"),
                    help="meta: shapes only (the default); cpu: the step run for real")
    args = ap.parse_args(argv)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    targets = all_cells() if args.all else [(args.arch, args.shape)]
    failures, analytic = [], []
    t0 = time.perf_counter()
    for arch_name, shape in targets:
        for mp in meshes:
            try:
                rec = dryrun_cell(arch_name, shape, multi_pod=mp, out_dir=args.out,
                                  device=args.device)
                if rec["source"] == "analytic":
                    analytic.append(rec["cell"])
            except Exception as e:  # noqa: BLE001 (report, keep sweeping)
                failures.append((arch_name, shape, mp, repr(e)))
                print(f"FAILED {arch_name}:{shape} multi_pod={mp}: {e}")
                traceback.print_exc()
    print(f"\n{len(targets) * len(meshes)} runs in {time.perf_counter() - t0:.1f} s; "
          f"{len(analytic)} analytic: {', '.join(analytic) or 'none'}")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nALL DRY-RUN CELLS PASSED")


if __name__ == "__main__":
    main()
