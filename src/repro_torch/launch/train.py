"""Training driver (port of ``repro.launch.train``): ``--arch <id>``, a mesh
where the machine has several cards, and fault tolerance.

Fault model, the reference's:
  * a checkpoint every ``--ckpt-every`` steps, atomic (a manifest and a
    rename), pruned to the newest ``--keep``;
  * resume = restore the latest checkpoint, then skip data
    deterministically: each batch is a pure function of (seed, step)
    (``data/pipeline.py``), so no data state is checkpointed;
  * stragglers: a step longer than ``--step-deadline-x`` times the median
    of the last 20 steps is logged; past ``--max-straggles`` the driver
    checkpoints and exits with 17, the scheduler's contract for "replace
    this host";
  * the NaN guard: a step whose loss is not finite leaves the parameters
    and the optimizer's state as they were (``make_train_step``'s
    ``skip_nonfinite``, which decides before the step's first write).

A checkpoint is labelled by the steps it holds: ``step_<N>`` is the state
after steps 0..N-1, and a resumed run starts at step N, so each step is
applied once and a killed-and-resumed run ends where an uninterrupted one
does. The reference labels its periodic checkpoints by the step just
taken, so its resume takes that step a second time.

On a machine with more than one CUDA device (and ``--device cuda``) the
cell runs over the reference's (device_count, 1) mesh; otherwise on the
one device named (``--device cuda:0`` for one card of several). Over the
mesh the cell holds what its layout splits or replicates as blocks on
each position, with their optimizer state (``distributed.layout.Resident``:
the recsys tables, the LM's routed experts, MACE's parameters in the
dst-partitioned layout); the other parameters stay whole on the first
card. On the card, the scatter-adds of the embedding
gradients add in no fixed order, so two runs of one step part by
rounding; ``--deterministic`` turns on PyTorch's deterministic algorithms
(with cuBLAS's fixed workspace), and a resumed run then repeats the
uninterrupted one bit for bit on the card as on the CPU.

    python -m repro_torch.launch.train --arch smoke-gqa --steps 20 [--device cpu]
"""
from __future__ import annotations

import argparse
import math
import os
import statistics
import tempfile
import time
from typing import Optional

import torch

from repro_torch.archs import get_arch
from repro_torch.archs.recsys import shape_batch
from repro_torch.ckpt import checkpoint as ck
from repro_torch.common.device import resolve_device
from repro_torch.data.pipeline import lm_batch
from repro_torch.distributed import MeshInfo
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.train import param_leaves

clock = time.perf_counter  # the step clock (a test drives stragglers through it)


def make_batch_fn(arch, shape: str, device="cuda", mi=None):
    """(seed, step) -> the batch of ``arch``'s train ``shape`` on ``device``:
    ``lm_batch`` at the shape's batch and length, the recsys model's
    generator (``shape_batch``), or the GNN cell's graph (``GNNArch.batch``,
    the dst-partitioned layout's over ``mi``'s shards). The reference's
    GNN batch function draws species from 32 whatever the config and
    leaves every mode's own inputs out; the port's is the cell's own."""
    sh = arch.shapes[shape]
    if arch.family == "lm":
        b, s, vocab = sh["global_batch"], sh["seq_len"], arch.cfg.vocab_size
        return lambda seed, step: lm_batch(seed, step, b, s, vocab, device=device)
    if arch.family == "recsys":
        return lambda seed, step: shape_batch(arch.cfg, shape, seed, step, shapes=arch.shapes,
                                              device=device)
    if arch.family == "gnn":
        return lambda seed, step: arch.batch(shape, seed, step, device, mi)
    raise ValueError(f"no batch fn for family {arch.family}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None, help="train shape name")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--step-deadline-x", type=float, default=3.0)
    ap.add_argument("--max-straggles", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--deterministic", action="store_true",
                    help="PyTorch's deterministic algorithms: runs repeat bit for bit")
    return ap.parse_args(argv)


def train_mesh(dev: torch.device) -> Optional[MeshInfo]:
    """The reference's (device_count, 1) mesh where ``dev`` is "cuda" on a
    machine of several cards, else None (one device)."""
    if dev.type != "cuda" or dev.index is not None or torch.cuda.device_count() < 2:
        return None
    return MeshInfo(make_test_mesh(torch.cuda.device_count(), model=1, device="cuda"))


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # before cuBLAS starts
        torch.use_deterministic_algorithms(True)
    dev = resolve_device(args.device)
    arch = get_arch(args.arch)
    shape = args.shape or next(s for s in arch.shape_names() if arch.shapes[s]["kind"] == "train")
    mi = train_mesh(dev)
    cell = arch.make_cell(shape, mi)
    model, opt_state, _ = cell.make_inputs(args.seed, dev)
    batch_fn = make_batch_fn(arch, shape, dev, mi)

    def state():
        return {"params": param_leaves(model), "opt": opt_state}

    start = ck.latest_step(args.ckpt_dir)
    if start is not None:
        print(f"[resume] restoring step {start}", flush=True)
        live = state()
        restored = ck.restore(args.ckpt_dir, start, live)
        with torch.no_grad():
            for dst, src in zip(_leaves(live), _leaves(restored)):
                dst.copy_(src)
    else:
        start = 0

    times: list[float] = []
    straggles = 0
    for step in range(start, args.steps):
        t0 = clock()
        batch = batch_fn(args.seed, step)
        model, opt_state, metrics = cell.fn(model, opt_state, batch, skip_nonfinite=True)
        loss = float(metrics["loss"])
        dt = clock() - t0
        if not math.isfinite(loss):
            print(f"[nan-guard] step {step}: non-finite loss, skipping update", flush=True)
        if times and dt > args.step_deadline_x * statistics.median(times):
            straggles += 1
            print(f"[straggler] step {step} took {dt:.2f}s (median "
                  f"{statistics.median(times):.2f}s) [{straggles}/{args.max_straggles}]",
                  flush=True)
            if straggles >= args.max_straggles:
                ck.save(args.ckpt_dir, step + 1, state())
                raise SystemExit(17)  # scheduler contract: replace me
        times = (times + [dt])[-20:]
        if step % 10 == 0:
            print(f"step {step:5d} loss={loss:.4f} ({dt * 1e3:.0f} ms)", flush=True)
        done = step + 1
        if done % args.ckpt_every == 0 and done < args.steps:
            ck.save(args.ckpt_dir, done, state())
            ck.prune_old(args.ckpt_dir, keep=args.keep)
    ck.save(args.ckpt_dir, args.steps, state())
    print("training complete", flush=True)
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k])
    else:
        yield tree


if __name__ == "__main__":
    raise SystemExit(main())
