"""Training over a mesh of four distinct cards, against the same mesh on one card.

    python3 tools/four_card_mesh.py          # on a machine with four CUDA devices

First, one PQ scan (``pq_adc``) on each card in turn, its table staged in
more shared memory than the 48 KB a launch gets unasked (m_sub 16 x 256
centroids x 4 B = 16 KB a query, 8 queries a block: 128 KB), each held bit
for bit to its plain version on integer-valued tables: the kernel's
shared-memory limit is a property of each card, so every card must be
given it.

One card can only hold a mesh that repeats cuda:0 (chip_smoke.py phase 12);
this run puts each position on its own card, so every move of a table's
block, an expert shard, a graph shard or a data group's ids crosses
cards, and every kernel (the two-tower bag and its backward) launches on
the card its inputs live on. For each smoke train cell it takes two steps
from one seed over a mesh of cuda:0..3 and over the same mesh of cuda:0,
and holds the first to the second by ``train/parity.py``'s float32 limits
(the card's scatter-adds add in no fixed order): smoke-dlrm,
smoke-deepfm, smoke-two-tower and smoke-sasrec over (2, 2); smoke-mla-moe
train_4k (MTP, router_aux_coef 0.01) over (1, 4) and (2, 2); smoke-mace's
ogb_products layout over (1, 4), float32. Then the training driver on the
four cards (its (4, 1) mesh) for smoke-two-tower and smoke-gqa: 8 steps,
then a second process resuming to 12. Last, the driver's default on a
machine of several cards against one card: deepfm as published (B
65,536) for 31 steps with ``--device cuda`` (the (4, 1) mesh) and with
``--device cuda:0``, the walls of steps 10, 20 and 30 as the driver
prints them (host clock, each ending in the loss's read). One line a
case; it exits nonzero on any failure. Without four CUDA devices it exits
nonzero before running anything.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

RECSYS = ("smoke-dlrm", "smoke-deepfm", "smoke-two-tower", "smoke-sasrec")


def mesh_of(devices, grid):
    from repro_torch.distributed import DeviceMesh, MeshInfo

    return MeshInfo(DeviceMesh.create(devices, grid, ("data", "model")))


def two_steps(cell, seed, dev, next_batch):
    """Two steps of ``cell`` from ``make_inputs(seed, dev)`` -> (start,
    leaves after step 1, metrics of both steps), leaves as CPU snapshots."""
    from repro_torch.train.parity import snapshot

    model, state, batch = cell.make_inputs(seed, dev)
    start = snapshot(model)
    model, state, m1 = cell.fn(model, state, batch)
    p1 = snapshot(model)
    _, _, m2 = cell.fn(model, state, next_batch())
    return start, p1, (m1, m2)


def compare(name, make_cell, grid, cards, seed, lr, next_batch) -> bool:
    """``make_cell(mi)``'s two steps over ``grid`` of the four cards against
    the same grid of cuda:0."""
    from repro_torch.train.parity import failures, readings

    n = grid[0] * grid[1]
    t0 = time.perf_counter()
    start, want_p, want = two_steps(make_cell(mesh_of([cards[0]] * n, grid)), seed, cards[0],
                                    next_batch)
    t1 = time.perf_counter()
    _, got_p, got = two_steps(make_cell(mesh_of(cards[:n], grid)), seed, cards[0], next_batch)
    t2 = time.perf_counter()
    r = readings(start, want_p, got_p, want, got, lr)
    bad = failures(r, lr, "float32")
    print("four_cards " + json.dumps(dict(
        case=name, mesh=list(grid), one_card_s=t1 - t0, four_cards_s=t2 - t1,
        loss=[float(m["loss"]) for m in got], one_card_loss=[float(m["loss"]) for m in want],
        rel=r["rel"], worst=r["worst"], leaf_far=r["leaf_far"], control=r["control"],
        failures=bad)), flush=True)
    return not bad


PQ_SCAN = dict(b=64, n=100_000, m_sub=16, n_cent=256)


def pq_scan_each_card(cards) -> bool:
    """One ``pq_adc`` scan a card, in turn, against its plain version."""
    from repro_torch.kernels.pq_adc import SMEM_LIMIT, pq_adc, pq_adc_plain

    b, n, m_sub, n_cent = (PQ_SCAN[k] for k in ("b", "n", "m_sub", "n_cent"))
    gen = torch.Generator().manual_seed(0)
    lut = torch.randint(0, 64, (b, m_sub, n_cent), generator=gen).float()
    codes = torch.randint(0, n_cent, (n, m_sub), generator=gen, dtype=torch.int32)
    want = pq_adc_plain(lut, codes)
    table = m_sub * n_cent * 4
    # queries a block stages, by the kernel's rule
    per_block = next(q for q in (32, 16, 8, 4, 2, 1) if SMEM_LIMIT // table >= q)
    ok = True
    for card in cards:
        launches = pq_adc.launches
        got = pq_adc(lut.to(card), codes.to(card)).cpu()
        same = torch.equal(got, want) and pq_adc.launches == launches + 1
        print("four_cards " + json.dumps(dict(
            case="pq_adc", card=str(card), batch=b, rows=n, table_bytes=table,
            staged_bytes=per_block * table, equal_plain=same)), flush=True)
        ok &= same
    return ok


def driver(arch, ckpt_dir) -> bool:
    """The driver on every card: 8 steps, then a second process to 12."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch, "--ckpt-every", "4",
           "--ckpt-dir", ckpt_dir]
    outs = []
    for steps in ("8", "12"):
        p = subprocess.run(cmd + ["--steps", steps], capture_output=True, text=True, env=env,
                           cwd=ROOT, timeout=600)
        outs.append(p)
    ok = (all(p.returncode == 0 for p in outs) and "[resume] restoring step 8" in outs[1].stdout
          and "training complete" in outs[1].stdout)
    print("four_cards " + json.dumps(dict(
        case=f"driver {arch}", returncodes=[p.returncode for p in outs],
        resumed="[resume] restoring step 8" in outs[1].stdout,
        tail=(outs[1].stdout + outs[1].stderr)[-400:])), flush=True)
    return ok


def driver_walls(arch, device, ckpt_dir) -> dict:
    """The driver's printed step walls (ms) over 31 steps on ``device``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch, "--steps", "31",
           "--ckpt-every", "1000", "--ckpt-dir", ckpt_dir, "--device", device]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT, timeout=900)
    walls = {int(ln.split()[1]): float(ln.split("(")[1].split()[0])
             for ln in p.stdout.splitlines() if ln.startswith("step ")}
    return dict(device=device, returncode=p.returncode, process_s=time.perf_counter() - t0,
                step_ms=walls, tail=(p.stdout + p.stderr)[-300:] if p.returncode else "")


def main() -> int:
    if torch.cuda.device_count() < 4:
        print(f"needs four CUDA devices; this machine has {torch.cuda.device_count()}",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi.replace("\n", "; "), flush=True)
    from repro_torch.archs import get_arch
    from repro_torch.archs.lm import LMArch
    from repro_torch.archs.recsys import shape_batch
    from repro_torch.data import lm_batch
    from repro_torch.kernels import build_all
    from repro_torch.models.gnn.distributed import dst_partitioned_loss
    from repro_torch.train import adamw, make_train_step

    build_all()
    cards = [torch.device("cuda", i) for i in range(4)]
    ok = pq_scan_each_card(cards)
    for name in RECSYS:
        arch = get_arch(name)
        ok &= compare(name, lambda mi, a=arch: a.make_cell("train_batch", mi), (2, 2), cards, 0,
                      1e-3, lambda a=arch: shape_batch(a.cfg, "train_batch", 0, 1,
                                                      shapes=a.shapes, device=cards[0]))
    base = get_arch("smoke-mla-moe")
    lm = LMArch(dataclasses.replace(base.cfg, router_aux_coef=0.01), "adamw", base.shapes)
    for grid in ((1, 4), (2, 2)):
        ok &= compare("smoke-mla-moe train_4k", lambda mi: lm.make_cell("train_4k", mi), grid,
                      cards, 0, 3e-4,
                      lambda: lm_batch(0, 1, 4, 32, lm.cfg.vocab_size, device=cards[0]))
    mace = get_arch("smoke-mace")
    cfg = dataclasses.replace(mace.cfg_for("ogb_products"), compute_dtype=torch.float32)

    def mace_cell(mi):
        cell = mace.make_cell("ogb_products", mi)
        step = make_train_step(lambda m, b: dst_partitioned_loss(m, cfg, mi, b), adamw(lr=1e-3),
                               clip_norm=1.0)
        return dataclasses.replace(cell, fn=step)

    ok &= compare("smoke-mace ogb_products (float32)", mace_cell, (1, 4), cards, 0, 1e-3,
                  lambda: mace.batch("ogb_products", 0, 1, cards[0], mesh_of(cards, (1, 4))))
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for arch in ("smoke-two-tower", "smoke-gqa"):
            ok &= driver(arch, str(Path(tmp) / arch))
        runs = [driver_walls("deepfm", d, str(Path(tmp) / f"deepfm-{d}"))
                for d in ("cuda", "cuda:0")]
        ok &= all(r["returncode"] == 0 for r in runs)
        print("four_cards " + json.dumps(dict(case="driver deepfm, (4, 1) mesh against one card",
                                              runs=runs)), flush=True)
    print(json.dumps({"four_cards_ok": bool(ok)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    (ROOT / "build").mkdir(exist_ok=True)
    sys.exit(main())
