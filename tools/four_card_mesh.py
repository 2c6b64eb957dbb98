"""Training over a mesh of four distinct cards, against the same mesh on one card.

    python3 tools/four_card_mesh.py [--repeat N]   # on a machine with four CUDA devices

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
smoke-deepfm, smoke-two-tower and smoke-sasrec over (2, 2) (their tables
resident as blocks); smoke-mla-moe train_4k (MTP, router_aux_coef 0.01)
over (1, 4) and (2, 2) (its experts resident as blocks, one a card);
smoke-mace's ogb_products layout over (1, 4), float32 (its parameters
four replicas, one a card).

Then two cells that train at full width with every leaf resident as its
blocks (the experts, attention, the feed-forwards, the embedding and the
head a quarter a card, the norms and the router a replica a card) and
Adafactor's state beside them, the step tensor-parallel (finite losses;
every leaf moved but the bf16 leaves whose update rounds away, and every
leaf's first moment non-zero, as chip_smoke.py phase 10 checks; every part
and statistic in its storage after the steps; each card's resident bytes
and peak): deepseek-v2-236b train_4k at phase 10's cut (1 dense + 1 MoE
layer, 160 experts, batch 2, grad_accum 2), the cell of phase 12c, and
deepseek-v3-671b train_4k with its published 3 dense layers and one MoE
layer (256 experts, 11.3e9 expert parameters: 22.5 GB in bf16, about 90 GB
with their gradients and float32 accumulation, which no one card holds)
and its batch kept at 4 (grad_accum 4) (PERF.md section 4 has the
reckoning and the one-card calibration behind the cut).

Then serving over the four cards: deepseek-v2-236b's long_500k decode at
chip_smoke.py phase 9d's cut (1 dense + 2 MoE layers, one sequence against
a 524,288-token latent cache, four steps from one random cache), the model
made resident over (1, 4) of the cards by the cell's ``fn`` (each card a
quarter of every split leaf and its own sequence shard of the cache), the
step tensor-parallel, against the same over (1, 4) of cuda:0: each step
whose MoE layers route its token alike held within 9d's bf16 limit
(``DS_MESH_TOL``), at least one step held, no weight moved (the tally),
each card's peak and the step walls.

Then the training driver on the four cards (its (4, 1) mesh) for
smoke-two-tower and smoke-gqa, the two at once: 8 steps, then a second
process resuming to 12. Last, the driver's default on a machine of
several cards against one card: deepfm as published (B 65,536) for 21
steps with ``--device cuda`` (the (4, 1) mesh, its dim-10 tables a
replica a card, their gradients summed over the rows the groups read)
and with ``--device cuda:0``, the walls of steps 10 and 20 as the driver
prints them (host clock, each ending in the loss's read).

One line a case. ``--repeat N`` runs every case N times in rounds and
counts each case's failures; a failing case (an exception included) does
not stop the round. ``--only CASE ...`` runs only the cases named as the
summary names them (a chip call of four cards costs four times its
seconds: a repair is rerun on the cases it touches). It exits nonzero on any failure. Without four CUDA
devices it exits nonzero before running anything.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# the full-width cells hold most of cuda:0: segments that grow in place keep
# the caching allocator from pinning half-used blocks (chip_smoke.py does so)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402 (after the allocator's setting)

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
    """The driver's printed step walls (ms) over 21 steps on ``device``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch, "--steps", "21",
           "--ckpt-every", "1000", "--ckpt-dir", ckpt_dir, "--device", device]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT, timeout=900)
    walls = {int(ln.split()[1]): float(ln.split("(")[1].split()[0])
             for ln in p.stdout.splitlines() if ln.startswith("step ")}
    return dict(device=device, returncode=p.returncode, process_s=time.perf_counter() - t0,
                step_ms=walls, tail=(p.stdout + p.stderr)[-300:] if p.returncode else "")


# (name, dense layers, layers, sequences, steps): the cuts of the full-width
# cells over (1, 4) of the four cards (PERF.md section 4)
LM_CELLS = (("deepseek-v2-236b", 1, 2, 2, 2), ("deepseek-v3-671b", 3, 4, 4, 2))


def part_ptrs(model, state) -> dict:
    """The data pointers of every resident part and optimizer statistic."""
    from repro_torch.distributed.layout import Blocks
    from repro_torch.train import param_leaves

    out = {k: [p.data_ptr() for p in v.parts] for k, v in param_leaves(model).items()
           if isinstance(v, Blocks)}
    for name, sub in state.items():
        if isinstance(sub, dict):
            out.update({f"{name}:{k}": [p.data_ptr() for p in v.parts]
                        for k, v in sub.items() if isinstance(v, Blocks)})
    return out


def parts_of(v) -> list:
    from repro_torch.distributed.layout import Blocks

    return v.parts if isinstance(v, Blocks) else [v]


def card_bytes(trees, cards) -> list:
    """Each card's bytes of the parts of ``trees``' resident leaves."""
    from repro_torch.distributed.layout import Blocks

    out = [0] * len(cards)
    for tree in trees:
        for v in tree.values():
            for p in (v.parts if isinstance(v, Blocks) else []):
                out[cards.index(p.device)] += p.numel() * p.element_size()
    return out


def leaf_sums(leaves) -> dict:
    return {k: sum(float(p.detach().sum(dtype=torch.float64)) for p in parts_of(v))
            for k, v in leaves.items()}


def lm_mesh_cell(name, dense, layers, batch, steps, cards) -> bool:
    """``name``'s train_4k at full width cut to ``dense`` dense layers of
    ``layers`` and ``batch`` sequences over (1, 4) of the four cards."""
    from repro_torch.archs import get_arch
    from repro_torch.archs.lm import LMArch
    from repro_torch.data import lm_batch
    from repro_torch.models.transformer.model import param_specs
    from repro_torch.train import param_leaves

    base = get_arch(name)
    cfg = dataclasses.replace(base.cfg, n_layers=layers, n_dense_layers=dense)
    shapes = {"train_4k": dict(base.shapes["train_4k"], global_batch=batch)}
    arch = LMArch(cfg, base.optimizer_name, shapes, base.grad_accum)
    seq = shapes["train_4k"]["seq_len"]
    cell_mesh = mesh_of(cards, (1, 4))
    cell = arch.make_cell("train_4k", cell_mesh)
    for c in cards:
        torch.empty(0, device=c)  # a card's allocator starts with its first tensor
        torch.cuda.reset_peak_memory_stats(c)
    t0 = time.perf_counter()
    model, state, data = cell.make_inputs(0, cards[0])
    for c in cards:
        torch.cuda.synchronize(c)
    init_s = time.perf_counter() - t0
    leaves = param_leaves(model)
    before, ptrs = leaf_sums(leaves), part_ptrs(model, state)
    resident_gb = [b / 1e9 for b in card_bytes([leaves], cards)]
    state_gb = [b / 1e9 for b in card_bytes([v for v in state.values() if isinstance(v, dict)],
                                             cards)]
    walls, losses = [], []
    for step in range(steps):
        if step:
            data = lm_batch(0, step, batch, seq, cfg.vocab_size, device=cards[0])
        t0 = time.perf_counter()
        model, state, m = cell.fn(model, state, data)
        for c in cards:
            torch.cuda.synchronize(c)
        walls.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in m.items()})
    after = leaf_sums(param_leaves(model))
    unmoved = [k for k in leaves if after[k] == before[k]]
    bf16 = [k for k in unmoved if leaves[k].dtype == torch.bfloat16]
    silent = [k for k, v in state["m"].items() if not any(bool(p.any()) for p in parts_of(v))]
    in_place = part_ptrs(model, state) == ptrs
    finite = all(math.isfinite(v) for m in losses for v in m.values())
    specs = param_specs(cfg, cell_mesh)
    resident = [k for k in leaves if len(parts_of(leaves[k])) == 4]
    ok = (finite and in_place and not silent and set(resident) == set(specs) == set(leaves)
          and unmoved == bf16)
    print("four_cards " + json.dumps(dict(
        case=f"{name} train_4k", mesh=[1, 4], dense_layers=dense, moe_layers=layers - dense,
        experts=cfg.n_experts, batch=batch, grad_accum=arch.grad_accum, seq=seq,
        params=sum(math.prod(v.shape) for v in leaves.values()), init_s=init_s, step_s=walls,
        step_s_warm=sum(walls[1:]) / max(len(walls) - 1, 1), metrics=losses,
        peak_gb=[torch.cuda.max_memory_allocated(c) / 1e9 for c in cards],
        resident_gb=resident_gb, state_gb=state_gb, leaves=len(leaves),
        resident_leaves=len(resident), parts_in_place=in_place, unmoved_bf16=bf16,
        unmoved_other=[k for k in unmoved if k not in bf16], first_moment_zero=silent,
        ok=ok)), flush=True)
    return ok


def resident_decode(cards) -> bool:
    """deepseek-v2-236b long_500k at phase 9d's cut, resident over (1, 4) of
    the four cards against (1, 4) of cuda:0 (the module docstring)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.data import lm_batch
    from repro_torch.distributed.layout import whole_leaves
    from repro_torch.models.transformer import init_params, shard_cache
    from repro_torch.roofline import collectives

    arch = cs.ds_arch()
    cfg, n = arch.cfg, arch.shapes["long_500k"]["seq_len"]
    tokens = lm_batch(0, 1, 1, cs.LM_DECODE_STEPS, cfg.vocab_size, device=cards[0])["tokens"]
    runs = {}
    for label, devs in (("cuda:0", [cards[0]] * 4), ("four cards", cards)):
        for c in cards:
            torch.empty(0, device=c)
            torch.cuda.reset_peak_memory_stats(c)
        mi = mesh_of(devs, (1, 4))
        model = init_params(torch.Generator(device=cards[0]).manual_seed(0), cfg,
                            device=cards[0])
        hooks_of = cs.norm_route_hooks(model)
        fn = arch.make_cell("long_500k", mi).fn
        cache = shard_cache(cs.lm_cache(cfg, 1, n, 0, cards[0]), mi)
        walls, logits, routes, weights = [], [], [], None
        for t in range(cs.LM_DECODE_STEPS):
            routes.append([])
            hooks = hooks_of(model, routes[-1])
            for c in cards:
                torch.cuda.synchronize(c)
            t0 = time.perf_counter()
            with collectives.tally() as tally:
                lg, cache = fn(model, cache, tokens[:, t])
            for c in cards:
                torch.cuda.synchronize(c)
            walls.append(time.perf_counter() - t0)
            for h in hooks:
                h.remove()
            logits.append(lg.float().cpu())
            weights = dict(tally.weight_counts)
        runs[label] = dict(walls=walls, logits=logits, routes=cs.routes_of(routes),
                           resident=not whole_leaves(model), weight_moves=weights,
                           peak_gb=[torch.cuda.max_memory_allocated(c) / 1e9 for c in cards])
        del model, cache, fn
        gc.collect()
        for c in cards:
            with torch.cuda.device(c):
                torch.cuda.empty_cache()
    one, four = runs["cuda:0"], runs["four cards"]
    errs = [float((a - b).abs().max()) for a, b in zip(four["logits"], one["logits"])]
    flipped = [any(not torch.equal(a, b) for a, b in zip(r4, r1))
               for r4, r1 in zip(four["routes"], one["routes"])]
    held = [e for e, f in zip(errs, flipped) if not f]
    finite = all(bool(torch.isfinite(lg).all()) for lg in four["logits"])
    ok = (finite and bool(held) and max(held) <= cs.DS_MESH_TOL and four["resident"]
          and one["resident"] and not four["weight_moves"] and not one["weight_moves"])
    print("four_cards " + json.dumps(dict(
        case="deepseek-v2-236b long_500k resident", mesh=[1, 4], layers=cfg.n_layers,
        cache_len=n, steps=cs.LM_DECODE_STEPS, step_s=four["walls"],
        one_card_step_s=one["walls"], max_abs_diff=errs, routes_flipped=flipped,
        tolerance=cs.DS_MESH_TOL, weight_moves=four["weight_moves"],
        peak_gb=four["peak_gb"], one_card_peak_gb=one["peak_gb"][0], ok=ok)), flush=True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeat", type=int, default=1, help="rounds of every case")
    ap.add_argument("--only", nargs="+", metavar="CASE",
                    help="run only these cases (the names the summary counts failures by)")
    args = ap.parse_args()
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
    base = get_arch("smoke-mla-moe")
    lm = LMArch(dataclasses.replace(base.cfg, router_aux_coef=0.01), "adamw", base.shapes)
    mace = get_arch("smoke-mace")
    cfg = dataclasses.replace(mace.cfg_for("ogb_products"), compute_dtype=torch.float32)

    def mace_cell(mi):
        cell = mace.make_cell("ogb_products", mi)
        step = make_train_step(lambda m, b: dst_partitioned_loss(m, cfg, mi, b), adamw(lr=1e-3),
                               clip_norm=1.0)
        return dataclasses.replace(cell, fn=step)

    def drivers(tmp) -> bool:
        with ThreadPoolExecutor(2) as pool:  # the two smoke drivers at once
            runs = list(pool.map(lambda a: driver(a, str(Path(tmp) / a)),
                                 ("smoke-two-tower", "smoke-gqa")))
        return all(runs)

    def deepfm(tmp) -> bool:
        runs = [driver_walls("deepfm", d, str(Path(tmp) / f"deepfm-{d}"))
                for d in ("cuda", "cuda:0")]
        print("four_cards " + json.dumps(dict(case="driver deepfm, (4, 1) mesh against one card",
                                              runs=runs)), flush=True)
        return all(r["returncode"] == 0 for r in runs)

    cases = [("pq_adc", lambda tmp: pq_scan_each_card(cards))]
    for name in RECSYS:
        arch = get_arch(name)
        cases.append((name, lambda tmp, a=arch: compare(
            a.name, lambda mi: a.make_cell("train_batch", mi), (2, 2), cards, 0, 1e-3,
            lambda: shape_batch(a.cfg, "train_batch", 0, 1, shapes=a.shapes, device=cards[0]))))
    for grid in ((1, 4), (2, 2)):
        cases.append((f"smoke-mla-moe {grid}", lambda tmp, g=grid: compare(
            "smoke-mla-moe train_4k", lambda mi: lm.make_cell("train_4k", mi), g, cards, 0,
            3e-4, lambda: lm_batch(0, 1, 4, 32, lm.cfg.vocab_size, device=cards[0]))))
    cases.append(("smoke-mace", lambda tmp: compare(
        "smoke-mace ogb_products (float32)", mace_cell, (1, 4), cards, 0, 1e-3,
        lambda: mace.batch("ogb_products", 0, 1, cards[0], mesh_of(cards, (1, 4))))))
    for cut in LM_CELLS:
        cases.append((cut[0], lambda tmp, c=cut: lm_mesh_cell(*c, cards)))
    cases.append(("resident decode", lambda tmp: resident_decode(cards)))
    cases += [("drivers", drivers), ("driver deepfm", deepfm)]
    if args.only:
        unknown = set(args.only) - {name for name, _ in cases}
        if unknown:
            print(f"unknown cases {sorted(unknown)}", file=sys.stderr)
            return 2
        cases = [(name, run) for name, run in cases if name in args.only]

    failed = collections.Counter()
    for r in range(args.repeat):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            for name, run in cases:
                try:
                    ok = run(tmp)
                except Exception:  # a failing case is counted; the round goes on
                    print(f"four_cards case {name} raised:\n{traceback.format_exc()}",
                          flush=True)
                    ok = False
                failed[name] += not ok
                gc.collect()
                for c in cards:
                    with torch.cuda.device(c):
                        torch.cuda.empty_cache()
        print("four_cards " + json.dumps(dict(round=r + 1, of=args.repeat,
                                              round_s=time.perf_counter() - t0,
                                              failed_so_far=dict(failed))), flush=True)
    ok = not sum(failed.values())
    print(json.dumps({"four_cards_ok": ok, "rounds": args.repeat,
                      "failures": {name: failed[name] for name, _ in cases}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    (ROOT / "build").mkdir(exist_ok=True)
    sys.exit(main())
