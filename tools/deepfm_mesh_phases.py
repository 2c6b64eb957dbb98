"""deepfm's train step split into its phases, on the (4, 1) mesh of four cards
and on cuda:0.

    python3 tools/deepfm_mesh_phases.py     # on a machine with four CUDA devices

deepfm as published (B 65,536, AdamW lr 1e-3): the cell's model and batch
over ``make_test_mesh(4, model=1)`` (each position its own card; the
tables that the data axis cannot split a replica a card) and then on
cuda:0 alone. Each phase ends in a sync of every card (host clock): the
loss, the backward (``train_step.gradients`` less its replica sums), the
replica sums (``train_step._sum_replicas``), the AdamW updates. Six steps,
the first a warm-up; one ``deepfm_breakdown {...}`` line of medians in ms.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.archs import get_arch  # noqa: E402
from repro_torch.archs.recsys import shape_batch  # noqa: E402
from repro_torch.distributed import MeshInfo  # noqa: E402
from repro_torch.distributed.layout import Blocks  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.train import adamw, apply_updates, param_leaves  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    cards = [torch.device("cuda", i) for i in range(4)]

    def sync():
        for c in cards:
            torch.cuda.synchronize(c)

    arch = get_arch("deepfm")
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.splitlines()[0]}
    real_sum = ts._sum_replicas
    for name, mi in (("p4x1", MeshInfo(make_test_mesh(4, model=1, device="cuda"))),
                     ("cuda0", None)):
        cell = arch.make_cell("train_batch", mi)
        model, _, batch = cell.make_inputs(0, cards[0])
        opt = adamw(lr=1e-3)
        state = ts.init_state(opt, model)
        t = {k: [] for k in ("loss", "backward", "replica_sums", "updates", "step")}
        spent = []

        def timed_sum(g, rows=None):
            sync()
            t0 = time.perf_counter()
            r = real_sum(g, rows)
            sync()
            spent.append(time.perf_counter() - t0)
            return r

        ts._sum_replicas = timed_sum
        for step in range(6):
            b = shape_batch(arch.cfg, "train_batch", 0, step, shapes=arch.shapes,
                            device=cards[0])
            sync()
            t0 = time.perf_counter()
            with torch.enable_grad():
                loss, _ = arch.loss(model, b, mi)
                sync()
                t1 = time.perf_counter()
                spent.clear()
                grads = ts.gradients(model, loss)
            sync()
            t2 = time.perf_counter()
            params = param_leaves(model)
            for k in list(grads):
                u, state2 = opt.update({k: grads.pop(k)}, state, {k: params[k]})
                apply_updates({k: params[k]}, u)
            state = state2
            sync()
            t3 = time.perf_counter()
            if step:
                sums = sum(spent)
                t["loss"].append(t1 - t0)
                t["backward"].append(t2 - t1 - sums)
                t["replica_sums"].append(sums)
                t["updates"].append(t3 - t2)
                t["step"].append(t3 - t0)
        ts._sum_replicas = real_sum
        out[name] = {k: 1e3 * statistics.median(v) for k, v in t.items()}
        out[name]["replicated_leaves"] = sum(
            1 for v in param_leaves(model).values()
            if isinstance(v, Blocks) and len(v.layout.replicas()[0]) > 1)
        del model, state, grads, batch
        torch.cuda.empty_cache()
    print("deepfm_breakdown " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
