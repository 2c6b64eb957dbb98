"""chip_smoke.py's phase 12c alone, then the memory of cuda:0's share of the
four-card deepseek-v3-671b cell on one card.

    python3 tools/moe_mesh_calibration.py     # on a machine with a CUDA device

12c is deepseek-v2-236b's train_4k at phase 10's cut over a (1, 4) mesh of
cuda:0, its experts four resident parts (``chip_smoke.moe_mesh_part``).
In ``tools/four_card_mesh.py``'s deepseek-v3-671b cell cuda:0 holds the
dense layers, the embedding, the head and the MTP block whole with their
state, beside a quarter of the 256 experts; here that share runs on one
device without a mesh (one MoE layer of 64 experts, B 4, grad_accum 4) at
dense depths 3, 2 and 1, two steps each, one ``v3cal {...}`` line each
with the peak (an out-of-memory error is reported, not raised).
"""
import dataclasses
import gc
import json
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402 (sets the allocator before torch)
import torch  # noqa: E402


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    args = types.SimpleNamespace(seed=0, card=smi.splitlines()[0])
    print(args.card, flush=True)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    cs.moe_mesh_part(args, dev)
    print(f"12c wall {time.perf_counter() - t0:.1f} s", flush=True)

    from repro_torch.archs import get_arch
    from repro_torch.archs.lm import LMArch
    from repro_torch.data import lm_batch

    base = get_arch("deepseek-v3-671b")
    for dense in (3, 2, 1):
        cfg = dataclasses.replace(base.cfg, n_layers=dense + 1, n_dense_layers=dense,
                                  n_experts=64)
        shapes = {"train_4k": dict(base.shapes["train_4k"], global_batch=4)}
        arch = LMArch(cfg, base.optimizer_name, shapes, base.grad_accum)
        try:
            row, unmoved = cs.train_cell_run(
                arch.make_cell("train_4k"), dev, 0, 2,
                lambda step: lm_batch(0, step, 4, 4096, cfg.vocab_size, device=dev))
            print("v3cal " + json.dumps(dict(
                dense=dense, experts=64, peak_gb=row["peak_gb"], step_s=row["step_s"],
                init_s=row["init_s"], params=row["params"], unmoved=unmoved,
                metrics=row["metrics"])), flush=True)
        except torch.cuda.OutOfMemoryError as e:
            print("v3cal " + json.dumps(dict(
                dense=dense, experts=64, oom=str(e)[:300],
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)), flush=True)
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
