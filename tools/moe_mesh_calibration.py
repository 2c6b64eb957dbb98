"""chip_smoke.py's phase 12c alone, then the memory of one card's share of
the four-card deepseek-v3-671b cell on one card.

    python3 tools/moe_mesh_calibration.py     # on a machine with a CUDA device

12c is deepseek-v2-236b's train_4k at phase 10's cut over a (1, 4) mesh of
cuda:0, every leaf resident (``chip_smoke.moe_mesh_part``). In
``tools/four_card_mesh.py``'s deepseek-v3-671b cell each card holds a
quarter of every split leaf (32 of the 128 heads, a quarter of the dense
feed-forward columns and of the vocabulary, 64 of the 256 experts) with
its state, and computes on the whole residual stream. Here that share
runs on one device without a mesh, as the config with those quarters
(n_heads 32, d_ff 4,608, vocab 32,384 padded to 32,768, 64 experts, B 4, grad_accum 4; the shared
expert, the low-rank projections and MTP's proj kept whole, which
overstates the share by ~0.1e9 parameters; the moves' buffers on the
card that sums a row-parallel product are not in it) at dense depths 3, 2
and 1, two steps each, one ``v3cal {...}`` line each with the peak (an
out-of-memory error is reported, not raised).
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
                                  n_experts=64, n_heads=base.cfg.n_heads // 4,
                                  d_ff=base.cfg.d_ff // 4,
                                  vocab_size=base.cfg.vocab_padded // 4)
        shapes = {"train_4k": dict(base.shapes["train_4k"], global_batch=4)}
        arch = LMArch(cfg, base.optimizer_name, shapes, base.grad_accum)
        try:
            row, unmoved = cs.train_cell_run(
                arch.make_cell("train_4k"), dev, 0, 2,
                lambda step: lm_batch(0, step, 4, 4096, cfg.vocab_size, device=dev))
            print("v3cal " + json.dumps(dict(
                dense=dense, experts=64, heads=cfg.n_heads, d_ff=cfg.d_ff,
                vocab_padded=cfg.vocab_padded, peak_gb=row["peak_gb"], step_s=row["step_s"],
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
