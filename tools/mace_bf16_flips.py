"""smoke-mace's ogb_products cell (bf16) on the card against the CPU, repeated.

    python3 tools/mace_bf16_flips.py [--repeats 6] [--deterministic]

One AdamW step of the cell from seeds 0-2, the CPU once and the card
``--repeats`` times from the same start: the cell's bf16 total energy and
every metric's relative difference from the CPU's, one line a run. The
card's segment sums (``index_add`` in bf16) add in no fixed order, and the
total energy is a bf16 number, so a run can land it one ulp from the
CPU's: the energy term then moves by about 2 ulp(e) / |e - target| of
itself. ``--deterministic`` runs the card under PyTorch's deterministic
algorithms (a fixed add order). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import copy
import os
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=6)
    ap.add_argument("--deterministic", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.archs import get_arch
    from repro_torch.distributed.meshinfo import single_device_meshinfo
    from repro_torch.models.gnn.distributed import dst_partitioned_energy
    from repro_torch.train.parity import tree_to

    if args.deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # before cuBLAS starts
        torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py sets them
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    arch = get_arch("smoke-mace")
    cell, cfg = arch.make_cell("ogb_products"), arch.cfg_for("ogb_products")

    def energy(model, batch):
        mi = single_device_meshinfo(model.embed.weight.device)
        with torch.no_grad():
            return float(dst_partitioned_energy(model, cfg, mi, batch))

    for seed in (0, 1, 2):
        model, state, batch = cell.make_inputs(seed, "cpu")
        e_cpu = energy(model, batch)
        _, _, m = cell.fn(copy.deepcopy(model), tree_to(state, "cpu"), batch)
        want = {k: float(v) for k, v in m.items()}
        print(seed, "cpu", f"energy {e_cpu!r}", {k: f"{v:.6g}" for k, v in want.items()},
              flush=True)
        for rep in range(args.repeats):
            card, card_batch = copy.deepcopy(model).to("cuda"), tree_to(batch, "cuda")
            e = energy(card, card_batch)
            _, _, m = cell.fn(card, tree_to(state, "cuda"), card_batch)
            got = {k: float(v) for k, v in m.items()}
            rel = {k: f"{abs(got[k] - want[k]) / abs(want[k]):.3e}" for k in want}
            print(seed, rep, f"energy {e!r}", rel, "card", {k: f"{v:.6g}" for k, v in got.items()},
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
