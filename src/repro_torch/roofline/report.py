"""Roofline report generator (port of ``repro.roofline.report``).

Joins the dry run's records (``launch/dryrun.py``: each position's argument
bytes, the controller's peak) with the analytic model
(``roofline/model.py``: loop-corrected flops, bytes and collectives) and
emits the roofline table of the single-pod mesh.

The port's ``airship_terms`` takes the shards a query is searched on as
``tp``; the reference hard-codes 16, which is the default, so the terms
here are the reference's.
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.archs.base import get_arch
from repro_torch.roofline import model as rm


def terms_for_cell(arch_name: str, shape: str, chips: int) -> rm.RooflineTerms:
    arch = get_arch(arch_name)
    fam = arch.family
    sh = arch.shapes[shape]
    if fam == "lm":
        cfg = arch.cfg
        b, s = sh["global_batch"], sh["seq_len"]
        if sh["kind"] == "train":
            f, h, c, mf = rm.lm_train_terms(cfg, b, s, chips, arch.grad_accum)
        elif shape.startswith("prefill"):
            f, h, c, mf = rm.lm_prefill_terms(cfg, b, s, chips)
        else:
            f, h, c, mf = rm.lm_decode_terms(cfg, b, s, chips)
    elif fam == "gnn":
        from repro_torch.models.gnn.sampler import subgraph_sizes

        cfg = arch.base_cfg
        mode = sh["mode"]
        if mode == "sampled":
            n, e = subgraph_sizes(sh["batch_nodes"], sh["fanouts"])
        elif mode == "batched":
            n, e = sh["n_nodes"] * sh["batch"], sh["n_edges"] * sh["batch"]
        else:
            n, e = sh["n_nodes"], sh["n_edges"]
        f, h, c, mf = rm.mace_terms(cfg, n, e, chips, mode)
    elif fam == "recsys":
        cfg = arch.cfg
        f, h, c, mf = rm.recsys_terms(cfg, sh["batch"], chips, sh["kind"],
                                      sh.get("n_candidates", 0))
    else:  # airship
        f, h, c, mf = rm.airship_terms(arch.cfg, sh["batch"], chips)
    return rm.RooflineTerms(cell=f"{arch_name}:{shape}", mesh=f"{chips}chips", chips=chips,
                            flops=f, hbm_bytes=h, coll_bytes=c, model_flops=mf)


def load_dryrun(artifact_dir: str) -> dict:
    """{(cell, mesh): record} of every ``*.json`` record in ``artifact_dir``."""
    recs = {}
    for path in glob.glob(os.path.join(artifact_dir, "*.json")):
        with open(path) as f:
            r = json.load(f)
        recs[(r["cell"], r["mesh"])] = r
    return recs


def markdown_table(artifact_dir: str = "artifacts/dryrun", chips: int = 256):
    """Per-cell roofline table for the single-pod mesh -> (the table's text,
    [(cell, terms, GB)]). The last column is a position's argument bytes
    plus the controller's temporaries (``temp_bytes``: one device held
    every position's work, so this is the reference's per-chip figure only
    where the step's temporaries are a position's); a record that took
    its cost from the model (``source`` analytic) has no temporaries."""
    recs = load_dryrun(artifact_dir)
    lines = [
        "| cell | t_compute | t_memory | t_collective | bottleneck | "
        "model/HLO flops | roofline fraction | peak GB/chip (measured) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    rows = []
    for (cell, mesh), rec in sorted(recs.items()):
        if mesh != "16x16":
            continue
        arch_name, shape = cell.split(":")
        try:
            t = terms_for_cell(arch_name, shape, chips)
        except Exception as e:  # noqa: BLE001 (one bad cell keeps the table)
            lines.append(f"| {cell} | model-error: {e} |")
            continue
        temp = rec["memory"]["temp_bytes"] or 0
        args = rec["memory"]["argument_bytes"] or 0
        rows.append((cell, t, (temp + args) / 1e9))
        lines.append(
            f"| {cell} | {t.t_compute*1e3:.2f} ms | {t.t_memory*1e3:.2f} ms | "
            f"{t.t_collective*1e3:.2f} ms | **{t.bottleneck}** | "
            f"{t.useful_fraction:.2f} | {t.roofline_fraction:.3f} | "
            f"{(temp + args)/1e9:.1f} |"
        )
    return "\n".join(lines), rows


if __name__ == "__main__":
    table, _ = markdown_table()
    print(table)
