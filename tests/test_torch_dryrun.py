"""The dry run (``launch/dryrun.py``), port against reference.

smoke-airship:serve_256 on the 16x16 production mesh: the reference lowers
and compiles it (``python -m repro.launch.dryrun`` in a subprocess, its
512 virtual host devices set before JAX starts), the port runs it on the
meta device (stopped by the walk's host read: an analytic record) and on
the CPU (measured). One position's arguments are 13,000 B on all three:
128 corpus rows x 16 x 4 B, labels 512, neighbours 4,096, samples 128,
the entry 4, one query's 64 and one label word's 4. The merge's gathers
are 640 B in 2 ops (dists and ids of (1, 16, 5)) on both. The reference's
HLO pass reads the first shape of a tuple-shaped all-reduce only: its
stats psums (combined by XLA into 2 ops) count 8 B, where the port counts
each of the five reduced stats fields, 20 B. A meta run's flops equal the
CPU run's (and ``FlopCounterMode``'s) for a smoke train cell, and the dry
run touches no CUDA state.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.archs import get_arch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_meshinfo
from repro_torch.roofline.report import terms_for_cell
from test_torch_parity_world import torch_threads  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELL = ("smoke-airship", "serve_256")
REFERENCE_KEYS = {"cell", "kind", "mesh", "n_devices", "note", "lower_s", "compile_s", "memory",
                  "cost", "collectives"}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-m", "repro.launch.dryrun", "--arch", CELL[0],
                           "--shape", CELL[1], "--out", str(tmp / "ref")],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    ref = json.loads((tmp / "ref" / "smoke-airship_serve_256_16-16.json").read_text())
    port = {d: dryrun.dryrun_cell(*CELL, multi_pod=False, out_dir=str(tmp / d), device=d)
            for d in ("meta", "cpu")}
    return ref, port


def test_smoke_airship_dryrun_against_reference(records):
    ref, port = records
    assert ref["memory"]["argument_bytes"] == 13_000
    for d, rec in port.items():
        assert REFERENCE_KEYS <= set(rec) and rec["device"] == d, d
        assert rec["cell"] == ref["cell"] and rec["mesh"] == ref["mesh"] == "16x16"
        assert rec["n_devices"] == ref["n_devices"] == 256 and rec["note"] == ref["note"]
        assert rec["memory"]["argument_bytes"] == 13_000, d
    cpu = port["cpu"]
    assert cpu["source"] == "measured" and cpu["compile_s"] is None and cpu["lower_s"] > 0
    for coll in (ref["collectives"], cpu["collectives"]):
        assert coll["per_op_bytes"]["all-gather"] == 640
        assert coll["per_op_counts"]["all-gather"] == 2
    assert cpu["cost"]["flops"] > 0 and cpu["cost"]["bytes_accessed"] > 0
    m = cpu["memory"]
    assert m["peak_bytes"] > m["temp_bytes"] > 0 and m["output_bytes"] > 0


def test_all_reduce_difference_is_the_references_tuple_count(records):
    """The reference: 2 tuple all-reduces read by their first shape, 4 B
    each; the port: dist_evals, hops, visited (1,), iters () and
    beam_expansions (1, 1), int32 each, one op apiece."""
    ref, port = records
    assert ref["collectives"]["per_op_bytes"]["all-reduce"] == 8
    assert ref["collectives"]["per_op_counts"]["all-reduce"] == 2
    cpu = port["cpu"]["collectives"]
    assert cpu["per_op_counts"]["all-reduce"] == 5
    assert cpu["per_op_bytes"]["all-reduce"] == 5 * 4
    assert cpu["total_bytes"] == 640 + 20 and ref["collectives"]["total_bytes"] == 640 + 8


def test_meta_run_of_the_walk_is_analytic(records):
    _, port = records
    meta = port["meta"]
    assert meta["source"] == "analytic" and meta["collectives"] is None
    assert "core/engine/loop.py" in meta["stopped_at"] and "done" in meta["stopped_at"]
    t = terms_for_cell(*CELL, 256)
    assert meta["cost"] == {"flops": t.flops, "bytes_accessed": t.hbm_bytes,
                            "transcendentals": None}
    assert meta["memory"]["temp_bytes"] is None and meta["lower_s"] is None


@pytest.mark.parametrize("arch_name", ["smoke-gqa", "smoke-dlrm"])
def test_meta_flops_equal_cpu_flops(arch_name):
    """A smoke train cell at 16x16: the meta run's flops == the CPU run's ==
    ``FlopCounterMode``'s over the same step, and both are measured."""
    shape = "train_4k" if arch_name == "smoke-gqa" else "train_batch"
    recs = {d: dryrun.dryrun_cell(arch_name, shape, multi_pod=False, out_dir=None, device=d)
            for d in ("meta", "cpu")}
    assert all(r["source"] == "measured" for r in recs.values())
    assert recs["meta"]["cost"]["flops"] == recs["cpu"]["cost"]["flops"] > 0
    assert recs["meta"]["memory"]["argument_bytes"] == recs["cpu"]["memory"]["argument_bytes"]
    cell = get_arch(arch_name).make_cell(shape, make_production_meshinfo(device="cpu"))
    with FlopCounterMode(display=False) as fc:
        cell.fn(*cell.make_inputs(0, "cpu"))
    assert fc.get_total_flops() == recs["cpu"]["cost"]["flops"]


def test_dryrun_touches_no_cuda_state(monkeypatch):
    def no_cuda(name):
        def call(*a, **k):
            raise AssertionError(f"the dry run called torch.cuda.{name}")
        return call

    for name in ("is_available", "device_count", "current_device", "synchronize", "init",
                 "set_device", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, no_cuda(name))
    rec = dryrun.dryrun_cell(*CELL, multi_pod=False, out_dir=None, device="meta")
    assert rec["source"] == "analytic"
    for cell in (("smoke-mla-moe", "decode_32k"), ("smoke-mace", "ogb_products")):
        rec = dryrun.dryrun_cell(*cell, multi_pod=True, out_dir=None, device="meta")
        assert rec["mesh"] == "2x16x16" and rec["n_devices"] == 512
    assert not torch.cuda.is_initialized()


def test_all_covers_46_cells_and_main_writes_records(tmp_path, capsys):
    assert len(dryrun.all_cells()) == 46
    dryrun.main(["--arch", "smoke-mace", "--shape", "molecule", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "smoke-mace_molecule_16-16.json").read_text())
    assert rec["source"] == "measured" and rec["cost"]["flops"] > 0
    assert "ALL DRY-RUN CELLS PASSED" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "no-such-arch", "--shape", "x", "--out", str(tmp_path)])
