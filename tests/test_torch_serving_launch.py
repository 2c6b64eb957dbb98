"""The port's serve launcher, ``python -m repro_torch.launch.serve``, in a
subprocess on the CPU (``--device cpu``): a replay exits 0 with a telemetry
report; the churn / hybrid / JSON-log and PQ / fused paths run; the flag
combinations the reference refuses exit non-zero and say why, and none
names a ROADMAP item (every path is ported: ``--distributed`` runs in
tests/test_torch_distributed.py, ``--serve-http`` / ``--replicas`` in
tests/test_torch_obs_http.py).
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _serve(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args], capture_output=True,
        text=True, cwd=ROOT, env=env, timeout=timeout)


def _report(stdout: str) -> dict:
    start = stdout.index("{\n")
    end = stdout.index("\n}\n", start) + 2
    return json.loads(stdout[start:end])


def test_replay_on_the_cpu_exits_zero_with_a_report():
    out = _serve("--device", "cpu", "--n", "2000", "--requests", "64")
    assert out.returncode == 0, out.stderr
    report = _report(out.stdout)
    assert report["telemetry"]["submitted"] == report["telemetry"]["completed"] == 64
    assert report["cache"]["trace_count"] == report["trace_budget"] == 3 * 2 * 2
    assert report["cache"]["misses"] == 0  # warmup built every closure
    assert "served 64/64 requests" in out.stdout and "on cpu" in out.stdout


def test_churn_hybrid_and_json_log(tmp_path):
    log = tmp_path / "serve.jsonl"
    out = _serve("--device", "cpu", "--n", "1500", "--requests", "48", "--churn", "0.3",
                 "--consolidate-after", "4", "--hybrid", "--log-json", str(log))
    assert out.returncode == 0, out.stderr
    report = _report(out.stdout)
    assert report["index"]["epoch"] > 1 and report["telemetry"]["epoch_swaps"] > 0
    assert "overlays" in report
    records = [json.loads(line) for line in log.read_text().splitlines()]
    events = {r["event"] for r in records}
    assert {"admit", "dispatch", "complete", "epoch_swap"} <= events
    assert all("ts" in r for r in records)
    assert f"flushed {len(records)} structured log records" in out.stdout


def test_pq_fused_slo_and_faults():
    out = _serve("--device", "cpu", "--n", "1500", "--d", "16", "--requests", "40",
                 "--approx", "pq", "--fuse", "on", "--slo", "--deadline-ms", "50",
                 "--inject-faults", "0.1", "--ladder", "8,32")
    assert out.returncode == 0, out.stderr
    report = _report(out.stdout)
    assert report["trace_budget"] == 2 * 2 * 2
    assert "slo: goodput" in out.stdout and "fault retries" in out.stdout


@pytest.mark.parametrize("args, item", [
    (("--distributed", "--churn", "0.3"), "drop --distributed"),
    (("--serve-http", "0", "--replicas", "2", "--distributed"), "drop --distributed"),
    (("--replicas", "2"), "needs --serve-http"),
])
def test_unported_paths_exit_nonzero_and_name_their_item(args, item):
    out = _serve("--device", "cpu", "--n", "500", *args, timeout=120)
    assert out.returncode != 0
    assert item in out.stderr and "ROADMAP item" not in out.stderr
