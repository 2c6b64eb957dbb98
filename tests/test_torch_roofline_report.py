"""The roofline report (``roofline/report.py``), port against reference.

``terms_for_cell`` over the port's analytic model gives finite, positive
terms for all 46 assigned + paper cells (the port of
``tests/test_coverage_extras.py::test_roofline_report_terms_all_cells``)
and the reference's flops, bytes, collective bytes and model flops for
each at 256 chips (relative 1e-12); the port's ``airship_terms`` takes
the shards a query is searched on as ``tp``, whose default is the
reference's hard-coded 16. ``markdown_table`` reads a directory of the
port's dry-run records.
"""
import json

import numpy as np

from repro.archs.airship import AirshipServeConfig as RefAirshipConfig
from repro.configs import ASSIGNED as REF_ASSIGNED
from repro.roofline import model as ref_rm
from repro.roofline.report import terms_for_cell as ref_terms_for_cell
from repro_torch.archs import get_arch
from repro_torch.archs.airship import AirshipServeConfig
from repro_torch.configs import ASSIGNED
from repro_torch.roofline import model as rm
from repro_torch.roofline.report import load_dryrun, markdown_table, terms_for_cell

FIELDS = ("flops", "hbm_bytes", "coll_bytes", "model_flops")


def cells():
    return [(a, s) for a in ASSIGNED + ("airship-sift1m",) for s in get_arch(a).shape_names()]


def test_roofline_report_terms_all_cells():
    """The analytic model gives finite, positive terms for all 46 assigned +
    paper cells without touching records."""
    n = 0
    for arch_name, shape in cells():
        t = terms_for_cell(arch_name, shape, 256)
        assert t.flops > 0 and t.hbm_bytes > 0, t.cell
        assert np.isfinite(t.roofline_fraction), t.cell
        assert t.bottleneck in ("compute", "memory", "collective")
        n += 1
    assert n == 46


def test_terms_equal_reference_for_every_cell():
    assert ASSIGNED == REF_ASSIGNED
    for arch_name, shape in cells():
        got, want = terms_for_cell(arch_name, shape, 256), ref_terms_for_cell(arch_name, shape, 256)
        assert got.cell == want.cell and got.mesh == want.mesh and got.chips == want.chips
        for f in FIELDS:
            a, b = getattr(got, f), getattr(want, f)
            assert abs(a - b) <= 1e-12 * abs(b), (got.cell, f, a, b)


def test_airship_terms_tp_default_is_the_reference():
    ref_cfg, cfg = RefAirshipConfig(), AirshipServeConfig()
    for batch, chips in ((256, 256), (8192, 256), (256, 512)):
        assert rm.airship_terms(cfg, batch, chips) == ref_rm.airship_terms(ref_cfg, batch, chips)
        assert rm.airship_terms(cfg, batch, chips, tp=16) == rm.airship_terms(cfg, batch, chips)
    assert rm.airship_terms(cfg, 256, 256, tp=1)[0] < rm.airship_terms(cfg, 256, 256)[0]


def record(cell, mesh="16x16", source="measured", args=13000, temp=2_000_000_000):
    return {"cell": cell, "kind": "serve", "mesh": mesh, "n_devices": 256, "note": "",
            "device": "meta", "source": source, "stopped_at": None, "inputs_s": 0.1,
            "lower_s": 1.0, "compile_s": None,
            "memory": {"argument_bytes": args, "output_bytes": None,
                       "temp_bytes": None if source == "analytic" else temp,
                       "peak_bytes": None},
            "cost": {"flops": 1.0, "bytes_accessed": 1.0, "transcendentals": None},
            "collectives": None}


def test_markdown_table_over_port_records(tmp_path):
    recs = [record("airship-sift1m:serve_256", source="analytic", args=40_258_772),
            record("granite-3-2b:train_4k", args=104_894_468),
            record("granite-3-2b:train_4k", mesh="2x16x16"),  # not the single pod: left out
            record("no-such-arch:x")]
    for i, r in enumerate(recs):
        (tmp_path / f"r{i}.json").write_text(json.dumps(r))
    assert set(load_dryrun(str(tmp_path))) == {(r["cell"], r["mesh"]) for r in recs}
    table, rows = markdown_table(str(tmp_path))
    lines = table.splitlines()
    assert lines[0].startswith("| cell | t_compute") and len(lines) == 2 + 3
    assert [c for c, _, _ in rows] == ["airship-sift1m:serve_256", "granite-3-2b:train_4k"]
    assert rows[0][2] == 40_258_772 / 1e9 and rows[1][2] == (104_894_468 + 2e9) / 1e9
    assert any(line.startswith("| no-such-arch:x | model-error") for line in lines)
    t = terms_for_cell("granite-3-2b", "train_4k", 256)
    assert f"| granite-3-2b:train_4k | {t.t_compute*1e3:.2f} ms |" in table
