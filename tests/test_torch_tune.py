"""The port's tuner (``repro_torch.tune``) on the CPU: the lattice and its
validation, the committed table, lookup parity with the reference's
``repro.tune.table.lookup`` under all three fallback rules, and
``build_context`` threading the table's configs into the backends (the
card's side is tests/test_torch_cuda_tune.py)."""
import dataclasses
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.tune import config as ref_config
from repro.tune import table as ref_table
from repro_torch.core.engine import loop as port_loop
from repro_torch.core.engine.context import build_context
from repro_torch.tune import (
    DEFAULT_CONFIGS,
    KERNELS,
    LATTICE,
    KernelConfig,
    lattice_configs,
    table,
    validate_config,
)
from repro_torch.tune.config import (
    ADC_LANES,
    ADC_THREADS,
    FIELDS,
    SCAN_ROWS_PER_BLOCK,
    SMEM_WARPS,
    key_configs,
)
from repro_torch.tune.sweep import WIN_SHARE, choose, sweep_kernel, table_doc

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


@pytest.fixture
def tuning_table(tmp_path, monkeypatch):
    """write(entries) points the port's table at a fresh file holding
    ``entries`` (dicts of kernel, platform, d, deg, beam, config); the
    loader's cache is cleared before and after."""

    def write(entries, name="table.json"):
        doc = {"version": table.SCHEMA_VERSION, "device": "test", "lattice": table.lattice_doc(),
               "entries": [dict(e, config=e["config"].to_dict()) for e in entries]}
        path = tmp_path / name
        path.write_text(json.dumps(doc))
        monkeypatch.setattr(table, "TABLE_PATH", str(path))
        table.load_table.cache_clear()
        return path

    yield write
    table.load_table.cache_clear()


def entry(kernel, cfg, d, deg, beam, platform="cpu"):
    return dict(kernel=kernel, platform=platform, d=d, deg=deg, beam=beam, config=cfg)


def test_lattice_membership_validation_and_pinning_match_the_cuda_header():
    for kernel in KERNELS:
        validate_config(kernel, DEFAULT_CONFIGS[kernel])
        assert DEFAULT_CONFIGS[kernel] in lattice_configs(kernel)
        for cfg in lattice_configs(kernel):
            validate_config(kernel, cfg)
    # The defaults are gather_distance's constants before the tuner; the
    # other kernels' lattices are their one shape.
    assert DEFAULT_CONFIGS["gather_distance"] == KernelConfig(tile_warps=4, rows_in_flight=4)
    for kernel in ("fused_exact", "fused_adc", "pq_adc"):
        assert LATTICE[kernel] == {} and lattice_configs(kernel) == (DEFAULT_CONFIGS[kernel],)
    bad = [("nope", KernelConfig()),
           ("gather_distance", KernelConfig(tile_warps=3)),
           ("gather_distance", KernelConfig(rows_in_flight=16)),
           ("fused_exact", KernelConfig(rows_in_flight=2)),  # not its dimension
           ("fused_adc", KernelConfig(tile_warps=8)),
           ("pq_adc", KernelConfig(tile_warps=2))]
    for kernel, cfg in bad:
        with pytest.raises(ValueError):
            validate_config(kernel, cfg)
    cfg = KernelConfig(rows_in_flight=8)
    assert KernelConfig.from_dict(cfg.to_dict()) == cfg
    assert len({KernelConfig(), KernelConfig(), KernelConfig(tile_warps=2)}) == 2  # hashable
    # lattice_configs pins the dimensions a kernel does not use.
    defaults = KernelConfig()
    for kernel in KERNELS:
        dims = LATTICE[kernel]
        configs = lattice_configs(kernel)
        assert len(configs) == len(set(configs)) == int(np.prod([len(v) for v in dims.values()]))
        for cfg in configs:
            for name in FIELDS:
                if name not in dims:
                    assert getattr(cfg, name) == getattr(defaults, name), (kernel, name)
        for name, values in dims.items():
            assert {getattr(c, name) for c in configs} == set(values)
    # csrc/gather_distance.cu instantiates exactly LATTICE's points.
    source = (CSRC / "gather_distance.cu").read_text()
    pattern = r"using (\w+)Lattice = std::integer_sequence<int, ([^>]+)>"
    seqs = {name: tuple(int(v) for v in vals.split(","))
            for name, vals in re.findall(pattern, source)}
    assert seqs == {"TileWarps": LATTICE["gather_distance"]["tile_warps"],
                    "RowsInFlight": LATTICE["gather_distance"]["rows_in_flight"]}
    # The fixed shapes are the sources' constants.
    sources = {name: (CSRC / name).read_text()
               for name in ("sqdist.cuh", "fused_expand_adc.cu", "pq_adc.cu")}
    for name, const, value in (("sqdist.cuh", "kTileWarps", 4), ("sqdist.cuh", "kRowsSmall", 4),
                               ("sqdist.cuh", "kSmemWarps", SMEM_WARPS),
                               ("fused_expand_adc.cu", "kMaxThreads", ADC_THREADS),
                               ("fused_expand_adc.cu", "kLanes", ADC_LANES),
                               ("pq_adc.cu", "kRowsPerBlock", SCAN_ROWS_PER_BLOCK)):
        assert re.search(rf"constexpr int {const} = {value};", sources[name]), (name, const)
    # A key's sweep space: off the register path gather_distance reads no config.
    assert key_configs("gather_distance", 128) == lattice_configs("gather_distance")
    for d in (13, 512):
        assert key_configs("gather_distance", d) == (DEFAULT_CONFIGS["gather_distance"],)


def _good_doc():
    return {"version": table.SCHEMA_VERSION, "device": "test", "lattice": table.lattice_doc(),
            "entries": [entry("gather_distance", KernelConfig(tile_warps=8), 128, 32, 1),
                        entry("gather_distance", KernelConfig(rows_in_flight=2), 256, 32, 1),
                        entry("fused_adc", KernelConfig(), 16, 32, 1)]}


def _corrupt(case):
    doc = _good_doc()
    e = doc["entries"]
    if case == "version":
        doc["version"] = 2
    elif case == "lattice":
        doc["lattice"]["gather_distance"]["tile_warps"] = [2, 4]
    elif case == "duplicate":
        e.append(dict(e[0]))
    elif case == "off_lattice":
        e[1]["config"] = KernelConfig(tile_warps=16)
        e[2]["config"] = KernelConfig(rows_in_flight=2)
    elif case == "bad_key":
        e[0]["d"] = 0
        del e[1]["beam"]
    for x in e:
        if isinstance(x["config"], KernelConfig):
            x["config"] = x["config"].to_dict()
    return doc


@pytest.mark.parametrize("case", ("good", "version", "lattice", "duplicate", "off_lattice",
                                  "bad_key"))
def test_validate_table_accepts_a_good_doc_and_rejects_each_corruption(case):
    doc = _corrupt(case)
    if case == "good":
        table.validate_table(doc)
        # The sweep's own document (a CPU rehearsal at a tiny size: every
        # config runs the plain version, which ignores it) is a good one.
        records = [sweep_kernel("gather_distance", d=d, deg=4, beam=1, b=2, n=64, repeats=2,
                                device="cpu", configs=lattice_configs("gather_distance")[:3])
                   for d in (8, 16)]
        table.validate_table(table_doc(records, "cpu rehearsal"))
    else:
        with pytest.raises(ValueError):
            table.validate_table(doc)


def test_the_committed_table_passes_check(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["table", "--check"])
    assert table._main() == 0
    assert "tuning table OK" in capsys.readouterr().out
    doc = json.loads(Path(table.TABLE_PATH).read_text())
    assert doc["device"]  # the card and power limit it was swept on
    for e in doc["entries"]:
        assert e["platform"] == "cuda"
        assert e["winner_us"] > 0 and e["default_us"] > 0 and e["speedup_vs_default"] >= 1.0


def test_lookup_picks_the_reference_entry_under_all_three_rules(tmp_path):
    # The same keys in the same order, one doc in each schema. The
    # reference's configs are distinct within a kernel, so the config its
    # lookup returns names the entry it picked; the port's lookup_index
    # names its own (its fused kernels hold their one shape).
    keys = {"gather_distance": [(128, 32, 1), (128, 32, 4), (256, 32, 1), (64, 16, 1),
                                (256, 16, 1), (8, 8, 2)],
            "fused_exact": [(128, 32, 1), (32, 8, 4), (512, 64, 1)],
            "fused_adc": [(16, 32, 1), (8, 16, 4)]}  # pq_adc: none, the default rule
    ref_pool = {k: [c for c in ref_config.lattice_configs(k)
                    if c != ref_config.DEFAULT_CONFIGS[k]] for k in keys}
    port_pool = [c for c in lattice_configs("gather_distance")
                 if c != DEFAULT_CONFIGS["gather_distance"]]
    ref_entries, port_entries = [], []
    for kernel, ks in keys.items():
        for i, (d, deg, beam) in enumerate(ks):
            base = dict(kernel=kernel, d=d, deg=deg, beam=beam)
            ref_entries.append(dict(base, platform="cpu", config=ref_pool[kernel][i].to_dict()))
            cfg = port_pool[i] if kernel == "gather_distance" else DEFAULT_CONFIGS[kernel]
            port_entries.append(dict(base, platform="cuda", config=cfg.to_dict()))
    ref_path, port_path = tmp_path / "ref.json", tmp_path / "port.json"
    ref_path.write_text(json.dumps({"version": ref_table.SCHEMA_VERSION, "entries": ref_entries,
                                    "lattice": {k: list(v)
                                                for k, v in ref_config.LATTICE.items()}}))
    port_path.write_text(json.dumps({"version": table.SCHEMA_VERSION, "entries": port_entries,
                                     "lattice": table.lattice_doc(), "device": "test"}))
    first = {k: next(i for i, e in enumerate(port_entries) if e["kernel"] == k) for k in keys}

    n = 0
    for kernel in KERNELS:
        for d in (8, 16, 64, 100, 128, 256, 512):
            for deg in (0, 8, 16, 32, 64):
                for beam in (0, 1, 2, 4, 8):
                    r = ref_table.lookup(kernel, d=d, deg=deg, beam=beam, platform="cpu",
                                         path=str(ref_path))
                    p = table.lookup(kernel, d=d, deg=deg, beam=beam, platform="cuda",
                                     path=str(port_path))
                    idx = table.lookup_index(kernel, d=d, deg=deg, beam=beam, platform="cuda",
                                             path=str(port_path))
                    if kernel in keys:
                        assert idx - first[kernel] == ref_pool[kernel].index(r)
                        assert port_entries[idx]["config"] == p.to_dict()
                    else:
                        assert r == ref_config.DEFAULT_CONFIGS[kernel]
                        assert p == DEFAULT_CONFIGS[kernel] and idx is None
                    n += 1
    assert n == 4 * 7 * 5 * 5
    # An exact key resolves to its own entry; a tie goes to the first in file
    # order: (128, 16, 1) is at log-distance 1 from entries 0, 3 and 4.
    assert table.lookup("gather_distance", d=128, deg=32, beam=4, platform="cuda",
                        path=str(port_path)) == port_pool[1]
    assert table.lookup_index("gather_distance", d=128, deg=16, beam=1, platform="cuda",
                              path=str(port_path)) == 0
    assert table.lookup_index("gather_distance", d=256, deg=16, beam=2, platform="cuda",
                              path=str(port_path)) == 4


def test_build_context_threads_the_table_and_resolves_defaults_on_cpu(tuning_table,
                                                                      monkeypatch):
    gen = torch.Generator().manual_seed(0)
    corpus = rt.make_labeled_corpus(gen, 600, 16, 6, device="cpu")
    graph = rt.build_index(gen, corpus, degree=12, sample_size=64, device="cpu")
    queries = corpus.vectors[:6].clone()
    cons = rt.equal_constraint(corpus.labels[:6], 6)
    params = rt.SearchParams(k=5, ef_result=16, ef_sat=16, ef_other=16, n_start=4,
                             max_iters=32, use_kernel=True)
    tuned, other = KernelConfig(tile_warps=8, rows_in_flight=2), KernelConfig(tile_warps=2)
    # Only a "cuda" entry: on the CPU the lookup is the default.
    tuning_table([entry("gather_distance", tuned, 16, 12, 1, platform="cuda")])
    ctx = build_context(corpus, cons, queries, params, degree=12)
    assert ctx.backend.gd_config == DEFAULT_CONFIGS["gather_distance"]
    base = rt.constrained_search(corpus, graph, queries, cons, params)
    # "cpu" entries: the backend carries them, keyed on the degree.
    tuning_table([entry("gather_distance", other, 16, 32, 1),
                  entry("gather_distance", tuned, 16, 12, 1)], name="cpu.json")
    assert build_context(corpus, cons, queries, params, degree=12).backend.gd_config == tuned
    assert build_context(corpus, cons, queries, params, degree=32).backend.gd_config == other
    # constrained_search passes the graph's degree; the plain version
    # ignores the config, so the walk is unchanged.
    seen = []

    def spy(*args, **kw):
        seen.append(kw.get("degree"))
        return build_context(*args, **kw)

    monkeypatch.setattr(port_loop, "build_context", spy)
    res = rt.constrained_search(corpus, graph, queries, cons, params)
    assert seen == [12]
    assert torch.equal(res.ids, base.ids) and torch.equal(res.dists, base.dists)


def _record(call_readings, key=("gather_distance", "cuda", 128, 32, 1)):
    """One sweep record: {config: readings} in the sweep's row order."""
    kernel, platform, d, deg, beam = key
    return {"kernel": kernel, "platform": platform, "d": d, "deg": deg, "beam": beam,
            "rows": [{"config": c.to_dict(), "readings_us": r, "bound_us": 1.0}
                     for c, r in call_readings.items()]}


@pytest.mark.parametrize("case", ("consistent", "shifted_calls", "inside_spread",
                                  "one_call_only", "default"))
def test_choose_keeps_the_default_unless_a_config_wins_nine_tenths_of_pooled_pairs(case):
    default, fast = DEFAULT_CONFIGS["gather_distance"], KernelConfig(rows_in_flight=2)
    base = [4.0, 4.02, 3.99, 4.01, 4.0, 4.03, 3.98, 4.0, 4.01, 4.02]  # quartiles 0.02 apart

    def shifted(xs, by):
        return [t + by for t in xs]

    if case == "consistent":  # faster in every pair of every call, by 0.08 us
        calls = [(base, shifted(base, -0.08))] * 3
    elif case == "shifted_calls":  # each call shifts both sides; the pairs still win
        calls = [(shifted(base, c), shifted(base, c - 0.05)) for c in (0.0, 0.3, -0.2)]
    elif case == "inside_spread":  # faster in every pair, by less than the spread
        calls = [(base, shifted(base, -0.01))] * 3
    elif case == "one_call_only":  # far faster in one call of three, slower in two
        calls = [(base, shifted(base, -0.5)), (base, shifted(base, 0.01)),
                 (base, shifted(base, 0.01))]
    else:  # only the default timed
        calls = [(base, None)]
    records = [_record({default: d, **({fast: c} if c else {})}) for d, c in calls]
    got = choose(records)
    assert got["pairs"] == len(base) * len(records) and got["calls"] == len(records)
    won = {tuple(sorted(s["config"].items())): s["pairs_won"] for s in got["configs"]}
    if case in ("consistent", "shifted_calls"):
        assert got["winner"] == fast.to_dict() and got["speedup_vs_default"] > 1.0
        assert won[tuple(sorted(fast.to_dict().items()))] == got["pairs"]
    else:
        assert got["winner"] == default.to_dict() and got["speedup_vs_default"] == 1.0
    if case == "one_call_only":  # a third of the pairs, short of WIN_SHARE
        assert won[tuple(sorted(fast.to_dict().items()))] < WIN_SHARE * got["pairs"]
    doc = table_doc(records, "test")
    table.validate_table(doc)
    assert doc["entries"][0]["config"] == got["winner"]


def test_serving_executors_resolve_the_config_constrained_search_does(tuning_table,
                                                                    monkeypatch):
    """LocalExecutor and StreamingLocalExecutor pass the graph's degree, so
    a table with two degrees gives serving the entry constrained_search
    gets (with degree unknown, the first entry would win the tie)."""
    from repro_torch.serving import runtime as serving_runtime
    from repro_torch.serving import (LocalExecutor, ServingRuntime, StreamingLocalExecutor,
                                     VirtualClock, label_words_row, make_tier_ladder)

    gen = torch.Generator().manual_seed(0)
    corpus = rt.make_labeled_corpus(gen, 300, 16, 4, device="cpu")
    graph = rt.build_index(gen, corpus, degree=12, sample_size=64, device="cpu")
    at12, at32 = KernelConfig(rows_in_flight=8), KernelConfig(tile_warps=2)
    tuning_table([entry("gather_distance", at32, 16, 32, 1),
                  entry("gather_distance", at12, 16, 12, 1)])
    seen = []

    def spy(*args, **kw):
        ctx = build_context(*args, **kw)
        seen.append(ctx.backend.gd_config)
        return ctx

    monkeypatch.setattr(port_loop, "build_context", spy)
    monkeypatch.setattr(serving_runtime, "build_context", spy)
    params = rt.SearchParams(k=4, ef_result=16, ef_sat=16, ef_other=16, n_start=4, max_iters=16,
                             use_kernel=True)
    rt.constrained_search(corpus, graph, corpus.vectors[:2].clone(),
                          rt.equal_constraint(corpus.labels[:2], 4), params)
    assert seen == [at12]
    index = rt.StreamingIndex.from_static(corpus, graph, device="cpu")
    for ex in (LocalExecutor(corpus, graph), StreamingLocalExecutor(index)):
        seen.clear()
        tiers = tuple(dataclasses.replace(p, use_kernel=True) for p in make_tier_ladder())
        runtime = ServingRuntime(ex, n_labels=4, tiers=tiers, ladder=(4,), clock=VirtualClock())
        rid = runtime.submit(corpus.vectors[0].numpy(), 4, "label", label_words_row([1], 4))
        runtime.drain()
        assert runtime.poll(rid).ok
        assert seen and set(seen) == {at12}
