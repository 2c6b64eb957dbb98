"""The serving runtime's host-side parts, port against reference: the same
call sequence goes to the reference's module and to the port's, and the
outputs and counters must be equal (batcher, closure cache, tier
controller, SLO ladder, telemetry percentiles, retry backoff, fault
schedule, workload draws, span traces and logs). Also the wall-clock rule
of tests/test_no_wall_clock.py, applied to the port's serving layer.
"""
import ast
import dataclasses
import io
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as ref_obs
import repro.serving as ref
import repro_torch.obs as port_obs
import repro_torch.serving as port
from repro.core.types import Corpus as RefCorpus
from repro_torch import Corpus as PortCorpus

SERVING = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "serving"


def _req(mod, i, family="label", tier=0, deadline=None, operand=None):
    if operand is None:
        operand = (mod.label_words_row([i % 5], 5) if family == "label"
                   else (0.1 * (i % 3), 0.9, i % 2))
    return mod.Request(req_id=i, query=np.zeros((4,), np.float32), k=4, family=family,
                       operand=operand, deadline=deadline, tier=tier)


def test_batcher_flushes_the_same_microbatches():
    def run(mod):
        b = mod.DynamicBatcher(ladder=(4, 16), max_wait=0.01)
        out = [b.flush(0.0)]
        t = 0.0
        for i in range(45):
            t += 0.0007
            fam = "label" if i % 3 else "range"
            b.add(_req(mod, i, fam, tier=i % 2, deadline=0.02 if i == 30 else None), t)
            if i % 7 == 6:
                out.append(b.flush(t))
        out += [b.occupancy(), b.flush(t + 0.005), b.flush(t + 0.011), b.pending_count()]
        for i in range(50, 53):
            b.add(_req(mod, i), t)
        out.append(b.flush(t, force=True))
        return [
            [(mb.group, mb.tier, mb.bucket, [r.req_id for r in mb.requests], mb.n_padded)
             for mb in o] if isinstance(o, list) else o
            for o in out
        ]

    got = run(port)
    assert got == run(ref)
    assert any(got[1:-4])  # something flushed before the end
    with pytest.raises(ValueError):
        port.DynamicBatcher(ladder=(8, 4))
    assert port.bucket_for(5, (4, 16)) == ref.bucket_for(5, (4, 16)) == 16


def test_closure_cache_counts_and_refuses_past_its_budget():
    def run(mod):
        built = []
        cache = mod.CompileCache(lambda k: built.append(k) or (lambda: k), max_entries=3)
        for k in ("a", "b", "a", "c", "b", "a"):
            assert cache.get(k)() == k
        stats = [cache.stats(), cache.hit_rate]
        with pytest.raises(mod.TraceBudgetError):
            cache.get("d")
        cache.reset_counters()
        cache.get("c")
        return built, stats, cache.stats()

    assert run(port) == run(ref)


def test_tier_ladder_and_controller_retuning():
    kw = dict(k_cap=8, base_ef=16, base_iters=32, base_n_start=4, n_tiers=3, growth=2)
    r_tiers, p_tiers = ref.make_tier_ladder(**kw), port.make_tier_ladder(**kw)
    assert [dataclasses.asdict(t) for t in r_tiers] == [dataclasses.asdict(t) for t in p_tiers]

    def run(mod, tiers):
        c = mod.AdaptiveController(tiers, mod.ControllerConfig(min_batches=2))
        rng = np.random.RandomState(0)
        out = []
        for i in range(40):
            fam = ("label", "range")[i % 2]
            tier = c.tier_for(fam)
            c.record(fam, tier, float(rng.choice([0.5, 0.95, 1.0])), float(rng.randint(1, 40)))
            c.record_strategy((fam, i % 3), ("graph", "posting")[i % 2],
                              float(rng.rand()), float(rng.rand()))
            req = _req(mod, i, fam, tier=tier)
            out.append((tier, c.escalate(req), c.strategy_for((fam, i % 3), "graph"),
                        c.strategy_ranking((fam, 0)), c.generation))
        return out, c.snapshot(), c.k_cap, c.max_tier

    assert run(port, p_tiers) == run(ref, r_tiers)
    with pytest.raises(ValueError):
        port.AdaptiveController(())


def test_slo_ladder_moves_with_the_same_hysteresis():
    def run(mod):
        cfg = mod.SLOConfig(target_latency=0.01, queue_high=16, queue_low=4, hold_up=2,
                            hold_down=3, lat_stale_after=4)
        lad = mod.DegradationLadder(cfg)
        out = []
        depth = [0, 2, 30, 40, 50, 60, 60, 20, 10, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]
        for i, q in enumerate(depth):
            if i % 3 == 0:
                lad.observe_latency(0.02 if q > 10 else 0.001)
            lad.observe_service(0.004 * (1 + i % 4))
            level = lad.observe_load(q)
            out.append((level, lad.force_base_tier, lad.cap_escalations, lad.prefer_cheap,
                        lad.shed_predicted, lad.predicted_miss(i * 0.01 + 0.005, i * 0.01)))
        return out, lad.transitions, lad.snapshot()

    got = run(port)
    assert got == run(ref)
    assert max(level for level, *_ in got[0]) == 3 and got[0][-1][0] < 3


def test_telemetry_percentiles_and_summary():
    def run(mod):
        rng = np.random.RandomState(1)
        hist = mod.LatencyHistogram()
        tel = mod.Telemetry(max_history=50)
        for x in (0.0, 1e-6, 5e-4, 0.02, 59.9999, 120.0):
            hist.record(x)
        quant = [hist.quantile(p) for p in (0, 1, 50, 99, 100)] + [hist.summary()]
        for i in range(80):
            arrival = float(i) * 0.01
            resp = mod.Response(
                req_id=i, ids=np.zeros(4, np.int32), dists=np.zeros(4, np.float32), k=4,
                filled=int(rng.randint(0, 5)), tier=i % 2, escalations=i % 2,
                fill_history=(), arrival_t=arrival,
                complete_t=arrival + float(rng.exponential(0.01)),
                deadline_missed=bool(i % 11 == 0), strategy=("graph", "posting")[i % 3 == 0],
                error="boom" if i % 17 == 0 else None,
                trace={s: 0.001 for s in ref_obs.STAGES} if i % 2 else None)
            tel.on_submit()
            if i % 13 == 0:
                resp.shed_reason = "expired"
                tel.on_shed(resp)
            else:
                tel.on_complete(resp)
            tel.on_dispatch(8, 5)
            tel.on_route(resp.strategy)
        tel.on_fault("error")
        tel.on_escalate()
        return quant, tel.summary(), tel.goodput_rate(), mod.percentile([], 50) != 0

    assert json.dumps(run(port), sort_keys=True) == json.dumps(run(ref), sort_keys=True)


class _FakeRuntime:
    """Admits after a fixed number of refusals; counts pumps."""

    def __init__(self, mod, clock, refusals):
        self.mod, self.clock, self.refusals = mod, clock, refusals
        self.telemetry = mod.Telemetry()
        self.steps = 0

    def step(self):
        self.steps += 1

    def submit(self):
        if self.refusals:
            self.refusals -= 1
            raise self.mod.AdmissionError("full")
        return 7


def test_retry_backoff_and_give_up():
    def run(mod):
        policy = mod.RetryPolicy(max_retries=3, base_backoff=0.002, jitter=0.5)
        rng = np.random.RandomState(3)
        backoffs = [policy.backoff_for(a, rng) for a in range(5)]
        out = [backoffs]
        for refusals, deadline in ((0, None), (2, None), (9, None), (2, 0.003)):
            rt = _FakeRuntime(mod, mod.VirtualClock(), refusals)
            got = mod.submit_with_retry(rt, rt.submit, policy, rng, deadline=deadline)
            out.append((got, rt.clock(), rt.steps, dict(rt.telemetry.counters)))
        return out

    assert run(port) == run(ref)


def test_fault_schedule_and_faulty_executor_draw_alike():
    def run(mod):
        cfg = mod.FaultConfig(seed=9, error_rate=0.2, spike_rate=0.2, spike_s=0.5,
                              stale_epoch_rate=0.3, max_faults=12)
        sched = mod.FaultSchedule(cfg)
        draws = [sched.draw_dispatch() if i % 3 else sched.draw_refresh() for i in range(60)]
        clock = mod.FaultClock(mod.VirtualClock())

        class Inner:
            dim = 4

            def build(self, bucket, family, params):
                return lambda q, c: (bucket, family)

        ex = mod.FaultyExecutor(Inner(), mod.FaultSchedule(mod.FaultConfig(
            seed=2, error_rate=0.3, spike_rate=0.3, spike_s=0.25)), clock)
        fn = ex.build(8, "label", None)
        outcomes = []
        for _ in range(20):
            try:
                outcomes.append(fn(None, None))
            except mod.InjectedFault as e:
                outcomes.append(str(e))
        return (draws, sched.injected, sched.by_kind, outcomes, ex.pop_faults(),
                clock.injected_s, clock(), ex.dim)

    got = run(port)
    assert got == run(ref)
    assert got[1] == 12 and got[5] > 0


def test_workload_draws_match_the_reference():
    rng = np.random.default_rng(2)
    vec = rng.integers(-6, 7, size=(300, 8)).astype(np.float32)
    lab = rng.integers(0, 40, size=300).astype(np.int32)
    attrs = rng.random((300, 2)).astype(np.float32)
    corpora = {
        ref: RefCorpus(vectors=jnp.asarray(vec), labels=jnp.asarray(lab),
                       attrs=jnp.asarray(attrs)),
        port: PortCorpus(vectors=torch.from_numpy(vec), labels=torch.from_numpy(lab),
                         attrs=torch.from_numpy(attrs)),
    }

    def items(mod):
        corpus = corpora[mod]
        mixed = mod.mixed_workload(5, corpus, 60, 40, k_choices=(2, 8))
        churn = mod.churn_workload(5, corpus, 60, 40, mutation_frac=0.4)
        out = []
        for it in mixed + churn:
            op = it.operand
            if it.family == "upsert":
                op = (op[0], op[1].tobytes())
            elif op is not None:
                op = np.asarray(op).tobytes()
            out.append((it.query.tobytes(), it.k, it.family, it.kind, op))
        arr = mod.poisson_arrivals(np.random.RandomState(4), 50, 1000.0, burst=(0.3, 0.6, 5.0))
        return out, arr.tobytes()

    assert items(port) == items(ref)
    row = port.label_words_row([0, 31, 39], 40)
    assert row.dtype == np.uint32 and row.tolist() == [0x80000001, 1 << 7]


def test_traces_and_json_logs_match_the_reference():
    def run(mod, obs):
        tr = obs.RequestTrace(3, 1.0, replica=None)
        tr.mark("route:graph", 1.0)
        tr.on_flush(1.0, 1.5)
        tr.on_exec(1.75, 2.0)
        tr.on_flush(2.0, 2.25)
        tr.on_exec(2.25, 3.0)
        bd = tr.breakdown(3.5)
        for i in range(70):
            tr.mark("x", float(i))
        sink = obs.RingBufferSink(capacity=3)
        clock = mod.VirtualClock(5.0)
        log = obs.JsonLogger(sink=sink, clock=clock).bind(replica=1)
        for i in range(5):
            clock.advance(0.5)
            log.log("dispatch", batch_id=i, epoch=None)
        fh = io.StringIO()
        n = log.flush_to(fh)
        return (bd, obs.stage_sum(bd), obs.trace_consistent(bd), tr.breakdown(4.0),
                sink.emitted, sink.dropped, n, fh.getvalue(), list(obs.STAGES))

    assert run(port, port_obs) == run(ref, ref_obs)
    with pytest.raises(ValueError):
        port_obs.RingBufferSink(0)


def test_port_serving_layer_reads_no_wall_clock_directly():
    """tests/test_no_wall_clock.py's rule over src/repro_torch/serving/: only
    types.py imports time, and only for perf_counter and thread_time."""
    assert SERVING.is_dir(), SERVING
    offenders = []
    for path in sorted(SERVING.glob("*.py")):
        if path.name == "types.py":
            continue
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                offenders += [f"{path.name}:{node.lineno}" for a in node.names
                              if a.name == "time" or a.name.startswith("time.")]
            elif isinstance(node, ast.ImportFrom) and node.module == "time":
                offenders.append(f"{path.name}:{node.lineno}")
    assert not offenders, offenders
    tree = ast.parse((SERVING / "types.py").read_text())
    calls = [node.attr for node in ast.walk(tree)
             if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
             and node.value.id == "time"]
    assert sorted(calls) == ["perf_counter", "thread_time"], calls
