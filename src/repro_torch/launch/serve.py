"""Online serving driver: Poisson-arrival mixed constrained workload (port of
``repro.launch.serve``).

Thin front over the serving runtime (repro_torch.serving, DESIGN.md §7):
builds an index on the device, then streams individual constrained queries
— each with its own k, constraint family/operand (equal / unequal-X% label
sets and numeric ranges in one stream), and Poisson arrival time — through
the dynamic batcher, the shape-bucketed closure cache and the adaptive
escalation controller, and prints the telemetry summary (QPS, latency
percentiles, fill, cache hit rate). Replays run on a virtual clock.

On the card (the default device):
    PYTHONPATH=src python -m repro_torch.launch.serve --n 20000 --requests 256
    PYTHONPATH=src python -m repro_torch.launch.serve --approx pq --fuse on
    PYTHONPATH=src python -m repro_torch.launch.serve --churn 0.3 --hybrid

On the CPU (the kernels' plain versions):
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --n 2000

Distributed path (scatter-search-merge over a (n_dev // model, model)
mesh of the CUDA devices, model = min(4, n_dev): 1x1 on one card):
    PYTHONPATH=src python -m repro_torch.launch.serve --distributed --approx pq

HTTP front end (DESIGN.md §12) — wall-clock runtime behind a real socket;
SIGINT or SIGTERM drains in-flight work, flushes the log and exits:
    PYTHONPATH=src python -m repro_torch.launch.serve --serve-http 8080 \
        --log-json serve_log.jsonl
    curl -s localhost:8080/metrics | head

Multi-replica tier (DESIGN.md §13) — N shared-nothing runtimes behind one
front end, hash- or load-routed, with /metrics labeled per replica:
    PYTHONPATH=src python -m repro_torch.launch.serve --serve-http 8080 \
        --replicas 4 --router hash

The corpus, attributes, index and PQ codebooks draw from torch generators
seeded 0, 5, 1 and 4, the reference's key numbers (the draws are torch's,
not JAX's).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import threading
from typing import Optional, Sequence

import torch

from repro_torch.common.device import resolve_device
from repro_torch.data.synthetic import make_labeled_corpus
from repro_torch.graph.index import build_index, build_partitioned_index
from repro_torch.serving import (
    LocalExecutor,
    ServingRuntime,
    VirtualClock,
    make_tier_ladder,
    mixed_workload,
    replay_poisson,
)


def _generator(seed: int, dev: torch.device) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def mesh_device_count(dev: torch.device) -> int:
    """Devices a --distributed mesh spans: every CUDA device, or one."""
    return torch.cuda.device_count() if dev.type == "cuda" and dev.index is None else 1


def build_runtime(args, corpus, clock, dev: torch.device, prebuilt_graph=None,
                  replica_id=None):
    """Executor + runtime over ``corpus`` on ``dev``: the streaming executor
    under ``--churn``, the distributed one under ``--distributed``, else
    the static local one (with PQ codebooks under ``--approx pq``).

    ``prebuilt_graph`` shares one (read-only) static graph build across
    replicas; each replica still gets its OWN executor, closure cache and
    (for churn) its own mutable ``StreamingIndex`` slot pool —
    shared-nothing everywhere state can change."""

    def graph_for(corpus):
        if prebuilt_graph is not None:
            return prebuilt_graph
        print("building index...")
        return build_index(_generator(1, dev), corpus, degree=16, sample_size=512, device=dev)

    def train_pq(vectors):
        # Codes are row-aligned with the corpus the executor serves, so the
        # distributed path trains on the PARTITIONED (padded) corpus.
        from repro_torch.core.pq import default_m_sub, pq_train

        m_sub = default_m_sub(args.d)
        print(f"training PQ codebooks (m_sub={m_sub})...")
        return pq_train(_generator(4, dev), vectors, m_sub=m_sub, n_cent=256)

    if args.churn > 0:
        if args.distributed or args.approx == "pq":
            raise SystemExit(
                "--churn serves through the streaming local executor "
                "(exact backend); drop --distributed/--approx pq"
            )
        from repro_torch.serving import StreamingLocalExecutor
        from repro_torch.streaming import StreamingIndex

        graph = graph_for(corpus)
        print("building streaming index (slot pool)...")
        index = StreamingIndex.from_static(corpus, graph, ef_insert=args.base_ef, device=dev)
        executor = StreamingLocalExecutor(index, consolidate_after=args.consolidate_after)
    elif args.distributed:
        from repro_torch.core import shard_corpus_for_mesh
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.serving import DistributedExecutor

        n_dev = mesh_device_count(dev)
        model = min(4, n_dev)
        mesh = make_test_mesh(n_dev, model=model, device=dev)
        print(f"mesh: {mesh.shape} over {len(set(mesh.devices))} device(s)")
        print("building partitioned index...")
        corpus_p, graph_p = build_partitioned_index(
            _generator(1, dev), corpus, n_shards=model, degree=16,
            sample_size_per_shard=128, device=dev)
        index_s = shard_corpus_for_mesh(corpus_p, graph_p, mesh)
        pq_index = train_pq(corpus_p.vectors) if args.approx == "pq" else None
        executor = DistributedExecutor(mesh, index_s, pq_index=pq_index)
    else:
        graph = graph_for(corpus)
        pq_index = train_pq(corpus.vectors) if args.approx == "pq" else None
        executor = LocalExecutor(corpus, graph, pq_index)

    tiers = make_tier_ladder(
        k_cap=args.k_cap,
        base_ef=args.base_ef,
        base_iters=args.base_iters,
        n_tiers=2,
    )
    if args.approx == "pq" or args.fuse != "auto":
        tiers = tuple(
            dataclasses.replace(t, approx=args.approx, fuse_expand=args.fuse)
            for t in tiers
        )
    if args.inject_faults > 0:
        from repro_torch.serving import (
            FaultClock,
            FaultConfig,
            FaultSchedule,
            FaultyExecutor,
        )

        fault_clock = FaultClock(clock)
        schedule = FaultSchedule(FaultConfig(
            seed=21,
            error_rate=args.inject_faults,
            spike_rate=args.inject_faults,
            spike_s=(args.deadline_ms / 2000.0) if args.deadline_ms > 0
            else 0.05,
            stale_epoch_rate=args.inject_faults if args.churn > 0 else 0.0,
        ))
        executor = FaultyExecutor(executor, schedule, fault_clock)
        clock = fault_clock

    slo_cfg = None
    if args.slo:
        from repro_torch.serving import SLOConfig

        slo_cfg = SLOConfig(
            target_latency=(args.deadline_ms / 1000.0)
            if args.deadline_ms > 0 else 0.05,
            queue_high=max(8, args.max_pending // 4),
            queue_low=max(4, args.max_pending // 16),
        )

    ladder = tuple(int(b) for b in args.ladder.split(","))
    runtime = ServingRuntime(
        executor,
        n_labels=args.labels,
        tiers=tiers,
        ladder=ladder,
        families=("label", "range"),
        max_wait=args.max_wait,
        max_pending=args.max_pending,
        clock=clock,
        slo=slo_cfg,
        shed_expired=args.slo,
        replica_id=replica_id,
    )
    if args.hybrid:
        if args.distributed:
            raise SystemExit(
                "--hybrid needs host-side posting lists; the distributed "
                "executor is graph-only for now (drop --distributed)"
            )
        from repro_torch.serving import make_serving_router

        runtime.router = make_serving_router(
            executor, n_labels=args.labels, controller=runtime.controller
        )
    return runtime


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="device of the corpus, index and every search (cuda or cpu); "
                    "the runtime never moves work off it")
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--d", type=int, default=32)
    ap.add_argument("--labels", type=int, default=10)
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--rate", type=float, default=2000.0,
                    help="Poisson arrival rate (requests/s of virtual time)")
    ap.add_argument("--k-cap", type=int, default=16)
    ap.add_argument("--ladder", default="8,32,128",
                    help="comma batch-bucket ladder")
    ap.add_argument("--base-ef", type=int, default=64)
    ap.add_argument("--base-iters", type=int, default=128,
                    help="tier-0 max_iters (escalation tier gets 4x)")
    ap.add_argument("--max-wait", type=float, default=0.005,
                    help="batcher flush timeout (s)")
    ap.add_argument("--max-pending", type=int, default=1024,
                    help="admission-queue bound (backpressure)")
    ap.add_argument("--distributed", action="store_true",
                    help="serve through the scatter-search-merge mesh path "
                    "(a (n_dev // model, model) mesh, model = min(4, n_dev))")
    ap.add_argument("--churn", type=float, default=0.0,
                    help="fraction of the stream that is upsert/delete "
                    "traffic against the streaming mutable index (0 = "
                    "static index; try 0.3 to replay the churn workload)")
    ap.add_argument("--consolidate-after", type=int, default=64,
                    help="pending tombstones that trigger a background "
                    "consolidation pass at the next flush boundary")
    ap.add_argument(
        "--approx", default="exact", choices=("exact", "pq"),
        help="distance backend for the walk: exact rows or PQ/ADC codes "
        "(trains a PQ index on the corpus; exact re-rank post-loop)",
    )
    ap.add_argument(
        "--hybrid", action="store_true",
        help="selectivity-adaptive execution (DESIGN.md §9): a per-query "
        "strategy router estimates constraint selectivity from incremental "
        "histograms and dispatches each request to the graph walk, a "
        "brute-force posting-set scan, or a cached label-subgraph overlay",
    )
    ap.add_argument(
        "--slo", action="store_true",
        help="fault-tolerant serving under SLO (DESIGN.md §10): expired "
        "requests are shed at flush time instead of served late, and a "
        "hysteretic degradation ladder caps tiers / prefers cheap "
        "strategies / predictively sheds as overload deepens",
    )
    ap.add_argument(
        "--deadline-ms", type=float, default=0.0,
        help="per-query deadline in virtual-time milliseconds (0 = no "
        "deadline); with --slo, expired requests are shed with a pollable "
        "shed_reason instead of completing late",
    )
    ap.add_argument(
        "--inject-faults", type=float, default=0.0,
        help="seeded fault-injection rate (per search dispatch: this "
        "probability each of an executor error and a latency spike; with "
        "--churn also a stale-epoch rate per refresh). Exercises the "
        "retry-within-budget and failed-Response recovery paths",
    )
    ap.add_argument(
        "--fuse", default="auto", choices=("auto", "on", "off"),
        help="fused candidate pipeline ('on' forces the one-pass "
        "fused_expand / fused_expand_adc kernel for either backend, applied "
        "to every serving tier)",
    )
    ap.add_argument(
        "--serve-http", type=int, default=None, metavar="PORT",
        help="instead of replaying a synthetic stream, serve over HTTP "
        "(DESIGN.md §12): POST /v1/search /v1/upsert /v1/delete, GET "
        "/metrics (Prometheus text), /healthz, /varz. Runs on the wall "
        "clock; SIGINT / SIGTERM drains in-flight work and exits. Port 0 "
        "picks a free port",
    )
    ap.add_argument(
        "--replicas", type=int, default=1, metavar="N",
        help="shared-nothing runtime replicas behind the HTTP front end "
        "(DESIGN.md §13): each gets its own closure cache, controller, "
        "batcher, pump thread, and (with --churn) slot pool; mutations "
        "broadcast to all at one enqueue boundary. Needs --serve-http",
    )
    ap.add_argument(
        "--router", default="hash", choices=("hash", "least-loaded"),
        help="replica router: consistent-hash by request key (closure-"
        "cache affinity, deterministic) or least-loaded by pending depth",
    )
    ap.add_argument(
        "--log-json", default=None, metavar="PATH",
        help="structured JSON request logs (admit/dispatch/complete/shed "
        "records with req_id/batch_id/epoch) buffered in a bounded ring "
        "and flushed to PATH at the end (at shutdown under --serve-http)",
    )
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    if args.replicas < 1:
        raise SystemExit("--replicas must be >= 1")
    if args.replicas > 1 and args.serve_http is None:
        raise SystemExit("--replicas N needs --serve-http (the replica "
                         "tier lives behind the HTTP front end)")
    if args.replicas > 1 and args.distributed:
        raise SystemExit("--replicas replicates the local executor; the "
                         "mesh path is single-tier (drop --distributed)")
    dev = resolve_device(args.device)

    corpus = make_labeled_corpus(_generator(0, dev), n=args.n, d=args.d,
                                 n_labels=args.labels, device=dev)
    corpus = dataclasses.replace(
        corpus, attrs=torch.rand((args.n, 2), generator=_generator(5, dev), device=dev))

    # HTTP mode serves real clients, so it runs on the wall clock; replay
    # mode keeps the deterministic virtual timeline.
    if args.serve_http is not None:
        from repro_torch.serving import wall_clock

        clock = wall_clock
    else:
        clock = VirtualClock()
    if args.replicas > 1:
        from repro_torch.serving import ReplicaSet, make_replica_router

        print(f"building index (shared across {args.replicas} replicas)...")
        shared_graph = build_index(_generator(1, dev), corpus, degree=16, sample_size=512,
                                   device=dev)
        runtime = ReplicaSet(
            [
                build_runtime(args, corpus, clock, dev, prebuilt_graph=shared_graph,
                              replica_id=i)
                for i in range(args.replicas)
            ],
            router=make_replica_router(args.router, args.replicas),
        )
        trace_budget = runtime.replicas[0].trace_budget
    else:
        runtime = build_runtime(args, corpus, clock, dev)
        trace_budget = runtime.trace_budget
    logger = None
    if args.log_json is not None:
        from repro_torch.obs import JsonLogger

        # The single runtime keeps its own clock (build_runtime may have
        # wrapped it in a FaultClock): virtual-time replays give
        # virtual-time logs; tier children bind their replica's clock in
        # attach_logger.
        logger = JsonLogger(clock=clock if args.replicas > 1 else runtime.clock)
        if args.replicas > 1:
            runtime.attach_logger(logger)
        else:
            runtime.logger = logger
    print(f"warming closure cache ({trace_budget} bucket shapes"
          + (f" x {args.replicas} replicas" if args.replicas > 1 else "")
          + f") on {dev}...")
    compiled = runtime.warmup()

    if args.serve_http is not None:
        serve_http(args, runtime, logger, compiled)
        return

    print(f"built {compiled} closures; serving {args.requests} requests "
          f"at Poisson rate {args.rate}/s...")

    k_choices = tuple(sorted({min(4, args.k_cap), min(8, args.k_cap),
                              args.k_cap}))
    deadline_s = args.deadline_ms / 1000.0 if args.deadline_ms > 0 else None
    retry = None
    if args.slo:
        from repro_torch.serving import RetryPolicy

        retry = RetryPolicy()  # backpressure rejections retry with backoff
    if args.churn > 0:
        from repro_torch.serving import churn_workload, replay_churn

        items = churn_workload(
            7, corpus, args.requests, args.labels,
            mutation_frac=args.churn, k_choices=k_choices,
        )
        responses, rejected = replay_churn(
            runtime, items, rate=args.rate, seed=11,
            deadline_s=deadline_s, retry=retry,
        )
    else:
        items = mixed_workload(
            7, corpus, args.requests, args.labels, k_choices=k_choices,
        )
        responses, rejected = replay_poisson(
            runtime, items, rate=args.rate, seed=11,
            deadline_s=deadline_s, retry=retry,
        )

    report = runtime.report()
    print(json.dumps(report, indent=2, default=str))
    served = [r for r in responses if r is not None]
    mean_fill = (
        sum(r.fill_frac for r in served) / len(served) if served else 0.0
    )
    print(
        f"served {len(served)}/{len(items)} requests "
        f"({rejected} rejected by backpressure) | "
        f"qps {report['telemetry'].get('qps', 0)} (virtual time) | mean fill "
        f"{mean_fill:.3f} | cache hit rate {report['cache']['hit_rate']} | "
        f"busy {runtime.busy_seconds:.3f} s on {dev}"
    )
    if args.slo or args.inject_faults > 0:
        counters = report["telemetry"]  # summary() flattens the counters
        goodput = sum(
            1 for r in served
            if r.ok and not r.deadline_missed and r.filled > 0
        )
        print(
            f"slo: goodput {goodput} | shed {counters.get('shed_total', 0)} "
            f"(expired {counters.get('shed_expired', 0)}, overload "
            f"{counters.get('shed_overload', 0)}) | "
            f"failed {counters.get('failed', 0)} | "
            f"fault retries {counters.get('fault_retries', 0)} | "
            f"degradation level {runtime.controller.degradation_level}"
        )
    if logger is not None:
        n = logger.flush_to_path(args.log_json)
        print(f"flushed {n} structured log records to {args.log_json}")


def serve_http(args, runtime, logger, compiled: int) -> None:
    """Serve ``runtime`` (one runtime or a ``ReplicaSet``) over HTTP until
    SIGINT or SIGTERM, then drain, flush the log and print the shutdown
    report."""
    import signal

    from repro_torch.obs.http import ServingFrontend

    frontend = ServingFrontend(runtime, logger=logger, port=args.serve_http)
    addr = frontend.start()
    print(f"built {compiled} closures; serving on {addr}")
    print(f"replicas: {frontend.n_replicas} (router "
          f"{runtime.router.name if args.replicas > 1 else 'n/a'})")
    print("routes: POST /v1/search /v1/upsert /v1/delete | "
          "GET /metrics /healthz /varz "
          "(SIGINT/SIGTERM drains and exits)", flush=True)
    # Explicit handlers: a supervisor (or a non-interactive shell that
    # spawned us with SIGINT ignored) sends SIGTERM — both signals must
    # take the same graceful drain-and-flush path as a TTY Ctrl-C.
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    print("draining...")
    report = frontend.close(drain=True, log_path=args.log_json)
    print(json.dumps({"shutdown": report}, indent=2), flush=True)


if __name__ == "__main__":
    main()
