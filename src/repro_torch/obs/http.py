"""Async HTTP front-end over ``ServingRuntime.submit``/``poll`` (port of
``repro.obs.http``, plain Python).

A stdlib ``ThreadingHTTPServer`` (no new dependencies) exposing:

    POST /v1/search   JSON {query, k, family, labels|range[, deadline_ms,
                      timeout_s]} -> submit, wait, return the Response
                      (ids, dists, fill, tier, trace breakdown, epoch,
                      replica, ...)
    POST /v1/upsert   JSON {vector[, label, attrs]} -> streaming insert;
                      broadcast to every replica of a tier
    POST /v1/delete   JSON {slot} -> streaming tombstone; broadcast
    GET  /metrics     Prometheus text exposition from the registry
    GET  /healthz     liveness + in-flight/queue snapshot (never blocks
                      behind a draining replica)
    GET  /varz        full runtime report (telemetry summary, cache,
                      controller, ladder level, epoch) as JSON

The front-end serves either ONE runtime or a ``ReplicaSet`` (duck-typed
on a ``.replicas`` attribute — DESIGN.md §13). Each replica stays
single-threaded behind its own lock with its own background *pump* thread
advancing its clock (virtual clocks advance by the batcher's ``max_wait``
per tick, so deterministic-clock runtimes serve over a real socket too)
and running ``step()``. Handler threads only submit under the routed
replica's lock and then poll-wait, so each replica's batcher still groups
concurrent requests into shared microbatches.

Locking is strictly per replica — there is NO front-end-global lock on
the hot path. ``/healthz`` and ``/metrics`` acquire each replica lock
with a short timeout (falling back to a lock-free peek), so one slow
replica mid-drain can never stall the tier's health or scrape surface
(the single-RLock ``close()`` stall this replaces).

Tensors never cross this module: a request's JSON becomes one float32 numpy
row, the runtime assembles each microbatch on its executor's device, and a
response comes back through the runtime's one synchronising copy
(``serving.runtime.read_back``) as numpy ids and distances.

``close()`` is the graceful shutdown: stop admitting, stop the pumps,
drain every replica concurrently (every in-flight request completes or
sheds — nothing is lost), flush the structured-log sink, then stop the
socket.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np


def _response_payload(resp, replica: Optional[int] = None) -> dict:
    return {
        "req_id": resp.req_id,
        "ids": [int(i) for i in np.asarray(resp.ids).tolist()],
        "dists": [float(d) for d in np.asarray(resp.dists).tolist()],
        "k": resp.k,
        "filled": resp.filled,
        "fill_frac": resp.fill_frac,
        "tier": resp.tier,
        "escalations": resp.escalations,
        "latency_s": resp.latency,
        "deadline_missed": resp.deadline_missed,
        "epoch": resp.epoch,
        "strategy": resp.strategy,
        "shed_reason": resp.shed_reason,
        "degraded": resp.degraded,
        "error": resp.error,
        "trace": resp.trace,
        "batch_id": resp.batch_id,
        "replica": replica,
    }


class ServingFrontend:
    """HTTP surface + per-replica pump threads over one runtime or a
    ``ReplicaSet``."""

    def __init__(
        self,
        runtime,
        registry=None,
        logger=None,
        host: str = "127.0.0.1",
        port: int = 0,
        pump_interval: float = 0.0005,
        default_timeout_s: float = 10.0,
    ):
        # A ReplicaSet quacks via .replicas/.locks; a bare runtime gets a
        # one-element tier-shaped view so every code path below is shared.
        self.tier = runtime if hasattr(runtime, "replicas") else None
        self.runtime = runtime
        if self.tier is not None:
            self.runtimes = list(self.tier.replicas)
            self.locks = list(self.tier.locks)
        else:
            self.runtimes = [runtime]
            self.locks = [threading.RLock()]
        # Callers of a single-runtime front end coordinate with its pump
        # through ``frontend.lock``: replica 0's lock.
        self.lock = self.locks[0]
        if registry is None:
            if self.tier is not None:
                from repro_torch.obs.adapters import instrument_tier

                registry = instrument_tier(self.tier)
            else:
                from repro_torch.obs.adapters import instrument_runtime

                registry = instrument_runtime(runtime)
        self.registry = registry
        self.logger = logger
        if logger is not None:
            # One shared logger: HTTP lifecycle records and the runtimes'
            # admit/dispatch/complete records interleave on the runtime's
            # (possibly virtual) clock; tier replicas log through bound
            # children stamping their replica id.
            if logger.clock is None:
                logger.clock = self.runtimes[0].clock
            if self.tier is not None:
                self.tier.attach_logger(logger)
            elif getattr(runtime, "logger", None) is None:
                runtime.logger = logger
        self.n_labels = self.runtimes[0].n_labels
        self.host = host
        self._port = int(port)
        self.pump_interval = float(pump_interval)
        self.default_timeout_s = float(default_timeout_s)
        self._server: Optional[ThreadingHTTPServer] = None
        self._threads: list = []
        self._stop = threading.Event()
        self._accepting = False
        self._meta_lock = threading.Lock()
        self.started_requests = 0

    # --- lifecycle --------------------------------------------------------
    @property
    def port(self) -> int:
        return self._server.server_address[1] if self._server else self._port

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}"

    @property
    def n_replicas(self) -> int:
        return len(self.runtimes)

    def start(self) -> str:
        frontend = self

        class Handler(_Handler):
            pass

        Handler.frontend = frontend
        self._server = ThreadingHTTPServer((self.host, self._port), Handler)
        self._server.daemon_threads = True
        self._stop.clear()
        self._accepting = True
        serve = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.05},
            name="obs-http-serve",
            daemon=True,
        )
        self._threads = [serve]
        for i in range(self.n_replicas):
            self._threads.append(threading.Thread(
                target=self._pump, args=(i,),
                name=f"obs-http-pump-{i}", daemon=True,
            ))
        for t in self._threads:
            t.start()
        if self.logger is not None:
            self.logger.log(
                "http_start", address=self.address, replicas=self.n_replicas
            )
        return self.address

    def _pump(self, i: int) -> None:
        runtime = self.runtimes[i]
        lock = self.locks[i]
        while not self._stop.is_set():
            with lock:
                clock = runtime.clock
                if hasattr(clock, "advance"):
                    # Virtual-clock runtimes never see max_wait elapse on
                    # their own; the pump supplies the passage of time.
                    clock.advance(runtime.batcher.max_wait)
                runtime.step()
            self._stop.wait(self.pump_interval)

    def close(self, drain: bool = True, log_path: Optional[str] = None) -> dict:
        """Graceful shutdown: stop admitting, stop the pumps, drain every
        replica concurrently (each under its own lock — ``/healthz`` and
        ``/metrics`` keep answering while a slow replica drains), flush
        the log sink (optionally to ``log_path``), stop the socket.
        Returns a small shutdown report."""
        self._accepting = False
        self._stop.set()
        # The pumps stop at their next tick; the socket's serve thread only
        # once the server shuts down, below.
        serve, pumps = self._threads[:1], self._threads[1:]
        for t in pumps:
            if t is not threading.current_thread():
                t.join(timeout=5.0)
        drained = 0
        per_replica = [0] * self.n_replicas
        if drain:
            if self.tier is not None:
                drained = self.tier.drain()
                per_replica = [rt.telemetry.counters["completed"]
                               for rt in self.runtimes]
            else:
                with self.locks[0]:
                    drained = self.runtime.drain()
                per_replica = [drained]
        in_flight = sum(rt.in_flight for rt in self.runtimes)
        if self.logger is not None:
            self.logger.log(
                "http_shutdown", drained=drained, in_flight=in_flight,
            )
        flushed = 0
        if self.logger is not None and log_path is not None:
            flushed = self.logger.flush_to_path(log_path)
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        for t in serve:
            if t is not threading.current_thread():
                t.join(timeout=5.0)
        return {
            "drained": drained,
            "in_flight": in_flight,
            "log_records_flushed": flushed,
            "replicas": self.n_replicas,
            "completed_per_replica": per_replica,
        }

    # --- request handling (called from handler threads) -------------------
    def handle_search(self, payload: dict) -> tuple:
        from repro_torch.serving.types import AdmissionError

        try:
            query = np.asarray(payload["query"], dtype=np.float32)
            k = int(payload.get("k", 10))
            family = str(payload["family"])
            operand = self._parse_operand(family, payload)
        except (KeyError, TypeError, ValueError) as e:
            return 400, {"error": f"bad request: {e}"}
        timeout_s = float(payload.get("timeout_s", self.default_timeout_s))
        if not self._accepting:
            return 503, {"error": "shutting down"}
        deadline_s = None
        if payload.get("deadline_ms") is not None:
            deadline_s = float(payload["deadline_ms"]) / 1e3
        try:
            if self.tier is not None:
                replica, req_id = self.tier.submit(
                    query, k, family, operand, deadline_s=deadline_s
                )
            else:
                replica = 0
                with self.locks[0]:
                    deadline = (
                        self.runtime.clock() + deadline_s
                        if deadline_s is not None else None
                    )
                    req_id = self.runtime.submit(
                        query, k, family, operand, deadline=deadline
                    )
        except AdmissionError as e:
            return 429, {"error": str(e)}
        except (TypeError, ValueError) as e:
            return 400, {"error": f"bad request: {e}"}
        with self._meta_lock:
            self.started_requests += 1
        give_up = time.monotonic() + timeout_s
        while time.monotonic() < give_up:
            with self.locks[replica]:
                resp = self.runtimes[replica].poll(req_id)
            if resp is not None:
                return 200, _response_payload(
                    resp,
                    replica=(
                        replica if self.tier is not None
                        else self.runtime.replica_id
                    ),
                )
            time.sleep(self.pump_interval)
        return 504, {
            "error": "timed out waiting for completion",
            "req_id": req_id,
            "replica": replica if self.tier is not None else None,
        }

    def handle_mutation(self, kind: str, payload: dict) -> tuple:
        """Streaming upsert/delete over the wire. On a tier the mutation
        is broadcast to every replica at one enqueue boundary and the
        reply aggregates all replicas' outcomes (slot agreement included);
        a single runtime answers with the plain response payload."""
        from repro_torch.serving.types import AdmissionError

        timeout_s = float(payload.get("timeout_s", self.default_timeout_s))
        if not self._accepting:
            return 503, {"error": "shutting down"}
        try:
            if kind == "upsert":
                vector = np.asarray(payload["vector"], dtype=np.float32)
                label = int(payload.get("label", 0))
                attrs = payload.get("attrs")
                if attrs is not None:
                    attrs = np.asarray(attrs, dtype=np.float32)
                if self.tier is not None:
                    handles = self.tier.submit_upsert(
                        vector, label=label, attrs=attrs
                    )
                else:
                    with self.locks[0]:
                        handles = ((0, self.runtime.submit_upsert(
                            vector, label=label, attrs=attrs
                        )),)
            else:  # delete
                slot = int(payload["slot"])
                if self.tier is not None:
                    handles = self.tier.submit_delete(slot)
                else:
                    with self.locks[0]:
                        handles = ((0, self.runtime.submit_delete(slot)),)
        except AdmissionError as e:
            return 429, {"error": str(e)}
        except (KeyError, TypeError, ValueError) as e:
            # TypeError covers "mutations need a streaming executor".
            return 400, {"error": f"bad request: {e}"}
        with self._meta_lock:
            self.started_requests += 1
        results: dict = {}
        give_up = time.monotonic() + timeout_s
        while time.monotonic() < give_up and len(results) < len(handles):
            for i, rid in handles:
                if (i, rid) in results:
                    continue
                with self.locks[i]:
                    resp = self.runtimes[i].poll(rid)
                if resp is not None:
                    results[(i, rid)] = resp
            if len(results) < len(handles):
                time.sleep(self.pump_interval)
        if len(results) < len(handles):
            return 504, {
                "error": f"timed out waiting for {kind} broadcast",
                "completed": len(results),
                "expected": len(handles),
            }
        per_replica = [
            {
                "replica": i,
                "req_id": rid,
                "slot": int(np.asarray(results[(i, rid)].ids)[0]),
                "ok": bool(results[(i, rid)].filled),
                "epoch": results[(i, rid)].epoch,
                "error": results[(i, rid)].error,
            }
            for i, rid in handles
        ]
        slots = {r["slot"] for r in per_replica}
        body = {
            "family": kind,
            "ok": all(r["ok"] for r in per_replica),
            "slot": per_replica[0]["slot"] if len(slots) == 1 else None,
            "slot_consistent": len(slots) == 1,
            "replicas": per_replica,
        }
        if self.tier is None:
            body["epoch"] = per_replica[0]["epoch"]
        return 200, body

    def _parse_operand(self, family: str, payload: dict):
        from repro_torch.serving.workload import label_words_row

        if family == "label":
            labels = payload.get("labels")
            if labels is None:
                raise ValueError("label family needs a 'labels' list")
            return label_words_row([int(x) for x in labels], self.n_labels)
        if family == "range":
            rng = payload.get("range")
            if rng is None or len(rng) != 3:
                raise ValueError("range family needs 'range': [lo, hi, col]")
            return (float(rng[0]), float(rng[1]), int(rng[2]))
        raise ValueError(f"unknown family {family!r}")

    def handle_metrics(self) -> tuple:
        if self.tier is not None:
            # Tier registries lock per replica inside each family callback
            # (with timeouts) — no front-end lock to hold here.
            return 200, self.registry.render_prometheus()
        got = self.locks[0].acquire(timeout=1.0)
        try:
            return 200, self.registry.render_prometheus()
        finally:
            if got:
                self.locks[0].release()

    def handle_healthz(self) -> tuple:
        """Liveness must answer even while a replica drains: every replica
        lock is tried with a short timeout, and a busy replica is reported
        from a lock-free peek instead of awaited."""
        replicas = []
        for i, rt in enumerate(self.runtimes):
            got = self.locks[i].acquire(timeout=0.05)
            try:
                try:
                    depth = rt.batcher.pending_count()
                except RuntimeError:
                    # Lock-free peek raced the pump mutating the batcher's
                    # group dict; depth is unknowable this instant.
                    depth = -1
                replicas.append({
                    "replica": i,
                    "locked": not got,
                    "in_flight": rt.in_flight,
                    "queue_depth": depth,
                })
            finally:
                if got:
                    self.locks[i].release()
        body = {
            "status": "ok" if self._accepting else "draining",
            "in_flight": sum(r["in_flight"] for r in replicas),
            "queue_depth": sum(max(r["queue_depth"], 0) for r in replicas),
        }
        if self.tier is not None:
            body["replicas"] = replicas
        return 200, body

    def handle_varz(self) -> tuple:
        if self.tier is not None:
            report = self.tier.report()
            report["started_requests"] = self.started_requests
            return 200, report
        with self.locks[0]:
            report = self.runtime.report()
            report["degradation_level"] = self.runtime.controller.degradation_level
            report["epoch"] = getattr(self.runtime.executor, "epoch", None)
            report["started_requests"] = self.started_requests
        return 200, report


class _Handler(BaseHTTPRequestHandler):
    frontend: ServingFrontend  # bound per server in ServingFrontend.start
    protocol_version = "HTTP/1.1"

    # Route stdlib request logging into the structured logger (or drop it)
    # instead of spamming stderr.
    def log_message(self, format: str, *args) -> None:  # noqa: A002
        logger = self.frontend.logger
        if logger is not None:
            logger.log("http_access", detail=format % args)

    def _send_json(self, status: int, payload: dict) -> None:
        body = json.dumps(payload, default=str).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, status: int, text: str, ctype: str) -> None:
        body = text.encode()
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 (stdlib API name)
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            status, body = self.frontend.handle_metrics()
            self._send_text(
                status, body, "text/plain; version=0.0.4; charset=utf-8"
            )
        elif path == "/healthz":
            self._send_json(*self.frontend.handle_healthz())
        elif path == "/varz":
            self._send_json(*self.frontend.handle_varz())
        else:
            self._send_json(404, {"error": f"no route {path!r}"})

    def do_POST(self) -> None:  # noqa: N802 (stdlib API name)
        path = self.path.split("?", 1)[0]
        routes = {
            "/v1/search": lambda p: self.frontend.handle_search(p),
            "/v1/upsert": lambda p: self.frontend.handle_mutation("upsert", p),
            "/v1/delete": lambda p: self.frontend.handle_mutation("delete", p),
        }
        handler = routes.get(path)
        if handler is None:
            self._send_json(404, {"error": f"no route {path!r}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
        except (ValueError, json.JSONDecodeError) as e:
            self._send_json(400, {"error": f"bad JSON body: {e}"})
            return
        self._send_json(*handler(payload))
