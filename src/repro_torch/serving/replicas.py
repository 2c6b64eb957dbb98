"""Shared-nothing replica tier over N ``ServingRuntime``s (DESIGN.md §13;
port of ``repro.serving.replicas``, plain Python).

Each replica owns its whole serving stack — closure cache, batcher,
controller, telemetry, and (streaming) slot pool — so replicas never share
mutable state and never contend on one lock. The tier adds exactly three
things on top:

  * a pluggable ``ReplicaRouter`` deciding which replica serves each query
    (``ConsistentHashRouter`` by request key for closure-cache affinity;
    ``LeastLoadedRouter`` by the pending-depth gauge as the alternative);
  * per-replica ``RLock``s — the submit/step/drain critical section is per
    replica, so one slow replica (or its shutdown drain) can never stall
    the others or the front-end's read-only surfaces;
  * epoch-consistent mutation broadcast: upserts/deletes are enqueued into
    EVERY replica's batcher under all replica locks at once, so no replica
    can flush the mutation before the others have it. Each replica then
    applies it at its own next flush boundary with the atomic
    snapshot swap — replicas built from the same seed state and fed the
    same broadcast order assign identical slot ids and converge to the
    same epoch at quiesce.

The tier deliberately quacks enough like a single runtime for the HTTP
front-end (``repro_torch.obs.http``) to serve either: it exposes ``replicas``,
``locks``, ``submit``/``poll`` (routed), broadcast mutations, ``drain``,
``in_flight`` and ``report``.
"""
from __future__ import annotations

import bisect
import hashlib
import threading
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.serving.types import AdmissionError


def _hash64(key) -> int:
    """Stable 64-bit hash (process-independent — ``hash()`` is salted)."""
    digest = hashlib.blake2b(str(key).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "big")


class ConsistentHashRouter:
    """Hash-ring routing by request key.

    Each replica owns ``vnodes`` points on a 64-bit ring; a key routes to
    the first point clockwise of its hash. Two properties the tests pin:
    the mapping is deterministic across processes (blake2b, not the salted
    builtin), and resizing N -> N+1 moves only the keys landing on the new
    replica's arcs — expected fraction 1/(N+1), never a full reshuffle
    (the closure-cache-affinity argument for hash routing).
    """

    name = "hash"

    def __init__(self, n_replicas: int, vnodes: int = 64):
        if n_replicas <= 0:
            raise ValueError(f"need at least one replica: {n_replicas}")
        self.n_replicas = int(n_replicas)
        self.vnodes = int(vnodes)
        points: List[Tuple[int, int]] = []
        for i in range(self.n_replicas):
            for v in range(self.vnodes):
                points.append((_hash64(f"replica-{i}/vnode-{v}"), i))
        points.sort()
        self._points = [p for p, _ in points]
        self._owners = [i for _, i in points]

    def route(self, key, loads: Optional[Sequence[int]] = None) -> int:
        del loads  # hash routing ignores load
        idx = bisect.bisect_right(self._points, _hash64(key))
        if idx == len(self._points):
            idx = 0  # wrap past the last ring point
        return self._owners[idx]


class LeastLoadedRouter:
    """Route to the replica with the smallest pending depth (the
    ``queue_depth`` gauge); ties break to the lowest replica index so the
    verdict is deterministic."""

    name = "least-loaded"

    def __init__(self, n_replicas: int):
        if n_replicas <= 0:
            raise ValueError(f"need at least one replica: {n_replicas}")
        self.n_replicas = int(n_replicas)

    def route(self, key, loads: Sequence[int]) -> int:
        del key
        if len(loads) != self.n_replicas:
            raise ValueError(
                f"{len(loads)} loads for {self.n_replicas} replicas"
            )
        return min(range(self.n_replicas), key=lambda i: (loads[i], i))


ROUTER_KINDS = ("hash", "least-loaded")


def make_replica_router(kind: str, n_replicas: int):
    if kind == "hash":
        return ConsistentHashRouter(n_replicas)
    if kind == "least-loaded":
        return LeastLoadedRouter(n_replicas)
    raise ValueError(f"unknown router {kind!r} (have {ROUTER_KINDS})")


class ReplicaSet:
    """N shared-nothing runtimes + router + per-replica locks."""

    def __init__(self, replicas: Sequence, router=None, logger=None):
        if not replicas:
            raise ValueError("a replica tier needs at least one runtime")
        self.replicas = list(replicas)
        self.locks = [threading.RLock() for _ in self.replicas]
        self.router = router or ConsistentHashRouter(len(self.replicas))
        for i, rt in enumerate(self.replicas):
            rt.replica_id = i
        # One tier-wide monotonic key: the hash router's request key and
        # the submitted counter the tier-level metrics expose.
        self._submitted = 0
        self._state_lock = threading.Lock()
        if logger is not None:
            self.attach_logger(logger)

    # --- shape -----------------------------------------------------------
    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    @property
    def n_labels(self) -> int:
        return self.replicas[0].n_labels

    @property
    def submitted(self) -> int:
        return self._submitted

    @property
    def in_flight(self) -> int:
        return sum(rt.in_flight for rt in self.replicas)

    def pending(self) -> int:
        return sum(rt.batcher.pending_count() for rt in self.replicas)

    def loads(self) -> List[int]:
        """Pending-depth gauge per replica (what LeastLoadedRouter reads)."""
        return [rt.batcher.pending_count() for rt in self.replicas]

    def epochs(self) -> List[Optional[int]]:
        return [getattr(rt.executor, "epoch", None) for rt in self.replicas]

    def attach_logger(self, logger) -> None:
        """Give each replica a child logger bound to its replica id (one
        shared ring sink, per-replica clocks)."""
        for i, rt in enumerate(self.replicas):
            if rt.logger is None:
                child = logger.bind(replica=i)
                child.clock = rt.clock
                rt.logger = child

    def warmup(self) -> int:
        return sum(rt.warmup() for rt in self.replicas)

    # --- queries ---------------------------------------------------------
    def submit(
        self,
        query,
        k: int,
        family: str,
        operand,
        deadline_s: Optional[float] = None,
    ) -> Tuple[int, int]:
        """Route one query; returns ``(replica, local req_id)`` — replicas
        number their own requests, so the pair is the tier-global handle.
        ``deadline_s`` is relative: the absolute deadline is computed
        against the ROUTED replica's clock (each replica owns its own
        timeline)."""
        with self._state_lock:
            key = self._submitted
            self._submitted += 1
        i = self.router.route(key, self.loads())
        rt = self.replicas[i]
        with self.locks[i]:
            deadline = rt.clock() + deadline_s if deadline_s is not None else None
            req_id = rt.submit(query, k, family, operand, deadline=deadline)
        return i, req_id

    def poll(self, replica: int, req_id: int):
        with self.locks[replica]:
            return self.replicas[replica].poll(req_id)

    # --- mutation broadcast ----------------------------------------------
    def _broadcast(self, fn: Callable) -> Tuple[Tuple[int, int], ...]:
        """Enqueue one mutation into every replica under ALL replica locks
        (acquired in index order — every broadcaster uses the same order,
        so no deadlock). Holding all locks means no replica can reach its
        next flush boundary before every replica has the mutation: each
        one's atomic snapshot swap then publishes it at its own next
        flush, and replicas fed the same broadcast order stay identical."""
        acquired = []
        try:
            for lk in self.locks:
                lk.acquire()
                acquired.append(lk)
            # All-or-nothing admission: a partial broadcast (one replica
            # full, the rest enqueued) would diverge the replicas forever,
            # so capacity is checked everywhere before anything enqueues.
            for i, rt in enumerate(self.replicas):
                if rt.in_flight >= rt.max_pending:
                    raise AdmissionError(
                        f"replica {i} at max_pending={rt.max_pending}; "
                        "broadcast refused"
                    )
            with self._state_lock:
                self._submitted += 1
            return tuple(
                (i, fn(rt)) for i, rt in enumerate(self.replicas)
            )
        finally:
            for lk in reversed(acquired):
                lk.release()

    def submit_upsert(
        self, vector, label: int = 0, attrs=None
    ) -> Tuple[Tuple[int, int], ...]:
        """Broadcast one insert; returns ``((replica, req_id), ...)`` for
        every replica."""
        return self._broadcast(
            lambda rt: rt.submit_upsert(vector, label=label, attrs=attrs)
        )

    def submit_delete(self, slot: int) -> Tuple[Tuple[int, int], ...]:
        """Broadcast one tombstone delete of ``slot`` (slot ids agree
        across replicas by the identical-history construction)."""
        return self._broadcast(lambda rt: rt.submit_delete(slot))

    def poll_all(self, handles: Sequence[Tuple[int, int]]) -> list:
        """Poll a broadcast's handles; None entries are still pending."""
        return [self.poll(i, rid) for i, rid in handles]

    # --- pump / shutdown --------------------------------------------------
    def step_all(self, force: bool = False) -> int:
        done = 0
        for i, rt in enumerate(self.replicas):
            with self.locks[i]:
                done += rt.step(force=force)
        return done

    def drain(self) -> int:
        """Drain every replica concurrently (each under its own lock) —
        total completions returned; zero in-flight loss by the runtime's
        own drain contract."""
        drained = [0] * len(self.replicas)

        def _one(i: int) -> None:
            with self.locks[i]:
                drained[i] = self.replicas[i].drain()

        threads = [
            threading.Thread(target=_one, args=(i,), name=f"replica-drain-{i}")
            for i in range(len(self.replicas))
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return sum(drained)

    # --- reporting --------------------------------------------------------
    def report(self) -> dict:
        return {
            "replicas": [rt.report() for rt in self.replicas],
            "n_replicas": self.n_replicas,
            "router": self.router.name,
            "submitted": self._submitted,
            "in_flight": self.in_flight,
            "pending": self.pending(),
            "epochs": self.epochs(),
        }
