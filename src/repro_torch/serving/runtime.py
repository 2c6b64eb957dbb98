"""Online serving runtime: submit/poll front over batcher + cache + controller
(port of ``repro.serving.runtime``).

``ServingRuntime`` is the event loop gluing the subsystem together
(DESIGN.md §7): ``submit`` admits one constrained query (its own k,
constraint operand, deadline) under a bounded admission queue
(backpressure — ``AdmissionError`` when full), ``step`` flushes due
microbatches through the shape-bucketed closure cache and routes
under-filled results back through the controller's escalation tiers, and
``poll``/``drain`` hand completed ``Response`` records back to the caller.

The runtime is single-threaded and clock-injectable: drivers decide when
``step`` runs (serve loop, replay, tests with a fake clock). Search
execution is pluggable via an *executor* that builds one closure per
(bucket, family, tier) key:

  * ``LocalExecutor`` — ``build_context`` + ``search_with_context`` over an
    in-memory index on one device;
  * ``StreamingLocalExecutor`` — the same over the published snapshot of a
    mutable ``StreamingIndex``;
  * ``DistributedExecutor`` — ``make_distributed_search`` over an index
    placed on a device mesh (the scatter-search-merge path), uniform
    ``pq_index`` payload.

The port runs eagerly: there is no trace to count, so an executor counts
its ``build()`` calls in ``traces`` (one per cache key), which keeps the
reference's check ``executor.traces == runtime.cache.trace_count``.

Where the tensors live. Requests arrive as numpy; a microbatch's queries
and constraint are assembled on the executor's device (label words as the
port's int32 words, the same bits), the search runs there, and one
synchronising copy per dispatch brings its ids, distances, fill counts and
iteration count back to the host. The port never moves work to the CPU on
its own: the executor's device is the corpus's. On a card every tier
scores its distances through the ``gather_distance`` kernel (the runtime
sets ``use_kernel`` for each closure, posting scan and overlay walk it
dispatches); the plain PyTorch distances run only on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.constraints import WORD_BITS, LabelSetConstraint, RangeConstraint
from repro_torch.core.distributed import ShardedIndex, make_distributed_search
from repro_torch.core.engine.context import build_context
from repro_torch.core.engine.loop import search_with_context
from repro_torch.core.estimator import SelectivityEstimator
from repro_torch.core.histogram import AttributeHistograms
from repro_torch.core.overlay import OverlayCache, build_overlay, overlay_search
from repro_torch.core.posting import (
    PostingLists,
    RangeIndex,
    pad_posting,
    posting_bucket,
    posting_search,
)
from repro_torch.core.router import RouterConfig, StrategyRouter
from repro_torch.core.types import Corpus, GraphIndex, SearchParams, SearchResult
from repro_torch.obs.logs import JsonLogger
from repro_torch.obs.tracing import RequestTrace
from repro_torch.serving.batcher import BATCH_LADDER, DynamicBatcher, MicroBatch
from repro_torch.serving.cache import CompileCache
from repro_torch.serving.controller import AdaptiveController, make_tier_ladder
from repro_torch.serving.faults import ExecutorFault
from repro_torch.serving.slo import SLOConfig
from repro_torch.serving.telemetry import Telemetry
from repro_torch.serving.types import (
    MUTATION_FAMILIES,
    AdmissionError,
    DeleteRequest,
    Request,
    Response,
    UpsertRequest,
    cpu_clock,
    deadline_missed,
    wall_clock,
)

# ---------------------------------------------------------------------------
# microbatch -> device tensors
# ---------------------------------------------------------------------------


def assemble_queries(mb: MicroBatch, dim: int, device) -> torch.Tensor:
    rows = [np.asarray(r.query, dtype=np.float32).reshape(dim) for r in mb.requests]
    rows.extend([rows[-1]] * mb.n_padded)  # pad = repeat last real lane
    return torch.from_numpy(np.stack(rows)).to(device)


def assemble_constraint(mb: MicroBatch, device):
    if mb.family == "label":
        # uint32 words -> int32 words with the same bits (a view, never a
        # value cast: labels 31 and 63 set bit 31).
        words = [np.asarray(r.operand, dtype=np.uint32) for r in mb.requests]
        words.extend([words[-1]] * mb.n_padded)
        return LabelSetConstraint(
            words=torch.from_numpy(np.stack(words).view(np.int32)).to(device)
        )
    if mb.family == "range":
        lo = [float(r.operand[0]) for r in mb.requests]
        hi = [float(r.operand[1]) for r in mb.requests]
        lo.extend([lo[-1]] * mb.n_padded)
        hi.extend([hi[-1]] * mb.n_padded)
        return RangeConstraint(
            lo=torch.from_numpy(np.asarray(lo, np.float32)).to(device),
            hi=torch.from_numpy(np.asarray(hi, np.float32)).to(device),
            col=int(mb.group[1]),
        )
    raise ValueError(f"unknown constraint family: {mb.family}")


def read_back(res: SearchResult):
    """-> (ids (B, K) int32, dists (B, K) float32, filled (B,) int32,
    iters int) on the host, in ONE synchronising device-to-host copy: the
    four results are packed as int32 words (distances by their bits), so the
    copy returns only after the search has finished on the device."""
    b, k = res.ids.shape
    packed = torch.cat([
        res.ids.reshape(-1).to(torch.int32),
        res.dists.reshape(-1).contiguous().view(torch.int32),
        res.filled.to(torch.int32),
        res.stats.iters.reshape(1).to(torch.int32),
    ]).cpu().numpy()
    ids = packed[: b * k].reshape(b, k)
    dists = packed[b * k : 2 * b * k].view(np.float32).reshape(b, k)
    filled = packed[2 * b * k : 2 * b * k + b]
    return ids, dists, filled, int(packed[-1])


# ---------------------------------------------------------------------------
# executors
# ---------------------------------------------------------------------------


class LocalExecutor:
    """Search closures over one in-memory (corpus, graph) on its device.

    ``traces`` counts ``build`` calls: one per (bucket, family, tier) key
    the cache admits, so the serving tests assert the trace budget against
    the closures that exist, not just the cache's bookkeeping.
    """

    def __init__(self, corpus: Corpus, graph: GraphIndex, pq_index=None):
        self.corpus = corpus
        self.graph = graph
        self.pq_index = pq_index
        self.traces = 0

    @property
    def dim(self) -> int:
        return self.corpus.dim

    @property
    def device(self) -> torch.device:
        return self.corpus.vectors.device

    def build(
        self, bucket: int, family: str, params: SearchParams
    ) -> Callable[..., SearchResult]:
        del bucket, family  # fixed by the assembled shapes themselves
        self.traces += 1

        def fn(queries: torch.Tensor, constraint) -> SearchResult:
            ctx = build_context(self.corpus, constraint, queries, params, self.pq_index,
                                degree=self.graph.neighbors.shape[1])
            return search_with_context(ctx, self.corpus, self.graph, queries, params)

        return fn


class StreamingLocalExecutor:
    """Epoch-versioned closures over a mutable ``StreamingIndex``.

    The slot pool keeps every array shape static at the pool capacity, so
    ONE closure per (bucket, family, tier) serves every epoch — mutations
    swap the snapshot the closure reads, never its shapes. The swap is
    explicit (``refresh``): the runtime calls it once per flush boundary
    after applying that flush's mutation microbatches, so every query batch
    of a flush runs against one epoch and queries already dispatched keep
    the epoch they started with.
    """

    def __init__(self, index, *, consolidate_after: int = 64):
        self.index = index
        # Background consolidation policy: splice tombstones out once this
        # many deletes are pending (0 disables auto-consolidation).
        self.consolidate_after = int(consolidate_after)
        self.traces = 0
        self.snapshot = index.snapshot()

    @property
    def dim(self) -> int:
        return self.index.dim

    @property
    def device(self) -> torch.device:
        return self.index.device

    @property
    def epoch(self) -> int:
        return self.snapshot.epoch

    def refresh(self) -> int:
        """Publish the latest epoch (running consolidation when due) and
        atomically swap the snapshot future dispatches will read."""
        if (
            self.consolidate_after
            and self.index.pool.n_pending >= self.consolidate_after
        ):
            self.index.consolidate()
        self.snapshot = self.index.snapshot()
        return self.snapshot.epoch

    def apply_mutations(self, requests: Sequence[Request]) -> list:
        """Host-side mutation application; returns one (ok, slot) per
        request. The new epoch is NOT published here — ``refresh`` does
        that once per flush boundary. A request that cannot apply (e.g.
        pool exhaustion after an emergency consolidation) reports
        ``ok=False`` instead of raising: an exception mid-batch would
        strand the batch's requests in the runtime's in-flight count.
        """
        out = []
        for req in requests:
            if isinstance(req, UpsertRequest):
                label, attrs = req.operand
                try:
                    if self.index.pool.n_free == 0 and self.index.pool.n_pending:
                        # Emergency reclaim: trade one early consolidation
                        # for not shedding the insert.
                        self.index.consolidate()
                    slot = self.index.insert(req.query, label=label, attrs=attrs)
                    out.append((True, slot))
                except RuntimeError:  # pool exhausted, nothing reclaimable
                    out.append((False, -1))
            elif isinstance(req, DeleteRequest):
                slot = int(req.operand)
                out.append((self.index.delete(slot), slot))
            else:
                raise TypeError(f"not a mutation request: {type(req)}")
        return out

    def build(
        self, bucket: int, family: str, params: SearchParams
    ) -> Callable[..., SearchResult]:
        del bucket, family  # fixed by the assembled shapes themselves
        self.traces += 1

        def fn(queries: torch.Tensor, constraint) -> SearchResult:
            snap = self.snapshot  # the epoch pinned at dispatch time
            ctx = build_context(snap.corpus, constraint, queries, params, None,
                                degree=snap.graph.neighbors.shape[1])
            return search_with_context(ctx, snap.corpus, snap.graph, queries, params)

        return fn


class DistributedExecutor:
    """Scatter-search-merge closures over a mesh-placed index.

    One ``make_distributed_search`` per (family, tier) x bucket shape; the
    uniform trailing ``pq_index`` payload (None for exact) means no
    per-backend call branching here either. The runtime assembles each
    microbatch on the mesh's first device, and the search leaves its
    result there.
    """

    def __init__(self, mesh, index_s: ShardedIndex, pq_index=None):
        self.mesh = mesh
        self.index_s = index_s
        self.pq_index = pq_index
        self.traces = 0

    @property
    def dim(self) -> int:
        return self.index_s.dim

    @property
    def device(self) -> torch.device:
        return self.mesh.devices[0]

    def build(
        self, bucket: int, family: str, params: SearchParams
    ) -> Callable[..., SearchResult]:
        del bucket
        self.traces += 1
        ctype = LabelSetConstraint if family == "label" else RangeConstraint
        search = make_distributed_search(self.mesh, params, constraint_type=ctype)

        def fn(queries: torch.Tensor, constraint) -> SearchResult:
            return search(self.index_s, queries, constraint, self.pq_index)

        return fn


# ---------------------------------------------------------------------------
# hybrid routing plumbing (DESIGN.md §9)
# ---------------------------------------------------------------------------


class EpochRangeView:
    """Range-posting view over a streaming index that re-sorts lazily at
    each epoch — the router's applicability gate and the posting scan both
    read through this, so neither ever sees a stale sort order."""

    def __init__(self, index):
        self._index = index

    def _fresh(self):
        idx = self._index
        if idx.pool.attrs is not None:
            idx.range_index.refresh(
                idx.pool.attrs, idx.pool.live_mask(), idx.epoch
            )
        return idx.range_index

    def count_range(self, lo, hi, col) -> int:
        return self._fresh().count_range(lo, hi, col)

    def ids_for_range(self, lo, hi, col) -> np.ndarray:
        return self._fresh().ids_for_range(lo, hi, col)


def make_serving_router(
    executor,
    n_labels: int,
    config: Optional[RouterConfig] = None,
    controller: Optional[AdaptiveController] = None,
) -> StrategyRouter:
    """Wire a ``StrategyRouter`` to an executor's index state.

    Streaming executors share the index's incrementally-maintained
    histograms/postings (exact at every epoch); static ``LocalExecutor``s
    get one-shot structures built from one host copy of the corpus's labels
    and attributes.
    """
    if hasattr(executor, "apply_mutations"):  # streaming
        index = executor.index
        estimator = SelectivityEstimator(histograms=index.histograms)
        return StrategyRouter(
            estimator,
            n=index.capacity,
            config=config,
            postings=index.postings,
            range_index=EpochRangeView(index),
            controller=controller,
        )
    if not hasattr(executor, "corpus"):
        raise TypeError(
            f"hybrid routing needs a local or streaming executor; "
            f"have {type(executor).__name__}"
        )
    corpus = executor.corpus
    labels = corpus.labels.cpu().numpy()
    attrs = None if corpus.attrs is None else corpus.attrs.cpu().numpy()
    hist = AttributeHistograms.from_arrays(labels, attrs, n_labels=n_labels)
    postings = PostingLists.from_arrays(labels, n_labels=n_labels)
    range_index = RangeIndex()
    if attrs is not None:
        range_index.refresh(attrs, np.ones((labels.shape[0],), bool), 0)
    graph = getattr(executor, "graph", None)
    estimator = SelectivityEstimator(
        histograms=hist,
        corpus=corpus,
        sample_ids=None if graph is None else graph.sample_ids,
    )
    return StrategyRouter(
        estimator,
        n=int(labels.shape[0]),
        config=config,
        postings=postings,
        range_index=range_index,
        controller=controller,
    )


# ---------------------------------------------------------------------------
# the runtime
# ---------------------------------------------------------------------------


class ServingRuntime:
    def __init__(
        self,
        executor,
        *,
        n_labels: int,
        tiers: Optional[Tuple[SearchParams, ...]] = None,
        ladder: Tuple[int, ...] = BATCH_LADDER,
        families: Sequence[str] = ("label", "range"),
        max_wait: float = 0.002,
        max_pending: int = 1024,
        controller: Optional[AdaptiveController] = None,
        clock: Optional[Callable[[], float]] = None,
        router: Optional[StrategyRouter] = None,
        max_overlays: int = 8,
        slo: Optional[SLOConfig] = None,
        shed_expired: bool = True,
        max_fault_retries: int = 2,
        tracing: bool = True,
        logger: Optional[JsonLogger] = None,
        replica_id: Optional[int] = None,
    ):
        self.executor = executor
        self.n_labels = int(n_labels)
        # Which replica of a ReplicaSet this runtime is (None standalone);
        # stamped into every trace so a tier's spans are attributable.
        self.replica_id = replica_id
        tiers = tuple(tiers) if tiers is not None else make_tier_ladder()
        self.controller = controller or AdaptiveController(tiers, slo=slo)
        # The params each tier dispatches with: on a card, distances go
        # through the gather_distance kernel whatever the tier says.
        on_card = executor.device.type == "cuda"
        self._tier_params = tuple(
            dataclasses.replace(t, use_kernel=True) if on_card else t
            for t in self.controller.tiers
        )
        if slo is not None and self.controller.ladder is None:
            # A caller-supplied controller gains the ladder the runtime
            # was asked for (the ladder lives on the controller so
            # tier_for/escalate consult it without extra plumbing).
            from repro_torch.serving.slo import DegradationLadder

            self.controller.ladder = DegradationLadder(slo)
        # Fault-tolerance policy (DESIGN.md §10): shed already-expired
        # requests at flush time instead of burning a search they cannot
        # use (shed_expired=False serves them late, for A/B comparison),
        # and re-queue ExecutorFault-hit requests at most this many times
        # before surfacing a failed Response.
        self.shed_expired = bool(shed_expired)
        self.max_fault_retries = int(max_fault_retries)
        self.families = tuple(families)
        self.ladder = tuple(ladder)
        self.max_pending = int(max_pending)
        self.clock = clock or wall_clock
        self.batcher = DynamicBatcher(ladder=self.ladder, max_wait=max_wait)
        self.telemetry = Telemetry()
        # The declared trace budget: an arbitrary stream can reach at most
        # every (bucket, family, tier) combination.
        self.trace_budget = (
            len(self.ladder) * len(self.families) * len(self.controller.tiers)
        )
        self.cache = CompileCache(self._build_for_key, max_entries=self.trace_budget)
        # Completed-but-unpolled responses are bounded too: callers that
        # never poll must not grow the server (oldest evicted + counted).
        self._responses: Dict[int, Response] = {}
        self._max_unpolled = 4 * self.max_pending
        self._in_flight = 0
        self._next_id = 0
        # Cumulative dispatch CPU seconds charged to this runtime — one
        # charge per microbatch (queries and mutations), measured on the
        # dispatching thread's CPU clock, unlike the execute stage
        # histogram which charges wall batch duration to every member
        # request (see types.cpu_clock). On a card, a synchronising copy
        # may spin the thread, so this can read close to wall time.
        self.busy_seconds = 0.0
        # Hybrid execution (opt-in; DESIGN.md §9): a router stamps each
        # request's strategy at admission and the pump dispatches posting /
        # overlay microbatches outside the closure cache. router=None
        # serves every request through the graph walk.
        self.router = router
        if router is not None and router.controller is None:
            router.controller = self.controller
        self.overlays = OverlayCache(max_overlays=max_overlays)
        # Observability (DESIGN.md §12): every admitted request carries a
        # clock-injected span recorder (tracing=False serves without the
        # per-request dict churn), structured events go to the optional
        # JSON logger (req_id/batch_id/epoch correlated), and microbatches
        # get monotonic dispatch ids for log<->Response correlation.
        self.tracing = bool(tracing)
        self.logger = logger
        if logger is not None and logger.clock is None:
            logger.clock = self.clock
        self._next_batch_id = 0

    def _log(self, event: str, **fields) -> None:
        if self.logger is not None:
            self.logger.log(event, **fields)

    # --- closure-cache plumbing -------------------------------------------
    def _build_for_key(self, key):
        bucket, family, tier = key
        return self.executor.build(bucket, family, self._tier_params[tier])

    def warmup(self) -> int:
        """Build every (bucket, family, tier) closure and run it once with
        dummy data on the executor's device (which also builds the CUDA
        kernels there, so no request pays a build), then zero the hit/miss
        counters — so steady-state serving reports pure-hit cache
        behaviour. Returns the number of closures built."""
        dim = self.executor.dim
        dev = self.executor.device
        n_words = (self.n_labels + WORD_BITS - 1) // WORD_BITS
        # A fault-injecting executor is disarmed for the dummy dispatches:
        # warmup must neither fault nor consume the seeded schedule's draws.
        was_armed = getattr(self.executor, "armed", None)
        if was_armed is not None:
            self.executor.armed = False
        for family in self.families:
            for tier in range(len(self.controller.tiers)):
                for bucket in self.ladder:
                    fn = self.cache.get((bucket, family, tier))
                    queries = torch.zeros((bucket, dim), dtype=torch.float32, device=dev)
                    if family == "label":
                        # every label allowed: the uint32 word 0xFFFFFFFF
                        # is int32 -1
                        cons = LabelSetConstraint(
                            words=torch.full((bucket, n_words), -1, dtype=torch.int32,
                                             device=dev)
                        )
                    else:
                        cons = RangeConstraint(
                            lo=torch.full((bucket,), -1e30, dtype=torch.float32, device=dev),
                            hi=torch.full((bucket,), 1e30, dtype=torch.float32, device=dev),
                            col=0,
                        )
                    read_back(fn(queries, cons))
        if was_armed is not None:
            self.executor.armed = was_armed
        compiled = self.cache.trace_count
        self.cache.reset_counters()
        return compiled

    # --- request front ----------------------------------------------------
    @property
    def in_flight(self) -> int:
        return self._in_flight

    def submit(
        self,
        query: np.ndarray,
        k: int,
        family: str,
        operand,
        deadline: Optional[float] = None,
    ) -> int:
        """Admit one constrained query; returns its request id.

        Raises ``AdmissionError`` when ``max_pending`` requests are already
        in flight — the bounded admission queue is the backpressure surface
        (callers shed or retry; the runtime never buffers unboundedly).
        """
        if family not in self.families:
            raise ValueError(f"family {family!r} not served (have {self.families})")
        if k > self.controller.k_cap:
            raise ValueError(f"k={k} exceeds the ladder's k cap {self.controller.k_cap}")
        ladder = self.controller.ladder
        degraded = ladder is not None and ladder.level > 0
        req = Request(
            req_id=self._next_id,
            query=np.asarray(query, dtype=np.float32),
            k=int(k),
            family=family,
            operand=operand,
            deadline=deadline,
            arrival_t=self.clock(),
            # tier_for consults the degradation ladder: base tier under
            # overload, the family default otherwise.
            tier=self.controller.tier_for(family),
            degraded=degraded,
        )
        if self.router is not None:
            prefer_cheap = ladder is not None and ladder.prefer_cheap
            decision = self.router.route(
                family, operand, prefer_cheap=prefer_cheap
            )
            req.strategy = decision.strategy
            req.est_selectivity = decision.est_selectivity
            req.sel_bucket = decision.bucket
            req.sel_source = decision.source
            req.overlay_label = decision.label
            self.telemetry.on_route(decision.strategy)
        return self._admit(req)

    def _admit(self, req: Request) -> int:
        if self._in_flight >= self.max_pending:
            self.telemetry.on_reject()
            raise AdmissionError(
                f"{self._in_flight} requests in flight >= max_pending="
                f"{self.max_pending}"
            )
        self._next_id += 1
        self._in_flight += 1
        self.telemetry.on_submit()
        if self.tracing:
            req.trace = RequestTrace(
                req.req_id, req.arrival_t, replica=self.replica_id
            )
            req.trace.mark(f"route:{req.strategy}", req.arrival_t)
        self._log(
            "admit",
            req_id=req.req_id,
            family=req.family,
            strategy=req.strategy,
            tier=req.tier,
            k=req.k,
        )
        self.batcher.add(req, req.arrival_t)
        return req.req_id

    def submit_upsert(
        self, vector: np.ndarray, label: int = 0, attrs=None
    ) -> int:
        """Admit one insert for the streaming index; returns its request id.

        The response's ``ids[0]`` is the assigned slot id. Requires a
        streaming executor (one exposing ``apply_mutations``). Predictable
        failures are rejected HERE (bad shape) or reported as a failed
        response (pool exhaustion) — they must never escape mid-flush and
        corrupt the runtime's in-flight accounting.
        """
        self._require_streaming()
        vec = np.asarray(vector, dtype=np.float32)
        if vec.size != self.executor.dim:
            raise ValueError(
                f"upsert vector has {vec.size} elements, index dim is "
                f"{self.executor.dim}"
            )
        return self._admit(
            UpsertRequest(
                req_id=self._next_id,
                query=vec.reshape(self.executor.dim),
                k=1,
                family="upsert",
                operand=(int(label), attrs),
                arrival_t=self.clock(),
            )
        )

    def submit_delete(self, slot: int) -> int:
        """Admit one tombstone delete; the response's ``filled`` is 1 iff
        the slot was live (idempotent otherwise)."""
        self._require_streaming()
        slot = int(slot)
        if not 0 <= slot < self.executor.index.capacity:
            raise ValueError(
                f"slot {slot} outside the pool [0, "
                f"{self.executor.index.capacity})"
            )
        return self._admit(
            DeleteRequest(
                req_id=self._next_id,
                query=np.zeros((0,), np.float32),
                k=1,
                family="delete",
                operand=slot,
                arrival_t=self.clock(),
            )
        )

    def _require_streaming(self) -> None:
        if not hasattr(self.executor, "apply_mutations"):
            raise TypeError(
                "mutations need a streaming executor "
                "(StreamingLocalExecutor over a StreamingIndex); "
                f"have {type(self.executor).__name__}"
            )

    def poll(self, req_id: int) -> Optional[Response]:
        """Completed response for ``req_id`` (popped), or None if pending."""
        return self._responses.pop(req_id, None)

    # --- the pump ---------------------------------------------------------
    def step(self, force: bool = False) -> int:
        """Flush and execute every microbatch due now; returns completions.

        Flush-boundary epoch semantics (streaming executors): the flush's
        mutation microbatches are applied FIRST, then the executor swaps in
        the new index epoch exactly once, then every query microbatch of
        the flush runs against that one snapshot. Queries already
        executing hold the snapshot they were dispatched with; nothing
        observes a half-applied flush.

        Fault-tolerance order of operations (DESIGN.md §10): the load
        sample feeds the degradation ladder BEFORE this flush executes
        (the level must reflect the queue the flush is about to face),
        query microbatches run earliest-deadline-first, and each batch is
        stripped of already-expired (and, at ladder level 3, provably
        unmeetable) requests before any compute is spent on it.
        """
        self.controller.observe_load(self.batcher.pending_count())
        done = 0
        t_flush = self.clock()
        batches = self.batcher.flush(t_flush, force=force)
        for mb in batches:
            mb.batch_id = self._next_batch_id
            self._next_batch_id += 1
            for r in mb.requests:
                if r.trace is not None:
                    # Span accounting at the flush boundary: everything
                    # since (re-)enqueue was batcher queue wait.
                    r.trace.on_flush(r.enqueue_t, t_flush)
        mutations = [mb for mb in batches if mb.family in MUTATION_FAMILIES]
        queries = [mb for mb in batches if mb.family not in MUTATION_FAMILIES]
        applied: list = []
        for mb in mutations:
            applied.extend(self._execute_mutation(mb))
        if mutations:
            epoch = self.executor.refresh()  # the atomic epoch swap
            self.telemetry.on_epoch_swap()
            self._log("epoch_swap", epoch=epoch)
            self._drain_executor_faults()  # a stale-epoch injection counts
            if self.router is not None:
                # Overlay hotness re-accumulates per epoch; the overlay
                # cache itself invalidates on epoch mismatch at get().
                self.router.on_epoch(epoch)
            for resp in applied:
                # The first epoch this mutation is visible in — queries
                # with Response.epoch >= this one see its effect.
                resp.epoch = epoch
        done += len(applied)
        # Earliest-deadline-first across the flush's query batches: when
        # the flush holds more work than the deadline budget, the batches
        # that can still win execute before the ones that already lost.
        queries.sort(key=self._batch_deadline)
        for mb in queries:
            done += self._shed_due(mb)
            if mb.requests:
                done += self._execute(mb)
        return done

    @staticmethod
    def _batch_deadline(mb: MicroBatch) -> float:
        return min(
            (r.deadline for r in mb.requests if r.deadline is not None),
            default=float("inf"),
        )

    def _shed_due(self, mb: MicroBatch) -> int:
        """Drop this batch's hopeless requests before dispatch: expired
        ones always (``shed_expired``), predicted-unmeetable ones at
        ladder level 3. Returns the number shed; ``mb.requests`` keeps
        only the live ones (the bucket stays — padding just grows)."""
        if not self.shed_expired:
            return 0
        now = self.clock()
        ladder = self.controller.ladder
        predict = ladder is not None and ladder.shed_predicted
        live: List[Request] = []
        shed = 0
        for req in mb.requests:
            if deadline_missed(req.deadline, now):
                self._shed(req, "expired", now, batch_id=mb.batch_id)
                shed += 1
            elif predict and ladder.predicted_miss(req.deadline, now):
                self._shed(req, "overload", now, batch_id=mb.batch_id)
                shed += 1
            else:
                live.append(req)
        mb.requests = live
        return shed

    def _shed(
        self, req: Request, reason: str, now: float, batch_id: int = -1
    ) -> None:
        """Terminal shed: a pollable empty Response with ``shed_reason``
        set — the request is accounted, never silently dropped, and never
        burns a search."""
        self._bound_unpolled()
        resp = Response(
            req_id=req.req_id,
            ids=np.full((req.k,), -1, np.int32),
            dists=np.full((req.k,), np.inf, np.float32),
            k=req.k,
            filled=0,
            tier=req.tier,
            escalations=req.escalations,
            fill_history=req.fill_history + (0,),
            arrival_t=req.arrival_t,
            complete_t=now,
            deadline_missed=deadline_missed(req.deadline, now),
            epoch=getattr(self.executor, "epoch", None),
            strategy=req.strategy,
            est_selectivity=req.est_selectivity,
            shed_reason=reason,
            degraded=req.degraded,
            trace=(
                req.trace.breakdown(now, outcome="shed")
                if req.trace is not None
                else None
            ),
            batch_id=batch_id,
        )
        self._responses[req.req_id] = resp
        self._in_flight -= 1
        self.telemetry.on_shed(resp)
        self._log(
            "shed", req_id=req.req_id, reason=reason, batch_id=batch_id
        )

    def _drain_executor_faults(self) -> List[str]:
        """Collect fault kinds the (possibly fault-injecting) executor
        observed since the last drain; counts them into telemetry."""
        pop = getattr(self.executor, "pop_faults", None)
        kinds = pop() if pop is not None else []
        for kind in kinds:
            self.telemetry.on_fault(kind)
        return kinds

    def _bound_unpolled(self) -> None:
        while len(self._responses) >= self._max_unpolled:
            self._responses.pop(next(iter(self._responses)))
            self.telemetry.counters["responses_evicted"] += 1

    def drain(self) -> int:
        """Run until nothing is in flight (escalations included)."""
        done = 0
        while self._in_flight:
            done += self.step(force=True)
        return done

    def _execute_mutation(self, mb: MicroBatch) -> list:
        """Apply one upsert/delete microbatch; returns the created
        responses (``step`` stamps their visibility epoch after the flush's
        swap).

        Mutations never touch the closure cache (no padded lanes are
        materialized — ``bucket`` is irrelevant to a host loop); their
        measured wall time still advances a virtual-time replay so churn
        costs land in the same timeline as query execution.
        """
        t_start = self.clock()
        t0 = wall_clock()
        c0 = cpu_clock()
        results = self.executor.apply_mutations(mb.requests)
        dt = wall_clock() - t0
        self.busy_seconds += cpu_clock() - c0
        if hasattr(self.clock, "advance"):
            self.clock.advance(dt)
        now = self.clock()
        self.telemetry.on_mutation(mb.family, len(mb.requests))
        self._log(
            "dispatch",
            batch_id=mb.batch_id,
            family=mb.family,
            n_real=mb.n_real,
        )
        responses = []
        for req, (ok, slot) in zip(mb.requests, results):
            self._bound_unpolled()
            if req.trace is not None:
                req.trace.on_exec(t_start, now)
            resp = Response(
                req_id=req.req_id,
                ids=np.asarray([slot], np.int32),
                dists=np.zeros((1,), np.float32),
                k=1,
                filled=int(ok),
                tier=req.tier,
                escalations=0,
                fill_history=(int(ok),),
                arrival_t=req.arrival_t,
                complete_t=now,
                deadline_missed=deadline_missed(req.deadline, now),
                trace=(
                    req.trace.breakdown(now) if req.trace is not None else None
                ),
                batch_id=mb.batch_id,
            )
            self._responses[req.req_id] = resp
            responses.append(resp)
            self._in_flight -= 1
        return responses

    # --- hybrid strategy executors (DESIGN.md §9) -------------------------
    def _current_corpus(self) -> Corpus:
        if hasattr(self.executor, "apply_mutations"):
            return self.executor.snapshot.corpus
        return self.executor.corpus

    def _pool_vectors(self) -> torch.Tensor:
        """The rows an overlay is built from, on the executor's device:
        the streaming pool's live rows, else the static corpus."""
        if hasattr(self.executor, "apply_mutations"):
            return self.executor.index.pool.vectors
        return self.executor.corpus.vectors

    def _run_posting(self, mb: MicroBatch, queries, constraint):
        """Brute-force scan over the batch's shared posting set. The scan
        is exact over that set (the constraint closure re-verifies every
        id), so its results never escalate — an under-fill means fewer
        than k satisfying rows exist."""
        req = mb.requests[0]
        if req.family == "label":
            ids = self.router.postings.ids_for_words(
                np.asarray(req.operand, np.uint32)
            )
        else:
            lo, hi, col = req.operand
            ids = self.router.range_index.ids_for_range(
                float(lo), float(hi), int(col)
            )
        padded = pad_posting(ids, posting_bucket(int(ids.shape[0])))
        params = self._tier_params[mb.tier]
        pq = (
            getattr(self.executor, "pq_index", None)
            if params.approx == "pq"
            else None
        )
        return posting_search(
            self._current_corpus(), queries, constraint,
            torch.from_numpy(padded).to(queries.device), params, pq,
        )

    def _run_overlay(self, mb: MicroBatch, queries):
        """Traversal over the hot label's cached sub-index; None when no
        overlay can be built (caller falls back to the graph plan)."""
        label = int(mb.group[-1])
        epoch = getattr(self.executor, "epoch", 0)
        overlay = self.overlays.get(label, epoch, self._overlay_build_fn)
        if overlay is None:
            return None
        # The acceptance invariant: churn must never serve a stale overlay.
        assert overlay.epoch == epoch, (
            f"overlay epoch {overlay.epoch} != index epoch {epoch}"
        )
        return overlay_search(
            overlay, queries, self._tier_params[mb.tier]
        )

    def _overlay_build_fn(self, label: int, epoch: int):
        ids = self.router.postings.ids_for_label(label)
        if ids.shape[0] < 2:  # a sub-graph needs at least one edge
            return None
        # The sample generator is seeded from the reference's key integer,
        # so an overlay is a function of (label, epoch). Its draw is
        # torch's, not JAX's: the sample (and so the overlay walk's start
        # points) differs from the reference's.
        dev = self.executor.device
        gen = torch.Generator(device=dev).manual_seed(
            (int(label) * 1_000_003 + int(epoch)) & 0x7FFFFFFF)
        return build_overlay(label, ids, self._pool_vectors(), epoch, generator=gen,
                             device=dev)

    def _execute(self, mb: MicroBatch) -> int:
        # The whole request-processing path is the service time: operand
        # assembly + host->device transfer + search + result readback. A
        # virtual-time replay charges all of it to the timeline — this is
        # exactly the per-request overhead the batch=1 baseline cannot
        # amortize.
        t_start = self.clock()
        t0 = wall_clock()
        c0 = cpu_clock()
        try:
            dev = self.executor.device
            queries = assemble_queries(mb, self.executor.dim, dev)
            constraint = assemble_constraint(mb, dev)
            strategy = mb.strategy
            res = None
            if strategy == "posting":
                res = self._run_posting(mb, queries, constraint)
            elif strategy == "overlay":
                res = self._run_overlay(mb, queries)
            if res is None:
                # graph strategy, or a routed strategy that turned out
                # inapplicable at dispatch time (e.g. the label's posting
                # set shrank below the overlay minimum under churn): the
                # full traversal is the universal fallback.
                strategy = "graph"
                fn = self.cache.get((mb.bucket, mb.family, mb.tier))
                res = fn(queries, constraint)
            # one synchronising copy: the search has finished on the device
            ids, dists, filled_all, iters = read_back(res)
        except ExecutorFault as fault:
            # The recovery contract: a faulted dispatch costs its wall
            # time, its requests are retried through the batcher within
            # their budget, and budget-exhausted ones surface as FAILED
            # responses — a fault never hangs or loses a request.
            dt = wall_clock() - t0
            self.busy_seconds += cpu_clock() - c0
            if hasattr(self.clock, "advance"):
                self.clock.advance(dt)
            return self._recover_faulted(mb, fault, t_start)
        dt = wall_clock() - t0
        self.busy_seconds += cpu_clock() - c0
        if hasattr(self.clock, "advance"):
            # Virtual-time replay: execution cost advances the timeline.
            self.clock.advance(dt)
        now = self.clock()
        # Execution-only duration (injected spikes excluded — they advance
        # the virtual clock, not the measured wall interval): the ladder's
        # predictive-shedding estimate of what one more dispatch costs.
        self.controller.observe_service(dt)
        # An injected latency spike completed the batch but late: mark its
        # responses faulted (+degraded) so a spike-caused deadline miss is
        # accountable, never a silent late completion.
        spiked = "spike" in self._drain_executor_faults()
        self.telemetry.on_dispatch(mb.bucket, mb.n_real)
        self._log(
            "dispatch",
            batch_id=mb.batch_id,
            family=mb.family,
            strategy=strategy,
            tier=mb.tier,
            bucket=mb.bucket,
            n_real=mb.n_real,
            epoch=getattr(self.executor, "epoch", None),
            exec_s=round(dt, 9),
        )

        mean_iters = float(iters)
        # ids rows are -1-padded at the tail (ascending dists), so the fill
        # within a request's k-prefix is min(total filled, k).
        filled_rows = np.minimum(filled_all,
                                 [r.k for r in mb.requests] + [0] * mb.n_padded)
        fill_fracs = []
        done = 0
        for i, req in enumerate(mb.requests):
            row_ids = ids[i, : req.k]
            filled = int(filled_rows[i])
            req.fill_history = req.fill_history + (filled,)
            fill_fracs.append(filled / max(req.k, 1))
            if req.trace is not None:
                req.trace.on_exec(t_start, now)
            # Posting-scan results are exact over the posting set: an
            # under-fill means fewer than k rows satisfy at all, and no
            # bigger-ef tier can conjure more — never escalate those.
            if filled < req.k and strategy != "posting":
                next_tier = self.controller.escalate(req)
                if next_tier is not None:
                    # Under-fill escalation: re-run at a bigger-ef tier
                    # instead of returning padded slots (the online
                    # analogue of the paper's "hope s is large enough").
                    req.tier = next_tier
                    req.escalations += 1
                    self.telemetry.on_escalate()
                    if req.trace is not None:
                        req.trace.mark(f"escalate:{next_tier}", now)
                    self._log(
                        "escalate",
                        req_id=req.req_id,
                        batch_id=mb.batch_id,
                        tier=next_tier,
                    )
                    self.batcher.add(req, now)
                    continue
                elif (
                    self.controller.ladder is not None
                    and self.controller.ladder.cap_escalations
                    and req.tier < self.controller.max_tier
                ):
                    # The ladder (not the ladder top) suppressed the
                    # retry: this partial answer is a degraded one.
                    req.degraded = True
            self._bound_unpolled()
            ladder = self.controller.ladder
            self._responses[req.req_id] = Response(
                req_id=req.req_id,
                ids=row_ids.copy(),
                dists=dists[i, : req.k].copy(),
                k=req.k,
                filled=filled,
                tier=req.tier,
                escalations=req.escalations,
                fill_history=req.fill_history,
                arrival_t=req.arrival_t,
                complete_t=now,
                deadline_missed=deadline_missed(req.deadline, now),
                epoch=getattr(self.executor, "epoch", None),
                strategy=strategy,
                est_selectivity=req.est_selectivity,
                # Degraded if the ladder shaped it at any point of its
                # life — admission, dispatch, or completion — a spike hit
                # its batch, or it crossed its deadline DURING execution
                # (it passed the flush-time shed check, then the dispatch
                # outlasted its budget: late = SLO-degraded): every late
                # completion carries a mark explaining it, never a silent
                # miss.
                degraded=(
                    req.degraded
                    or spiked
                    or (ladder is not None and ladder.level > 0)
                    or deadline_missed(req.deadline, now)
                ),
                faulted=spiked or req.fault_retries > 0,
                trace=(
                    req.trace.breakdown(now) if req.trace is not None else None
                ),
                batch_id=mb.batch_id,
            )
            self._in_flight -= 1
            self.telemetry.on_complete(self._responses[req.req_id])
            self.controller.observe_latency(now - req.arrival_t)
            self._log(
                "complete",
                req_id=req.req_id,
                batch_id=mb.batch_id,
                filled=filled,
                latency_s=round(now - req.arrival_t, 9),
            )
            done += 1
        if not fill_fracs:
            return done
        mean_fill = sum(fill_fracs) / len(fill_fracs)
        if strategy == "graph":
            # Tier retuning reads traversal fill/iteration EMAs — posting
            # scans (iters == 0 by construction) must not train them.
            self.controller.record(mb.family, mb.tier, mean_fill, mean_iters)
        if self.router is not None and mb.requests[0].sel_bucket >= 0:
            # Strategy retuning per (family, selectivity bucket): observed
            # per-request latency + fill for whatever executor actually ran.
            self.controller.record_strategy(
                (mb.family, mb.requests[0].sel_bucket),
                strategy,
                dt / max(mb.n_real, 1),
                mean_fill,
            )
        return done

    def _recover_faulted(
        self, mb: MicroBatch, fault: ExecutorFault, t_start: float
    ) -> int:
        """Fault recovery (DESIGN.md §10): every request of a faulted
        dispatch is either re-queued through the batcher (within its
        ``max_fault_retries`` budget) or completed as a FAILED pollable
        Response carrying the fault message — never hung in ``in_flight``,
        never silently lost. Returns the number completed-as-failed."""
        self._drain_executor_faults()  # count the injection behind this raise
        now = self.clock()
        done = 0
        for req in mb.requests:
            if req.trace is not None:
                # The faulted dispatch still burned execute time.
                req.trace.on_exec(t_start, now)
            if req.fault_retries < self.max_fault_retries:
                req.fault_retries += 1
                self.telemetry.on_fault_retry()
                if req.trace is not None:
                    req.trace.mark("fault_retry", now)
                self._log(
                    "fault_retry", req_id=req.req_id, batch_id=mb.batch_id
                )
                self.batcher.add(req, now)
                continue
            self._bound_unpolled()
            resp = Response(
                req_id=req.req_id,
                ids=np.full((req.k,), -1, np.int32),
                dists=np.full((req.k,), np.inf, np.float32),
                k=req.k,
                filled=0,
                tier=req.tier,
                escalations=req.escalations,
                fill_history=req.fill_history + (0,),
                arrival_t=req.arrival_t,
                complete_t=now,
                deadline_missed=deadline_missed(req.deadline, now),
                epoch=getattr(self.executor, "epoch", None),
                strategy=req.strategy,
                est_selectivity=req.est_selectivity,
                degraded=req.degraded,
                faulted=True,
                error=str(fault),
                trace=(
                    req.trace.breakdown(now, outcome="failed")
                    if req.trace is not None
                    else None
                ),
                batch_id=mb.batch_id,
            )
            self._responses[req.req_id] = resp
            self._in_flight -= 1
            self.telemetry.on_complete(resp)
            self._log(
                "failed",
                req_id=req.req_id,
                batch_id=mb.batch_id,
                error=str(fault),
            )
            done += 1
        return done

    # --- reporting --------------------------------------------------------
    def report(self) -> dict:
        out = {
            "telemetry": self.telemetry.summary(),
            "cache": self.cache.stats(),
            "trace_budget": self.trace_budget,
            "controller": self.controller.snapshot(),
            "pending": self.batcher.pending_count(),
        }
        if self.router is not None:
            out["overlays"] = self.overlays.stats()
        if hasattr(self.executor, "apply_mutations"):
            idx = self.executor.index
            out["index"] = {
                "epoch": self.executor.epoch,
                "capacity": idx.capacity,
                "n_live": idx.pool.n_live,
                "n_pending": idx.pool.n_pending,
                "n_free": idx.pool.n_free,
                "consolidations": idx.consolidations,
            }
        return out
