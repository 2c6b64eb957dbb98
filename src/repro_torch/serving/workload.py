"""Mixed-workload generation + Poisson replay for the serving runtime (port
of ``repro.serving.workload``).

Real filtered-search traffic mixes constraint selectivities wildly (SIEVE's
workload study); this module synthesizes that: one stream interleaving
equal-label, unequal-X%, and numeric-range constraints with mixed per-query
``k`` and Poisson arrivals. Shared by the serve driver
(launch/serve.py) and ``chip_smoke.py``'s serving phase, so both measure
the same stream shape. The draws are numpy's, as the reference's: the same
seed over the same corpus rows gives the same stream on both sides.

The generators read the corpus on the host: one copy of its rows, labels
and attributes per workload (512 MB at 1M x 128 float32), never a device
read per request.

Replay runs in virtual time (``VirtualClock``): arrival gaps advance the
clock explicitly and the runtime adds each microbatch's measured execution
wall time, so latency percentiles are consistent arrival-to-completion
quantities even though the host replays the stream as fast as it can.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.constraints import WORD_BITS
from repro_torch.core.types import Corpus
from repro_torch.serving.retry import RetryPolicy, submit_with_retry
from repro_torch.serving.runtime import ServingRuntime
from repro_torch.serving.types import AdmissionError, Response, VirtualClock


def _host_columns(corpus: Corpus):
    """One host copy of a corpus's rows, labels and attributes (tensors on
    any device) as numpy arrays."""
    def host(a):
        return None if a is None else a.detach().cpu().numpy()

    return host(corpus.vectors), host(corpus.labels), host(corpus.attrs)


@dataclasses.dataclass
class WorkItem:
    query: np.ndarray  # (d,) float32
    k: int
    family: str
    operand: object
    kind: str  # workload slice tag ("equal" | "unequal" | "range")


def label_words_row(labels: Sequence[int], n_labels: int) -> np.ndarray:
    """(Lw,) uint32 allowed-label bitmask row for one request."""
    row = np.zeros(((n_labels + WORD_BITS - 1) // WORD_BITS,), np.uint32)
    for lab in labels:
        row[lab // WORD_BITS] |= np.uint32(1) << np.uint32(lab % WORD_BITS)
    return row


def mixed_workload(
    seed: int,
    corpus: Corpus,
    n_requests: int,
    n_labels: int,
    *,
    k_choices: Tuple[int, ...] = (4, 8, 16),
    mix: Tuple[float, float, float] = (0.4, 0.4, 0.2),  # equal/unequal/range
    unequal_pct: float = 20.0,
    range_col: int = 0,
    range_width: Tuple[float, float] = (0.05, 0.3),
    jitter: float = 0.05,
) -> List[WorkItem]:
    """One heterogeneous stream: queries drawn near corpus points (the
    paper's protocol), each with its own k and constraint.

    Range windows are centered on the query point's own attribute value
    with width >= ``range_width[0]`` so every request is satisfiable by
    >= k corpus items in expectation (attrs ~ U[0, 1]).
    """
    return _mixed(seed, *_host_columns(corpus), n_requests, n_labels, k_choices=k_choices,
                  mix=mix, unequal_pct=unequal_pct, range_col=range_col,
                  range_width=range_width, jitter=jitter)


def _mixed(seed, vectors, labels, attrs, n_requests, n_labels, *, k_choices, mix,
           unequal_pct, range_col, range_width, jitter) -> List[WorkItem]:
    """``mixed_workload`` over host arrays."""
    rng = np.random.RandomState(seed)
    n, d = vectors.shape
    if mix[2] > 0 and attrs is None:
        raise ValueError("range slice requested but corpus has no attrs")

    items: List[WorkItem] = []
    kinds = rng.choice(3, size=n_requests, p=np.asarray(mix) / np.sum(mix))
    picks = rng.randint(0, n, size=n_requests)
    for kind_id, pick in zip(kinds, picks):
        q = vectors[pick] + rng.randn(d).astype(np.float32) * jitter
        k = int(rng.choice(k_choices))
        qlab = int(labels[pick])
        if kind_id == 0:
            items.append(WorkItem(q, k, "label", label_words_row([qlab], n_labels), "equal"))
        elif kind_id == 1:
            n_allowed = max(1, int(round(n_labels * unequal_pct / 100.0)))
            others = [lab for lab in range(n_labels) if lab != qlab]
            allowed = rng.choice(others, size=min(n_allowed, len(others)), replace=False)
            items.append(
                WorkItem(q, k, "label", label_words_row(list(allowed), n_labels), "unequal")
            )
        else:
            center = float(attrs[pick, range_col])
            width = float(rng.uniform(*range_width))
            lo, hi = center - width / 2, center + width / 2
            items.append(WorkItem(q, k, "range", (lo, hi, range_col), "range"))
    return items


def churn_workload(
    seed: int,
    corpus: Corpus,
    n_requests: int,
    n_labels: int,
    *,
    mutation_frac: float = 0.3,
    delete_frac: float = 0.5,
    k_choices: Tuple[int, ...] = (4, 8, 16),
    mix: Tuple[float, float, float] = (0.4, 0.4, 0.2),
    unequal_pct: float = 20.0,
    range_col: int = 0,
    range_width: Tuple[float, float] = (0.05, 0.3),
    jitter: float = 0.05,
) -> List[WorkItem]:
    """One Poisson-replayable stream mixing QUERIES with index mutations.

    ``mutation_frac`` of the stream is upsert/delete traffic (split by
    ``delete_frac``); the rest is the usual constrained-query mix. Upsert
    items carry the new vector + ``(label, attrs_row)`` operand; delete
    items carry no target — ``replay_churn`` picks a live id at submit time
    (the generator cannot know slot assignments that only exist once the
    runtime has processed earlier upserts).
    """
    rng = np.random.RandomState(seed)
    vectors, labels, attrs = _host_columns(corpus)
    queries = _mixed(
        seed + 1, vectors, labels, attrs, n_requests, n_labels,
        k_choices=k_choices, mix=mix, unequal_pct=unequal_pct,
        range_col=range_col, range_width=range_width, jitter=jitter,
    )
    n, d = vectors.shape

    items: List[WorkItem] = []
    for q in queries:
        if rng.rand() >= mutation_frac:
            items.append(q)
            continue
        if rng.rand() < delete_frac:
            items.append(
                WorkItem(np.zeros((0,), np.float32), 1, "delete", None, "delete")
            )
        else:
            pick = rng.randint(0, n)
            vec = vectors[pick] + rng.randn(d).astype(np.float32) * jitter
            arow = None if attrs is None else attrs[pick].copy()
            items.append(
                WorkItem(vec, 1, "upsert", (int(labels[pick]), arow), "upsert")
            )
    return items


def _is_virtual(clock) -> bool:
    """A ``VirtualClock`` or any wrapper exposing its advance surface
    (``FaultClock`` wraps one to own injected spike time)."""
    return isinstance(clock, VirtualClock) or (
        hasattr(clock, "advance") and hasattr(clock, "advance_to")
    )


def poisson_arrivals(
    rng: np.random.RandomState,
    n: int,
    rate: float,
    burst: Optional[Tuple[float, float, float]] = None,
) -> np.ndarray:
    """Cumulative Poisson arrival times for ``n`` items at ``rate`` qps.

    ``burst=(start_frac, end_frac, mult)`` multiplies the arrival rate by
    ``mult`` for the items whose *index* falls in that fraction of the
    stream — the overload window the SLO harness injects (a 5x burst in
    the middle third: ``(1/3, 2/3, 5.0)``).
    """
    gaps = rng.exponential(1.0 / rate, size=n)
    if burst is not None:
        lo_f, hi_f, mult = burst
        i0, i1 = int(lo_f * n), int(hi_f * n)
        gaps[i0:i1] /= float(mult)
    return np.cumsum(gaps)


def replay_churn(
    runtime: ServingRuntime,
    items: Sequence[WorkItem],
    rate: float,
    seed: int = 0,
    initial_live: Optional[Sequence[int]] = None,
    *,
    deadline_s: Optional[float] = None,
    retry: Optional[RetryPolicy] = None,
    burst: Optional[Tuple[float, float, float]] = None,
) -> Tuple[List[Optional[Response]], int]:
    """Drive a churn stream (queries + upserts/deletes) with Poisson arrivals.

    Like ``replay_poisson`` but routes mutation items through
    ``submit_upsert``/``submit_delete`` and tracks the live-id set as
    upsert responses surface slot assignments, so deletes always target an
    id that was live at submit time. Returns (responses aligned with items
    — None for rejected or skipped [no live id to delete] items, rejection
    count).

    ``deadline_s`` stamps each QUERY with an absolute deadline that many
    seconds after its submission instant (mutations stay deadline-free:
    an upsert shed for lateness would silently lose data). ``retry`` runs
    every submission under the client retry policy (retry.py); ``burst``
    is forwarded to ``poisson_arrivals``.
    """
    clock = runtime.clock
    if not _is_virtual(clock):
        raise TypeError("replay_churn needs a runtime built on a VirtualClock")
    rng = np.random.RandomState(seed)
    live: List[int] = list(
        initial_live
        if initial_live is not None
        else range(runtime.executor.index.pool.n_live)
    )
    arrivals = poisson_arrivals(rng, len(items), rate, burst)
    req_ids: List[Optional[int]] = []
    open_upserts: dict = {}

    def harvest_upserts() -> None:
        # Learn slot assignments as upsert responses complete, so later
        # deletes can target freshly inserted items too.
        for rid in list(open_upserts):
            resp = runtime.poll(rid)
            if resp is not None:
                open_upserts.pop(rid)
                _responses[rid] = resp
                if resp.filled:
                    live.append(int(resp.ids[0]))

    _responses: dict = {}
    rejected = 0
    for item, t_arr in zip(items, arrivals):
        clock.advance_to(t_arr)
        runtime.step()
        harvest_upserts()
        target: Optional[int] = None
        if item.family == "upsert":
            submit = lambda it=item: runtime.submit_upsert(it.query, *it.operand)
            deadline = None
        elif item.family == "delete":
            if not live:
                req_ids.append(None)
                continue
            target = live.pop(rng.randint(len(live)))
            submit = lambda t=target: runtime.submit_delete(t)
            deadline = None
        else:
            deadline = (
                None if deadline_s is None else runtime.clock() + deadline_s
            )
            submit = lambda it=item, dl=deadline: runtime.submit(
                it.query, it.k, it.family, it.operand, deadline=dl
            )
        try:
            if retry is not None:
                rid, _ = submit_with_retry(
                    runtime, submit, retry, rng, deadline=deadline
                )
                if rid is None:
                    raise AdmissionError("retry budget exhausted")
            else:
                rid = submit()
            if item.family == "upsert":
                open_upserts[rid] = True
            req_ids.append(rid)
        except AdmissionError:
            if target is not None:
                live.append(target)  # the delete was shed, the id stays live
            req_ids.append(None)
            rejected += 1
        runtime.step()
        harvest_upserts()
    while runtime.in_flight:
        clock.advance(runtime.batcher.max_wait)
        runtime.step()
        harvest_upserts()
    out: List[Optional[Response]] = []
    for rid in req_ids:
        if rid is None:
            out.append(None)
        elif rid in _responses:
            out.append(_responses[rid])
        else:
            out.append(runtime.poll(rid))
    return out, rejected


def replay_poisson(
    runtime: ServingRuntime,
    items: Sequence[WorkItem],
    rate: float,
    seed: int = 0,
    *,
    deadline_s: Optional[float] = None,
    retry: Optional[RetryPolicy] = None,
    burst: Optional[Tuple[float, float, float]] = None,
) -> Tuple[List[Optional[Response]], int]:
    """Drive ``items`` through the runtime with Poisson(rate) arrivals.

    Requires the runtime's clock to be a ``VirtualClock``. Returns
    (responses aligned with items — None for rejected requests, rejection
    count).

    ``deadline_s`` stamps each request with an absolute deadline that many
    seconds after its submission instant; ``retry`` runs submissions under
    the client retry policy (retry.py — backpressure becomes jittered
    backoff instead of an instant client-side shed); ``burst`` injects an
    overload window (``poisson_arrivals``).
    """
    clock = runtime.clock
    if not _is_virtual(clock):
        raise TypeError("replay_poisson needs a runtime built on a VirtualClock")
    rng = np.random.RandomState(seed)
    arrivals = poisson_arrivals(rng, len(items), rate, burst)
    req_ids: List[Optional[int]] = []
    rejected = 0
    for item, t_arr in zip(items, arrivals):
        clock.advance_to(t_arr)
        runtime.step()  # flush anything that came due while idle
        deadline = None if deadline_s is None else runtime.clock() + deadline_s
        submit = lambda it=item, dl=deadline: runtime.submit(
            it.query, it.k, it.family, it.operand, deadline=dl
        )
        try:
            if retry is not None:
                rid, _ = submit_with_retry(
                    runtime, submit, retry, rng, deadline=deadline
                )
                if rid is None:
                    rejected += 1
                req_ids.append(rid)
            else:
                req_ids.append(submit())
        except AdmissionError:
            req_ids.append(None)
            rejected += 1
        runtime.step()  # full buckets ship immediately
    while runtime.in_flight:
        clock.advance(runtime.batcher.max_wait)
        runtime.step()
    return [None if rid is None else runtime.poll(rid) for rid in req_ids], rejected
