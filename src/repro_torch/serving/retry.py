"""Client-side retry policy: jittered exponential backoff on backpressure
(port of ``repro.serving.retry``, plain Python).

``AdmissionError`` is the runtime telling the caller "not now"; a client
that retries immediately just hammers the full queue, and one that never
retries converts transient overload into permanent sheds. The policy in
between: back off exponentially with jitter (decorrelates competing
clients), respect a per-request retry budget, and give up *early* when
the next attempt could not land before the request's deadline anyway —
deadline-aware give-up, so retry traffic never becomes a second source
of already-expired work.

Backoff waits go through the runtime's injected clock: a ``VirtualClock``
is advanced explicitly (deterministic replay), a wall clock is waited out
by pumping ``runtime.step()`` — which is what a real single-threaded
client would do anyway, and keeps this module free of direct wall-clock
calls (tests/test_no_wall_clock.py).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np

from repro_torch.serving.types import AdmissionError


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    max_retries: int = 3
    base_backoff: float = 0.002  # seconds before the first retry
    multiplier: float = 2.0  # exponential growth per attempt
    jitter: float = 0.5  # +/- fraction of the backoff, uniform

    def backoff_for(self, attempt: int, rng: np.random.RandomState) -> float:
        base = self.base_backoff * self.multiplier**attempt
        if self.jitter:
            base *= 1.0 + self.jitter * float(2.0 * rng.rand() - 1.0)
        return max(base, 0.0)


def submit_with_retry(
    runtime,
    submit_fn: Callable[[], int],
    policy: RetryPolicy,
    rng: np.random.RandomState,
    deadline: Optional[float] = None,
) -> Tuple[Optional[int], int]:
    """Run ``submit_fn`` (a zero-arg closure over ``runtime.submit``/
    ``submit_upsert``/``submit_delete``) under the retry policy.

    Returns ``(req_id, retries_used)`` — ``req_id`` None when the budget
    ran out or the deadline made another attempt pointless (the caller
    sheds client-side; its accounting stays exact either way). Retries are
    counted into ``runtime.telemetry.counters["retries"]``.
    """
    attempt = 0
    while True:
        try:
            return submit_fn(), attempt
        except AdmissionError:
            if attempt >= policy.max_retries:
                return None, attempt
            backoff = policy.backoff_for(attempt, rng)
            now = runtime.clock()
            if deadline is not None and now + backoff > deadline:
                # Even if the retry were admitted instantly it would
                # already be expired-at-flush — give up now.
                return None, attempt
            attempt += 1
            runtime.telemetry.counters["retries"] += 1
            if hasattr(runtime.clock, "advance"):
                runtime.clock.advance(backoff)
                runtime.step()
            else:
                # Wall clock: pump the runtime until the backoff elapses
                # (each step drains work, which is what frees capacity).
                t_until = now + backoff
                while runtime.clock() < t_until:
                    runtime.step()
