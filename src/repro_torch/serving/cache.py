"""Shape-bucketed closure cache with a hard trace budget (port of
``repro.serving.cache``, plain Python).

The reference jit-traces one search closure per (bucket batch size,
constraint family, params tier). The port runs eagerly, so a "trace" here
is one executor ``build()``: the closure that binds a key's
``SearchParams`` to the executor's index. The registry memoizes those
closures, counts hits/misses, and *refuses* to grow past the budget the
bucket ladder implies: an arbitrary request stream can create at most
|ladder| x |families| x |tiers| closures, and exceeding that is a bug in
the batcher/controller (e.g. a tier escaping the declared ladder), not a
workload property — so it raises instead of silently building.
"""
from __future__ import annotations

from typing import Callable, Dict, Hashable


class TraceBudgetError(AssertionError):
    """A bucket key outside the declared ladder reached the compile cache."""


class CompileCache:
    def __init__(self, build_fn: Callable[[Hashable], Callable], max_entries: int):
        self._build = build_fn
        self._fns: Dict[Hashable, Callable] = {}
        self.max_entries = int(max_entries)
        self.hits = 0
        self.misses = 0

    @property
    def trace_count(self) -> int:
        return len(self._fns)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def get(self, key: Hashable) -> Callable:
        fn = self._fns.get(key)
        if fn is not None:
            self.hits += 1
            return fn
        if len(self._fns) >= self.max_entries:
            raise TraceBudgetError(
                f"bucket key {key!r} would be built closure "
                f"#{len(self._fns) + 1}, over the declared budget of "
                f"{self.max_entries} (= |ladder| x |families| x |tiers|); "
                f"known keys: {sorted(map(repr, self._fns))}"
            )
        self.misses += 1
        fn = self._build(key)
        self._fns[key] = fn
        return fn

    def reset_counters(self) -> None:
        """Zero hit/miss counters (built closures stay warm) — used to
        report steady-state hit rates after an explicit warmup pass."""
        self.hits = 0
        self.misses = 0

    def stats(self) -> dict:
        return {
            "trace_count": self.trace_count,
            "max_entries": self.max_entries,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hit_rate, 4),
        }
