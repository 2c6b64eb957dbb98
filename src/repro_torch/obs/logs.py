"""Structured JSON logging behind a bounded ring-buffer sink (port of
``repro.obs.logs``, plain Python).

Every record is one flat dict — ``ts`` (from the *injected* clock),
``event``, and whatever correlation fields the call site attaches
(``req_id`` / ``batch_id`` / ``epoch`` are the ones the serving runtime
stamps) — so a p99 outlier's whole life is greppable by request id across
admission, flush, dispatch, and completion records.

The ring buffer keeps the server's memory flat no matter how chatty the
stream is (oldest records evicted and counted); ``flush()`` writes the
buffered records as JSON lines, and an optional live ``stream`` tees every
record out as it happens (``launch/serve.py --log-json``).
"""
from __future__ import annotations

import json
from collections import deque
from typing import Callable, Deque, List, Optional, TextIO


class RingBufferSink:
    """Bounded in-memory record buffer: O(1) emit, oldest-out eviction."""

    def __init__(self, capacity: int = 4096):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive: {capacity}")
        self.capacity = int(capacity)
        self._records: Deque[dict] = deque(maxlen=self.capacity)
        self.emitted = 0  # lifetime count, evictions included

    def emit(self, record: dict) -> None:
        self._records.append(record)
        self.emitted += 1

    def __len__(self) -> int:
        return len(self._records)

    @property
    def dropped(self) -> int:
        return self.emitted - len(self._records)

    def records(self) -> List[dict]:
        return list(self._records)

    def clear(self) -> None:
        self._records.clear()

    def flush(self, fh: TextIO) -> int:
        """Write the buffered records as JSON lines (oldest first) and
        clear the buffer; returns the number written."""
        n = 0
        for rec in self._records:
            fh.write(json.dumps(rec, default=str) + "\n")
            n += 1
        fh.flush()
        self._records.clear()
        return n


class JsonLogger:
    """Structured logger over a ring sink, timestamped by an injected
    clock (the serving runtime passes its own, so virtual-time replays
    produce virtual-time logs)."""

    def __init__(
        self,
        sink: Optional[RingBufferSink] = None,
        clock: Optional[Callable[[], float]] = None,
        stream: Optional[TextIO] = None,
        fields: Optional[dict] = None,
    ):
        self.sink = sink if sink is not None else RingBufferSink()
        self.clock = clock
        self.stream = stream
        self.fields = dict(fields) if fields else {}

    def bind(self, **fields) -> "JsonLogger":
        """A child logger sharing this sink/stream with extra fields
        stamped on every record (e.g. ``logger.bind(replica=2)``) — how
        the replica tier tags one shared ring by replica id."""
        merged = {**self.fields, **fields}
        return JsonLogger(
            sink=self.sink, clock=self.clock, stream=self.stream,
            fields=merged,
        )

    def log(self, event: str, **fields) -> dict:
        record = {"event": str(event)}
        if self.clock is not None:
            record["ts"] = round(float(self.clock()), 9)
        if self.fields:
            record.update(self.fields)
        record.update(fields)
        self.sink.emit(record)
        if self.stream is not None:
            self.stream.write(json.dumps(record, default=str) + "\n")
        return record

    def flush_to(self, fh: TextIO) -> int:
        return self.sink.flush(fh)

    def flush_to_path(self, path: str) -> int:
        with open(path, "a") as fh:
            return self.sink.flush(fh)
