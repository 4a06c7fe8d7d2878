"""Span exporters: where :class:`repro_torch.obs.Tracer` events land (the
port's copy of the JAX package's ``obs/export.py``).

Exporters expose one method — ``export(event: dict) -> None`` — called
synchronously from the emitting thread, so they must be cheap and
thread-safe.  Two are provided:

* :class:`RingBufferExporter` — bounded in-memory deque; the default for
  tests, benchmarks, and live engine introspection.  Oldest events are
  evicted first.
* :class:`JsonlExporter` — append-only JSONL file for offline analysis
  (:func:`read_jsonl` loads it back).

Counters/gauges/histograms are *not* spans — they live in
:mod:`repro_torch.obs.metrics` and render via Prometheus text exposition.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from typing import Any, Dict, List

__all__ = ["JsonlExporter", "RingBufferExporter", "read_jsonl"]


class RingBufferExporter:
    """Keep the most recent ``capacity`` events in memory (FIFO eviction)."""

    def __init__(self, capacity: int = 4096):
        self._buf: deque = deque(maxlen=int(capacity))
        self._lock = threading.Lock()

    def export(self, event: Dict[str, Any]) -> None:
        # lock-free on purpose: deque.append with maxlen is atomic under
        # the GIL, and this sits on the serve worker's critical path.  The
        # lock below only serializes drain() against itself — a snapshot
        # concurrent with appends is still a valid (slightly stale) view.
        self._buf.append(event)

    def events(self) -> List[Dict[str, Any]]:
        """Snapshot, oldest first; the buffer is left intact."""
        return list(self._buf)

    def drain(self) -> List[Dict[str, Any]]:
        """Snapshot-and-clear, oldest first."""
        with self._lock:
            out = list(self._buf)
            self._buf.clear()
            return out

    def __len__(self) -> int:
        return len(self._buf)


class JsonlExporter:
    """Append each event as one JSON line; flushed per event so a crashed
    process loses at most the OS buffer."""

    def __init__(self, path: str):
        self.path = str(path)
        self._lock = threading.Lock()
        self._fh = open(self.path, "a")

    def export(self, event: Dict[str, Any]) -> None:
        line = json.dumps(event, default=str)
        with self._lock:
            self._fh.write(line + "\n")
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.close()

    def __enter__(self) -> "JsonlExporter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Load a JSONL trace file back into event dicts (blank lines skipped)."""
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
