"""Low-overhead hierarchical tracing — the spine every layer reports into.

The port's copy of the JAX package's ``obs/tracer.py``, pure Python and
unchanged in behaviour (same event schema, same span names from the serve
engine).  One :class:`Tracer` serves three very different call sites with
one event schema:

* the **serving hot path** (``ServeEngine``): the worker already holds every
  timestamp it needs (submit, enqueue, dequeue, exec window), so spans are
  emitted *after the fact* via :meth:`Tracer.record` — no context managers,
  no contextvars, no allocation on the request path beyond the trace ID.
  Every instrumentation site guards on :attr:`Tracer.enabled` (a plain
  attribute read), so the disabled cost is one branch per site.
* nested scopes (the reference's compiler passes): :meth:`Tracer.span`
  hands out a context-manager span; children parent explicitly
  (``parent=root``) — deterministic across threads, unlike an ambient
  contextvar stack.
* **cross-component propagation** (a caller → ``ServeEngine``): the trace
  ID is a plain string created once at the outermost layer and passed
  down; any layer may attach spans to it from any thread.

Events are flat dicts (see :data:`EVENT_FIELDS`) pushed synchronously into a
pluggable exporter (:mod:`repro_torch.obs.export`): a bounded in-memory ring for
tests and dashboards, JSONL for offline analysis (``read_jsonl``).
Durations come from ``perf_counter``
(monotonic); ``ts`` is the wall-clock end time for cross-process ordering.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Any, Dict, Optional

__all__ = ["EVENT_FIELDS", "NULL_SPAN", "Span", "Tracer"]

# The JSONL schema, one event per finished span.  ``t0`` is a perf_counter
# reading — comparable within one process only; ``ts`` (unix seconds, span
# end) orders events across processes.
EVENT_FIELDS = ("trace", "span", "parent", "name", "ts", "t0", "dur_ms",
                "status", "attrs")


class Span:
    """A live span handle (enabled tracer only) — context-manager friendly.

    ``set(key, value)`` attaches structured attributes; ``end(status)``
    exports the event exactly once.  Exiting the ``with`` block ends the
    span, with ``status="error:<ExcType>"`` if an exception is in flight.
    """

    __slots__ = ("_tracer", "name", "trace", "span_id", "parent",
                 "attrs", "_t0", "_done")

    def __init__(self, tracer: "Tracer", name: str, trace: str,
                 span_id: str, parent: Optional[str],
                 attrs: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self.name = name
        self.trace = trace
        self.span_id = span_id
        self.parent = parent
        self.attrs = dict(attrs) if attrs else {}
        self._t0 = time.perf_counter()
        self._done = False

    def set(self, key: str, value: Any) -> "Span":
        self.attrs[key] = value
        return self

    def end(self, status: str = "ok") -> None:
        if self._done:
            return
        self._done = True
        self._tracer._export(self.name, self._t0, time.perf_counter(),
                             self.trace, self.span_id, self.parent,
                             status, self.attrs)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.end("ok" if exc_type is None
                 else f"error:{exc_type.__name__}")


class _NullSpan:
    """The disabled-tracer span: one module-level singleton, every method a
    no-op — the fast path allocates nothing."""

    __slots__ = ()
    name = ""
    trace = ""
    span_id = ""
    parent = None
    attrs: Dict[str, Any] = {}

    def set(self, key: str, value: Any) -> "_NullSpan":
        return self

    def end(self, status: str = "ok") -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


NULL_SPAN = _NullSpan()


class Tracer:
    """Span factory + exporter front-end.

    ``enabled`` is a plain attribute: hot paths read it once per
    instrumentation site and skip all span construction when False.  IDs
    stay cheap either way — a per-process random session prefix plus an
    atomic counter (``itertools.count`` under the GIL), no UUID machinery.
    """

    def __init__(self, exporter: Optional[Any] = None, enabled: bool = True):
        self.exporter = exporter
        self.enabled = bool(enabled) and exporter is not None
        self._session = os.urandom(3).hex()
        self._ids = itertools.count(1)

    def configure(self, exporter: Optional[Any] = None,
                  enabled: bool = True) -> "Tracer":
        """Swap the exporter / flip tracing at runtime (the global default
        tracer is configured exactly this way — components that captured it
        at construction see the change immediately)."""
        if exporter is not None:
            self.exporter = exporter
        self.enabled = bool(enabled) and self.exporter is not None
        return self

    # -- IDs ----------------------------------------------------------------
    def new_trace(self, prefix: str = "req") -> str:
        """A fresh trace ID.  Always available (even disabled): the ID is
        the one per-request allocation the disabled path is allowed — it
        rides error messages and cross-layer propagation regardless of
        whether spans are being exported."""
        return f"{prefix}-{self._session}-{next(self._ids):x}"

    def _span_id(self) -> str:
        return f"s{next(self._ids):x}"

    # -- span emission ------------------------------------------------------
    def span(self, name: str, *, trace: Optional[str] = None,
             parent: Optional[str] = None,
             attrs: Optional[Dict[str, Any]] = None):
        """A live span starting NOW; returns :data:`NULL_SPAN` when
        disabled.  ``trace=None`` starts a fresh trace."""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, trace or self.new_trace("span"),
                    self._span_id(), parent, attrs)

    def record(self, name: str, t0: float, t1: float, *, trace: str,
               parent: Optional[str] = None, span_id: Optional[str] = None,
               status: str = "ok",
               attrs: Optional[Dict[str, Any]] = None) -> str:
        """Emit a span post-hoc from timestamps the caller already holds
        (``perf_counter`` readings) — the serving hot path's API.  Returns
        the span ID so later spans can parent onto it; ``""`` when
        disabled.

        Deliberately flat: the event dict is built and handed to the
        exporter right here (no helper hops) — this call sits on the serve
        worker's critical path between dequeue and the next backbone exec,
        and each layer of Python call overhead showed up directly in the
        enabled-overhead benchmark."""
        if not self.enabled:
            return ""
        exp = self.exporter
        if exp is None:
            return ""
        sid = span_id or f"s{next(self._ids):x}"
        exp.export({
            "trace": trace, "span": sid, "parent": parent, "name": name,
            "ts": time.time(), "t0": t0,
            "dur_ms": (t1 - t0) * 1e3, "status": status,
            "attrs": attrs or {},
        })
        return sid

    def record_many(self, events) -> None:
        """Bulk post-hoc emission — the serve worker's batch path.

        ``events`` is a sequence of
        ``(name, t0, t1, trace, parent, span_id, status, attrs)`` tuples
        (``span_id``/``status``/``attrs`` may be None for auto-ID/"ok"/{}).
        One tracer call per coalesced batch instead of ~3 per request: the
        per-call overhead and the wall-clock read are paid once, and the
        event loop stays tight — this is what keeps the enabled tracing
        cost inside the <= 5% serve-throughput budget."""
        if not self.enabled:
            return
        exp = self.exporter
        if exp is None:
            return
        ts = time.time()
        push = exp.export
        ids = self._ids
        for name, t0, t1, trace, parent, sid, status, attrs in events:
            push({
                "trace": trace, "span": sid or f"s{next(ids):x}",
                "parent": parent, "name": name, "ts": ts, "t0": t0,
                "dur_ms": (t1 - t0) * 1e3, "status": status or "ok",
                "attrs": attrs or {},
            })

    def _export(self, name: str, t0: float, t1: float, trace: str,
                span_id: str, parent: Optional[str], status: str,
                attrs: Dict[str, Any]) -> None:
        exp = self.exporter
        if exp is None:
            return
        exp.export({
            "trace": trace, "span": span_id, "parent": parent, "name": name,
            "ts": time.time(), "t0": t0,
            "dur_ms": (t1 - t0) * 1e3, "status": status, "attrs": attrs,
        })
