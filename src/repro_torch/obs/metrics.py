"""Shared counter/gauge/histogram registry with Prometheus text exposition
(the port's copy of the JAX package's ``obs/metrics.py``).

One :class:`MetricsRegistry` holds every metric behind a **single lock** —
that is the point: ``ServeMetrics`` previously kept counters and latency
deques under separate implicit synchronisation, and a snapshot could read a
counter from before a batch and a latency list from after it.  Here every
mutation and every read section takes the one registry lock, so snapshots
are consistent by construction.  A caller may inject its own lock
(``MetricsRegistry(lock=...)``) to extend that consistency boundary around
state it keeps outside the registry.

Metrics are identified by ``(name, labelnames)``; each distinct label-value
tuple is a separate child series, created lazily on first touch.  Rendering
follows the Prometheus text exposition format, including label-value
escaping of backslash, double-quote, and newline.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "escape_label_value"]


def escape_label_value(v: str) -> str:
    """Prometheus label-value escaping: ``\\`` → ``\\\\``, ``"`` → ``\\"``,
    newline → ``\\n``."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _series_key(labelnames: Sequence[str],
                labels: Dict[str, str]) -> Tuple[str, ...]:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} != declared {sorted(labelnames)}")
    return tuple(str(labels[k]) for k in labelnames)


class _Metric:
    """Base: a named family of label-keyed child series."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str,
                 labelnames: Sequence[str], lock: threading.Lock):
        self.name = name
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._series: Dict[Tuple[str, ...], float] = {}

    def _fmt_labels(self, key: Tuple[str, ...]) -> str:
        if not key:
            return ""
        pairs = ", ".join(
            f'{n}="{escape_label_value(v)}"'
            for n, v in zip(self.labelnames, key))
        return "{" + pairs + "}"

    def reset(self) -> None:
        with self._lock:
            self._series.clear()


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = _series_key(self.labelnames, labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        key = _series_key(self.labelnames, labels)
        with self._lock:
            return self._series.get(key, 0.0)

    def total(self) -> float:
        """Sum over every child series."""
        with self._lock:
            return sum(self._series.values())

    def render(self) -> List[str]:
        with self._lock:
            items = sorted(self._series.items())
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} counter"]
        for key, val in items:
            lines.append(f"{self.name}{self._fmt_labels(key)} {val:g}")
        return lines


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels: str) -> None:
        key = _series_key(self.labelnames, labels)
        with self._lock:
            self._series[key] = float(value)

    def max(self, value: float, **labels: str) -> None:
        """Keep the running maximum (queue-depth high-water marks)."""
        key = _series_key(self.labelnames, labels)
        with self._lock:
            cur = self._series.get(key)
            if cur is None or value > cur:
                self._series[key] = float(value)

    def value(self, **labels: str) -> float:
        key = _series_key(self.labelnames, labels)
        with self._lock:
            return self._series.get(key, 0.0)

    def render(self) -> List[str]:
        with self._lock:
            items = sorted(self._series.items())
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} gauge"]
        for key, val in items:
            lines.append(f"{self.name}{self._fmt_labels(key)} {val:g}")
        return lines


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics: each ``le`` bucket
    counts observations ≤ its bound, ``+Inf`` counts everything)."""

    kind = "histogram"
    DEFAULT_BUCKETS = (0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000)

    def __init__(self, name: str, help_text: str,
                 labelnames: Sequence[str], lock: threading.Lock,
                 buckets: Optional[Sequence[float]] = None):
        super().__init__(name, help_text, labelnames, lock)
        self.buckets = tuple(sorted(buckets or self.DEFAULT_BUCKETS))
        # per child series: ([bucket counts..., +Inf count], sum)
        self._series: Dict[Tuple[str, ...], Tuple[List[int], float]] = {}

    def observe(self, value: float, **labels: str) -> None:
        key = _series_key(self.labelnames, labels)
        with self._lock:
            counts, total = self._series.get(
                key, ([0] * (len(self.buckets) + 1), 0.0))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            counts[-1] += 1
            self._series[key] = (counts, total + value)

    def count(self, **labels: str) -> int:
        key = _series_key(self.labelnames, labels)
        with self._lock:
            entry = self._series.get(key)
            return entry[0][-1] if entry else 0

    def render(self) -> List[str]:
        with self._lock:
            items = [(k, (list(c), s)) for k, (c, s) in
                     sorted(self._series.items())]
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        for key, (counts, total) in items:
            base = list(zip(self.labelnames, key))
            for bound, cum in zip(list(self.buckets) + ["+Inf"], counts):
                pairs = base + [("le", str(bound))]
                labels_txt = "{" + ", ".join(
                    f'{n}="{escape_label_value(v)}"' for n, v in pairs) + "}"
                lines.append(f"{self.name}_bucket{labels_txt} {cum}")
            lbl = self._fmt_labels(key)
            lines.append(f"{self.name}_sum{lbl} {total:g}")
            lines.append(f"{self.name}_count{lbl} {counts[-1]}")
        return lines


class MetricsRegistry:
    """Get-or-create registry; every metric shares ONE lock (optionally the
    caller's own, to widen the consistency boundary)."""

    def __init__(self, lock: Optional[threading.Lock] = None):
        self.lock = lock if lock is not None else threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self._reg_lock = threading.Lock()

    def _get_or_create(self, cls, name, help_text, labelnames, **kw):
        with self._reg_lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help_text, tuple(labelnames), self.lock, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls) or m.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} re-registered with different "
                    f"type/labels")
            return m

    def counter(self, name: str, help_text: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help_text, labelnames)

    def gauge(self, name: str, help_text: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help_text, labelnames)

    def histogram(self, name: str, help_text: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help_text, labelnames,
                                   buckets=buckets)

    def render(self) -> str:
        """Prometheus text exposition for every registered metric."""
        with self._reg_lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        with self._reg_lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.reset()
