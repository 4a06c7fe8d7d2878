"""repro_torch.obs — tracing and metrics for the port's serving layer.

The port's copies of the JAX package's ``obs/{tracer,metrics,export}.py``
(pure Python, kept here so the port imports nothing of ``repro``):

* :class:`Tracer` and its exporters — hierarchical spans with one trace ID
  per serve request, exported as flat event dicts (a bounded in-memory
  ring, or JSONL).
* :class:`MetricsRegistry` — counters, gauges and histograms under one
  lock, rendered as Prometheus text exposition (``ServeMetrics`` is built
  on it).

* :mod:`repro_torch.obs.costmodel` — per-node FLOPs/bytes/estimated-ms
  attribution behind ``DeployedModel.profile()``, recorded into sweep
  points.

The reference's HLO analysis and trace summarizer read XLA artifacts and
are not part of the port.  A process-global default tracer
(disabled until :func:`configure` attaches an exporter) lets components
instrument unconditionally at near-zero cost when nobody is looking.
"""

from repro_torch.obs.export import JsonlExporter, RingBufferExporter, read_jsonl
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, escape_label_value)
from repro_torch.obs.tracer import EVENT_FIELDS, NULL_SPAN, Span, Tracer

__all__ = [
    "EVENT_FIELDS", "NULL_SPAN", "Span", "Tracer",
    "JsonlExporter", "RingBufferExporter", "read_jsonl",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "escape_label_value",
    "configure", "get_tracer",
]

# Disabled until configure() attaches an exporter; components that default
# to this tracer pay one attribute read per instrumentation site.
_default_tracer = Tracer(exporter=None, enabled=False)


def get_tracer() -> Tracer:
    """The process-global default tracer."""
    return _default_tracer


def configure(exporter=None, enabled: bool = True) -> Tracer:
    """Attach an exporter to (and enable/disable) the global tracer.

    Returns the tracer so call sites can do
    ``tr = obs.configure(RingBufferExporter())``.
    """
    return _default_tracer.configure(exporter=exporter, enabled=enabled)
