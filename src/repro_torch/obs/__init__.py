"""Tracing and metrics for the checkpoint lifecycle (stdlib only).

* :mod:`repro_torch.obs.trace` — thread-aware spans in per-thread ring
  buffers, exportable as Chrome trace-event JSON (Perfetto). Off by
  default; ``span(...)`` is a near-free no-op when disabled.
* :mod:`repro_torch.obs.metrics` — a process-wide registry of counters,
  gauges and histograms, plus the unified save/restore report schema.
"""

from .trace import (Tracer, add_span, counter, disable, enable, enabled,
                    flow_id, get_tracer, instant, span, tracing)
from .metrics import (MetricsRegistry, RestoreReport, SaveReport,
                      cascade_report, metrics)

__all__ = [
    "Tracer", "add_span", "counter", "disable", "enable", "enabled",
    "flow_id", "get_tracer", "instant", "span", "tracing",
    "MetricsRegistry", "RestoreReport", "SaveReport", "cascade_report",
    "metrics",
]
