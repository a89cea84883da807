"""Always-on runtime telemetry (mirrors ``paddle_tpu/observability/``,
its exports without the drift monitor).

* :mod:`.metrics` — process-wide registry of counters / gauges /
  fixed-bucket histograms; ``PADDLE_TPU_TELEMETRY=0`` kill switch;
* :mod:`.journal` — schema-versioned step/event ring buffer, flushed
  as JSONL into ``PADDLE_TPU_TELEMETRY_DIR``;
* :mod:`.exporters` — Prometheus text and JSON snapshot;
* :mod:`.runtime` — the one-line hooks the executor, the pipeline, the
  serving dispatcher, the decode engine and the concurrency gates call;
* :mod:`.tracing` — spans with cross-thread / cross-process context
  propagation (``PADDLE_TPU_TRACING=0`` kill switch) plus a flight
  recorder dumped on fatal conditions.

Every hook and span is host work: nothing here reads or waits on the
device.  The drift monitor (predicted against measured step time) waits
for the cost model (ROADMAP.md, Queue A item 3).
"""

from . import exporters, journal, metrics, runtime, tracing  # noqa: F401
from .exporters import (export_json, export_prometheus,
                        write_chrome_trace, write_metrics_snapshot)
from .journal import (SCHEMA_VERSION, Journal, emit, get_journal,
                      journal_dir, read_journal, reset_journal)
from .metrics import (DEFAULT_LATENCY_BUCKETS_MS, Counter, Gauge,
                      Histogram, MetricsRegistry, counter, gauge,
                      histogram, registry, reset_metrics,
                      set_telemetry_enabled, telemetry_enabled)
from .tracing import (NULL_SPAN, Span, SpanContext, Tracer,
                      capture_context, current_span, current_trace_id,
                      current_traceparent, flight_dump, get_tracer,
                      read_flight_records, read_traces, reset_tracing,
                      sample_step, set_rank, set_tracing_enabled, span,
                      span_if_traced, start_span, step_sample_every,
                      tracing_enabled, use_context)

__all__ = [
    # metrics
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "DEFAULT_LATENCY_BUCKETS_MS", "registry", "counter", "gauge",
    "histogram", "telemetry_enabled", "set_telemetry_enabled",
    "reset_metrics",
    # journal
    "SCHEMA_VERSION", "Journal", "get_journal", "emit", "read_journal",
    "journal_dir", "reset_journal",
    # exporters
    "export_prometheus", "export_json", "write_metrics_snapshot",
    "write_chrome_trace",
    # tracing
    "Span", "SpanContext", "Tracer", "NULL_SPAN", "span", "start_span",
    "span_if_traced", "sample_step", "step_sample_every",
    "current_span", "current_trace_id", "current_traceparent",
    "capture_context", "use_context", "get_tracer", "flight_dump",
    "read_traces", "read_flight_records", "tracing_enabled",
    "set_tracing_enabled", "set_rank", "reset_tracing",
    "reset_telemetry",
]


def reset_telemetry():
    """Full reset — metrics, journal singleton, runtime cross-step
    state, tracer singleton (test isolation)."""
    reset_metrics()
    reset_journal()
    reset_tracing()
    runtime.reset_runtime()
