"""Observability of the port's data plane — the counterpart of
``kubeshare_tpu/obs/``.

- :mod:`.metrics` — labeled Counter/Gauge/Histogram families with a
  strict Prometheus exposition renderer, OpenMetrics exemplars on
  histogram buckets, and the parser and lint that read exposition back.
- :mod:`.trace` — spans with trace ids, a JSONL and a Chrome-trace
  export; the ids ride the wire under ``_trace``.
- :mod:`.flight` — the always-on flight recorder: a bounded ring of
  recent spans, notes, alerts and counter deltas, dumped as JSONL when a
  trigger fires.
- :mod:`.ledger` — the chip-time ledger: every interval of a device's
  timeline accounted to one ``(tenant, class, state)``.
- :mod:`.blame` — who held the device while a grant waited.
- :mod:`.slo` — per-tenant objectives, error budgets and multi-window
  burn-rate alerts on an injectable clock.
- :mod:`.prof` — tracked locks, phase attribution and a stack sampler.
- :mod:`.critpath` — one request's wall time split into front door,
  transport, grant wait and execute from many processes' spans.
- :mod:`.tsdb` — the registry's bounded fleet time-series store.
- :mod:`.decisions` — the scheduler's decision recorder: every submit,
  outcome, preemption and eviction as a replayable trace.

The port's token scheduler, proxy, wire, clients, resilience and serving
modules feed these where the JAX package's feed its own.
"""

from .blame import BlameGraph, default_blame
from .critpath import (SEGMENTS, assemble, load_spans, render_report,
                       report, spans_from_flight_entries)
from .flight import (FlightRecorder, default_recorder, dump_jsonl,
                     install_crash_handler, parse_dump_jsonl)
from .ledger import ChipTimeLedger, default_ledger
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      collect_default, default_registry, lint_exposition,
                      parse_exposition, prom_escape, quantile_from_buckets,
                      render_default, render_exposition, render_help_type,
                      render_sample)
from .prof import (PhaseProfiler, StackSampler, TrackedCondition,
                   TrackedLock, TrackedRLock)
from .slo import (AlertEvent, SloError, SloEvaluator, SloSpec,
                  default_evaluator, parse_slo, set_default_evaluator)
from .trace import (Span, Tracer, add_span_sink, get_tracer, install_tracer,
                    new_trace_id, remove_span_sink, tracing_enabled,
                    uninstall_tracer)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "collect_default", "default_registry", "lint_exposition",
    "parse_exposition", "prom_escape", "quantile_from_buckets",
    "render_default", "render_exposition", "render_help_type",
    "render_sample",
    "SEGMENTS", "assemble", "load_spans", "render_report", "report",
    "spans_from_flight_entries",
    "Span", "Tracer", "add_span_sink", "get_tracer", "install_tracer",
    "new_trace_id", "remove_span_sink", "tracing_enabled",
    "uninstall_tracer",
    "AlertEvent", "SloError", "SloEvaluator", "SloSpec",
    "default_evaluator", "parse_slo", "set_default_evaluator",
    "FlightRecorder", "default_recorder", "dump_jsonl",
    "install_crash_handler", "parse_dump_jsonl",
    "PhaseProfiler", "StackSampler", "TrackedCondition", "TrackedLock",
    "TrackedRLock",
    "ChipTimeLedger", "default_ledger", "BlameGraph", "default_blame",
]
