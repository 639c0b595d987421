"""Lightweight span tracing with JSONL and Chrome trace-event export —
the port's copy of ``kubeshare_tpu/obs/trace.py``.

A :class:`Tracer` records :class:`Span` rows keyed by a trace id that
rides with the request: a client stamps it on its connection, the wire
carries it under the ``_trace`` message key (``isolation/protocol.py``),
and the server side's spans (``token-grant``, ``execute``,
``serve-batch``) join the client's (``transport``, ``reconnect``,
``migrate``), so one request's timeline stitches across processes.

Clock discipline: span times come from ``time.monotonic`` (never wall
time), anchored once per tracer to an epoch so exported timestamps are
stable across export calls. Epochs are per process, which is why
:mod:`.critpath` attributes by durations. Export targets:

- ``export_jsonl(path)`` — one JSON object per line;
- ``chrome_trace()`` — Chrome trace-event JSON (``ph: "X"`` complete
  events, microsecond units), loadable in Perfetto.

Completed spans also go to the span sinks (:func:`add_span_sink`) whether
or not a real tracer is installed: the flight recorder is one.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


def new_trace_id() -> str:
    return uuid.uuid4().hex


# -- span sinks --------------------------------------------------------------
# Observers of *completed* spans, fired regardless of whether a real
# tracer is installed (the flight recorder must see spans even when the
# bounded Tracer ring is not): both Tracer and _NullTracer emit from
# finish()/record(). Sink errors are swallowed — observability must
# never take down the operation it observes.

_SINKS: List[Callable[["Span"], None]] = []
_sinks_lock = threading.Lock()


def add_span_sink(fn: Callable[["Span"], None]) -> Callable[["Span"], None]:
    with _sinks_lock:
        if fn not in _SINKS:
            _SINKS.append(fn)
    return fn


def remove_span_sink(fn: Callable[["Span"], None]) -> None:
    with _sinks_lock:
        try:
            _SINKS.remove(fn)
        except ValueError:
            pass


def _emit_span(span: "Span") -> None:
    with _sinks_lock:
        sinks = list(_SINKS)
    for fn in sinks:
        try:
            fn(span)
        except Exception:
            pass


def _new_span_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclass
class Span:
    """One timed operation. ``end_ms`` stays ``None`` while open."""

    name: str
    trace_id: str
    span_id: str = field(default_factory=_new_span_id)
    parent_id: str = ""
    start_ms: float = 0.0
    end_ms: Optional[float] = None
    attrs: dict = field(default_factory=dict)

    @property
    def duration_ms(self) -> Optional[float]:
        if self.end_ms is None:
            return None
        return self.end_ms - self.start_ms

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_ms": round(self.start_ms, 3),
            "end_ms": None if self.end_ms is None else round(self.end_ms, 3),
            "attrs": self.attrs,
        }


class _SpanHandle:
    """Context manager returned by :meth:`Tracer.span`."""

    __slots__ = ("_tracer", "span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self.span = span

    def __enter__(self) -> Span:
        return self.span

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.span.attrs.setdefault("error", exc_type.__name__)
        self._tracer.finish(self.span)


class Tracer:
    """Bounded in-memory span sink (drops oldest beyond ``capacity``)."""

    def __init__(self, capacity: int = 10000):
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._capacity = capacity
        # monotonic epoch so span times are comparable within a process
        self._epoch = time.monotonic()

    def now_ms(self) -> float:
        return (time.monotonic() - self._epoch) * 1000.0

    # -- recording -----------------------------------------------------------

    def begin(self, name: str, trace_id: str, parent_id: str = "",
              **attrs) -> Span:
        span = Span(name=name, trace_id=trace_id, parent_id=parent_id,
                    start_ms=self.now_ms(), attrs=dict(attrs))
        with self._lock:
            self._spans.append(span)
            if len(self._spans) > self._capacity:
                del self._spans[:len(self._spans) - self._capacity]
        return span

    def finish(self, span: Span) -> Span:
        if span.end_ms is None:
            span.end_ms = self.now_ms()
            _emit_span(span)
        return span

    def span(self, name: str, trace_id: str, parent_id: str = "",
             **attrs) -> _SpanHandle:
        """``with tracer.span("filter", tid) as s: ...`` — auto-finishes."""
        return _SpanHandle(self, self.begin(name, trace_id, parent_id,
                                            **attrs))

    def record(self, name: str, trace_id: str, start_ms: float,
               end_ms: float, parent_id: str = "", **attrs) -> Span:
        """Record a span retroactively with explicit timestamps.

        Used where the duration is only known after the fact — e.g.
        queue-wait, whose start predates the point of measurement.
        """
        span = Span(name=name, trace_id=trace_id, parent_id=parent_id,
                    start_ms=start_ms, end_ms=end_ms, attrs=dict(attrs))
        with self._lock:
            self._spans.append(span)
            if len(self._spans) > self._capacity:
                del self._spans[:len(self._spans) - self._capacity]
        _emit_span(span)
        return span

    # -- reading / export ----------------------------------------------------

    def spans(self, trace_id: Optional[str] = None) -> List[Span]:
        with self._lock:
            out = list(self._spans)
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        return out

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def _closed_spans(self, trace_id: Optional[str]) -> List[Span]:
        """Spans with open ends closed at their trace's last-seen time.

        Root spans (e.g. a pod's ``submit``) stay open until the pod is
        deleted; exports close them at the max end time seen in the same
        trace so containment (submit ⊃ children) holds in the output.
        """
        spans = self.spans(trace_id)
        last_end: Dict[str, float] = {}
        for s in spans:
            end = s.end_ms if s.end_ms is not None else s.start_ms
            last_end[s.trace_id] = max(last_end.get(s.trace_id, 0.0), end)
        closed = []
        for s in spans:
            if s.end_ms is None:
                s = Span(name=s.name, trace_id=s.trace_id,
                         span_id=s.span_id, parent_id=s.parent_id,
                         start_ms=s.start_ms,
                         end_ms=max(last_end[s.trace_id], s.start_ms),
                         attrs=dict(s.attrs, open=True))
            closed.append(s)
        return closed

    def export_jsonl(self, path, trace_id: Optional[str] = None) -> int:
        """Write one JSON object per span; returns the span count."""
        spans = self._closed_spans(trace_id)
        with open(path, "w") as fh:
            for s in sorted(spans, key=lambda s: s.start_ms):
                fh.write(json.dumps(s.to_dict(), sort_keys=True) + "\n")
        return len(spans)

    def chrome_trace(self, trace_id: Optional[str] = None) -> dict:
        """Chrome trace-event JSON object (Perfetto-loadable).

        Each trace ID becomes one ``pid`` row so concurrent pods render
        as parallel tracks; span nesting within a track is inferred by
        the viewer from timestamp containment.
        """
        spans = self._closed_spans(trace_id)
        pids: Dict[str, int] = {}
        events = []
        for s in sorted(spans, key=lambda s: s.start_ms):
            pid = pids.setdefault(s.trace_id, len(pids) + 1)
            events.append({
                "name": s.name,
                "ph": "X",
                "ts": round(s.start_ms * 1000.0, 1),      # microseconds
                "dur": round((s.end_ms - s.start_ms) * 1000.0, 1),
                "pid": pid,
                "tid": 1,
                "args": dict(s.attrs, trace_id=s.trace_id,
                             span_id=s.span_id, parent_id=s.parent_id),
            })
        meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 1,
                 "args": {"name": "trace %s" % tid[:8]}}
                for tid, pid in pids.items()]
        return {"traceEvents": meta + events,
                "displayTimeUnit": "ms"}


class _NullTracer(Tracer):
    """Records nothing — the default when tracing is not installed."""

    def __init__(self):
        super().__init__(capacity=0)

    def begin(self, name, trace_id, parent_id="", **attrs):
        return Span(name=name, trace_id=trace_id, parent_id=parent_id,
                    attrs=dict(attrs))

    def finish(self, span):
        if span.end_ms is None:
            span.end_ms = span.start_ms
            _emit_span(span)
        return span

    def record(self, name, trace_id, start_ms, end_ms, parent_id="",
               **attrs):
        span = Span(name=name, trace_id=trace_id, parent_id=parent_id,
                    start_ms=start_ms, end_ms=end_ms, attrs=dict(attrs))
        _emit_span(span)
        return span


_NULL = _NullTracer()
_active: Tracer = _NULL
_active_lock = threading.Lock()


def install_tracer(tracer: Optional[Tracer] = None) -> Tracer:
    """Install (and return) the process-wide tracer."""
    global _active
    with _active_lock:
        _active = tracer if tracer is not None else Tracer()
        return _active


def uninstall_tracer() -> None:
    global _active
    with _active_lock:
        _active = _NULL


def get_tracer() -> Tracer:
    return _active


def tracing_enabled() -> bool:
    return _active is not _NULL
