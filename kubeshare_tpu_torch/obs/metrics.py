"""Labeled metrics and their Prometheus exposition — the port's copy of
what the preemption and serving planes record into, from
``kubeshare_tpu/obs/metrics.py``.

Counter, Gauge and cumulative-bucket Histogram families with a fixed
label schema, held in a :class:`MetricsRegistry`; histogram series keep
the latest trace-id exemplar per bucket, rendered in OpenMetrics syntax on
the ``_bucket`` lines. :func:`quantile_from_buckets` is the PromQL-style
estimate the serving accounting derives p50/p99 from. The JAX module's
exposition parser, lint and remote-write collection are not ported (no
reader of the port needs them yet); the text this module renders is the
JAX module's, line for line.
"""

from __future__ import annotations

import bisect
import math
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

# -- exposition rendering ----------------------------------------------------

_LABEL_ESCAPES = {"\\": r"\\", '"': r"\"", "\n": r"\n"}


def prom_escape(value) -> str:
    """Escape a label value per the Prometheus text format (v0.0.4)."""
    return "".join(_LABEL_ESCAPES.get(ch, ch) for ch in str(value))


def render_sample(name: str, labels: Optional[dict], value,
                  exemplar: Optional[Tuple[str, float]] = None) -> str:
    """One sample line: ``name{k="v",...} value``, with an optional
    ``# {trace_id="..."} observed`` exemplar (no trailing newline)."""
    if labels:
        body = ",".join('%s="%s"' % (k, prom_escape(v))
                        for k, v in sorted(labels.items()))
        line = "%s{%s} %s" % (name, body, _fmt_value(value))
    else:
        line = "%s %s" % (name, _fmt_value(value))
    if exemplar is not None:
        trace_id, observed = exemplar
        line += ' # {trace_id="%s"} %s' % (prom_escape(trace_id),
                                           _fmt_value(observed))
    return line


def render_help_type(name: str, mtype: str, help_text: str) -> List[str]:
    """``# HELP`` / ``# TYPE`` header lines for one metric family."""
    return [
        "# HELP %s %s" % (name, help_text.replace("\\", r"\\")
                          .replace("\n", r"\n")),
        "# TYPE %s %s" % (name, mtype),
    ]


def _fmt_value(value) -> str:
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    f = float(value)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_le(bound: float) -> str:
    return "+Inf" if bound == math.inf else _fmt_value(bound)


# -- metric primitives -------------------------------------------------------

#: latency buckets in seconds: sub-millisecond grants up to multi-second
#: waits under contention
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, math.inf)


class _Metric:
    """One named family with a fixed label-key schema."""

    mtype = "untyped"

    def __init__(self, name: str, help_text: str,
                 labels: Sequence[str] = ()):
        self.name = name
        self.help_text = help_text
        self.label_keys = tuple(labels)
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, ...], object] = {}

    def _key(self, label_values: Sequence) -> Tuple[str, ...]:
        if len(label_values) != len(self.label_keys):
            raise ValueError("%s expects labels %r, got %r"
                             % (self.name, self.label_keys,
                                tuple(label_values)))
        return tuple(str(v) for v in label_values)

    def render(self) -> List[str]:
        lines = render_help_type(self.name, self.mtype, self.help_text)
        with self._lock:
            series = sorted(self._series.items())
        for key, value in series:
            lines.extend(self._render_series(
                dict(zip(self.label_keys, key)), value))
        return lines

    def _render_series(self, labels: dict, value) -> List[str]:
        return [render_sample(self.name, labels, value)]


class Counter(_Metric):
    """Monotonically increasing count."""

    mtype = "counter"

    def inc(self, *label_values, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counter %s cannot decrease" % self.name)
        key = self._key(label_values)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, *label_values) -> float:
        key = self._key(label_values)
        with self._lock:
            return float(self._series.get(key, 0.0))


class Gauge(_Metric):
    """Point-in-time value that can go up or down."""

    mtype = "gauge"

    def set(self, *label_values, value: float) -> None:
        key = self._key(label_values)
        with self._lock:
            self._series[key] = float(value)

    def value(self, *label_values) -> float:
        key = self._key(label_values)
        with self._lock:
            return float(self._series.get(key, 0.0))


class _HistSeries:
    __slots__ = ("counts", "total", "count", "exemplars")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets   # per bucket, not cumulative
        self.total = 0.0
        self.count = 0
        #: bucket index -> (trace_id, observed value); the latest wins
        self.exemplars: Dict[int, Tuple[str, float]] = {}


class Histogram(_Metric):
    """Cumulative-bucket histogram (``_bucket``/``_sum``/``_count``)."""

    mtype = "histogram"

    def __init__(self, name: str, help_text: str,
                 labels: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help_text, labels)
        bounds = sorted(float(b) for b in buckets)
        if not bounds or bounds[-1] != math.inf:
            bounds.append(math.inf)
        self.buckets = tuple(bounds)

    def observe(self, *label_values, value: float,
                exemplar: Optional[str] = None) -> None:
        value = float(value)
        if value != value:     # NaN sorts nowhere and would poison _sum
            raise ValueError("histogram %s cannot observe NaN" % self.name)
        key = self._key(label_values)
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = _HistSeries(len(self.buckets))
            series.counts[idx] += 1
            series.total += value
            series.count += 1
            if exemplar:
                series.exemplars[idx] = (str(exemplar), value)

    def snapshot(self, *label_values):
        """(cumulative bucket counts, sum, count) — for quantile math."""
        key = self._key(label_values)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                return [0] * len(self.buckets), 0.0, 0
            cumulative, running = [], 0
            for c in series.counts:
                running += c
                cumulative.append(running)
            return cumulative, series.total, series.count

    def _render_series(self, labels: dict, series: _HistSeries) -> List[str]:
        lines, running = [], 0
        for i, (bound, c) in enumerate(zip(self.buckets, series.counts)):
            running += c
            bucket_labels = dict(labels)
            bucket_labels["le"] = _fmt_le(bound)
            lines.append(render_sample(self.name + "_bucket",
                                       bucket_labels, running,
                                       exemplar=series.exemplars.get(i)))
        lines.append(render_sample(self.name + "_sum", labels, series.total))
        lines.append(render_sample(self.name + "_count", labels,
                                   series.count))
        return lines


def quantile_from_buckets(buckets: Sequence[float],
                          cumulative: Sequence[int],
                          q: float) -> float:
    """Estimate quantile ``q`` by linear interpolation within buckets, as
    PromQL's ``histogram_quantile``: the +Inf bucket clamps to the
    previous finite bound rather than extrapolating."""
    total = cumulative[-1] if cumulative else 0
    if total == 0:
        return float("nan")
    rank = q * total
    for i, cum in enumerate(cumulative):
        if cum >= rank:
            upper = buckets[i]
            lower = buckets[i - 1] if i > 0 else 0.0
            if upper == math.inf:
                return lower if i > 0 else float("nan")
            prev_cum = cumulative[i - 1] if i > 0 else 0
            in_bucket = cum - prev_cum
            if in_bucket == 0:
                return upper
            return lower + (upper - lower) * (rank - prev_cum) / in_bucket
    return buckets[-2] if len(buckets) > 1 else float("nan")


# -- registry ----------------------------------------------------------------

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


class MetricsRegistry:
    """Named families with idempotent getters: ``counter()``, ``gauge()``
    and ``histogram()`` return the family already registered under a
    name, so instrumentation sites declare theirs without coordination."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help_text, labels, **kwargs):
        if not _NAME_RE.match(name):
            raise ValueError("invalid metric name %r" % name)
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError("metric %s already registered as %s"
                                     % (name, existing.mtype))
                return existing
            metric = cls(name, help_text, labels, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help_text: str,
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help_text, labels)

    def gauge(self, name: str, help_text: str,
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help_text, labels)

    def histogram(self, name: str, help_text: str,
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help_text, labels,
                                   buckets=buckets)

    def render(self) -> str:
        """Full exposition text for this registry (trailing newline)."""
        lines: List[str] = []
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        for metric in metrics:
            lines.extend(metric.render())
        return "\n".join(lines) + "\n" if lines else ""


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry the preemption counters record into."""
    return _DEFAULT
