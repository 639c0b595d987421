"""In-process labeled metrics with a strict Prometheus exposition renderer
— the port's copy of ``kubeshare_tpu/obs/metrics.py``.

Counter, Gauge and cumulative-bucket Histogram families with a fixed label
schema, held in a :class:`MetricsRegistry`; histogram series keep the
latest trace-id exemplar per bucket, rendered in OpenMetrics syntax on the
``_bucket`` lines. One process-wide default registry takes every record of
the port's data plane (token scheduler, proxy, wire, resilience, serving,
preemption, the obs modules themselves); :func:`render_default` is its
exposition and :func:`collect_default` its flat sample list.
:func:`parse_exposition` / :func:`render_exposition` /
:func:`lint_exposition` read exposition text back. The text this module
renders is the JAX module's, byte for byte, for the same operations.

No external deps: the stdlib is enough for counters, gauges and
histograms, and keeps a record at a dict lookup plus a float add under one
lock.
"""

from __future__ import annotations

import bisect
import math
import re
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# -- exposition rendering ----------------------------------------------------

_LABEL_ESCAPES = {"\\": r"\\", '"': r"\"", "\n": r"\n"}


def prom_escape(value) -> str:
    """Escape a label value per the Prometheus text format (v0.0.4)."""
    return "".join(_LABEL_ESCAPES.get(ch, ch) for ch in str(value))


def render_sample(name: str, labels: Optional[dict], value,
                  exemplar: Optional[Tuple[str, float]] = None) -> str:
    """One sample line: ``name{k="v",...} value`` (no trailing newline).

    ``exemplar`` is an optional ``(trace_id, observed_value)`` pair
    rendered in OpenMetrics syntax: ``... 17 # {trace_id="abc"} 0.043``.
    Only histogram ``_bucket`` lines may carry one (enforced by
    :func:`lint_exposition`, not here).
    """
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

# Latency buckets in seconds: sub-millisecond scheduler phases up to
# multi-second token waits under contention.
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, math.inf)


class _Metric:
    """Base: one named family with a fixed label-key schema."""

    mtype = "untyped"

    def __init__(self, name: str, help_text: str,
                 labels: Sequence[str] = ()):
        self.name = name
        self.help_text = help_text
        self.label_keys = tuple(labels)
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, ...], object] = {}

    def _key(self, label_values: Sequence[str]) -> Tuple[str, ...]:
        if len(label_values) != len(self.label_keys):
            raise ValueError("%s expects labels %r, got %r"
                             % (self.name, self.label_keys,
                                tuple(label_values)))
        # fast path: transport hot paths record per op, and their label
        # values are already strings — skip the genexp + str() round-trip
        for v in label_values:
            if type(v) is not str:
                return tuple(str(v) for v in label_values)
        return tuple(label_values)

    def _labels_dict(self, key: Tuple[str, ...]) -> dict:
        return dict(zip(self.label_keys, key))

    def render(self) -> List[str]:
        lines = render_help_type(self.name, self.mtype, self.help_text)
        with self._lock:
            series = sorted(self._series.items())
        for key, value in series:
            lines.extend(self._render_series(self._labels_dict(key), value))
        return lines

    def _render_series(self, labels: dict, value) -> List[str]:
        return [render_sample(self.name, labels, value)]

    def collect(self) -> List[Tuple[str, dict, float]]:
        """Flat ``(sample_name, labels, value)`` tuples for this family.

        A reader that wants numbers gets these instead of exposition
        text: building tuples skips the render→regex-parse round trip.
        """
        with self._lock:
            series = sorted(self._series.items())
        out: List[Tuple[str, dict, float]] = []
        for key, value in series:
            out.extend(self._collect_series(self._labels_dict(key), value))
        return out

    def _collect_series(self, labels: dict, value) -> List[Tuple[str, dict,
                                                                 float]]:
        return [(self.name, labels, float(value))]


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

    def inc(self, *label_values, amount: float = 1.0) -> None:
        key = self._key(label_values)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, *label_values) -> float:
        key = self._key(label_values)
        with self._lock:
            return float(self._series.get(key, 0.0))


class _HistSeries:
    __slots__ = ("counts", "total", "count", "exemplars")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets   # per-bucket (non-cumulative)
        self.total = 0.0
        self.count = 0
        # bucket idx -> (trace_id, observed value); latest wins, so the
        # exposition always links each bucket to a recent concrete trace
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
        if value != value:     # NaN sorts nowhere: bisect would pick an
            raise ValueError(  # arbitrary bucket and poison _sum forever
                "histogram %s cannot observe NaN" % self.name)
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

    def exemplars(self, *label_values) -> Dict[float, Tuple[str, float]]:
        """Latest ``{bucket upper bound: (trace_id, value)}`` per series."""
        key = self._key(label_values)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                return {}
            return {self.buckets[i]: ex
                    for i, ex in series.exemplars.items()}

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

    def _collect_series(self, labels: dict, series: _HistSeries
                        ) -> List[Tuple[str, dict, float]]:
        out, running = [], 0
        for bound, c in zip(self.buckets, series.counts):
            running += c
            bucket_labels = dict(labels)
            bucket_labels["le"] = _fmt_le(bound)
            out.append((self.name + "_bucket", bucket_labels,
                        float(running)))
        out.append((self.name + "_sum", labels, float(series.total)))
        out.append((self.name + "_count", labels, float(series.count)))
        return out


def quantile_from_buckets(buckets: Sequence[float],
                          cumulative: Sequence[int],
                          q: float) -> float:
    """Estimate quantile ``q`` by linear interpolation within buckets.

    Mirrors PromQL's ``histogram_quantile``: the +Inf bucket clamps to
    the previous finite bound rather than extrapolating.
    """
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
    """Named families with idempotent getters.

    ``counter()/gauge()/histogram()`` return the existing family when the
    name is already registered, so instrumentation sites can declare
    their families at import time without coordination.
    """

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

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def families(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def render(self) -> str:
        """Full exposition text for this registry (trailing newline)."""
        lines: List[str] = []
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        for metric in metrics:
            lines.extend(metric.render())
        return "\n".join(lines) + "\n" if lines else ""

    def collect(self) -> dict:
        """Compact snapshot: ``{"families": {name: type}, "samples":
        [(name, labels, value), ...]}``.

        The JAX package's remote-write wire shape: histogram sub-samples
        (``_bucket``/``_sum``/``_count``) appear
        under their full sample names with the base family typed
        ``histogram`` in ``families``, mirroring how
        :func:`parse_exposition` attaches them.
        """
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        families = {m.name: m.mtype for m in metrics}
        samples: List[Tuple[str, dict, float]] = []
        for metric in metrics:
            samples.extend(metric.collect())
        return {"families": families, "samples": samples}

    def reset(self) -> None:
        """Drop all families — test isolation only."""
        with self._lock:
            self._metrics.clear()


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry every instrumentation site records into."""
    return _DEFAULT


def render_default() -> str:
    return _DEFAULT.render()


def collect_default() -> dict:
    """Compact snapshot of the process-wide registry."""
    return _DEFAULT.collect()


# -- exposition parsing (readers and lint) -----------------------------------

HELP_RE = re.compile(r"^# HELP ([a-zA-Z_:][a-zA-Z0-9_:]*) (.*)$")
TYPE_RE = re.compile(
    r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) "
    r"(counter|gauge|histogram|summary|untyped)$")
_NUM = r"NaN|[+-]?Inf|[+-]?[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?"
SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{((?:[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\\n]|\\[\\\"n])*\",?)*)\})?"
    r" (" + _NUM + r")"
    r"(?: [0-9]+)?"
    # OpenMetrics exemplar: ` # {trace_id="..."} <value>` — anything
    # else after the value (including a malformed exemplar) fails the
    # whole line, which is how lint rejects bad exemplar syntax.
    r"(?: # \{trace_id=\"((?:[^\"\\\n]|\\[\\\"n])*)\" *\} (" + _NUM + r"))?"
    r"$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\\n]|\\[\\"n])*)"')


def _unescape(value: str) -> str:
    return (value.replace(r"\n", "\n").replace(r"\"", '"')
            .replace(r"\\", "\\"))


def parse_exposition(text: str) -> Dict[str, dict]:
    """Parse exposition text into ``{family: {type, help, samples,
    exemplars}}``.

    ``samples`` is a list of ``(name, labels_dict, value)``; histogram
    ``_bucket``/``_sum``/``_count`` samples attach to their base family.
    ``exemplars`` is a list of ``(name, labels_dict, trace_id, value)``
    for sample lines that carried an OpenMetrics exemplar.
    Raises ``ValueError`` on any malformed line — this doubles as the
    line grammar of :func:`lint_exposition`.
    """
    families: Dict[str, dict] = {}

    def family(name: str) -> dict:
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in families:
                base = name[:-len(suffix)]
                break
        return families.setdefault(
            base, {"type": None, "help": None, "samples": [],
                   "exemplars": []})

    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        m = HELP_RE.match(line)
        if m:
            family(m.group(1))["help"] = m.group(2)
            continue
        m = TYPE_RE.match(line)
        if m:
            family(m.group(1))["type"] = m.group(2)
            continue
        if line.startswith("#"):      # bare comments are legal, skipped
            continue
        m = SAMPLE_RE.match(line)
        if not m:
            raise ValueError("malformed exposition line %d: %r"
                             % (lineno, line))
        name, raw_labels, raw_value = m.group(1), m.group(2), m.group(3)
        labels = {k: _unescape(v)
                  for k, v in _LABEL_RE.findall(raw_labels or "")}
        value = float(raw_value.replace("Inf", "inf"))
        fam = family(name)
        fam["samples"].append((name, labels, value))
        if m.group(4) is not None:
            fam["exemplars"].append(
                (name, labels, _unescape(m.group(4)),
                 float(m.group(5).replace("Inf", "inf"))))
    return families


def render_exposition(families: Dict[str, dict]) -> str:
    """Inverse of :func:`parse_exposition` — re-render parsed families.

    ``parse(render(parse(text)))`` equals ``parse(text)`` for any text
    rendered by this module, which is what the exemplar round-trip test
    pins. HELP text is emitted verbatim (it is stored escaped).
    """
    lines: List[str] = []
    for name in sorted(families):
        fam = families[name]
        if fam.get("help") is not None:
            lines.append("# HELP %s %s" % (name, fam["help"]))
        if fam.get("type") is not None:
            lines.append("# TYPE %s %s" % (name, fam["type"]))
        by_key = {}
        for ex in fam.get("exemplars", ()):
            ex_name, ex_labels, trace_id, observed = ex
            by_key[(ex_name, tuple(sorted(ex_labels.items())))] = \
                (trace_id, observed)
        for sname, labels, value in fam.get("samples", ()):
            ex = by_key.get((sname, tuple(sorted(labels.items()))))
            lines.append(render_sample(sname, labels, value, exemplar=ex))
    return "\n".join(lines) + "\n" if lines else ""


def lint_exposition(text: str) -> List[str]:
    """Return lint errors (empty list == clean).

    Beyond line grammar: every family with samples must carry both a
    ``# HELP`` and a ``# TYPE`` header, and exemplars may only ride
    histogram ``_bucket`` lines (malformed exemplar syntax already
    fails the line grammar inside :func:`parse_exposition`).
    """
    try:
        families = parse_exposition(text)
    except ValueError as exc:
        return [str(exc)]
    errors = []
    for name, fam in sorted(families.items()):
        if not fam["samples"]:
            continue
        if fam["type"] is None:
            errors.append("family %s has samples but no # TYPE" % name)
        if fam["help"] is None:
            errors.append("family %s has samples but no # HELP" % name)
        for ex_name, _labels, _tid, _obs in fam.get("exemplars", ()):
            if fam["type"] != "histogram" or not ex_name.endswith("_bucket"):
                errors.append("exemplar on non-bucket sample %s "
                              "(family %s)" % (ex_name, name))
    return errors
