"""Bounded in-memory time-series store for the fleet telemetry plane.

The port's copy of ``kubeshare_tpu/obs/tsdb.py``.

The reference's telemetry loop is cluster-wide — the scheduler queries
Prometheus for *fleet* state (``pkg/scheduler/gpu.go:22-53``), not one
process's ``/metrics``. This module is the retention half of that loop:
every process remote-writes its metric snapshot (``telemetry/
remote_write.py``) into one :class:`TimeSeriesStore` hosted behind the
telemetry registry, and ``GET /query`` evaluates windowed aggregations
across instances (``topcli --fleet``, doctor freshness probes).

Design constraints, in order:

- **Bounded.** Per-series ring buffers (raw tier) plus a coarser
  downsampled tier, under hard ``max_series``/``max_bytes`` caps. When
  a cap is hit the stalest series are shed first — fleet views prefer
  losing a dead proxy's history to OOMing the registry.
- **Explicit now.** Every mutation and query takes ``now``; nothing in
  this file calls ``time.time()`` unless you let the default clock
  stand. The sim drives it on virtual time and gets deterministic
  query results.
- **Counter-reset aware.** Proxy restarts are routine (crash recovery), so
  ``rate()``/``increase()`` must not go negative across a restart:
  a sample smaller than its predecessor is treated as a reset and
  contributes its full value (Prometheus semantics).
- **Staleness markers.** A series whose newest sample is older than
  ``stale_after_s`` is excluded from queries; a registry restart must
  not resurrect it (the store is deliberately not journaled — replay
  restores capacity/pods/leases, never remote-written samples).
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .metrics import parse_exposition, quantile_from_buckets

__all__ = ["TimeSeriesStore", "SeriesKey"]

# deque of (t, v) tuples: ~100 bytes per point on CPython once the
# tuple + two floats are counted; used for the max_bytes accounting.
_BYTES_PER_POINT = 100
_BYTES_PER_SERIES = 400          # key tuples, label dict, deque headers

#: key = (family, instance, job, ((label, value), ...)) with labels
#: sorted. Instance/job sit in the key directly (not merged into the
#: labelset) so the ingest hot path never copies a dict per sample —
#: the merged view lives on the series itself for matching.
SeriesKey = Tuple[str, str, str, Tuple[Tuple[str, str], ...]]

#: cap sweeps cost O(total series); amortize them across pushes instead
#: of paying that on every 1k-sample ingest (the <1 ms/push budget)
_CAPS_EVERY_PUSHES = 16

_AGGS = ("latest", "sum", "avg", "min", "max", "rate", "increase",
         "quantile")


class _Series:
    __slots__ = ("family", "labels", "mtype", "raw", "tier", "last_tier_t",
                 "last_t", "last_v")

    def __init__(self, family: str, labels: dict, mtype: str,
                 raw_capacity: int, tier_capacity: int):
        self.family = family
        self.labels = labels
        self.mtype = mtype
        self.raw: deque = deque(maxlen=raw_capacity)
        self.tier: deque = deque(maxlen=tier_capacity)
        self.last_tier_t = -math.inf
        self.last_t = -math.inf
        self.last_v = 0.0


class TimeSeriesStore:
    """Ring-buffer TSDB keyed by (family, labelset incl. instance/job)."""

    def __init__(self,
                 retention_s: float = 600.0,
                 raw_capacity: int = 128,
                 tier_resolution_s: float = 30.0,
                 tier_capacity: int = 64,
                 stale_after_s: float = 30.0,
                 max_series: int = 100_000,
                 max_bytes: int = 64 << 20,
                 clock: Optional[Callable[[], float]] = None):
        self.retention_s = float(retention_s)
        self.raw_capacity = int(raw_capacity)
        self.tier_resolution_s = float(tier_resolution_s)
        self.tier_capacity = int(tier_capacity)
        self.stale_after_s = float(stale_after_s)
        self.max_series = int(max_series)
        self.max_bytes = int(max_bytes)
        self._clock = clock
        self._lock = threading.Lock()
        self._series: Dict[SeriesKey, _Series] = {}
        self._types: Dict[str, str] = {}          # family -> metric type
        # instance -> {"job", "last_push_t", "pushes", "samples"}
        self._instances: Dict[str, dict] = {}
        self._stale_marked: set = set()           # explicitly retired
        self.pushes = 0
        self.samples_ingested = 0

    # -- clock ---------------------------------------------------------------

    def _now(self, now: Optional[float]) -> float:
        if now is not None:
            return float(now)
        if self._clock is not None:
            return float(self._clock())
        import time
        return time.time()

    # -- ingest --------------------------------------------------------------

    def ingest(self, instance: str, job: str, snapshot: Optional[dict] = None,
               exposition: Optional[str] = None,
               now: Optional[float] = None) -> int:
        """Ingest one remote-write push for ``instance``.

        ``snapshot`` is the compact ``MetricsRegistry.collect()`` shape
        (the fast path); ``exposition`` is Prometheus text (compat path
        for processes that only have a rendered page). Returns the
        number of samples stored.
        """
        t = self._now(now)
        if snapshot is not None:
            types = dict(snapshot.get("families", {}))
            samples = snapshot.get("samples", [])
        elif exposition is not None:
            families = parse_exposition(exposition)
            types, samples = {}, []
            for fam, data in families.items():
                types[fam] = data.get("type") or "untyped"
                samples.extend(data["samples"])
        else:
            raise ValueError("ingest needs a snapshot or exposition text")
        n, created = self._ingest_samples(instance, job, samples, types, t)
        with self._lock:
            self.pushes += 1
            self.samples_ingested += n
            inst = self._instances.setdefault(
                instance, {"job": job, "pushes": 0, "samples": 0})
            inst["job"] = job
            inst["last_push_t"] = t
            inst["pushes"] += 1
            inst["samples"] = n
            self._stale_marked.discard(instance)
        # cap sweeps are O(total series): amortized to every Nth push,
        # plus any push that created series (the only way to jump caps)
        if created or self.pushes % _CAPS_EVERY_PUSHES == 0:
            self._enforce_caps(t)
        return n

    def _ingest_samples(self, instance: str, job: str,
                        samples: Sequence[Tuple[str, dict, float]],
                        types: Dict[str, str],
                        t: float) -> Tuple[int, bool]:
        n = 0
        created = False
        with self._lock:
            for fam, mtype in types.items():
                self._types[fam] = mtype
            series_get = self._series.get
            series_map = self._series
            tier_res = self.tier_resolution_s
            for name, labels, value in samples:
                # 0/1-label sets (the common case) skip the sort
                if not labels:
                    lkey = ()
                elif len(labels) == 1:
                    lkey = tuple(labels.items())
                else:
                    lkey = tuple(sorted(labels.items()))
                key = (name, instance, job, lkey)
                series = series_get(key)
                if series is None:
                    full = dict(labels)
                    full["instance"] = instance
                    full["job"] = job
                    series = series_map[key] = _Series(
                        name, full, self._type_of(name, types),
                        self.raw_capacity, self.tier_capacity)
                    created = True
                if t < series.last_t:
                    continue          # out-of-order push: drop, not rewind
                v = float(value)
                series.raw.append((t, v))
                series.last_t = t
                series.last_v = v
                if t - series.last_tier_t >= tier_res:
                    series.tier.append((t, v))
                    series.last_tier_t = t
                n += 1
        return n, created

    def _type_of(self, name: str, types: Dict[str, str]) -> str:
        if name in types:
            return types[name]
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix):
                base = name[:-len(suffix)]
                if types.get(base) == "histogram":
                    return "histogram"
        return "untyped"

    def mark_stale(self, instance: str) -> None:
        """Explicit staleness marker: retire an instance's series now
        (clean unregister / eviction), without waiting out
        ``stale_after_s``. Cleared by the instance's next push."""
        with self._lock:
            self._stale_marked.add(instance)

    # -- caps ----------------------------------------------------------------

    def bytes_estimate(self) -> int:
        with self._lock:
            return sum(_BYTES_PER_SERIES
                       + (len(s.raw) + len(s.tier)) * _BYTES_PER_POINT
                       for s in self._series.values())

    def series_count(self) -> int:
        with self._lock:
            return len(self._series)

    def _enforce_caps(self, now: float) -> None:
        with self._lock:
            # drop points past retention from the coarse tier (the raw
            # ring ages out by capacity on its own)
            horizon = now - self.retention_s
            for s in self._series.values():
                while s.tier and s.tier[0][0] < horizon:
                    s.tier.popleft()
            over_series = len(self._series) - self.max_series
            est = sum(_BYTES_PER_SERIES
                      + (len(s.raw) + len(s.tier)) * _BYTES_PER_POINT
                      for s in self._series.values())
            if over_series <= 0 and est <= self.max_bytes:
                return
            # shed stalest series first
            by_age = sorted(self._series.items(),
                            key=lambda kv: kv[1].last_t)
            for key, s in by_age:
                if (len(self._series) <= self.max_series
                        and est <= self.max_bytes):
                    break
                est -= (_BYTES_PER_SERIES
                        + (len(s.raw) + len(s.tier)) * _BYTES_PER_POINT)
                del self._series[key]

    # -- introspection -------------------------------------------------------

    def instances(self, now: Optional[float] = None) -> List[dict]:
        """Push freshness per known instance (doctor's freshness probe)."""
        t = self._now(now)
        with self._lock:
            out = []
            for name in sorted(self._instances):
                inst = self._instances[name]
                age = t - inst.get("last_push_t", -math.inf)
                out.append({
                    "instance": name,
                    "job": inst.get("job", ""),
                    "last_push_t": inst.get("last_push_t"),
                    "age_s": round(age, 3),
                    "pushes": inst.get("pushes", 0),
                    "samples": inst.get("samples", 0),
                    "stale": (name in self._stale_marked
                              or age > self.stale_after_s),
                })
            return out

    def families(self) -> List[str]:
        with self._lock:
            return sorted({s.family for s in self._series.values()})

    def stats(self) -> dict:
        with self._lock:
            n_series = len(self._series)
            n_points = sum(len(s.raw) + len(s.tier)
                           for s in self._series.values())
        return {"series": n_series, "points": n_points,
                "pushes": self.pushes,
                "samples_ingested": self.samples_ingested,
                "bytes_estimate": self.bytes_estimate(),
                "instances": len(self._instances)}

    # -- query ---------------------------------------------------------------

    def _match(self, family: str, matchers: Optional[dict],
               now: float) -> List[_Series]:
        out = []
        for s in self._series.values():
            if s.family != family:
                continue
            if s.labels.get("instance") in self._stale_marked:
                continue
            if now - s.last_t > self.stale_after_s:
                continue
            if matchers and any(s.labels.get(k) != str(v)
                                for k, v in matchers.items()):
                continue
            out.append(s)
        return out

    @staticmethod
    def _points(series: _Series, start: float,
                end: float) -> List[Tuple[float, float]]:
        """Merged tier+raw points in [start, end], oldest first.

        The coarse tier covers history the raw ring has already aged
        out; raw wins wherever both tiers hold the window.
        """
        raw = [(t, v) for t, v in series.raw if start <= t <= end]
        raw_oldest = series.raw[0][0] if series.raw else math.inf
        tier = [(t, v) for t, v in series.tier
                if start <= t <= end and t < raw_oldest]
        return tier + raw

    @staticmethod
    def _increase(points: Sequence[Tuple[float, float]]) -> float:
        """Counter increase over the points, reset-aware.

        A sample below its predecessor means the counter restarted
        (proxy crash/restart): the post-reset value counts in full.
        """
        inc, prev = 0.0, None
        for _, v in points:
            if prev is not None:
                inc += v - prev if v >= prev else v
            prev = v
        return inc

    def query(self, family: str, agg: str = "latest",
              window_s: float = 60.0,
              matchers: Optional[dict] = None,
              by: Sequence[str] = (),
              q: float = 0.99,
              now: Optional[float] = None) -> dict:
        """Evaluate one windowed aggregation across matching series.

        ``agg``:
        - ``latest``/``sum``: sum of each series' newest in-window value
        - ``avg``/``min``/``max``: across each series' newest value
        - ``rate``/``increase``: reset-aware counter delta over the
          window, summed across series (rate divides by ``window_s``)
        - ``quantile``: histogram quantile ``q`` from the family's
          ``_bucket`` series, computed over the *windowed increase* of
          each bucket so restarts can't produce negative bucket deltas

        ``by`` groups the result by those label names (e.g.
        ``by=("instance",)``); default is one fleet-wide group.
        """
        if agg not in _AGGS:
            raise ValueError("unknown agg %r (one of %s)"
                             % (agg, ", ".join(_AGGS)))
        t = self._now(now)
        start = t - float(window_s)
        lookup_family = family + "_bucket" if agg == "quantile" else family
        with self._lock:
            matched = self._match(lookup_family, matchers, t)
            groups: Dict[Tuple[str, ...], List[_Series]] = {}
            for s in matched:
                gkey = tuple(s.labels.get(k, "") for k in by)
                groups.setdefault(gkey, []).append(s)
            results = []
            for gkey in sorted(groups):
                members = groups[gkey]
                value = self._aggregate(members, agg, start, t,
                                        window_s, q)
                results.append({"labels": dict(zip(by, gkey)),
                                "value": value,
                                "series": len(members)})
        return {"family": family, "agg": agg, "window_s": float(window_s),
                "q": q if agg == "quantile" else None,
                "now": t, "series_matched": len(matched),
                "groups": results}

    def _aggregate(self, members: List[_Series], agg: str, start: float,
                   end: float, window_s: float, q: float):
        if agg == "quantile":
            return self._bucket_quantile(members, start, end, q)
        if agg in ("rate", "increase"):
            total = 0.0
            for s in members:
                total += self._increase(self._points(s, start, end))
            return total / window_s if agg == "rate" else total
        # instant aggs over each series' newest in-window value
        latest = []
        for s in members:
            pts = self._points(s, start, end)
            if pts:
                latest.append(pts[-1][1])
        if not latest:
            return None
        if agg in ("latest", "sum"):
            return sum(latest)
        if agg == "avg":
            return sum(latest) / len(latest)
        if agg == "min":
            return min(latest)
        return max(latest)

    def _bucket_quantile(self, members: List[_Series], start: float,
                         end: float, q: float):
        """histogram_quantile over summed per-``le`` windowed increases."""
        by_le: Dict[float, float] = {}
        for s in members:
            le = s.labels.get("le")
            if le is None:
                continue
            bound = math.inf if le in ("+Inf", "inf") else float(le)
            pts = self._points(s, start, end)
            # cumulative-bucket counters: the windowed increase per
            # bucket is itself cumulative across le once summed
            by_le[bound] = by_le.get(bound, 0.0) + self._increase(pts)
        if not by_le:
            return None
        bounds = sorted(by_le)
        cumulative = [by_le[b] for b in bounds]
        # per-le increases of cumulative buckets stay cumulative, but
        # guard against float jitter breaking monotonicity
        for i in range(1, len(cumulative)):
            if cumulative[i] < cumulative[i - 1]:
                cumulative[i] = cumulative[i - 1]
        if cumulative[-1] <= 0:
            return None
        val = quantile_from_buckets(bounds, cumulative, q)
        return None if val != val else val

    def range_query(self, family: str, agg: str = "sum",
                    window_s: float = 60.0, step_s: float = 10.0,
                    span_s: float = 300.0,
                    matchers: Optional[dict] = None,
                    q: float = 0.99,
                    now: Optional[float] = None) -> dict:
        """Instant query evaluated at each step over ``span_s`` —
        the sparkline feed for ``topcli --fleet --watch``."""
        t = self._now(now)
        steps = max(1, int(span_s / step_s))
        points = []
        for i in range(steps, -1, -1):
            at = t - i * step_s
            res = self.query(family, agg=agg, window_s=window_s,
                             matchers=matchers, by=(), q=q, now=at)
            value = res["groups"][0]["value"] if res["groups"] else None
            points.append({"t": at, "value": value})
        return {"family": family, "agg": agg, "window_s": float(window_s),
                "step_s": float(step_s), "now": t, "points": points}
