"""Cross-process critical-path attribution for a traced request — the
port's copy of ``kubeshare_tpu/obs/critpath.py``.

One request's wall time is spent across at least two processes — the
client or front door (admission, transport) and the chip proxy (token
grant-wait, execute). Each process exports spans sharing the request's
trace id (``obs/trace.py``), but each process's tracer has its *own*
monotonic epoch: timestamps from two sources are not comparable, so
naive timeline stitching is wrong by whatever the epoch skew is.

This module therefore attributes by *durations*, not absolute
alignment:

- spans are merged from any number of sources (span JSONL exports,
  flight-recorder dumps/rings) and grouped by trace id;
- each span name maps to one named segment (``SEGMENT_OF``);
- within one (source, segment) pair overlapping spans are
  interval-unioned, so a parent and its child never double-count;
- segment durations are summed across sources;
- the ``transport`` segment is client-measured round-trip time and
  therefore *envelops* the server-side ``execute`` work it carried —
  the enveloped time is subtracted (``ENVELOPES``) so the segments
  partition the wall clock instead of overlapping it;
- the chip proxy's ``execute`` span is its handler time, the token
  wait inside it included (the JAX proxy records it so, and the port's
  the same), so after the transport envelope has used the whole of it
  the ``grant-wait`` it holds is taken out of it (``HELD_BY_SOURCE``).

The last rule is the one place the port parts from the JAX module on
purpose: without it a proxy request's grant wait is counted twice, once
as ``grant-wait`` and once inside ``execute``, and only the clamp of the
attributed time at the wall time hides it.

Wall time is the root span's duration (``submit``, or an explicit
``request`` span from a client or front door). Coverage is the
attributed fraction of wall time.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["SEGMENTS", "SEGMENT_OF", "ROOT_NAMES", "load_spans",
           "spans_from_flight_entries", "assemble", "report",
           "render_report"]

#: attribution order — also the display order of :func:`render_report`
SEGMENTS = ("admission", "queue-wait", "schedule", "grant-wait",
            "transport", "execute")

#: span name -> segment. Span names not listed here (migrate, autopilot
#: moves, ...) are ignored: they are not part of the submit→reply path.
SEGMENT_OF = {
    "admission": "admission",
    "queue-wait": "queue-wait",
    "gang-wait": "queue-wait",
    "filter": "schedule",
    "reserve": "schedule",
    "bind": "schedule",
    "token-grant": "grant-wait",
    "transport": "transport",
    "execute": "execute",
    "serve-batch": "execute",
    "step": "execute",
}

#: root span candidates, in preference order
ROOT_NAMES = ("submit", "request")

#: client-measured segments that envelop server-side segments for the
#: same trace: attributed transport = raw transport − enveloped time
#: (clamped at 0), because the client's RPC round-trip span contains
#: the proxy's execute service time.
ENVELOPES = {"transport": ("execute",)}

#: (source, segment) -> segments its spans hold: the chip proxy's
#: execute handler waits for the token inside, so the grant wait is taken
#: out of the execute segment (clamped at what the proxy's spans hold)
HELD_BY_SOURCE = {("chipproxy", "execute"): ("grant-wait",)}


# -- loading -----------------------------------------------------------------

def _span_row(d: dict, source: str) -> Optional[dict]:
    """Normalize one JSON object into a span row, or None to skip."""
    if "name" not in d or "trace_id" not in d or "start_ms" not in d:
        return None
    end = d.get("end_ms")
    if end is None:
        return None                       # open span: no duration to give
    attrs = d.get("attrs") or {}
    return {
        "name": str(d["name"]),
        "trace_id": str(d["trace_id"]),
        "span_id": str(d.get("span_id", "")),
        "parent_id": str(d.get("parent_id", "") or ""),
        "start_ms": float(d["start_ms"]),
        "end_ms": float(end),
        "source": str(attrs.get("proc") or source),
        "attrs": attrs,
    }


def spans_from_flight_entries(entries: Iterable[dict],
                              source: str = "flight") -> List[dict]:
    """Span rows from flight-recorder ring entries (``kind == "span"``)."""
    out = []
    for e in entries:
        if e.get("kind") != "span":
            continue
        row = _span_row(e, source)
        if row is not None:
            out.append(row)
    return out


def load_spans(paths: Sequence[str]) -> List[dict]:
    """Load spans from JSONL files — tracer exports or flight dumps.

    A tracer export is one span object per line; a flight dump starts
    with a ``{"kind": "trigger"}`` header and mixes spans with notes/
    alerts/deltas. Both are handled; the file's basename becomes the
    span's source unless the span carries a ``proc`` attr.
    """
    spans: List[dict] = []
    for path in paths:
        source = os.path.splitext(os.path.basename(path))[0]
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                d = json.loads(line)
                if d.get("kind") is not None:
                    if d["kind"] == "span":
                        row = _span_row(d, source)
                        if row is not None:
                            spans.append(row)
                    continue               # trigger header / note / alert
                row = _span_row(d, source)
                if row is not None:
                    spans.append(row)
    return spans


# -- assembly ----------------------------------------------------------------

def _interval_union_ms(intervals: List[Tuple[float, float]]) -> float:
    """Total covered time of possibly-overlapping [start, end] intervals."""
    if not intervals:
        return 0.0
    intervals.sort()
    total, cur_s, cur_e = 0.0, intervals[0][0], intervals[0][1]
    for s, e in intervals[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s)


def _pick_root(rows: List[dict]) -> Optional[dict]:
    for name in ROOT_NAMES:
        candidates = [r for r in rows if r["name"] == name]
        if candidates:
            # prefer a true root (no parent); else the longest
            roots = [r for r in candidates if not r["parent_id"]]
            pool = roots or candidates
            return max(pool, key=lambda r: r["end_ms"] - r["start_ms"])
    return None


def assemble(spans: Sequence[dict],
             trace_id: Optional[str] = None) -> List[dict]:
    """Group spans by trace and attribute wall time to segments.

    Returns one dict per trace that has a root span: ``{trace_id,
    wall_ms, segments: {name: ms}, attributed_ms, residual_ms,
    coverage, sources, spans}``. Traces without a root are skipped —
    there is no wall clock to attribute against.
    """
    by_trace: Dict[str, List[dict]] = {}
    for row in spans:
        by_trace.setdefault(row["trace_id"], []).append(row)
    out = []
    for tid in sorted(by_trace):
        if trace_id is not None and tid != trace_id:
            continue
        rows = by_trace[tid]
        root = _pick_root(rows)
        if root is None:
            continue
        wall_ms = root["end_ms"] - root["start_ms"]
        # (source, segment) -> intervals, unioned so nested spans from
        # the same process never double-count
        buckets: Dict[Tuple[str, str], List[Tuple[float, float]]] = {}
        for r in rows:
            if r is root:
                continue
            seg = SEGMENT_OF.get(r["name"])
            if seg is None:
                continue
            buckets.setdefault((r["source"], seg), []).append(
                (r["start_ms"], r["end_ms"]))
        segments = {seg: 0.0 for seg in SEGMENTS}
        for (_, seg), intervals in buckets.items():
            segments[seg] += _interval_union_ms(intervals)
        for env, inner in ENVELOPES.items():
            if segments.get(env, 0.0) > 0.0:
                inner_present = any(
                    seg in inner for (_, seg) in buckets)
                if not inner_present:
                    # The envelope is client-measured round-trip time;
                    # without the server-side spans it carried (proxy
                    # never pushed its export) we cannot split wire time
                    # from service time. Attributing the whole RTT to
                    # transport would blame the network for chip work —
                    # drop the segment to residual so coverage degrades
                    # honestly instead of misattributing.
                    segments[env] = 0.0
                    continue
                carried = sum(segments.get(i, 0.0) for i in inner)
                segments[env] = max(0.0, segments[env] - carried)
        for (src, seg), inner in HELD_BY_SOURCE.items():
            intervals = buckets.get((src, seg))
            if intervals:
                held = min(_interval_union_ms(intervals),
                           sum(segments.get(i, 0.0) for i in inner))
                segments[seg] = max(0.0, segments[seg] - held)
        attributed = min(sum(segments.values()), wall_ms)
        residual = max(0.0, wall_ms - attributed)
        out.append({
            "trace_id": tid,
            "wall_ms": round(wall_ms, 3),
            "segments": {k: round(v, 3) for k, v in segments.items()},
            "attributed_ms": round(attributed, 3),
            "residual_ms": round(residual, 3),
            "coverage": round(attributed / wall_ms, 4) if wall_ms > 0
            else 0.0,
            "sources": sorted({r["source"] for r in rows}),
            "spans": len(rows),
        })
    return out


# -- reporting ---------------------------------------------------------------

def _percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (deterministic, no interpolation)."""
    if not values:
        return float("nan")
    ordered = sorted(values)
    rank = max(1, math.ceil(q * len(ordered)))
    return ordered[min(rank, len(ordered)) - 1]


def report(traces: Sequence[dict]) -> dict:
    """Aggregate per-segment p50/p99 + coverage over assembled traces."""
    segs = {}
    for seg in SEGMENTS:
        values = [t["segments"].get(seg, 0.0) for t in traces]
        shares = [t["segments"].get(seg, 0.0) / t["wall_ms"]
                  for t in traces if t["wall_ms"] > 0]
        segs[seg] = {
            "p50_ms": round(_percentile(values, 0.50), 3) if values else None,
            "p99_ms": round(_percentile(values, 0.99), 3) if values else None,
            "share": round(sum(shares) / len(shares), 4) if shares else 0.0,
        }
    coverages = [t["coverage"] for t in traces]
    walls = [t["wall_ms"] for t in traces]
    sources: set = set()
    for t in traces:
        sources.update(t["sources"])
    return {
        "traces": len(traces),
        "sources": sorted(sources),
        "wall_p50_ms": round(_percentile(walls, 0.50), 3) if walls else None,
        "wall_p99_ms": round(_percentile(walls, 0.99), 3) if walls else None,
        "coverage_mean": (round(sum(coverages) / len(coverages), 4)
                          if coverages else 0.0),
        "coverage_min": round(min(coverages), 4) if coverages else 0.0,
        "segments": segs,
    }


def render_report(rep: dict, traces: Sequence[dict] = ()) -> str:
    """Human-readable breakdown of :func:`report`."""
    lines = []
    lines.append("critical path  %d trace(s) across %d source(s): %s"
                 % (rep["traces"], len(rep["sources"]),
                    ", ".join(rep["sources"]) or "-"))
    if not rep["traces"]:
        lines.append("  (no complete traces — is a root 'submit'/'request' "
                     "span present?)")
        return "\n".join(lines) + "\n"
    lines.append("  wall  p50 %8.1f ms   p99 %8.1f ms   coverage mean "
                 "%5.1f%%  min %5.1f%%"
                 % (rep["wall_p50_ms"], rep["wall_p99_ms"],
                    rep["coverage_mean"] * 100.0,
                    rep["coverage_min"] * 100.0))
    lines.append("  %-12s %10s %10s %8s" % ("segment", "p50 ms", "p99 ms",
                                            "share"))
    for seg in SEGMENTS:
        s = rep["segments"][seg]
        bar = "#" * int(round(s["share"] * 30))
        lines.append("  %-12s %10.1f %10.1f %7.1f%%  %s"
                     % (seg, s["p50_ms"], s["p99_ms"],
                        s["share"] * 100.0, bar))
    if traces:
        worst = min(traces, key=lambda t: t["coverage"])
        lines.append("  worst-covered trace %s: %.1f%% of %.1f ms "
                     "(%.1f ms unattributed)"
                     % (worst["trace_id"][:8], worst["coverage"] * 100.0,
                        worst["wall_ms"], worst["residual_ms"]))
    return "\n".join(lines) + "\n"
