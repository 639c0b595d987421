"""Always-on flight recorder: a bounded black box of recent activity —
the port's copy of ``kubeshare_tpu/obs/flight.py``.

A :class:`FlightRecorder` keeps a fixed-size ring of what the process
was doing *just now*: completed spans (fed by the ``obs.trace`` span
sink, so they arrive even when no real tracer is installed), subsystem
notes (session detaches and resumes, sheds, parks), SLO alert
transitions, and rate-limited per-subsystem counter deltas. It records
continuously at one deque append per entry; nothing is written anywhere
until a *trigger* fires.

A trigger — an SLO alert firing, a crash handler — calls
:meth:`FlightRecorder.trigger`, which freezes the ring into a dump: the
black box of the seconds leading up to the event. Recent dumps stay in
memory and are optionally persisted one file per trigger under
``dump_dir``.

Dump format (one JSON object per line):

- line 1: ``{"kind": "trigger", "reason": ..., "t": ..., "seq": ...,
  "entries": N}``
- lines 2..N+1: ring entries oldest-first, each with ``kind`` one of
  ``span`` / ``note`` / ``alert`` / ``delta`` and a wall-clock ``t``.

The process-global default recorder is installed as a span sink at
import time — the recorder is *always on*.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from .trace import Span, add_span_sink

DEFAULT_CAPACITY = 2048
MAX_RETAINED_DUMPS = 8
#: on-disk retention under ``dump_dir`` — unlike the in-memory deque,
#: files used to accumulate forever; pruned oldest-mtime-first past this
MAX_DUMP_FILES = 32


class FlightRecorder:
    """Bounded ring of recent spans/notes/alerts/deltas + dump-on-trigger."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 clock: Optional[Callable[[], float]] = None,
                 dump_dir: Optional[str] = None,
                 max_dump_files: int = MAX_DUMP_FILES):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, int(capacity)))
        self._clock = clock or time.time
        self._dump_dir = dump_dir
        self._max_dump_files = max(1, int(max_dump_files))
        self._dumps: deque = deque(maxlen=MAX_RETAINED_DUMPS)
        self._seq = 0
        self._dropped = 0
        # per-subsystem previous counter snapshot for delta sampling
        self._delta_prev: Dict[str, Dict[str, float]] = {}
        self._delta_last_t: Dict[str, float] = {}

    # -- configuration -------------------------------------------------------

    def set_clock(self, clock: Callable[[], float]) -> None:
        """Swap the timestamp source (a virtual clock in tests)."""
        self._clock = clock

    def set_dump_dir(self, path: Optional[str]) -> None:
        self._dump_dir = path

    def set_dump_retention(self, max_files: int) -> None:
        """Cap on persisted ``flight-*.jsonl`` files (oldest pruned)."""
        self._max_dump_files = max(1, int(max_files))

    # -- recording -----------------------------------------------------------

    def _append(self, entry: dict) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
            self._ring.append(entry)

    def on_span(self, span: Span) -> None:
        """Span-sink callback: every completed span lands in the ring."""
        self._append({
            "kind": "span", "t": self._clock(), "name": span.name,
            "trace_id": span.trace_id, "span_id": span.span_id,
            "start_ms": round(span.start_ms, 3),
            "end_ms": None if span.end_ms is None else round(span.end_ms, 3),
            "attrs": dict(span.attrs),
        })

    def note(self, subsystem: str, event: str, **attrs) -> None:
        """One-off subsystem event (eviction, detach, rollback, ...)."""
        self._append({"kind": "note", "t": self._clock(),
                      "subsystem": subsystem, "event": event,
                      "attrs": attrs})

    def alert(self, event: dict) -> None:
        """SLO alert transition (wired as an SloEvaluator listener)."""
        self._append(dict(event, kind="alert", t=event.get("t",
                                                           self._clock())))

    def sample_deltas(self, subsystem: str,
                      values: Dict[str, float],
                      min_interval_s: float = 5.0) -> bool:
        """Record deltas of monotonic counters since the last sample.

        Called from natural periodic sites (proxy idle watchdog,
        token-scheduler release, blame ingestion); rate-limited so hot paths
        can call it unconditionally. Returns True when a delta entry
        was recorded.
        """
        now = self._clock()
        with self._lock:
            last = self._delta_last_t.get(subsystem)
            if last is not None and now - last < min_interval_s:
                return False
            self._delta_last_t[subsystem] = now
            prev = self._delta_prev.get(subsystem, {})
            self._delta_prev[subsystem] = dict(values)
        deltas = {k: round(v - prev.get(k, 0.0), 6)
                  for k, v in values.items()}
        self._append({"kind": "delta", "t": now, "subsystem": subsystem,
                      "deltas": deltas})
        return True

    # -- triggering / reading ------------------------------------------------

    def trigger(self, reason: str, **attrs) -> dict:
        """Freeze the ring into a dump; retain it and optionally persist."""
        with self._lock:
            entries = list(self._ring)
            self._seq += 1
            seq = self._seq
            dropped = self._dropped
        dump = {
            "reason": reason, "t": self._clock(), "seq": seq,
            "entries": entries, "dropped": dropped, "attrs": attrs,
        }
        with self._lock:
            self._dumps.append(dump)
        if self._dump_dir:
            try:
                os.makedirs(self._dump_dir, exist_ok=True)
                path = os.path.join(self._dump_dir,
                                    "flight-%06d.jsonl" % seq)
                with open(path, "w") as fh:
                    fh.write(dump_jsonl(dump))
                dump["path"] = path
                self._prune_dump_files()
            except OSError:
                pass          # the in-memory dump is still authoritative
        return dump

    def _prune_dump_files(self) -> None:
        """Keep at most ``max_dump_files`` dumps on disk, oldest-mtime
        first. The sequence number restarts with the process, so mtime
        — not the filename — is the age that matters across restarts."""
        try:
            names = [n for n in os.listdir(self._dump_dir)
                     if n.startswith("flight-") and n.endswith(".jsonl")]
        except OSError:
            return
        if len(names) <= self._max_dump_files:
            return
        paths = []
        for n in names:
            p = os.path.join(self._dump_dir, n)
            try:
                paths.append((os.path.getmtime(p), p))
            except OSError:
                continue
        paths.sort()
        for _, p in paths[:max(0, len(paths) - self._max_dump_files)]:
            try:
                os.remove(p)
            except OSError:
                pass

    def dumps(self) -> List[dict]:
        with self._lock:
            return list(self._dumps)

    def last_dump(self) -> Optional[dict]:
        with self._lock:
            return self._dumps[-1] if self._dumps else None

    def ring(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._dumps.clear()
            self._delta_prev.clear()
            self._delta_last_t.clear()
            self._dropped = 0

    def state(self) -> dict:
        """Summary of the recorder (without the full rings)."""
        with self._lock:
            return {
                "capacity": self._ring.maxlen,
                "ring_len": len(self._ring),
                "dropped": self._dropped,
                "dumps": [{"reason": d["reason"], "t": d["t"],
                           "seq": d["seq"],
                           "entries": len(d["entries"])}
                          for d in self._dumps],
            }


def dump_jsonl(dump: dict) -> str:
    """Serialize one dump as JSONL: trigger header, then ring entries."""
    header = {"kind": "trigger", "reason": dump["reason"], "t": dump["t"],
              "seq": dump["seq"], "entries": len(dump["entries"]),
              "dropped": dump.get("dropped", 0),
              "attrs": dump.get("attrs", {})}
    lines = [json.dumps(header, sort_keys=True)]
    lines.extend(json.dumps(e, sort_keys=True) for e in dump["entries"])
    return "\n".join(lines) + "\n"


def parse_dump_jsonl(text: str) -> dict:
    """Inverse of :func:`dump_jsonl` — how a dump on disk is read back."""
    lines = [json.loads(line) for line in text.splitlines() if line.strip()]
    if not lines or lines[0].get("kind") != "trigger":
        raise ValueError("flight dump missing trigger header")
    header = lines[0]
    if len(lines) - 1 != header.get("entries"):
        raise ValueError("flight dump entry count mismatch: header says "
                         "%s, got %d" % (header.get("entries"),
                                         len(lines) - 1))
    return {"reason": header["reason"], "t": header["t"],
            "seq": header["seq"], "dropped": header.get("dropped", 0),
            "attrs": header.get("attrs", {}), "entries": lines[1:]}


_DEFAULT = FlightRecorder()
add_span_sink(_DEFAULT.on_span)     # always on


def default_recorder() -> FlightRecorder:
    return _DEFAULT


_orig_excepthook = None


def install_crash_handler(recorder: Optional[FlightRecorder] = None) -> None:
    """Dump the black box on an unhandled exception, then re-raise."""
    import sys
    global _orig_excepthook
    rec = recorder or _DEFAULT
    if _orig_excepthook is None:
        _orig_excepthook = sys.excepthook

    def _hook(exc_type, exc, tb):
        try:
            rec.trigger("crash", error=exc_type.__name__,
                        detail=str(exc)[:200])
        except Exception:
            pass
        _orig_excepthook(exc_type, exc, tb)

    sys.excepthook = _hook
