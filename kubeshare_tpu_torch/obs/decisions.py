"""Decision flight recorder: every placement decision as a replayable
trace (doc/replay.md).

The port's copy of ``kubeshare_tpu/obs/decisions.py``.

Chaos (doc/chaos.md) proved the control plane *deterministic* — same
(scenario, seed) → same timeline — but determinism is only a safety
net once the decision **inputs** are recorded, so a candidate build
can be fed the exact same history and diffed against what actually
happened. A :class:`DecisionRecorder` is that record: a bounded ring
of compact JSON entries, one per control-plane decision, captured by
hooks in the dispatcher (:meth:`~..scheduler.dispatcher.Dispatcher.
attach_decisions`), the engine (trace-id draws), the healthwatch
(state transitions), the preemption policy, and the autopilot.

Per entry: a monotonic ``seq``, an explicit-now ``t`` (the caller's
injectable clock — never a wall read), a ``kind``, and kind-specific
fields. Capacity/health views are **delta-encoded** against the
previous view entry (:meth:`DecisionRecorder.record_view` /
:func:`apply_view_delta`), rng draws go through
:meth:`DecisionRecorder.rng_draw` so replay cannot silently diverge
on entropy, and pod specs carry a short fingerprint
(:func:`fingerprint_labels`) next to the full labels.

Entry kinds, by direction:

- **inputs** (what the world did — the shadow replayer re-drives
  these): ``fleet``, ``submit``, ``delete``, ``node-health``;
- **outputs** (what the control plane decided — the decision diff
  compares these): ``outcome``, ``preempt``, ``evict``, ``move``,
  ``plan``, ``apply``, ``token-preempt``, ``gang-preempt``, ``view``,
  ``rng``.

Serialization is JSONL via :func:`trace_jsonl` /
:func:`parse_trace_jsonl` — same shape as the flight recorder's dumps
(header line + entries, ``sort_keys`` canonical), but the parser is
**torn-tail tolerant**: a trace cut mid-line (crash mid-write) drops
the torn tail and reports ``truncated`` instead of raising, because a
post-mortem trace is exactly the one most likely to be torn.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import random
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

DEFAULT_CAPACITY = 8192
TRACE_VERSION = 1

#: entry kinds the shadow replayer re-drives (everything else is an
#: output the candidate build must re-derive on its own)
INPUT_KINDS = frozenset({"fleet", "submit", "delete", "node-health"})


def fingerprint_labels(labels: dict) -> str:
    """Short stable fingerprint of a pod spec (sorted labels)."""
    blob = json.dumps(sorted((str(k), str(v)) for k, v in labels.items()))
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


class DecisionRecorder:
    """Bounded ring of control-plane decisions; record-side of replay."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 clock: Optional[Callable[[], float]] = None,
                 seed: int = 0):
        # the slow-path lock (views, rng, clear, priming); record()
        # itself is LOCK-FREE — see its docstring
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, int(capacity)))
        self._append = self._ring.append
        # fallback timestamp source only — hooks on the decision path
        # pass their explicit now; the clock covers attach-time entries
        self._clock = clock or time.time
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._seq_counter = itertools.count(1)
        self._seq = 0
        self._counts: Dict[str, int] = {}
        self._prev_view: Dict[str, str] = {}
        #: recorded draws primed by the replayer (deque of rng entries);
        #: consumed label-checked by rng_draw before the seeded fallback
        self._primed_draws: deque = deque()
        #: free-form harness metadata serialized into the trace header
        #: (tick cadence, drain bound, dispatcher config, ...)
        self.meta: Dict[str, object] = {}

    # -- configuration ---------------------------------------------------

    def set_clock(self, clock: Callable[[], float]) -> None:
        """Swap the fallback timestamp source (sim/replay virtual clock)."""
        self._clock = clock

    def prime_draws(self, rng_entries: List[dict]) -> None:
        """Feed recorded ``rng`` entries so a candidate build replays
        the *recorded* draws even if its draw order or rng algorithm
        changed; exhausted or mismatched labels fall back to the seeded
        stream (and the divergence shows up in the diff)."""
        with self._lock:
            self._primed_draws = deque(rng_entries)

    # -- recording -------------------------------------------------------

    def record(self, kind: str, now: Optional[float] = None,
               **fields) -> dict:
        """Append one decision entry; returns it (with seq + t).

        This is the hot path (one call per admission check under the
        dispatcher lock), budgeted at <=2% of that check by
        ``bench_replay`` — so it is LOCK-FREE: the seq draw
        (``itertools.count``) and the bounded-deque append are each
        GIL-atomic, entries carry their seq so readers order by it,
        drop accounting is derived (``seq - len(ring)``), and the
        per-kind counts are advisory flight-sample fodder (a lost
        increment under a rare cross-thread race skews a black-box
        delta, never the trace). Timestamp rounding and pod-spec
        fingerprints happen lazily at serialization
        (:func:`canonical_entry`)."""
        entry = fields
        entry["kind"] = kind
        entry["t"] = self._clock() if now is None else now
        entry["seq"] = self._seq = next(self._seq_counter)
        self._append(entry)
        counts = self._counts
        try:
            counts[kind] += 1
        except KeyError:
            counts[kind] = 1
        return entry

    def record_view(self, now: float, view: Dict[str, str]) -> bool:
        """Delta-encode the capacity/health view: record only keys that
        changed since the previous view entry (plus removals) — a full
        snapshot per decision would dwarf the decisions themselves.
        Returns True when a (non-empty) delta entry was recorded."""
        with self._lock:
            changed = {k: v for k, v in view.items()
                       if self._prev_view.get(k) != v}
            gone = sorted(k for k in self._prev_view if k not in view)
            if not changed and not gone:
                return False
            self._prev_view = dict(view)
        self.record("view", now, set=dict(sorted(changed.items())),
                    drop=gone)
        return True

    def rng_draw(self, label: str, now: Optional[float] = None) -> float:
        """One recorded random draw in [0, 1): the ONLY sanctioned
        entropy source on the decision path. Record mode draws from the
        seeded stream; a replayer that primed recorded draws gets those
        back instead (label-checked)."""
        with self._lock:
            while self._primed_draws:
                rec = self._primed_draws.popleft()
                if rec.get("label") == label:
                    value = float(rec.get("value", 0.0))
                    break
            else:
                value = self._rng.random()
        self.record("rng", now, label=label, value=round(value, 12))
        return value

    def rng_draw_hex(self, label: str,
                     now: Optional[float] = None) -> str:
        """A 32-hex-digit identifier derived from :meth:`rng_draw` —
        the decision-path replacement for ``uuid4().hex`` trace ids."""
        v = self.rng_draw(label, now)
        return hashlib.sha256(
            f"{self.seed}:{label}:{v:.12f}".encode()).hexdigest()[:32]

    # -- reading ---------------------------------------------------------

    @property
    def dropped(self) -> int:
        """Entries pushed out of the bounded ring (derived, not
        counted: total appends minus what the ring still holds)."""
        return max(0, self._seq - len(self._ring))

    def entries(self) -> List[dict]:
        """Ring snapshot in seq order (record() is lock-free, so under
        cross-thread interleaving ring order can trail seq order by an
        entry — the sort restores the authoritative order)."""
        return sorted((dict(e) for e in list(self._ring)),
                      key=lambda e: e["seq"])

    def counts(self) -> Dict[str, int]:
        """Per-kind entry counts since construction (not ring-bounded)."""
        return dict(self._counts)

    def state(self) -> dict:
        """Summary for ``GET /decisions`` (ring tail, not the full trace)."""
        return {
            "attached": True,
            "capacity": self._ring.maxlen,
            "ring_len": len(self._ring),
            "seq": self._seq,
            "dropped": self.dropped,
            "seed": self.seed,
            "kinds": dict(sorted(self._counts.items())),
            "recent": [canonical_entry(e)
                       for e in self.entries()[-20:]],
        }

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._counts.clear()
            self._prev_view.clear()
            self._primed_draws.clear()
            self._seq_counter = itertools.count(1)
            self._seq = 0
            self._rng = random.Random(self.seed)


# -- view-delta reconstruction -------------------------------------------


def apply_view_delta(view: Dict[str, str], entry: dict) -> Dict[str, str]:
    """Fold one ``view`` entry into a running view (inverse of
    :meth:`DecisionRecorder.record_view`'s encoding)."""
    out = dict(view)
    out.update(entry.get("set", {}))
    for k in entry.get("drop", ()):
        out.pop(k, None)
    return out


def reconstruct_views(entries: List[dict]) -> List[Dict[str, str]]:
    """The full view after each ``view`` entry, oldest-first."""
    view: Dict[str, str] = {}
    out = []
    for e in entries:
        if e.get("kind") == "view":
            view = apply_view_delta(view, e)
            out.append(view)
    return out


# -- serialization -------------------------------------------------------


def canonical_entry(entry: dict) -> dict:
    """The serialized form of one entry: timestamps rounded to the
    microsecond grid and ``submit`` entries enriched with their pod-spec
    fingerprint — both deferred off the hot recording path. Idempotent,
    so entries parsed back from a trace canonicalize to themselves."""
    e = dict(entry)
    t = e.get("t")
    if isinstance(t, float):
        e["t"] = round(t, 6)
    if e.get("kind") == "submit" and "labels" in e and "fp" not in e:
        e["fp"] = fingerprint_labels(e["labels"])
    return e


def trace_jsonl(recorder: DecisionRecorder) -> str:
    """Serialize the ring as a decision trace: header line + one line
    per entry, ``sort_keys`` so equal traces are byte-equal."""
    entries = [canonical_entry(e) for e in recorder.entries()]
    header = {"kind": "header", "version": TRACE_VERSION,
              "seed": recorder.seed, "entries": len(entries),
              "dropped": recorder.dropped,
              "meta": dict(recorder.meta)}
    lines = [json.dumps(header, sort_keys=True)]
    lines.extend(json.dumps(e, sort_keys=True) for e in entries)
    return "\n".join(lines) + "\n"


def parse_trace_jsonl(text: str, strict: bool = False) -> dict:
    """Parse a decision trace. Returns ``{"header", "entries",
    "truncated"}``. Non-strict mode is torn-tail tolerant: a final
    line cut mid-write (crash, partial flush) is dropped and flagged
    ``truncated`` instead of raising — mid-stream corruption still
    raises, a trace with a rotten middle is not trustworthy."""
    raw = [ln for ln in text.splitlines() if ln.strip()]
    if not raw:
        raise ValueError("empty decision trace")
    lines: List[dict] = []
    truncated = False
    for i, ln in enumerate(raw):
        try:
            lines.append(json.loads(ln))
        except ValueError:
            if not strict and i == len(raw) - 1:
                truncated = True
                break
            raise ValueError(
                f"decision trace corrupt at line {i + 1}") from None
    if not lines or lines[0].get("kind") != "header":
        raise ValueError("decision trace missing header")
    header, entries = lines[0], lines[1:]
    if len(entries) != header.get("entries"):
        if strict:
            raise ValueError(
                "decision trace entry count mismatch: header says "
                f"{header.get('entries')}, got {len(entries)}")
        truncated = True
    return {"header": header, "entries": entries, "truncated": truncated}


def trace_fingerprint(entries: List[dict]) -> str:
    """sha256 over the canonical serialization — the bit-identity check.
    Canonicalizing here means a live recorder's entries and the same
    trace parsed back from JSONL fingerprint identically."""
    blob = "\n".join(json.dumps(canonical_entry(e), sort_keys=True)
                     for e in entries)
    return hashlib.sha256(blob.encode()).hexdigest()


# -- process-global default ----------------------------------------------

_DEFAULT: Optional[DecisionRecorder] = None
_DEFAULT_LOCK = threading.Lock()


def default_decisions() -> DecisionRecorder:
    """Lazy process-global recorder (the service attaches it)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = DecisionRecorder()
        return _DEFAULT


def reset_for_tests() -> None:
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = None
