"""Chip-time ledger: every interval of a device's timeline accounted to
exactly one ``(tenant, tpu_class, state)`` — the port's copy of
``kubeshare_tpu/obs/ledger.py``.

The token scheduler's token is exclusive (one holder at a time —
``isolation/tokensched.py``), so a device's timeline partitions cleanly
into intervals, each in exactly one state:

- ``granted-active`` — a tenant holds the token and an execute is in
  flight (the proxy brackets ``fn()`` with execute begin/end; on the
  card ``fn()`` ends after its completion barrier, so the interval is
  device time and not launch time);
- ``granted-idle`` — the token is held but nothing is executing (the
  quantum a holder burns without work, what preemption reclaims);
- ``reserving`` — a gang's two-phase window (the JAX gang coordinator's;
  the port has no gang plane, the state is kept for parity);
- ``paused`` — grants blocked around a migration flip; shows only while
  no holder occupies the device;
- ``free`` — nobody holds the token and nothing blocks it.

Orthogonally to the state, intervals carry a ``preempted`` tag: when the
preemption plane marks a holder (``mark_preempted``), the open interval
closes at the mark and everything the holder burns *after* the mark is
tagged. The state itself stays honest; the tag is what lets the blame
graph tell "waited behind a hold" from "the holder was preempted for
you" (the ``preempted`` edge kind).

Transitions close the open interval at an explicit ``now`` and open the
next one, so the timeline has no gaps or overlaps *by construction*;
:meth:`ChipTimeLedger.check` verifies that property and the cumulative
sums. Every mutator takes ``now`` (seconds) and the ledger's own
``clock`` is injectable; live processes default to ``time.monotonic``.
The chip key is the port's device id as ``topology/discovery.py`` names
it (``TokenScheduler(chip=...)``).

The ledger feeds :mod:`.blame` (who made a grant wait).
"""

from __future__ import annotations

import threading
import time
from collections import deque

#: the states a chip interval can be in (exactly one at a time)
STATES = ("granted-active", "granted-idle", "reserving", "paused", "free")

#: states in which a specific tenant occupies the chip (blame targets)
OCCUPIED_STATES = ("granted-active", "granted-idle", "reserving")

_MAX_INTERVALS = 4096          # retained per chip (blame look-back)
_SNAPSHOT_RECENT = 32          # intervals shown in the operator view


class _ChipTimeline:
    """One chip's flag state + closed-interval history."""

    __slots__ = ("origin", "holder", "active", "paused", "preempted",
                 "open_since", "open_key", "intervals", "totals",
                 "transitions")

    def __init__(self, now: float):
        self.origin = now
        self.holder = None           # (tenant, tpu_class, gang, reserving)
        self.active = 0              # in-flight executes under the hold
        self.paused = False
        self.preempted = False       # holder marked by the preempt plane
        self.open_since = now
        self.open_key = ("", "", "free", "", False)
        self.intervals: deque = deque(maxlen=_MAX_INTERVALS)
        self.totals = {s: 0.0 for s in STATES}   # closed intervals only
        self.transitions = 0

    def resolve(self) -> tuple:
        """Current ``(tenant, tpu_class, state, gang, preempted)`` from
        the flags. A holder beats paused beats free — pause blocks
        *new* grants, so it only shows while the chip is unoccupied."""
        if self.holder is not None:
            tenant, tpu_class, gang, reserving = self.holder
            if reserving:
                state = "reserving"
            elif self.active > 0:
                state = "granted-active"
            else:
                state = "granted-idle"
            return (tenant, tpu_class, state, gang, self.preempted)
        if self.paused:
            return ("", "", "paused", "", False)
        return ("", "", "free", "", False)


class ChipTimeLedger:
    """Thread-safe chip-time accounting. ``clock`` returns seconds."""

    def __init__(self, clock=None, max_intervals: int = _MAX_INTERVALS):
        self._clock = clock or time.monotonic
        self._max_intervals = max_intervals
        self._lock = threading.Lock()
        self._chips: dict[str, _ChipTimeline] = {}

    # -- internals ----------------------------------------------------

    def _now(self, now) -> float:
        return self._clock() if now is None else float(now)

    def _chip(self, chip: str, now: float) -> _ChipTimeline:
        tl = self._chips.get(chip)
        if tl is None:
            tl = _ChipTimeline(now)
            if self._max_intervals != _MAX_INTERVALS:
                tl.intervals = deque(maxlen=self._max_intervals)
            self._chips[chip] = tl
        return tl

    def _transition(self, tl: _ChipTimeline, now: float) -> None:
        # close the open interval at `now` and open the next one at the
        # resolved state; a no-op when the state didn't change.
        now = max(now, tl.open_since)      # guard clock regression
        key = tl.resolve()
        if key == tl.open_key:
            return
        span = now - tl.open_since
        if span > 0.0:
            tl.intervals.append((tl.open_since, now) + tl.open_key)
        tl.totals[tl.open_key[2]] += span
        tl.open_since = now
        tl.open_key = key
        tl.transitions += 1

    # -- mutators (token scheduler / gang coordinator / proxy hooks) --

    def grant(self, chip: str, tenant: str, tpu_class: str = "",
              gang: str = "", now=None) -> None:
        """The chip token was granted to *tenant* (tokensched
        ``_note_grant``)."""
        now = self._now(now)
        with self._lock:
            tl = self._chip(chip, now)
            tl.holder = (tenant, tpu_class, gang, False)
            tl.preempted = False
            self._transition(tl, now)

    def release(self, chip: str, now=None) -> None:
        """The holder released the token (tokensched ``_note_release``)."""
        now = self._now(now)
        with self._lock:
            tl = self._chip(chip, now)
            tl.holder = None
            tl.active = 0
            tl.preempted = False
            self._transition(tl, now)

    def mark_preempted(self, chip: str, now=None) -> None:
        """The preemption plane marked the current holder: close the
        pre-mark portion of the hold and tag everything after — the
        holder's preempted idle-tail — until grant/release clears it.
        No-op when nobody holds the chip."""
        now = self._now(now)
        with self._lock:
            tl = self._chip(chip, now)
            if tl.holder is None:
                return
            tl.preempted = True
            self._transition(tl, now)

    def execute_begin(self, chip: str, now=None) -> None:
        now = self._now(now)
        with self._lock:
            tl = self._chip(chip, now)
            tl.active += 1
            self._transition(tl, now)

    def execute_end(self, chip: str, now=None) -> None:
        now = self._now(now)
        with self._lock:
            tl = self._chip(chip, now)
            tl.active = max(0, tl.active - 1)
            self._transition(tl, now)

    def mark_reserving(self, chip: str, tenant: str, tpu_class: str = "",
                       gang: str = "", now=None) -> None:
        """A gang reserved this chip (phase 1) but has not committed —
        overlays the plain grant the member's tokensched acquire made."""
        now = self._now(now)
        with self._lock:
            tl = self._chip(chip, now)
            tl.holder = (tenant, tpu_class, gang, True)
            tl.preempted = False
            self._transition(tl, now)

    def commit(self, chip: str, now=None) -> None:
        """The gang holding this chip committed (every member granted)."""
        now = self._now(now)
        with self._lock:
            tl = self._chip(chip, now)
            if tl.holder is not None:
                tenant, tpu_class, gang, _res = tl.holder
                tl.holder = (tenant, tpu_class, gang, False)
            self._transition(tl, now)

    def pause(self, chip: str, now=None) -> None:
        now = self._now(now)
        with self._lock:
            tl = self._chip(chip, now)
            tl.paused = True
            self._transition(tl, now)

    def unpause(self, chip: str, now=None) -> None:
        now = self._now(now)
        with self._lock:
            tl = self._chip(chip, now)
            tl.paused = False
            self._transition(tl, now)

    # -- queries ------------------------------------------------------

    def chips(self) -> list[str]:
        with self._lock:
            return sorted(self._chips)

    def account(self, chip: str, start: float, end: float,
                now=None) -> list[dict]:
        """Occupancy of ``[start, end]``: one row per overlapping
        interval (including the still-open one, clipped at ``now``) with
        the overlap in seconds — the blame graph's input.

        The JAX ledger copies every retained interval (up to
        ``max_intervals``) on each call, which the blame graph makes on
        every grant that waited: ~1.5 ms under the scheduler's lock once
        4096 are kept. The intervals are chained in time order, so the
        walk here goes back from the newest and stops at the first that
        ends by ``start``; the rows are the JAX ledger's, in its order."""
        now = self._now(now)
        out: list[dict] = []
        if end <= start:
            return out
        with self._lock:
            tl = self._chips.get(chip)
            if tl is None:
                return out
            rows = [(tl.open_since, max(now, tl.open_since)) + tl.open_key]
            for interval in reversed(tl.intervals):
                if interval[1] <= start:
                    break
                rows.append(interval)
        rows.reverse()
        for (s, e, tenant, tpu_class, state, gang, preempted) in rows:
            overlap = min(e, end) - max(s, start)
            if overlap <= 0.0:
                continue
            out.append({"overlap_s": overlap, "tenant": tenant,
                        "tpu_class": tpu_class, "state": state,
                        "gang": gang, "preempted": preempted})
        return out

    def conservation(self, now=None) -> dict:
        """Per-chip accounting totals: elapsed vs accounted, retained-
        chain gaps/overlaps, per-state sums (open interval included)."""
        now = self._now(now)
        report: dict[str, dict] = {}
        with self._lock:
            for chip, tl in self._chips.items():
                t = max(now, tl.open_since)
                by_state = dict(tl.totals)
                by_state[tl.open_key[2]] += t - tl.open_since
                gap = overlap = 0.0
                prev_end = None
                for (s, e, *_rest) in tl.intervals:
                    if prev_end is not None:
                        gap += max(0.0, s - prev_end)
                        overlap += max(0.0, prev_end - s)
                    prev_end = e
                if prev_end is not None:
                    gap += max(0.0, tl.open_since - prev_end)
                    overlap += max(0.0, prev_end - tl.open_since)
                report[chip] = {
                    "elapsed_s": t - tl.origin,
                    "accounted_s": sum(by_state.values()),
                    "gap_s": gap,
                    "overlap_s": overlap,
                    "by_state": by_state,
                    "transitions": tl.transitions,
                }
        return report

    def check(self, now=None, tolerance: float = 0.01) -> list[str]:
        """Conservation violations (empty when the ledger is sound):
        on every chip the interval chain must be gapless and
        non-overlapping and the per-state sums must equal elapsed time
        within *tolerance*."""
        problems: list[str] = []
        for chip, rep in self.conservation(now).items():
            elapsed = rep["elapsed_s"]
            slack = max(tolerance * max(elapsed, 1e-9), 1e-6)
            if rep["gap_s"] > slack:
                problems.append(f"{chip}: {rep['gap_s']:.6f}s of timeline "
                                "unaccounted (gap between intervals)")
            if rep["overlap_s"] > slack:
                problems.append(f"{chip}: intervals overlap by "
                                f"{rep['overlap_s']:.6f}s")
            if abs(rep["accounted_s"] - elapsed) > slack:
                problems.append(
                    f"{chip}: accounted {rep['accounted_s']:.6f}s != "
                    f"elapsed {elapsed:.6f}s (>{tolerance:.0%} off)")
        return problems

    def snapshot(self, now=None) -> dict:
        """Operator view: per chip its open state, per-state sums and the
        latest closed intervals."""
        now = self._now(now)
        chips: dict[str, dict] = {}
        with self._lock:
            items = list(self._chips.items())
        cons = self.conservation(now)
        with self._lock:
            for chip, tl in items:
                tenant, tpu_class, state, gang, preempted = tl.open_key
                rep = cons[chip]
                chips[chip] = {
                    "state": state,
                    "tenant": tenant,
                    "tpu_class": tpu_class,
                    "gang": gang,
                    "preempted": preempted,
                    "since_s": round(max(0.0, now - tl.open_since), 6),
                    "elapsed_s": round(rep["elapsed_s"], 6),
                    "by_state": {s: round(v, 6)
                                 for s, v in rep["by_state"].items()},
                    "transitions": tl.transitions,
                    "recent": [
                        {"start": round(s, 6), "end": round(e, 6),
                         "tenant": t, "tpu_class": c, "state": st,
                         "gang": g, "preempted": p}
                        for (s, e, t, c, st, g, p)
                        in list(tl.intervals)[-_SNAPSHOT_RECENT:]],
                }
        return {"chips": chips, "states": list(STATES)}


_default_lock = threading.Lock()
_default: ChipTimeLedger | None = None


def default_ledger() -> ChipTimeLedger:
    """Process-global ledger (a proxy built without a scheduler feeds
    it; tests build their own)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = ChipTimeLedger()
        return _default
