"""Runtime contention profiler: tracked locks, phase attribution, stacks
— the port's copy of ``kubeshare_tpu/obs/prof.py``.

Three legs:

- **Tracked locks** — :class:`TrackedLock` / :class:`TrackedRLock` /
  :class:`TrackedCondition`, drop-in wrappers over the stdlib
  primitives with an injectable clock. They record per-lock wait/hold
  accounting (exact wait totals, gap-weighted sampled hold totals),
  holder-site attribution (top caller by cumulative hold), and a
  current-holder snapshot. All accounting runs while holding the lock
  being measured: wait is recorded just after a contended acquire
  succeeds, hold just before release — so the lock serializes its own
  bookkeeping. The uncontended fast path is one ``acquire(False)``
  try, a counter bump, and a sampling branch — clock reads, site
  capture and hold timing happen only on the 1-in-8 sampled acquires
  (each sample weighted by the acquire gap it covers, so totals stay
  unbiased); with the profiler disabled the wrappers degenerate to a
  delegated acquire/release and an owner stamp. The token scheduler's
  condition (``"tokensched"``) and the serving front door's lock
  (``"frontdoor"``) are tracked.
- **Phase attribution** — :class:`PhaseProfiler` brackets a long-held
  critical section into named sequential phases with lap-timer
  semantics: every instant between span start and close is attributed
  to exactly one phase. Phases are measured on a *wall* clock
  (``time.perf_counter``) even when the surrounding component runs on
  an injected virtual clock.
- **Sampling wall profiler** — :class:`StackSampler` walks
  ``sys._current_frames()`` on a cadence and aggregates every thread's
  stack into folded-stack counts (``thread;outer;inner N``), exportable
  as speedscope JSON.

Metric families (exported by :func:`sync_metrics`, which flushes the
exact per-lock accumulators into the process-wide default registry):

- ``kubeshare_lock_wait_seconds{lock}`` — histogram of *contended*
  acquire waits (uncontended acquires observe nothing).
- ``kubeshare_lock_hold_seconds{lock}`` — histogram of *sampled* hold
  times (1-in-8 uncontended plus every contended acquire).
- ``kubeshare_lock_waited_seconds_total{lock}`` — exact cumulative
  wait seconds.
- ``kubeshare_lock_held_seconds_total{lock}`` — gap-weighted estimate
  of cumulative hold seconds (exact whenever every acquire is sampled).
- ``kubeshare_lock_acquisitions_total{lock}`` /
  ``kubeshare_lock_contended_total{lock}``.
- ``kubeshare_prof_phase_seconds_total{phase}`` — per-phase time;
  ``kubeshare_prof_span_seconds_total`` is the denominator.
- ``kubeshare_prof_stack_samples_total`` — sampler liveness.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import weakref
from threading import get_ident
from typing import Dict, List, Optional, Tuple

from . import metrics as obs_metrics

__all__ = [
    "TrackedLock", "TrackedRLock", "TrackedCondition", "PhaseProfiler",
    "StackSampler", "set_enabled", "enabled", "snapshot", "sync_metrics",
    "top_wait_totals", "reset_for_tests",
]

_OBS = obs_metrics.default_registry()
_WAIT_HIST = _OBS.histogram(
    "kubeshare_lock_wait_seconds",
    "Contended tracked-lock acquire waits (uncontended acquires are "
    "not observed).", labels=("lock",))
_HOLD_HIST = _OBS.histogram(
    "kubeshare_lock_hold_seconds",
    "Tracked-lock hold times, sampled 1-in-8 plus every contended "
    "acquire.", labels=("lock",))
_WAITED = _OBS.counter(
    "kubeshare_lock_waited_seconds_total",
    "Exact cumulative seconds threads spent waiting for each tracked "
    "lock.", labels=("lock",))
_HELD = _OBS.counter(
    "kubeshare_lock_held_seconds_total",
    "Cumulative seconds each tracked lock was held (gap-weighted "
    "sampling estimate; exact when every acquire is sampled).",
    labels=("lock",))
_ACQS = _OBS.counter(
    "kubeshare_lock_acquisitions_total",
    "Tracked-lock acquisitions.", labels=("lock",))
_CONTENDED = _OBS.counter(
    "kubeshare_lock_contended_total",
    "Tracked-lock acquisitions that had to wait.", labels=("lock",))
_PHASE_SECONDS = _OBS.counter(
    "kubeshare_prof_phase_seconds_total",
    "Seconds of bracketed critical-section time attributed to each "
    "named phase.", labels=("phase",))
_SPAN_SECONDS = _OBS.counter(
    "kubeshare_prof_span_seconds_total",
    "Total bracketed critical-section seconds (the phase coverage "
    "denominator).")
_STACK_SAMPLES = _OBS.counter(
    "kubeshare_prof_stack_samples_total",
    "Stack-sampler passes over sys._current_frames().")

#: process-wide enable switch (``--prof`` defaults on; ``--no-prof``
#: drops every wrapper to the delegated fast path)
_enabled = True

#: frames whose code lives in these files are lock/condition machinery,
#: not holder sites — the site walk skips them
_SKIP_FILES = frozenset((__file__, threading.__file__))

_registry_lock = threading.Lock()
_locks: "weakref.WeakSet[TrackedLock]" = weakref.WeakSet()
_phase_profilers: "weakref.WeakSet[PhaseProfiler]" = weakref.WeakSet()


def set_enabled(value: bool) -> None:
    """Flip the profiler (``--prof``/``--no-prof``). Takes effect on the
    next acquire; a hold begun while enabled is still accounted."""
    global _enabled
    _enabled = bool(value)


def enabled() -> bool:
    return _enabled


def _register_lock(lock: "TrackedLock") -> None:
    with _registry_lock:
        _locks.add(lock)


def _register_phases(prof: "PhaseProfiler") -> None:
    with _registry_lock:
        _phase_profilers.add(prof)


# -- tracked locks -----------------------------------------------------------


class TrackedLock:
    """Drop-in ``threading.Lock`` with wait/hold accounting.

    Also usable as the backing lock of a ``threading.Condition`` (the
    serving front door's ``Condition(self.lock)`` pattern): it provides
    ``_is_owned`` so the Condition adopts owner tracking instead of its
    acquire-probe fallback, and the default ``_release_save`` /
    ``_acquire_restore`` route through the tracked acquire/release.
    """

    __slots__ = ("name", "_inner", "_clock", "_owner", "_t_acq", "_site",
                 "_k", "_last_sampled", "wait_total_s", "hold_total_s",
                 "acquisitions", "contended", "sites", "_synced",
                 "__weakref__")

    def __init__(self, name: str, clock=time.monotonic, inner=None):
        self.name = name
        self._inner = inner if inner is not None else threading.Lock()
        self._clock = clock
        self._owner: Optional[int] = None
        self._t_acq = -1.0           # -1 = hold not profiled (a fake
        # clock may legitimately stamp an acquire at exactly 0.0)
        self._site: Optional[Tuple[object, int]] = None
        self._k = 1                  # acquire gap the current sample covers
        self._last_sampled = 0       # acquisitions count at the last sample
        # exact accumulators — only ever mutated while HOLDING the lock
        # (wait is recorded after a successful acquire, hold before
        # release), so the measured lock serializes its own bookkeeping
        self.wait_total_s = 0.0
        self.hold_total_s = 0.0
        self.acquisitions = 0
        self.contended = 0
        #: (code, lineno) -> cumulative hold seconds (holder sites)
        self.sites: Dict[Tuple[object, int], float] = {}
        # last values flushed into the counter families (sync_metrics)
        self._synced = (0.0, 0.0, 0, 0)
        _register_lock(self)

    # the stdlib context protocol

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def _capture_site(self) -> None:
        # prof.py is in _SKIP_FILES, so the walk steps past this helper
        # and acquire() to the caller's frame
        f = sys._getframe(1)
        while f is not None and f.f_code.co_filename in _SKIP_FILES:
            f = f.f_back
        self._site = (f.f_code, f.f_lineno) if f is not None else None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not _enabled:
            ok = self._inner.acquire(blocking, timeout)
            if ok:
                self._owner = get_ident()
                self._t_acq = -1.0      # hold begun unprofiled
            return ok
        if self._inner.acquire(False):
            # uncontended fast path — what a tracked lock costs lives
            # here. Hold TIMING is sampled
            # 1-in-8: unsampled acquires pay one counter bump and one
            # branch (no clock reads at all — those are the dominant
            # cost a pure-Python wrapper can shed). Each sampled hold
            # is weighted by the acquire gap it covers, so hold totals
            # stay an unbiased estimate (and EXACT whenever every
            # acquire lands on a sample: single-acquire unit contracts,
            # contended traffic, low-rate locks). Wait accounting lives
            # entirely on the contended path below and stays exact —
            # that is the bar the churn accuracy harness pins.
            self._owner = get_ident()
            self.acquisitions = acqs = self.acquisitions + 1
            if (acqs & 7) == 1:
                self._k = acqs - self._last_sampled
                self._last_sampled = acqs
                self._capture_site()
                self._t_acq = self._clock()
            return True
        if not blocking:
            return False
        t0 = self._clock()
        if not self._inner.acquire(True, timeout):
            return False
        waited = self._clock() - t0
        # holding from here on: accounting is serialized by the lock.
        # Every contended acquire is sampled: exact wait accounting,
        # site capture, and a timed hold covering the gap since the
        # last sample.
        self._owner = get_ident()
        self.acquisitions = acqs = self.acquisitions + 1
        self.contended += 1
        self.wait_total_s += waited
        _WAIT_HIST.observe(self.name, value=waited)
        self._k = acqs - self._last_sampled
        self._last_sampled = acqs
        self._capture_site()
        self._t_acq = self._clock()
        return True

    def release(self) -> None:
        # _t_acq >= 0 only after a sampled acquire, so a hold begun
        # while enabled is accounted even if the profiler was flipped
        # off mid-hold
        t0 = self._t_acq
        if t0 >= 0.0:
            self._t_acq = -1.0
            held = self._clock() - t0
            # gap-weighted: this sample stands in for the _k acquires
            # since the previous one (k == 1 when every acquire is
            # sampled, so low-rate and contended locks stay exact)
            self.hold_total_s += held * self._k
            site = self._site
            if site is not None:
                self._site = None
                self.sites[site] = self.sites.get(site, 0.0) + held
            _HOLD_HIST.observe(self.name, value=held)
        self._owner = None
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def _is_owned(self) -> bool:
        # Condition copies this at construction — owner tracking beats
        # its acquire-probe fallback (which would pollute the stats)
        return self._owner == get_ident()

    # -- introspection (racy reads by design: snapshot callers do NOT
    # hold the lock; worst case they see a holder mid-transition) ------

    def holder(self) -> Optional[dict]:
        """Current holder, or None. Racy snapshot — advisory only."""
        owner, t_acq, site = self._owner, self._t_acq, self._site
        if owner is None:
            return None
        out: dict = {"thread_id": owner}
        for th in threading.enumerate():
            if th.ident == owner:
                out["thread"] = th.name
                break
        if t_acq >= 0.0:
            out["held_s"] = round(max(0.0, self._clock() - t_acq), 6)
        if site is not None:
            out["site"] = _fmt_site(site)
        return out

    def top_sites(self, n: int = 3) -> List[dict]:
        """Top holder sites by cumulative hold seconds."""
        items = sorted(self.sites.items(), key=lambda kv: -kv[1])[:n]
        return [{"site": _fmt_site(site), "held_s": round(s, 6)}
                for site, s in items]

    def stats(self) -> dict:
        return {
            "name": self.name,
            "acquisitions": self.acquisitions,
            "contended": self.contended,
            "wait_total_s": round(self.wait_total_s, 6),
            "hold_total_s": round(self.hold_total_s, 6),
            "holder": self.holder(),
            "top_sites": self.top_sites(),
        }


class TrackedRLock(TrackedLock):
    """Re-entrant :class:`TrackedLock` (pure-Python RLock semantics over
    a plain inner Lock). Only the outermost acquire/release pair is
    accounted; nested acquires are an owner check + depth bump.

    Implements ``_release_save`` / ``_acquire_restore`` so it backs a
    ``threading.Condition`` whose ``wait()`` must fully drop a
    multiply-held lock.
    """

    __slots__ = ("_depth",)

    def __init__(self, name: str, clock=time.monotonic):
        super().__init__(name, clock=clock, inner=threading.Lock())
        self._depth = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._owner == get_ident():
            self._depth += 1
            return True
        ok = TrackedLock.acquire(self, blocking, timeout)
        if ok:
            self._depth = 1
        return ok

    def release(self) -> None:
        if self._owner != get_ident():
            raise RuntimeError("cannot release un-acquired lock")
        self._depth -= 1
        if self._depth == 0:
            TrackedLock.release(self)

    def _release_save(self):
        # Condition.wait: fully drop the lock whatever the depth —
        # the hold ends here (and is accounted), the wait for notify
        # happens on the Condition's waiter lock, not on this one
        depth = self._depth
        self._depth = 1
        self.release()
        return depth

    def _acquire_restore(self, depth) -> None:
        self.acquire()
        self._depth = depth


class TrackedCondition(threading.Condition):
    """``threading.Condition`` over a tracked lock (re-entrant by
    default, matching ``threading.Condition()``'s RLock). Drop-in for
    the token scheduler's condition;
    ``.tracked`` exposes the underlying :class:`TrackedLock`."""

    def __init__(self, name: str, clock=time.monotonic, lock=None):
        self.tracked = lock if lock is not None \
            else TrackedRLock(name, clock=clock)
        super().__init__(self.tracked)


def _fmt_site(site: Tuple[object, int]) -> str:
    code, lineno = site
    try:
        filename = code.co_filename.rsplit("/", 1)[-1]
        return "%s (%s:%d)" % (code.co_name, filename, lineno)
    except AttributeError:
        return str(site)


# -- phase attribution -------------------------------------------------------


class _NullSpan:
    """Disabled-profiler span: every call is a no-op."""

    __slots__ = ()

    def lap(self, phase: str) -> None:
        pass

    def close(self, phase: str = "") -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    """One bracketed critical section with lap-timer attribution: each
    ``lap(phase)`` charges the time since the previous mark to *phase*,
    so sequential code partitions its whole duration with no gaps."""

    __slots__ = ("_prof", "_t0", "_last")

    def __init__(self, prof: "PhaseProfiler", t0: float):
        self._prof = prof
        self._t0 = t0
        self._last = t0

    def lap(self, phase: str) -> None:
        now = self._prof._wall()
        self._prof._add(phase, now - self._last)
        self._last = now

    def close(self, phase: str = "") -> None:
        now = self._prof._wall()
        if phase:
            self._prof._add(phase, now - self._last)
        self._prof.span_total_s += now - self._t0
        self._prof.spans += 1


class PhaseProfiler:
    """Named-phase attribution for one long-held critical section.

    Deliberately measured on ``time.perf_counter`` (injectable for unit
    tests only): the components it brackets run on injectable —
    possibly frozen — clocks, under which every phase would measure
    zero. Accounting is serialized by the critical section itself; the
    only cross-thread readers are racy snapshots.
    """

    def __init__(self, name: str, wall=time.perf_counter):
        self.name = name
        self._wall = wall
        self.phase_totals: Dict[str, float] = {}
        self.phase_counts: Dict[str, int] = {}
        self.span_total_s = 0.0
        self.spans = 0
        self._synced: Dict[str, float] = {}
        self._synced_span = 0.0
        _register_phases(self)

    def span(self):
        """Open a span (``_NULL_SPAN`` when the profiler is off)."""
        if not _enabled:
            return _NULL_SPAN
        return _Span(self, self._wall())

    def _add(self, phase: str, dt: float) -> None:
        self.phase_totals[phase] = self.phase_totals.get(phase, 0.0) + dt
        self.phase_counts[phase] = self.phase_counts.get(phase, 0) + 1

    def coverage(self) -> float:
        """Fraction of measured span time the phases account for."""
        if self.span_total_s <= 0.0:
            return 0.0
        return sum(self.phase_totals.values()) / self.span_total_s

    def state(self) -> dict:
        return {
            "name": self.name,
            "spans": self.spans,
            "span_seconds": round(self.span_total_s, 6),
            "phases": {p: round(s, 6)
                       for p, s in sorted(self.phase_totals.items())},
            "coverage": round(self.coverage(), 4),
        }


# -- sampling wall profiler --------------------------------------------------


class StackSampler:
    """``sys._current_frames()`` sampler aggregating folded stacks.

    Low-cadence (default 10 ms) and allocation-light: each pass walks
    every thread's frame chain once and bumps one dict counter per
    thread. Output is folded-stack text (flamegraph.pl-compatible) or
    speedscope JSON (one sampled profile per thread).
    """

    def __init__(self, interval_s: float = 0.01, max_depth: int = 64):
        self.interval_s = interval_s
        self.max_depth = max_depth
        #: (thread_name, "outer;inner;...") -> sample count
        self.counts: Dict[Tuple[str, str], int] = {}
        self.samples = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def sample_once(self, frames=None) -> int:
        """One aggregation pass; ``frames`` is injectable for tests
        (defaults to ``sys._current_frames()``). Returns threads seen."""
        if frames is None:
            frames = sys._current_frames()
        me = threading.get_ident()
        names = {th.ident: th.name for th in threading.enumerate()}
        seen = 0
        with self._lock:
            for ident, frame in frames.items():
                if ident == me:
                    continue            # never profile the profiler
                stack: List[str] = []
                f, depth = frame, 0
                while f is not None and depth < self.max_depth:
                    stack.append(f.f_code.co_name)
                    f = f.f_back
                    depth += 1
                stack.reverse()         # outermost first (folded order)
                key = (names.get(ident, "thread-%d" % ident),
                       ";".join(stack))
                self.counts[key] = self.counts.get(key, 0) + 1
                seen += 1
            self.samples += 1
        _STACK_SAMPLES.inc()
        return seen

    def start(self) -> "StackSampler":
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="prof-stack-sampler")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:
                # the profiler must never take the process with it
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def folded(self) -> str:
        """Folded-stack lines: ``thread;outer;inner count``."""
        with self._lock:
            items = sorted(self.counts.items())
        return "\n".join("%s;%s %d" % (thread, stack, n)
                         for (thread, stack), n in items) + \
            ("\n" if items else "")

    def speedscope(self) -> dict:
        """Speedscope JSON (``type: sampled``, one profile per thread,
        weights in seconds at the configured interval)."""
        with self._lock:
            items = sorted(self.counts.items())
        frames: List[dict] = []
        index: Dict[str, int] = {}

        def frame_idx(name: str) -> int:
            if name not in index:
                index[name] = len(frames)
                frames.append({"name": name})
            return index[name]

        by_thread: Dict[str, List[Tuple[List[int], float]]] = {}
        for (thread, stack), n in items:
            idxs = [frame_idx(name) for name in stack.split(";") if name]
            by_thread.setdefault(thread, []).append(
                (idxs, n * self.interval_s))
        profiles = []
        for thread in sorted(by_thread):
            rows = by_thread[thread]
            total = sum(w for _, w in rows)
            profiles.append({
                "type": "sampled", "name": thread, "unit": "seconds",
                "startValue": 0, "endValue": round(total, 6),
                "samples": [idxs for idxs, _ in rows],
                "weights": [round(w, 6) for _, w in rows],
            })
        return {
            "$schema": "https://www.speedscope.app/file-format-schema.json",
            "shared": {"frames": frames},
            "profiles": profiles,
            "name": "kubeshare-prof",
            "activeProfileIndex": 0,
            "exporter": "kubeshare_tpu_torch.obs.prof",
        }

    def export_speedscope(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.speedscope(), f)


# -- process-wide surface ----------------------------------------------------


def _live_locks() -> List[TrackedLock]:
    with _registry_lock:
        return list(_locks)


def _live_phases() -> List[PhaseProfiler]:
    with _registry_lock:
        return list(_phase_profilers)


def sync_metrics() -> None:
    """Flush exact per-lock/per-phase accumulators into the default
    registry's counter families. Called from every exposition path
    (and :func:`snapshot`) so the families
    are fresh wherever they are scraped; deltas since the last flush
    keep the counters monotone even though the accumulators are plain
    floats."""
    for lock in _live_locks():
        waited, held, acqs, cont = (lock.wait_total_s, lock.hold_total_s,
                                    lock.acquisitions, lock.contended)
        s_waited, s_held, s_acqs, s_cont = lock._synced
        if waited > s_waited:
            _WAITED.inc(lock.name, amount=waited - s_waited)
        if held > s_held:
            _HELD.inc(lock.name, amount=held - s_held)
        if acqs > s_acqs:
            _ACQS.inc(lock.name, amount=acqs - s_acqs)
        if cont > s_cont:
            _CONTENDED.inc(lock.name, amount=cont - s_cont)
        lock._synced = (waited, held, acqs, cont)
    for prof in _live_phases():
        for phase, total in list(prof.phase_totals.items()):
            prev = prof._synced.get(phase, 0.0)
            if total > prev:
                _PHASE_SECONDS.inc(phase, amount=total - prev)
                prof._synced[phase] = total
        if prof.span_total_s > prof._synced_span:
            _SPAN_SECONDS.inc(amount=prof.span_total_s
                              - prof._synced_span)
            prof._synced_span = prof.span_total_s


def snapshot() -> dict:
    """The profiler's snapshot: per-lock wait/hold table (ranked by wait,
    then hold), holder sites, current holders, and per-profiler phase
    attribution with coverage."""
    sync_metrics()
    by_name: Dict[str, dict] = {}
    for lock in _live_locks():
        s = lock.stats()
        agg = by_name.get(s["name"])
        if agg is None:
            by_name[s["name"]] = s
            continue
        # several instances may share a name (tests build many
        # schedulers) — aggregate them into one row per lock name
        agg["acquisitions"] += s["acquisitions"]
        agg["contended"] += s["contended"]
        agg["wait_total_s"] = round(agg["wait_total_s"]
                                    + s["wait_total_s"], 6)
        agg["hold_total_s"] = round(agg["hold_total_s"]
                                    + s["hold_total_s"], 6)
        if agg.get("holder") is None:
            agg["holder"] = s["holder"]
        sites = {e["site"]: e["held_s"]
                 for e in agg.get("top_sites", [])}
        for e in s.get("top_sites", []):
            sites[e["site"]] = sites.get(e["site"], 0.0) + e["held_s"]
        agg["top_sites"] = [
            {"site": site, "held_s": round(held, 6)}
            for site, held in sorted(sites.items(),
                                     key=lambda kv: -kv[1])[:3]]
    locks = sorted(by_name.values(),
                   key=lambda s: (-s["wait_total_s"], -s["hold_total_s"],
                                  s["name"]))
    phases: Dict[str, dict] = {}
    for prof in _live_phases():
        st = prof.state()
        agg = phases.get(st["name"])
        if agg is None:
            phases[st["name"]] = st
            continue
        agg["spans"] += st["spans"]
        agg["span_seconds"] = round(agg["span_seconds"]
                                    + st["span_seconds"], 6)
        for p, s in st["phases"].items():
            agg["phases"][p] = round(agg["phases"].get(p, 0.0) + s, 6)
        total = sum(agg["phases"].values())
        agg["coverage"] = round(total / agg["span_seconds"], 4) \
            if agg["span_seconds"] > 0 else 0.0
    return {
        "enabled": _enabled,
        "locks": locks,
        "phases": phases,
    }


def top_wait_totals(n: int = 8) -> Dict[str, float]:
    """Top-N lock cumulative wait seconds, keyed by lock name — the
    flight recorder's ``lockcontention`` delta subsystem feeds these
    monotone totals to :meth:`FlightRecorder.sample_deltas`, so a
    black-box dump shows which locks the control plane was waiting on
    in the seconds before the trigger."""
    totals: Dict[str, float] = {}
    for lock in _live_locks():
        totals[lock.name] = totals.get(lock.name, 0.0) + lock.wait_total_s
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
    return {name: round(total, 6) for name, total in top}


def reset_for_tests() -> None:
    """Drop every registered lock/profiler and re-enable — test
    isolation only (mirrors ``MetricsRegistry.reset``)."""
    global _enabled
    with _registry_lock:
        _locks.clear()
        _phase_profilers.clear()
    _enabled = True
