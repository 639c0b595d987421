"""Token scheduler: time-slices one device between fractional clients.

Counterpart of ``kubeshare_tpu/isolation/tokensched.py``. One exclusive
*token* circulates per device; a grant carries a quota (ms of device time)
and the holder reports actual usage on release. Scheduling is stride
scheduling weighted by ``request`` with a sliding-window ``limit`` cap
(the algorithm is stated in ``native/tokensched.cpp``).

Two cores with one interface: :class:`NativeTokenCore`, the JAX package's
C++ core (a copy, built with ``g++`` at first use), which
:class:`TokenScheduler` runs by default, and :class:`PyTokenCore`, its
executable spec in Python (``native=False``). A failed native build
raises; it never falls back to Python. The blocking façade
:class:`TokenScheduler` gives each client a workload class and, with a
:class:`~kubeshare_tpu_torch.preempt.PreemptionPolicy`, lets a latency
waiter preempt a best-effort holder; :func:`serve` is its TCP server for
pod managers. The gang wire extension is not ported.

The façade feeds the observability plane where the JAX façade feeds its
own, whichever core runs under it: the grant-wait, hold and utilisation
families, the SLO evaluator's ``grant-wait`` indicator, a ``token-grant``
span for a traced waiter, the flight recorder's rate-limited deltas, and
with ``ledger=`` (a :class:`~kubeshare_tpu_torch.obs.ledger.
ChipTimeLedger`) and ``blame=`` the chip-time ledger and the blame graph.
Its condition is a tracked one (``"tokensched"``, :mod:`..obs.prof`).
"""

from __future__ import annotations

import ctypes
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from ..constants import BASE_QUOTA_MS, MIN_QUOTA_MS, WINDOW_MS
from ..obs import metrics as obs_metrics
from ..obs import prof as obs_prof
from ..obs import slo as obs_slo
from ..obs.flight import default_recorder as flight_default_recorder
from ..obs.trace import get_tracer
from ..utils.logger import get_logger
from . import protocol
from .native import load_library

log = get_logger("tokensched")

_INF = float("inf")

_OBS = obs_metrics.default_registry()
_GRANT_WAIT = _OBS.histogram(
    "kubeshare_token_grant_wait_seconds",
    "Time a client blocked between requesting the chip token and the "
    "grant, by tenant namespace and workload class.",
    labels=("chip", "namespace", "tpu_class"))
_HOLD = _OBS.histogram(
    "kubeshare_token_hold_seconds",
    "Wall time a client held the chip token before releasing it.",
    labels=("chip",))
_UTIL = _OBS.gauge(
    "kubeshare_token_utilization_ratio",
    "Per-client share of the sliding window actually consumed "
    "(window_usage / window_ms), updated at each release.",
    labels=("chip", "client"))


@dataclass
class _PyClient:
    name: str
    request: float
    limit: float
    vtime: float = 0.0
    waiting: bool = False
    usage: list = field(default_factory=list)  # [(start_ms, end_ms)]

    def window_usage(self, now_ms: float, window_ms: float) -> float:
        lo = now_ms - window_ms
        self.usage = [(s, e) for s, e in self.usage if e > lo]
        return sum(e - max(s, lo) for s, e in self.usage)

    def eligible_at(self, now_ms: float, window_ms: float, target_ms: float) -> float:
        if self.window_usage(now_ms, window_ms) <= target_ms:
            return now_ms
        lo, hi = now_ms, now_ms + window_ms
        for _ in range(48):
            mid = (lo + hi) / 2
            wlo = mid - window_ms
            total = sum(e - max(s, wlo) for s, e in self.usage if e > wlo)
            if total <= target_ms:
                hi = mid
            else:
                lo = mid
        return hi


class PyTokenCore:
    """Same state machine as the native core, in Python."""

    kind = "python"

    def __init__(self, window_ms: float = WINDOW_MS,
                 base_quota_ms: float = BASE_QUOTA_MS,
                 min_quota_ms: float = MIN_QUOTA_MS):
        self.window_ms = window_ms
        self.base_quota_ms = base_quota_ms
        self.min_quota_ms = min_quota_ms
        self._clients: dict[str, _PyClient] = {}
        self._holder: str | None = None
        self._closed = False

    def add_client(self, name: str, request: float, limit: float) -> None:
        if self._closed:
            raise RuntimeError("token scheduler closed")
        if request <= 0 or limit <= 0 or limit > 1 or request > limit:
            raise ValueError(f"bad request/limit: {request}/{limit}")
        if name in self._clients:
            raise ValueError(f"duplicate client {name}")
        vmin = min((c.vtime for c in self._clients.values()), default=0.0)
        self._clients[name] = _PyClient(name, request, limit, vtime=vmin)

    def remove_client(self, name: str) -> None:
        self._clients.pop(name, None)
        if self._holder == name:
            self._holder = None

    def request_token(self, name: str) -> None:
        self._clients[name].waiting = True

    def cancel_request(self, name: str) -> None:
        client = self._clients.get(name)
        if client is not None:
            client.waiting = False

    def poll(self, now_ms: float) -> tuple[str, float] | float:
        """Grant ``(name, quota_ms)`` or return the next wake time (ms,
        may be inf)."""
        if self._closed:
            # Same contract as the native core's freed-handle guard: a
            # waiter woken by close() must error out, not sleep forever.
            raise RuntimeError("token scheduler closed")
        if self._holder is not None:
            return _INF
        best: _PyClient | None = None
        best_remaining = 0.0
        next_wake = _INF
        for c in self._clients.values():
            if not c.waiting:
                continue
            cap = c.limit * self.window_ms
            remaining = cap - c.window_usage(now_ms, self.window_ms)
            if remaining < self.min_quota_ms:
                next_wake = min(next_wake, c.eligible_at(
                    now_ms, self.window_ms, cap - self.min_quota_ms))
                continue
            if (best is None or c.vtime < best.vtime
                    or (c.vtime == best.vtime and c.name < best.name)):
                best, best_remaining = c, remaining
        if best is None:
            return next_wake
        quota = max(self.min_quota_ms, min(self.base_quota_ms, best_remaining))
        best.waiting = False
        self._holder = best.name
        return best.name, quota

    def release_token(self, name: str, used_ms: float, now_ms: float) -> None:
        if self._holder != name:
            raise ValueError(f"{name} does not hold the token")
        c = self._clients[name]
        if used_ms > 0:
            c.usage.append((now_ms - used_ms, now_ms))
            c.vtime += used_ms / c.request
        self._holder = None

    def set_effective(self, name: str, request: float, limit: float) -> None:
        """Adjust a client's effective share in place (elastic burst
        credit): the validation of ``add_client``, taking hold at the next
        grant decision. Usage history and vtime are untouched, so a
        revocation is symmetric and instant."""
        if request <= 0 or limit <= 0 or limit > 1 or request > limit:
            raise ValueError(f"bad request/limit: {request}/{limit}")
        c = self._clients.get(name)
        if c is None:
            raise KeyError(name)
        c.request = request
        c.limit = limit

    def effective(self, name: str) -> tuple[float, float]:
        """The ``(request, limit)`` the core enforces for ``name``, read
        back from its client record. Raises KeyError for an unknown one."""
        c = self._clients[name]
        return c.request, c.limit

    def window_usage(self, name: str, now_ms: float) -> float:
        return self._clients[name].window_usage(now_ms, self.window_ms)

    def holder(self) -> str | None:
        return self._holder

    def client_count(self) -> int:
        return len(self._clients)

    def close(self) -> None:
        self._closed = True
        self._clients.clear()
        self._holder = None


# --------------------------------------------------------------------------
# Native core (ctypes over native/tokensched.cpp)
# --------------------------------------------------------------------------

def _bind_native(lib: ctypes.CDLL) -> None:
    """Declare the C interface's argument and result types."""
    vp, cp, db = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_double
    dbp = ctypes.POINTER(ctypes.c_double)
    lib.ts_create.restype = vp
    lib.ts_create.argtypes = [db, db, db]
    lib.ts_destroy.restype = None
    lib.ts_destroy.argtypes = [vp]
    for fn, args in (("ts_add_client", [vp, cp, db, db]),
                     ("ts_remove_client", [vp, cp]),
                     ("ts_request_token", [vp, cp]),
                     ("ts_cancel_request", [vp, cp]),
                     ("ts_poll", [vp, db, cp, ctypes.c_int, dbp, dbp]),
                     ("ts_release_token", [vp, cp, db, db]),
                     ("ts_set_effective", [vp, cp, db, db]),
                     ("ts_client_count", [vp]),
                     ("ts_holder", [vp, cp, ctypes.c_int])):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = args
    lib.ts_window_usage.restype = db
    lib.ts_window_usage.argtypes = [vp, cp, db]
    lib.ts_get_effective.restype = ctypes.c_int
    lib.ts_get_effective.argtypes = [vp, cp, dbp, dbp]


class NativeTokenCore:
    """ctypes wrapper over ``libtokensched.so`` with :class:`PyTokenCore`'s
    interface. Building the library may raise (with ``g++``'s output)."""

    kind = "native"

    def __init__(self, window_ms: float = WINDOW_MS,
                 base_quota_ms: float = BASE_QUOTA_MS,
                 min_quota_ms: float = MIN_QUOTA_MS):
        self._h = None
        lib = load_library("tokensched")
        _bind_native(lib)
        self._lib = lib
        self._h = lib.ts_create(window_ms, base_quota_ms, min_quota_ms)
        self.window_ms = window_ms
        self.base_quota_ms = base_quota_ms
        self.min_quota_ms = min_quota_ms

    def _handle(self):
        # after close() the C++ scheduler is freed: a waiter woken by the
        # close must error out, never touch a freed handle
        h = self._h
        if not h:
            raise RuntimeError("token scheduler closed")
        return h

    def add_client(self, name: str, request: float, limit: float) -> None:
        rc = self._lib.ts_add_client(self._handle(), name.encode(), request,
                                     limit)
        if rc == -1:
            raise ValueError(f"bad request/limit: {request}/{limit}")
        if rc == -2:
            raise ValueError(f"duplicate client {name}")

    def remove_client(self, name: str) -> None:
        self._lib.ts_remove_client(self._handle(), name.encode())

    def request_token(self, name: str) -> None:
        if self._lib.ts_request_token(self._handle(), name.encode()) != 0:
            raise KeyError(name)

    def cancel_request(self, name: str) -> None:
        self._lib.ts_cancel_request(self._handle(), name.encode())

    def poll(self, now_ms: float) -> tuple[str, float] | float:
        """Grant ``(name, quota_ms)`` or return the next wake time (ms,
        may be inf)."""
        buf = ctypes.create_string_buffer(256)
        quota = ctypes.c_double()
        wake = ctypes.c_double()
        rc = self._lib.ts_poll(self._handle(), now_ms, buf, len(buf),
                               ctypes.byref(quota), ctypes.byref(wake))
        if rc == 1:
            return buf.value.decode(), quota.value
        return wake.value

    def release_token(self, name: str, used_ms: float, now_ms: float) -> None:
        if self._lib.ts_release_token(self._handle(), name.encode(), used_ms,
                                      now_ms) != 0:
            raise ValueError(f"{name} does not hold the token")

    def set_effective(self, name: str, request: float, limit: float) -> None:
        rc = self._lib.ts_set_effective(self._handle(), name.encode(),
                                        request, limit)
        if rc == -1:
            raise ValueError(f"bad request/limit: {request}/{limit}")
        if rc == -2:
            raise KeyError(name)

    def effective(self, name: str) -> tuple[float, float]:
        request, limit = ctypes.c_double(), ctypes.c_double()
        if self._lib.ts_get_effective(self._handle(), name.encode(),
                                      ctypes.byref(request),
                                      ctypes.byref(limit)) != 0:
            raise KeyError(name)
        return request.value, limit.value

    def window_usage(self, name: str, now_ms: float) -> float:
        u = self._lib.ts_window_usage(self._handle(), name.encode(), now_ms)
        if u < 0:
            raise KeyError(name)
        return u

    def holder(self) -> str | None:
        buf = ctypes.create_string_buffer(256)
        if self._lib.ts_holder(self._handle(), buf, len(buf)):
            return buf.value.decode()
        return None

    def client_count(self) -> int:
        return self._lib.ts_client_count(self._handle())

    def close(self) -> None:
        if self._h:
            self._lib.ts_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


def make_core(window_ms: float = WINDOW_MS,
              base_quota_ms: float = BASE_QUOTA_MS,
              min_quota_ms: float = MIN_QUOTA_MS, native: bool = True):
    """The native core, or with ``native=False`` the Python one. Unlike the
    JAX package's, a native core that does not build raises."""
    if native:
        return NativeTokenCore(window_ms, base_quota_ms, min_quota_ms)
    return PyTokenCore(window_ms, base_quota_ms, min_quota_ms)


# --------------------------------------------------------------------------
# Blocking façade
# --------------------------------------------------------------------------

def _now_ms() -> float:
    return time.monotonic() * 1000.0


class TokenScheduler:
    """Thread-safe blocking façade over a core: ``acquire`` blocks until the
    token is granted, ``renew`` releases and re-requests atomically,
    ``release`` reports usage and wakes the next waiter.

    Each client has a workload class (``"latency"`` or ``"best-effort"``,
    the default). With ``preempt`` — a :class:`~kubeshare_tpu_torch.
    preempt.PreemptionPolicy` — a waiter that outranks the holder and has
    waited past the policy's grace marks the holder preempted
    (:meth:`preempted`, which the proxy's boundary slicer reads) and is
    granted next, the holder right after it. With no policy and no
    directed grant queued, the grant path is exactly the core's poll.

    ``clock`` (milliseconds) is the core's timebase; ``chip`` names this
    token in every family, the ledger and the blame graph (the port's
    device id, as ``topology/discovery.py`` names it). ``ledger`` and
    ``blame`` take the grant, release, execute and preemption transitions
    and each grant's wait; ``ledger_clock`` returns SECONDS and is
    deliberately separate from ``clock``."""

    def __init__(self, window_ms: float = WINDOW_MS,
                 base_quota_ms: float = BASE_QUOTA_MS,
                 min_quota_ms: float = MIN_QUOTA_MS, native: bool = True,
                 clock=None, chip: str = "", ledger=None, blame=None,
                 ledger_clock=None, preempt=None):
        self._core = make_core(window_ms, base_quota_ms, min_quota_ms, native)
        # tracked (obs/prof.py): the façade's grant and release lock; a
        # re-entrant condition as threading.Condition() makes, so the
        # grant order of either core is unchanged
        self._cond = obs_prof.TrackedCondition("tokensched")
        self._grants: dict[str, float] = {}    # name -> granted quota_ms
        # name -> FIFO of waiter tickets: several threads may wait on one
        # client's single token stream; they are served in arrival order
        self._waiting: dict[str, deque] = {}
        self._held_since: dict[str, float] = {}   # name -> grant time (s)
        self._shares: dict[str, tuple[float, float]] = {}
        # the share the core enforces: the base one, or the elastic
        # plane's burst credit (set_effective)
        self._effective: dict[str, tuple[float, float]] = {}
        self._classes: dict[str, str] = {}
        self._clock = clock or _now_ms
        self.window_ms = window_ms
        #: the label of this token in the families, ledger and blame
        self.chip = chip or "chip"
        self._ledger = ledger
        self._blame = blame
        self._ledger_clock = ledger_clock or time.monotonic
        self.preempt = preempt
        self._preempt_flags: set[str] = set()     # holders marked
        self._preempt_marked_at: dict[str, float] = {}
        #: directed grants, (name, "beneficiary" | "credit"): granted next
        #: regardless of stride order
        self._boost: deque = deque()
        self._hold_quota: dict[str, float] = {}   # name -> granted quota
        #: demand hook (the autopilot's elastic quota): called as
        #: ``on_demand(name)`` under the lock the moment a client asks
        #: for the token, BEFORE the grant decision, so a lender whose
        #: demand returns has its credit revoked within that same token
        #: cycle. Its exceptions are logged and swallowed: quota policy
        #: must never break the data path.
        self.on_demand = None

    @property
    def core(self):
        return self._core

    @property
    def ledger(self):
        """The chip-time ledger this scheduler feeds, or None."""
        return self._ledger

    @property
    def blame(self):
        """The blame graph this scheduler feeds, or None."""
        return self._blame

    def add_client(self, name: str, request: float, limit: float,
                   tpu_class: str = "best-effort") -> None:
        with self._cond:
            self._core.add_client(name, request, limit)
            self._shares[name] = (request, limit)
            self._effective[name] = (request, limit)
            self._classes[name] = tpu_class or "best-effort"

    def remove_client(self, name: str) -> None:
        with self._cond:
            self._core.remove_client(name)
            self._grants.pop(name, None)
            was_holding = self._held_since.pop(name, None) is not None
            if was_holding and self._ledger is not None:
                # a removed holder never calls release: close its hold in
                # the ledger here, or the interval stays open
                self._ledger.release(self.chip, now=self._ledger_clock())
            self._shares.pop(name, None)
            self._effective.pop(name, None)
            self._classes.pop(name, None)
            self._preempt_flags.discard(name)
            self._preempt_marked_at.pop(name, None)
            self._hold_quota.pop(name, None)
            self._cond.notify_all()

    def waiting(self) -> list[str]:
        """Names with at least one waiter queued right now."""
        with self._cond:
            return [n for n, q in self._waiting.items() if q]

    def set_effective(self, name: str, request: float, limit: float) -> bool:
        """Push an adjusted effective share into the core (a burst credit
        granted or revoked). Returns False when the core refuses the call
        (``RuntimeError``: a closed scheduler): the caller must treat the
        credit as never granted. Raises KeyError for an unknown client and
        ValueError for a bad share, as ``add_client``."""
        with self._cond:
            try:
                self._core.set_effective(name, request, limit)
            except RuntimeError:
                return False
            self._effective[name] = (request, limit)
            self._cond.notify_all()   # a raised limit may unblock a waiter
            return True

    def shares(self) -> dict[str, tuple[float, float]]:
        """Base (guaranteed) ``{name: (request, limit)}`` as registered,
        never changed by burst credit."""
        with self._cond:
            return dict(self._shares)

    def effective(self, name: str) -> tuple[float, float]:
        """The share the core enforces for ``name``: the base one unless
        :meth:`set_effective` changed it."""
        with self._cond:
            return self._effective[name]

    def accounting(self) -> dict:
        """One consistent snapshot of the shares: per client its base and
        effective ``(request, limit)``, class and whether it holds the
        token, the effective-request sum (which must stay <= 1.0 even
        under elastic lending), the holders marked preempted, and the core
        in use."""
        with self._cond:
            clients = {name: {"request": req, "limit": lim,
                              "effective_request": self._effective[name][0],
                              "effective_limit": self._effective[name][1],
                              "class": self._classes.get(name,
                                                         "best-effort"),
                              "holding": name in self._held_since}
                       for name, (req, lim) in self._shares.items()}
            return {"chip": self.chip, "core": self._core.kind,
                    "clients": clients,
                    "share_sum": sum(c["effective_request"]
                                     for c in clients.values()),
                    "waiting": [n for n, q in self._waiting.items() if q],
                    "preempted": sorted(self._preempt_flags)}

    def now_ms(self) -> float:
        """This scheduler's clock, the timebase of window usage."""
        return self._clock()

    def acquire(self, name: str, timeout: float | None = None,
                trace_id: str = "") -> float:
        """Block until ``name`` is granted the token; returns quota_ms.
        ``trace_id`` tags the grant's span and its blame exemplar."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            self._core.request_token(name)
            self._note_demand(name)
            return self._wait_noted(name, deadline, trace_id)

    def renew(self, name: str, used_ms: float,
              timeout: float | None = None, trace_id: str = "") -> float:
        """Atomically release + re-request + wait for the next grant.

        The steady-state call: release and re-request happen under one
        lock, so this client is *waiting* when the freed token is handed
        out and stride weighting decides the order — a release-then-acquire
        pair would hand the token to whoever waited in the gap, collapsing
        shares to round-robin."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            self._core.release_token(name, used_ms, self._clock())
            self._note_release(name, used_ms)
            self._core.request_token(name)
            self._note_demand(name)
            self._cond.notify_all()
            return self._wait_noted(name, deadline, trace_id)

    def release(self, name: str, used_ms: float) -> None:
        with self._cond:
            self._core.release_token(name, used_ms, self._clock())
            self._note_release(name, used_ms)
            self._cond.notify_all()

    def execute_begin(self) -> None:
        """An execute started under the current hold (the proxy's token
        gate): the ledger's interval turns granted-active."""
        if self._ledger is not None:
            self._ledger.execute_begin(self.chip, now=self._ledger_clock())

    def execute_end(self) -> None:
        """The execute ended (on the card: after its completion
        barrier): the interval turns granted-idle again."""
        if self._ledger is not None:
            self._ledger.execute_end(self.chip, now=self._ledger_clock())

    def window_usage(self, name: str) -> float:
        with self._cond:
            return self._core.window_usage(name, self._clock())

    def close(self) -> None:
        with self._cond:
            self._core.close()
            # wake every waiter so it hits the closed-core error instead
            # of sleeping on a grant that can never come
            self._cond.notify_all()

    # -- preemption ----------------------------------------------------------

    def preempted(self, name: str) -> bool:
        """Is ``name``'s current hold marked preempted? The proxy's
        program-boundary check: True asks the holder to yield (renew) at
        its next execute boundary, forfeiting the rest of its quantum."""
        with self._cond:
            return name in self._preempt_flags

    def mark_preempted(self, name: str) -> None:
        """Mark holder ``name`` preempted from outside the policy (the
        entry point a gang coordinator decides through). A no-op unless
        ``name`` holds the token."""
        with self._cond:
            if name not in self._held_since or name in self._preempt_flags:
                return
            self._preempt_flags.add(name)
            self._preempt_marked_at[name] = time.monotonic()
            if self._ledger is not None:
                self._ledger.mark_preempted(self.chip,
                                            now=self._ledger_clock())
            self._cond.notify_all()

    def add_boost(self, name: str, credit: bool = False) -> None:
        """Queue ``name`` for a directed grant: the next grant, regardless
        of stride order (a beneficiary, or with ``credit`` an
        anti-starvation re-grant)."""
        with self._cond:
            self._boost.append((name, "credit" if credit else "beneficiary"))
            self._cond.notify_all()

    def _poll_grant(self):
        """The core's poll with directed grants (caller holds the lock).

        With no boost queued this IS ``core.poll``. With one armed and the
        token free, every other waiter's request is withdrawn for one poll
        so the core must pick the boost target, then re-armed — cancel and
        request are idempotent flag flips in both cores, so stride state
        is untouched. A target that is window-capped drops its boost and
        the poll is redone in stride order: a directed grant may jump the
        queue but never idles the device."""
        now = self._clock()
        if not self._boost or self._core.holder() is not None:
            # nothing directed, or the token is still held (a preempted
            # holder draining to its program boundary): keep the boost
            return self._core.poll(now)
        while self._boost:
            target, _kind = self._boost[0]
            if target not in self._shares or target in self._held_since:
                self._boost.popleft()      # vanished or already holding
                continue
            break
        if not self._boost:
            return self._core.poll(now)
        target, kind = self._boost[0]
        if not self._waiting.get(target):
            # the target is not asking right now: stride order, the boost
            # kept for when it asks
            return self._core.poll(now)
        others = [n for n, q in self._waiting.items() if q and n != target]
        for other in others:
            self._core.cancel_request(other)
        try:
            result = self._core.poll(now)
        finally:
            for other in others:
                try:
                    self._core.request_token(other)
                except KeyError:
                    pass                   # removed meanwhile
        if isinstance(result, tuple) and result[0] == target:
            self._boost.popleft()
            if self.preempt is not None:
                self.preempt.note_boost_grant(self.chip,
                                              credit=kind == "credit")
            return result
        if not isinstance(result, tuple):
            # the target is window-capped: forfeit the boost
            self._boost.popleft()
            return self._core.poll(now)
        return result

    def _maybe_preempt(self, name: str, waited_s: float) -> float | None:
        """Evaluate the policy for waiter ``name`` (caller holds the
        lock). Fires at most once a hold: the holder is marked (the
        ledger tags its tail from this instant), and the waiter then the
        holder are queued for directed grants — the holder's entry is its
        anti-starvation credit. Returns the seconds until the decision
        could flip (the waiter's next wake), or None."""
        policy = self.preempt
        if policy is None or not policy.enabled:
            return None
        holder = next(iter(self._held_since), None)
        if holder is None or holder == name or holder in self._preempt_flags:
            return None
        waiter_class = self._classes.get(name, "best-effort")
        holder_class = self._classes.get(holder, "best-effort")
        held_s = time.monotonic() - self._held_since[holder]
        if policy.should_preempt(waiter_class, holder_class,
                                 waited_s * 1000.0, held_s * 1000.0):
            self._preempt_flags.add(holder)
            self._preempt_marked_at[holder] = time.monotonic()
            self._boost.append((name, "beneficiary"))
            self._boost.append((holder, "credit"))
            if self._ledger is not None:
                self._ledger.mark_preempted(self.chip,
                                            now=self._ledger_clock())
            policy.note_preemption(self.chip, holder, waiter_class,
                                   holder_class)
            return None
        if not policy.should_preempt(waiter_class, holder_class, _INF, _INF):
            return None        # the class order can never flip it
        due = max(policy.grace_ms / 1000.0 - waited_s,
                  policy.min_hold_ms / 1000.0 - held_s)
        return max(0.001, due)

    # -- internals -----------------------------------------------------------

    def _note_demand(self, name: str) -> None:
        # caller holds self._cond, right after request_token
        if self.on_demand is None:
            return
        try:
            self.on_demand(name)
        except Exception:
            log.exception("on_demand hook failed for %s", name)

    def _wait_noted(self, name: str, deadline: float | None,
                    trace_id: str) -> float:
        # caller holds self._cond and has requested the token: the wait,
        # then its grant or its timeout reported to the obs plane
        t0 = time.monotonic()
        try:
            quota = self._wait_for_grant(name, deadline)
        except TimeoutError:
            self._note_timeout(name, time.monotonic() - t0, trace_id)
            raise
        self._note_grant(name, time.monotonic() - t0, trace_id)
        return quota

    def _take_grant(self, name: str, q: deque) -> float:
        # caller holds self._cond; a grant for `name` exists and this
        # thread's ticket heads the queue. With more same-name waiters,
        # re-arm the core's request so the next release can grant again.
        quota = self._grants.pop(name)
        self._hold_quota[name] = quota
        if len(q) > 1:
            self._core.request_token(name)
            self._cond.notify_all()
        return quota

    def _note_grant(self, name: str, wait_s: float, trace_id: str) -> None:
        # caller holds self._cond; a timed-out wait raised before this.
        # Tenant attribution: a client name "namespace/pod" is its
        # namespace's; a bare name is its own tenant.
        namespace = name.partition("/")[0]
        tpu_class = self._classes.get(name, "best-effort")
        _GRANT_WAIT.observe(self.chip, namespace, tpu_class,
                            value=wait_s, exemplar=trace_id or None)
        obs_slo.default_evaluator().record(
            namespace, "grant-wait", value_s=wait_s, trace_id=trace_id)
        self._held_since[name] = time.monotonic()
        if self._ledger is not None:
            now = self._ledger_clock()
            if self._blame is not None and wait_s > 0.0:
                # attribute BEFORE recording the grant: the wait window
                # must see the previous occupants, not this grant
                self._blame.account_wait(self.chip, namespace, tpu_class,
                                         wait_s, now=now, trace_id=trace_id)
            self._ledger.grant(self.chip, namespace, tpu_class, now=now)
        if trace_id:
            tracer = get_tracer()
            end = tracer.now_ms()
            tracer.record("token-grant", trace_id,
                          end - wait_s * 1000.0, end,
                          client=name, chip=self.chip)

    def _note_timeout(self, name: str, wait_s: float, trace_id: str) -> None:
        # caller holds self._cond; the wait ended in TimeoutError — the
        # blocked time is as real as a granted wait, so blame still names
        # whoever occupied the device during it
        if self._blame is not None and wait_s > 0.0:
            self._blame.account_wait(
                self.chip, name.partition("/")[0],
                self._classes.get(name, "best-effort"), wait_s,
                now=self._ledger_clock(), trace_id=trace_id, granted=False)

    def _note_release(self, name: str, used_ms: float = 0.0) -> None:
        # caller holds self._cond, right after the core's release, so the
        # utilisation gauge includes the usage just reported
        since = self._held_since.pop(name, None)
        if since is not None:
            _HOLD.observe(self.chip, value=time.monotonic() - since)
        quota = self._hold_quota.pop(name, 0.0)
        marked = self._preempt_marked_at.pop(name, None)
        if name in self._preempt_flags:
            # the preempted holder yielded: its mark-to-yield time and the
            # quantum it forfeited to the beneficiary
            self._preempt_flags.discard(name)
            if self.preempt is not None:
                yield_s = 0.0 if marked is None else time.monotonic() - marked
                self.preempt.note_yield(self.chip, yield_s,
                                        max(0.0, quota - used_ms))
        if self._ledger is not None:
            self._ledger.release(self.chip, now=self._ledger_clock())
        # black-box cadence (rate-limited inside): what this token was
        # doing in the run-up to a trigger
        flight_default_recorder().sample_deltas("tokensched-" + self.chip, {
            "clients": float(len(self._shares)),
            "waiting": float(sum(1 for q in self._waiting.values() if q)),
        })
        try:
            usage = self._core.window_usage(name, self._clock())
        except (KeyError, RuntimeError):
            return
        _UTIL.set(self.chip, name, value=usage / self.window_ms)

    def _wait_for_grant(self, name: str, deadline: float | None) -> float:
        # caller holds self._cond and has requested the token
        ticket = object()
        q = self._waiting.setdefault(name, deque())
        q.append(ticket)
        wait_t0 = time.monotonic()
        try:
            while True:
                due = self._maybe_preempt(name, time.monotonic() - wait_t0)
                result = self._poll_grant()
                if isinstance(result, tuple):
                    granted, quota = result
                    self._grants[granted] = quota
                    self._cond.notify_all()
                if name in self._grants and q[0] is ticket:
                    return self._take_grant(name, q)
                try:
                    self._core.window_usage(name, self._clock())
                except KeyError:
                    raise RuntimeError(f"{name}: client removed while "
                                       "waiting for token") from None
                if isinstance(result, tuple) or result == _INF:
                    wait = None
                else:
                    wait = max(0.001, (result - self._clock()) / 1000.0)
                if due is not None:
                    # wake when the preemption decision could flip
                    wait = due if wait is None else min(wait, due)
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        if name in self._grants and q[0] is ticket:
                            return self._take_grant(name, q)
                        if len(q) == 1:
                            self._core.cancel_request(name)
                        raise TimeoutError(f"{name}: token wait timed out")
                    wait = remaining if wait is None else min(wait, remaining)
                self._cond.wait(wait)
        finally:
            q.remove(ticket)
            if not q:
                self._waiting.pop(name, None)
            self._cond.notify_all()


def serve(scheduler: TokenScheduler, host: str = "127.0.0.1", port: int = 0,
          coordinator=None) -> protocol.FramedServer:
    """Expose a :class:`TokenScheduler` over framed-JSON TCP — the wire of
    ``kubeshare_tpu.isolation.tokensched.serve``, which pod managers and
    gates of either package speak.

    Requests: ``{"op": "register", "name", "request", "limit"}`` (creates
    the client; this connection owns it; an optional ``"class"`` sets its
    workload class), ``{"op": "attach", "name"}`` (binds an extra
    connection to an existing client — a pod manager's per-gate relay
    channels), ``{"op": "acquire"}`` (blocks; reply carries ``quota_ms``),
    ``{"op": "renew", "used_ms"}`` (atomic release+reacquire — the
    steady-state call), ``{"op": "release", "used_ms"}``, ``{"op":
    "usage"}``, ``{"op": "unregister"}``. Token ops act on the
    *connection-bound* identity (set by register/attach) — a connection
    can never name another pod's client. Replies: ``{"ok": true, ...}`` or
    ``{"ok": false, "error": msg}``. The owning connection's disconnect
    removes the client (≙ gem-schd dropping a dead pod manager); attached
    connections' disconnects don't. A request's ``_trace`` (the wire's
    trace id) tags the grant it waits for.

    A server started with a :class:`~kubeshare_tpu_torch.gang.coordinator.
    GangTokenCoordinator` also speaks the gang-grant extension:
    ``gang_register`` (publishes a gang's ``members``, ``[[chip,
    client], ...]``, and makes this connection its owner: the
    connection's disconnect unregisters it), ``gang_acquire`` (blocks
    until every member holds its token; replies ``held``),
    ``gang_release`` and ``gang_state`` (the coordinator's snapshot).
    Without a coordinator those names answer the standard unknown-op
    error, as the wire did before the extension.

    A scheduler with a preemption policy also answers ``preempt_poll``
    (is the connection-bound client's hold marked preempted?) and
    ``preempt_state`` (the policy's snapshot); without one they answer the
    standard unknown-op error, as a JAX server without a policy does.
    """
    def handle(req: dict, state: dict) -> dict:
        op = req.get("op")
        if coordinator is not None and op in GANG_OPS:
            return _handle_gang(coordinator, op, req, state)
        if scheduler.preempt is not None and op in ("preempt_poll",
                                                    "preempt_state"):
            if op == "preempt_state":
                return {"ok": True, "state": scheduler.preempt.snapshot()}
            name = state.get("name")
            if not name:
                raise PermissionError(
                    "connection not bound (register/attach first)")
            return {"ok": True, "preempted": scheduler.preempted(name)}
        if op not in ("register", "attach", "acquire", "renew", "release",
                      "usage", "unregister"):
            return {"ok": False, "error": f"unknown op {op!r}"}
        if op in ("register", "attach"):
            if state.get("name"):
                raise ValueError(
                    f"connection already bound to {state['name']!r}")
            name = req["name"]
            if op == "register":
                scheduler.add_client(name, float(req["request"]),
                                     float(req["limit"]),
                                     tpu_class=req.get("class",
                                                       "best-effort"))
            else:
                scheduler.window_usage(name)  # KeyError if no such client
            state["name"] = name
            state["owner"] = op == "register"
            return {"ok": True}
        name = state.get("name")
        if not name:
            raise PermissionError("connection not bound (register/attach first)")
        if op == "acquire":
            quota = scheduler.acquire(name, timeout=req.get("timeout"),
                                      trace_id=state.get("trace_id", ""))
            return {"ok": True, "quota_ms": quota}
        if op == "renew":
            quota = scheduler.renew(name, float(req["used_ms"]),
                                    timeout=req.get("timeout"),
                                    trace_id=state.get("trace_id", ""))
            return {"ok": True, "quota_ms": quota}
        if op == "release":
            scheduler.release(name, float(req["used_ms"]))
            return {"ok": True}
        if op == "usage":
            return {"ok": True,
                    "used_ms": scheduler.window_usage(name),
                    "window_ms": scheduler.window_ms}
        scheduler.remove_client(name)         # unregister
        state.pop("name", None)
        state.pop("owner", None)
        return {"ok": True}

    def cleanup(state: dict) -> None:
        if state.get("owner") and state.get("name"):
            try:
                scheduler.remove_client(state["name"])
            except RuntimeError:
                pass  # scheduler already closed — nothing left to free
        if coordinator is not None:
            for gang in state.get("gangs", ()):
                try:
                    coordinator.unregister_gang(gang)
                except Exception:
                    pass

    return protocol.serve_framed(host, port, handle, cleanup)


#: the gang-grant extension's ops (answered only with a coordinator)
GANG_OPS = ("gang_register", "gang_acquire", "gang_release", "gang_state")


def _handle_gang(coordinator, op: str, req: dict, state: dict) -> dict:
    """The gang-grant extension. ``gang_register`` publishes membership
    and makes this connection the gang's owner (its disconnect withdraws
    the gang, as with client ownership); ``gang_acquire`` and
    ``gang_release`` drive the two-phase gang-atomic grant;
    ``gang_state`` returns the coordinator's snapshot."""
    if op == "gang_state":
        return {"ok": True, "state": coordinator.snapshot()}
    gang = req.get("gang")
    if not gang:
        raise ValueError("gang ops require a 'gang' id")
    if op == "gang_register":
        members = [(str(c), str(cl)) for c, cl in req["members"]]
        coordinator.register_gang(
            gang, members, namespace=req.get("namespace", ""),
            tpu_class=req.get("class", "best-effort"))
        state.setdefault("gangs", set()).add(gang)
        return {"ok": True}
    if op == "gang_acquire":
        held = coordinator.acquire(gang, timeout=req.get("timeout"),
                                   trace_id=req.get("trace_id", ""))
        return {"ok": True, "held": dict(held)}
    coordinator.release(gang, used_ms=req.get("used_ms"))   # gang_release
    return {"ok": True}
