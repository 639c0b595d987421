"""Token scheduler: time-slices one device between fractional clients.

Counterpart of ``kubeshare_tpu/isolation/tokensched.py`` (Python core and
blocking façade). One exclusive *token* circulates per device; a grant
carries a quota (ms of device time) and the holder reports actual usage
on release. Scheduling is stride scheduling weighted by ``request`` with a
sliding-window ``limit`` cap.

:class:`PyTokenCore` is the JAX package's Python core, copied, and
:func:`serve` its TCP server for pod managers. The native C++ twin, the
gang and preemption wire extensions and the ledger, blame, SLO and
profiler hooks of the JAX façade are not ported yet.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field

from ..constants import BASE_QUOTA_MS, MIN_QUOTA_MS, WINDOW_MS
from . import protocol

_INF = float("inf")


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
# Blocking façade
# --------------------------------------------------------------------------

def _now_ms() -> float:
    return time.monotonic() * 1000.0


class TokenScheduler:
    """Thread-safe blocking façade over a :class:`PyTokenCore`: ``acquire``
    blocks until the token is granted, ``renew`` releases and re-requests
    atomically, ``release`` reports usage and wakes the next waiter."""

    def __init__(self, window_ms: float = WINDOW_MS,
                 base_quota_ms: float = BASE_QUOTA_MS,
                 min_quota_ms: float = MIN_QUOTA_MS):
        self._core = PyTokenCore(window_ms, base_quota_ms, min_quota_ms)
        self._cond = threading.Condition()
        self._grants: dict[str, float] = {}    # name -> granted quota_ms
        # name -> FIFO of waiter tickets: several threads may wait on one
        # client's single token stream; they are served in arrival order
        self._waiting: dict[str, deque] = {}
        self._holding: set[str] = set()
        self._shares: dict[str, tuple[float, float]] = {}
        self.window_ms = window_ms

    @property
    def core(self) -> PyTokenCore:
        return self._core

    def add_client(self, name: str, request: float, limit: float) -> None:
        with self._cond:
            self._core.add_client(name, request, limit)
            self._shares[name] = (request, limit)

    def remove_client(self, name: str) -> None:
        with self._cond:
            self._core.remove_client(name)
            self._grants.pop(name, None)
            self._holding.discard(name)
            self._shares.pop(name, None)
            self._cond.notify_all()

    def accounting(self) -> dict:
        """One consistent snapshot of the shares: per client its
        ``(request, limit)`` and whether it holds the token, plus the
        request sum, which must stay <= 1.0."""
        with self._cond:
            clients = {name: {"request": req, "limit": lim,
                              "holding": name in self._holding}
                       for name, (req, lim) in self._shares.items()}
            return {"clients": clients,
                    "share_sum": sum(c["request"] for c in clients.values()),
                    "waiting": [n for n, q in self._waiting.items() if q]}

    def acquire(self, name: str, timeout: float | None = None) -> float:
        """Block until *name* is granted the token; returns quota_ms."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            self._core.request_token(name)
            return self._wait_for_grant(name, deadline)

    def renew(self, name: str, used_ms: float,
              timeout: float | None = None) -> float:
        """Atomically release + re-request + wait for the next grant.

        The steady-state call: release and re-request happen under one
        lock, so this client is *waiting* when the freed token is handed
        out and stride weighting decides the order — a release-then-acquire
        pair would hand the token to whoever waited in the gap, collapsing
        shares to round-robin."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            self._core.release_token(name, used_ms, _now_ms())
            self._holding.discard(name)
            self._core.request_token(name)
            self._cond.notify_all()
            return self._wait_for_grant(name, deadline)

    def release(self, name: str, used_ms: float) -> None:
        with self._cond:
            self._core.release_token(name, used_ms, _now_ms())
            self._holding.discard(name)
            self._cond.notify_all()

    def window_usage(self, name: str) -> float:
        with self._cond:
            return self._core.window_usage(name, _now_ms())

    def close(self) -> None:
        with self._cond:
            self._core.close()
            # wake every waiter so it hits the closed-core error instead
            # of sleeping on a grant that can never come
            self._cond.notify_all()

    def _take_grant(self, name: str, q: deque) -> float:
        # caller holds self._cond; a grant for `name` exists and this
        # thread's ticket heads the queue. With more same-name waiters,
        # re-arm the core's request so the next release can grant again.
        quota = self._grants.pop(name)
        self._holding.add(name)
        if len(q) > 1:
            self._core.request_token(name)
            self._cond.notify_all()
        return quota

    def _wait_for_grant(self, name: str, deadline: float | None) -> float:
        # caller holds self._cond and has requested the token
        ticket = object()
        q = self._waiting.setdefault(name, deque())
        q.append(ticket)
        try:
            while True:
                result = self._core.poll(_now_ms())
                if isinstance(result, tuple):
                    granted, quota = result
                    self._grants[granted] = quota
                    self._cond.notify_all()
                if name in self._grants and q[0] is ticket:
                    return self._take_grant(name, q)
                try:
                    self._core.window_usage(name, _now_ms())
                except KeyError:
                    raise RuntimeError(f"{name}: client removed while "
                                       "waiting for token") from None
                if isinstance(result, tuple) or result == _INF:
                    wait = None
                else:
                    wait = max(0.001, (result - _now_ms()) / 1000.0)
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


def serve(scheduler: TokenScheduler, host: str = "127.0.0.1", port: int = 0
          ) -> protocol.FramedServer:
    """Expose a :class:`TokenScheduler` over framed-JSON TCP — the wire of
    ``kubeshare_tpu.isolation.tokensched.serve``, which pod managers and
    gates of either package speak.

    Requests: ``{"op": "register", "name", "request", "limit"}`` (creates
    the client; this connection owns it), ``{"op": "attach", "name"}``
    (binds an extra connection to an existing client — a pod manager's
    per-gate relay channels), ``{"op": "acquire"}`` (blocks; reply carries
    ``quota_ms``), ``{"op": "renew", "used_ms"}`` (atomic
    release+reacquire — the steady-state call), ``{"op": "release",
    "used_ms"}``, ``{"op": "usage"}``, ``{"op": "unregister"}``. Token ops
    act on the *connection-bound* identity (set by register/attach) — a
    connection can never name another pod's client. Replies: ``{"ok":
    true, ...}`` or ``{"ok": false, "error": msg}``. The owning
    connection's disconnect removes the client (≙ gem-schd dropping a dead
    pod manager); attached connections' disconnects don't.

    The gang (``gang_*``) and preemption (``preempt_*``) extensions answer
    the standard unknown-op error, as a JAX server started without a
    coordinator or a policy does. A register's ``"class"`` is accepted and
    ignored (the port keeps no per-class metrics yet).
    """
    def handle(req: dict, state: dict) -> dict:
        op = req.get("op")
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
                                     float(req["limit"]))
            else:
                scheduler.window_usage(name)  # KeyError if no such client
            state["name"] = name
            state["owner"] = op == "register"
            return {"ok": True}
        name = state.get("name")
        if not name:
            raise PermissionError("connection not bound (register/attach first)")
        if op == "acquire":
            return {"ok": True,
                    "quota_ms": scheduler.acquire(name,
                                                  timeout=req.get("timeout"))}
        if op == "renew":
            return {"ok": True,
                    "quota_ms": scheduler.renew(name, float(req["used_ms"]),
                                                timeout=req.get("timeout"))}
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

    return protocol.serve_framed(host, port, handle, cleanup)
