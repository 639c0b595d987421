"""Transparent reconnect-and-replay for isolation clients.

Counterpart of ``kubeshare_tpu/resilience/reconnect.py``.
:class:`ResilientConnection` wraps a
:class:`~..isolation.protocol.Connection` and keeps a session alive across
the peer dying: when the transport breaks (or a reply goes missing past
``request_timeout_s``) it re-dials with exponential backoff and jitter,
re-registers with the session's ``resume`` token, re-negotiates features
and *replays* every request whose reply no caller has observed yet, under
its original request id (``_rid``). The proxy answers a rid it already
handled from its reply cache, so nothing runs twice — which matters for a
step that updates its parameters in place.

A caller holding a future never sees the failure: :class:`ReplayableReply`
loops through recoveries until the real reply lands. Only when the budget
runs out (or the proxy refuses the token) does it surface, as
:class:`SessionLost`, a :class:`~..isolation.protocol.ProtocolError`. A
proxy that answers a resume with ``{"moved": [host, port]}`` (the
migration tombstone) redirects the reconnect, and the replay runs against
the destination.

The pod manager's break-and-reconnect uses the budget and the backoff
(:class:`ReconnectPolicy`, :func:`backoff_delays`) alone.

Recoveries are counted by outcome (``kubeshare_resilience_reconnects_
total``), their replay depth is a histogram, and a connection made with a
``trace_id`` (which rides every request) records a ``reconnect`` span per
resume.
"""

from __future__ import annotations

import random
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass

from ..isolation import protocol
from ..obs import metrics as obs_metrics
from ..obs.trace import get_tracer
from ..utils.logger import get_logger

log = get_logger("reconnect")

_REG = obs_metrics.default_registry()
_RECONNECTS = _REG.counter(
    "kubeshare_resilience_reconnects_total",
    "Client reconnect attempts by outcome: 'resumed' (session replayed "
    "onto a live proxy), 'moved' (migration tombstone redirected the "
    "endpoint), 'lost' (budget exhausted -> SessionLost).",
    labels=("outcome",))
_REPLAY_DEPTH = _REG.histogram(
    "kubeshare_resilience_replay_depth",
    "In-flight requests replayed per successful resume (how deep the "
    "pipeline was when the connection died).",
    buckets=(0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0))


class SessionLost(protocol.ProtocolError):
    """The reconnect budget is exhausted (or the peer refused the resume
    token): the session's server-side state must be presumed gone."""


@dataclass(frozen=True)
class ReconnectPolicy:
    """Backoff/budget knobs of a re-dial loop."""

    #: dial-and-resume attempts before giving up with SessionLost
    max_attempts: int = 8
    #: first retry delay; doubles per attempt (the first attempt is
    #: immediate — the common case is a peer that is already back)
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    #: fraction of the delay randomized (0.5 -> delay * [1.0, 1.5)) so a
    #: herd of clients does not re-dial a restarted peer in lockstep
    jitter: float = 0.5
    dial_timeout_s: float = 2.0
    #: when set, a reply unresolved for this long forces a reconnect and
    #: replay: the recovery of a lost reply on a healthy-looking
    #: connection. None = wait forever.
    request_timeout_s: float | None = None
    #: jitter seed; None draws from the process RNG
    seed: int | None = None


def backoff_delays(policy: ReconnectPolicy, rng: random.Random):
    """Yield the sleep before each attempt: 0 first, then exponential
    with multiplicative jitter, capped at ``max_delay_s``."""
    yield 0.0
    delay = policy.base_delay_s
    while True:
        yield delay * (1.0 + policy.jitter * rng.random())
        delay = min(delay * 2.0, policy.max_delay_s)


class _Record:
    """One request kept for replay until its caller observes the reply,
    so what is kept is bounded by the caller's own pipeline depth."""

    __slots__ = ("rid", "msg", "blob", "sink", "inner")

    def __init__(self, rid: int, msg: dict, blob, sink):
        self.rid = rid
        self.msg = msg
        self.blob = blob
        self.sink = sink
        self.inner: protocol.PendingReply | None = None


class ReplayableReply:
    """Future over a kept request: ``result()`` survives any number of
    reconnects underneath it. Quacks like
    :class:`~..isolation.protocol.PendingReply` (``done()``, ``sink``)."""

    __slots__ = ("_rc", "_rec")

    def __init__(self, rc: "ResilientConnection", rec: _Record):
        self._rc = rc
        self._rec = rec

    @property
    def sink(self):
        return self._rec.sink

    def done(self) -> bool:
        inner = self._rec.inner
        return inner is not None and inner.done()

    def wait(self, timeout: float | None = None) -> bool:
        inner = self._rec.inner
        return inner is not None and inner.wait(timeout)

    def result(self, timeout: float | None = None) -> tuple:
        rc = self._rc
        while True:
            with rc._mu:
                inner, epoch = self._rec.inner, rc._epoch
            if inner is None:
                # kept but on no wire (a recovery died mid-replay)
                rc._recover(epoch)
                continue
            try:
                eff = (rc.policy.request_timeout_s
                       if rc.policy.request_timeout_s is not None
                       else timeout)
                msg, blob = inner.result(timeout=eff)
            except TimeoutError:
                if rc.policy.request_timeout_s is None:
                    raise
                # a presumed-lost reply: fail the channel so every pending
                # future meets the same recovery, then replay
                rc._conn._break(protocol.ProtocolError(
                    "no reply within request_timeout (presumed lost)"))
                rc._recover(epoch)
                continue
            except SessionLost:
                raise
            except (protocol.ProtocolError, OSError):
                rc._recover(epoch)
                continue
            except RuntimeError:
                # the peer refused: the request WAS handled, an answer
                rc._finalize(self._rec)
                raise
            rc._finalize(self._rec)
            return msg, blob


class ResilientConnection:
    """Stands in for :class:`~..isolation.protocol.Connection` on the
    client side of a resumable session (``call``/``submit``/``flush``/
    ``pipelined``/``close`` keep their contracts). When the peer grants no
    ``"resume"`` it passes everything through: nothing kept, nothing
    replayed, failures surface as before."""

    def __init__(self, host: str, port: int, timeout: float | None = None,
                 policy: ReconnectPolicy | None = None,
                 fault_tag: str = "", trace_id: str = ""):
        self._host = host
        self._port = port
        self._dial_timeout = timeout
        self._trace_id = trace_id
        self.policy = policy if policy is not None else ReconnectPolicy()
        self.fault_tag = fault_tag
        self._rng = random.Random(self.policy.seed)
        self._mu = threading.RLock()
        # the endpoint has its own lock: a mover flips it from another
        # thread while a recovery (holding _mu through its backoff) runs,
        # and the flip must reach the very next dial
        self._ep_mu = threading.Lock()
        self._conn: protocol.Connection | None = None
        self.token: str | None = None
        self.features: frozenset[str] = frozenset()
        self._records: "OrderedDict[int, _Record]" = OrderedDict()
        self._next_rid = 0
        #: every rid <= _acked has had its reply seen (contiguously: an
        #: out-of-order observation must not prune an older cached reply)
        self._acked = 0
        self._hwm = 0            # highest rid ever finalized
        self._epoch = 0          # bumped per successful reconnect
        self._closing = False
        self._lost: Exception | None = None
        #: reconnects that resumed the session, and requests replayed
        self.resumes = 0
        self.replayed = 0

    # -- lifecycle -------------------------------------------------------

    def open(self, register_msg: dict) -> dict:
        """Dial and register; returns the register reply. A recovery
        re-registers with the token alone."""
        msg = dict(register_msg)
        msg.setdefault("features", list(protocol.FEATURES))
        conn = protocol.Connection(self._host, self._port,
                                   timeout=self._dial_timeout,
                                   trace_id=self.trace_id,
                                   fault_tag=self.fault_tag)
        try:
            reply, _ = conn.call(msg)
        except BaseException:
            conn.close()
            raise
        self.features = frozenset(reply.get("features", ()))
        self.token = reply.get("resume")
        if "seq" in self.features:
            conn.start_pipeline()
        self._conn = conn
        return reply

    @property
    def trace_id(self) -> str:
        """The trace id every request carries, across reconnects."""
        return self._trace_id

    @trace_id.setter
    def trace_id(self, trace_id: str) -> None:
        self._trace_id = trace_id
        conn = self._conn
        if conn is not None:
            conn.trace_id = trace_id

    @property
    def pipelined(self) -> bool:
        return self._conn is not None and self._conn.pipelined

    @property
    def healthy(self) -> bool:
        """False once the session is lost or the current channel broke."""
        if self._lost is not None or self._closing or self._conn is None:
            return False
        return self._conn._broken is None

    def set_endpoint(self, host: str, port: int) -> None:
        """Point later reconnects elsewhere (the migration flip), even a
        recovery already in its backoff. The live channel is untouched."""
        with self._ep_mu:
            self._host, self._port = host, int(port)

    @property
    def endpoint(self) -> tuple[str, int]:
        with self._ep_mu:
            return self._host, self._port

    def close(self) -> None:
        with self._mu:
            self._closing = True
        if self._conn is not None:
            self._conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- request paths ---------------------------------------------------

    def submit(self, msg: dict, blob=None, sink=None,
               defer: bool = False):
        if self.token is None:
            return self._conn.submit(msg, blob, sink=sink, defer=defer)
        with self._mu:
            if self._lost is not None:
                raise SessionLost(f"session lost: {self._lost}")
            self._next_rid += 1
            rec = _Record(self._next_rid, msg, blob, sink)
            self._records[rec.rid] = rec
            while True:
                wire = {**msg, protocol.RID_KEY: rec.rid,
                        protocol.ACK_KEY: self._acked}
                try:
                    rec.inner = self._conn.submit(wire, blob=blob,
                                                  sink=sink, defer=defer)
                    return ReplayableReply(self, rec)
                except protocol.FrameTooLarge:
                    # nothing hit the wire and nothing will
                    del self._records[rec.rid]
                    raise
                except (protocol.ProtocolError, OSError):
                    self._recover(self._epoch)
                    if rec.inner is not None:
                        # the recovery's replay carried this record
                        return ReplayableReply(self, rec)

    def call(self, msg: dict, blob=None, sink=None) -> tuple:
        if self.token is None:
            return self._conn.call(msg, blob, sink=sink)
        if self.pipelined:
            return self.submit(msg, blob, sink=sink).result()
        # a lockstep resumable session: the same replay, one at a time
        with self._mu:
            if self._lost is not None:
                raise SessionLost(f"session lost: {self._lost}")
            self._next_rid += 1
            rid = self._next_rid
        while True:
            with self._mu:
                conn, epoch, acked = self._conn, self._epoch, self._acked
            wire = {**msg, protocol.RID_KEY: rid, protocol.ACK_KEY: acked}
            try:
                reply, rblob = conn.call(wire, blob, sink=sink)
            except (protocol.FrameTooLarge, SessionLost):
                raise
            except OSError:   # ProtocolError included
                self._recover(epoch)
                continue
            with self._mu:
                self._hwm = max(self._hwm, rid)
                self._bump_ack()
            return reply, rblob

    def flush(self) -> None:
        try:
            self._conn.flush()
        except protocol.FrameTooLarge:
            raise
        except (OSError, RuntimeError):
            # recovered when a caller waits on a corked request's future
            pass

    # -- recovery --------------------------------------------------------

    def _finalize(self, rec: _Record) -> None:
        with self._mu:
            self._records.pop(rec.rid, None)
            self._hwm = max(self._hwm, rec.rid)
            self._bump_ack()

    def _bump_ack(self) -> None:
        # caller holds _mu; records are ordered by rid, so the first is
        # the oldest outstanding request and all below it were observed
        if self._records:
            first = next(iter(self._records))
            self._acked = max(self._acked, min(first - 1, self._hwm))
        else:
            self._acked = max(self._acked, self._hwm)

    def _recover(self, failed_epoch: int) -> None:
        """Re-dial, resume, replay. Serialized by ``_mu``: the first
        failure does the work, the rest see the epoch moved and re-wait."""
        with self._mu:
            if self._lost is not None:
                raise SessionLost(f"session lost: {self._lost}")
            if self._closing:
                raise SessionLost("connection closed")
            if self._epoch != failed_epoch:
                return
            t0 = time.monotonic()
            delays = backoff_delays(self.policy, self._rng)
            attempts = 0
            last_err: Exception | None = None
            while attempts < self.policy.max_attempts:
                attempts += 1
                time.sleep(next(delays))
                host, port = self.endpoint   # a flip may land mid-backoff
                try:
                    conn = protocol.Connection(
                        host, port, timeout=self.policy.dial_timeout_s,
                        trace_id=self.trace_id, fault_tag=self.fault_tag)
                except OSError as exc:
                    last_err = exc
                    continue
                try:
                    reply, _ = conn.call({
                        "op": "register", "resume": self.token,
                        "features": list(protocol.FEATURES)})
                except RuntimeError as exc:
                    conn.close()
                    text = str(exc)
                    if "migrating" in text or "still attached" in text:
                        last_err = exc      # transient: retry
                        continue
                    # a permanent refusal (unknown token: state is gone)
                    self._lost = exc
                    _RECONNECTS.inc("lost")
                    raise SessionLost(f"resume refused: {exc}") from exc
                except OSError as exc:
                    conn.close()
                    last_err = exc
                    continue
                if reply.get("moved"):
                    host, port = reply["moved"]
                    self.set_endpoint(str(host), int(port))
                    conn.close()
                    _RECONNECTS.inc("moved")
                    last_err = protocol.ProtocolError(
                        f"session moved to {host}:{port}")
                    continue
                self._resume_on(conn, reply, t0, attempts)
                return
            self._lost = last_err or protocol.ProtocolError(
                "reconnect budget exhausted")
            _RECONNECTS.inc("lost")
            raise SessionLost(
                f"session lost after {attempts} reconnect attempts: "
                f"{last_err}") from last_err

    def _resume_on(self, conn: protocol.Connection, reply: dict,
                   t0: float, attempts: int) -> None:
        # caller holds _mu
        conn.sock.settimeout(None)
        self.features = frozenset(reply.get("features", ()))
        if "seq" in self.features:
            conn.start_pipeline()
        self._conn = conn
        self._epoch += 1
        nreplay = len(self._records)
        self.resumes += 1
        self.replayed += nreplay
        _REPLAY_DEPTH.observe(value=float(nreplay))
        _RECONNECTS.inc("resumed")
        for rec in self._records.values():     # rid (submission) order
            rec.inner = self._replay_one(conn, rec)
        if self.trace_id:
            get_tracer().record(
                "reconnect", self.trace_id, t0 * 1000.0,
                time.monotonic() * 1000.0, attempts=attempts,
                replayed=nreplay)
        log.info("session resumed on %s:%d after %d attempt(s), "
                 "replaying %d request(s)", *self.endpoint, attempts,
                 len(self._records))

    def _replay_one(self, conn: protocol.Connection,
                    rec: _Record) -> protocol.PendingReply:
        wire = {**rec.msg, protocol.RID_KEY: rec.rid,
                protocol.ACK_KEY: self._acked}
        if conn.pipelined:
            try:
                return conn.submit(wire, blob=rec.blob, sink=rec.sink)
            except OSError as exc:
                # the fresh channel died mid-replay: fail THIS future so
                # its waiter drives the next recovery
                rep = protocol.PendingReply(rec.sink)
                rep._fail(protocol.ProtocolError(f"replay failed: {exc}"))
                return rep
        # a lockstep resumed session: run it now into a resolved future
        rep = protocol.PendingReply(rec.sink)
        try:
            msg, blob = conn.call(wire, blob=rec.blob, sink=rec.sink)
            rep._resolve(msg, blob)
        except RuntimeError as exc:
            rep._resolve({"ok": False, "error": str(exc)}, None)
        except OSError as exc:
            rep._fail(protocol.ProtocolError(f"replay failed: {exc}"))
        return rep
