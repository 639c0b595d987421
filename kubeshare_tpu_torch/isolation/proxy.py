"""The chip proxy: one process owns the card, clients execute through it.

Counterpart of ``kubeshare_tpu/isolation/proxy.py`` on one CUDA device.
The :class:`ChipProxy` is the one process that touches the card; client
threads or pods stage their state on the host with numpy, ``put`` it, and
then run programs on device-resident buffers addressed by handle, so a
training loop ships its parameters once. A program is a registered loop
spec (:mod:`.programs`) or a tenant's own function, traced and saved by
:mod:`.exported` on the client (the proxy-mode attach ships every
``torch.compile``'d call so). A loop program — a spec, or a saved function
compiled with ``ncarry`` — runs ``repeat`` steps a burst, its carry
threaded through; any other saved program runs once a call.

Enforcement lives where the JAX proxy's lives:

- **compute** — every execution is gated by the per-device token
  scheduler (:mod:`.tokensched`): a client acquires a quota, keeps the
  token across back-to-back bursts until the quota is spent, then renews;
  an idle watchdog returns the token when a client stalls. The device time
  charged is measured up to a completion barrier
  (``torch.cuda.synchronize``) inside the timed window — torch launches
  asynchronously, and without the barrier the charge would be launch time;
- **memory** — device bytes are charged per client before they are
  allocated (``put``, staged uploads, execution outputs), against the
  client's cap. Buffers are charged by storage: an output that is one of
  its inputs (an in-place update returned) or another output holds one
  charge however many handles name it, and freeing one handle leaves the
  others valid.

Sessions outlive their connection. A client that negotiates ``"resume"``
gets a token: when its connection dies the session is parked for
``DETACH_GRACE_MS``, a reconnect re-attaches it by token, and replayed
requests (``_rid``) are answered from a reply cache, so a step is never
run twice — a port step updates its parameters in place. With a journal
directory every such session is mirrored on disk
(:mod:`..resilience.journal`) and a restarted proxy brings it back; the
admin ops move it to another proxy (:mod:`..resilience.migrate`).
``"seq"`` pipelines the connection.

Each session has a workload class (``"class"`` at register, kept by the
journal and a migration). With a preemption policy on the scheduler, a
latency session waiting behind a best-effort holder marks it preempted,
and the holder yields the token at its next program boundary — between
two bursts of a chain, never in the middle of one (:class:`~kubeshare_
tpu_torch.preempt.BoundarySlicer`); a chain's reply counts its slices
(``"sliced"``) for a peer that negotiated ``"preempt"``.

The proxy feeds the observability plane where the JAX proxy feeds its own:
a proxy built without a scheduler gets one that feeds the process's
chip-time ledger and blame graph (``obs.ledger.default_ledger``,
``obs.blame.default_blame``); the token gate brackets every execute with
the scheduler's ``execute_begin`` / ``execute_end``, so the ledger's
``granted-active`` interval closes after the completion barrier; a traced
session's grants and executes carry its trace id; the RPC latency,
resume, detach and replay families, and the flight recorder's notes on
detach and resume. With ``--remote-write`` the CLI pushes the process's
metrics to the registry's fleet TSDB, as the JAX proxy does.
"""

from __future__ import annotations

import os
import socket
import threading
import time
import uuid
from collections import OrderedDict, deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..obs.blame import default_blame
from ..obs.flight import default_recorder as flight_default_recorder
from ..obs.ledger import default_ledger
from ..preempt.slicer import BoundarySlicer
from ..resilience import faults as _faults
from ..resilience.journal import SessionJournal, valid_token
from ..topology.discovery import device_chip_id
from ..utils.device import resolve_device, synchronize
from ..utils.logger import get_logger
from . import exported, programs, protocol
from .protocol import load_array
from .tokensched import TokenScheduler

log = get_logger("proxy")

#: a session that holds the token and has not executed for this long has
#: stopped: the watchdog returns its token. Above the reference's 10 ms: a
#: proxy-attached tenant calls over the lockstep wire and spends 5–12 ms
#: between its steps (its uploads, the loss fetch, its own Python), so at
#: 10 ms the token went back whenever a gap ran long and was granted to
#: whichever tenant waited then, out of stride order (on an H100 host a
#: 0.25 tenant beside a 0.75 one was charged up to 0.33 of the token at
#: 10 ms, 0.25–0.26 at 50 ms; ``scripts/torch_proxy_pairs.py``)
IDLE_RELEASE_MS = 50.0

#: how long a detached resumable session is kept before the watchdog
#: reclaims it; a client's reconnect budget must fit inside
DETACH_GRACE_MS = 30_000.0

#: the transport features this proxy serves
SERVED_FEATURES = ("preempt", "resume", "seq")

#: how long a resume waits for a migration of its session to end before
#: it is refused (retryable): under the client's 2 s dial timeout, so a
#: resuming client's retries span a move instead of spending its budget
#: in refusals while the bytes are in flight (a full-width LM session
#: moves in 3–4 s on an H100 host, where the reference's instant refusal
#: left a default client one attempt to spare)
MIGRATION_WAIT_S = 1.0

#: the ops the RPC latency family labels by name (any other is "other")
_KNOWN_OPS = frozenset((
    "register", "put", "put_begin", "put_chunk", "put_commit", "put_abort",
    "get", "free", "compile", "execute", "usage", "unregister",
    "drain", "migrate_begin", "migrate_abort", "migrate_finish",
    "export_session", "export_buffer", "export_program", "import_session",
    "import_buffer_begin", "import_buffer_chunk", "import_buffer_commit",
    "import_program"))
#: control-plane ops addressed by resume token, not connection identity:
#: the mover is no registered client, holding the token is the capability
_ADMIN_OPS = frozenset((
    "drain", "migrate_begin", "migrate_abort", "migrate_finish",
    "export_session",
    "export_buffer", "export_program", "import_session",
    "import_buffer_begin", "import_buffer_chunk", "import_buffer_commit",
    "import_program"))
#: ops without side effects, or idempotent: a replayed rid whose reply is
#: not cached (it carried a payload, or fell out of the cache) runs again
_REPLAY_REEXEC = frozenset(("get", "usage", "free", "put_abort",
                            "put_chunk"))
#: ops after which the journal's manifest is rewritten
_JOURNALED_OPS = frozenset(("put", "put_begin", "put_commit", "put_abort",
                            "compile", "execute", "free"))
#: largest staged transfer (put_begin, import_buffer_begin)
_MAX_STAGED = 64 << 30

_OBS = obs_metrics.default_registry()
_RPC_LAT = _OBS.histogram(
    "kubeshare_proxy_rpc_latency_seconds",
    "Chip-proxy RPC handling wall time per op (token waits and device "
    "time included).", labels=("op",))
_RESUMES = _OBS.counter(
    "kubeshare_proxy_session_resumes_total",
    "Sessions re-attached via a resume token after their connection "
    "died.")
_DETACHES = _OBS.counter(
    "kubeshare_proxy_session_detaches_total",
    "Resumable sessions whose connection died (state parked, awaiting "
    "resume or grace expiry).")
_DETACHED = _OBS.gauge(
    "kubeshare_proxy_sessions_detached",
    "Resumable sessions currently parked without a connection.")
_REPLAY_SERVED = _OBS.counter(
    "kubeshare_proxy_replay_served_total",
    "Replayed requests answered from the per-session reply cache (or "
    "re-executed idempotently) instead of being executed twice.")


def _now_ms() -> float:
    return time.monotonic() * 1000.0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor) -> tuple[int, int]:
    """``(key, bytes)`` of the memory under ``t``: tensors that share a
    storage (views, an output that is its input) share the key."""
    st = t.untyped_storage()
    return st.data_ptr(), st.nbytes()


def _view_key(t: torch.Tensor) -> tuple:
    """Equal for two tensors that are the same view of the same memory:
    the handles that name one tensor travel (journal, migration) once."""
    return (t.data_ptr(), t.dtype, tuple(t.shape), t.stride())


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes as numpy (bfloat16 as its int16 bits)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy()


def _from_host(arr: np.ndarray, dtype_name: str, shape) -> torch.Tensor:
    """:func:`_to_host`'s inverse, held to the dtype and shape that a
    manifest or an import names."""
    dtype = programs.torch_dtype(dtype_name)
    raw = "int16" if dtype == torch.bfloat16 else dtype_name
    if arr.dtype.name != raw or list(arr.shape) != [int(d) for d in shape]:
        raise ValueError(f"a {arr.dtype.name}{list(arr.shape)} array is not "
                         f"the {dtype_name}{list(shape)} tensor named")
    t = torch.from_numpy(np.asarray(arr, order="C"))
    return t.view(dtype) if dtype == torch.bfloat16 else t


@dataclass
class _Cost:
    """Burst cost model, shared across sessions by program identity:
    ``burst_ms ≈ step_ms + (n-1) * loop_step_ms``. The first step of a
    burst carries the fixed per-dispatch cost (launch, barrier), in-loop
    steps only device time."""
    step_ms: float = 0.0          # EMA of a 1-step burst
    loop_step_ms: float = 0.0     # EMA of the per-step time inside a burst


@dataclass
class _Executable:
    exec_id: int
    #: a registered loop program, or a saved one (:class:`.exported.
    #: Program`)
    program: "programs.Program | exported.Program"
    in_meta: list                 # (shape tuple, torch dtype) per argument
    out_nbytes: int
    ncarry: int | None            # None: a saved program, run once a call
    cost: _Cost
    warmed: bool = False          # its first (warm-up) burst has run

    def step(self, carry: list, consts: list) -> tuple[list, list]:
        """One step of a loop program: ``(carry, aux)``."""
        if isinstance(self.program, programs.Program):
            return self.program(carry, consts)
        outs = self.program(*carry, *consts)
        return outs[:self.ncarry], outs[self.ncarry:]


@dataclass
class _Session:
    name: str
    request: float
    limit: float
    memory_cap: int               # bytes; 0 = uncapped
    tpu_class: str = "best-effort"
    buffers: dict = field(default_factory=dict)
    #: storage key -> [bytes, handles on it]: the charge of each storage
    storages: dict = field(default_factory=dict)
    executables: dict = field(default_factory=dict)
    hbm_used: int = 0
    next_id: int = 0
    # token state (guarded by lock)
    lock: threading.Lock = field(default_factory=threading.Lock)
    holding: bool = False
    busy: bool = False            # an execution is in flight right now
    quota_ms: float = 0.0
    used_ms: float = 0.0
    last_end_ms: float = 0.0
    exec_count: int = 0
    exec_ms_total: float = 0.0
    #: yields of a hold marked preempted, at a program boundary
    preempt_yields: int = 0
    #: the trace id its latest request carried (its connection's, from
    #: register on): the grants it waits for are spans of that trace
    trace_id: str = ""
    # chunked transfers: one serialized buffer served in slices, as
    # (handle, parts, total bytes); staged uploads as sid -> (total,
    # bytearray, bytes reserved at begin)
    fetch_cache: tuple | None = None
    staging: dict = field(default_factory=dict)
    # -- resilience (resumable sessions only) -----------------------------
    features: frozenset = frozenset()
    #: capability to re-attach or move the session; empty = dropped with
    #: its connection
    resume_token: str = ""
    attached: bool = True
    detached_at: float = 0.0
    #: set while no connection owns the session
    detach_ev: threading.Event = field(default_factory=threading.Event)
    migrating: bool = False
    #: severs the owning connection (a resume or a migration kicks it)
    disconnect: object = None
    #: replay state: the highest request id handled, and the replies of
    #: the latest ones (no payload-bearing reply is kept)
    last_rid: int = 0
    replies: OrderedDict = field(default_factory=OrderedDict)
    #: staged uploads a detach invalidated: a replayed chunk of one is
    #: refused with a restart-the-upload error
    aborted_staging: set = field(default_factory=set)
    #: exec_id -> how to build the program again: {"ncarry", "blob"} for a
    #: saved program, {"ncarry", "spec", "in_meta"} for a registered one
    programs: dict = field(default_factory=dict)
    #: imports in flight: staging sid -> handle, handle -> manifest entry
    import_handles: dict = field(default_factory=dict)
    import_specs: dict = field(default_factory=dict)
    #: the journal's generation of each handle's tensor, the generations
    #: on disk, and the last one given out
    gens: dict = field(default_factory=dict)
    disk_gens: set = field(default_factory=set)
    next_gen: int = 0

    def fresh_id(self) -> int:
        self.next_id += 1
        return self.next_id


def _bucket(n: int) -> int:
    """Largest power of two ≤ n — the burst lengths the proxy runs, as in
    the JAX proxy, so the cost model sees the same burst sizes."""
    return 1 << (max(1, int(n)).bit_length() - 1)


class _FifoLock:
    """A FIFO mutex: hands the lock to the longest waiter, so a client's
    put or compile is never starved behind another client's hot loop."""

    def __init__(self):
        self._mu = threading.Lock()
        self._waiters: deque[threading.Event] = deque()
        self._held = False

    def __enter__(self):
        with self._mu:
            if not self._held and not self._waiters:
                self._held = True
                return self
            ev = threading.Event()
            self._waiters.append(ev)
        ev.wait()  # ownership is handed off in __exit__
        return self

    def __exit__(self, *exc):
        with self._mu:
            if self._waiters:
                self._waiters.popleft().set()
            else:
                self._held = False
        return False


class HBMError(RuntimeError):
    pass


class _ExecutionError(Exception):
    """An exception raised by the device execution itself, as opposed to a
    token-gate failure, which happens before anything was dispatched."""

    def __init__(self, cause: BaseException):
        super().__init__(str(cause))
        self.cause = cause


class ChipProxy:
    """Owns one device; serves the framed-JSON execution protocol.

    ``device`` defaults to the CUDA card; tests pass ``"cpu"``, which runs
    the same code with the kernels' plain versions. ``journal_dir`` mirrors
    every resumable session on disk, and :meth:`serve` restores the
    sessions journaled there before it accepts a connection. Without a
    ``scheduler`` it builds one keyed by the device's discovery id that
    feeds the process's chip-time ledger and blame graph."""

    #: bursts per chained call: bounds one reply's latency
    MAX_CHAIN_BURSTS = 32
    #: cost models kept (least recently used dropped)
    PROGRAMS_CAP = 32
    #: replies kept per session for replay
    REPLAY_CACHE = 256

    def __init__(self, device=None, scheduler: TokenScheduler | None = None,
                 idle_release_ms: float = IDLE_RELEASE_MS,
                 journal_dir: str | None = None,
                 detach_grace_ms: float = DETACH_GRACE_MS):
        self.device = resolve_device(device)
        self.platform = self.device.type
        self.scheduler = (scheduler if scheduler is not None
                          else TokenScheduler(
                              chip=device_chip_id(self.device),
                              ledger=default_ledger(),
                              blame=default_blame()))
        # program-boundary slicing: between gated bursts the proxy asks
        # whether the hold was preempted and yields by renew, never in
        # the middle of an execute (the slicer refuses then, and counts)
        self.slicer = BoundarySlicer(self.scheduler)
        self.idle_release_ms = idle_release_ms
        self.detach_grace_ms = detach_grace_ms
        self.journal = SessionJournal(journal_dir)
        self._sessions: dict[str, _Session] = {}
        self._by_token: dict[str, _Session] = {}
        #: token -> (host, port) left by migrate_finish: a resuming client
        #: is sent on to the destination
        self._moved: dict[str, tuple[str, int]] = {}
        self._draining = False
        self._crashed = False
        self._recovered = False
        #: sessions restored from the journal (the last serve), and
        #: replayed requests answered without running again
        self.restored: list[str] = []
        self.replays_served = 0
        self._slock = threading.Lock()
        # Serializes every device interaction (put/get/execute). Taken
        # INSIDE the token gate, never around it, so there is no ordering
        # cycle with the scheduler's own blocking.
        self._dlock = _FifoLock()
        self._costs: dict[str, _Cost] = {}
        self._server: protocol.FramedServer | None = None
        self._stop = threading.Event()
        self._watchdog: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------------

    def serve(self, host: str = "127.0.0.1", port: int = 0
              ) -> protocol.FramedServer:
        recover = None
        if self.journal.enabled and not self._recovered:
            # restored once the socket listens and before the first
            # connection is accepted: a client re-dialing meanwhile waits
            # in the backlog, and never meets a half-restored proxy
            self._recovered = True
            recover = self._recover_sessions
        self._server = protocol.serve_framed(host, port, self._handle_timed,
                                             self._cleanup,
                                             sink=self._blob_sink,
                                             prepare=recover)
        self._watchdog = threading.Thread(target=self._watch_idle,
                                          daemon=True,
                                          name="proxy-idle-watchdog")
        self._watchdog.start()
        log.info("chip proxy serving %s on %s:%d", self.device,
                 *self._server.server_address[:2])
        return self._server

    @property
    def port(self) -> int:
        if self._server is None:
            raise RuntimeError("proxy is not serving")
        return self._server.server_address[1]

    def close(self) -> None:
        self._stop.set()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._watchdog is not None:
            self._watchdog.join(timeout=5.0)
        with self._slock:
            names = list(self._sessions)
        for name in names:
            self._drop_session(name)
        self.scheduler.close()

    def drain(self) -> None:
        """Admit no new session and return idle tokens fast: how a card
        is emptied before its sessions move."""
        self._draining = True
        self.idle_release_ms = min(self.idle_release_ms, 2.0)
        log.info("proxy draining: new sessions refused")

    @property
    def draining(self) -> bool:
        return self._draining

    def crash(self, wait: bool = False) -> None:
        """A hard stop for fault injection: the listener and every live
        connection die at once, no cleanup runs, and the journal is
        written no more — the closest a test gets to ``kill -9`` without
        losing the process. Recovery must come from the journal alone.
        ``wait`` returns once the listening socket is closed, so another
        proxy may bind its port (not from a handler of this proxy)."""
        self._crashed = True
        self._stop.set()
        srv, self._server = self._server, None
        if srv is None:
            return
        with srv._conn_mu:
            socks = list(srv._conn_socks)
        for s in socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        # shutdown() joins the serve_forever loop: off this thread, so a
        # crash from a handler cannot wait on itself
        closer = threading.Thread(
            target=lambda: (srv.shutdown(), srv.server_close()),
            daemon=True)
        closer.start()
        if wait:
            closer.join()

    # -- sessions ------------------------------------------------------------

    def _register(self, name: str, request: float, limit: float,
                  memory: int, tpu_class: str) -> _Session:
        with self._slock:
            if name in self._sessions:
                raise ValueError(f"duplicate client {name}")
            self.scheduler.add_client(name, request, limit,
                                      tpu_class=tpu_class)
            sess = _Session(name, request, limit, memory, tpu_class)
            self._sessions[name] = sess
            return sess

    def _session(self, name: str) -> _Session:
        with self._slock:
            try:
                return self._sessions[name]
            except KeyError:
                raise KeyError(f"unknown client {name!r}") from None

    def _drop_session(self, name: str, purge: bool = False) -> None:
        with self._slock:
            sess = self._sessions.pop(name, None)
            if sess is not None and sess.resume_token:
                self._by_token.pop(sess.resume_token, None)
        if sess is None:
            return
        if sess.resume_token and not sess.attached:
            _DETACHED.inc(amount=-1.0)
        with sess.lock:
            holding, used = sess.holding, sess.used_ms
            sess.holding = False
        if holding:
            try:
                self.scheduler.release(name, used)
            except (KeyError, ValueError, RuntimeError):
                pass  # already removed or scheduler closed
        self.scheduler.remove_client(name)
        sess.buffers.clear()
        sess.executables.clear()
        sess.staging.clear()
        if purge and sess.resume_token and not self._crashed:
            self.journal.purge(sess.resume_token)
        log.info("client %s dropped (freed %d bytes)", name, sess.hbm_used)

    def _detach_session(self, sess: _Session) -> None:
        """The connection of a resumable session died: park the session.
        What belongs to the connection goes — the token (a parked client
        must not hold the card), the fetch cache, and every open staged
        upload, whose bytes can never complete (its reservation is
        released and its id remembered, so a replayed chunk is refused)."""
        with sess.lock:
            holding, used = sess.holding, sess.used_ms
            sess.holding = False
        if holding:
            try:
                self.scheduler.release(sess.name, used)
            except (KeyError, ValueError, RuntimeError):
                pass
        with self._slock:
            for sid, (_total, _raw, charged) in sess.staging.items():
                sess.hbm_used -= charged
                sess.aborted_staging.add(sid)
            sess.staging.clear()
            while len(sess.aborted_staging) > 256:
                sess.aborted_staging.pop()
            sess.fetch_cache = None
            sess.attached = False
            sess.detached_at = _now_ms()
            sess.disconnect = None
        sess.detach_ev.set()
        _DETACHES.inc()
        _DETACHED.inc()
        flight_default_recorder().note("proxy", "session-detached",
                                       client=sess.name,
                                       trace_id=sess.trace_id,
                                       hbm_parked=sess.hbm_used)
        self._journal_checkpoint(sess)
        log.info("client %s detached (%d bytes parked)", sess.name,
                 sess.hbm_used)

    def hbm_accounting(self) -> dict[str, dict]:
        """Per session: bytes charged against the bytes of live buffers
        (each storage counted once) and staged-upload reservations.
        Sample at quiesce — an execution in flight carries a transient
        output charge with no buffer yet."""
        out = {}
        with self._slock:
            sessions = list(self._sessions.values())
        for sess in sessions:
            live = sum(dict(map(_storage, sess.buffers.values())).values())
            staged = sum(c for (_t, _r, c) in sess.staging.values())
            out[sess.name] = {"hbm_used": sess.hbm_used,
                              "buffer_bytes": live,
                              "staged_bytes": staged,
                              "memory_cap": sess.memory_cap,
                              "balanced": sess.hbm_used == live + staged}
        return out

    # -- memory accounting ---------------------------------------------------

    def _charge(self, sess: _Session, nbytes: int) -> None:
        if sess.memory_cap and sess.hbm_used + nbytes > sess.memory_cap:
            raise HBMError(f"{sess.name}: device memory cap exceeded "
                           f"({sess.hbm_used} + {nbytes} > "
                           f"{sess.memory_cap})")
        sess.hbm_used += nbytes

    def _bind(self, sess: _Session, handle: int, t: torch.Tensor) -> None:
        """Name ``t`` by ``handle``; its storage is charged with its first
        handle."""
        key, nbytes = _storage(t)
        refs = sess.storages.get(key)
        if refs is None:
            sess.storages[key] = [nbytes, 1]
            sess.hbm_used += nbytes
        else:
            refs[1] += 1
        sess.buffers[handle] = t

    def _store(self, sess: _Session, outs: list, precharged: int
               ) -> list[int]:
        """A handle for each tensor of ``outs``. The ``precharged`` bytes,
        charged before the tensors existed, become the charge of the
        storages they hold: once per storage, however many handles share
        it (an output that is an input, or another output)."""
        sess.hbm_used -= precharged
        handles = []
        for t in outs:
            handle = sess.fresh_id()
            self._bind(sess, handle, t)
            handles.append(handle)
        return handles

    def _forget_buffer(self, sess: _Session, handle: int):
        """Drop one handle (freed or donated); its storage's charge goes
        with the last handle on it."""
        buf = sess.buffers.pop(int(handle), None)
        if buf is not None:
            key, _ = _storage(buf)
            refs = sess.storages[key]
            refs[1] -= 1
            if refs[1] == 0:
                del sess.storages[key]
                sess.hbm_used -= refs[0]
            if sess.fetch_cache and sess.fetch_cache[0] == int(handle):
                sess.fetch_cache = None
        return buf

    # -- journal -------------------------------------------------------------

    def _journaling(self, sess: _Session) -> bool:
        return (bool(sess.resume_token) and self.journal.enabled
                and not self._crashed)

    def _manifest(self, sess: _Session) -> dict:
        """The session as the journal and a migration carry it. Handles
        that name one tensor share a generation and point at their first
        handle (``alias_of``)."""
        first: dict = {}
        buffers = []
        for h in sorted(sess.buffers):
            t = sess.buffers[h]
            lead = first.setdefault(_view_key(t), h)
            buffers.append({"handle": int(h), "shape": list(t.shape),
                            "dtype": programs.dtype_name(t.dtype),
                            "nbytes": _nbytes(t), "gen": sess.gens.get(h),
                            "alias_of": None if lead == h else int(lead)})
        progs = []
        for exec_id, rec in sorted(sess.programs.items()):
            entry = {"exec_id": int(exec_id), "ncarry": rec["ncarry"]}
            if "spec" in rec:
                entry.update(spec=rec["spec"], in_meta=rec["in_meta"])
            progs.append(entry)
        return {"token": sess.resume_token, "name": sess.name,
                "request": sess.request, "limit": sess.limit,
                "memory": sess.memory_cap, "class": sess.tpu_class,
                "trace_id": sess.trace_id,
                "features": sorted(sess.features),
                "next_id": sess.next_id, "last_rid": sess.last_rid,
                "buffers": buffers, "programs": progs,
                "staging": sorted(int(s) for s in sess.staging),
                "aborted": sorted(int(s) for s in sess.aborted_staging),
                "replies": [[int(r), rep] for r, rep in sess.replies.items()]}

    def _journal_tensors(self, sess: _Session, tensors) -> None:
        """Write each of ``tensors`` (new, or changed in place) to a new
        generation, for every handle on it. The manifest switches to them
        at the next checkpoint; the old files go after it."""
        if not self._journaling(sess):
            return
        dirty = {_view_key(t): t for t in tensors}
        handles: dict = {}
        for h, t in sess.buffers.items():
            key = _view_key(t)
            if key in dirty:
                handles.setdefault(key, []).append(h)
        for key, hs in handles.items():
            sess.next_gen += 1
            with self._dlock:
                host = _to_host(dirty[key])
            self.journal.save_buffer(sess.resume_token, sess.next_gen, host)
            sess.disk_gens.add(sess.next_gen)
            for h in hs:
                sess.gens[h] = sess.next_gen

    def _journal_checkpoint(self, sess: _Session) -> None:
        """Rewrite the manifest, then delete the generations it no longer
        names: one atomic rename moves the session from one consistent
        state to the next."""
        if not self._journaling(sess):
            return
        missing = [t for h, t in sess.buffers.items() if h not in sess.gens]
        if missing:
            self._journal_tensors(sess, missing)
        sess.gens = {h: g for h, g in sess.gens.items() if h in sess.buffers}
        self.journal.checkpoint(self._manifest(sess))
        if self._crashed:
            return                  # a crash mid-checkpoint: disk is frozen
        stale = sess.disk_gens - set(sess.gens.values())
        for gen in stale:
            self.journal.drop_buffer(sess.resume_token, gen)
        sess.disk_gens -= stale

    def _recover_sessions(self) -> None:
        self.restored = []
        for manifest in self.journal.recover():
            try:
                self._restore_session(manifest)
                self.restored.append(str(manifest["name"]))
            except Exception as exc:
                log.warning("journal recovery of session %r failed, "
                            "nothing of it loaded: %s",
                            manifest.get("name"), exc)

    def _restore_session(self, m: dict) -> None:
        """One journaled session back on the device. Its programs go
        through the compile checks first; if anything fails, nothing of
        the session is kept."""
        name, token = str(m["name"]), str(m["token"])
        if not valid_token(token):
            raise ValueError("not a resume token this proxy minted")
        with self._slock:
            if name in self._sessions or token in self._by_token:
                return
        sess = self._new_session(m)
        for p in m.get("programs", ()):
            exec_id = int(p["exec_id"])
            rec = {"ncarry": p.get("ncarry")}
            if "spec" in p:
                rec.update(spec=p["spec"], in_meta=p["in_meta"])
            else:
                rec["blob"] = self.journal.load_program(token, exec_id)
            self._install_program(sess, rec, exec_id, journal=False)
        tensors: dict = {}
        for b in m.get("buffers", ()):
            gen = int(b["gen"])
            if gen not in tensors:
                arr = self.journal.load_buffer(token, gen)
                host = _from_host(arr, b["dtype"], b["shape"])
                with self._dlock:
                    tensors[gen] = host.to(self.device)
            t = tensors[gen]
            if (programs.dtype_name(t.dtype) != b["dtype"]
                    or list(t.shape) != list(b["shape"])):
                raise ValueError(f"handle {b['handle']}: generation {gen} "
                                 f"is not a {b['dtype']}{b['shape']}")
            self._bind(sess, int(b["handle"]), t)
            sess.gens[int(b["handle"])] = gen
        sess.disk_gens = set(sess.gens.values())
        sess.next_gen = max(sess.disk_gens, default=0)
        self._admit_parked(sess)
        log.info("recovered session %s from the journal (%d buffers, %d "
                 "programs, last_rid=%d)", name, len(sess.buffers),
                 len(sess.programs), sess.last_rid)

    def _new_session(self, m: dict) -> _Session:
        """A parked session from a manifest (journal or migration), not
        yet known to the scheduler."""
        sess = _Session(str(m["name"]), float(m["request"]),
                        float(m["limit"]), int(m.get("memory", 0)),
                        str(m.get("class", "best-effort")))
        sess.features = frozenset(protocol.negotiate_features(
            m.get("features", ()), SERVED_FEATURES))
        sess.resume_token = str(m["token"])
        sess.trace_id = str(m.get("trace_id", ""))
        sess.next_id = int(m.get("next_id", 0))
        sess.last_rid = int(m.get("last_rid", 0))
        sess.replies = OrderedDict(
            (int(rid), dict(rep)) for rid, rep in m.get("replies", []))
        # open uploads can never complete across a crash or a move: the
        # client restarts them
        sess.aborted_staging = {int(s) for s in m.get("staging", [])}
        sess.aborted_staging |= {int(s) for s in m.get("aborted", [])}
        sess.attached = False
        sess.detached_at = _now_ms()
        sess.detach_ev.set()
        return sess

    def _admit_parked(self, sess: _Session) -> None:
        with self._slock:
            if sess.name in self._sessions:
                raise ValueError(f"session {sess.name!r} already exists")
            if sess.resume_token in self._by_token:
                raise ValueError("resume token already present")
            self.scheduler.add_client(sess.name, sess.request, sess.limit,
                                      tpu_class=sess.tpu_class)
            self._sessions[sess.name] = sess
            self._by_token[sess.resume_token] = sess
        _DETACHED.inc()

    # -- token gate ----------------------------------------------------------

    def _gated(self, sess: _Session, fn, timing: dict):
        """Run ``fn()`` under the device token (Gemini burst semantics).

        ``fn`` records its device time in ``timing["exec_ms"]`` (from the
        moment it holds the device lock to its completion barrier), and
        that is what is charged: wall time around ``fn()`` would bill a
        client for another connection's put holding the lock.

        A spent quota is *renewed* — an atomic release + re-request —
        rather than released and re-acquired, which would collapse
        request-weighted shares to round-robin. Idle clients return the
        token through the watchdog.

        A hold marked preempted (``TokenScheduler.preempted``) renews here
        too: this gate sits at a program boundary, so the yield forfeits
        the rest of the quantum without interrupting an execute, and the
        scheduler's directed grants hand the token to the higher-class
        waiter and then straight back.

        The scheduler's ``execute_begin`` / ``execute_end`` bracket
        ``fn()``: the chip-time ledger's ``granted-active`` interval holds
        the device-lock wait and the execute up to its completion barrier,
        never the launch alone."""
        with sess.lock:
            sess.busy = True
            holding = sess.holding
            exhausted = holding and sess.used_ms >= sess.quota_ms
            used = sess.used_ms
        preempted = (holding and not exhausted
                     and self.slicer.should_yield(sess.name))
        try:
            if not holding:
                quota = self.scheduler.acquire(sess.name,
                                               trace_id=sess.trace_id)
            elif exhausted or preempted:
                if preempted:
                    self.slicer.note_yield(sess.name)
                    with sess.lock:
                        sess.preempt_yields += 1
                quota = self.scheduler.renew(sess.name, used,
                                             trace_id=sess.trace_id)
            else:
                quota = None
            if quota is not None:
                with sess.lock:
                    sess.holding = True
                    sess.quota_ms = quota
                    sess.used_ms = 0.0
            start = _now_ms()
            self.scheduler.execute_begin()
            self.slicer.execute_begin(sess.name)
            try:
                return fn()
            finally:
                end = _now_ms()
                self.slicer.execute_end(sess.name)
                self.scheduler.execute_end()
                elapsed = timing.get("exec_ms", end - start)
                with sess.lock:
                    sess.used_ms += elapsed
                    sess.exec_count += 1
                    sess.exec_ms_total += elapsed
                    sess.busy = False
                    sess.last_end_ms = end
        finally:
            # still busy only when the gate itself failed before dispatch
            if sess.busy:
                with sess.lock:
                    sess.busy = False
                    sess.last_end_ms = _now_ms()

    def _watch_idle(self) -> None:
        """Return tokens from clients that stopped executing, and reclaim
        parked sessions nobody resumed within the grace."""
        period = max(self.idle_release_ms / 2.0, 1.0) / 1000.0
        while not self._stop.wait(period):
            now = _now_ms()
            with self._slock:
                sessions = list(self._sessions.values())
            # black-box cadence: the proxy's population and traffic
            # counters, so a dump shows its recent shape (rate-limited)
            flight_default_recorder().sample_deltas("proxy", {
                "sessions": float(len(sessions)),
                "detached": _DETACHED.value(),
                "resumes_total": _RESUMES.value(),
                "detaches_total": _DETACHES.value(),
            })
            for sess in sessions:
                with sess.lock:
                    idle = (sess.holding and not sess.busy
                            and now - sess.last_end_ms
                            >= self.idle_release_ms)
                    if idle:
                        sess.holding = False
                        used = sess.used_ms
                if idle:
                    try:
                        self.scheduler.release(sess.name, used)
                    except (KeyError, ValueError, RuntimeError):
                        pass  # raced a drop
            for sess in sessions:
                if (sess.resume_token and not sess.attached
                        and not sess.migrating
                        and now - sess.detached_at >= self.detach_grace_ms):
                    log.info("detached session %s expired after %.0f ms",
                             sess.name, now - sess.detached_at)
                    self._drop_session(sess.name, purge=True)

    # -- protocol ------------------------------------------------------------

    def _blob_sink(self, msg: dict, state: dict, nbytes: int):
        """Reader-side hook of :func:`.protocol.serve_framed`: a chunk of a
        staged upload (or of a migration's import) lands straight in its
        staging buffer. Anything irregular returns None, and the worker
        raises the proper error."""
        op = msg.get("op")
        with self._slock:
            if op == "import_buffer_chunk":
                sess = self._by_token.get(str(msg.get("token", "")))
            elif op == "put_chunk" and state.get("name"):
                sess = self._sessions.get(state["name"])
            else:
                return None
        if sess is None:
            return None
        try:
            entry = sess.staging.get(int(msg.get("staging", -1)))
            off = int(msg.get("offset", -1))
        except (TypeError, ValueError):
            return None
        if entry is None or off < 0 or off + nbytes > entry[0]:
            return None
        return memoryview(entry[1])[off:off + nbytes]

    def _handle_timed(self, req: dict, state: dict) -> dict:
        op = str(req.get("op"))
        t0 = time.perf_counter()
        try:
            return self._handle(req, state)
        finally:
            # unknown ops share one label: a misbehaving client must not
            # mint unbounded series
            _RPC_LAT.observe(op if op in _KNOWN_OPS else "other",
                             value=time.perf_counter() - t0)
            if op == "execute":
                # critpath's "execute" segment: the server-side service
                # time under the session's trace, which splits a client's
                # round trip into transport and device work
                tid = state.get("trace_id", "")
                if tid:
                    tracer = obs_trace.get_tracer()
                    end_ms = tracer.now_ms()
                    tracer.record(
                        "execute", tid,
                        end_ms - (time.perf_counter() - t0) * 1000.0,
                        end_ms, proc="chipproxy")

    def _handle(self, req: dict, state: dict) -> dict:
        op = req.get("op")
        if op == "register":
            return self._handle_register(req, state)
        if op in _ADMIN_OPS:
            return self._handle_admin(op, req, state)
        # identity is connection-bound: a session is reachable only from
        # the connection that registered (or resumed) it
        name = state.get("name")
        if not name:
            raise PermissionError("not registered on this connection")
        sess = self._session(name)
        # the trace of the request in hand: its grants are spans of it
        sess.trace_id = state.get("trace_id", sess.trace_id)
        rid = req.pop(protocol.RID_KEY, None)
        ack = req.pop(protocol.ACK_KEY, None)
        if ack is not None:
            self._prune_replies(sess, int(ack))
        if rid is None:
            try:
                return self._dispatch(op, req, sess, state)
            finally:
                if op in _JOURNALED_OPS:
                    self._journal_checkpoint(sess)
        # A rid at or below the watermark was (possibly) handled already:
        # answer from the cache, or run again only an idempotent op. A
        # fresh rid runs, its error captured IN-BAND, so that a lost
        # error reply never turns into a second run on replay.
        rid = int(rid)
        if rid <= sess.last_rid:
            cached = sess.replies.get(rid)
            if cached is not None:
                self.replays_served += 1
                _REPLAY_SERVED.inc()
                return dict(cached)
            if op in _REPLAY_REEXEC:
                self.replays_served += 1
                _REPLAY_SERVED.inc()
                return self._dispatch(op, req, sess, state)
            return {"ok": False,
                    "error": f"ReplayError: request {rid} is outside the "
                             f"replay window"}
        try:
            reply = self._dispatch(op, req, sess, state)
        except Exception as e:
            reply = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        sess.last_rid = max(sess.last_rid, rid)
        if state.get("reply_blob") is None:
            # a reply with a payload (a get) is never kept: the op runs
            # again, and keeping it would pin the bytes
            sess.replies[rid] = dict(reply)
            while len(sess.replies) > self.REPLAY_CACHE:
                sess.replies.popitem(last=False)
        if op in _JOURNALED_OPS:
            self._journal_checkpoint(sess)
        return reply

    def _prune_replies(self, sess: _Session, ack: int) -> None:
        while sess.replies:
            rid = next(iter(sess.replies))
            if rid > ack:
                break
            sess.replies.popitem(last=False)

    def _handle_register(self, req: dict, state: dict) -> dict:
        if "resume" in req:
            return self._resume(str(req["resume"]), state)
        if state.get("name"):
            raise ValueError(
                f"connection already registered as {state['name']!r}")
        if self._draining:
            raise RuntimeError("proxy is draining; new sessions refused")
        name = req["name"]
        sess = self._register(name, float(req["request"]), float(req["limit"]),
                              int(req.get("memory", 0)),
                              str(req.get("class", "best-effort")))
        sess.trace_id = state.get("trace_id", "")
        sess.disconnect = state.get("_disconnect")
        state["name"] = name
        reply = {"ok": True, "platforms": [self.platform],
                 "device": str(self.device)}
        if "features" in req:
            # granted = requested ∩ served; the key is echoed only when
            # asked, so a peer that negotiates nothing gets the reply
            # shape it always got
            granted = protocol.negotiate_features(req.get("features") or (),
                                                  SERVED_FEATURES)
            sess.features = frozenset(granted)
            reply["features"] = granted
            if "resume" in sess.features:
                token = uuid.uuid4().hex
                sess.resume_token = token
                with self._slock:
                    self._by_token[token] = sess
                reply["resume"] = token
                self._journal_checkpoint(sess)
        return reply

    def _resume(self, token: str, state: dict) -> dict:
        """Re-attach a parked session to this connection. The token is
        the capability; an old connection the kernel has not reaped yet
        is kicked and its detach awaited, so one connection owns the
        session."""
        if state.get("name"):
            raise ValueError(
                f"connection already registered as {state['name']!r}")
        with self._slock:
            moved = self._moved.get(token)
            sess = self._by_token.get(token)
        if sess is not None and sess.migrating:
            deadline = time.monotonic() + MIGRATION_WAIT_S
            while (sess.migrating and token not in self._moved
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            with self._slock:
                moved = self._moved.get(token)
        if moved is not None:
            return {"ok": True, "moved": [moved[0], moved[1]]}
        if sess is None:
            raise KeyError("unknown resume token")
        if sess.migrating:
            raise RuntimeError("session is migrating; retry")
        if sess.attached:
            kick = sess.disconnect
            if kick is not None:
                try:
                    kick()
                except OSError:
                    pass
            if not sess.detach_ev.wait(timeout=5.0):
                raise RuntimeError("session still attached")
            if sess.migrating:
                raise RuntimeError("session is migrating; retry")
        with self._slock:
            sess.attached = True
            sess.detach_ev.clear()
            sess.disconnect = state.get("_disconnect")
            sess.trace_id = state.get("trace_id", sess.trace_id)
        state["name"] = sess.name
        _RESUMES.inc()
        _DETACHED.inc(amount=-1.0)
        flight_default_recorder().note("proxy", "session-resumed",
                                       client=sess.name,
                                       trace_id=sess.trace_id,
                                       last_rid=sess.last_rid)
        log.info("session %s resumed (last_rid=%d)", sess.name,
                 sess.last_rid)
        return {"ok": True, "platforms": [self.platform],
                "device": str(self.device),
                "features": sorted(sess.features), "resume": token,
                "resumed": True, "last_rid": sess.last_rid}

    def _admin_session(self, req: dict) -> _Session:
        with self._slock:
            sess = self._by_token.get(str(req.get("token", "")))
        if sess is None:
            raise KeyError("unknown resume token")
        return sess

    def _handle_admin(self, op, req: dict, state: dict) -> dict:
        """Drain and live migration. They arrive on an unregistered
        connection (the mover is operator tooling, not a client); the
        resume token is the capability."""
        if op == "drain":
            self.drain()
            return {"ok": True}

        if op == "import_session":
            if self._draining:
                raise RuntimeError("proxy is draining; imports refused")
            m = dict(req["manifest"])
            if not valid_token(m.get("token")):
                raise ValueError("not a resume token a proxy minted")
            sess = self._new_session(m)
            for spec in m.get("buffers", ()):
                sess.import_specs[int(spec["handle"])] = dict(spec)
            self._admit_parked(sess)
            self._journal_checkpoint(sess)
            return {"ok": True}

        sess = self._admin_session(req)

        if op == "migrate_begin":
            # freeze: resumes are refused (retryable) while the bytes are
            # in flight, and the owner is kicked so no request changes
            # the session under the export
            sess.migrating = True
            if sess.attached:
                kick = sess.disconnect
                if kick is not None:
                    try:
                        kick()
                    except OSError:
                        pass
                if not sess.detach_ev.wait(timeout=5.0):
                    sess.migrating = False
                    raise RuntimeError("session still attached; cannot "
                                       "migrate")
            return {"ok": True}

        if op == "migrate_abort":
            # the move failed before its flip: the session is the
            # source's again, and its client resumes here
            sess.migrating = False
            return {"ok": True}

        if op == "export_session":
            return {"ok": True, "manifest": self._manifest(sess)}

        if op == "export_buffer":
            total = self._serve_slice(sess, req, state, raw=True)
            return {"ok": True, "total": total}

        if op == "export_program":
            rec = sess.programs[int(req["exec_id"])]
            if "spec" in rec:
                return {"ok": True, "ncarry": rec["ncarry"],
                        "spec": rec["spec"], "in_meta": rec["in_meta"]}
            state["reply_blob"] = [rec["blob"]]
            return {"ok": True, "ncarry": rec["ncarry"]}

        if op == "import_buffer_begin":
            handle = int(req["handle"])
            if handle not in sess.import_specs:
                raise KeyError(f"handle {handle} is not in the imported "
                               f"manifest")
            sid = self._stage(sess, int(req["nbytes"]))
            sess.import_handles[sid] = handle
            return {"ok": True, "staging": sid}

        if op == "import_buffer_chunk":
            self._land_chunk(sess, req, state)
            return {"ok": True}

        if op == "import_buffer_commit":
            sid = int(req["staging"])
            total, raw, charged = sess.staging.pop(sid)
            handle = sess.import_handles.pop(sid)
            spec = sess.import_specs.pop(handle)
            sess.hbm_used -= charged
            host = _from_host(load_array(raw), spec["dtype"], spec["shape"])
            self._charge(sess, _nbytes(host))
            sess.hbm_used -= _nbytes(host)       # _bind charges the storage
            with self._dlock:
                t = host.to(self.device)
            self._bind(sess, handle, t)
            for h, other in list(sess.import_specs.items()):
                if other.get("alias_of") == handle:
                    self._bind(sess, h, t)
                    del sess.import_specs[h]
            self._journal_tensors(sess, [t])
            self._journal_checkpoint(sess)
            return {"ok": True}

        if op == "import_program":
            rec = {"ncarry": req.get("ncarry")}
            if "spec" in req:
                rec.update(spec=req["spec"], in_meta=req["in_meta"])
            else:
                rec["blob"] = bytes(state["blob"])
            self._install_program(sess, rec, int(req["exec_id"]))
            self._journal_checkpoint(sess)
            return {"ok": True}

        if op == "migrate_finish":
            host, port = req["moved"]
            with self._slock:
                self._moved[sess.resume_token] = (str(host), int(port))
            self._drop_session(sess.name, purge=True)
            log.info("session %s migrated to %s:%d", sess.name, str(host),
                     int(port))
            return {"ok": True}

        return {"ok": False, "error": f"unknown admin op {op!r}"}

    def _dispatch(self, op, req: dict, sess: _Session, state: dict) -> dict:
        if op == "put":
            if state.get("blob") is None:
                raise ValueError("put carries the array as its payload")
            return self._put_array(sess, load_array(state["blob"]))

        if op == "put_begin":
            # a staged upload: the serialized array crosses in chunks
            # (landing in the staging buffer) and becomes a device buffer
            # at commit; its device bytes are reserved now, so an upload
            # over the cap is refused before any chunk moves
            return {"ok": True, "staging": self._stage(sess,
                                                       int(req["nbytes"]))}

        if op == "put_chunk":
            inj = _faults.active()
            if inj is not None and inj.should_crash_proxy():
                self.crash()
                raise RuntimeError("fault injection: proxy crashed")
            if int(req["staging"]) in sess.aborted_staging:
                raise RuntimeError(f"staging {req['staging']} invalidated "
                                   f"by disconnect; restart upload")
            self._land_chunk(sess, req, state)
            return {"ok": True}

        if op == "put_commit":
            sid = int(req["staging"])
            if sid in sess.aborted_staging:
                raise RuntimeError(f"staging {sid} invalidated by "
                                   f"disconnect; restart upload")
            _total, raw, charged = sess.staging.pop(sid)
            sess.hbm_used -= charged      # the real buffer is charged next
            return self._put_array(sess, load_array(raw))

        if op == "put_abort":
            sid = int(req["staging"])
            sess.aborted_staging.discard(sid)
            entry = sess.staging.pop(sid, None)
            if entry is not None:
                sess.hbm_used -= entry[2]
            return {"ok": True}

        if op == "get":
            if "offset" in req:
                # a sliced fetch: serialized once, served in byte ranges
                return {"ok": True,
                        "total": self._serve_slice(sess, req, state)}
            buf = sess.buffers[int(req["handle"])]
            if _nbytes(buf) > protocol.MAX_FRAME - 4096:
                raise ValueError(f"buffer too large to transfer "
                                 f"({_nbytes(buf)} bytes); fetch it in "
                                 f"slices (get with offset/length)")
            with self._dlock:
                host = buf.detach().cpu().numpy()
            state["reply_blob"] = protocol.dump_array_parts(host)
            return {"ok": True}

        if op == "free":
            for handle in req["handles"]:
                self._forget_buffer(sess, int(handle))
            return {"ok": True}

        if op == "compile":
            blob = state.get("blob")
            if blob is not None:
                return self._compile_program(sess, req, blob)
            return self._compile(sess, req)

        if op == "execute":
            return self._execute(sess, req)

        if op == "usage":
            return {"ok": True,
                    "used_ms": self.scheduler.window_usage(sess.name),
                    "window_ms": self.scheduler.window_ms,
                    "hbm_used": sess.hbm_used,
                    "exec_count": sess.exec_count,
                    "exec_ms_total": sess.exec_ms_total}

        if op == "unregister":
            # a clean exit: the journal must not outlive the session
            self._drop_session(sess.name, purge=True)
            state.pop("name", None)
            return {"ok": True}

        return {"ok": False, "error": f"unknown op {op!r}"}

    # -- transfers -----------------------------------------------------------

    def _stage(self, sess: _Session, total: int) -> int:
        """Open a staged transfer of ``total`` serialized bytes, reserving
        its device bytes (the stream less its < 4 KiB header)."""
        if not 0 < total <= _MAX_STAGED:
            raise ValueError(f"bad staged size {total}")
        charged = max(total - 4096, 0)
        self._charge(sess, charged)
        sid = sess.fresh_id()
        sess.staging[sid] = (total, bytearray(total), charged)
        return sid

    def _land_chunk(self, sess: _Session, req: dict, state: dict) -> None:
        total, raw, _charged = sess.staging[int(req["staging"])]
        if state.get("blob_sunk"):
            return          # the reader received it in place already
        blob = state.get("blob") or b""
        off = int(req["offset"])
        n = memoryview(blob).nbytes
        if off < 0 or off + n > total:
            raise ValueError(f"chunk [{off}, {off + n}) outside staged "
                             f"{total}")
        raw[off:off + n] = blob

    def _serve_slice(self, sess: _Session, req: dict, state: dict,
                     raw: bool = False) -> int:
        """One byte range of a buffer's serialized stream as the reply's
        payload. The stream is made once and dropped with its last byte,
        so a session holds at most one host copy. ``raw``: bfloat16 as
        its int16 bits (a migration's export)."""
        handle = int(req["handle"])
        if sess.fetch_cache is None or sess.fetch_cache[0] != handle:
            buf = sess.buffers[handle]
            with self._dlock:
                host = _to_host(buf) if raw else buf.detach().cpu().numpy()
            parts = protocol.dump_array_parts(host)
            sess.fetch_cache = (handle, parts, protocol.buffers_nbytes(parts))
        _, parts, total = sess.fetch_cache
        off, length = int(req["offset"]), int(req["length"])
        if off < 0 or length <= 0:
            raise ValueError(f"bad slice [{off}, +{length})")
        if off + length >= total:
            sess.fetch_cache = None
        state["reply_blob"] = protocol.slice_buffers(parts, off, length)
        return total

    def _put_array(self, sess: _Session, arr: np.ndarray) -> dict:
        programs.torch_dtype(arr.dtype.name)      # refuse what can't cross
        # charged before the device allocation: an over-cap put never
        # touches the card
        self._charge(sess, int(arr.nbytes))
        try:
            # order="C", not ascontiguousarray (which makes 0-d into (1,))
            host = torch.from_numpy(np.asarray(arr, order="C"))
            with self._dlock:
                buf = host.to(self.device)
        except Exception:
            sess.hbm_used -= int(arr.nbytes)
            raise
        handle, = self._store(sess, [buf], int(arr.nbytes))
        self._journal_tensors(sess, [buf])
        return {"ok": True, "handle": handle, "shape": list(buf.shape),
                "dtype": programs.dtype_name(buf.dtype)}

    # -- programs ------------------------------------------------------------

    def _shared_cost(self, key: str) -> _Cost:
        """The cost model of the program ``key``, shared by every session
        that compiles it."""
        with self._slock:
            cost = self._costs.pop(key, None) or _Cost()
            self._costs[key] = cost                 # most recently used
            while len(self._costs) > self.PROGRAMS_CAP:
                self._costs.pop(next(iter(self._costs)))
        return cost

    def _compile_program(self, sess: _Session, req: dict, blob) -> dict:
        """A saved program (:mod:`.exported`), loaded outside the token:
        loading is host work. With ``ncarry`` it is a loop program."""
        if "spec" in req:
            raise ValueError("compile takes a saved program or a spec, "
                             "not both")
        ncarry = req.get("ncarry")
        exe = self._install_program(sess, {"blob": bytes(blob),
                                           "ncarry": ncarry})
        return {"ok": True, "exec_id": exe.exec_id,
                "out_meta": [[list(s), d]
                             for s, d in exe.program.out_meta],
                "out_nbytes": exe.out_nbytes}

    def _compile(self, sess: _Session, req: dict) -> dict:
        if "ncarry" not in req:
            raise ValueError("compile takes a saved program (the payload) "
                             "or a loop spec with ncarry")
        exe = self._install_program(sess, {"spec": req["spec"],
                                           "in_meta": req["in_meta"],
                                           "ncarry": int(req["ncarry"])})
        prog = exe.program
        return {"ok": True, "exec_id": exe.exec_id,
                "out_meta": [[list(s), d] for s, d in prog.out_meta],
                "out_nbytes": prog.out_nbytes, "naux": prog.naux}

    def _install_program(self, sess: _Session, rec: dict,
                         exec_id: int | None = None,
                         journal: bool = True) -> _Executable:
        """Build a program from its record — a saved program's bytes
        through :func:`.exported.load_program`'s checks, a spec through
        :func:`.programs.resolve`'s — and register it. Shared by compile
        (a fresh exec_id), a migration's import and the journal's
        recovery (the original exec_id, so the client's stays valid)."""
        ncarry = rec.get("ncarry")
        if "spec" in rec:
            prog = programs.resolve(rec["spec"], rec["in_meta"], int(ncarry))
            in_meta = [(s, programs.torch_dtype(d)) for s, d in prog.in_meta]
            key = prog.key
        else:
            prog = exported.load_program(rec["blob"], self.device)
            in_meta = list(prog.in_meta)
            if ncarry is not None:
                ncarry = int(ncarry)
                carry_in = [(tuple(s), programs.dtype_name(d))
                            for s, d in in_meta[:ncarry]]
                carry_out = [(tuple(s), d) for s, d in prog.out_meta[:ncarry]]
                if not 0 < ncarry <= min(len(in_meta), len(prog.out_meta)) \
                        or carry_in != carry_out:
                    raise ValueError(
                        f"a loop program's first {ncarry} outputs are its "
                        f"carry, of its first {ncarry} inputs' shapes and "
                        f"dtypes: inputs {carry_in}, outputs {carry_out}")
            key = f"{prog.key}|{ncarry}"
        if exec_id is None:
            exec_id = sess.fresh_id()
        exe = _Executable(exec_id, prog, in_meta, prog.out_nbytes,
                          None if ncarry is None else int(ncarry),
                          self._shared_cost(key))
        sess.executables[exec_id] = exe
        sess.programs[exec_id] = dict(rec, ncarry=exe.ncarry)
        if journal and "blob" in rec and self._journaling(sess):
            self.journal.save_program(sess.resume_token, exec_id,
                                      rec["blob"])
        return exe

    def _chunk_fn(self, exe: _Executable, n: int):
        """``n`` steps of the loop program in one gated burst: a Python
        loop of launches on the device, threading the carry, with one
        completion barrier after it (in :meth:`_run_fn`)."""
        ncarry = exe.ncarry

        def chunk(*args):
            carry, consts = list(args[:ncarry]), list(args[ncarry:])
            aux: list = []
            for _ in range(n):
                carry, aux = exe.step(carry, consts)
                carry = list(carry)
            return carry + list(aux)

        return chunk

    def _cap_repeat(self, exe: _Executable, repeat: int) -> int:
        """Clamp a requested burst length (the JAX proxy's rule). One burst
        is one unpreemptible stretch of device time, so before any timing
        exists it runs exactly one step. After that the budget is the
        larger of 2·base quota and 32·fixed per-dispatch cost, bounded by a
        quarter of the accounting window so shares converge within one."""
        cost = exe.cost
        if cost.step_ms <= 0.0:
            return 1
        base = self.scheduler.core.base_quota_ms
        window = self.scheduler.window_ms
        if cost.loop_step_ms <= 0.0:
            n = int(min(2.0 * base, window / 4.0) / cost.step_ms)
            return max(1, min(repeat, n))
        fixed = max(cost.step_ms - cost.loop_step_ms, 0.0)
        budget = min(max(2.0 * base, 32.0 * fixed), window / 4.0)
        n = 1 + int(max(0.0, budget - cost.step_ms) / cost.loop_step_ms)
        return max(1, min(repeat, n))

    def _update_cost_model(self, exe: _Executable, repeat: int,
                           burst_ms: float) -> None:
        cost = exe.cost
        with self._slock:  # the cost model is shared across sessions
            if not exe.warmed:
                # A session's first run of an eager program pays one-time
                # costs (the caching allocator growing, cuBLAS and cuDNN
                # handles for the session's serving thread) that later
                # steps do not. step_ms is refreshed only by 1-step
                # bursts, so such a reading would stand for the whole
                # run, and short tail bursts would then drag loop_step_ms
                # to ~0 and let bursts overrun the window/4 clamp. So it
                # feeds nothing.
                exe.warmed = True
                return
            if repeat == 1:
                cost.step_ms = (burst_ms if cost.step_ms <= 0.0
                                else 0.5 * cost.step_ms + 0.5 * burst_ms)
            else:
                first = (cost.step_ms if cost.step_ms > 0.0
                         else burst_ms / repeat)
                per_loop = max(0.001, (burst_ms - first) / (repeat - 1))
                cost.loop_step_ms = (
                    per_loop if cost.loop_step_ms <= 0.0
                    else 0.5 * cost.loop_step_ms + 0.5 * per_loop)

    def _args(self, sess: _Session, exe: _Executable, req: dict) -> list:
        """Look up and validate the arguments BEFORE dispatch: a mismatch
        is a clean client error, never a half-run burst."""
        handles = [int(h) for h in req["args"]]
        if len(handles) != len(exe.in_meta):
            raise ValueError(f"expected {len(exe.in_meta)} args, "
                             f"got {len(handles)}")
        if exe.ncarry is not None:
            carry = handles[:exe.ncarry]
            # the carry is updated in place: one buffer may not stand for
            # two carry leaves, nor be read as a const while it is written
            if len(set(carry)) != len(carry) or set(carry) & set(
                    handles[exe.ncarry:]):
                raise ValueError("carry handles must be distinct and not "
                                 "passed again as consts")
        args = [sess.buffers[h] for h in handles]
        for i, (buf, (shape, dtype)) in enumerate(zip(args, exe.in_meta)):
            if tuple(buf.shape) != shape or buf.dtype != dtype:
                raise ValueError(
                    f"arg {i}: got {tuple(buf.shape)}/{buf.dtype}, program "
                    f"expects {shape}/{dtype}")
        return args

    def _consumed(self, exe: _Executable, req: dict) -> list[int]:
        """Handles a dispatch consumes: the donated ones and, always, the
        carry — the program writes it in place, so a handle left on it
        would alias a tensor that later bursts mutate."""
        carry = [int(h) for h in req["args"][:exe.ncarry]]
        return list(dict.fromkeys(
            carry + [int(h) for h in req.get("donate", [])]))

    def _versions(self, sess: _Session, args: list) -> list | None:
        """The arguments' version counters, when the journal must learn
        which of them a run changed in place."""
        return [t._version for t in args] if self._journaling(sess) else None

    def _journal_run(self, sess: _Session, args: list, versions, outs
                     ) -> None:
        """A run's outputs and the arguments it changed in place."""
        if versions is not None:
            changed = [t for t, v in zip(args, versions) if t._version != v]
            self._journal_tensors(sess, list(outs) + changed)

    def _execute(self, sess: _Session, req: dict) -> dict:
        exe = sess.executables[int(req["exec_id"])]
        if exe.ncarry is None:
            return self._execute_program(sess, exe, req)
        args = self._args(sess, exe, req)
        consumed = self._consumed(exe, req)
        chain_steps = int(req.get("chain_steps", 0))
        if chain_steps:
            return self._execute_chain(sess, exe, args, consumed,
                                       chain_steps)
        repeat = int(req.get("repeat", 1))
        if repeat < 1:
            raise ValueError(f"repeat must be >= 1, got {repeat}")
        repeat = _bucket(self._cap_repeat(exe, repeat))
        fn = self._chunk_fn(exe, repeat)
        versions = self._versions(sess, args)
        # cap check up front: no allocation over the cap, even transiently
        self._charge(sess, exe.out_nbytes)
        exec_ms_before = sess.exec_ms_total
        timing: dict = {}

        def run_tagged():
            try:
                return self._run_fn(fn, args, timing)
            except Exception as e:
                raise _ExecutionError(e) from e

        try:
            outs = self._gated(sess, run_tagged, timing)
        except _ExecutionError as tagged:
            sess.hbm_used -= exe.out_nbytes
            for handle in consumed:
                self._forget_buffer(sess, handle)
            raise RuntimeError(
                f"loop execution failed and its carry was consumed "
                f"(handles {consumed} freed); re-put the carry before "
                f"retrying: {tagged.cause}") from tagged.cause
        except Exception:
            # token-gate failure: nothing dispatched, buffers intact
            sess.hbm_used -= exe.out_nbytes
            raise
        self._update_cost_model(exe, repeat,
                                sess.exec_ms_total - exec_ms_before)
        handles = self._store(sess, outs, exe.out_nbytes)
        for handle in consumed:
            self._forget_buffer(sess, handle)
        self._journal_run(sess, args, versions, outs)
        return {"ok": True, "handles": handles, "repeat": repeat}

    def _execute_program(self, sess: _Session, exe: _Executable,
                         req: dict) -> dict:
        """One run of a saved program, one token-gated burst. Its outputs
        are charged before the run; one that is an input (an in-place
        update returned) keeps that input's storage and charge. The
        argument handles stay valid but the donated ones (``donate``),
        which a successful run forgets with their charge, as the JAX
        proxy frees them; a storage an output still holds keeps its
        charge under the output's handle. A failed run refunds the charge
        and frees nothing."""
        if int(req.get("repeat", 1)) != 1 or req.get("chain_steps"):
            raise ValueError("a saved program runs once a call and keeps "
                             "its arguments but the donated ones; repeat "
                             "and chain_steps are for loop programs")
        args = self._args(sess, exe, req)
        versions = self._versions(sess, args)
        self._charge(sess, exe.out_nbytes)
        exec_ms_before = sess.exec_ms_total
        timing: dict = {}

        def run_tagged():
            try:
                return self._run_fn(exe.program, args, timing)
            except Exception as e:
                raise _ExecutionError(e) from e

        try:
            outs = self._gated(sess, run_tagged, timing)
        except _ExecutionError as tagged:
            sess.hbm_used -= exe.out_nbytes
            self._journal_run(sess, args, versions, [])
            raise RuntimeError(
                f"execution failed (its arguments kept): "
                f"{tagged.cause}") from tagged.cause
        except Exception:
            sess.hbm_used -= exe.out_nbytes     # nothing dispatched
            raise
        self._update_cost_model(exe, 1, sess.exec_ms_total - exec_ms_before)
        handles = self._store(sess, outs, exe.out_nbytes)
        self._journal_run(sess, args, versions, outs)
        for handle in req.get("donate", ()):
            self._forget_buffer(sess, int(handle))
        return {"ok": True, "handles": handles, "repeat": 1}

    def _execute_chain(self, sess: _Session, exe: _Executable, args: list,
                       consumed: list[int], total: int) -> dict:
        """Server-side burst chaining: run toward ``total`` steps as a
        SEQUENCE of token-gated bursts, each burst's carry feeding the
        next, with no client round trip between bursts. Every burst passes
        the token gate on its own, so co-tenants interleave at quantum
        granularity. Stops early at ``MAX_CHAIN_BURSTS``; the reply says
        how many steps ran."""
        if total < 1:
            raise ValueError(f"chain_steps must be >= 1, got {total}")
        ncarry = exe.ncarry
        consts = args[ncarry:]
        carry = list(args[:ncarry])
        versions = self._versions(sess, args)
        yields_before = sess.preempt_yields
        steps = bursts = last_burst = 0
        outs: list = []
        while steps < total and bursts < self.MAX_CHAIN_BURSTS:
            repeat = _bucket(self._cap_repeat(exe, total - steps))
            fn = self._chunk_fn(exe, repeat)
            try:
                self._charge(sess, exe.out_nbytes)
            except HBMError:
                if bursts == 0:
                    raise      # nothing dispatched, buffers intact
                break          # return the valid partial chain instead
            exec_ms_before = sess.exec_ms_total
            timing: dict = {}
            burst_args = carry + consts

            def run_tagged():
                try:
                    return self._run_fn(fn, burst_args, timing)
                except Exception as e:
                    raise _ExecutionError(e) from e

            try:
                new_outs = self._gated(sess, run_tagged, timing)
            except _ExecutionError as tagged:
                sess.hbm_used -= exe.out_nbytes
                self._chain_abort(sess, exe, consumed, bursts)
                raise RuntimeError(
                    f"chained loop failed after {steps} steps and the "
                    f"carry was consumed (handles {consumed} freed); "
                    f"re-put the carry before retrying: "
                    f"{tagged.cause}") from tagged.cause
            except Exception:
                # token-gate failure: THIS burst never dispatched
                sess.hbm_used -= exe.out_nbytes
                if bursts == 0:
                    raise      # nothing consumed, buffers intact
                self._chain_abort(sess, exe, consumed, bursts)
                raise RuntimeError(
                    f"chained loop interrupted after {steps} steps and "
                    f"the carry was consumed (handles {consumed} freed); "
                    f"re-put the carry before retrying")
            self._update_cost_model(exe, repeat,
                                    sess.exec_ms_total - exec_ms_before)
            if bursts == 0:
                for handle in consumed:
                    self._forget_buffer(sess, handle)
            else:
                # the previous burst's outputs (carry threaded on, aux
                # dropped) release their charge
                sess.hbm_used -= exe.out_nbytes
            outs = new_outs
            carry = list(outs[:ncarry])
            steps += repeat
            # the steady-state clamp is the LARGEST burst of the chain
            last_burst = max(last_burst, repeat)
            bursts += 1
        handles = self._store(sess, outs, exe.out_nbytes)
        self._journal_run(sess, args, versions, outs)
        reply = {"ok": True, "handles": handles, "repeat": steps,
                 "burst": last_burst}
        sliced = sess.preempt_yields - yields_before
        if sliced > 0 and "preempt" in sess.features:
            # a key for the negotiated only: another peer's reply stays
            # as it always was, sliced or not
            reply["sliced"] = sliced
        return reply

    def _chain_abort(self, sess: _Session, exe: _Executable,
                     consumed: list[int], bursts: int) -> None:
        for handle in consumed:
            self._forget_buffer(sess, handle)
        if bursts > 0:
            sess.hbm_used -= exe.out_nbytes

    def _run_fn(self, fn, args: list, timing: dict) -> list:
        # the device lock inside the token gate: device time is measured
        # once the lock is ours, up to the completion barrier — without
        # the barrier exec_ms would be launch time, quota accounting would
        # read near zero and the scheduler would over-grant
        with self._dlock:
            start = _now_ms()
            try:
                outs = fn(*args)
                synchronize(self.device)
            finally:
                timing["exec_ms"] = _now_ms() - start
        return list(outs)

    def _cleanup(self, state: dict) -> None:
        if self._crashed:
            return      # a crash runs no teardown: the journal is all left
        name = state.get("name")
        if not name:
            return
        with self._slock:
            sess = self._sessions.get(name)
        if sess is None:
            return
        if sess.resume_token:
            # park it for the grace: the client is probably re-dialing
            self._detach_session(sess)
        else:
            self._drop_session(name)


def main(argv=None) -> None:
    """``python -m kubeshare_tpu_torch.isolation.proxy -P 49901 -S 50901``
    — the gem-schd launch shape (``launcher.py:22-32``), owning the card
    too. ``-S`` also serves the proxy's token scheduler over TCP for pod
    managers (:func:`.tokensched.serve`); ``--journal-dir`` (or
    ``KUBESHARE_JOURNAL_DIR``) keeps every resumable session on disk and
    restores the ones found there; ``KUBESHARE_FAULTS`` installs a fault
    injector (:mod:`..resilience.faults`); ``--remote-write HOST:PORT``
    pushes the process's metrics to that registry every
    ``--push-period`` seconds as ``--instance`` (default ``<node>:<port>``,
    job ``chipproxy``), and a clean stop marks the instance stale. Prints
    ``READY <port>[ TOKENS <port>]`` once it serves."""
    import argparse

    from ..constants import (BASE_QUOTA_MS, ENV_JOURNAL_DIR, MIN_QUOTA_MS,
                             WINDOW_MS)
    from ..utils import ready_until_signal
    from .tokensched import serve as serve_tokens

    parser = argparse.ArgumentParser(prog="kubeshare_tpu_torch.isolation.proxy")
    parser.add_argument("-P", "--port", type=int, default=0)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("-q", "--base-quota", type=float, default=BASE_QUOTA_MS)
    parser.add_argument("-m", "--min-quota", type=float, default=MIN_QUOTA_MS)
    parser.add_argument("-w", "--window", type=float, default=WINDOW_MS)
    parser.add_argument("-S", "--token-port", type=int, default=-1,
                        help="also serve the token scheduler over TCP for "
                             "pod managers (gem-schd parity); -1 = off, "
                             "0 = ephemeral")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--journal-dir",
                        default=os.environ.get(ENV_JOURNAL_DIR, ""),
                        help="directory of the durable session journal; "
                             "empty keeps sessions in memory only")
    parser.add_argument("--remote-write", default="",
                        help="HOST:PORT of the telemetry registry; when "
                             "set, this proxy pushes its metric snapshot "
                             "to the fleet TSDB every --push-period "
                             "seconds")
    parser.add_argument("--push-period", type=float, default=5.0)
    parser.add_argument("--instance", default="",
                        help="instance label for remote-write (default "
                             "node:port)")
    args = parser.parse_args(argv)

    inj = _faults.from_env()
    if inj is not None:
        _faults.install(inj)
    device = resolve_device(args.device)
    # the CLI's scheduler feeds the process's chip-time ledger and blame
    # graph, as a proxy built without one does
    sched = TokenScheduler(window_ms=args.window,
                           base_quota_ms=args.base_quota,
                           min_quota_ms=args.min_quota,
                           chip=device_chip_id(device),
                           ledger=default_ledger(), blame=default_blame())
    proxy = ChipProxy(device=device, scheduler=sched,
                      journal_dir=args.journal_dir or None)
    server = proxy.serve(args.host, args.port)
    token_server = None
    tokens = ""
    if args.token_port >= 0:
        token_server = serve_tokens(sched, args.host, args.token_port)
        tokens = f" TOKENS {token_server.server_address[1]}"
    writer = None
    if args.remote_write:
        from ..telemetry.registry import RegistryClient
        from ..telemetry.remote_write import RemoteWriter, default_instance

        rw_host, _, rw_port = args.remote_write.rpartition(":")
        writer = RemoteWriter(
            RegistryClient(rw_host or "127.0.0.1", int(rw_port)),
            args.instance or default_instance(server.server_address[1]),
            "chipproxy", period_s=args.push_period).start()
    try:
        ready_until_signal(f"READY {server.server_address[1]}{tokens}")
    finally:
        if writer is not None:
            writer.stop()
    if token_server is not None:
        token_server.shutdown()
        token_server.server_close()
    proxy.close()


if __name__ == "__main__":
    main()
