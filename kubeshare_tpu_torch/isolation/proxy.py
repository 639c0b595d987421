"""The chip proxy: one process owns the card, clients execute through it.

Counterpart of ``kubeshare_tpu/isolation/proxy.py`` on one CUDA device.
The :class:`ChipProxy` is the one process that touches the card; client
threads or pods stage their state on the host with numpy, ``put`` it, and
then run programs on device-resident buffers addressed by handle, so a
training loop ships its parameters once. A program is either a registered
loop spec (:mod:`.programs`, run ``repeat`` times a burst) or a tenant's
own function, traced and saved by :mod:`.exported` on the client (the
proxy-mode attach ships every ``torch.compile``'d call so) and run once a
call.

Enforcement lives where the JAX proxy's lives:

- **compute** — every execution is gated by the per-device token
  scheduler (:mod:`.tokensched`): a client acquires a quota, keeps the
  token across back-to-back bursts until the quota is spent, then renews;
  an idle watchdog returns the token when a client stalls. The device time
  charged is measured up to a completion barrier
  (``torch.cuda.synchronize``) inside the timed window — torch launches
  asynchronously, and without the barrier the charge would be launch time;
- **memory** — device bytes are charged per client before they are
  allocated (``put`` and execution outputs), against the client's cap.
  Buffers are charged by storage: an output that is one of its inputs
  (an in-place update returned) or another output holds one charge
  however many handles name it, and freeing one handle leaves the others
  valid.

Ported: register (lockstep; no transport features granted), put, get,
free, compile (a loop spec, or a saved program as the payload), execute
(a loop with ``repeat`` and ``chain_steps``; a saved program once), usage,
unregister; the burst cost model and its clamp; carry donation; server-side
chaining; :func:`main`, the per-device process the node launcher spawns
(``-P``/``-S``/``-q``/``-m``/``-w``). Not yet: journaling, resume,
migration, admin ops, chunked transfers, fault injection, preemption
slicing and remote write.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

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


def _now_ms() -> float:
    return time.monotonic() * 1000.0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor) -> tuple[int, int]:
    """``(key, bytes)`` of the memory under ``t``: tensors that share a
    storage (views, an output that is its input) share the key."""
    st = t.untyped_storage()
    return st.data_ptr(), st.nbytes()


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
    #: a loop program, or a saved one (:class:`.exported.Program`)
    program: "programs.Program | exported.Program"
    in_meta: list                 # (shape tuple, torch dtype) per argument
    out_nbytes: int
    ncarry: int | None            # None: a saved program, run once a call
    cost: _Cost
    warmed: bool = False          # its first (warm-up) burst has run


@dataclass
class _Session:
    name: str
    request: float
    limit: float
    memory_cap: int               # bytes; 0 = uncapped
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
    the same code with the kernels' plain versions."""

    #: bursts per chained call: bounds one reply's latency
    MAX_CHAIN_BURSTS = 32
    #: cost models kept (least recently used dropped)
    PROGRAMS_CAP = 32

    def __init__(self, device=None, scheduler: TokenScheduler | None = None,
                 idle_release_ms: float = IDLE_RELEASE_MS):
        self.device = resolve_device(device)
        self.platform = self.device.type
        self.scheduler = scheduler if scheduler is not None else TokenScheduler()
        self.idle_release_ms = idle_release_ms
        self._sessions: dict[str, _Session] = {}
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
        self._server = protocol.serve_framed(host, port, self._handle,
                                             self._cleanup)
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

    # -- sessions ------------------------------------------------------------

    def _register(self, name: str, request: float, limit: float,
                  memory: int) -> _Session:
        with self._slock:
            if name in self._sessions:
                raise ValueError(f"duplicate client {name}")
            self.scheduler.add_client(name, request, limit)
            sess = _Session(name, request, limit, memory)
            self._sessions[name] = sess
            return sess

    def _session(self, name: str) -> _Session:
        with self._slock:
            try:
                return self._sessions[name]
            except KeyError:
                raise KeyError(f"unknown client {name!r}") from None

    def _drop_session(self, name: str) -> None:
        with self._slock:
            sess = self._sessions.pop(name, None)
        if sess is None:
            return
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
        log.info("client %s dropped (freed %d bytes)", name, sess.hbm_used)

    def hbm_accounting(self) -> dict[str, dict]:
        """Per session: bytes charged against bytes of live buffers, each
        storage counted once. Sample at quiesce — an execution in flight
        carries a transient output charge with no buffer yet."""
        out = {}
        with self._slock:
            sessions = list(self._sessions.values())
        for sess in sessions:
            live = sum(dict(map(_storage, sess.buffers.values())).values())
            out[sess.name] = {"hbm_used": sess.hbm_used,
                              "buffer_bytes": live,
                              "memory_cap": sess.memory_cap,
                              "balanced": sess.hbm_used == live}
        return out

    # -- memory accounting ---------------------------------------------------

    def _charge(self, sess: _Session, nbytes: int) -> None:
        if sess.memory_cap and sess.hbm_used + nbytes > sess.memory_cap:
            raise HBMError(f"{sess.name}: device memory cap exceeded "
                           f"({sess.hbm_used} + {nbytes} > "
                           f"{sess.memory_cap})")
        sess.hbm_used += nbytes

    def _store(self, sess: _Session, outs: list, precharged: int
               ) -> list[int]:
        """A handle for each tensor of ``outs``. The ``precharged`` bytes,
        charged before the tensors existed, become the charge of the
        storages they hold: once per storage, however many handles share
        it (an output that is an input, or another output)."""
        sess.hbm_used -= precharged
        handles = []
        for t in outs:
            key, nbytes = _storage(t)
            refs = sess.storages.get(key)
            if refs is None:
                sess.storages[key] = [nbytes, 1]
                sess.hbm_used += nbytes
            else:
                refs[1] += 1
            handle = sess.fresh_id()
            sess.buffers[handle] = t
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
        return buf

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
        token through the watchdog."""
        with sess.lock:
            sess.busy = True
            holding = sess.holding
            exhausted = holding and sess.used_ms >= sess.quota_ms
            used = sess.used_ms
        try:
            if not holding:
                quota = self.scheduler.acquire(sess.name)
            elif exhausted:
                quota = self.scheduler.renew(sess.name, used)
            else:
                quota = None
            if quota is not None:
                with sess.lock:
                    sess.holding = True
                    sess.quota_ms = quota
                    sess.used_ms = 0.0
            start = _now_ms()
            try:
                return fn()
            finally:
                end = _now_ms()
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
        """Return tokens from clients that stopped executing."""
        period = max(self.idle_release_ms / 2.0, 1.0) / 1000.0
        while not self._stop.wait(period):
            now = _now_ms()
            with self._slock:
                sessions = list(self._sessions.values())
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

    # -- protocol ------------------------------------------------------------

    def _handle(self, req: dict, state: dict) -> dict:
        op = req.get("op")
        if op == "register":
            return self._handle_register(req, state)
        # identity is connection-bound: a session is reachable only from
        # the connection that registered it
        name = state.get("name")
        if not name:
            raise PermissionError("not registered on this connection")
        return self._dispatch(op, req, self._session(name), state)

    def _handle_register(self, req: dict, state: dict) -> dict:
        if state.get("name"):
            raise ValueError(
                f"connection already registered as {state['name']!r}")
        name = req["name"]
        self._register(name, float(req["request"]), float(req["limit"]),
                       int(req.get("memory", 0)))
        state["name"] = name
        # lockstep only: a requested "features" list is granted nothing,
        # and the reply has no "features" key (the seed reply shape)
        return {"ok": True, "platforms": [self.platform],
                "device": str(self.device)}

    def _dispatch(self, op, req: dict, sess: _Session, state: dict) -> dict:
        if op == "put":
            if state.get("blob") is None:
                raise ValueError("put carries the array as its payload")
            return self._put_array(sess, load_array(state["blob"]))

        if op == "get":
            buf = sess.buffers[int(req["handle"])]
            if _nbytes(buf) > protocol.MAX_FRAME - 4096:
                raise ValueError(f"buffer too large to transfer "
                                 f"({_nbytes(buf)} bytes)")
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
            self._drop_session(sess.name)
            state.pop("name", None)
            return {"ok": True}

        return {"ok": False, "error": f"unknown op {op!r}"}

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
        return {"ok": True, "handle": handle, "shape": list(buf.shape),
                "dtype": programs.dtype_name(buf.dtype)}

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
        """A saved program (:mod:`.exported`), loaded here, outside the
        token: loading is host work, and its key shares the cost model
        between identical tenants."""
        if "ncarry" in req or "spec" in req:
            raise ValueError("a saved program runs once a call; loop "
                             "programs are registered specs")
        prog = exported.load_program(blob, self.device)
        exec_id = sess.fresh_id()
        sess.executables[exec_id] = _Executable(
            exec_id, prog, list(prog.in_meta), prog.out_nbytes, None,
            self._shared_cost(prog.key))
        return {"ok": True, "exec_id": exec_id,
                "out_meta": [[list(s), d] for s, d in prog.out_meta],
                "out_nbytes": prog.out_nbytes}

    def _compile(self, sess: _Session, req: dict) -> dict:
        if "ncarry" not in req:
            raise ValueError("compile takes a saved program (the payload) "
                             "or a loop spec with ncarry")
        prog = programs.resolve(req["spec"], req["in_meta"],
                                int(req["ncarry"]))
        cost = self._shared_cost(prog.key)
        exec_id = sess.fresh_id()
        sess.executables[exec_id] = _Executable(
            exec_id, prog,
            [(s, programs.torch_dtype(d)) for s, d in prog.in_meta],
            prog.out_nbytes, prog.ncarry, cost)
        return {"ok": True, "exec_id": exec_id,
                "out_meta": [[list(s), d] for s, d in prog.out_meta],
                "out_nbytes": prog.out_nbytes, "naux": prog.naux}

    def _chunk_fn(self, exe: _Executable, n: int):
        """``n`` steps of the loop program in one gated burst: a Python
        loop of launches on the device, threading the carry, with one
        completion barrier after it (in :meth:`_run_fn`)."""
        program, ncarry = exe.program, exe.ncarry

        def chunk(*args):
            carry, consts = list(args[:ncarry]), list(args[ncarry:])
            aux: list = []
            for _ in range(n):
                carry, aux = program(carry, consts)
            return carry + aux

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
        return {"ok": True, "handles": handles, "repeat": repeat}

    def _execute_program(self, sess: _Session, exe: _Executable,
                         req: dict) -> dict:
        """One run of a saved program, one token-gated burst. Its outputs
        are charged before the run; one that is an input (an in-place
        update returned) keeps that input's storage and charge. The
        argument handles stay valid, and a failed run refunds the
        charge."""
        if (int(req.get("repeat", 1)) != 1 or req.get("chain_steps")
                or req.get("donate")):
            raise ValueError("a saved program runs once a call and keeps "
                             "its arguments; repeat, chain_steps and "
                             "donate are for loop programs")
        args = self._args(sess, exe, req)
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
            raise RuntimeError(
                f"execution failed (its arguments kept): "
                f"{tagged.cause}") from tagged.cause
        except Exception:
            sess.hbm_used -= exe.out_nbytes     # nothing dispatched
            raise
        self._update_cost_model(exe, 1, sess.exec_ms_total - exec_ms_before)
        handles = self._store(sess, outs, exe.out_nbytes)
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
        return {"ok": True, "handles": self._store(sess, outs,
                                                   exe.out_nbytes),
                "repeat": steps, "burst": last_burst}

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
        name = state.get("name")
        if name:
            self._drop_session(name)


def main(argv=None) -> None:
    """``python -m kubeshare_tpu_torch.isolation.proxy -P 49901 -S 50901``
    — the gem-schd launch shape (``launcher.py:22-32``), owning the card
    too. ``-S`` also serves the proxy's token scheduler over TCP for pod
    managers (:func:`.tokensched.serve`). Prints ``READY <port>[ TOKENS
    <port>]`` once it serves."""
    import argparse

    from ..constants import BASE_QUOTA_MS, MIN_QUOTA_MS, WINDOW_MS
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
    args = parser.parse_args(argv)

    sched = TokenScheduler(window_ms=args.window,
                           base_quota_ms=args.base_quota,
                           min_quota_ms=args.min_quota)
    proxy = ChipProxy(device=args.device, scheduler=sched)
    server = proxy.serve(args.host, args.port)
    token_server = None
    tokens = ""
    if args.token_port >= 0:
        token_server = serve_tokens(sched, args.host, args.token_port)
        tokens = f" TOKENS {token_server.server_address[1]}"
    ready_until_signal(f"READY {server.server_address[1]}{tokens}")
    if token_server is not None:
        token_server.shutdown()
        token_server.server_close()
    proxy.close()


if __name__ == "__main__":
    main()
