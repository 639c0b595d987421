"""Client side of the isolation runtime.

Counterpart of ``kubeshare_tpu/isolation/client.py``:

- :class:`ProxyClient` is the stand-in for the card in a client that
  never owns it. The client stages its state on the host with numpy,
  ``put``s it, and runs programs on the proxy: registered loop specs
  (:mod:`.programs`, :meth:`~ProxyClient.compile_loop`) or its own
  functions, traced abstractly and saved by :mod:`.exported`
  (:meth:`~ProxyClient.compile`, what the proxy-mode attach forwards).
  Tensors live there as handles (:class:`RemoteBuffer`), so a training
  loop transfers its parameters once.
- :class:`ExecutionGate` and :class:`HbmCap` are for a process that owns
  the card itself (gate-mode attach, :mod:`kubeshare_tpu_torch.attach`):
  the gate passes a token round trip with the pod manager before work,
  the cap holds the process to its memory grant.

Lockstep connection only; the pipelined transport and
reconnect-and-resume are not ported yet, so :meth:`ProxyClient.
execute_async` returns a future that is already resolved, as the JAX
client's does on a lockstep connection.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.logger import get_logger
from ..utils.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from . import protocol
from .protocol import load_array

log = get_logger("client")


@dataclass(frozen=True)
class RemoteBuffer:
    """A device-resident tensor on the proxy."""

    handle: int
    shape: tuple[int, ...]
    dtype: str

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * np.dtype(
            self.dtype).itemsize


class RemoteFuture:
    """The result of a dispatch (:meth:`ProxyClient.execute_async`,
    :meth:`RemoteExecutable.call_async`). ``result()`` maps the reply once
    and returns (or raises) the same outcome on every later call. On this
    lockstep connection the dispatch has completed when the future is
    made; the pipelined transport would resolve it later, with callers
    unchanged."""

    __slots__ = ("_resolve", "_mu", "_done", "_value", "_exc")

    def __init__(self, resolve):
        self._resolve = resolve        # () -> value; may raise
        self._mu = threading.Lock()
        self._done = False
        self._value = None
        self._exc: Exception | None = None

    def done(self) -> bool:
        return True

    def result(self):
        with self._mu:
            if not self._done:
                try:
                    self._value = self._resolve()
                except Exception as e:
                    self._exc = e
                self._done = True
                self._resolve = None   # drop captured state
            if self._exc is not None:
                raise self._exc
            return self._value


def _host_array(x) -> np.ndarray:
    """A host tensor or array as numpy, to cross the wire."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(f"a tensor on {x.device} is not a host tensor")
        return x.detach().numpy()
    return np.asarray(x)


class RemoteExecutable:
    """A saved program compiled on the proxy (:meth:`ProxyClient.compile`);
    call it with the tree of its example arguments, each leaf a
    :class:`RemoteBuffer` or a host tensor or array. Host leaves are
    uploaded for the call and freed after it, whether it succeeds or
    fails. Returns the output tree of :class:`RemoteBuffer`\\ s."""

    def __init__(self, client: "ProxyClient", exec_id: int, in_def, out_def,
                 out_meta: list):
        self._client = client
        self._exec_id = exec_id
        self._in_def = in_def
        self._out_def = out_def
        self.out_meta = out_meta

    def __call__(self, *args):
        return self.call_async(*args).result()

    def call_async(self, *args) -> RemoteFuture:
        leaves, in_def = tree_flatten(args)
        if in_def != self._in_def:
            raise ValueError("arguments differ in structure from the "
                             "example the program was traced with")
        client = self._client
        bufs, uploaded = [], []
        # a failure from the first upload on frees what was uploaded (a
        # retried step must not leak its uploads against the memory cap);
        # that free is best effort, so the original error wins
        try:
            for leaf in leaves:
                if isinstance(leaf, RemoteBuffer):
                    bufs.append(leaf)
                else:
                    buf = client.put(leaf)
                    bufs.append(buf)
                    uploaded.append(buf)
            fut = client.execute_async(self._exec_id,
                                       [b.handle for b in bufs])
        except Exception:
            if uploaded:
                try:
                    client.free(*uploaded)
                except Exception:
                    pass
            raise

        def resolve():
            handles = fut.result()
            if uploaded:
                client.free(*uploaded)
            out = [RemoteBuffer(h, tuple(shape), dtype)
                   for h, (shape, dtype) in zip(handles, self.out_meta)]
            return tree_unflatten(self._out_def, out)

        return RemoteFuture(resolve)


class RemoteLoop:
    """A compiled loop program (see :meth:`ProxyClient.compile_loop`).

    ``new_carry, aux = loop(n, carry, *consts)`` runs up to ``n`` steps on
    the proxy in one token-gated burst; :meth:`chain` runs toward ``n``
    steps as a server-side chain of bursts. The old carry's handles are
    consumed (the proxy updates the carry in place); consts persist.
    """

    def __init__(self, client: "ProxyClient", exec_id: int, carry_def,
                 out_meta: list, ncarry: int, naux: int):
        self._client = client
        self._exec_id = exec_id
        self._carry_def = carry_def
        self.out_meta = out_meta
        self._ncarry = ncarry
        self._naux = naux
        #: steps the proxy actually ran on the last call — it may clamp a
        #: long burst to keep one dispatch near the scheduling quantum
        self.last_n = 0
        #: the per-burst clamp inside the last call (equals last_n for a
        #: plain call) — the burst controller's steady state
        self.last_burst = 0

    def __call__(self, n: int, carry, *consts):
        return self._dispatch(int(n), carry, consts, chain=False)

    def chain(self, n: int, carry, *consts):
        """Run toward ``n`` steps with server-side burst chaining. May stop
        early; ``last_n`` reports the steps run."""
        return self._dispatch(int(n), carry, consts, chain=True)

    def _dispatch(self, n: int, carry, consts, chain: bool):
        if n < 1:
            raise ValueError(f"loop count must be >= 1, got {n}")
        leaves = tree_leaves((carry, *consts))
        if not all(isinstance(x, RemoteBuffer) for x in leaves):
            raise TypeError("RemoteLoop args must be device-resident "
                            "(put them first)")
        msg = {"op": "execute", "name": self._client.name,
               "exec_id": self._exec_id,
               "args": [b.handle for b in leaves],
               "donate": [b.handle for b in leaves[:self._ncarry]]}
        msg["chain_steps" if chain else "repeat"] = n
        reply, _ = self._client._conn.call(msg)
        self.last_n = int(reply["repeat"])
        self.last_burst = int(reply.get("burst", self.last_n))
        out = [RemoteBuffer(h, tuple(shape), dtype)
               for h, (shape, dtype) in zip(reply["handles"], self.out_meta)]
        new_carry = tree_unflatten(self._carry_def, out[:self._ncarry])
        aux = out[self._ncarry:]
        return new_carry, (aux[0] if self._naux == 1 else tuple(aux))


class ProxyClient:
    """Connection to a :class:`~.proxy.ChipProxy` for one named client."""

    def __init__(self, host: str, port: int, name: str, request: float,
                 limit: float, memory: int = 0,
                 timeout: float | None = None):
        self.name = name
        self._conn = protocol.Connection(host, port, timeout=timeout)
        reply, _ = self._conn.call({"op": "register", "name": name,
                                    "request": request, "limit": limit,
                                    "memory": memory})
        self.platforms: list[str] = reply["platforms"]
        self.device: str = reply.get("device", "")
        self.last_compile: dict = {}

    # -- buffers -------------------------------------------------------------

    def put(self, array) -> RemoteBuffer:
        """Upload a host array (numpy, or a tensor on the CPU)."""
        reply, _ = self._conn.call(
            {"op": "put", "name": self.name},
            blob=protocol.dump_array_parts(_host_array(array)))
        return RemoteBuffer(reply["handle"], tuple(reply["shape"]),
                            reply["dtype"])

    def get(self, buf: RemoteBuffer) -> np.ndarray:
        _, blob = self._conn.call({"op": "get", "name": self.name,
                                   "handle": buf.handle})
        return load_array(blob)

    def free(self, *bufs) -> None:
        handles = [b.handle for b in tree_leaves(bufs)
                   if isinstance(b, RemoteBuffer)]
        if handles:
            self._conn.call({"op": "free", "name": self.name,
                             "handles": handles})

    def put_tree(self, tree):
        """Upload a tree of host arrays → same-shaped tree of buffers."""
        return tree_map(self.put, tree)

    def get_tree(self, tree):
        return tree_map(
            lambda b: self.get(b) if isinstance(b, RemoteBuffer) else b, tree)

    # -- programs ------------------------------------------------------------

    def compile(self, fn, *example_args) -> RemoteExecutable:
        """Trace ``fn(*example_args)`` here, abstractly (nothing runs),
        save it (:func:`.exported.export_program`) and compile it on the
        proxy. Only the shapes and dtypes of ``example_args``' leaves
        (tensors, arrays, :class:`RemoteBuffer`\\ s) are read."""
        from .exported import export_program

        t0 = time.perf_counter()
        blob, in_def, out_def, out_meta = export_program(
            fn, example_args, self.device)
        t1 = time.perf_counter()
        reply, _ = self._conn.call({"op": "compile", "name": self.name},
                                   blob=[blob])
        if [list(m) for m in reply["out_meta"]] != [list(m) for m in
                                                    out_meta]:
            raise RuntimeError(f"the proxy's outputs {reply['out_meta']} "
                               f"differ from the trace's {out_meta}")
        #: the last compile, for the record: the saved program's bytes,
        #: the seconds to trace and save it here, and the seconds of the
        #: compile round trip (sending it, the proxy's load)
        self.last_compile = {"blob_nbytes": len(blob), "export_s": t1 - t0,
                             "compile_s": time.perf_counter() - t1}
        return RemoteExecutable(self, reply["exec_id"], in_def, out_def,
                                reply["out_meta"])

    def execute_async(self, exec_id: int, handles: list[int]
                      ) -> RemoteFuture:
        """Run a compiled saved program on the handles; the future
        resolves to the output handles. Lockstep: the reply is in when
        this returns, and a failed run raises here."""
        reply, _ = self._conn.call({"op": "execute", "name": self.name,
                                    "exec_id": exec_id,
                                    "args": list(handles)})  # raises here
        return RemoteFuture(lambda: list(reply["handles"]))

    def compile_loop(self, spec: dict, carry, *consts) -> RemoteLoop:
        """Compile the registered program ``spec`` as a loop program over
        ``carry`` (a tree of :class:`RemoteBuffer`) and ``consts``; only
        their shapes and dtypes are sent."""
        carry_leaves, carry_def = tree_flatten(carry)
        leaves = carry_leaves + tree_leaves(consts)
        if not all(isinstance(x, RemoteBuffer) for x in leaves):
            raise TypeError("compile_loop args must be device-resident "
                            "(put them first)")
        reply, _ = self._conn.call({
            "op": "compile", "name": self.name, "spec": spec,
            "ncarry": len(carry_leaves),
            "in_meta": [[list(b.shape), b.dtype] for b in leaves]})
        return RemoteLoop(self, reply["exec_id"], carry_def,
                          reply["out_meta"], len(carry_leaves),
                          int(reply["naux"]))

    def usage(self) -> dict:
        reply, _ = self._conn.call({"op": "usage", "name": self.name})
        return reply

    def close(self) -> None:
        try:
            self._conn.call({"op": "unregister", "name": self.name})
        except (OSError, RuntimeError):
            pass  # connection already gone: the proxy drops the session
        self._conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# --------------------------------------------------------------------------
# gate mode: a process that owns the card
# --------------------------------------------------------------------------

def device_barrier() -> None:
    """Wait until every kernel this process queued on its current CUDA
    device has finished (all its streams: the caching allocator's, the
    autograd engine's and the hand-written kernels' launches alike). A
    process that has not initialized CUDA has queued nothing, and returns
    at once."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _completion_event(out):
    """An event recorded behind ``out``'s producing work, on the current
    stream of the first CUDA tensor in ``out`` (a tensor or a tree of
    them); None when ``out`` holds none."""
    from torch.utils._pytree import tree_leaves as leaves

    for leaf in leaves(out):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(leaf.device))
            return event
    return None


class HbmCap:
    """The memory grant (``tpu_mem``) of a process that owns its card.

    The reference's hook caps ``gpu_mem`` at allocation time inside every
    shared pod (``pkg/scheduler/pod.go:419-424``); the JAX package polls
    ``device.memory_stats()``'s ``bytes_in_use``. The port reads
    ``torch.cuda.memory_reserved``, summed over the visible devices: the
    bytes the caching allocator holds, which a co-tenant cannot use,
    whether or not a live tensor sits in them. A breach kills the
    workload with an attributable error; its death releases its token
    through the pod manager's crash-release path, so co-tenants are
    unharmed.

    Where there are no allocator stats (no CUDA device: the CPU) the cap
    **fails closed**: a granted cap that cannot be enforced stops the
    process instead of letting it run unenforced.
    """

    def __init__(self, cap_bytes: int, stats_fn=None,
                 min_poll_interval_s: float = 0.25):
        self.cap_bytes = int(cap_bytes)
        self._stats = stats_fn or self._device_stats
        self._min_poll_s = min_poll_interval_s
        self._last_poll = 0.0
        #: stats have been read successfully at least once — separates
        #: "no allocator stats" (fail closed) from "one poll failed"
        self._supported = False

    @staticmethod
    def _device_stats():
        """``{"bytes_reserved": n}`` over every visible CUDA device, or
        None when there is none. Before CUDA is initialized the allocator
        holds nothing and each device reads 0."""
        if not torch.cuda.is_available():
            return None
        return {"bytes_reserved": sum(torch.cuda.memory_reserved(i)
                                      for i in range(torch.cuda.device_count()))}

    def check(self, extra_bytes: int = 0) -> None:
        """Enforce the cap now. ``extra_bytes`` pre-charges a host→device
        copy about to happen, so a single oversized copy is refused before
        its bytes land."""
        if not self.cap_bytes:
            return
        try:
            stats = self._stats()
        except Exception as exc:
            if self._supported:
                # the device HAS stats and this one poll failed: skip it
                # (killing a healthy pod over one failed poll is failing
                # closed in the wrong place), once per poll interval
                self._last_poll = time.monotonic()
                log.warning("memory stats poll failed (%s); skipping this "
                            "check", exc)
                return
            # the first poll: a transient failure is not "no stats" —
            # retry briefly before deciding, as the JAX gate does
            for _ in range(3):
                time.sleep(0.1)
                try:
                    stats = self._stats()
                    break
                except Exception as retry_exc:
                    exc = retry_exc
            else:
                raise SystemExit(
                    f"kubeshare-tpu: memory grant {self.cap_bytes} bytes, "
                    f"but the allocator stats query keeps failing ({exc}) "
                    f"— the cap cannot be enforced in gate mode. Refusing "
                    f"to run unenforced.")
        if stats is None:
            raise SystemExit(
                f"kubeshare-tpu: memory grant {self.cap_bytes} bytes, but "
                f"this process has no CUDA allocator stats (no CUDA "
                f"device) — the cap cannot be enforced in gate mode. "
                f"Refusing to run unenforced; drop the memory grant.")
        self._supported = True
        self._last_poll = time.monotonic()
        used = int(stats["bytes_reserved"]) + int(extra_bytes)
        if used > self.cap_bytes:
            raise SystemExit(
                f"kubeshare-tpu: device memory cap exceeded: {used} bytes "
                f"{'(incl. pending transfer) ' if extra_bytes else ''}"
                f"reserved > grant of {self.cap_bytes} (KUBESHARE_TPU_MEM); "
                f"reduce model/batch or raise the request")

    def maybe_check(self) -> None:
        """Throttled :meth:`check` for the per-op meter: bound the poll
        rate, not the op rate."""
        if self.cap_bytes and (time.monotonic() - self._last_poll
                               >= self._min_poll_s):
            self.check()


class ExecutionGate:
    """Token gate for a process that owns its card (hook parity).

    Call the gate before work; the wall time between the previous call and
    this one is charged as device usage. It acquires a quota on first use
    and renews — atomically release + re-request — when the charged usage
    exhausts it, blocking the whole process (an RLock: every thread waits
    through a renew) until the token comes back.

    Completion barrier. PyTorch launches asynchronously, so wall time at
    launch under-counts the card's time. A result handed to
    :meth:`note_dispatch` (a gated compiled call's) gets an event behind
    it, and the next gate call waits for that event before it reads the
    clock, as the JAX gate host-reads its pending result. Eager PyTorch
    has no per-call result, so before every ``renew`` and ``release`` the
    gate also waits for the device's queue (``barrier``, by default
    :func:`device_barrier`) and charges the wait: the tenant's queued
    kernels finish, and are paid for, before the token passes to a
    co-tenant. The JAX gate has no such drain (XLA's one program per call
    is its unit); the port adds it on purpose.

    :meth:`stats` reads the gate's running totals: grants, ms charged,
    ms spent draining and ms spent waiting for the token.
    """

    def __init__(self, conn: protocol.Connection, name: str,
                 barrier=device_barrier):
        self._conn = conn
        self.name = name
        self._barrier = barrier
        self._quota_ms = 0.0
        self._used_ms = 0.0
        self._last: float | None = None
        self._pending = None
        self._mu = threading.RLock()
        # totals over the gate's life: reported charges (of finished
        # grants), drains, token waits (acquire and renew round trips)
        self._acquires = 0
        self._renews = 0
        self._reported_ms = 0.0
        self._drain_ms = 0.0
        self._waited_ms = 0.0

    def note_dispatch(self, out) -> None:
        """Record the (possibly still running) result of a gated call; the
        next gate call charges through its completion."""
        event = _completion_event(out)
        with self._mu:
            self._pending = event

    def _complete_pending(self) -> None:
        # caller holds self._mu
        if self._pending is not None:
            event, self._pending = self._pending, None
            event.synchronize()

    def _charge(self) -> None:
        # caller holds self._mu: wall time since the last call
        now = time.monotonic() * 1000.0
        if self._last is not None:
            self._used_ms += now - self._last
        self._last = now

    def _drain(self) -> None:
        # caller holds self._mu: the device's queue, charged
        t0 = time.monotonic() * 1000.0
        self._barrier()
        self._charge()
        self._drain_ms += self._last - t0

    def _call(self, msg: dict) -> dict:
        # caller holds self._mu: a token round trip, timed
        t0 = time.monotonic()
        reply, _ = self._conn.call(msg)
        self._waited_ms += (time.monotonic() - t0) * 1000.0
        return reply

    def __call__(self) -> None:
        with self._mu:
            self._complete_pending()
            self._charge()
            if self._quota_ms <= 0.0:
                reply = self._call({"op": "acquire", "name": self.name})
                self._acquires += 1
                self._quota_ms = reply["quota_ms"]
                self._used_ms = 0.0
            elif self._used_ms >= self._quota_ms:
                self._drain()
                reply = self._call({"op": "renew", "name": self.name,
                                    "used_ms": self._used_ms})
                self._renews += 1
                self._reported_ms += self._used_ms
                self._quota_ms = reply["quota_ms"]
                self._used_ms = 0.0
            self._last = time.monotonic() * 1000.0

    def close(self) -> None:
        """Release the token (if held), charging through the device's
        queue. The connection stays open (as the JAX gate's does): over a
        direct scheduler connection it owns the registration, which lives
        until the process exits or the caller closes ``conn``."""
        with self._mu:
            if self._quota_ms > 0.0:
                self._complete_pending()
                self._charge()
                self._drain()
                try:
                    self._conn.call({"op": "release", "name": self.name,
                                     "used_ms": self._used_ms})
                except (OSError, RuntimeError):
                    pass
                self._reported_ms += self._used_ms
                self._used_ms = 0.0
                self._quota_ms = 0.0

    def stats(self) -> dict:
        """Totals so far: ``acquires``, ``renews``, ``charged_ms`` (ms
        reported to the scheduler plus the current grant's charge up to
        the last gate call), ``drain_ms`` and ``waited_ms``."""
        with self._mu:
            return {"acquires": self._acquires, "renews": self._renews,
                    "charged_ms": self._reported_ms + self._used_ms,
                    "drain_ms": self._drain_ms,
                    "waited_ms": self._waited_ms}

    @classmethod
    def connect(cls, host: str, port: int, name: str, request: float,
                limit: float, barrier=device_barrier) -> "ExecutionGate":
        """Dial a pod manager (or a token scheduler) and register."""
        conn = protocol.Connection(host, port)
        conn.call({"op": "register", "name": name, "request": request,
                   "limit": limit})
        return cls(conn, name, barrier)
