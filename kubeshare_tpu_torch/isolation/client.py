"""Client side of the isolation runtime.

Counterpart of ``kubeshare_tpu/isolation/client.py``:

- :class:`ProxyClient` is the stand-in for the card in a client that
  never owns it. The client stages its state on the host with numpy,
  ``put``s it, and runs programs on the proxy: its own functions, traced
  abstractly and saved by :mod:`.exported` (:meth:`~ProxyClient.compile`,
  what the proxy-mode attach forwards; :meth:`~ProxyClient.compile_loop`
  for a step looped N times a burst), or registered loop specs
  (:mod:`.programs`). Tensors live there as handles
  (:class:`RemoteBuffer`), so a training loop transfers its parameters
  once. It negotiates the pipelined transport (``"seq"``: many requests
  in flight, replies resolved to futures) and, by default, a resumable
  session (``"resume"``): a dropped connection, a proxy restarted from
  its journal or a session moved to another proxy is reconnected and
  replayed underneath the caller (:mod:`..resilience.reconnect`). Arrays
  larger than ``chunk_bytes`` cross in windowed chunks.
- :class:`ExecutionGate` and :class:`HbmCap` are for a process that owns
  the card itself (gate-mode attach, :mod:`kubeshare_tpu_torch.attach`):
  the gate passes a token round trip with the pod manager before work,
  the cap holds the process to its memory grant.

A ``trace_id`` given to either rides every request (the wire's
``_trace``), so the server's ``token-grant`` and ``execute`` spans join
the caller's trace; a traced client records each execute's round trip as
a ``transport`` span. A windowed put or get that blocks on its oldest
chunk counts a window stall.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..utils.logger import get_logger
from ..utils.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from . import protocol
from .protocol import load_array

log = get_logger("client")

_WINDOW_STALLS = obs_metrics.default_registry().counter(
    "kubeshare_client_window_stalls_total",
    "Times a windowed put/get stream had to block on its oldest in-flight "
    "chunk before submitting the next (transfer credit exhausted — the "
    "wire or the peer is the bottleneck, not this client).", labels=("op",))


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
    :meth:`RemoteExecutable.call_async`, :meth:`RemoteLoop.call_async`).
    ``result()`` blocks until the reply is in, maps it once and returns
    (or raises) the same outcome on every later call. On a lockstep
    connection the dispatch completed when the future was made."""

    __slots__ = ("_resolve", "_pending", "_mu", "_done", "_value", "_exc")

    def __init__(self, resolve, pending=None):
        self._resolve = resolve        # () -> value; blocks, may raise
        self._pending = pending
        self._mu = threading.Lock()
        self._done = False
        self._value = None
        self._exc: Exception | None = None

    def done(self) -> bool:
        with self._mu:
            if self._done:
                return True
        return self._pending is None or self._pending.done()

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


def _remote(handles, out_meta) -> list:
    return [RemoteBuffer(h, tuple(shape), dtype)
            for h, (shape, dtype) in zip(handles, out_meta)]


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

    def __call__(self, *args, donate: bool = False):
        return self.call_async(*args, donate=donate).result()

    def call_async(self, *args, donate: bool = False) -> RemoteFuture:
        """Dispatch without waiting: the uploads happen now, the execute
        rides the pipelined connection, and the future resolves to the
        output tree; the uploads are freed when it resolves. ``donate``
        donates every argument, uploads included: a successful run frees
        them on the proxy (an output that is one of them keeps its
        storage), a failed one frees nothing but the uploads."""
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
            handles = [b.handle for b in bufs]
            fut = client.execute_async(self._exec_id, handles,
                                       donate=handles if donate else ())
        except Exception:
            client._free_quietly(uploaded)
            raise

        def resolve():
            try:
                handles = fut.result()
            except Exception:
                client._free_quietly(uploaded)
                raise
            if not donate:
                client._free_quietly(uploaded)
            return tree_unflatten(self._out_def,
                                  _remote(handles, self.out_meta))

        return RemoteFuture(resolve, fut._pending)


class RemoteLoop:
    """A compiled loop program (see :meth:`ProxyClient.compile_loop`).

    ``new_carry, aux = loop(n, carry, *consts)`` runs up to ``n`` steps on
    the proxy in one token-gated burst; :meth:`chain` runs toward ``n``
    steps as a server-side chain of bursts. The old carry's handles are
    consumed (the proxy updates the carry in place); consts persist.
    """

    def __init__(self, client: "ProxyClient", exec_id: int, out_def,
                 out_meta: list, ncarry: int):
        self._client = client
        self._exec_id = exec_id
        #: the structure of ``(new_carry, aux)``
        self._out_def = out_def
        self.out_meta = out_meta
        self._ncarry = ncarry
        #: steps the proxy actually ran on the last call — it may clamp a
        #: long burst to keep one dispatch near the scheduling quantum
        self.last_n = 0
        #: the per-burst clamp inside the last call (equals last_n for a
        #: plain call) — the burst controller's steady state
        self.last_burst = 0

    def __call__(self, n: int, carry, *consts):
        return self.call_async(n, carry, *consts).result()

    def call_async(self, n: int, carry, *consts) -> RemoteFuture:
        """Dispatch one burst without waiting; ``last_n``/``last_burst``
        update when the future resolves."""
        return self._dispatch_async(int(n), carry, consts, chain=False)

    def chain(self, n: int, carry, *consts):
        """Run toward ``n`` steps with server-side burst chaining. May stop
        early; ``last_n`` reports the steps run."""
        return self._dispatch_async(int(n), carry, consts,
                                    chain=True).result()

    def _dispatch_async(self, n: int, carry, consts, chain: bool
                        ) -> RemoteFuture:
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
        fut = self._client._dispatch(msg, lambda reply: reply)

        def resolve():
            reply = fut.result()
            self.last_n = int(reply["repeat"])
            self.last_burst = int(reply.get("burst", self.last_n))
            return tree_unflatten(self._out_def,
                                  _remote(reply["handles"], self.out_meta))

        return RemoteFuture(resolve, fut._pending)


class ProxyClient:
    """Connection to a :class:`~.proxy.ChipProxy` for one named client.

    ``reconnect="auto"`` (the default) or a
    :class:`~..resilience.reconnect.ReconnectPolicy` makes the session
    resumable: a dead connection is re-dialed and replayed underneath the
    caller, a ``"moved"`` session followed, and only a spent budget
    surfaces, as ``SessionLost``. ``reconnect=None`` keeps the lockstep
    client of earlier releases: it negotiates nothing (the reference's
    legacy transport still asks for ``"seq"``), failures surface at once
    and a dropped connection frees the session. ``fault_tag`` names the
    connection for the fault injector; ``trace_id`` rides every request
    of the session, across reconnects."""

    #: frees sent without waiting that may be outstanding before the
    #: oldest one is waited for
    MAX_UNREAPED = 64

    def __init__(self, host: str, port: int, name: str, request: float,
                 limit: float, memory: int = 0,
                 timeout: float | None = None, chunk_bytes: int = 64 << 20,
                 reconnect="auto", fault_tag: str = "",
                 tpu_class: str = "best-effort", trace_id: str = ""):
        self.name = name
        #: transfer slab of put/get: larger arrays cross in windowed
        #: slices, so a buffer may exceed the wire's frame cap
        self.chunk_bytes = chunk_bytes
        register = {"op": "register", "name": name, "request": request,
                    "limit": limit, "memory": memory}
        if tpu_class != "best-effort":
            # sent only when not the default, so the wire to a proxy that
            # keeps no classes is unchanged
            register["class"] = tpu_class
        if reconnect is None:
            # the lockstep client: no features asked, so the proxy grants
            # none and answers as it always has
            self._conn = protocol.Connection(host, port, timeout=timeout,
                                             trace_id=trace_id,
                                             fault_tag=fault_tag)
            reply, _ = self._conn.call(register)
        else:
            from ..resilience.reconnect import (ReconnectPolicy,
                                                ResilientConnection)
            policy = (reconnect if isinstance(reconnect, ReconnectPolicy)
                      else None)
            self._conn = ResilientConnection(host, port, timeout=timeout,
                                             policy=policy,
                                             fault_tag=fault_tag,
                                             trace_id=trace_id)
            reply = self._conn.open(dict(register,
                                         features=list(protocol.FEATURES)))
        self.platforms: list[str] = reply["platforms"]
        self.device: str = reply.get("device", "")
        #: transport features both ends agreed on at register
        self.features: frozenset[str] = frozenset(reply.get("features", ()))
        self.last_compile: dict = {}
        self._unreaped: deque = deque()
        self._reap_mu = threading.Lock()

    # -- buffers -------------------------------------------------------------

    def _chunk(self) -> int:
        # read MAX_FRAME at call time: the slab must fit the wire's cap
        return max(1, min(self.chunk_bytes, protocol.MAX_FRAME - 4096))

    @staticmethod
    def _window(chunk: int) -> int:
        """Chunks in flight for a windowed put or get: enough to keep the
        wire busy across a reply's round trip, never more than ~256 MiB."""
        return max(2, min(16, (256 << 20) // max(chunk, 1)))

    def put(self, array) -> RemoteBuffer:
        """Upload a host array (numpy, or a tensor on the CPU)."""
        parts = protocol.dump_array_parts(_host_array(array))
        nbytes = protocol.buffers_nbytes(parts)
        chunk = self._chunk()
        if nbytes <= chunk:
            reply, _ = self._conn.call({"op": "put", "name": self.name},
                                       blob=parts)
        else:
            try:
                reply = self._put_chunked(parts, nbytes, chunk)
            except RuntimeError as exc:
                if "invalidated by disconnect" not in str(exc):
                    raise
                # the connection died mid-window and the proxy dropped the
                # half-landed staging; the session survived: once more
                reply = self._put_chunked(parts, nbytes, chunk)
        return RemoteBuffer(reply["handle"], tuple(reply["shape"]),
                            reply["dtype"])

    def _put_chunked(self, parts: list, nbytes: int, chunk: int) -> dict:
        """A staged upload: a window of chunks in flight on a pipelined
        connection (each landing in the proxy's staging buffer), one a
        round trip on a lockstep one. The device bytes were reserved at
        put_begin, so a refusal comes before the stream moves."""
        conn = self._conn
        reply0, _ = conn.call({"op": "put_begin", "name": self.name,
                               "nbytes": nbytes})
        sid = reply0["staging"]
        pending: deque = deque()
        try:
            for off in range(0, nbytes, chunk):
                msg = {"op": "put_chunk", "name": self.name,
                       "staging": sid, "offset": off}
                blob = protocol.slice_buffers(parts, off, chunk)
                if not conn.pipelined:
                    conn.call(msg, blob=blob)
                    continue
                if len(pending) >= self._window(chunk):
                    head = pending.popleft()
                    if not head.done():
                        _WINDOW_STALLS.inc("put")
                    head.result()
                pending.append(conn.submit(msg, blob=blob))
            while pending:
                pending.popleft().result()
            reply, _ = conn.call({"op": "put_commit", "name": self.name,
                                  "staging": sid})
            return reply
        except RuntimeError:
            # the proxy refused (cap, bad chunk): drain the window, then
            # drop the staged bytes; the connection is still in sync
            while pending:
                try:
                    pending.popleft().result()
                except Exception:
                    pass
            try:
                conn.call({"op": "put_abort", "name": self.name,
                           "staging": sid})
            except Exception:
                pass
            raise

    def get(self, buf: RemoteBuffer) -> np.ndarray:
        """Download a buffer. One larger than a slab crosses in slices,
        a window of them in flight on a pipelined connection; its stream
        is the buffer's bytes and a header under 4 KiB, so the
        destination is made before the first reply and every slice lands
        in place."""
        chunk = self._chunk()
        conn = self._conn
        if buf.nbytes + 4096 <= chunk:
            _, blob = conn.call({"op": "get", "name": self.name,
                                 "handle": buf.handle})
            return load_array(blob)
        raw = bytearray(buf.nbytes + 4096)
        mv = memoryview(raw)

        def ask(off: int, length: int):
            return ({"op": "get", "name": self.name, "handle": buf.handle,
                     "offset": off, "length": length},
                    mv[off:off + length])

        def landed(off: int, length: int, part) -> None:
            if memoryview(part).nbytes != length:
                raise protocol.ProtocolError(
                    f"slice at {off}: {memoryview(part).nbytes} bytes, "
                    f"asked {length}")
            if not (isinstance(part, memoryview) and part.obj is raw):
                mv[off:off + length] = part

        msg, view = ask(0, chunk)
        reply, part = conn.call(msg, sink=view)
        total = int(reply["total"])
        if total > len(raw):       # a header past its allowance: never
            raise protocol.ProtocolError(f"a {buf.nbytes}-byte buffer "
                                         f"streams {total} bytes")
        landed(0, min(chunk, total), part)
        pending: deque = deque()
        off = min(chunk, total)
        while off < total or pending:
            while off < total and (not pending or len(pending)
                                   < self._window(chunk)):
                length = min(chunk, total - off)
                msg, view = ask(off, length)
                if conn.pipelined:
                    pending.append((off, length,
                                    conn.submit(msg, sink=view)))
                else:
                    landed(off, length, conn.call(msg, sink=view)[1])
                off += length
            if pending:
                doff, dlen, rep = pending.popleft()
                if not rep.done():
                    _WINDOW_STALLS.inc("get")
                landed(doff, dlen, rep.result()[1])
        return load_array(mv[:total])

    def free(self, *bufs, wait: bool = True) -> None:
        """Free the buffers in ``bufs`` (any tree). ``wait=False`` sends
        the free on a pipelined connection without waiting for its reply,
        which a later call collects."""
        handles = [b.handle for b in tree_leaves(bufs)
                   if isinstance(b, RemoteBuffer)]
        self._reap()
        if not handles:
            return
        msg = {"op": "free", "name": self.name, "handles": handles}
        if wait or not self._conn.pipelined:
            self._conn.call(msg)
            return
        rep = self._conn.submit(msg)
        with self._reap_mu:
            self._unreaped.append(rep)

    def _reap(self, block: bool = False) -> None:
        """Collect the replies of frees sent without waiting: those in,
        and the oldest ones while too many are out (all with ``block``)."""
        while True:
            with self._reap_mu:
                if not self._unreaped:
                    return
                rep = self._unreaped[0]
                if not (block or rep.done()
                        or len(self._unreaped) > self.MAX_UNREAPED):
                    return
                self._unreaped.popleft()
            try:
                rep.result()
            except Exception as exc:
                log.warning("a free sent without waiting failed: %s", exc)

    def _free_quietly(self, bufs) -> None:
        """Free a call's uploads; best effort, the call's outcome wins."""
        if bufs:
            try:
                self.free(*bufs)
            except Exception:
                pass

    def put_tree(self, tree):
        """Upload a tree of host arrays → same-shaped tree of buffers."""
        return tree_map(self.put, tree)

    def get_tree(self, tree):
        return tree_map(
            lambda b: self.get(b) if isinstance(b, RemoteBuffer) else b, tree)

    # -- programs ------------------------------------------------------------

    def _export_and_compile(self, fn, example_args, ncarry: int | None):
        """Trace ``fn(*example_args)`` here, abstractly (nothing runs),
        save it (:func:`.exported.export_program`) and compile it on the
        proxy. Returns ``(exec_id, in_def, out_def, out_meta)``."""
        from .exported import export_program

        t0 = time.perf_counter()
        blob, in_def, out_def, out_meta = export_program(
            fn, example_args, self.device)
        t1 = time.perf_counter()
        msg = {"op": "compile", "name": self.name}
        if ncarry is not None:
            msg["ncarry"] = ncarry
        reply, _ = self._conn.call(msg, blob=[blob])
        if [list(m) for m in reply["out_meta"]] != [list(m) for m in
                                                    out_meta]:
            raise RuntimeError(f"the proxy's outputs {reply['out_meta']} "
                               f"differ from the trace's {out_meta}")
        #: the last compile, for the record: the saved program's bytes,
        #: the seconds to trace and save it here, and the seconds of the
        #: compile round trip (sending it, the proxy's load)
        self.last_compile = {"blob_nbytes": len(blob), "export_s": t1 - t0,
                             "compile_s": time.perf_counter() - t1}
        return reply["exec_id"], in_def, out_def, reply["out_meta"]

    def compile(self, fn, *example_args) -> RemoteExecutable:
        """Trace ``fn(*example_args)`` here, abstractly (nothing runs),
        save it (:func:`.exported.export_program`) and compile it on the
        proxy. Only the shapes and dtypes of ``example_args``' leaves
        (tensors, arrays, :class:`RemoteBuffer`\\ s) are read."""
        exec_id, in_def, out_def, out_meta = self._export_and_compile(
            fn, example_args, None)
        return RemoteExecutable(self, exec_id, in_def, out_def, out_meta)

    def compile_loop(self, fn, carry, *consts) -> RemoteLoop:
        """Compile ``fn(carry, *consts) -> (carry, aux)`` as a loop
        program: :class:`RemoteLoop` runs N steps a dispatch on the proxy,
        one token-gated burst, the carry threaded through (and updated in
        place). ``fn`` is traced once, as :meth:`compile` traces, and must
        give back a carry of the structure it was given. ``carry`` and
        ``consts`` are trees of :class:`RemoteBuffer`.

        ``fn`` may instead be a registered program spec (a dict,
        :mod:`.programs`), which the proxy builds itself; then only the
        arguments' shapes and dtypes are sent."""
        carry_leaves, carry_def = tree_flatten(carry)
        leaves = carry_leaves + tree_leaves(consts)
        if not all(isinstance(x, RemoteBuffer) for x in leaves):
            raise TypeError("compile_loop args must be device-resident "
                            "(put them first)")
        ncarry = len(carry_leaves)
        if isinstance(fn, dict):
            reply, _ = self._conn.call({
                "op": "compile", "name": self.name, "spec": fn,
                "ncarry": ncarry,
                "in_meta": [[list(b.shape), b.dtype] for b in leaves]})
            naux = int(reply["naux"])
            aux_def = None if naux == 1 else ("tuple", naux, (None,) * naux)
            return RemoteLoop(self, reply["exec_id"],
                              ("tuple", 2, (carry_def, aux_def)),
                              reply["out_meta"], ncarry)

        def checked_fn(c, *cs):
            new_carry, aux = fn(c, *cs)
            new_def = tree_flatten(new_carry)[1]
            if new_def != tree_flatten(c)[1]:
                raise TypeError(
                    f"loop fn must preserve carry structure: {new_def} "
                    f"!= {tree_flatten(c)[1]}")
            return new_carry, aux

        exec_id, _, out_def, out_meta = self._export_and_compile(
            checked_fn, (carry, *consts), ncarry)
        return RemoteLoop(self, exec_id, out_def, out_meta, ncarry)

    def _dispatch(self, msg: dict, unwrap) -> RemoteFuture:
        """Send an execute; the future resolves to ``unwrap(reply)``. On a
        lockstep connection it is resolved (or raises) here. A traced
        session records the round trip as a ``transport`` span (critpath
        subtracts the proxy's own ``execute`` span from it)."""
        tid = getattr(self._conn, "trace_id", "")
        tracer = obs_trace.get_tracer() if tid else None
        t0 = tracer.now_ms() if tracer is not None else 0.0

        def transport_span():
            if tracer is not None:
                tracer.record("transport", tid, t0, tracer.now_ms(),
                              proc="client", op="execute")

        if self._conn.pipelined:
            rep = self._conn.submit(msg)

            def resolve():
                reply = rep.result()[0]
                transport_span()
                return unwrap(reply)

            return RemoteFuture(resolve, rep)
        reply, _ = self._conn.call(msg)
        transport_span()
        return RemoteFuture(lambda: unwrap(reply))

    def execute_async(self, exec_id: int, handles: list[int], donate=()
                      ) -> RemoteFuture:
        """Run a compiled saved program on the handles without waiting;
        the future resolves to the output handles. The ``donate`` handles
        are freed on the proxy once the run succeeds. On a pipelined
        connection many dispatches ride the wire at once; the proxy runs a
        session's requests in submission order."""
        msg = {"op": "execute", "name": self.name, "exec_id": exec_id,
               "args": list(handles)}
        if donate:
            msg["donate"] = [int(h) for h in donate]
        return self._dispatch(msg, lambda reply: list(reply["handles"]))

    def flush(self) -> None:
        """Send any corked requests now."""
        if self._conn.pipelined:
            self._conn.flush()

    def usage(self) -> dict:
        reply, _ = self._conn.call({"op": "usage", "name": self.name})
        return reply

    def transport(self) -> dict:
        """The connection's record: features, and the reconnects that
        resumed the session and the requests they replayed."""
        return {"features": sorted(self.features),
                "resumes": getattr(self._conn, "resumes", 0),
                "replayed": getattr(self._conn, "replayed", 0)}

    @property
    def trace_id(self) -> str:
        """The trace id every request of this session carries (``""``:
        none); settable, the next request carries the new one."""
        return self._conn.trace_id

    @trace_id.setter
    def trace_id(self, trace_id: str) -> None:
        self._conn.trace_id = trace_id

    def set_endpoint(self, host: str, port: int) -> None:
        """Point later reconnects at another proxy (the migration flip).
        Needs a resumable session."""
        fn = getattr(self._conn, "set_endpoint", None)
        if fn is None:
            raise RuntimeError("set_endpoint requires reconnect support "
                               "(ProxyClient(..., reconnect='auto'))")
        fn(host, port)

    def close(self) -> None:
        if getattr(self._conn, "healthy", True):
            # over a live channel only: unregistering a lost session would
            # spend the whole reconnect budget here
            try:
                self._reap(block=True)
                self._conn.call({"op": "unregister", "name": self.name})
            except Exception:
                pass  # the connection is gone: the proxy drops the session
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
                limit: float, barrier=device_barrier,
                trace_id: str = "") -> "ExecutionGate":
        """Dial a pod manager (or a token scheduler) and register.
        ``trace_id`` rides every message, so the server's ``token-grant``
        spans join the caller's trace."""
        conn = protocol.Connection(host, port, trace_id=trace_id)
        conn.call({"op": "register", "name": name, "request": request,
                   "limit": limit})
        return cls(conn, name, barrier)
