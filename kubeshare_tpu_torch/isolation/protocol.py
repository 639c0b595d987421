"""Framed-JSON socket protocol of the isolation runtime.

A copy of ``kubeshare_tpu/isolation/protocol.py``'s wire without its
metrics: every message is a 4-byte big-endian length followed by a UTF-8
JSON object, and a binary payload (an array crossing the proxy boundary)
rides as raw bytes after the JSON, announced by ``_blob`` (its byte
length).

Two transport modes, as in the JAX package:

- **lockstep** (the default, and all that a peer which negotiates nothing
  ever sees): one request, one reply, strictly alternating;
- **pipelined**: once a peer negotiates the ``"seq"`` feature at
  ``register``, every request carries a ``_seq`` tag, many ride the wire
  at once, and a reader thread resolves each reply to its
  :class:`PendingReply`. A server speaks both: a request with ``_seq``
  gets a ``_seq``-tagged reply, one without gets the untagged reply.

The frame bytes are frozen: ``json.dumps`` with its default separators, so
replies read ``"ok": true`` with the space that the JAX package's native
pod-manager relay string-matches.
"""

from __future__ import annotations

import io
import json
import queue
import socket
import socketserver
import struct
import threading
import time

import numpy as np

from ..resilience import faults as _faults

_HDR = struct.Struct(">I")
MAX_FRAME = 1 << 30

#: reserved key tagging a request/reply pair on a pipelined connection:
#: assigned by the client, echoed by the server, never part of an op
SEQ_KEY = "_seq"
#: reserved key carrying a session-scoped request id on a connection that
#: negotiated ``"resume"``: it survives reconnects, so the proxy answers a
#: replayed request from its reply cache instead of running it twice
RID_KEY = "_rid"
#: reserved companion of ``_rid``: the highest rid whose reply the client
#: has observed, which lets the server prune its reply cache
ACK_KEY = "_ack"

#: transport features a peer may ask for at register time
FEATURES = ("resume", "seq", "preempt")

#: per-connection server credit: requests accepted off the wire and not
#: yet replied to. A client that streams faster than the handler drains
#: meets TCP backpressure instead of growing the server's memory.
SERVER_CREDIT = 8


def negotiate_features(requested, served=FEATURES) -> list:
    """The features both sides have: a peer's request ∩ ``served``."""
    return sorted(set(requested) & set(served) & set(FEATURES))


class ProtocolError(ConnectionError):
    pass


class FrameTooLarge(ValueError):
    """Raised before any bytes hit the wire — the stream stays in sync, so
    the connection must NOT be torn down for it."""


def dump_array_parts(arr) -> list:
    """numpy array → ``[npy header bytes, raw data buffer]``, sent as
    separate scatter-gather buffers so the payload is never copied."""
    arr = np.asarray(arr, order="C")
    if arr.dtype.hasobject:
        raise ValueError("object arrays cannot cross the proxy wire")
    hdr = io.BytesIO()
    np.lib.format.write_array_header_2_0(
        hdr, np.lib.format.header_data_from_array_1_0(arr))
    data = memoryview(arr).cast("B") if arr.nbytes else b""
    return [hdr.getvalue(), data]


def slice_buffers(parts, offset: int, length: int) -> list:
    """Byte range ``[offset, offset+length)`` of a stream of buffers, as
    views: the chunked transfers slice header and payload as one blob."""
    out = []
    for p in parts:
        mv = memoryview(p)
        n = mv.nbytes
        if offset >= n:
            offset -= n
            continue
        take = min(length, n - offset)
        out.append(mv[offset:offset + take])
        length -= take
        offset = 0
        if length <= 0:
            break
    return out


def buffers_nbytes(parts) -> int:
    return sum(memoryview(p).nbytes for p in parts)


def load_array(blob, writable: bool = True) -> np.ndarray:
    """.npy bytes (any byte buffer) → array, viewing the data in place.
    ``writable=True`` returns a mutable array (one copy when the source
    buffer is read-only)."""
    mv = memoryview(blob)
    fp = io.BytesIO(bytes(mv[:min(mv.nbytes, 65536)]))
    version = np.lib.format.read_magic(fp)
    read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                   else np.lib.format.read_array_header_2_0)
    shape, fortran, dtype = read_header(fp)
    if dtype.hasobject:
        raise ValueError("object arrays cannot cross the proxy wire")
    count = 1
    for d in shape:
        count *= d
    arr = np.frombuffer(blob, dtype=dtype, offset=fp.tell(), count=count)
    arr = arr.reshape(shape, order="F" if fortran else "C")
    if writable:
        return arr if arr.flags.writeable else arr.copy()
    return arr


def _recv_into(sock: socket.socket, view: memoryview) -> None:
    n = view.nbytes
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if not r:
            raise ProtocolError("peer closed mid-frame" if got
                                else "peer closed")
        got += r


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    _recv_into(sock, memoryview(buf))
    return buf


class _RecvStream:
    """Buffered receive side of a socket, for the threads that alone own
    one (the pipelined client's reader, the server's reader): one fill
    drains several small frames; a remainder of a chunk or more is
    received straight into the caller's destination."""

    CHUNK = 1 << 16

    __slots__ = ("sock", "_buf", "_pos", "_end")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._buf = bytearray(self.CHUNK)
        self._pos = 0
        self._end = 0

    def _fill(self) -> None:
        if self._pos == self._end:
            self._pos = self._end = 0
        r = self.sock.recv_into(memoryview(self._buf)[self._end:],
                                len(self._buf) - self._end)
        if not r:
            raise ProtocolError("peer closed")
        self._end += r

    def recv_into(self, view: memoryview) -> None:
        n = view.nbytes
        got = min(self._end - self._pos, n)
        if got:
            view[:got] = memoryview(self._buf)[self._pos:self._pos + got]
            self._pos += got
        while got < n:
            rem = n - got
            if rem >= self.CHUNK:
                r = self.sock.recv_into(view[got:], rem)
                if not r:
                    raise ProtocolError("peer closed mid-frame")
                got += r
                continue
            try:
                self._fill()
            except ProtocolError:
                raise ProtocolError("peer closed mid-frame" if got
                                    else "peer closed") from None
            take = min(self._end - self._pos, rem)
            view[got:got + take] = \
                memoryview(self._buf)[self._pos:self._pos + take]
            self._pos += take
            got += take

    def recv_exact(self, n: int) -> bytearray:
        buf = bytearray(n)
        self.recv_into(memoryview(buf))
        return buf


def _byte_views(parts) -> list:
    out = []
    for p in parts:
        mv = memoryview(p)
        if mv.nbytes == 0:
            continue
        if mv.ndim != 1 or mv.format != "B":
            try:
                mv = mv.cast("B")
            except (TypeError, ValueError):      # not contiguous
                mv = memoryview(bytes(mv))
        out.append(mv)
    return out


def _send_buffers(sock: socket.socket, parts) -> None:
    """Scatter-gather send of every part, looping on partial sends."""
    bufs = _byte_views(parts)
    while bufs:
        sent = sock.sendmsg(bufs)
        while sent:
            head = bufs[0]
            if head.nbytes <= sent:
                sent -= head.nbytes
                bufs.pop(0)
            else:
                bufs[0] = head[sent:]
                sent = 0


def _frame(msg: dict, blob=None) -> list:
    """Wire parts for one message: ``[header+JSON, *blob parts]``. Raises
    :class:`FrameTooLarge` before anything could hit the wire."""
    parts: list = []
    if blob is not None:
        parts = list(blob) if isinstance(blob, (list, tuple)) else [blob]
        nblob = buffers_nbytes(parts)
        if nblob > MAX_FRAME:
            raise FrameTooLarge(f"blob too large: {nblob}")
        msg = dict(msg, _blob=nblob)
    # default separators on purpose: the frame bytes are frozen
    data = json.dumps(msg).encode()
    if len(data) > MAX_FRAME:
        raise FrameTooLarge(f"frame too large: {len(data)}")
    return [_HDR.pack(len(data)) + data, *parts]


def send_msg(sock: socket.socket, msg: dict, blob=None) -> None:
    """``blob``: bytes, any buffer, or a list of buffers, each sent as it
    is after the JSON frame; lengths count bytes, never elements."""
    _send_buffers(sock, _frame(msg, blob))


def _landing(sink, blob_len: int, ok: bool):
    """The view of ``sink`` a reply's payload lands in, or None."""
    if sink is None or not ok:
        return None
    mv = memoryview(sink)
    return mv[:blob_len] if blob_len <= mv.nbytes else None


def recv_msg(sock: socket.socket, sink=None) -> tuple:
    """Receive one message. ``sink``: an optional writable buffer; when
    the message is ok and its payload fits, the payload is received
    straight into it (the blob returned is the filled view)."""
    (size,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    if size > MAX_FRAME:
        raise ProtocolError(f"frame too large: {size}")
    msg = json.loads(_recv_exact(sock, size))
    blob = None
    if "_blob" in msg:
        blob_len = int(msg.pop("_blob"))
        if not 0 <= blob_len <= MAX_FRAME:
            raise ProtocolError(f"blob too large: {blob_len}")
        dest = _landing(sink, blob_len, msg.get("ok", True))
        if dest is not None:
            _recv_into(sock, dest)
            blob = dest
        else:
            blob = _recv_exact(sock, blob_len)
    return msg, blob


class PendingReply:
    """The reply slot of one request on a pipelined connection, resolved
    by the connection's reader thread. A connection's replies share one
    condition variable."""

    __slots__ = ("sink", "_cond", "_done", "_msg", "_blob", "_err")

    def __init__(self, sink=None, cond: threading.Condition | None = None):
        self.sink = sink
        self._cond = cond if cond is not None else threading.Condition()
        self._done = False
        self._msg = None
        self._blob = None
        self._err: Exception | None = None

    def _resolve(self, msg: dict, blob) -> None:
        with self._cond:
            self._msg = msg
            self._blob = blob
            self._done = True
            self._cond.notify_all()

    def _fail(self, err: Exception) -> None:
        with self._cond:
            self._err = err
            self._done = True
            self._cond.notify_all()

    def done(self) -> bool:
        return self._done

    def wait(self, timeout: float | None = None) -> bool:
        if self._done:
            return True
        with self._cond:
            return self._cond.wait_for(lambda: self._done, timeout)

    def result(self, timeout: float | None = None) -> tuple:
        """Block for the reply, as :meth:`Connection.call` does: the
        transport error if the connection died, RuntimeError with the
        peer's message if it replied ``ok: false``."""
        if not self.wait(timeout):
            raise TimeoutError("no reply within timeout")
        if self._err is not None:
            raise self._err
        if not self._msg.get("ok", False):
            raise RuntimeError(self._msg.get("error", "remote error"))
        return self._msg, self._blob


class Connection:
    """Client side of a request/reply channel.

    Lockstep until :meth:`start_pipeline` (call it only once the peer
    granted ``"seq"``): from then on :meth:`submit` tags each request with
    a fresh ``_seq`` and returns its :class:`PendingReply`, and a reader
    thread resolves replies as they arrive. One dead connection fails
    every pending reply."""

    #: deferred submits go out by themselves once this many are corked
    CORK_FRAMES = 16

    def __init__(self, host: str, port: int, timeout: float | None = None,
                 fault_tag: str = ""):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        #: what the fault injector's connection kill matches
        #: (:mod:`..resilience.faults`); inert without an injector
        self.fault_tag = fault_tag
        self._lock = threading.Lock()        # the wire's write side
        self._plock = threading.Lock()       # pending table and liveness
        self._cond = threading.Condition()   # shared by the replies
        self._pending: dict[int, PendingReply] = {}
        self._outbox: list = []              # corked frames (under _lock)
        self._ncorked = 0
        self._next_seq = 0
        self._reader: threading.Thread | None = None
        self._broken: Exception | None = None

    @property
    def pipelined(self) -> bool:
        return self._reader is not None

    def start_pipeline(self) -> None:
        """Switch to multiplexed mode (the peer negotiated ``"seq"``)."""
        if self._reader is not None:
            return
        # the reader idles between replies: a dial timeout left on the
        # socket would kill a healthy idle connection
        self.sock.settimeout(None)
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name="conn-reader")
        self._reader.start()

    def submit(self, msg: dict, blob=None, sink=None,
               defer: bool = False) -> PendingReply:
        """Send one request on a pipelined connection; returns its reply
        slot. ``sink``: a writable buffer the reply's payload lands in.
        ``defer=True`` corks the frame: it goes out with its neighbours on
        the next undeferred submit, :meth:`flush`, or after
        ``CORK_FRAMES``; flush before waiting on a corked request."""
        if self._reader is None:
            raise RuntimeError("connection is not pipelined "
                               "(peer did not negotiate 'seq')")
        rep = PendingReply(sink, cond=self._cond)
        with self._plock:
            if self._broken is not None:
                raise ProtocolError(f"connection broken: {self._broken}")
            self._next_seq += 1
            seq = self._next_seq
            self._pending[seq] = rep
        try:
            parts = _frame({**msg, SEQ_KEY: seq}, blob)
            with self._lock:
                # every frame passes the outbox, so corked requests keep
                # their submission order on the wire
                self._outbox.extend(parts)
                self._ncorked += 1
                if not defer or self._ncorked >= self.CORK_FRAMES:
                    bufs, self._outbox = self._outbox, []
                    self._ncorked = 0
                    _send_buffers(self.sock, bufs)
        except FrameTooLarge:
            with self._plock:            # nothing hit the wire
                self._pending.pop(seq, None)
            raise
        except OSError as e:
            self._break(e)
            raise
        self._maybe_kill_after_send()
        return rep

    def _maybe_kill_after_send(self, nframes: int = 1) -> None:
        """Fault-injection hook, after a request's bytes left: the peer
        may or may not have handled it, which is the case replay exists
        for. Nothing without an injector."""
        inj = _faults.active()
        if inj is None:
            return
        if inj.should_kill_connection(self.fault_tag, nframes):
            if self._reader is not None:
                self._break(ProtocolError("fault injection: connection "
                                          "killed"))
            else:
                try:
                    self.sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

    def flush(self) -> None:
        """Send every corked frame."""
        try:
            with self._lock:
                if not self._outbox:
                    return
                bufs, self._outbox = self._outbox, []
                self._ncorked = 0
                _send_buffers(self.sock, bufs)
        except OSError as e:
            self._break(e)
            raise

    def call(self, msg: dict, blob=None, sink=None) -> tuple:
        """Send one request and wait for its reply; raises RuntimeError
        with the peer's message when it replies ``ok: false``."""
        if self._reader is not None:
            return self.submit(msg, blob, sink=sink).result()
        with self._lock:
            try:
                send_msg(self.sock, msg, blob)
                self._maybe_kill_after_send()
                reply, rblob = recv_msg(self.sock, sink=sink)
            except OSError:
                # a failure mid-exchange leaves the stream desynced
                self.close()
                raise
        if not reply.get("ok", False):
            raise RuntimeError(reply.get("error", "remote error"))
        return reply, rblob

    def _read_loop(self) -> None:
        stream = _RecvStream(self.sock)
        try:
            while True:
                (size,) = _HDR.unpack(stream.recv_exact(_HDR.size))
                if size > MAX_FRAME:
                    raise ProtocolError(f"frame too large: {size}")
                msg = json.loads(stream.recv_exact(size))
                seq = msg.pop(SEQ_KEY, None)
                with self._plock:
                    rep = self._pending.pop(seq, None)
                if rep is None:
                    raise ProtocolError(f"reply for unknown seq {seq!r}")
                blob = None
                if "_blob" in msg:
                    blob_len = int(msg.pop("_blob"))
                    if not 0 <= blob_len <= MAX_FRAME:
                        raise ProtocolError(f"blob too large: {blob_len}")
                    dest = _landing(rep.sink, blob_len,
                                    msg.get("ok", False))
                    if dest is not None:
                        stream.recv_into(dest)
                        blob = dest
                    else:
                        blob = stream.recv_exact(blob_len)
                rep._resolve(msg, blob)
        except Exception as e:
            self._break(e)

    def _break(self, exc: Exception) -> None:
        """Mark the stream dead, close the socket and fail every pending
        reply, each with an exception of its own."""
        with self._plock:
            if self._broken is None:
                self._broken = exc
            pending = list(self._pending.values())
            self._pending.clear()
        try:
            # shutdown before close: the reader blocked in recv holds the
            # socket, and a bare close would neither wake it nor send FIN
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        for rep in pending:
            rep._fail(ProtocolError(f"connection broken: {exc}"))

    def close(self) -> None:
        if self._reader is not None:
            self._break(ConnectionError("connection closed"))
            return
        try:
            self.sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FramedServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


def serve_framed(host: str, port: int, handle, cleanup=None, sink=None,
                 prepare=None) -> FramedServer:
    """Start a threaded framed-JSON server.

    ``handle(request, state) -> reply`` runs per message on the
    connection's worker thread, strictly in arrival order; ``state`` is
    per connection, with the request's payload under ``state["blob"]``
    (and ``state["blob_sunk"]`` true when it landed through ``sink``), a
    reply payload taken from ``state["reply_blob"]``, and
    ``state["_disconnect"]``, which severs the connection. An exception
    becomes an ``{"ok": false, "error": ...}`` reply. ``cleanup(state)``
    runs on disconnect, after the last handler.

    Each connection is a reader (parses frames, queues requests), a worker
    (runs ``handle``) and a writer (sends replies in batches). Accepted
    and unreplied requests are bounded by ``SERVER_CREDIT``.

    ``sink(msg, state, nbytes)`` (optional) runs on the reader after a
    request's JSON is parsed and before its payload is received; a
    writable buffer of exactly ``nbytes`` it returns receives the payload
    in place. ``prepare()`` (optional) runs once the socket listens and
    before the first connection is accepted: a client that dials meanwhile
    waits in the listen backlog. The caller owns ``server.shutdown()``;
    the bound port is ``server.server_address[1]``."""

    def _recv_request(stream: _RecvStream, state: dict) -> tuple:
        (size,) = _HDR.unpack(stream.recv_exact(_HDR.size))
        if size > MAX_FRAME:
            raise ProtocolError(f"frame too large: {size}")
        msg = json.loads(stream.recv_exact(size))
        seq = msg.pop(SEQ_KEY, None)
        blob = None
        sunk = False
        if "_blob" in msg:
            blob_len = int(msg.pop("_blob"))
            if not 0 <= blob_len <= MAX_FRAME:
                raise ProtocolError(f"blob too large: {blob_len}")
            dest = None
            if sink is not None and blob_len:
                try:
                    dest = sink(msg, state, blob_len)
                except Exception:
                    dest = None
            if dest is not None and memoryview(dest).nbytes == blob_len:
                mv = memoryview(dest)
                stream.recv_into(mv)
                blob = mv
                sunk = True
            else:
                blob = stream.recv_exact(blob_len)
        return seq, msg, blob, sunk

    class Handler(socketserver.BaseRequestHandler):
        def handle(self):
            sock = self.request
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            state: dict = {}
            with self.server._conn_mu:
                self.server._conn_socks.add(sock)

            def _disconnect():
                # a server-side kick (migration, a resume taking over, a
                # crash) runs the same path as the peer dying
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

            state["_disconnect"] = _disconnect
            requests: queue.SimpleQueue = queue.SimpleQueue()
            replies: queue.SimpleQueue = queue.SimpleQueue()
            credit = threading.Semaphore(SERVER_CREDIT)

            def run_worker():
                # replies go to the writer in batches, flushed whenever
                # the request queue runs empty (a lone request waits for
                # nothing)
                out: list = []
                while True:
                    item = requests.get()
                    if item is None:
                        if out:
                            replies.put(out)
                        replies.put(None)
                        return
                    seq, msg, blob, sunk = item
                    state["blob"] = blob
                    state["blob_sunk"] = sunk
                    state.pop("reply_blob", None)
                    try:
                        reply = handle(msg, state)
                    except Exception as e:  # surfaced to the caller
                        reply = {"ok": False,
                                 "error": f"{type(e).__name__}: {e}"}
                    if seq is not None:
                        reply = {**reply, SEQ_KEY: seq}
                    out.append((reply, state.get("reply_blob")))
                    if requests.empty() or len(out) >= SERVER_CREDIT:
                        replies.put(out)
                        out = []

            def run_writer():
                dead = False
                stop = False
                while not stop:
                    batch: list = []
                    item = replies.get()
                    while True:
                        if item is None:
                            stop = True
                            break
                        batch.extend(item)
                        try:
                            item = replies.get_nowait()
                        except queue.Empty:
                            break
                    if not batch:
                        continue
                    inj = _faults.active()
                    if inj is not None:
                        delay = inj.writer_delay_s()
                        if delay:
                            time.sleep(delay)
                    parts: list = []
                    for reply, rblob in batch:
                        if dead:
                            continue
                        if inj is not None and inj.should_drop_reply(
                                reply.get(SEQ_KEY)):
                            continue      # a lost reply: it WAS handled
                        try:
                            parts.extend(_frame(reply, rblob))
                        except FrameTooLarge as e:
                            # refused before the send: report it, the
                            # stream is in sync
                            err = {"ok": False,
                                   "error": f"FrameTooLarge: {e}"}
                            if SEQ_KEY in reply:
                                err[SEQ_KEY] = reply[SEQ_KEY]
                            parts.extend(_frame(err))
                    if parts and not dead:
                        try:
                            _send_buffers(sock, parts)
                        except OSError:
                            dead = True
                    credit.release(len(batch))

            worker = threading.Thread(target=run_worker, daemon=True,
                                      name="framed-worker")
            writer = threading.Thread(target=run_writer, daemon=True,
                                      name="framed-writer")
            worker.start()
            writer.start()
            stream = _RecvStream(sock)
            try:
                while True:
                    credit.acquire()
                    try:
                        item = _recv_request(stream, state)
                    except (ProtocolError, OSError, ValueError):
                        break
                    requests.put(item)
            finally:
                # the worker finishes every accepted request, the writer
                # flushes, then cleanup: strictly after the last handler
                requests.put(None)
                worker.join()
                writer.join()
                with self.server._conn_mu:
                    self.server._conn_socks.discard(sock)
                if cleanup is not None:
                    cleanup(state)

    server = FramedServer((host, port), Handler)
    # live connection sockets, for a crash that severs them all at once
    server._conn_mu = threading.Lock()
    server._conn_socks = set()
    if prepare is not None:
        try:
            prepare()
        except BaseException:
            server.server_close()
            raise
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name=f"framed-server-{server.server_address[1]}")
    thread.start()
    return server
