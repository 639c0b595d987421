"""Framed-JSON socket protocol of the isolation runtime (lockstep).

A copy of ``kubeshare_tpu/isolation/protocol.py``'s wire without its
metrics and fault-injection hooks and without the pipelined transport:
every message is a 4-byte big-endian length followed by a UTF-8 JSON
object, and a binary payload (an array crossing the proxy boundary) rides
as raw bytes after the JSON, announced by ``_blob`` (its byte length). One
request, one reply, strictly alternating.

The frame bytes are frozen: ``json.dumps`` with its default separators, so
replies read ``"ok": true`` with the space that the native pod-manager
relay string-matches.
"""

from __future__ import annotations

import io
import json
import socket
import socketserver
import struct
import threading

import numpy as np

_HDR = struct.Struct(">I")
MAX_FRAME = 1 << 30


class ProtocolError(ConnectionError):
    pass


class FrameTooLarge(ValueError):
    """Raised before any bytes hit the wire — the stream stays in sync."""


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


def _send_buffers(sock: socket.socket, parts) -> None:
    """Scatter-gather send of every part, looping on partial sends."""
    bufs = []
    for p in parts:
        mv = memoryview(p)
        if mv.nbytes:
            bufs.append(mv.cast("B") if mv.format != "B" or mv.ndim != 1
                        else mv)
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
    """Wire parts for one message: ``[header+JSON, *blob parts]``."""
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
    _send_buffers(sock, _frame(msg, blob))


def recv_msg(sock: socket.socket) -> tuple[dict, bytearray | None]:
    (size,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    if size > MAX_FRAME:
        raise ProtocolError(f"frame too large: {size}")
    msg = json.loads(_recv_exact(sock, size))
    blob = None
    if "_blob" in msg:
        blob_len = int(msg.pop("_blob"))
        if not 0 <= blob_len <= MAX_FRAME:
            raise ProtocolError(f"blob too large: {blob_len}")
        blob = _recv_exact(sock, blob_len)
    return msg, blob


class Connection:
    """Client side of a lockstep request/reply channel."""

    def __init__(self, host: str, port: int, timeout: float | None = None):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()

    def call(self, msg: dict, blob=None) -> tuple[dict, bytearray | None]:
        """Send one request and wait for its reply; raises RuntimeError
        with the peer's message when it replies ``ok: false``."""
        with self._lock:
            try:
                send_msg(self.sock, msg, blob)
                reply, rblob = recv_msg(self.sock)
            except OSError:
                # a failure mid-exchange leaves the stream desynced
                self.close()
                raise
        if not reply.get("ok", False):
            raise RuntimeError(reply.get("error", "remote error"))
        return reply, rblob

    def close(self) -> None:
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


def serve_framed(host: str, port: int, handle, cleanup=None) -> FramedServer:
    """Start a threaded framed-JSON server.

    ``handle(request, state) -> reply`` runs per message on the
    connection's thread, in arrival order; ``state`` is per connection,
    with the request's payload under ``state["blob"]`` and a reply payload
    taken from ``state["reply_blob"]``. An exception becomes an
    ``{"ok": false, "error": ...}`` reply. ``cleanup(state)`` runs on
    disconnect. The caller owns ``server.shutdown()``; the bound port is
    ``server.server_address[1]``."""

    class Handler(socketserver.BaseRequestHandler):
        def handle(self):
            sock = self.request
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            state: dict = {}
            try:
                while True:
                    try:
                        msg, blob = recv_msg(sock)
                    except (ProtocolError, OSError, ValueError):
                        return
                    state["blob"] = blob
                    state.pop("reply_blob", None)
                    try:
                        reply = handle(msg, state)
                    except Exception as e:  # surfaced to the caller
                        reply = {"ok": False,
                                 "error": f"{type(e).__name__}: {e}"}
                    try:
                        parts = _frame(reply, state.get("reply_blob"))
                    except FrameTooLarge as e:
                        parts = _frame({"ok": False,
                                        "error": f"FrameTooLarge: {e}"})
                    try:
                        _send_buffers(sock, parts)
                    except OSError:
                        return
            finally:
                if cleanup is not None:
                    cleanup(state)

    server = FramedServer((host, port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name=f"framed-server-{server.server_address[1]}")
    thread.start()
    return server
