"""The port's wire (``kubeshare_tpu_torch/isolation/protocol.py``): the
framing cases of ``tests/test_protocol_edge.py``, the pipelined
connection, feature negotiation, and each package's ``Connection``
against the other's ``serve_framed`` in both modes — the wire is the JAX
package's wire, byte for byte."""

import json
import socket
import struct
import threading

import numpy as np
import pytest

from kubeshare_tpu.isolation import protocol as jprotocol
from kubeshare_tpu_torch.isolation import protocol
from kubeshare_tpu_torch.resilience import faults


@pytest.fixture(autouse=True)
def _clear_faults():
    yield
    faults.uninstall()


def _pair():
    return socket.socketpair()


# --- framing -----------------------------------------------------------------

def test_blob_at_exact_max_frame_boundary(monkeypatch):
    monkeypatch.setattr(protocol, "MAX_FRAME", 4096)
    a, b = _pair()
    try:
        payload = b"x" * 4096          # exactly MAX_FRAME: allowed
        protocol.send_msg(a, {"op": "edge"}, blob=payload)
        msg, blob = protocol.recv_msg(b)
        assert msg["op"] == "edge" and bytes(blob) == payload
        with pytest.raises(protocol.FrameTooLarge):
            protocol.send_msg(a, {"op": "edge"}, blob=b"x" * 4097)
        # the refused send wrote nothing: the stream is still in sync
        protocol.send_msg(a, {"op": "after"})
        msg, blob = protocol.recv_msg(b)
        assert msg["op"] == "after" and blob is None
    finally:
        a.close()
        b.close()


def test_oversized_json_is_refused_before_the_send(monkeypatch):
    monkeypatch.setattr(protocol, "MAX_FRAME", 256)
    a, b = _pair()
    try:
        with pytest.raises(protocol.FrameTooLarge):
            protocol.send_msg(a, {"op": "x", "pad": "y" * 1024})
        protocol.send_msg(a, {"op": "fits"})
        assert protocol.recv_msg(b)[0]["op"] == "fits"
    finally:
        a.close()
        b.close()


def test_zero_byte_blob_roundtrips():
    a, b = _pair()
    try:
        protocol.send_msg(a, {"op": "empty"}, blob=b"")
        msg, blob = protocol.recv_msg(b)
        # an announced empty payload is an empty buffer, not "no payload"
        assert blob is not None and len(blob) == 0 and "_blob" not in msg
    finally:
        a.close()
        b.close()


def test_non_byte_memoryview_parts_count_bytes():
    """Framing counts bytes, not elements: an int32 view framed by its
    length would desync the stream."""
    a, b = _pair()
    try:
        arr = np.arange(32, dtype=np.int32)
        protocol.send_msg(a, {"op": "wide"}, blob=[memoryview(arr), b"tail"])
        _, blob = protocol.recv_msg(b)
        assert bytes(blob) == arr.tobytes() + b"tail"
        protocol.send_msg(a, {"op": "next"})
        assert protocol.recv_msg(b)[0]["op"] == "next"
    finally:
        a.close()
        b.close()


def test_truncated_frame_mid_blob_raises_protocol_error():
    a, b = _pair()
    try:
        body = json.dumps({"op": "x", "_blob": 100}).encode()
        a.sendall(struct.pack(">I", len(body)) + body + b"z" * 40)
        a.close()
        with pytest.raises(protocol.ProtocolError):
            protocol.recv_msg(b)
    finally:
        b.close()


def test_garbage_length_header_raises_protocol_error():
    a, b = _pair()
    try:
        a.sendall(b"\xff\xff\xff\xff" + b"junk")
        with pytest.raises(protocol.ProtocolError):
            protocol.recv_msg(b)
    finally:
        a.close()
        b.close()


def test_recv_into_sink_lands_payload_in_place():
    a, b = _pair()
    try:
        payload = bytes(range(64))
        dest = bytearray(64)
        protocol.send_msg(a, {"op": "s"}, blob=payload)
        _, blob = protocol.recv_msg(b, sink=memoryview(dest))
        assert isinstance(blob, memoryview) and blob.obj is dest
        assert bytes(dest) == payload
    finally:
        a.close()
        b.close()


def test_slice_buffers_spans_parts():
    parts = [b"abc", memoryview(b"defgh"), b"ij"]
    for off, n in ((0, 10), (2, 4), (3, 5), (7, 3), (9, 5)):
        got = b"".join(bytes(p) for p in protocol.slice_buffers(parts, off,
                                                               n))
        assert got == b"abcdefghij"[off:off + n]
        assert got == b"".join(bytes(p) for p in
                               jprotocol.slice_buffers(parts, off, n))


@pytest.mark.parametrize("requested, served, granted", [
    (["seq", "frobnicate"], protocol.FEATURES, ["seq"]),
    ([], protocol.FEATURES, []),
    (("seq",), protocol.FEATURES, ["seq"]),
    (["resume", "seq", "preempt"], ("resume", "seq"), ["resume", "seq"]),
    (["preempt"], ("resume", "seq"), [])])
def test_negotiate_features_intersects(requested, served, granted):
    assert protocol.negotiate_features(requested, served) == granted
    assert protocol.FEATURES == jprotocol.FEATURES
    if served == protocol.FEATURES:
        assert jprotocol.negotiate_features(requested) == granted


# --- the server --------------------------------------------------------------

def _echo(req, state):
    if req.get("op") == "echo":
        state["reply_blob"] = state.get("blob")
        return {"ok": True}
    if req.get("op") == "bigreply":
        state["reply_blob"] = b"x" * int(req["n"])
        return {"ok": True}
    if req.get("op") == "fail":
        raise KeyError("nope")
    return {"ok": True, "op": req.get("op")}


SERVERS = {"port": protocol.serve_framed, "jax": jprotocol.serve_framed}
CLIENTS = {"port": protocol.Connection, "jax": jprotocol.Connection}


@pytest.fixture
def echo_server():
    cleaned = threading.Event()
    server = protocol.serve_framed("127.0.0.1", 0, _echo,
                                   cleanup=lambda s: cleaned.set())
    yield server.server_address[1], cleaned
    server.shutdown()
    server.server_close()


def test_server_garbage_header_tears_down_connection(echo_server):
    port, cleaned = echo_server
    s = socket.create_connection(("127.0.0.1", port))
    try:
        s.sendall(b"\xff\xff\xff\xff")
        assert s.recv(1) == b""
        assert cleaned.wait(5.0)
    finally:
        s.close()


def test_server_oversized_reply_is_error_not_teardown(echo_server,
                                                      monkeypatch):
    monkeypatch.setattr(protocol, "MAX_FRAME", 1 << 16)
    port, _ = echo_server
    with protocol.Connection("127.0.0.1", port) as conn:
        with pytest.raises(RuntimeError, match="FrameTooLarge"):
            conn.call({"op": "bigreply", "n": (1 << 16) + 1})
        _, blob = conn.call({"op": "echo"}, blob=b"still alive")
        assert bytes(blob) == b"still alive"


def test_pipelined_connection_multiplexes(echo_server):
    port, _ = echo_server
    conn = protocol.Connection("127.0.0.1", port)
    conn.start_pipeline()
    try:
        # more in flight than the server's credit: backpressure, not a
        # deadlock
        reps = [conn.submit({"op": "echo", "i": i}, blob=str(i).encode())
                for i in range(3 * protocol.SERVER_CREDIT)]
        for i, rep in enumerate(reps):
            msg, blob = rep.result(timeout=30)
            assert msg["ok"] and bytes(blob) == str(i).encode()
        # corked requests go out on the flush, in order
        corked = [conn.submit({"op": "c", "i": i}, defer=True)
                  for i in range(3)]
        conn.flush()
        assert [r.result(timeout=30)[0]["op"] for r in corked] == ["c"] * 3
    finally:
        conn.close()


def test_pipelined_connection_fails_all_pending_on_death():
    """A dead connection fails every reply still pending, each with its
    own error, and refuses new requests."""
    release = threading.Event()

    def slow(req, state):
        release.wait(10)
        return {"ok": True}

    drained = threading.Event()
    server = protocol.serve_framed("127.0.0.1", 0, slow,
                                   cleanup=lambda state: drained.set())
    conn = protocol.Connection("127.0.0.1", server.server_address[1])
    conn.start_pipeline()
    try:
        reps = [conn.submit({"op": "wait"}) for _ in range(4)]
        conn.close()
        errors = []
        for rep in reps:
            with pytest.raises(protocol.ProtocolError) as e:
                rep.result(timeout=5)
            errors.append(e.value)
        assert len({id(e) for e in errors}) == 4
        with pytest.raises(protocol.ProtocolError):
            conn.submit({"op": "after"})
    finally:
        release.set()
        # the handler still answers the four requests once released, and
        # its writer consults the process-wide fault injector: it must be
        # done before a later test installs one (a drop of seq 2 would
        # go to this dead connection's reply)
        drained.wait(10)
        server.shutdown()
        server.server_close()
    assert drained.is_set()


def test_submit_needs_a_pipelined_connection(echo_server):
    port, _ = echo_server
    with protocol.Connection("127.0.0.1", port) as conn:
        with pytest.raises(RuntimeError, match="not pipelined"):
            conn.submit({"op": "x"})


def test_a_dropped_reply_and_a_killed_connection_are_injected(echo_server):
    """The fault hooks: the writer drops the reply of one seq (the request
    was handled), and a connection dies right after a frame is sent."""
    port, _ = echo_server
    conn = protocol.Connection("127.0.0.1", port, fault_tag="victim")
    conn.start_pipeline()
    try:
        faults.install(faults.Injector(faults.FaultSpec(drop_reply_seq=2)))
        first = conn.submit({"op": "a"})
        lost = conn.submit({"op": "b"})
        third = conn.submit({"op": "c"})
        assert first.result(timeout=5)[0]["op"] == "a"
        assert third.result(timeout=5)[0]["op"] == "c"
        assert not lost.wait(0.2)
        faults.install(faults.Injector(faults.FaultSpec(
            kill_conn_after_frames=1, kill_conn_tag="victim")))
        with pytest.raises(protocol.ProtocolError):
            conn.submit({"op": "d"}).result(timeout=5)
        with pytest.raises(protocol.ProtocolError):
            lost.result(timeout=5)       # failed with the connection
    finally:
        conn.close()


def test_an_injected_kill_fails_its_request_even_when_its_reply_wins(
        echo_server, monkeypatch):
    """The killed request's reply fails even when the peer's reply reaches
    the reader before the kill runs: the injector decides before the
    bytes leave, and the request leaves the pending table first (a
    divergence on purpose: the JAX connection decides after the send, so
    its reader may answer the request, and the fault did not happen)."""
    port, _ = echo_server
    conn = protocol.Connection("127.0.0.1", port, fault_tag="victim")
    conn.start_pipeline()
    read = threading.Event()

    class Pending(dict):
        def pop(self, *args):
            if threading.current_thread() is conn._reader:
                read.set()            # the reader took a reply's slot
            return super().pop(*args)

    send = protocol._send_buffers

    def send_then_let_the_reply_in(sock, bufs):
        send(sock, bufs)
        assert read.wait(5)

    try:
        assert conn.submit({"op": "warm"}).result(timeout=5)[0]["op"] == "warm"
        with conn._plock:
            conn._pending = Pending(conn._pending)
        monkeypatch.setattr(protocol, "_send_buffers",
                            send_then_let_the_reply_in)
        faults.install(faults.Injector(faults.FaultSpec(
            kill_conn_after_frames=1, kill_conn_tag="victim")))
        rep = conn.submit({"op": "d"})
        with pytest.raises(protocol.ProtocolError, match="fault injection"):
            rep.result(timeout=5)
    finally:
        conn.close()


# --- across the packages -----------------------------------------------------

@pytest.mark.parametrize("client, server", [("jax", "port"), ("port", "jax"),
                                            ("port", "port")])
@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["lockstep", "pipelined"])
def test_each_connection_talks_to_each_server(client, server, pipelined):
    srv = SERVERS[server]("127.0.0.1", 0, _echo)
    conn = CLIENTS[client]("127.0.0.1", srv.server_address[1])
    try:
        if pipelined:
            conn.start_pipeline()
            reps = [conn.submit({"op": "echo", "i": i},
                                blob=protocol.dump_array_parts(
                                    np.full(i + 1, i, np.float32)))
                    for i in range(2 * protocol.SERVER_CREDIT)]
            for i, rep in enumerate(reps):
                _, blob = rep.result(timeout=30)
                np.testing.assert_array_equal(protocol.load_array(blob),
                                              np.full(i + 1, i))
        for i in range(3):
            reply, blob = conn.call({"op": "echo"},
                                    blob=protocol.dump_array_parts(
                                        np.arange(i + 4, dtype=np.int64)))
            np.testing.assert_array_equal(jprotocol.load_array(blob),
                                          np.arange(i + 4))
        assert conn.call({"op": "hello"})[0] == {"ok": True, "op": "hello"}
        with pytest.raises(RuntimeError, match="KeyError"):
            conn.call({"op": "fail"})
        assert conn.call({"op": "still"})[0]["op"] == "still"
    finally:
        conn.close()
        srv.shutdown()
        srv.server_close()


def _raw_replies(serve, frames: bytes, n: int) -> bytes:
    """The bytes a server sends back for ``frames``, up to ``n`` replies."""
    srv = serve("127.0.0.1", 0, _echo)
    s = socket.create_connection(("127.0.0.1", srv.server_address[1]))
    try:
        s.sendall(frames)
        out = b""
        for _ in range(n):
            (size,) = struct.unpack(">I", _exact(s, 4))
            body = _exact(s, size)
            out += struct.pack(">I", size) + body
            blob = json.loads(body).get("_blob")
            if blob:
                out += _exact(s, blob)
        return out
    finally:
        s.close()
        srv.shutdown()
        srv.server_close()


def _exact(s, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        assert chunk, "server closed early"
        buf += chunk
    return buf


@pytest.mark.parametrize("tagged", [False, True], ids=["lockstep", "seq"])
def test_replies_are_byte_identical_to_the_jax_server(tagged):
    """A lockstep peer gets the reply bytes it always got (``"ok": true``
    with its space), and a tagged one the JAX server's tagged bytes."""
    msgs = [({"op": "hello"}, None), ({"op": "echo"}, b"\x00payload\xff"),
            ({"op": "fail"}, None), ({"op": "x", "n": [1, 2.5]}, None)]
    frames = b"".join(
        b"".join(bytes(p) for p in protocol._frame(
            {**m, **({protocol.SEQ_KEY: i + 1} if tagged else {})}, b))
        for i, (m, b) in enumerate(msgs))
    port = _raw_replies(protocol.serve_framed, frames, len(msgs))
    ref = _raw_replies(jprotocol.serve_framed, frames, len(msgs))
    assert port == ref
    assert b'"ok": true' in port


# --- the proxy's staged uploads across a dropped connection ------------------

def test_put_abort_races_connection_drop():
    """A client that drops mid-upload and aborts the staged put after
    resuming finds the abort idempotent: the disconnect invalidated the
    staging (releasing its reservation), so neither the abort nor its
    replay releases twice, and a replayed chunk of the dead upload is
    refused with the restart-upload error."""
    from kubeshare_tpu_torch.isolation.proxy import ChipProxy
    from kubeshare_tpu_torch.isolation.tokensched import TokenScheduler

    p = ChipProxy(device="cpu", scheduler=TokenScheduler(1000.0, 100.0,
                                                         10.0))
    p.serve()
    R, A = protocol.RID_KEY, protocol.ACK_KEY
    try:
        conn = protocol.Connection("127.0.0.1", p.port)
        rep, _ = conn.call({"op": "register", "name": "abrt",
                            "request": 0.5, "limit": 1.0, "memory": 0,
                            "features": ["resume"]})
        token = rep["resume"]
        sid = conn.call({"op": "put_begin", "nbytes": 1 << 16,
                         R: 1})[0]["staging"]
        conn.call({"op": "put_chunk", "staging": sid, "offset": 0, R: 2},
                  blob=b"z" * 1024)
        conn.sock.close()

        c2 = protocol.Connection("127.0.0.1", p.port)
        try:
            rep, _ = c2.call({"op": "register", "resume": token})
            assert rep.get("resumed") and rep["last_rid"] == 2
            with pytest.raises(RuntimeError,
                               match="invalidated by disconnect"):
                c2.call({"op": "put_chunk", "staging": sid, "offset": 1024,
                         R: 3}, blob=b"z" * 16)
            assert c2.call({"op": "put_abort", "staging": sid,
                            R: 4})[0]["ok"]
            assert c2.call({"op": "usage", R: 5})[0]["hbm_used"] == 0
            # ack the abort's cached reply away, then replay it: it runs
            # again (idempotent), releasing nothing twice
            assert c2.call({"op": "usage", R: 6, A: 5})[0]["hbm_used"] == 0
            assert c2.call({"op": "put_abort", "staging": sid,
                            R: 4})[0]["ok"]
            assert c2.call({"op": "usage", R: 7})[0]["hbm_used"] == 0
            c2.call({"op": "unregister", R: 8})
        finally:
            c2.close()
    finally:
        p.close()


@pytest.mark.parametrize("arr", [
    np.float32(1.5), np.zeros((0, 3), np.float32),
    np.arange(12, dtype=np.int64).reshape(3, 4),
    np.asfortranarray(np.arange(6, dtype=np.float64).reshape(2, 3)),
    np.arange(10, dtype=np.int16)[::2], np.array([True, False])],
    ids=["scalar", "empty", "int64", "fortran", "strided", "bool"])
def test_dump_array_is_the_jax_bytes(arr):
    """``dump_array`` joins ``dump_array_parts``: the JAX package's .npy
    bytes, 0-d kept 0-d, and it loads back to the same array."""
    blob = protocol.dump_array(arr)
    assert isinstance(blob, bytes)
    assert blob == jprotocol.dump_array(arr)
    assert blob == b"".join(bytes(p) for p in protocol.dump_array_parts(arr))
    back = protocol.load_array(blob)
    assert back.shape == np.shape(arr) and back.dtype == np.asarray(arr).dtype
    np.testing.assert_array_equal(back, arr)
    with pytest.raises(ValueError, match="object arrays"):
        protocol.dump_array(np.array([object()]))
