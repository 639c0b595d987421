"""The port's token server and pod managers, against the JAX package's.

Mirrors ``tests/test_native_podmgr.py``'s cases of the Python manager,
run for the port's ``PodManager`` and the JAX package's against the
port's server. Adds the parity cases: the port's ``serve`` answers a
scripted op sequence as ``kubeshare_tpu.isolation.tokensched.serve``
does, and the wire is one wire — either package's gate and managers drive
either package's server.
"""

import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from kubeshare_tpu.isolation import tokensched as jts
from kubeshare_tpu.isolation.podmgr import PodManager as JaxPodManager
from kubeshare_tpu_torch.isolation import protocol
from kubeshare_tpu_torch.isolation.client import ExecutionGate
from kubeshare_tpu_torch.isolation.podmgr import PodManager
from kubeshare_tpu_torch.isolation.tokensched import TokenScheduler, serve
from kubeshare_tpu_torch.resilience.reconnect import (ReconnectPolicy,
                                                      SessionLost)

REPO = Path(__file__).resolve().parent.parent
WINDOW, BASE, MIN = 2000.0, 100.0, 10.0


def _server(pkg="port", window=WINDOW, base=BASE, minq=MIN, native=False):
    """(scheduler, framed server, port) of either package."""
    if pkg == "port":
        sched = TokenScheduler(window, base, minq)
        srv = serve(sched)
    else:
        sched = jts.TokenScheduler(window, base, minq, native=native)
        srv = jts.serve(sched)
    return sched, srv, srv.server_address[1]


def _stop(sched, srv):
    srv.shutdown()
    srv.server_close()
    sched.close()


def _wait(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def _call(conn, msg):
    """A reply, or the peer's error text."""
    try:
        return conn.call(msg)[0]
    except RuntimeError as e:
        return {"error": str(e)}


# --- parity (a): the token server --------------------------------------------

def _scripted_session(port, sched_count) -> list:
    """One fixed op sequence over four connections; returns every reply.
    ``sched_count()`` reads the server's client count."""
    conns = {k: protocol.Connection("127.0.0.1", port)
             for k in ("A", "B", "A2", "X")}
    script = [
        ("X", {"op": "acquire"}),
        ("A", {"op": "register", "name": "a", "request": 0.5, "limit": 1.0}),
        ("A", {"op": "register", "name": "z", "request": 0.5, "limit": 1.0}),
        ("B", {"op": "register", "name": "a", "request": 0.5, "limit": 1.0}),
        ("B", {"op": "register", "name": "b", "request": 0.6, "limit": 0.5}),
        ("B", {"op": "register", "name": "b", "request": 0.3, "limit": 0.5,
               "class": "latency"}),
        ("X", {"op": "attach", "name": "nobody"}),
        ("A2", {"op": "attach", "name": "a"}),
        ("A", {"op": "acquire"}),
        ("B", {"op": "acquire", "timeout": 0.05}),     # a holds it
        ("A2", {"op": "renew", "used_ms": 120.0}),
        ("A", {"op": "release", "used_ms": 80.0}),
        ("B", {"op": "acquire"}),
        ("B", {"op": "release", "used_ms": 4800.0}),
        ("B", {"op": "release", "used_ms": 1.0}),      # not holding
        ("B", {"op": "acquire"}),                       # 200 ms left of 5000
        ("B", {"op": "release", "used_ms": 100.0}),
        ("B", {"op": "acquire", "timeout": 0.05}),     # 100 ms left
        ("B", {"op": "release", "used_ms": 100.0}),
        ("B", {"op": "acquire", "timeout": 0.05}),     # under the min quota
        ("A", {"op": "usage"}),
        ("B", {"op": "usage"}),
        ("A", {"op": "gang_register", "gang": "g", "members": []}),
        ("A", {"op": "preempt_poll"}),
        ("A", {"op": "preempt_state"}),
        ("A", {"op": "bogus"}),
        ("A2", {"op": "unregister"}),
        ("A", {"op": "usage"}),
    ]
    replies = [_call(conns[k], msg) for k, msg in script]
    conns["B"].close()                 # the owner hangs up: b is removed
    assert _wait(lambda: sched_count() == 0)
    replies.append(_call(conns["X"], {"op": "attach", "name": "b"}))
    for c in conns.values():
        c.close()
    return replies


@pytest.mark.parametrize("jax_core", ["python", "native"])
def test_serve_answers_a_scripted_session_as_jax_serve(jax_core):
    """Parity (a): the same op sequence gets the same replies from the
    JAX package's ``serve`` and the port's — every ``quota_ms`` and error
    text equal, window usage to 1 ms (both run on the wall clock; the
    usage is the sum of the reported ``used_ms``, all inside a 10 s
    window)."""
    runs = {}
    for pkg in ("jax", "port"):
        sched, srv, port = _server(pkg, 10000.0, 3000.0, 20.0,
                                   native=jax_core == "native")
        try:
            runs[pkg] = _scripted_session(port, sched.core.client_count)
        finally:
            _stop(sched, srv)
    assert len(runs["port"]) == len(runs["jax"])
    for got, want in zip(runs["port"], runs["jax"]):
        assert got.keys() == want.keys(), (got, want)
        for key, value in want.items():
            if key == "used_ms":
                assert got[key] == pytest.approx(value, abs=1.0)
            else:
                assert got[key] == value, (got, want)
    quotas = [r["quota_ms"] for r in runs["port"] if "quota_ms" in r]
    assert quotas == [3000.0, 3000.0, 3000.0, 200.0, 100.0]
    assert {r["error"].split(":")[0] for r in runs["port"]
            if "error" in r} >= {"PermissionError", "ValueError", "KeyError",
                                 "TimeoutError"}
    assert sum("unknown op" in r.get("error", "") for r in runs["port"]) == 4


# --- parity (b): one wire ------------------------------------------------------

def _manager(kind, sched_port, name):
    """(close, port) of a pod manager of ``kind``: the port's or the JAX
    package's."""
    cls = PodManager if kind == "port" else JaxPodManager
    mgr = cls("127.0.0.1", sched_port, name, request=0.5, limit=1.0)
    mgr.serve()
    return mgr.close, mgr.port


@pytest.mark.parametrize("manager,server_pkg", [
    ("port", "port"), ("jax", "port"), ("port", "jax"), ("jax", "jax")])
def test_gate_through_any_manager_to_any_server(server_pkg, manager):
    """Parity (b): the port's ExecutionGate, through a pod manager of
    either package, drives a token server of either package; the server
    charges what the gate reported."""
    sched, srv, sport = _server(server_pkg)
    close, mport = _manager(manager, sport, "ns/wire")
    try:
        assert sched.core.client_count() == 1
        gate = ExecutionGate.connect("127.0.0.1", mport, "ignored", 0.5, 1.0,
                                     barrier=lambda: None)
        for _ in range(5):
            gate()
            time.sleep(0.03)
        gate.close()
        assert sched.window_usage("ns/wire") == pytest.approx(150.0,
                                                              rel=0.5)
        assert sched.core.holder() is None
        gate._conn.close()
    finally:
        close()
        assert _wait(lambda: sched.core.client_count() == 0)
        _stop(sched, srv)


def test_port_gate_drives_jax_server_directly():
    sched, srv, port = _server("jax")
    try:
        gate = ExecutionGate.connect("127.0.0.1", port, "direct", 0.5, 1.0,
                                     barrier=lambda: None)
        gate()
        assert sched.core.holder() == "direct"
        time.sleep(0.02)
        gate.close()
        assert sched.window_usage("direct") >= 15.0
        gate._conn.close()
        assert _wait(lambda: sched.core.client_count() == 0)
    finally:
        _stop(sched, srv)


# --- the Python manager ------------------------------------------------------

def _failed_renew_then_crash(sched, srv_port, downstream_port, name):
    """A renew that times out (a competitor holds the token) must DISARM
    the crash-release path: the scheduler's renew releases the old token
    before re-requesting, so after an ok:false renew the pod holds
    nothing, and a disconnect must not charge stale quota."""
    comp = protocol.Connection("127.0.0.1", srv_port)
    comp.call({"op": "register", "name": "ns/comp", "request": 0.5,
               "limit": 1.0})
    down = protocol.Connection("127.0.0.1", downstream_port)
    reply, _ = down.call({"op": "acquire"})
    assert reply["quota_ms"] == BASE

    def competitor():
        comp.call({"op": "acquire"})       # granted when the renew releases
        time.sleep(0.5)                    # outlive the renew's timeout
        comp.call({"op": "release", "used_ms": 5.0})

    t = threading.Thread(target=competitor)
    t.start()
    time.sleep(0.1)                        # the competitor is waiting
    with pytest.raises(RuntimeError):      # re-request times out: ok:false
        down.call({"op": "renew", "used_ms": 30.0, "timeout": 0.2})
    time.sleep(0.3)   # wall time accrues: a stale crash-release would
    down.close()      # charge ~min(wall, quota) on top of the 30
    t.join(timeout=5)
    assert not t.is_alive()
    deadline = time.monotonic() + 2.0
    while time.monotonic() < deadline and sched.window_usage(name) > 80.0:
        time.sleep(0.02)
    assert sched.window_usage(name) == pytest.approx(30.0, abs=20.0)
    comp.close()


@pytest.mark.parametrize("kind", ["python", "jax"])
def test_failed_renew_disarms_crash_release(kind):
    """The port's manager, and the JAX package's against the port's
    server."""
    sched, srv, port = _server()
    name = f"ns/{kind}-rn"
    cls = PodManager if kind == "python" else JaxPodManager
    mgr = cls("127.0.0.1", port, name, request=0.5, limit=1.0)
    mport = mgr.serve().server_address[1]
    close = mgr.close
    try:
        _failed_renew_then_crash(sched, port, mport, name)
    finally:
        close()
        _stop(sched, srv)


def test_python_podmgr_redials_after_upstream_blip():
    """A transport error on the upstream scheduler connection is ridden
    out in place: re-dial, re-attach, retry the op on the fresh channel."""
    sched, srv, port = _server()
    mgr = PodManager("127.0.0.1", port, "ns/blip", request=0.5, limit=1.0)
    state: dict = {}
    try:
        assert mgr._handle({"op": "acquire"}, state)["quota_ms"] == BASE
        mgr._handle({"op": "release", "used_ms": 10}, state)
        dead = state["up"]
        dead.sock.close()                 # network blip
        assert mgr._handle({"op": "acquire"}, state)["quota_ms"] == BASE
        assert state["up"] is not dead
        assert state.get("holding")
        mgr._handle({"op": "release", "used_ms": 5}, state)
    finally:
        mgr.close()
        _stop(sched, srv)


def test_python_podmgr_renew_across_blip_releases_wall_time():
    """A blip while HOLDING: the usage report went down with the old
    channel, so the manager releases the conservative wall-time charge
    before re-acquiring, and the renew becomes a plain acquire."""
    sched, srv, port = _server()
    mgr = PodManager("127.0.0.1", port, "ns/blip-hold", request=0.5,
                     limit=1.0)
    state: dict = {}
    try:
        assert mgr._handle({"op": "acquire"}, state)["quota_ms"] == BASE
        time.sleep(0.05)
        state["up"].sock.close()          # blip mid-hold
        rep = mgr._handle({"op": "renew", "used_ms": 40.0}, state)
        assert rep["quota_ms"] == BASE
        assert state.get("holding")
        used = sched.window_usage("ns/blip-hold")
        assert 0.0 < used <= BASE        # ~wall time, not the lost 40 ms
        mgr._handle({"op": "release", "used_ms": 5}, state)
    finally:
        mgr.close()
        _stop(sched, srv)


def test_python_podmgr_scheduler_stays_down_surfaces():
    """An exhausted reconnect budget surfaces to the gate (SessionLost is
    an OSError) instead of hanging the relay forever."""
    sched, srv, port = _server()
    mgr = PodManager("127.0.0.1", port, "ns/down", request=0.5, limit=1.0)
    mgr.RECONNECT = ReconnectPolicy(max_attempts=2, base_delay_s=0.01,
                                    max_delay_s=0.02, dial_timeout_s=0.2)
    state: dict = {}
    try:
        assert mgr._handle({"op": "acquire"}, state)["quota_ms"] == BASE
        mgr._handle({"op": "release", "used_ms": 10}, state)
        _stop(sched, srv)                 # the scheduler is gone for good
        state["up"].sock.close()
        with pytest.raises(SessionLost):
            mgr._handle({"op": "acquire"}, state)
        assert not state.get("holding")
        assert isinstance(SessionLost("x"), OSError)
    finally:
        mgr._up.close()


def test_python_podmgr_refuses_unknown_ops():
    sched, srv, port = _server()
    mgr = PodManager("127.0.0.1", port, "ns/ops", request=0.5, limit=1.0)
    try:
        assert mgr._handle({"op": "register", "name": "x"}, {}) == {
            "ok": True, "name": "ns/ops"}
        assert mgr._handle({"op": "unregister"}, {})["ok"] is False
    finally:
        mgr.close()
        _stop(sched, srv)


# --- both managers as processes ----------------------------------------------

# the manager's module: the port's, as the launcher spawns it, or the JAX
# package's, against the port's server
MANAGER_MODULES = {"python": "kubeshare_tpu_torch.isolation.podmgr",
                   "jax": "kubeshare_tpu.isolation.podmgr"}


def _manager_env():
    return dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")


def _start_manager(kind, sched_port, name):
    """A pod-manager process, ``python -m <module>`` with the launcher's
    arguments."""
    proc = subprocess.Popen(
        [sys.executable, "-m", MANAGER_MODULES[kind],
         "--scheduler-ip", "127.0.0.1", "--scheduler-port", str(sched_port),
         "--port", "0", "--pod-name", name, "--request", "0.5",
         "--limit", "1.0"],
        stdout=subprocess.PIPE, text=True, cwd=str(REPO),
        env=_manager_env())
    line = proc.stdout.readline().strip()
    assert line.startswith("READY "), line
    return proc, int(line.split()[1])


@pytest.fixture(params=["python", "jax"])
def manager_kind(request):
    return request.param


def test_manager_registers_relays_unregisters(manager_kind):
    sched, srv, port = _server()
    proc, mport = _start_manager(manager_kind, port, "ns/m")
    try:
        assert sched.core.client_count() == 1
        with protocol.Connection("127.0.0.1", mport) as conn:
            reply, _ = conn.call({"op": "register", "name": "ignored"})
            assert reply["name"] == "ns/m"
            reply, _ = conn.call({"op": "acquire", "name": "x"})
            assert reply["quota_ms"] == BASE
            conn.call({"op": "release", "name": "x", "used_ms": 30.0})
            reply, _ = conn.call({"op": "usage", "name": "x"})
            assert reply["used_ms"] == pytest.approx(30.0, abs=5.0)
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=10)
        assert _wait(lambda: sched.core.client_count() == 0)  # unregistered
        _stop(sched, srv)


def test_manager_crash_releases_token(manager_kind):
    """A workload that dies holding the token has it released, charged
    at wall time up to the quota."""
    sched, srv, port = _server()
    proc, mport = _start_manager(manager_kind, port, "ns/crash")
    try:
        conn = protocol.Connection("127.0.0.1", mport)
        reply, _ = conn.call({"op": "acquire"})
        assert reply["quota_ms"] == BASE
        assert sched.core.holder() == "ns/crash"
        time.sleep(0.03)
        conn.close()                       # crash: no release
        assert _wait(lambda: sched.core.holder() is None, 2.0)
        assert 25.0 <= sched.window_usage("ns/crash") <= BASE
    finally:
        proc.terminate()
        proc.wait(timeout=10)
        _stop(sched, srv)


def test_manager_two_connections_no_deadlock(manager_kind):
    sched, srv, port = _server()
    proc, mport = _start_manager(manager_kind, port, "ns/two")
    try:
        c1 = protocol.Connection("127.0.0.1", mport)
        c2 = protocol.Connection("127.0.0.1", mport)
        c1.call({"op": "acquire"})
        reply, _ = c2.call({"op": "usage"})   # must not block behind c1
        assert reply["ok"] is True
        c1.call({"op": "release", "used_ms": 5.0})
        c1.close()
        c2.close()
    finally:
        proc.terminate()
        proc.wait(timeout=10)
        _stop(sched, srv)


def test_manager_retries_duplicate_until_old_owner_reaped():
    """The launcher's kill-then-respawn can race the scheduler reaping
    the old owner: a 'duplicate client' refusal is transient. (The port's
    manager only: this test stops the manager as soon as it is READY,
    where the JAX package's CLI can deadlock, see the next test.)"""
    sched, srv, port = _server()
    old = protocol.Connection("127.0.0.1", port)
    old.call({"op": "register", "name": "ns/respawn", "request": 0.5,
              "limit": 1.0})
    result = {}

    def start():
        result["proc"], result["port"] = _start_manager(
            "python", port, "ns/respawn")

    t = threading.Thread(target=start)
    t.start()
    try:
        time.sleep(1.0)                  # the new manager is retrying
        assert t.is_alive()
        old.close()                      # the old owner finally drops
        t.join(timeout=15)
        assert not t.is_alive()
        assert sched.core.client_count() == 1
    finally:
        if "proc" in result:
            result["proc"].terminate()
            result["proc"].wait(timeout=10)
        _stop(sched, srv)


def test_manager_stops_on_sigterm_right_after_ready():
    """A manager signalled the moment it prints READY exits cleanly and
    unregisters. Its handler raises instead of setting an Event: the JAX
    package's CLI calls ``Event.set`` from its handler, which deadlocks
    when the signal lands while the main thread holds that Event's lock
    on its way into ``Event.wait``."""
    sched, srv, port = _server()
    try:
        for i in range(8):
            proc, _ = _start_manager("python", port, f"ns/quick-{i}")
            proc.terminate()
            assert proc.wait(timeout=10) == 0
            assert _wait(lambda: sched.core.client_count() == 0)
    finally:
        _stop(sched, srv)


def test_manager_without_scheduler_exits_nonzero(manager_kind):
    """A pod manager that cannot reach its scheduler exits non-zero (and
    the gate behind it can never attach)."""
    cmd = [sys.executable, "-m", MANAGER_MODULES[manager_kind]]
    env = dict(_manager_env(), SCHEDULER_PORT="1",
               KUBESHARE_TPU_POD_NAME="ns/lonely",
               KUBESHARE_TPU_POD_MANAGER_PORT="0", POD_REQUEST="0.5",
               POD_LIMIT="1.0")
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=60, cwd=str(REPO))
    assert proc.returncode != 0
    assert "READY" not in proc.stdout
    assert "cannot reach scheduler" in proc.stderr


def test_jax_gate_drives_port_manager_and_server():
    """The other direction of parity (b): the JAX package's gate through
    the port's pod manager to the port's token server."""
    from kubeshare_tpu.isolation.client import ExecutionGate as JaxGate
    from kubeshare_tpu.isolation.protocol import Connection as JaxConnection

    sched, srv, port = _server()
    mgr = PodManager("127.0.0.1", port, "ns/jaxgate", request=0.5, limit=1.0)
    mgr.serve()
    try:
        conn = JaxConnection("127.0.0.1", mgr.port)
        conn.call({"op": "register"})
        gate = JaxGate(conn, "ns/jaxgate")
        for _ in range(4):
            gate()
            time.sleep(0.03)
        gate.close()
        conn.close()
        assert sched.window_usage("ns/jaxgate") == pytest.approx(120.0,
                                                                 rel=0.5)
    finally:
        mgr.close()
        _stop(sched, srv)
