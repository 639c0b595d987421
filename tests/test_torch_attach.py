"""Gate-mode attach of the port: an unmodified PyTorch process metered
through env vars alone, against the JAX package's attach.

Mirrors the gate-mode and shim cases of ``tests/test_attach.py``. In the
port the meter is a ``TorchDispatchMode`` that gates every aten op on any
device, so on the CPU it meters CPU ops; what only the card can show (the
drain of the device queue, the allocator's memory, the device pin taking
effect) is in ``tests/test_torch_cuda.py``.
"""

import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from kubeshare_tpu.isolation.client import ExecutionGate as JaxGate
from kubeshare_tpu_torch import attach
from kubeshare_tpu_torch import constants as C
from kubeshare_tpu_torch.isolation import client as tclient
from kubeshare_tpu_torch.isolation import protocol
from kubeshare_tpu_torch.isolation.client import ExecutionGate, HbmCap
from kubeshare_tpu_torch.isolation.podmgr import PodManager
from kubeshare_tpu_torch.isolation.tokensched import TokenScheduler, serve

REPO = Path(__file__).resolve().parent.parent
SHIM = REPO / "kubeshare_tpu_torch" / "_shim"
ATTACH_ENV = (C.ENV_CHIP_PROXY_PORT, C.ENV_POD_MANAGER_PORT,
              C.ENV_ATTACH_MODE, C.ENV_VISIBLE_CHIPS, C.ENV_POD_NAME,
              C.ENV_TPU_REQUEST, C.ENV_TPU_LIMIT, C.ENV_TPU_MEMORY,
              C.ENV_COORDINATOR, C.ENV_NUM_PROCESSES, C.ENV_PROCESS_ID,
              C.ENV_RENDEZVOUS_TIMEOUT_S)


@pytest.fixture(autouse=True)
def _clean_attach(monkeypatch):
    for var in ATTACH_ENV:
        monkeypatch.delenv(var, raising=False)
    # set, then removed: monkeypatch restores the variable as it was, even
    # where the pin under test sets it
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    yield
    attach.detach()
    assert _get_current_dispatch_mode() is None


@pytest.fixture
def token_server():
    sched = TokenScheduler(window_ms=500, base_quota_ms=30, min_quota_ms=5)
    server = serve(sched)
    yield sched, server.server_address[1]
    server.shutdown()
    server.server_close()
    sched.close()


def _pod_env(**extra) -> dict:
    """The environment a pod gets: the port's shim first on PYTHONPATH,
    then the checkout; few CPU threads (the suite runs in parallel)."""
    env = {k: v for k, v in os.environ.items() if k not in ATTACH_ENV}
    env.update(PYTHONPATH=os.pathsep.join([str(SHIM), str(REPO)]),
               OMP_NUM_THREADS="2")
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _run(args, env, timeout=120):
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, env=env, timeout=timeout, cwd=str(REPO))


# --- the meter ---------------------------------------------------------------

def test_attach_gate_meters_cpu_ops(token_server):
    sched, port = token_server
    attach.attach_gate("127.0.0.1", port, "gated", 0.5, 1.0)
    assert attach.active_mode() == "gate"
    x = torch.ones(4) * 2.0          # eager ops run locally, metered
    assert float(x.sum()) == 8.0
    assert sched.core.client_count() == 1
    assert sched.core.holder() == "gated"   # the first op acquired
    attach.detach()
    assert sched.core.holder() is None      # detach released the token
    assert attach.active_mode() == ""


def test_gate_eager_only_workload_is_charged(token_server):
    """Every op passes the gate, so a workload with no compiled call is
    still charged its time (the JAX meter's eager hole, closed here by the
    dispatch mode)."""
    sched, port = token_server
    attach.attach_gate("127.0.0.1", port, "eager-only", 0.5, 1.0)
    x = torch.eye(64)
    for _ in range(20):
        x = x @ x / x.norm() + 1.0
    time.sleep(0.05)
    float(x[0, 0])
    attach.detach()                   # the final release charges the tail
    assert sched.window_usage("eager-only") >= 40.0


def test_gate_charges_wall_time_between_ops():
    """The charge is the wall time between gate calls, so a workload whose
    steps are ~10x longer is charged ~10x per step (test_attach.py's
    proportional-charge case)."""
    sched = TokenScheduler(window_ms=300000, base_quota_ms=60000,
                           min_quota_ms=10)
    server = serve(sched)
    steady, walls = {}, {}
    try:
        for name, pause in (("light", 0.002), ("heavy", 0.02)):
            attach.attach_gate("127.0.0.1", server.server_address[1], name,
                               0.5, 1.0)
            x = torch.ones(8)
            x = x + 1                 # acquires
            t0 = time.monotonic()
            for _ in range(8):
                time.sleep(pause)     # host work: charged as wall time
                x = x + 1
            walls[name] = (time.monotonic() - t0) * 1000.0
            attach.detach()
            steady[name] = sched.window_usage(name)
        for name in steady:           # the charge is the wall time
            assert walls[name] <= steady[name] <= walls[name] + 50.0, (
                steady, walls)
        ratio = steady["heavy"] / max(steady["light"], 1e-9)
        assert ratio >= 4.0 or ratio >= 0.8 * walls["heavy"] / walls[
            "light"], (steady, walls)
    finally:
        server.shutdown()
        server.server_close()
        sched.close()


def test_gate_meters_backward_and_new_threads(token_server, monkeypatch):
    """Autograd's backward ops pass the meter (the engine carries the mode
    in its thread-local state), and so does a thread started after
    attach (a threading profile hook enters the meter on it), as the JAX
    meter meters every thread."""
    seen = []
    real = ExecutionGate.__call__

    def counting(self):
        seen.append(threading.current_thread().name)
        real(self)

    monkeypatch.setattr(ExecutionGate, "__call__", counting)
    _, port = token_server
    attach.attach_gate("127.0.0.1", port, "threads", 0.5, 1.0)
    x = torch.ones(3, requires_grad=True)
    y = (x * x).sum()
    before = len(seen)
    y.backward()
    assert len(seen) > before         # backward's ops were gated
    torch.testing.assert_close(x.grad, 2 * torch.ones(3))

    def work():
        torch.ones(2) + 1

    late = threading.Thread(target=work, name="late")
    late.start()
    late.join(timeout=30)
    assert not late.is_alive()
    assert "late" in seen


def test_compiled_call_is_gated_once_with_meter_suspended(token_server,
                                                          monkeypatch):
    """A ``torch.compile``'d callable passes the gate once per call, with
    the meter suspended inside it (JAX gates a jitted call and skips the
    meter inside its trace)."""
    calls = []
    real = ExecutionGate.__call__
    monkeypatch.setattr(ExecutionGate, "__call__",
                        lambda self: (calls.append(1), real(self)))
    inside = []

    def fake_compile(fn, **kwargs):   # what torch.compile hands back
        def compiled(*args):
            inside.append(_get_current_dispatch_mode())
            return fn(*args)
        return compiled

    monkeypatch.setattr(torch, "compile", fake_compile)
    _, port = token_server
    attach.attach_gate("127.0.0.1", port, "compiled", 0.5, 1.0)
    assert attach.real_compile() is fake_compile
    f = torch.compile(lambda a: a * 2 + 1)
    x = torch.ones(3)
    n = len(calls)
    out = f(x)
    assert len(calls) == n + 1        # one gate call for the whole call
    assert inside == [None]           # no meter inside the compiled call
    torch.testing.assert_close(out, 3 * torch.ones(3))
    attach.detach()
    assert torch.compile is fake_compile


def test_compile_with_dynamo_runs_gated(token_server):
    _, port = token_server
    attach.attach_gate("127.0.0.1", port, "dynamo", 0.5, 1.0)
    f = torch.compile(lambda a: a * 2 + 1, backend="eager")
    torch.testing.assert_close(f(torch.ones(3)), 3 * torch.ones(3))
    module = torch.compile(torch.nn.Linear(2, 2), backend="eager")
    assert isinstance(module, torch.nn.Module)
    assert len(list(module.parameters())) == 2
    assert module(torch.ones(1, 2)).shape == (1, 2)


def test_gate_eager_metering_detached_cleanly(token_server):
    """detach() takes the meter off, restores torch.compile and the
    thread hook: a leaked meter would gate every later test's ops against
    a dead scheduler."""
    _, port = token_server
    real_compile = torch.compile
    attach.attach_gate("127.0.0.1", port, "d", 0.5, 1.0)
    meter = _get_current_dispatch_mode()
    assert meter is not None
    assert torch.compile is not real_compile
    assert threading.getprofile() is not None
    attach.detach()
    assert _get_current_dispatch_mode() is None
    assert not meter.active
    assert torch.compile is real_compile
    assert threading.getprofile() is None


def test_gate_mode_manager_death_fails_fast(token_server):
    """The token server dying mid-run surfaces as an error at the next
    renew, not a hang."""
    sched, port = token_server
    attach.attach_gate("127.0.0.1", port, "orphan", 0.5, 1.0)
    torch.ones(2) + 1
    sched.close()        # the scheduler dies under the attached process
    with pytest.raises((RuntimeError, OSError)):
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:   # until the quota forces a renew
            torch.ones(2) + 1
            time.sleep(0.005)


def test_attach_if_env_noop_without_env():
    assert attach.attach_if_env() == ""
    assert attach.active_mode() == ""
    assert _get_current_dispatch_mode() is None


# --- the completion barrier and the renew charge -----------------------------

class _FakeConn:
    """Records each request; every grant is ``quota`` ms."""

    def __init__(self, quota):
        self.quota = quota
        self.sent = []

    def call(self, msg, blob=None):
        self.sent.append(dict(msg))
        return {"ok": True, "quota_ms": self.quota}, None

    def close(self):
        pass


def test_gate_renew_charges_match_jax_under_scripted_clock(monkeypatch):
    """Parity (c): the same sequence of gate calls under a scripted
    ``time.monotonic`` sends the same messages — the same ``used_ms`` in
    each renew and in the release — from both packages' ExecutionGate.
    Exact equality: both sum the same float differences."""
    clock = [100.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    steps = [0.003, 0.02, 0.011, 0.05, 0.001, 0.04, 0.007, 0.03, 0.09,
             0.002, 0.025, 0.013]
    sent = {}
    for label, make in (("jax", lambda c: JaxGate(c, "p")),
                        ("port", lambda c: ExecutionGate(
                            c, "p", barrier=lambda: None))):
        clock[0] = 100.0
        conn = _FakeConn(quota=50.0)
        gate = make(conn)
        for dt in steps:
            gate()
            clock[0] += dt
        gate.close()
        sent[label] = conn.sent
    assert [m["op"] for m in sent["port"]].count("renew") >= 3
    assert sent["port"] == sent["jax"]


def test_gate_drains_the_device_before_renew_and_release(monkeypatch):
    """A deliberate divergence from the JAX gate. XLA runs one program per
    jitted call and the JAX gate host-reads its result; eager PyTorch has
    no per-call result, and the per-op gate must not wait for the device
    at every op (that would serialize launch and execution). So the port's
    gate waits for the device's queue only before each renew and the
    release, and charges the wait: the tenant's queued kernels finish, and
    are paid for, before the token can pass to a co-tenant, whose work
    would otherwise run into this one's grant."""
    clock = [0.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    drains = []

    def barrier():
        drains.append([m["op"] for m in conn.sent])
        clock[0] += 0.004             # the queue takes 4 ms to drain

    conn = _FakeConn(quota=10.0)
    gate = ExecutionGate(conn, "p", barrier=barrier)
    for _ in range(4):
        gate()                        # acquire, then 6 ms a call
        clock[0] += 0.006
    gate.close()
    ops = [m["op"] for m in conn.sent]
    assert ops == ["acquire", "renew", "release"]
    # the drain ran just before each renew and the release, nowhere else
    assert drains == [["acquire"], ["acquire", "renew"]]
    # and was charged: 2 x 6 ms + 4 ms drain, then 6 + 6 + 4
    assert conn.sent[1]["used_ms"] == pytest.approx(16.0)
    assert conn.sent[2]["used_ms"] == pytest.approx(16.0)


def test_gate_stats_count_grants_charges_drains_and_waits(monkeypatch):
    """``stats()`` adds up what the gate did: each grant, the ms charged
    (the reported ones and the current grant's so far), the ms spent
    draining, and the ms spent in token round trips (here 2 ms each)."""
    clock = [0.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])

    class SlowConn(_FakeConn):
        def call(self, msg, blob=None):
            clock[0] += 0.002
            return super().call(msg, blob)

    def barrier():
        clock[0] += 0.004

    gate = ExecutionGate(SlowConn(quota=10.0), "p", barrier=barrier)
    assert gate.stats() == {"acquires": 0, "renews": 0, "charged_ms": 0.0,
                            "drain_ms": 0.0, "waited_ms": 0.0}
    for _ in range(4):
        gate()
        clock[0] += 0.006
    got = gate.stats()
    # acquire, 6 + 6 + 4 (drain) reported at the renew, then 6 charged at
    # the fourth call; the 6 ms since that call is not charged yet
    assert (got["acquires"], got["renews"]) == (1, 1)
    assert got["charged_ms"] == pytest.approx(22.0)
    assert got["drain_ms"] == pytest.approx(4.0)
    assert got["waited_ms"] == pytest.approx(4.0)
    gate.close()
    got = gate.stats()
    assert got["charged_ms"] == pytest.approx(32.0)   # + 6, + 4 drained
    assert got["drain_ms"] == pytest.approx(8.0)


def test_gate_stats_through_attach(token_server):
    sched, port = token_server
    assert attach.gate_stats() == {}
    attach.attach_gate("127.0.0.1", port, "ns/stats", 0.5, 1.0)
    try:
        torch.ones(3) + 1
        assert attach.gate_stats()["acquires"] == 1
    finally:
        attach.detach()
    assert attach.gate_stats() == {}


def test_note_dispatch_without_cuda_results_waits_for_nothing():
    conn = _FakeConn(quota=10.0)
    gate = ExecutionGate(conn, "p", barrier=lambda: None)
    gate.note_dispatch((torch.ones(2), {"a": torch.zeros(1)}))
    assert gate._pending is None      # CPU results: already complete
    gate()
    assert [m["op"] for m in conn.sent] == ["acquire"]


def test_device_barrier_is_a_no_op_before_cuda_initializes(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: pytest.fail("synchronized"))
    tclient.device_barrier()


# --- the memory cap ----------------------------------------------------------

def test_hbm_cap_fails_closed_without_cuda_stats(token_server):
    """A memory grant where there are no allocator stats (the CPU) stops
    the attach; nothing stays registered or attached."""
    sched, port = token_server
    assert HbmCap._device_stats() is None
    with pytest.raises(SystemExit, match="cannot be enforced"):
        attach.attach_gate("127.0.0.1", port, "nostats", 0.5, 1.0,
                           memory=100_000_000)
    assert attach.active_mode() == ""
    assert _get_current_dispatch_mode() is None
    deadline = time.monotonic() + 5
    while sched.core.client_count() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert sched.core.client_count() == 0


def test_hbm_cap_breach_and_transient_poll():
    reads = iter([{"bytes_reserved": 10}, RuntimeError("poll failed"),
                  {"bytes_reserved": 200}])

    def stats():
        value = next(reads)
        if isinstance(value, Exception):
            raise value
        return value

    cap = HbmCap(100, stats_fn=stats, min_poll_interval_s=0.0)
    cap.check()                       # 10 of 100
    cap.check()                       # a failed poll after a good one: skip
    with pytest.raises(SystemExit, match="cap exceeded"):
        cap.check()
    with pytest.raises(SystemExit, match="pending transfer"):
        HbmCap(100, stats_fn=lambda: {"bytes_reserved": 10}).check(
            extra_bytes=91)
    HbmCap(0, stats_fn=lambda: pytest.fail("polled")).check()


@pytest.mark.parametrize("failures,stops", [(2, False), (4, True)])
def test_hbm_cap_retries_a_failing_first_poll(failures, stops):
    """A first stats query that fails is retried three times, 0.1 s apart,
    as the JAX gate does: a transient failure is not "no stats". Only a
    query that keeps failing stops the process."""
    calls = []

    def stats():
        calls.append(time.monotonic())
        if len(calls) <= failures:
            raise RuntimeError("transport hiccup")
        return {"bytes_reserved": 10}

    cap = HbmCap(100, stats_fn=stats, min_poll_interval_s=0.0)
    if stops:
        with pytest.raises(SystemExit, match="keeps failing"):
            cap.check()
    else:
        cap.check()
    assert len(calls) == min(failures + 1, 4)
    assert calls[-1] - calls[0] >= 0.1 * (len(calls) - 1) - 0.01
    if not stops:
        cap.check()                       # supported now: polls as usual
        assert len(calls) == failures + 2


def test_host_to_device_copy_is_precharged(token_server, monkeypatch):
    """A host→device copy is charged against the cap before its bytes
    land: the meter refuses the op before it runs."""
    monkeypatch.setattr(HbmCap, "_device_stats",
                        staticmethod(lambda: {"bytes_reserved": 1_000}))
    _, port = token_server
    attach.attach_gate("127.0.0.1", port, "bigput", 0.5, 1.0,
                       memory=50_000_000)
    meter = _get_current_dispatch_mode()
    host = torch.zeros(100_000_000, dtype=torch.uint8)
    aten = torch.ops.aten
    cuda = torch.device("cuda")
    assert attach._h2d_bytes(aten._to_copy.default, (host,),
                             {"device": cuda}) == 100_000_000
    assert attach._h2d_bytes(aten._to_copy.default, (host,),
                             {"device": cuda, "dtype": torch.float32}) \
        == 400_000_000
    assert attach._h2d_bytes(aten._to_copy.default, (host,),
                             {"dtype": torch.float32}) == 0
    with pytest.raises(SystemExit, match="pending transfer"):
        meter.__torch_dispatch__(aten._to_copy.default, (), (host,),
                                 {"device": cuda})


def test_hbm_cap_kills_overallocator_cotenant_survives(tmp_path,
                                                       token_server):
    """A gated process that passes its memory grant dies with an
    attributable error; its death frees its registration and a co-tenant
    acquires tokens without obstruction."""
    sched, port = token_server
    child = tmp_path / "overalloc.py"
    child.write_text(f"""
import sys
from kubeshare_tpu_torch.isolation.client import HbmCap
n = [0]
def fake_stats():
    n[0] += 1
    return {{"bytes_reserved": n[0] * 100_000_000}}
HbmCap._device_stats = staticmethod(fake_stats)
from kubeshare_tpu_torch import attach
attach.attach_gate("127.0.0.1", {port}, "overalloc", 0.5, 1.0,
                   memory=250_000_000)
import time, torch
for i in range(200):
    torch.ones(4) + i
    time.sleep(0.01)
print("UNREACHABLE: cap never fired")
""")
    proc = _run([str(child)], dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode != 0, proc.stdout
    assert "device memory cap exceeded" in proc.stderr, proc.stderr[-2000:]
    assert "UNREACHABLE" not in proc.stdout
    deadline = time.monotonic() + 5
    while sched.core.client_count() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert sched.core.client_count() == 0
    with protocol.Connection("127.0.0.1", port) as conn:
        conn.call({"op": "register", "name": "cotenant", "request": 0.5,
                   "limit": 1.0})
        reply, _ = conn.call({"op": "acquire"})
        assert reply["quota_ms"] == 30
        conn.call({"op": "release", "used_ms": 5.0})


# --- the device pin and the refused envs ---------------------------------------

def test_whole_device_pod_sets_visible_devices(monkeypatch):
    monkeypatch.setenv(C.ENV_VISIBLE_CHIPS,
                       "NVIDIA-H100-80GB-HBM3-host-a-2,"
                       "NVIDIA-H100-80GB-HBM3-host-a-3@1.0")
    assert attach.attach_if_env() == "visible"
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "2,3"


def test_whole_device_visible_devices_not_overridden(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setenv(C.ENV_VISIBLE_CHIPS, "TPU-v5e-host-a-2")
    assert attach.attach_if_env() == ""
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "0"


@pytest.mark.parametrize("grant", ["garbage-without-index-", ","])
def test_bad_chip_grant_fails_closed(monkeypatch, grant):
    """A malformed or empty grant stops the pod instead of leaving every
    device of the host visible, co-tenants' included."""
    monkeypatch.setenv(C.ENV_VISIBLE_CHIPS, grant)
    with pytest.raises(SystemExit, match="refusing to start"):
        attach.attach_if_env()
    assert "CUDA_VISIBLE_DEVICES" not in os.environ


def test_gate_mode_also_pins_visible_devices(monkeypatch, token_server):
    _, port = token_server
    monkeypatch.setenv(C.ENV_VISIBLE_CHIPS, "TPU-v4-host-3")
    monkeypatch.setenv(C.ENV_POD_MANAGER_PORT, str(port))
    monkeypatch.setenv(C.ENV_POD_NAME, "gated-pin")
    monkeypatch.setenv(C.ENV_TPU_REQUEST, "0.5")
    assert attach.attach_if_env() == "gate"
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "3"


@pytest.fixture
def chip_proxy():
    from kubeshare_tpu_torch.isolation.proxy import ChipProxy

    p = ChipProxy(device="cpu", scheduler=TokenScheduler(
        window_ms=500, base_quota_ms=30, min_quota_ms=5))
    p.serve()
    yield p
    p.close()


@pytest.mark.parametrize("env,what", [
    ({C.ENV_CHIP_PROXY_PORT: "<proxy>"}, "proxy attach"),
    ({C.ENV_CHIP_PROXY_PORT: "1", C.ENV_ATTACH_MODE: "proxy"},
     "proxy attach"),
    ({C.ENV_ATTACH_MODE: "proxy"}, "proxy attach"),
    ({C.ENV_POD_MANAGER_PORT: "<manager>", C.ENV_COORDINATOR: "<free>",
      C.ENV_NUM_PROCESSES: "2", C.ENV_PROCESS_ID: "1",
      C.ENV_RENDEZVOUS_TIMEOUT_S: "1"}, "gang join"),
])
def test_unported_modes_are_refused(monkeypatch, chip_proxy, token_server,
                                    env, what):
    """The env's modes in the JAX package's order. A proxy port attaches
    in proxy mode (the default) and a proxy that is not there fails the
    attach (the shim then stops the process, below); mode ``proxy``
    without a port warns and attaches nothing. A gate-mode gang member
    joins its gang after its gate: here the rest of the gang never comes,
    so the rendezvous times out and the member exits 1 (gated until
    then); it never runs solo."""
    from kubeshare_tpu_torch.utils.virtualcpu import free_port

    monkeypatch.delenv(C.ENV_RENDEZVOUS_TIMEOUT_S, raising=False)
    fill = {"<proxy>": str(chip_proxy.port),
            "<manager>": str(token_server[1]),
            "<free>": f"127.0.0.1:{free_port()}"}
    for k, v in env.items():
        monkeypatch.setenv(k, fill.get(v, v))
    if what == "gang join":
        with pytest.raises(SystemExit) as e:
            attach.attach_if_env()
        assert e.value.code == 1
        assert attach.active_mode() == "gate"     # the gate came first
        attach.detach()
    elif env.get(C.ENV_CHIP_PROXY_PORT) == "1":
        with pytest.raises(OSError):          # nothing listens on port 1
            attach.attach_if_env()
    elif C.ENV_CHIP_PROXY_PORT in env:
        assert attach.attach_if_env() == "proxy"
        assert attach.active_mode() == "proxy"
        assert os.environ["CUDA_VISIBLE_DEVICES"] == ""
        attach.detach()
    else:
        assert attach.attach_if_env() == ""
    assert attach.active_mode() == ""


def test_attach_off_attaches_nothing(monkeypatch, token_server):
    _, port = token_server
    monkeypatch.setenv(C.ENV_ATTACH_MODE, "off")
    monkeypatch.setenv(C.ENV_POD_MANAGER_PORT, str(port))
    assert attach.attach_if_env() == ""
    assert _get_current_dispatch_mode() is None


# --- the shim ----------------------------------------------------------------

@pytest.mark.parametrize("env,message", [
    ({C.ENV_ATTACH_MODE: "gate", C.ENV_POD_MANAGER_PORT: "1",
      C.ENV_POD_NAME: "doomed", C.ENV_TPU_REQUEST: "1",
      C.ENV_TPU_LIMIT: "1"}, "refusing to run unmetered"),
    ({C.ENV_CHIP_PROXY_PORT: "1"}, "refusing to run unmetered"),
    ({C.ENV_COORDINATOR: "<free>", C.ENV_NUM_PROCESSES: "2",
      C.ENV_PROCESS_ID: "1", C.ENV_RENDEZVOUS_TIMEOUT_S: "1"},
     "failed its rendezvous"),
    ({C.ENV_VISIBLE_CHIPS: "no-index-"}, "refusing to start"),
], ids=["no-manager", "proxy-mode", "gang", "bad-grant"])
def test_shim_fails_closed(env, message):
    """A pod whose env requests an attach that cannot be made DIES — no
    manager, no proxy where the proxy port points, a gang member whose
    rendezvous fails (exit 1), a bad grant — instead of running
    unmetered or solo."""
    from kubeshare_tpu_torch.utils.virtualcpu import free_port

    env = {k: f"127.0.0.1:{free_port()}" if v == "<free>" else v
           for k, v in env.items()}
    proc = _run(["-c", "print('RAN UNMETERED')"], _pod_env(**env))
    if C.ENV_COORDINATOR in env:
        assert proc.returncode == 1
    assert proc.returncode != 0
    assert "RAN UNMETERED" not in proc.stdout
    assert message in proc.stderr, proc.stderr[-2000:]


def test_shim_fails_closed_on_memory_grant_without_stats(token_server):
    _, port = token_server
    proc = _run(["-c", "print('RAN UNMETERED')"], _pod_env(**{
        C.ENV_POD_MANAGER_PORT: port, C.ENV_POD_NAME: "nostats",
        C.ENV_TPU_REQUEST: "0.5", C.ENV_TPU_MEMORY: "100000000"}))
    assert proc.returncode != 0
    assert "RAN UNMETERED" not in proc.stdout
    assert "cannot be enforced" in proc.stderr, proc.stderr[-2000:]


def test_shim_fails_closed_even_when_package_unimportable(tmp_path):
    """The shim does not depend on the package it guards."""
    shutil.copy(SHIM / "sitecustomize.py", tmp_path / "sitecustomize.py")
    env = {"PATH": os.environ.get("PATH", ""), "PYTHONPATH": str(tmp_path),
           C.ENV_ATTACH_MODE: "gate", C.ENV_POD_MANAGER_PORT: "1"}
    proc = _run(["-c", "print('RAN UNMETERED')"], env)
    assert proc.returncode != 0
    assert "RAN UNMETERED" not in proc.stdout
    assert "refusing to run unmetered" in proc.stderr


def test_shim_noop_without_kubeshare_env():
    proc = _run(["-c", "import sys; print('plain python ok', "
                       "'torch' in sys.modules)"], _pod_env())
    assert proc.returncode == 0, proc.stderr[-1000:]
    assert "plain python ok False" in proc.stdout   # torch not even imported
    assert "shim failed" not in proc.stderr


def test_unmodified_mnist_attaches_through_shim_and_is_charged():
    """Parity (d), the zero-touch contract: ``python -m
    kubeshare_tpu_torch.models.mnist --device cpu --steps 3`` with only a
    pod's env and the port's shim on PYTHONPATH registers through a pod
    manager, is metered, and is charged; its release frees the token."""
    sched = TokenScheduler(window_ms=600000, base_quota_ms=50,
                           min_quota_ms=5)
    server = serve(sched)
    mgr = PodManager("127.0.0.1", server.server_address[1], "ns/mnist-pod",
                     request=0.5, limit=1.0)
    mgr.serve()
    try:
        proc = _run(["-m", "kubeshare_tpu_torch.models.mnist", "--device",
                     "cpu", "--steps", "3"], _pod_env(**{
                         C.ENV_POD_MANAGER_PORT: mgr.port,
                         C.ENV_POD_NAME: "ns/mnist-pod",
                         C.ENV_TPU_REQUEST: "0.5",
                         C.ENV_TPU_LIMIT: "1.0"}), timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "steps/s" in proc.stdout and "final loss" in proc.stdout
        used = sched.window_usage("ns/mnist-pod")
        assert used > 0.0, "the workload ran with zero charge"
        assert sched.core.holder() is None   # released at exit
    finally:
        mgr.close()
        server.shutdown()
        server.server_close()
        sched.close()
