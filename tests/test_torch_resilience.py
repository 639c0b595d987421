"""The port's resilience plane on a CPU ``ChipProxy``: the counterparts of
``tests/test_resilience.py`` (negotiation, reconnect-and-replay, the fault
injector, crash recovery from the journal, live migration), the cases of
a step that updates its parameters in place — a replayed step runs once,
a crash between a sidecar and its manifest recovers one consistent
moment, a tampered journaled program loads nothing — and
``compile_loop`` over a tenant's own function against the JAX package's.
"""

import io
import json
import os
import subprocess
import sys
import threading
import time
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubeshare_tpu.isolation.client import ProxyClient as JaxProxyClient
from kubeshare_tpu.isolation.proxy import ChipProxy as JaxChipProxy
from kubeshare_tpu.isolation.tokensched import TokenScheduler as JaxScheduler
from kubeshare_tpu.models import tinymlp as jtiny
from kubeshare_tpu.models.common import make_train_step as jax_train_step
from kubeshare_tpu.ops.fused_adam import fused_adam as jax_fused_adam
from kubeshare_tpu.resilience import faults as jfaults
from kubeshare_tpu_torch import convert
from kubeshare_tpu_torch.isolation import protocol
from kubeshare_tpu_torch.isolation.client import ProxyClient
from kubeshare_tpu_torch.isolation.proxy import ChipProxy
from kubeshare_tpu_torch.isolation.tokensched import TokenScheduler
from kubeshare_tpu_torch.models import common, tinymlp
from kubeshare_tpu_torch.ops.fused_adam import fused_adam
from kubeshare_tpu_torch.resilience import faults
from kubeshare_tpu_torch.resilience.migrate import migrate_session
from kubeshare_tpu_torch.resilience.reconnect import (ReconnectPolicy,
                                                      SessionLost,
                                                      backoff_delays)
from kubeshare_tpu_torch.utils.tree import tree_leaves

REPO = Path(__file__).resolve().parent.parent
WINDOW, BASE, MIN = 1000.0, 100.0, 10.0
LR = 1e-2
#: a tight budget, so failures resolve in test time; seeded, so the
#: jittered backoff is the same every run
FAST = ReconnectPolicy(max_attempts=8, base_delay_s=0.02, max_delay_s=0.2,
                       dial_timeout_s=1.0, seed=7)
PATIENT = ReconnectPolicy(max_attempts=30, base_delay_s=0.05,
                          max_delay_s=0.25, dial_timeout_s=1.0, seed=3)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # the suite runs in parallel workers: keep torch's CPU kernels from
    # taking every core from the timing-sensitive tests of other workers
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _clear_faults():
    yield
    faults.uninstall()


def make_proxy(journal_dir=None, **kw):
    p = ChipProxy(device="cpu", scheduler=TokenScheduler(WINDOW, BASE, MIN),
                  journal_dir=None if journal_dir is None
                  else str(journal_dir), **kw)
    p.serve()
    return p


@pytest.fixture
def proxy():
    p = make_proxy()
    yield p
    p.close()


def connect(p, name, policy=FAST, **kw):
    return ProxyClient("127.0.0.1", p.port, name, 0.5, 1.0,
                       reconnect=policy, **kw)


# --- the in-place train step -------------------------------------------------

def _step():
    return common.make_train_step(tinymlp.loss_fn, fused_adam(LR))


def _loop_fn(carry, x, y):
    params, state, loss = _step()(*carry, (x, y))
    return (params, state), loss


def _host_start(seed=0):
    params = tinymlp.init(seed)
    state = fused_adam(LR).init(common.to_device(params, "cpu"))
    return params, state, tuple(tinymlp.batch_fn(seed + 1))


def _put_start(c, seed=0):
    params, state, batch = _host_start(seed)
    return c.put_tree(params), c.put_tree(state), c.put_tree(batch)


def _eager_params(steps, seed=0):
    """Params and losses of ``steps`` eager steps on the CPU."""
    params, state, batch = _host_start(seed)
    p = common.to_device(params, "cpu")
    s = common.to_device(state, "cpu")
    b = common.to_device(batch, "cpu")
    losses = []
    for _ in range(steps):
        p, s, loss = _step()(p, s, b)
        losses.append(float(loss))
    return [t.numpy() for t in tree_leaves(p)], losses


def _assert_params(c, params, want):
    for got, w in zip(tree_leaves(c.get_tree(params)), want):
        np.testing.assert_array_equal(got, w)


# --- negotiation -------------------------------------------------------------

def test_register_grants_resume_and_seq(proxy):
    with connect(proxy, "nego") as c:
        assert c.features == {"preempt", "resume", "seq"}
        assert c._conn.token and c._conn.pipelined
        x = np.arange(16, dtype=np.float32)
        np.testing.assert_array_equal(c.get(c.put(x)), x)


def test_unnegotiated_register_reply_unchanged(proxy):
    with protocol.Connection("127.0.0.1", proxy.port) as conn:
        reply, _ = conn.call({"op": "register", "name": "old",
                              "request": 0.5, "limit": 1.0, "memory": 0})
        assert set(reply) == {"ok", "platforms", "device"}
        assert conn.call({"op": "usage"})[0]["hbm_used"] == 0
        conn.call({"op": "unregister"})


def test_reconnect_none_keeps_the_lockstep_client(proxy):
    """``reconnect=None``: no features, no resume token — a lockstep
    connection whose drop frees the session at once, its failures
    surfacing unchanged."""
    c = ProxyClient("127.0.0.1", proxy.port, "legacy", 0.5, 1.0,
                    reconnect=None)
    assert c.features == frozenset() and not c._conn.pipelined
    x = np.arange(4, dtype=np.float32)
    bx = c.put(x)
    out = c.compile(lambda t: t + 1.0, bx)(bx)    # a resolved future
    np.testing.assert_array_equal(c.get(out), x + 1.0)
    c._conn.close()
    with pytest.raises(OSError):
        c.get(bx)
    deadline = time.monotonic() + 5
    while "legacy" in proxy._sessions and time.monotonic() < deadline:
        time.sleep(0.01)
    assert "legacy" not in proxy._sessions


def test_backoff_delays_deterministic_and_capped():
    import random
    pol = ReconnectPolicy(base_delay_s=0.1, max_delay_s=0.4, jitter=0.5)
    a_gen = backoff_delays(pol, random.Random(42))
    b_gen = backoff_delays(pol, random.Random(42))
    a = [next(a_gen) for _ in range(6)]
    b = [next(b_gen) for _ in range(6)]
    assert a[0] == 0.0 and a == b
    assert all(x <= 0.4 * 1.5 for x in b)


# --- the fault injector ------------------------------------------------------

SPECS = [
    dict(kill_conn_after_frames=3, kill_conn_repeat=2, drop_reply_seq=4,
         seed=11),
    dict(kill_conn_after_frames=2, kill_conn_tag="t",
         crash_proxy_after_chunks=3),
    dict(suppress_heartbeats_node="n1", suppress_heartbeats_after=2,
         flap_node="n2", flap_beats=2, partition_registry_ops=2,
         drop_service_ops=1, delay_writer_ms=1.5)]
SCRIPT = [("should_kill_connection", ("t", 1)),
          ("should_kill_connection", ("u", 2)),
          ("should_drop_reply", (4,)), ("should_kill_connection", ("t", 1)),
          ("should_crash_proxy", ()), ("should_drop_reply", (4,)),
          ("should_kill_connection", ("t", 3)), ("should_crash_proxy", ()),
          ("should_suppress_heartbeat", ("n1",)),
          ("should_suppress_heartbeat", ("n2",)),
          ("should_crash_proxy", ()), ("should_partition_registry", ()),
          ("should_suppress_heartbeat", ("n1",)),
          ("should_suppress_heartbeat", ("n1",)),
          ("should_suppress_heartbeat", ("n2",)),
          ("should_suppress_heartbeat", ("n2",)),
          ("should_drop_service_call", ()), ("should_drop_service_call", ()),
          ("should_partition_registry", ()), ("writer_delay_s", ()),
          ("should_kill_connection", ("t", 2)),
          ("should_partition_registry", ())]


def _decisions(mod, specs):
    inj = mod.compose(*[mod.FaultSpec(**s) for s in specs])
    return [getattr(inj, name)(*args) for name, args in SCRIPT]


@pytest.mark.parametrize("specs", [[SPECS[0]], [SPECS[1]], [SPECS[2]],
                                   SPECS], ids=["kill", "crash", "control",
                                                "composed"])
def test_injector_decides_as_the_jax_injector(specs):
    """The same specs, seed and hook calls give the JAX injector's
    decisions, call for call — alone and composed."""
    got = _decisions(faults, specs)
    assert got == _decisions(jfaults, specs)
    assert got == _decisions(faults, specs)       # deterministic


def test_fault_spec_from_env_matches_jax():
    env = {"KUBESHARE_FAULTS": "kill_conn_after_frames=5,kill_conn_tag=x,"
                               "delay_writer_ms=1.5;drop_reply_seq=3",
           "KUBESHARE_FAULT_SEED": "9"}
    inj, ref = faults.from_env(env), jfaults.from_env(env)
    assert [vars(i.spec) for i in inj.injectors] == \
        [vars(i.spec) for i in ref.injectors]
    assert inj.injectors[0].spec.seed == 9 and inj.injectors[1].spec.seed \
        == 10
    assert faults.from_env({}) is None
    with pytest.raises(ValueError, match="unknown fault field"):
        faults.parse_spec("frobnicate=1")


# --- reconnect and replay ----------------------------------------------------

def test_kill_mid_window_put_is_transparent(proxy):
    """The connection dies mid windowed upload; the caller sees a put that
    succeeded and the same bytes, never the failure."""
    c = connect(proxy, "killput", fault_tag="victim", chunk_bytes=8192)
    big = np.arange(65536, dtype=np.float32).reshape(256, 256)
    faults.install(faults.Injector(faults.FaultSpec(
        kill_conn_after_frames=4, kill_conn_tag="victim")))
    buf = c.put(big)
    faults.uninstall()
    np.testing.assert_array_equal(c.get(buf), big)
    assert c.transport()["resumes"] >= 1
    assert proxy.hbm_accounting()["killput"]["balanced"]
    c.close()


def test_kill_mid_window_keeps_the_accounting_exact(proxy):
    """Killing the connection mid-window again and again leaves no staged
    upload behind and the memory charge exact, with no creep per kill."""
    big = np.arange(65536, dtype=np.float32).reshape(256, 256)
    c = connect(proxy, "leakcheck", fault_tag="leak", chunk_bytes=8192)
    for _ in range(3):
        faults.install(faults.Injector(faults.FaultSpec(
            kill_conn_after_frames=4, kill_conn_tag="leak")))
        buf = c.put(big)
        faults.uninstall()
        np.testing.assert_array_equal(c.get(buf), big)   # windowed get
        assert c.usage()["hbm_used"] == big.nbytes
        c.free(buf)
        assert c.usage()["hbm_used"] == 0
    assert not proxy._session("leakcheck").staging
    c.close()


def test_in_flight_execute_future_survives_kill(proxy):
    """An execute sent right before the connection dies resolves through
    the replay, answered from the reply cache: it ran once."""
    c = connect(proxy, "killexec", fault_tag="evict")
    x = np.full((32, 32), 3.0, np.float32)
    bx = c.put(x)
    exe = c.compile(lambda a: a * 2.0, bx)
    faults.install(faults.Injector(faults.FaultSpec(
        kill_conn_after_frames=1, kill_conn_tag="evict")))
    fut = exe.call_async(bx)             # this frame triggers the kill
    out = fut.result()
    faults.uninstall()
    np.testing.assert_array_equal(c.get(out), 2.0 * x)
    assert c.usage()["exec_count"] == 1
    c.close()


def test_a_replayed_in_place_step_runs_once(proxy):
    """The train step updates its parameters in place. The connection dies
    right after its execute frame left; the replay is answered from the
    reply cache, so the parameters are those of exactly one step, equal
    to the eager step's."""
    c = connect(proxy, "inplace", fault_tag="step")
    p, s, b = _put_start(c)
    exe = c.compile(_step(), p, s, b)
    faults.install(faults.Injector(faults.FaultSpec(
        kill_conn_after_frames=1, kill_conn_tag="step")))
    p2, s2, loss = exe(p, s, b)
    faults.uninstall()
    assert c.transport()["replayed"] >= 1
    assert c.usage()["exec_count"] == 1
    want, losses = _eager_params(1)
    assert float(c.get(loss)) == losses[0]
    _assert_params(c, p2, want)
    _assert_params(c, p, want)           # the same tensors, updated once
    c.close()


def test_lost_reply_recovered_via_request_timeout(proxy):
    """The proxy handles a request but its reply is lost: the presumed-lost
    timer forces a reconnect, and the replayed rid is answered from the
    cache."""
    pol = ReconnectPolicy(max_attempts=4, base_delay_s=0.02,
                          max_delay_s=0.1, dial_timeout_s=1.0,
                          request_timeout_s=0.3, seed=5)
    c = connect(proxy, "dropped", policy=pol)
    x = np.arange(64, dtype=np.float32)
    bx = c.put(x)                        # seq 1
    faults.install(faults.Injector(faults.FaultSpec(drop_reply_seq=2)))
    assert c.usage()["hbm_used"] == x.nbytes   # seq 2: its reply dropped
    faults.uninstall()
    np.testing.assert_array_equal(c.get(bx), x)
    c.close()


def test_budget_exhausted_surfaces_session_lost():
    p = make_proxy()
    pol = ReconnectPolicy(max_attempts=2, base_delay_s=0.01,
                          max_delay_s=0.02, dial_timeout_s=0.2, seed=1)
    c = connect(p, "doomed", policy=pol)
    bx = c.put(np.zeros(8, np.float32))
    p.crash(wait=True)                   # gone for good
    with pytest.raises(SessionLost):
        c.get(bx)
    assert not c._conn.healthy
    with pytest.raises(SessionLost):     # every later request too
        c.usage()
    c.close()                            # skips the dead unregister
    p.close()


def test_resume_token_is_required_capability(proxy):
    with protocol.Connection("127.0.0.1", proxy.port) as conn:
        with pytest.raises(RuntimeError, match="unknown resume token"):
            conn.call({"op": "register", "resume": "beef" * 8})


def test_a_parked_session_expires_after_its_grace():
    p = make_proxy(detach_grace_ms=100.0)
    try:
        c = connect(p, "parked")
        c.put(np.zeros(4, np.float32))
        c._conn._conn.close()            # the connection dies, unresumed
        deadline = time.monotonic() + 5
        while "parked" in p._sessions and time.monotonic() < deadline:
            time.sleep(0.02)
        assert "parked" not in p._sessions
        assert p.scheduler.core.client_count() == 0
    finally:
        p.close()


# --- crash and the journal ---------------------------------------------------

def test_proxy_crash_mid_stream_recovers_from_journal(tmp_path):
    """The proxy crashes mid windowed put with an execute in flight; a new
    one starts from the journal on a new port and the client's endpoint
    is flipped. Both futures resolve with the same bytes — the caller
    never saw the crash — and the accounting is exact."""
    p1 = make_proxy(tmp_path)
    c = ProxyClient("127.0.0.1", p1.port, "crashy", 0.5, 1.0,
                    reconnect=PATIENT, chunk_bytes=8192)
    x = np.arange(1024, dtype=np.float32)
    bx = c.put(x)
    exe = c.compile(lambda a: a + 1.0, bx)
    big = np.arange(65536, dtype=np.float32).reshape(256, 256)
    faults.install(faults.Injector(faults.FaultSpec(
        crash_proxy_after_chunks=3)))
    fut = exe.call_async(bx)             # in flight across the crash
    done: dict = {}

    def uploader():
        try:
            done["buf"] = c.put(big)
        except Exception as exc:         # pragma: no cover - failure path
            done["err"] = exc

    t = threading.Thread(target=uploader)
    t.start()
    deadline = time.monotonic() + 10.0
    while not p1._crashed and time.monotonic() < deadline:
        time.sleep(0.01)
    assert p1._crashed
    faults.uninstall()
    p2 = make_proxy(tmp_path)            # restores the session
    assert p2.restored == ["crashy"]
    c.set_endpoint("127.0.0.1", p2.port)
    t.join(timeout=60)
    assert not t.is_alive() and "err" not in done, done.get("err")
    out = fut.result()
    np.testing.assert_array_equal(c.get(out), x + 1.0)
    np.testing.assert_array_equal(c.get(bx), x)
    np.testing.assert_array_equal(c.get(done["buf"]), big)
    assert c.usage()["hbm_used"] == x.nbytes + big.nbytes + x.nbytes
    assert p2.hbm_accounting()["crashy"]["balanced"]
    c.close()
    assert os.listdir(tmp_path) == []    # a clean exit purges the journal
    p2.close()
    p1.close()


@pytest.mark.parametrize("when", ["before_manifest", "after_manifest"])
def test_a_crash_between_sidecar_and_manifest_recovers_one_moment(
        tmp_path, monkeypatch, when):
    """The proxy crashes while it journals an in-place step: after the new
    sidecars, before the manifest that switches to them — or just after
    it. Either way the recovered parameters and the reply cache describe
    one moment, so the replayed step runs once (before) or not at all
    (after), and the parameters are exactly two steps'."""
    p1 = make_proxy(tmp_path)
    c = ProxyClient("127.0.0.1", p1.port, "moment", 0.5, 1.0,
                    reconnect=PATIENT)
    p, s, b = _put_start(c)
    exe = c.compile(_step(), p, s, b)
    p, s, _ = exe(p, s, b)               # step 1, journaled
    real = p1.journal.checkpoint

    def crash_at_the_manifest(manifest):
        if when == "after_manifest":
            real(manifest)
        p1.crash()

    monkeypatch.setattr(p1.journal, "checkpoint", crash_at_the_manifest)
    fut = exe.call_async(p, s, b)        # step 2: its journal write dies
    deadline = time.monotonic() + 10.0
    while not p1._crashed and time.monotonic() < deadline:
        time.sleep(0.01)
    assert p1._crashed
    p2 = make_proxy(tmp_path)
    sess = p2._sessions["moment"]
    on_disk = [t.numpy().copy() for t in
               (sess.buffers[h] for h in
                (x.handle for x in tree_leaves(p)))]
    steps_on_disk = 2 if when == "after_manifest" else 1
    want_disk, _ = _eager_params(steps_on_disk)
    for got, w in zip(on_disk, want_disk):
        np.testing.assert_array_equal(got, w)
    c.set_endpoint("127.0.0.1", p2.port)
    p3, s3, loss = fut.result()
    want, losses = _eager_params(2)
    assert float(c.get(loss)) == losses[1]
    _assert_params(c, p3, want)
    assert c.usage()["exec_count"] == (0 if when == "after_manifest" else 1)
    c.close()
    p2.close()
    p1.close()


def _from_file(victim):
    def edit(name, data):
        if name.endswith("model.json"):
            model = json.loads(data)
            node = model["graph_module"]["graph"]["nodes"][0]
            node["target"] = "torch.ops.aten.from_file.default"
            node["inputs"] = [
                {"name": "filename", "arg": {"as_string": str(victim)},
                 "kind": 1},
                {"name": "shared", "arg": {"as_bool": True}, "kind": 1},
                {"name": "size", "arg": {"as_int": 3}, "kind": 1},
                {"name": "dtype", "arg": {"as_scalar_type": 7}, "kind": 2}]
            data = json.dumps(model).encode()
        return data
    return edit


def test_a_tampered_journaled_program_is_refused_at_recovery(tmp_path,
                                                             monkeypatch):
    """A journal directory holds bytes that tenants wrote: a journaled
    program edited to map a file of the proxy's host (``aten.from_file``)
    is refused at recovery as a compile would refuse it, before
    ``torch.export.load``, and nothing else of that session loads; a
    session beside it comes back."""
    from kubeshare_tpu_torch.isolation import exported

    jdir, victim = tmp_path / "journal", tmp_path / "victim.bin"
    victim.write_bytes(np.arange(3, dtype=np.float32).tobytes())
    p1 = make_proxy(jdir)
    bad = ProxyClient("127.0.0.1", p1.port, "tampered", 0.5, 1.0,
                      reconnect=PATIENT)
    good = ProxyClient("127.0.0.1", p1.port, "intact", 0.5, 1.0,
                       reconnect=PATIENT)
    for c in (bad, good):
        bx = c.put(np.zeros(3, np.float32))
        c.compile(lambda t: t + 1.0, bx)
    token = bad._conn.token
    p1.crash(wait=True)
    prog, = [n for n in os.listdir(jdir) if n.startswith(token + ".prog")]
    src = zipfile.ZipFile(io.BytesIO((jdir / prog).read_bytes()))
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w") as w:
        for n in src.namelist():
            w.writestr(n, _from_file(victim)(n, src.read(n)))
    (jdir / prog).write_bytes(out.getvalue())
    loads = []
    real_load = torch.export.load
    monkeypatch.setattr(torch.export, "load",
                        lambda *a, **k: (loads.append(1),
                                         real_load(*a, **k))[1])
    p2 = make_proxy(jdir)
    try:
        assert p2.restored == ["intact"]
        assert "tampered" not in p2._sessions
        assert p2.scheduler.core.client_count() == 1
        assert len(loads) == 1               # the intact program only
        assert victim.read_bytes() == \
            np.arange(3, dtype=np.float32).tobytes()
        assert (jdir / prog).exists()        # kept for the operator
        with pytest.raises(exported.ProgramRefused, match="from_file"):
            exported.load_program((jdir / prog).read_bytes(), "cpu")
    finally:
        for c in (bad, good):
            c._conn.close()
        p2.close()
        p1.close()


def test_recovery_refuses_what_the_proxy_did_not_write(tmp_path):
    """A manifest whose token the proxy did not mint, or whose sidecar
    does not hold the tensor it names, loads nothing of its session."""
    p1 = make_proxy(tmp_path)
    c = ProxyClient("127.0.0.1", p1.port, "victim", 0.5, 1.0,
                    reconnect=PATIENT)
    c.put(np.arange(4, dtype=np.float32))
    token = c._conn.token
    p1.crash(wait=True)
    manifest = json.loads((tmp_path / f"{token}.json").read_text())
    gen = manifest["buffers"][0]["gen"]
    np.save(tmp_path / f"{token}.g{gen}.npy", np.zeros(5, np.int64))
    (tmp_path / "../escape.json").write_text(json.dumps(
        dict(manifest, token="../escape", name="escape")))
    os.replace(tmp_path / "../escape.json", tmp_path / "x.json")
    p2 = make_proxy(tmp_path)
    try:
        assert p2.restored == [] and not p2._sessions
    finally:
        c._conn.close()
        p2.close()
        p1.close()


def _proxy_process(env: dict, port: int = 0):
    """The proxy's CLI on the CPU; returns the process and its port."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeshare_tpu_torch.isolation.proxy",
         "--device", "cpu", "-P", str(port), "-w", str(WINDOW), "-q",
         str(BASE), "-m", str(MIN)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=str(REPO), env=dict(os.environ, OMP_NUM_THREADS="2", **env))
    line = proc.stdout.readline()
    assert line.startswith("READY"), line
    return proc, int(line.split()[1])


def test_the_cli_restores_its_sessions_after_a_kill(tmp_path):
    """``KUBESHARE_JOURNAL_DIR`` for the proxy process: SIGKILLed under a
    tenant and started again on the same port, it brings the session
    back from the journal and the tenant goes on, never told."""
    env = {"KUBESHARE_JOURNAL_DIR": str(tmp_path)}
    first, port = _proxy_process(env)
    second = None
    try:
        c = ProxyClient("127.0.0.1", port, "survivor", 0.5, 1.0,
                        reconnect=PATIENT)
        x = np.arange(12, dtype=np.float32)
        bx = c.put(x)
        exe = c.compile(lambda a: a * 2.0, bx)
        first.kill()
        first.wait()
        second, _ = _proxy_process(env, port)
        np.testing.assert_array_equal(c.get(exe(bx)), 2.0 * x)
        np.testing.assert_array_equal(c.get(bx), x)
        assert c.transport()["resumes"] == 1
        c.close()
        assert os.listdir(tmp_path) == []
    finally:
        for proc in (first, second):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()


# --- live migration ----------------------------------------------------------

def test_live_migration_end_to_end():
    """drain → export → import → flip: the buffers and the compiled
    program arrive as they were, the client follows the tombstone by
    itself, and the source refuses new sessions."""
    p1, p2 = make_proxy(), make_proxy()
    try:
        c = connect(p1, "mover")
        x = np.arange(4096, dtype=np.float32).reshape(64, 64)
        bx = c.put(x)
        exe = c.compile(lambda a: a * 3.0, bx)
        out0 = exe(bx)
        np.testing.assert_array_equal(c.get(out0), 3.0 * x)
        c.free(out0)
        res = migrate_session(("127.0.0.1", p1.port),
                              ("127.0.0.1", p2.port), c._conn.token,
                              drain=True)
        assert res["name"] == "mover" and res["moved"][1] == p2.port
        assert res["bytes"] >= x.nbytes and res["duration_s"] > 0
        out = exe(bx)                    # rides the tombstone redirect
        np.testing.assert_array_equal(c.get(out), 3.0 * x)
        np.testing.assert_array_equal(c.get(bx), x)
        assert c._conn.endpoint == ("127.0.0.1", p2.port)
        assert p1.scheduler.core.client_count() == 0
        with pytest.raises(RuntimeError, match="draining"):
            ProxyClient("127.0.0.1", p1.port, "newbie", 0.5, 1.0)
        c.close()
    finally:
        p1.close()
        p2.close()


def test_a_moved_in_place_step_goes_on_as_if_unmoved():
    """A session mid-training moves: its in-place step's parameters (and
    the handles that alias them) arrive as one tensor each, and the next
    steps give the unmoved run's parameters exactly."""
    p1, p2 = make_proxy(), make_proxy()
    try:
        c = connect(p1, "trainer")
        p, s, b = _put_start(c)
        exe = c.compile(_step(), p, s, b)
        p, s, _ = exe(p, s, b)
        migrate_session(("127.0.0.1", p1.port), ("127.0.0.1", p2.port),
                        c._conn.token)
        for _ in range(2):
            p, s, loss = exe(p, s, b)
        want, losses = _eager_params(3)
        assert float(c.get(loss)) == losses[2]
        _assert_params(c, p, want)
        assert p2.hbm_accounting()["trainer"]["balanced"]
        c.close()
    finally:
        p1.close()
        p2.close()


def test_migration_failure_leaves_source_authoritative():
    p1 = make_proxy()
    try:
        c = connect(p1, "stay")
        x = np.arange(256, dtype=np.float32)
        bx = c.put(x)
        with pytest.raises(OSError):     # the destination refuses the dial
            migrate_session(("127.0.0.1", p1.port), ("127.0.0.1", 1),
                            c._conn.token)
        np.testing.assert_array_equal(c.get(bx), x)
        c.close()
    finally:
        p1.close()


def test_a_migration_failing_after_the_freeze_unfreezes_the_source():
    """The destination refuses the import after the source froze the
    session (and kicked its client): the mover aborts the migration, and
    the client resumes on the source as if nothing moved."""
    p1, p2 = make_proxy(), make_proxy()
    try:
        c = connect(p1, "refused")
        x = np.arange(64, dtype=np.float32)
        bx = c.put(x)
        p2.drain()                       # imports refused
        with pytest.raises(RuntimeError, match="imports refused"):
            migrate_session(("127.0.0.1", p1.port), ("127.0.0.1", p2.port),
                            c._conn.token)
        assert not p1._sessions["refused"].migrating
        np.testing.assert_array_equal(c.get(bx), x)
        assert c.transport()["resumes"] == 1
        c.close()
    finally:
        p1.close()
        p2.close()


def test_a_resume_waits_out_a_move_in_flight(monkeypatch):
    """A client whose budget is a few quick attempts resumes while its
    session is mid-move: each attempt waits for the move (up to
    MIGRATION_WAIT_S) instead of being refused at once, so the client
    follows the tombstone to the destination."""
    from kubeshare_tpu_torch.resilience import migrate

    p1, p2 = make_proxy(), make_proxy()
    real_copy = migrate._copy_buffer

    def slow_copy(*a, **k):
        time.sleep(0.3)
        return real_copy(*a, **k)

    monkeypatch.setattr(migrate, "_copy_buffer", slow_copy)
    try:
        c = connect(p1, "inflight", policy=ReconnectPolicy(
            max_attempts=3, base_delay_s=0.01, max_delay_s=0.02,
            dial_timeout_s=2.0, seed=2))
        x = np.arange(64, dtype=np.float32)
        bx = c.put(x)
        mover = threading.Thread(target=migrate_session, args=(
            ("127.0.0.1", p1.port), ("127.0.0.1", p2.port),
            c._conn.token))
        mover.start()
        deadline = time.monotonic() + 10
        while (not p1._sessions["inflight"].migrating
               and time.monotonic() < deadline):
            time.sleep(0.005)
        np.testing.assert_array_equal(c.get(bx), x)   # resumes mid-move
        mover.join(timeout=30)
        assert not mover.is_alive()
        assert c._conn.endpoint == ("127.0.0.1", p2.port)
        c.close()
    finally:
        p1.close()
        p2.close()


def test_a_registered_loop_program_migrates_as_its_spec():
    """A loop built from a registered spec travels as its spec, through
    the destination's spec checks, under its exec id."""
    spec = {"program": "train_step", "model": "tinymlp",
            "optimizer": {"name": "fused_adam", "lr": LR}}
    p1, p2 = make_proxy(), make_proxy()
    try:
        c = connect(p1, "specs")
        p, s, b = _put_start(c)
        loop = c.compile_loop(spec, (p, s), *b)
        carry, _ = loop(1, (p, s), *b)
        migrate_session(("127.0.0.1", p1.port), ("127.0.0.1", p2.port),
                        c._conn.token)
        carry, loss = loop(1, carry, *b)
        want, losses = _eager_params(2)
        assert float(c.get(loss)) == pytest.approx(losses[1], rel=1e-6)
        assert "spec" in p2._sessions["specs"].programs[loop._exec_id]
        c.close()
    finally:
        p1.close()
        p2.close()


# --- compile_loop over a tenant's own function -------------------------------

def _jax_tiny():
    params = jax.tree_util.tree_map(np.asarray,
                                    jtiny.init(jax.random.PRNGKey(5)))
    return params, tuple(np.asarray(a) for a in tinymlp.batch_fn(6))


def _run_loop(client, loop, carry, batch, plan):
    """Drive ``loop`` through ``plan`` — ``("one", n)`` n one-step calls,
    ``("burst", n)`` bursts toward n steps, ``("chain", n)`` chains toward
    n — returning the carry, the steps run and the loss after each call."""
    steps, losses = 0, []
    for how, n in plan:
        goal = steps + n
        while steps < goal:
            if how == "chain":
                carry, loss = loop.chain(goal - steps, carry, *batch)
            else:
                carry, loss = loop(1 if how == "one" else goal - steps,
                                   carry, *batch)
            steps += loop.last_n
            losses.append((steps, float(np.asarray(client.get(loss)))))
    return carry, steps, losses


PLAN = [("one", 1), ("burst", 3), ("chain", 4)]


def test_compile_loop_over_a_function_matches_the_jax_package():
    """The same tinymlp weights and batch through the JAX package's
    ``compile_loop(fn, carry, *consts)`` on its proxy and the port's on
    the port's: a one-step call, bursts and a chain, 8 steps in all. The
    losses and parameters agree to the tolerances of the port's one-step
    parity (``tests/test_torch_mnist.py``: the loss to 1e-6 relative,
    parameters to 2·lr a step everywhere), here over eight steps."""
    params, batch = _jax_tiny()
    jopt = jax_fused_adam(LR)
    jstep = jax_train_step(jtiny.loss_fn, jopt)

    def jfn(carry, x, y):
        p, s, loss = jstep(*carry, (x, y))
        return (p, s), loss

    jp = JaxChipProxy(scheduler=JaxScheduler(WINDOW, BASE, MIN))
    jp.serve()
    p = make_proxy()
    try:
        jc = JaxProxyClient("127.0.0.1", jp.port, "jloop", 0.5, 1.0)
        jcarry = jc.put_tree((params, jax.tree_util.tree_map(
            np.asarray, jopt.init(jax.tree_util.tree_map(jnp.asarray,
                                                         params)))))
        jb = jc.put_tree(batch)
        jloop = jc.compile_loop(jfn, jcarry, *jb)
        jcarry, jsteps, jlosses = _run_loop(jc, jloop, jcarry, jb, PLAN)

        c = connect(p, "tloop")
        tp = convert.params_from_jax(params)
        carry = c.put_tree((tp, fused_adam(LR).init(
            common.to_device(tp, "cpu"))))
        b = c.put_tree(batch)
        loop = c.compile_loop(_loop_fn, carry, *b)
        carry, steps, losses = _run_loop(c, loop, carry, b, PLAN)

        assert steps == jsteps == 8
        assert losses[0][0] == jlosses[0][0] == 1
        got = dict(losses)
        for n, jl in jlosses:
            if n in got:
                assert got[n] == pytest.approx(jl, rel=1e-6)
        assert 8 in got and 8 in dict(jlosses)
        jparams = jc.get_tree(jcarry[0])
        tparams = convert.params_to_jax(c.get_tree(carry[0]))
        for a, t in zip(jax.tree_util.tree_leaves(jparams),
                        jax.tree_util.tree_leaves(tparams)):
            np.testing.assert_allclose(np.asarray(t), np.asarray(a), rtol=0,
                                       atol=2 * LR * 8 + 1e-6)
        exe = p._sessions["tloop"].executables[loop._exec_id]
        assert exe.ncarry == len(tree_leaves(carry))
        jc.close()
        c.close()
    finally:
        p.close()
        jp.close()


def test_a_looped_step_equals_the_same_step_one_call_at_a_time(proxy):
    """The loop program over the in-place step: the same start, run one
    call at a time and in chained bursts, gives the same losses and
    parameters bit for bit, and the eager step's."""
    c = connect(proxy, "bits")
    p, s, b = _put_start(c)
    loop = c.compile_loop(_loop_fn, (p, s), *b)
    carry, _, one = _run_loop(c, loop, (p, s), b, [("one", 8)])
    p, s, _ = _put_start(c)
    carry2, steps, chained = _run_loop(c, loop, (p, s), b,
                                       [("one", 1), ("chain", 7)])
    assert steps == 8 and len(chained) < 8
    assert set(chained) <= set(one)
    want, losses = _eager_params(8)
    assert [l for _, l in one] == losses
    _assert_params(c, carry[0], want)
    _assert_params(c, carry2[0], want)
    c.close()


def test_compile_loop_pins_the_carry_structure(proxy):
    c = connect(proxy, "shape")
    p, s, b = _put_start(c)
    with pytest.raises(TypeError, match="loop fn must preserve carry "
                                        "structure"):
        c.compile_loop(lambda carry, x, y: (carry[0], x.sum()), (p, s), *b)
    with pytest.raises(TypeError, match="device-resident"):
        c.compile_loop(_loop_fn, (p, s), *_host_start()[2])
    c.close()


def test_a_saved_loop_program_is_held_to_its_carry(proxy):
    """The proxy checks a saved loop program's carry: its first ``ncarry``
    outputs have its first ``ncarry`` inputs' shapes and dtypes."""
    from kubeshare_tpu_torch.isolation import exported

    c = connect(proxy, "carry")
    x = c.put(np.zeros(4, np.float32))
    blob = exported.export_program(lambda t: (t.sum(),), (x,), "cpu")[0]
    with pytest.raises(RuntimeError, match="carry"):
        c._conn.call({"op": "compile", "name": "carry", "ncarry": 1},
                      blob=[blob])
    c.close()


def test_the_journal_restores_a_loop_mid_training(tmp_path):
    """A crash between chained bursts of the loop program: the restarted
    proxy restores the saved loop program and its carry, and training
    goes on to the parameters of the uncrashed run."""
    p1 = make_proxy(tmp_path)
    c = ProxyClient("127.0.0.1", p1.port, "looped", 0.5, 1.0,
                    reconnect=PATIENT)
    p, s, b = _put_start(c)
    loop = c.compile_loop(_loop_fn, (p, s), *b)
    carry, steps, _ = _run_loop(c, loop, (p, s), b, [("one", 1),
                                                     ("chain", 3)])
    p1.crash(wait=True)
    p2 = make_proxy(tmp_path)
    c.set_endpoint("127.0.0.1", p2.port)
    carry, more, _ = _run_loop(c, loop, carry, b, [("chain", 4)])
    want, _ = _eager_params(steps + more)
    _assert_params(c, carry[0], want)
    c.close()
    p2.close()
    p1.close()
