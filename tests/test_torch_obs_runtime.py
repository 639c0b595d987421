"""The observability plane fed by the port's runtime, against the JAX
package's where both run the same script.

- the wire: a trace id crosses both packages' framed-JSON wire, lockstep
  and pipelined, into the server's ``state["trace_id"]``;
- the token scheduler: the JAX façade and the port's, each with a
  chip-time ledger, a blame graph and virtual clocks, driven by the same
  acquire/renew/release/mark/timeout trace on the native core and on
  ``PyTokenCore``, give equal ledger snapshots, blame edges and family
  renders;
- the slice: a CPU ``ChipProxy`` with a best-effort chain and a latency
  client under a ``PreemptionPolicy``, each traced — the ledger is
  sound, blame names the trainer with a ``preempted`` edge, the spans
  carry their trace ids across the wire (lockstep and pipelined), and
  critpath splits the latency request without double counting;
- resilience: resume, detach and replay counters, the flight notes, the
  reconnect and migration spans, the journal's bytes.
"""

import threading
import time
import types

import numpy as np
import pytest
import torch

from kubeshare_tpu.isolation import protocol as jprotocol
from kubeshare_tpu.isolation import tokensched as jts
from kubeshare_tpu.obs import blame as jblame
from kubeshare_tpu.obs import ledger as jledger
from kubeshare_tpu.obs import metrics as jmetrics
from kubeshare_tpu.obs import trace as jtrace
from kubeshare_tpu.preempt.policy import PreemptionPolicy as JaxPolicy
from kubeshare_tpu_torch.isolation import protocol, tokensched
from kubeshare_tpu_torch.isolation.client import ExecutionGate, ProxyClient
from kubeshare_tpu_torch.isolation.proxy import ChipProxy
from kubeshare_tpu_torch.isolation.tokensched import TokenScheduler
from kubeshare_tpu_torch.models import common, tinymlp
from kubeshare_tpu_torch.obs import blame as pblame
from kubeshare_tpu_torch.obs import critpath, flight
from kubeshare_tpu_torch.obs import ledger as pledger
from kubeshare_tpu_torch.obs import metrics as pmetrics
from kubeshare_tpu_torch.obs import trace as ptrace
from kubeshare_tpu_torch.ops.fused_adam import fused_adam
from kubeshare_tpu_torch.preempt import PreemptionPolicy
from kubeshare_tpu_torch.resilience import faults
from kubeshare_tpu_torch.resilience.migrate import migrate_session
from kubeshare_tpu_torch.resilience.reconnect import ReconnectPolicy

MIN = 10.0
FAST = ReconnectPolicy(max_attempts=8, base_delay_s=0.02, max_delay_s=0.2,
                       dial_timeout_s=1.0, seed=7)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # the suite runs in parallel workers: keep torch's CPU kernels from
    # taking every core from the timing-sensitive tests of other workers
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def tracer():
    tr = ptrace.install_tracer(ptrace.Tracer())
    yield tr
    ptrace.uninstall_tracer()


def _wait_until(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.002)
    return pred()


def _lines(registry, family, label, value):
    """A family's sample lines whose ``label`` is ``value``."""
    fam = registry.get(family)
    if fam is None:
        return []
    return [line for line in fam.render() if not line.startswith("#")
            and '%s="%s"' % (label, value) in line]


# -- the wire -----------------------------------------------------------------

@pytest.mark.parametrize("client_pkg,server_pkg", [
    ("port", "port"), ("port", "jax"), ("jax", "port")])
@pytest.mark.parametrize("pipelined", [False, True])
def test_the_trace_id_crosses_the_wire_into_the_servers_state(
        client_pkg, server_pkg, pipelined):
    server_mod = protocol if server_pkg == "port" else jprotocol
    client_mod = protocol if client_pkg == "port" else jprotocol

    def handle(req, state):
        return {"ok": True, "trace": state.get("trace_id", ""),
                "leaked": protocol.TRACE_KEY in req}

    srv = server_mod.serve_framed("127.0.0.1", 0, handle)
    try:
        conn = client_mod.Connection("127.0.0.1", srv.server_address[1],
                                     trace_id="tid-wire")
        if pipelined:
            conn.start_pipeline()
        reply, _ = conn.call({"op": "x"})
        assert reply["trace"] == "tid-wire" and not reply["leaked"]
        # a message's own _trace wins over the connection's
        reply, _ = conn.call({"op": "x", "_trace": "tid-own"})
        assert reply["trace"] == "tid-own"
        conn.trace_id = ""
        reply, _ = conn.call({"op": "x"})
        assert reply["trace"] == "tid-own"       # the state keeps the last
        conn.close()
    finally:
        srv.shutdown()
        srv.server_close()
    assert protocol.TRACE_KEY == jprotocol.TRACE_KEY == "_trace"


def test_the_wire_records_its_three_families():
    reg = pmetrics.default_registry()
    busy = reg.get("kubeshare_transport_handler_busy_seconds_total")
    before = busy.value("obs-wire-op") if busy is not None else 0.0
    srv = protocol.serve_framed("127.0.0.1", 0,
                                lambda req, state: {"ok": True})
    try:
        conn = protocol.Connection("127.0.0.1", srv.server_address[1])
        conn.start_pipeline()
        for rep in [conn.submit({"op": "obs-wire-op"}) for _ in range(20)]:
            rep.result()
        conn.close()
    finally:
        srv.shutdown()
        srv.server_close()
    wait = reg.get("kubeshare_transport_dispatch_wait_seconds")
    assert any('le="+Inf",op="obs-wire-op"} 20' in line
               for line in wait.render())
    assert reg.get("kubeshare_transport_handler_busy_seconds_total").value(
        "obs-wire-op") > before
    assert _wait_until(lambda: reg.get(
        "kubeshare_transport_inflight_requests").value() >= 0.0)
    for fam in ("kubeshare_transport_inflight_requests",
                "kubeshare_transport_dispatch_wait_seconds",
                "kubeshare_transport_handler_busy_seconds_total"):
        assert jmetrics.default_registry().get(fam).help_text == \
            reg.get(fam).help_text


# -- the token scheduler on virtual clocks -------------------------------------

class FakeTime(types.SimpleNamespace):
    """A ``time`` module whose monotonic clock is virtual seconds; every
    other name is the real module's."""

    def __init__(self, now):
        super().__init__(now=now)

    def monotonic(self):
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


def _thread(fn, *args, **kw):
    out = {}

    def run():
        try:
            out["value"] = fn(*args, **kw)
        except Exception as e:
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, out


def _drive(pkg, core, chip, monkeypatch):
    """One acquire/renew/release/mark/timeout trace on virtual clocks: a
    latency waiter preempts a best-effort holder, the holder's credit,
    a best-effort timeout, an external mark and a removed holder."""
    if pkg == "port":
        mod, lmod, bmod, pol = tokensched, pledger, pblame, PreemptionPolicy
    else:
        mod, lmod, bmod, pol = jts, jledger, jblame, JaxPolicy
    fake = FakeTime(1.0)
    monkeypatch.setattr(mod, "time", fake)
    ledger = lmod.ChipTimeLedger(clock=lambda: fake.now)
    blame = bmod.BlameGraph(ledger)
    sched = mod.TokenScheduler(
        1000.0, 100.0, MIN, native=core == "native",
        clock=lambda: fake.now * 1000.0, chip=chip, ledger=ledger,
        blame=blame, ledger_clock=lambda: fake.now,
        preempt=pol(grace_ms=5.0, min_hold_ms=1.0))
    a, b, c = "ns-a/p", "ns-b/p", "ns-c/p"
    sched.add_client(a, 0.5, 1.0)
    sched.add_client(b, 0.4, 1.0, tpu_class="latency")
    sched.add_client(c, 0.1, 1.0)
    waits = []

    def at(t):
        fake.now = t

    sched.acquire(a, trace_id="ta")
    at(1.001)
    sched.execute_begin()
    at(1.009)
    sched.execute_end()
    tb, ob = _thread(sched.acquire, b, trace_id="tb")
    assert _wait_until(lambda: b in sched.waiting())
    at(1.030)                           # b is past its grace: a is marked
    assert _wait_until(lambda: sched.preempted(a))
    at(1.031)
    sched.execute_begin()
    at(1.040)
    sched.execute_end()
    ta2, oa2 = _thread(sched.renew, a, 35.0, trace_id="ta")
    tb.join(10.0)
    waits.append(ob)
    at(1.045)
    sched.execute_begin()
    at(1.050)
    sched.execute_end()
    tc, oc = _thread(sched.acquire, c, timeout=0.02, trace_id="tc")
    assert _wait_until(lambda: c in sched.waiting())
    at(1.052)
    sched.release(b, 7.0)               # a's credit comes back
    ta2.join(10.0)
    waits.append(oa2)
    at(1.080)                           # c's deadline passes
    tc.join(10.0)
    waits.append(oc)
    at(1.090)
    sched.release(a, 5.0)
    at(1.095)
    sched.acquire(c, trace_id="tc")
    at(1.100)
    sched.release(c, 5.0)
    at(1.200)
    sched.acquire(a)
    at(1.210)
    sched.mark_preempted(a)
    at(1.250)
    sched.release(a, 50.0)
    at(1.300)
    sched.acquire(c)
    at(1.310)
    sched.remove_client(c)              # a removed holder: the hold ends
    at(1.400)
    out = {
        "waits": [sorted(o) for o in waits],
        "timeout": type(oc.get("error")).__name__,
        "ledger": ledger.snapshot(),
        "check": ledger.check(),
        "edges": blame.edges(),
        "victims": blame.victims(),
        "clients": {n: (v["class"], v["holding"]) for n, v in
                    sched.accounting()["clients"].items()},
        "policy": sched.preempt.snapshot()["stats"],
    }
    sched.close()
    return out


def _approx(a, b, tol=1e-9):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (a, b)
        for k in a:
            _approx(a[k], b[k], tol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _approx(x, y, tol)
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= tol, (a, b)
    else:
        assert a == b, (a, b)


@pytest.mark.parametrize("core", ["native", "python"])
def test_the_scheduler_feeds_ledger_blame_and_families_as_jax(
        core, monkeypatch):
    chip = "obs-sched-%s" % core
    jtracer = jtrace.install_tracer(jtrace.Tracer())
    ptracer = ptrace.install_tracer(ptrace.Tracer())
    try:
        port = _drive("port", core, chip, monkeypatch)
        jax = _drive("jax", core, chip, monkeypatch)
    finally:
        jtrace.uninstall_tracer()
        ptrace.uninstall_tracer()
    _approx(port, jax)
    assert port["check"] == []
    assert port["timeout"] == "TimeoutError"
    edges = {(e["victim"], e["blamed"]): e for e in port["edges"]}
    assert edges[("ns-b", "ns-a")]["kind"] == "preempted"
    assert edges[("ns-b", "ns-a")]["trace_ids"] == ["tb"]
    assert edges[("ns-c", "ns-b")]["kind"] == "hold"
    # the external mark is no decision of the policy's; both marked
    # holders yield
    assert port["policy"]["preemptions"] == 1
    assert port["policy"]["yields"] == 2
    for family, label in (
            ("kubeshare_token_grant_wait_seconds", "chip"),
            ("kubeshare_token_hold_seconds", "chip"),
            ("kubeshare_token_utilization_ratio", "chip"),
            ("kubeshare_blame_wait_seconds_total", "chip")):
        got = _lines(pmetrics.default_registry(), family, label, chip)
        assert got and got == _lines(jmetrics.default_registry(), family,
                                     label, chip), family

    def grants(tr):
        return sorted((s.trace_id, round(s.duration_ms, 6),
                       s.attrs["client"], s.attrs["chip"])
                      for s in tr.spans() if s.name == "token-grant"
                      and s.attrs.get("chip") == chip)

    assert grants(ptracer) == grants(jtracer)
    assert ("tb", 31.0, "ns-b/p", chip) in grants(ptracer)


def test_the_tracked_condition_keeps_the_grant_order():
    """Three waiters at equal virtual time are granted by name, on both
    cores, with the tracked condition under the façade."""
    for native in (True, False):
        sched = TokenScheduler(1000.0, 100.0, MIN, native=native)
        assert type(sched._cond).__name__ == "TrackedCondition"
        for n in ("c", "a", "b", "h"):
            sched.add_client(n, 0.2, 1.0)
        sched.acquire("h")
        threads = [_thread(sched.acquire, n) for n in ("c", "a", "b")]
        assert _wait_until(lambda: len(sched.waiting()) == 3)
        order = []
        holder = "h"
        for _ in range(3):
            sched.release(holder, 1.0)
            assert _wait_until(lambda: any(
                v["holding"] for v in sched.accounting()["clients"].values()))
            holder = next(n for n, v in sched.accounting()["clients"].items()
                          if v["holding"])
            order.append(holder)
        assert order == ["a", "b", "c"]
        for t, _ in threads:
            t.join(5.0)
        sched.close()


def test_a_gate_carries_its_trace_to_the_token_grant(tracer):
    sched = TokenScheduler(1000.0, 100.0, MIN, chip="obs-gate")
    srv = tokensched.serve(sched)
    try:
        gate = ExecutionGate.connect("127.0.0.1", srv.server_address[1],
                                     "ns/g", 0.5, 1.0, barrier=lambda: None,
                                     trace_id="tid-gate")
        gate()
        gate.close()
        (span,) = [s for s in tracer.spans("tid-gate")
                   if s.name == "token-grant"]
        assert span.attrs == {"client": "ns/g", "chip": "obs-gate"}
    finally:
        srv.shutdown()
        srv.server_close()
        sched.close()


def test_a_proxy_without_a_scheduler_feeds_the_process_ledger():
    p = ChipProxy(device="cpu")
    try:
        assert p.scheduler.ledger is pledger.default_ledger()
        assert p.scheduler.blame is pblame.default_blame()
        assert p.scheduler.blame.ledger is pledger.default_ledger()
        assert p.scheduler.chip == "cpu"
    finally:
        p.close()


# -- the slice: a traced chain and a latency client under preemption ----------

def _loop_start(c, seed=0):
    opt = fused_adam(1e-2)
    params = tinymlp.init(seed)
    state = opt.init(common.to_device(params, "cpu"))
    step = common.make_train_step(tinymlp.loss_fn, opt)

    def loop_fn(carry, x, y):
        p, s, loss = step(*carry, (x, y))
        return (p, s), loss

    carry = c.put_tree((params, state))
    consts = c.put_tree(tuple(tinymlp.batch_fn(seed + 1)))
    return c.compile_loop(loop_fn, carry, *consts), carry, consts


@pytest.mark.parametrize("train_mode,serve_mode", [("seq", "lockstep"),
                                                   ("lockstep", "seq")])
def test_the_slice_accounts_blames_and_traces_a_preemption(
        tracer, train_mode, serve_mode):
    ledger = pledger.ChipTimeLedger()
    blame = pblame.BlameGraph(ledger)
    pol = PreemptionPolicy(grace_ms=5.0, min_hold_ms=1.0)
    # the quota outlasts the chain (as in test_torch_preempt.py's
    # slicing case): only the preemption hands the token over
    sched = TokenScheduler(100_000.0, 100_000.0, MIN, chip="obs-slice",
                           ledger=ledger, blame=blame, preempt=pol)
    proxy = ChipProxy(device="cpu", scheduler=sched)
    proxy.serve()
    tids = {"train": "tid-train-" + train_mode,
            "serve": "tid-serve-" + serve_mode}
    try:
        trainer = ProxyClient(
            "127.0.0.1", proxy.port, "train", 0.5, 1.0,
            trace_id=tids["train"],
            reconnect="auto" if train_mode == "seq" else None)
        server = ProxyClient(
            "127.0.0.1", proxy.port, "serve", 0.5, 1.0,
            tpu_class="latency", trace_id=tids["serve"],
            reconnect="auto" if serve_mode == "seq" else None)
        assert trainer._conn.pipelined == (train_mode == "seq")
        assert server._conn.pipelined == (serve_mode == "seq")
        loop, carry, consts = _loop_start(trainer)
        bx = server.put(np.ones(8, dtype=np.float32))
        exe = server.compile(lambda a: a * 2.0, bx)
        carry, _ = loop.chain(128, carry, *consts)     # the cost model
        cost = next(iter(proxy._costs.values()))
        steps = int(1000.0 / max(cost.loop_step_ms, 1e-3))
        t, out = _thread(loop.chain, steps, carry, *consts)
        assert _wait_until(
            lambda: sched.accounting()["clients"]["train"]["holding"])
        t0 = tracer.now_ms()
        np.testing.assert_array_equal(server.get(exe(bx)), np.full(8, 2.0))
        tracer.record("request", tids["serve"], t0, tracer.now_ms())
        t.join(120.0)
        assert "value" in out, out
        trainer.close()
        server.close()
    finally:
        proxy.close()
    assert pol.snapshot()["stats"]["preemptions"] >= 1
    assert ledger.check() == []
    edges = {(e["victim"], e["blamed"]): e for e in blame.edges()}
    edge = edges[("serve", "train")]
    assert edge["kind"] == "preempted" and edge["preempted_s"] > 0.0
    assert tids["serve"] in edge["trace_ids"]
    assert blame.total_attributed_s() <= sum(
        v["waited_s"] for v in blame.victims().values()) + 1e-9
    by = {(s.trace_id, s.name): s for s in tracer.spans()}
    for who, tid in tids.items():
        assert (tid, "token-grant") in by, who
        assert by[(tid, "token-grant")].attrs["client"] == who
        assert by[(tid, "execute")].attrs["proc"] == "chipproxy"
        assert (tid, "transport") in by
    spans = [critpath._span_row(s.to_dict(), "slice")
             for s in tracer.spans()]
    (req,) = critpath.assemble([s for s in spans if s is not None],
                               trace_id=tids["serve"])
    segs = req["segments"]
    assert segs["grant-wait"] > 0.0 and segs["execute"] > 0.0
    assert sum(segs.values()) <= req["wall_ms"] * 1.01
    assert req["coverage"] > 0.5


# -- serving with per-batch traces ---------------------------------------------

def test_a_served_batch_carries_its_head_requests_trace(tracer):
    from kubeshare_tpu_torch.serving import (ContinuousBatcher, FrontDoor,
                                             ProxyServable)
    from kubeshare_tpu_torch.obs.slo import SloEvaluator

    proxy = ChipProxy(device="cpu",
                      scheduler=TokenScheduler(1000.0, 100.0, MIN))
    proxy.serve()
    try:
        client = ProxyClient("127.0.0.1", proxy.port, "serve/s", 0.5, 1.0,
                             trace_id="tid-session")
        servable = ProxyServable(client, seed=3)
        slo = SloEvaluator(fast_window_s=1.0, slow_window_s=2.0,
                           min_samples=1)
        clock = [100.0]
        fd = FrontDoor(clock=lambda: clock[0], slo=slo)
        fd.register_tenant("t", tpu_class="latency",
                           slo_spec="serve-p99<=1ms,serve-availability>=99")
        b = ContinuousBatcher(fd, servable, max_wait_s=0.001,
                              clock=lambda: clock[0])
        req = fd.submit("t", np.ones((1, tinymlp.FEATURES), np.float32),
                        trace_id="tid-head")
        clock[0] += 0.5                  # past the bound: a bad sample
        assert b.step() == 1
        assert req.result(timeout=10.0).shape[0] == 1
        names = {s.name for s in tracer.spans("tid-head")}
        assert {"serve-batch", "token-grant", "execute",
                "transport"} <= names
        events = slo.evaluate(now=clock[0])
        assert [(e.tenant, e.objective, e.state) for e in events] == \
            [("t", "serve-p99<=1ms", "firing")]
        client.close()
    finally:
        proxy.close()


def test_an_untraced_batch_after_a_traced_one_keeps_to_its_own_trace(
        tracer):
    """A batch whose head request carries no trace runs under a trace of
    its own: its grant and execute spans do not land on the previous
    batch's head request, on the lockstep and the pipelined wire."""
    from kubeshare_tpu_torch.serving import (ContinuousBatcher, FrontDoor,
                                             ProxyServable)

    proxy = ChipProxy(device="cpu",
                      scheduler=TokenScheduler(1000.0, 100.0, MIN))
    proxy.serve()
    try:
        for reconnect in (None, "auto"):
            client = ProxyClient("127.0.0.1", proxy.port,
                                 "serve/s-%s" % reconnect, 0.5, 1.0,
                                 reconnect=reconnect)
            servable = ProxyServable(client, seed=3)
            fd = FrontDoor()
            fd.register_tenant("t", tpu_class="latency")
            b = ContinuousBatcher(fd, servable, max_wait_s=0.0)
            x = np.ones((1, tinymlp.FEATURES), np.float32)
            head = "tid-first-%s" % reconnect
            fd.submit("t", x, trace_id=head)
            assert b.step(force=True) == 1
            untraced = fd.submit("t", x)
            assert b.step(force=True) == 1
            assert untraced.result(timeout=10.0).shape[0] == 1
            names = [s.name for s in tracer.spans(head)]
            assert names.count("execute") == 1
            assert names.count("serve-batch") == 1
            assert names.count("token-grant") <= 1
            second = [s for s in tracer.spans() if s.name == "serve-batch"
                      and s.trace_id != head][-1].trace_id
            assert second and "execute" in [
                s.name for s in tracer.spans(second)]
            client.close()
    finally:
        proxy.close()


# -- resilience ----------------------------------------------------------------

def test_resumes_detaches_replays_and_reconnect_spans_are_counted(
        tmp_path, tracer):
    reg = pmetrics.default_registry()
    resumes = reg.get("kubeshare_proxy_session_resumes_total")
    detaches = reg.get("kubeshare_proxy_session_detaches_total")
    reconnects = reg.get("kubeshare_resilience_reconnects_total")
    r0, d0 = resumes.value(), detaches.value()
    k0 = reconnects.value("resumed")
    proxy = ChipProxy(device="cpu",
                      scheduler=TokenScheduler(1000.0, 100.0, MIN),
                      journal_dir=str(tmp_path / "j"))
    proxy.serve()
    try:
        c = ProxyClient("127.0.0.1", proxy.port, "obs-res", 0.5, 1.0,
                        reconnect=FAST, fault_tag="obs-victim",
                        chunk_bytes=8192, trace_id="tid-res")
        faults.install(faults.Injector(faults.FaultSpec(
            kill_conn_after_frames=4, kill_conn_tag="obs-victim")))
        big = np.arange(65536, dtype=np.float32).reshape(256, 256)
        buf = c.put(big)
        faults.uninstall()
        np.testing.assert_array_equal(c.get(buf), big)
        resumed = c.transport()["resumes"]
        assert resumed >= 1
        assert resumes.value() - r0 == resumed
        assert detaches.value() - d0 == resumed
        assert reconnects.value("resumed") - k0 == resumed
        (span, *_) = [s for s in tracer.spans("tid-res")
                      if s.name == "reconnect"]
        assert span.attrs["attempts"] >= 1
        notes = [(e["event"], e["attrs"]["trace_id"])
                 for e in flight.default_recorder().ring()
                 if e["kind"] == "note"
                 and e["attrs"].get("client") == "obs-res"]
        assert ("session-detached", "tid-res") in notes
        assert ("session-resumed", "tid-res") in notes
        gauge = reg.get("kubeshare_proxy_journal_bytes")
        assert gauge.value() == float(proxy.journal.size())
        c.close()
    finally:
        faults.uninstall()
        proxy.close()


def test_a_migration_is_counted_timed_and_traced(tracer):
    reg = pmetrics.default_registry()
    moved0 = reg.get("kubeshare_migrations_total").value("moved")
    p1 = ChipProxy(device="cpu", scheduler=TokenScheduler(1000.0, 100.0, MIN))
    p2 = ChipProxy(device="cpu", scheduler=TokenScheduler(1000.0, 100.0, MIN))
    p1.serve()
    p2.serve()
    try:
        c = ProxyClient("127.0.0.1", p1.port, "obs-mover", 0.5, 1.0,
                        reconnect=FAST)
        bx = c.put(np.arange(64, dtype=np.float32))
        res = migrate_session(("127.0.0.1", p1.port), ("127.0.0.1", p2.port),
                              c._conn.token, trace_id="tid-move")
        np.testing.assert_array_equal(c.get(bx), np.arange(64))
        assert reg.get("kubeshare_migrations_total").value("moved") == \
            moved0 + 1
        spans = tracer.spans("tid-move")
        (mig,) = [s for s in spans if s.name == "migrate"]
        assert mig.attrs["outcome"] == "moved"
        assert mig.attrs["buffers"] == len(res["buffers"])
        subs = [s for s in spans if s.name == "migrate.buffer"]
        assert subs and all(s.parent_id == mig.span_id for s in subs)
        failed0 = reg.get("kubeshare_migrations_total").value("failed")
        with pytest.raises(Exception):
            migrate_session(("127.0.0.1", p1.port), ("127.0.0.1", p2.port),
                            "0" * 32, trace_id="tid-move-bad")
        assert reg.get("kubeshare_migrations_total").value("failed") == \
            failed0 + 1
        c.close()
    finally:
        p1.close()
        p2.close()
