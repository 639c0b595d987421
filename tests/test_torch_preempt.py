"""The port's preemption plane against the JAX package's: the policy, the
boundary slicer, the token scheduler's directed grants, the wire, and
program-boundary slicing through a CPU ``ChipProxy``.

Mirrors the non-gang cases of ``tests/test_preempt.py`` (the ledger and
blame cases wait for the port's obs plane, the gang cases for its gang
coordinator, the contention replay for its simulator); adds the cases of
a session's class through the journal and a migration, a waiter that
preempts on time, and a latency client slicing a best-effort chain.
"""

import itertools
import threading
import time

import numpy as np
import pytest
import torch

from kubeshare_tpu.isolation import tokensched as jts
from kubeshare_tpu.preempt import BoundarySlicer as JaxSlicer
from kubeshare_tpu.preempt import PreemptionPolicy as JaxPolicy
from kubeshare_tpu.preempt.policy import class_priority as jax_priority
from kubeshare_tpu_torch import constants as C
from kubeshare_tpu_torch.isolation import protocol, tokensched
from kubeshare_tpu_torch.isolation.client import ProxyClient
from kubeshare_tpu_torch.isolation.proxy import ChipProxy
from kubeshare_tpu_torch.isolation.tokensched import TokenScheduler
from kubeshare_tpu_torch.models import common, tinymlp
from kubeshare_tpu_torch.ops.fused_adam import fused_adam
from kubeshare_tpu_torch.preempt import (CLASS_PRIORITY, BoundarySlicer,
                                         PreemptionPolicy)
from kubeshare_tpu_torch.preempt.policy import class_priority
from kubeshare_tpu_torch.resilience.migrate import migrate_session
from kubeshare_tpu_torch.resilience.reconnect import ReconnectPolicy
from kubeshare_tpu_torch.utils.tree import tree_leaves

WINDOW = 1000.0
BASE = 100.0
MIN = 10.0
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


# -- policy core --------------------------------------------------------------

CLASSES = ("latency", "best-effort", "", None, "mystery")


def test_should_preempt_matrix_equals_the_jax_policy():
    """Over a grid of classes, waits, holds and settings the port's
    decision is the JAX policy's, and the JAX test's cases hold."""
    for grace, hold, enabled in itertools.product((0.0, 5.0, 7.5),
                                                  (0.0, 2.0), (True, False)):
        port = PreemptionPolicy(grace_ms=grace, min_hold_ms=hold,
                                enabled=enabled)
        ref = JaxPolicy(grace_ms=grace, min_hold_ms=hold, enabled=enabled)
        for w, h, waited, held in itertools.product(
                CLASSES, CLASSES, (0.0, 4.0, 5.0, 6.0, 60.0),
                (0.0, 1.0, 2.0, 3.0, 30.0)):
            assert port.should_preempt(w, h, waited, held) == \
                ref.should_preempt(w, h, waited, held), (w, h, waited, held)
    pol = PreemptionPolicy(grace_ms=5.0, min_hold_ms=2.0)
    assert pol.should_preempt("latency", "best-effort", 6.0, 3.0)
    assert not pol.should_preempt("latency", "best-effort", 4.0, 3.0)
    assert not pol.should_preempt("latency", "best-effort", 6.0, 1.0)
    assert not pol.should_preempt("latency", "latency", 60.0, 30.0)
    assert not pol.should_preempt("best-effort", "best-effort", 60.0, 30.0)
    assert not pol.should_preempt("best-effort", "latency", 60.0, 30.0)
    off = PreemptionPolicy(enabled=False)
    assert not off.should_preempt("latency", "best-effort", 60.0, 30.0)


def test_class_priority_defaults():
    assert CLASS_PRIORITY["latency"] > CLASS_PRIORITY["best-effort"]
    for cls in CLASSES:
        assert class_priority(cls) == jax_priority(cls)
    assert class_priority("") == CLASS_PRIORITY["best-effort"]
    assert class_priority(None) == CLASS_PRIORITY["best-effort"]
    assert class_priority("mystery") == CLASS_PRIORITY["best-effort"]
    assert C.TPU_CLASSES == ("latency", "best-effort")
    assert C.POD_CLASS == "sharedtpu/class"


def test_policy_snapshot_counts():
    snaps = []
    for cls in (PreemptionPolicy, JaxPolicy):
        pol = cls(grace_ms=7.0)
        pol.note_preemption("chip0", "flood", "latency", "best-effort")
        pol.note_yield("chip0", 0.004, 55.0)
        pol.note_yield("chip0", 0.001, -3.0)
        pol.note_boost_grant("chip0")
        pol.note_boost_grant("chip0", credit=True)
        pol.note_gang_preemption("ring-a", "ring-b")
        snaps.append(pol.snapshot())
    assert snaps[0] == snaps[1]
    snap = snaps[0]
    assert snap["enabled"] and snap["grace_ms"] == 7.0
    s = snap["stats"]
    assert s["preemptions"] == 1 and s["gang_preemptions"] == 1
    assert s["boost_grants"] == 2 and s["credits_repaid"] == 1
    assert s["yields"] == 2 and s["reclaimed_ms"] == pytest.approx(55.0)
    assert s["by_tenant"] == {"flood": 1}


# -- boundary slicer ----------------------------------------------------------

class _FakeSched:
    def __init__(self):
        self.flagged = set()

    def preempted(self, name):
        return name in self.flagged


def test_slicer_never_yields_mid_execute():
    answers = []
    for cls in (BoundarySlicer, JaxSlicer):
        sched = _FakeSched()
        sl = cls(sched)
        sched.flagged.add("w")
        got = [sl.should_yield("w")]
        sl.execute_begin("w")
        got.append(sl.should_yield("w"))          # mid-execute: never
        sl.execute_end("w")
        got.append(sl.should_yield("w"))
        sl.note_yield("w")
        got.append(sl.stats())
        sl.execute_begin("w")
        sl.note_yield("w")                        # a contract breach
        got.append(sl.stats())
        sl.execute_end("w")
        answers.append(got)
    assert answers[0] == answers[1]
    assert answers[0][:3] == [True, False, True]
    assert answers[0][3] == {"checks": 3, "yields": 1,
                             "mid_execute_yields": 0}
    assert answers[0][4]["mid_execute_yields"] == 1


def test_slicer_refcounts_nested_executes():
    sched = _FakeSched()
    sched.flagged.add("w")
    sl = BoundarySlicer(sched)
    sl.execute_begin("w")
    sl.execute_begin("w")
    sl.execute_end("w")
    assert not sl.should_yield("w")      # still inside one execute
    assert sl._in_execute.get("w", 0) == 1
    sl.execute_end("w")
    assert sl._in_execute.get("w", 0) == 0
    assert sl.should_yield("w")
    # no scheduler, or one without preempted(): slicing is off
    assert not BoundarySlicer(None).should_yield("w")


# -- TokenScheduler integration -----------------------------------------------

def _wait_until(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.005)
    return pred()


def test_directed_grant_overrides_fifo():
    """``add_boost`` targets the next grant regardless of arrival order —
    the beneficiary half of the preemption handshake."""
    sched = TokenScheduler(WINDOW, BASE, MIN)
    for n in ("a", "b", "c"):
        sched.add_client(n, 0.3, 1.0)
    sched.acquire("a", timeout=2.0)
    order = []
    lock = threading.Lock()

    def waiter(name):
        sched.acquire(name, timeout=5.0)
        with lock:
            order.append(name)
        sched.release(name, 1.0)

    tb = threading.Thread(target=waiter, args=("b",))
    tb.start()
    assert _wait_until(lambda: "b" in sched.waiting())
    tc = threading.Thread(target=waiter, args=("c",))
    tc.start()
    assert _wait_until(lambda: "c" in sched.waiting())
    sched.add_boost("c")                 # c must beat the earlier waiter b
    sched.release("a", 1.0)
    tb.join(timeout=5.0)
    tc.join(timeout=5.0)
    assert not tb.is_alive() and not tc.is_alive()
    assert order == ["c", "b"]


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_preemption_end_to_end_single_chip(native):
    """A latency waiter behind a best-effort holder past grace: the holder
    is marked, yields at its next program boundary forfeiting the rest of
    its quantum, the waiter is granted next, and the holder regains the
    device through its anti-starvation credit."""
    pol = PreemptionPolicy(grace_ms=3.0, min_hold_ms=1.0)
    sched = TokenScheduler(WINDOW, BASE, MIN, native=native, chip="chipA",
                           preempt=pol)
    sched.add_client("flood", 0.5, 1.0, tpu_class="best-effort")
    sched.add_client("lat", 0.5, 1.0, tpu_class="latency")
    events = []
    lock = threading.Lock()
    stop = threading.Event()

    def flood():
        sched.acquire("flood", timeout=5.0)
        used = 0.0
        while not stop.is_set():
            time.sleep(0.002)             # one "program step"
            used += 2.0
            if sched.preempted("flood"):  # the boundary check
                with lock:
                    events.append("flood-yield")
                sched.renew("flood", used, timeout=5.0)
                used = 0.0
        sched.release("flood", used)

    def lat():
        time.sleep(0.02)                  # flood takes and holds the device
        for _ in range(3):
            sched.acquire("lat", timeout=5.0)
            with lock:
                events.append("lat-grant")
            time.sleep(0.001)
            sched.release("lat", 1.0)
            time.sleep(0.005)

    tf = threading.Thread(target=flood)
    tl = threading.Thread(target=lat)
    tf.start()
    tl.start()
    tl.join(timeout=15.0)
    stop.set()
    tf.join(timeout=15.0)
    assert not tl.is_alive() and not tf.is_alive()
    s = pol.snapshot()["stats"]
    assert s["preemptions"] >= 1 and s["yields"] >= 1
    assert s["reclaimed_ms"] > 0.0        # the quantum's rest forfeited
    assert s["boost_grants"] >= 2 and s["credits_repaid"] >= 1
    assert s["by_tenant"]["flood"] == s["preemptions"]
    with lock:
        assert "flood-yield" in events and "lat-grant" in events
    assert sched.accounting()["preempted"] == []


def test_a_waiter_preempts_when_its_grace_runs_out():
    """The waiter re-evaluates the policy when its grace expires, not at
    its next timeout: a holder that never releases is marked within a few
    graces of the wait's start."""
    pol = PreemptionPolicy(grace_ms=40.0, min_hold_ms=0.0)
    sched = TokenScheduler(WINDOW, BASE, MIN, preempt=pol)
    sched.add_client("hog", 0.5, 1.0)
    sched.add_client("lat", 0.5, 1.0, tpu_class="latency")
    sched.acquire("hog")
    got = {}

    def lat():
        try:
            got["quota"] = sched.acquire("lat", timeout=10.0)
        except RuntimeError as e:        # the scheduler closes under it
            got["err"] = e

    t0 = time.monotonic()
    t = threading.Thread(target=lat)
    t.start()
    assert _wait_until(lambda: sched.preempted("hog"), timeout=5.0)
    marked_after = time.monotonic() - t0
    assert 0.035 <= marked_after < 1.0, marked_after
    assert "lat" in sched.waiting()       # marked, not yet granted
    sched.release("hog", 5.0)             # the holder yields
    t.join(timeout=5.0)
    assert not t.is_alive() and got.get("quota", 0) > 0
    assert pol.snapshot()["stats"]["yields"] == 1
    sched.close()


def test_preempt_disabled_grant_path_is_plain_core_poll():
    """With no policy and no boost queued the façade's grant path is
    exactly the core's poll — no cancels, no re-arms."""
    sched = TokenScheduler(WINDOW, BASE, MIN)
    assert sched.preempt is None

    class Spy:
        def __init__(self, core):
            self._core = core

        def cancel_request(self, name):
            raise AssertionError("cancel_request on the disabled path")

        def __getattr__(self, attr):
            return getattr(self._core, attr)

    sched._core = Spy(sched._core)
    sched.add_client("a", 0.5, 1.0)
    sched.add_client("b", 0.5, 1.0)
    order = []
    lock = threading.Lock()

    def worker(name):
        for _ in range(4):
            sched.acquire(name, timeout=5.0)
            with lock:
                order.append(name)
            sched.release(name, 1.0)

    threads = [threading.Thread(target=worker, args=(n,)) for n in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10.0)
    assert len(order) == 8
    assert not sched.preempted("a")
    assert sched.accounting()["preempted"] == []


def test_mark_preempted_requires_holder():
    sched = TokenScheduler(WINDOW, BASE, MIN)
    sched.add_client("a", 0.5, 1.0)
    sched.mark_preempted("a")             # not holding: no-op
    assert not sched.preempted("a")
    sched.acquire("a", timeout=2.0)
    sched.mark_preempted("a")
    assert sched.preempted("a")
    assert sched.accounting()["preempted"] == ["a"]
    sched.release("a", 1.0)               # the release clears the flag
    assert not sched.preempted("a")


# -- wire ---------------------------------------------------------------------

def _preempt_replies(sched, serve):
    server = serve(sched)
    out = []
    try:
        with protocol.Connection("127.0.0.1",
                                 server.server_address[1]) as conn:
            for msg in ({"op": "preempt_state"}, {"op": "preempt_poll"},
                        {"op": "register", "name": "p", "request": 0.5,
                         "limit": 1.0}, {"op": "preempt_poll"}):
                try:
                    out.append(conn.call(msg)[0])
                except RuntimeError as e:
                    out.append(str(e))
    finally:
        server.shutdown()
        sched.close()
    return out


def test_wire_preempt_ops_unknown_without_policy():
    """A scheduler with no policy answers the preempt ops with the
    standard unknown-op error, as the JAX package's does."""
    port = _preempt_replies(TokenScheduler(WINDOW, BASE, MIN),
                            tokensched.serve)
    ref = _preempt_replies(jts.TokenScheduler(WINDOW, BASE, MIN), jts.serve)
    assert port == ref
    assert "unknown op" in port[0] and "unknown op" in port[1]


def test_wire_preempt_ops_with_policy():
    port = _preempt_replies(TokenScheduler(WINDOW, BASE, MIN,
                                           preempt=PreemptionPolicy()),
                            tokensched.serve)
    ref = _preempt_replies(jts.TokenScheduler(WINDOW, BASE, MIN,
                                              preempt=JaxPolicy()),
                           jts.serve)
    assert port == ref
    assert port[0]["state"]["enabled"]
    assert "not bound" in port[1]
    assert port[3] == {"ok": True, "preempted": False}


# -- through the proxy --------------------------------------------------------

def test_proxy_negotiates_preempt_feature_and_slices():
    """The proxy grants "preempt", and a marked holder yields at the next
    program boundary — never in the middle of an execute. The watchdog's
    idle release is set past the test's span, so the session still holds
    the token when it is marked, however slow the host."""
    sched = TokenScheduler(WINDOW, BASE, MIN, preempt=PreemptionPolicy())
    proxy = ChipProxy(device="cpu", scheduler=sched,
                      idle_release_ms=600_000.0)
    proxy.serve()
    try:
        with ProxyClient("127.0.0.1", proxy.port, "flood", 0.5, 1.0) as c:
            assert "preempt" in c.features
            x = np.arange(16, dtype=np.float32)
            bx = c.put(x)
            exe = c.compile(lambda a: a + 1.0, bx)
            np.testing.assert_array_equal(c.get(exe(bx)), x + 1.0)
            assert sched.preempted("flood") is False
            sched.mark_preempted("flood")
            assert sched.preempted("flood")
            np.testing.assert_array_equal(c.get(exe(bx)), x + 1.0)
            stats = proxy.slicer.stats()
            assert stats["yields"] == 1
            assert stats["mid_execute_yields"] == 0
            assert proxy._sessions["flood"].preempt_yields == 1
            assert not sched.preempted("flood")   # the yield cleared it
    finally:
        proxy.close()


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


def _chain_to(loop, steps, carry, consts):
    """Chains until ``steps`` steps ran (a chain may stop early)."""
    ran = 0
    while ran < steps:
        carry, loss = loop.chain(steps - ran, carry, *consts)
        ran += loop.last_n
    return carry, loss


def test_a_latency_client_slices_a_best_effort_chain():
    """A best-effort chain of bursts holds the token; a latency client's
    execute waits past grace and marks it; the chain yields between two
    bursts, the latency execute runs before the chain ends, and the chain
    goes on to compute what an unsliced chain computes. The window and
    the quota (100 s) outlast the chain, whose bursts are powers of two
    that halve what is left of it, so only the preemption hands the
    token over, at the end of the burst in flight. With a quota a slow
    host's burst could outlast (the 1 s of a 1 s window), the marked
    hold would renew at that boundary as a spent quota instead, and no
    yield would be the slicer's."""
    pol = PreemptionPolicy(grace_ms=5.0, min_hold_ms=1.0)
    sched = TokenScheduler(100_000.0, 100_000.0, MIN, preempt=pol)
    proxy = ChipProxy(device="cpu", scheduler=sched)
    proxy.serve()
    try:
        trainer = ProxyClient("127.0.0.1", proxy.port, "train", 0.5, 1.0)
        server = ProxyClient("127.0.0.1", proxy.port, "serve", 0.5, 1.0,
                             tpu_class="latency")
        assert sched.accounting()["clients"]["serve"]["class"] == "latency"
        loop, carry, consts = _loop_start(trainer)
        ref_loop, ref_carry, ref_consts = _loop_start(trainer)
        bx = server.put(np.ones(8, dtype=np.float32))
        exe = server.compile(lambda a: a * 2.0, bx)
        # warm the shared cost model
        ref_carry, _ = _chain_to(ref_loop, 256, ref_carry, ref_consts)
        cost = next(iter(proxy._costs.values()))
        steps = 256 + int(1500.0 / max(cost.loop_step_ms, 1e-3))
        done = {}

        def train():
            done["out"] = loop.chain(steps, carry, *consts)
            done["n"] = loop.last_n
            done["t"] = time.monotonic()

        t = threading.Thread(target=train)
        t.start()
        assert _wait_until(lambda: sched.accounting()["clients"]["train"]
                           ["holding"], timeout=10.0)
        np.testing.assert_array_equal(server.get(exe(bx)), np.full(8, 2.0))
        served_at = time.monotonic()
        t.join(timeout=120.0)
        assert not t.is_alive()
        assert served_at < done["t"]          # served while the chain ran
        s = pol.snapshot()["stats"]
        assert s["preemptions"] >= 1 and s["yields"] >= 1
        assert s["credits_repaid"] >= 1
        stats = proxy.slicer.stats()
        assert stats["yields"] >= 1 and stats["mid_execute_yields"] == 0
        assert proxy._sessions["train"].preempt_yields >= 1
        # the sliced chain computed what an unsliced one computes
        _, loss = done["out"]
        ref_carry, ref_loss = _chain_to(ref_loop, done["n"] - 256,
                                        ref_carry, ref_consts)
        assert float(trainer.get(loss)) == float(trainer.get(ref_loss))
        trainer.close()
        server.close()
    finally:
        proxy.close()


def test_a_sliced_chain_reply_counts_its_slices_only_when_negotiated():
    sched = TokenScheduler(WINDOW, BASE, MIN, preempt=PreemptionPolicy())
    proxy = ChipProxy(device="cpu", scheduler=sched,
                      idle_release_ms=600_000.0)
    proxy.serve()
    try:
        for name, reconnect in (("nego", "auto"), ("lockstep", None)):
            c = ProxyClient("127.0.0.1", proxy.port, name, 0.4, 1.0,
                            reconnect=reconnect)
            loop, carry, consts = _loop_start(c)
            carry, _ = loop.chain(2, carry, *consts)    # holds the token
            assert sched.accounting()["clients"][name]["holding"]
            sched.mark_preempted(name)
            msg = {"op": "execute", "name": name, "exec_id": loop._exec_id,
                   "args": [b.handle for b in tree_leaves((carry, consts))],
                   "chain_steps": 2}
            reply = c._conn.call(msg)[0]
            assert ("sliced" in reply) == (name == "nego"), reply
            if name == "nego":
                assert reply["sliced"] == 1
            c.close()
    finally:
        proxy.close()


# -- the class through the journal and a migration ----------------------------

def test_a_journaled_latency_session_keeps_its_class(tmp_path):
    p1 = ChipProxy(device="cpu", scheduler=TokenScheduler(WINDOW, BASE, MIN),
                   journal_dir=str(tmp_path))
    p1.serve()
    c = ProxyClient("127.0.0.1", p1.port, "lat", 0.5, 1.0,
                    reconnect=PATIENT, tpu_class="latency")
    bx = c.put(np.arange(4, dtype=np.float32))
    assert p1.scheduler.accounting()["clients"]["lat"]["class"] == "latency"
    p1.crash(wait=True)
    p2 = ChipProxy(device="cpu", scheduler=TokenScheduler(WINDOW, BASE, MIN),
                   journal_dir=str(tmp_path))
    p2.serve()
    try:
        assert p2.restored == ["lat"]
        assert p2._sessions["lat"].tpu_class == "latency"
        assert p2.scheduler.accounting()["clients"]["lat"]["class"] == \
            "latency"
        c.set_endpoint("127.0.0.1", p2.port)
        np.testing.assert_array_equal(c.get(bx), np.arange(4))
        c.close()
    finally:
        p2.close()
        p1.close()


def test_a_migrated_latency_session_keeps_its_class():
    procs = [ChipProxy(device="cpu",
                       scheduler=TokenScheduler(WINDOW, BASE, MIN))
             for _ in range(2)]
    for p in procs:
        p.serve()
    p1, p2 = procs
    try:
        c = ProxyClient("127.0.0.1", p1.port, "lat", 0.5, 1.0,
                        reconnect=PATIENT, tpu_class="latency")
        be = ProxyClient("127.0.0.1", p1.port, "be", 0.3, 1.0,
                         reconnect=PATIENT)
        bx = c.put(np.arange(4, dtype=np.float32))
        res = migrate_session(("127.0.0.1", p1.port),
                              ("127.0.0.1", p2.port), c._conn.token)
        assert res["class"] == "latency"
        assert p2._sessions["lat"].tpu_class == "latency"
        assert p2.scheduler.accounting()["clients"]["lat"]["class"] == \
            "latency"
        np.testing.assert_array_equal(c.get(bx), np.arange(4))
        assert c._conn.endpoint == ("127.0.0.1", p2.port)
        assert p1._sessions["be"].tpu_class == "best-effort"
        c.close()
        be.close()
    finally:
        p1.close()
        p2.close()


# -- the class label's default ------------------------------------------------

@pytest.mark.parametrize("surface", ["tokensched", "proxy", "serving"])
def test_missing_class_label_defaults_to_best_effort(surface):
    """A client or tenant registered without a class is best-effort on
    every surface of the port, as in the JAX package."""
    if surface == "tokensched":
        sched = TokenScheduler(WINDOW, BASE, MIN)
        sched.add_client("anon", 0.5, 1.0)
        sched.add_client("fast", 0.3, 1.0, tpu_class="latency")
        acc = sched.accounting()["clients"]
        assert acc["anon"]["class"] == "best-effort"
        assert acc["fast"]["class"] == "latency"
    elif surface == "proxy":
        proxy = ChipProxy(device="cpu",
                          scheduler=TokenScheduler(WINDOW, BASE, MIN))
        proxy.serve()
        try:
            with protocol.Connection("127.0.0.1", proxy.port) as conn:
                conn.call({"op": "register", "name": "anon",
                           "request": 0.5, "limit": 1.0})
                acc = proxy.scheduler.accounting()["clients"]
                assert acc["anon"]["class"] == "best-effort"
                assert proxy._sessions["anon"].tpu_class == "best-effort"
        finally:
            proxy.close()
    else:
        from kubeshare_tpu_torch.serving.frontdoor import FrontDoor

        fd = FrontDoor()
        fd.register_tenant("anon")
        fd.register_tenant("fast", "latency")
        x = np.ones((1, 4), dtype=np.float32)
        fd.submit("anon", x)
        fd.submit("fast", x, tpu_class="latency")
        snap = fd.state()
        assert snap["tenants"]["anon"]["class"] == "best-effort"
        assert snap["tenants"]["fast"]["class"] == "latency"
        batch = fd.pop_batch(max_rows=1)
        assert batch and batch[0].tenant == "fast"
        assert batch[0].tpu_class == "latency"
