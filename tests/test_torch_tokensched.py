"""The port's token scheduler against the JAX package's: both cores (the
native C++ copy, built at first use, and the Python spec), the blocking
façade and the TCP server.

Mirrors ``tests/test_tokensched.py``: every core case runs the same
operations on the port's core and on the JAX package's core of the same
kind and requires the same answers, then the JAX test's own assertions;
the trace cases drive all four cores in lockstep.
"""

import os
import shutil
import threading
import time

import pytest

from kubeshare_tpu.isolation import protocol as jprotocol
from kubeshare_tpu.isolation import tokensched as jts
from kubeshare_tpu_torch.isolation import native, protocol, tokensched
from kubeshare_tpu_torch.isolation.tokensched import (
    NativeTokenCore, PyTokenCore, TokenScheduler, make_core)

WINDOW = 1000.0
BASE = 100.0
MIN = 10.0
INF = float("inf")


def _pair(kind):
    """(port core, JAX core) of one kind."""
    if kind == "py":
        return (PyTokenCore(WINDOW, BASE, MIN),
                jts.PyTokenCore(WINDOW, BASE, MIN))
    return (NativeTokenCore(WINDOW, BASE, MIN),
            jts.NativeTokenCore(WINDOW, BASE, MIN))


@pytest.fixture(params=["py", "native"])
def pair(request):
    port, jax_core = _pair(request.param)
    yield port, jax_core
    port.close()
    jax_core.close()


def _both(pair, scenario):
    """Run ``scenario(core) -> observations`` on both cores; they must
    observe the same. Returns the port's."""
    port, jax_core = pair
    got = scenario(port)
    assert got == scenario(jax_core)
    return got


def _four_cores():
    return [NativeTokenCore(WINDOW, BASE, MIN), PyTokenCore(WINDOW, BASE, MIN),
            jts.NativeTokenCore(WINDOW, BASE, MIN),
            jts.PyTokenCore(WINDOW, BASE, MIN)]


# --- the native build --------------------------------------------------------

def test_native_core_builds_and_is_the_default():
    core = make_core()
    assert isinstance(core, NativeTokenCore)
    assert core.kind == "native"
    assert os.path.exists(native._paths("tokensched")[1])
    sched = TokenScheduler(WINDOW, BASE, MIN)
    assert isinstance(sched.core, NativeTokenCore)
    assert sched.accounting()["core"] == "native"
    py = TokenScheduler(WINDOW, BASE, MIN, native=False)
    assert isinstance(py.core, PyTokenCore)
    assert py.accounting()["core"] == "python"


def test_a_failed_native_build_raises_with_the_compilers_output(
        tmp_path, monkeypatch):
    """Divergence on purpose: the JAX package falls back to Python when
    g++ fails; the port raises, the compiler's words in the error."""
    bad = tmp_path / "tokensched.cpp"
    bad.write_text("int ts_create( { this is not C++\n")
    monkeypatch.setattr(native, "_HERE", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(RuntimeError, match="native build of tokensched "
                                           "failed") as err:
        NativeTokenCore(WINDOW, BASE, MIN)
    assert "error" in str(err.value)
    with pytest.raises(RuntimeError, match="native build"):
        TokenScheduler(WINDOW, BASE, MIN)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        make_core(native=True)
    # the Python core is had only by asking for it
    assert isinstance(make_core(native=False), PyTokenCore)


@pytest.mark.parametrize("native_core", [False, True])
def test_the_core_reads_its_effective_share_back(native_core):
    """The port's cores read back the share they enforce (the JAX cores
    have no such read): the registered one, then each accepted
    ``set_effective``; a refused one leaves it, an unknown name raises.
    The scheduler's record of what it pushed agrees."""
    sched = TokenScheduler(WINDOW, BASE, MIN, native=native_core)
    core = sched.core
    sched.add_client("a", 0.25, 0.5)
    assert core.effective("a") == (0.25, 0.5)
    assert sched.set_effective("a", 0.35, 0.35)
    assert core.effective("a") == sched.effective("a") == (0.35, 0.35)
    with pytest.raises(ValueError):
        sched.set_effective("a", 0.6, 0.5)
    assert core.effective("a") == sched.effective("a") == (0.35, 0.35)
    with pytest.raises(KeyError):
        core.effective("b")
    sched.remove_client("a")
    with pytest.raises(KeyError):
        core.effective("a")
    sched.close()


# --- one core, against the JAX core of the same kind -------------------------

def test_single_client_grant_and_quota(pair):
    def scenario(core):
        core.add_client("a", 0.5, 1.0)
        core.request_token("a")
        first = core.poll(0.0)
        holder = core.holder()
        core.add_client("b", 0.5, 1.0)
        core.request_token("b")
        blocked = core.poll(1.0)
        core.release_token("a", 50.0, 50.0)
        return [first, holder, blocked, core.poll(50.0)]

    first, holder, blocked, second = _both(pair, scenario)
    assert first == ("a", BASE) and holder == "a"
    assert blocked == INF                 # the token is exclusive
    assert second[0] == "b"


def test_stride_shares_converge_to_requests(pair):
    """0.75 vs 0.25 requests → device-time shares converge to 3:1."""
    def scenario(core):
        core.add_client("big", 0.75, 1.0)
        core.add_client("small", 0.25, 1.0)
        now = 0.0
        used = {"big": 0.0, "small": 0.0}
        for _ in range(200):
            core.request_token("big")
            core.request_token("small")
            name, quota = core.poll(now)
            burst = min(quota, 20.0)
            now += burst
            core.release_token(name, burst, now)
            used[name] += burst
        return used

    used = _both(pair, scenario)
    share = used["big"] / (used["big"] + used["small"])
    assert 0.70 <= share <= 0.80


def test_limit_cap_enforced(pair):
    """limit=0.3 client alone on the device is held to ≤30% of the
    window."""
    def scenario(core):
        core.add_client("capped", 0.3, 0.3)
        now = used_total = 0.0
        wakes = []
        while now < 3 * WINDOW:
            core.request_token("capped")
            granted = core.poll(now)
            if isinstance(granted, tuple):
                now += granted[1]
                core.release_token("capped", granted[1], now)
                used_total += granted[1]
            else:
                assert granted != INF, "waiter starved with no wake time"
                wakes.append(granted)
                now = max(granted, now + 1.0)
        return used_total, core.window_usage("capped", now), len(wakes)

    used_total, window_used, _ = _both(pair, scenario)
    assert used_total <= 0.3 * (3 * WINDOW) * 1.05
    assert window_used <= 0.3 * WINDOW + 1e-6


def test_quota_clamped_to_remaining_allowance(pair):
    def scenario(core):
        core.add_client("c", 0.5, 0.5)    # cap 500 ms of the window
        core.request_token("c")
        core.poll(0.0)
        core.release_token("c", 450.0, 450.0)   # 50 ms of allowance left
        core.request_token("c")
        return core.poll(450.0)

    granted = _both(pair, scenario)
    assert granted[1] == pytest.approx(50.0, abs=1e-6)


def test_below_min_quota_is_ineligible_with_wake_time(pair):
    def scenario(core):
        core.add_client("c", 0.5, 0.5)
        core.request_token("c")
        core.poll(0.0)
        core.release_token("c", 495.0, 495.0)   # 5 ms left < MIN
        core.request_token("c")
        wake = core.poll(495.0)
        return wake, core.poll(wake + 1e-3)

    wake, granted = _both(pair, scenario)
    assert wake < INF
    assert isinstance(granted, tuple)     # at the wake time, a grant


def test_usage_expires_from_window(pair):
    def scenario(core):
        core.add_client("c", 1.0, 1.0)
        core.request_token("c")
        core.poll(0.0)
        core.release_token("c", 100.0, 100.0)
        return [core.window_usage("c", t) for t in (100.0, 600.0, 1050.0,
                                                    1200.0)]

    assert _both(pair, scenario) == pytest.approx([100.0, 100.0, 50.0, 0.0])


@pytest.mark.parametrize("request_, limit", [(0.0, 1.0), (0.6, 0.5),
                                             (0.5, 1.5)])
def test_client_validation(pair, request_, limit):
    def scenario(core):
        with pytest.raises(ValueError) as err:
            core.add_client("x", request_, limit)
        core.add_client("x", 0.5, 1.0)
        with pytest.raises(ValueError) as dup:
            core.add_client("x", 0.5, 1.0)
        return str(err.value), str(dup.value)

    assert _both(pair, scenario) == (f"bad request/limit: {request_}/{limit}",
                                     "duplicate client x")


def test_remove_holder_frees_token(pair):
    def scenario(core):
        core.add_client("a", 0.5, 1.0)
        core.add_client("b", 0.5, 1.0)
        core.request_token("a")
        core.request_token("b")
        name, _ = core.poll(0.0)
        core.remove_client(name)
        return name, core.poll(1.0), core.client_count()

    name, granted, count = _both(pair, scenario)
    assert isinstance(granted, tuple) and granted[0] != name and count == 1


# --- all four cores in lockstep -----------------------------------------------

def test_cores_agree_on_trace():
    """One deterministic trace through the port's native and Python cores
    and the JAX package's two: every grant, quota, wake time and window
    usage the same."""
    cores = _four_cores()
    for c in cores:
        c.add_client("a", 0.6, 0.8)
        c.add_client("b", 0.2, 0.4)
    now = 0.0
    for i in range(300):
        for c in cores:
            c.request_token("a" if i % 3 else "b")
        got = [c.poll(now) for c in cores]
        ref = got[-1]
        for g in got[:-1]:
            assert isinstance(g, tuple) == isinstance(ref, tuple), (i, got)
            if isinstance(ref, tuple):
                assert g[0] == ref[0]
                assert g[1] == pytest.approx(ref[1], abs=1e-6)
            else:
                assert g == pytest.approx(ref, abs=1e-3)
        if isinstance(ref, tuple):
            burst = min(ref[1], 37.0)
            now += burst
            for c in cores:
                c.release_token(ref[0], burst, now)
        else:
            now = max(now + 1.0, ref if ref < INF else now + 1.0)
        for name in ("a", "b"):
            usage = [c.window_usage(name, now) for c in cores]
            assert usage == pytest.approx([usage[-1]] * 4, abs=1e-6)


def test_cores_agree_on_cancel_and_timeout_trace():
    """Request, cancel and poll through all four cores: grants, wake
    times and holders match, including a cancel of an unknown name (a
    no-op), of the holder (no effect on the hold), and a cancel then a
    new request (the façade's acquire-timeout path)."""
    cores = _four_cores()
    for c in cores:
        c.add_client("a", 0.5, 1.0)
        c.add_client("b", 0.3, 0.6)
    now = 0.0
    for i in range(200):
        step = i % 10
        for c in cores:
            if step in (0, 4):
                c.request_token("a")
            if step in (0, 6):
                c.request_token("b")
            if step == 2:
                c.cancel_request("b")
            if step == 3:
                c.cancel_request("ghost")
            if step == 5:
                c.cancel_request(c.holder() or "a")
        got = [c.poll(now) for c in cores]
        ref = got[-1]
        for g in got[:-1]:
            assert isinstance(g, tuple) == isinstance(ref, tuple), (i, got)
            if isinstance(ref, tuple):
                assert g[0] == ref[0], i
                assert g[1] == pytest.approx(ref[1], abs=1e-6)
            else:
                assert g == pytest.approx(ref, abs=1e-3), i
        if isinstance(ref, tuple):
            burst = min(ref[1], 23.0)
            now += burst
            for c in cores:
                c.release_token(ref[0], burst, now)
        else:
            now += 7.0
        assert len({c.holder() for c in cores}) == 1, i


@pytest.mark.parametrize("names", [("b", "a"), ("zeta", "alpha", "mid")])
def test_cores_break_vtime_ties_by_name(names):
    """Fresh clients start at equal vtime: every core grants the smallest
    name first, whatever order they were added in (the native core's
    map iteration order must not decide)."""
    cores = _four_cores()
    orders = []
    for c in cores:
        for n in names:
            c.add_client(n, 0.3, 1.0)
        order, now = [], 0.0
        for _ in names:
            for n in names:
                c.request_token(n)
            name, _ = c.poll(now)
            now += 10.0
            c.release_token(name, 10.0, now)    # its vtime moves past
            order.append(name)
            for n in names:
                c.cancel_request(n)
        orders.append(order)
    assert orders == [sorted(names)] * 4


@pytest.mark.parametrize("requests", [(0.25, 0.75), (0.5, 0.5)])
def test_a_capped_creditor_leaves_the_debt(requests):
    """chip_smoke.py's gate pairs on a virtual clock (window 1 s, quota
    300 ms, min 20 ms, limit 1.0 each): tenant a's first grant is held
    7 s (its CUDA start-up), b's 2 s, every later one a 31 ms step past
    its quota. b, owed a's start-up, reaches its window cap every ~1 s
    and a is granted a whole quota each time: at requests 0.25 / 0.75 a
    keeps its request's share from then on, so its debt stays and its
    share over its life stays high; at 0.5 / 0.5 b takes the debt back.
    The same on all four cores."""
    def scenario(core):
        core.add_client("a", requests[0], 1.0)
        core.add_client("b", requests[1], 1.0)
        first = {"a": 7000.0, "b": 2000.0}
        held = {"a": 0.0, "b": 0.0}
        at = {}
        now = 0.0
        for name in held:
            core.request_token(name)
        while now < 40000.0:
            granted = core.poll(now)
            if not isinstance(granted, tuple):
                now = max(now + 1.0, granted)
                continue
            name, quota = granted
            used = first.pop(name, quota + 31.0)
            now += used
            held[name] += used
            core.release_token(name, used, now)
            core.request_token(name)
            now += 1.0
            if now >= 10000.0 and not at:
                at = dict(held)
        return at, held

    cores = [c(1000.0, 300.0, 20.0) for c in (
        NativeTokenCore, PyTokenCore, jts.NativeTokenCore, jts.PyTokenCore)]
    runs = [scenario(c) for c in cores]
    for c in cores:
        c.close()
    assert all(r == pytest.approx(runs[-1]) for r in runs)
    at, held = runs[0]
    life = held["a"] / (held["a"] + held["b"])
    late = (held["a"] - at["a"]) / (
        held["a"] - at["a"] + held["b"] - at["b"])
    if requests[0] == 0.25:
        assert late == pytest.approx(0.25, abs=0.02)
        assert life > 0.35
    else:
        assert life == pytest.approx(0.5, abs=0.01)


# --- the blocking façade -----------------------------------------------------

def test_blocking_facade_serializes_holders():
    sched = TokenScheduler(WINDOW, BASE, MIN)
    sched.add_client("a", 0.5, 1.0)
    sched.add_client("b", 0.5, 1.0)
    order = []
    lock = threading.Lock()

    def worker(name):
        for _ in range(5):
            sched.acquire(name, timeout=5.0)
            with lock:
                order.append(name)
            sched.release(name, 1.0)

    threads = [threading.Thread(target=worker, args=(n,)) for n in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10.0)
    assert not any(t.is_alive() for t in threads)
    assert sorted(order.count(n) for n in "ab") == [5, 5]


def test_renew_preserves_stride_shares():
    """Steady-state renew gives request-proportional shares (a
    release-then-acquire pair would collapse 0.7/0.3 to round-robin)."""
    sched = TokenScheduler(WINDOW, BASE, MIN)
    sched.add_client("big", 0.7, 1.0)
    sched.add_client("small", 0.3, 1.0)
    used = {"big": 0.0, "small": 0.0}
    lock = threading.Lock()
    budget = 900.0

    def worker(name):
        quota = sched.acquire(name, timeout=5.0)
        while True:
            burst = min(quota, 10.0)
            with lock:
                if sum(used.values()) >= budget:
                    break
                used[name] += burst
            time.sleep(burst / 1000.0)
            quota = sched.renew(name, burst, timeout=5.0)
        sched.release(name, 0.0)

    threads = [threading.Thread(target=worker, args=(n,))
               for n in ("big", "small")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
    assert not any(t.is_alive() for t in threads)
    share = used["big"] / (used["big"] + used["small"])
    assert 0.62 <= share <= 0.78, share


def test_concurrent_waiters_same_name_fifo():
    """Same-name waiters queue for their one token stream and are granted
    in arrival order — every waiter served, no lost grants."""
    sched = TokenScheduler(WINDOW, BASE, MIN)
    sched.add_client("a", 0.5, 1.0)
    sched.add_client("b", 0.5, 1.0)
    sched.acquire("a")
    order, errs = [], []

    def waiter(tag, entered):
        entered.set()
        try:
            sched.acquire("b", timeout=10.0)
            order.append(tag)
            time.sleep(0.02)
            sched.release("b", 1.0)
        except Exception as e:   # recorded for the assertion below
            errs.append(e)

    threads = []
    for tag in ("first", "second", "third"):
        ev = threading.Event()
        t = threading.Thread(target=waiter, args=(tag, ev))
        t.start()
        ev.wait()
        time.sleep(0.05)
        threads.append(t)
    sched.release("a", 1.0)
    for t in threads:
        t.join(timeout=10.0)
        assert not t.is_alive()
    assert not errs, errs
    assert order == ["first", "second", "third"]


def test_waiter_errors_when_client_removed():
    sched = TokenScheduler(WINDOW, BASE, MIN)
    sched.add_client("a", 0.5, 1.0)
    sched.add_client("b", 0.5, 1.0)
    sched.acquire("a")
    errs = []

    def waiter():
        try:
            sched.acquire("b")
        except RuntimeError as e:
            errs.append(e)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    sched.remove_client("b")
    t.join(timeout=5.0)
    assert not t.is_alive(), "waiter hung after client removal"
    assert errs and "removed" in str(errs[0])


def test_facade_acquire_timeout_cancels():
    sched = TokenScheduler(WINDOW, BASE, MIN)
    sched.add_client("a", 0.5, 1.0)
    sched.add_client("b", 0.5, 1.0)
    sched.acquire("a", timeout=1.0)
    with pytest.raises(TimeoutError):
        sched.acquire("b", timeout=0.05)
    sched.release("a", 1.0)
    assert sched.core.holder() is None    # b's withdrawn request
    assert sched.acquire("b", timeout=1.0) > 0


def test_close_wakes_a_waiter_of_the_native_core():
    """After close the C++ scheduler is freed: a waiter woken by the
    close errors out instead of touching the freed handle."""
    sched = TokenScheduler(WINDOW, BASE, MIN)
    sched.add_client("a", 0.5, 1.0)
    sched.add_client("b", 0.5, 1.0)
    sched.acquire("a")
    errs = []

    def waiter():
        try:
            sched.acquire("b")
        except RuntimeError as e:
            errs.append(e)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    sched.close()
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert errs and "closed" in str(errs[0])


# --- the TCP server ----------------------------------------------------------

def _session(port):
    with protocol.Connection("127.0.0.1", port) as conn:
        out = [conn.call({"op": "register", "name": "p", "request": 0.5,
                          "limit": 1.0})[0]]
        out.append(conn.call({"op": "acquire", "name": "p"})[0])
        out.append(conn.call({"op": "release", "name": "p",
                              "used_ms": 42.0})[0])
        usage = conn.call({"op": "usage", "name": "p"})[0]
        out.append({"window_ms": usage["window_ms"],
                    "used_ms": round(usage["used_ms"])})
    return out


def test_tcp_server_roundtrip():
    """The same session gets the same replies from both servers, and
    the owner's disconnect removes its client."""
    replies = {}
    for pkg in ("port", "jax"):
        sched = (TokenScheduler(WINDOW, BASE, MIN) if pkg == "port"
                 else jts.TokenScheduler(WINDOW, BASE, MIN))
        server = (tokensched.serve(sched) if pkg == "port"
                  else jts.serve(sched))
        try:
            replies[pkg] = _session(server.server_address[1])
            deadline = time.monotonic() + 2.0
            while sched.core.client_count() and time.monotonic() < deadline:
                time.sleep(0.01)
            assert sched.core.client_count() == 0
        finally:
            server.shutdown()
            sched.close()
    assert replies["port"] == replies["jax"]
    assert replies["port"][1]["quota_ms"] == BASE
    assert replies["port"][3] == {"window_ms": WINDOW, "used_ms": 42}


def test_tcp_server_error_reply():
    sched = TokenScheduler(WINDOW, BASE, MIN)
    server = tokensched.serve(sched)
    try:
        with protocol.Connection("127.0.0.1",
                                 server.server_address[1]) as conn:
            with pytest.raises(RuntimeError, match="unknown op"):
                conn.call({"op": "nope"})
            with pytest.raises(RuntimeError, match="bad request/limit"):
                conn.call({"op": "register", "name": "x",
                           "request": 2.0, "limit": 1.0})
    finally:
        server.shutdown()
        sched.close()


def test_register_class_reaches_the_scheduler():
    """A register's ``"class"`` sets the client's class, on the port's
    server as on the JAX package's; absent, it is best-effort."""
    classes = {}
    for pkg in ("port", "jax"):
        sched = (TokenScheduler(WINDOW, BASE, MIN) if pkg == "port"
                 else jts.TokenScheduler(WINDOW, BASE, MIN))
        server = (tokensched.serve(sched) if pkg == "port"
                  else jts.serve(sched))
        conns = [jprotocol.Connection("127.0.0.1", server.server_address[1])
                 for _ in range(2)]
        try:
            conns[0].call({"op": "register", "name": "lat", "request": 0.3,
                           "limit": 1.0, "class": "latency"})
            conns[1].call({"op": "register", "name": "anon",
                           "request": 0.3, "limit": 1.0})
            acct = sched.accounting()["clients"]
            classes[pkg] = {n: acct[n]["class"] for n in acct}
        finally:
            for c in conns:
                c.close()
            server.shutdown()
            sched.close()
    assert classes["port"] == classes["jax"] == {"lat": "latency",
                                                 "anon": "best-effort"}
