"""Port's isolation runtime: token scheduler against the JAX package's,
the frozen wire, and a CPU ``ChipProxy`` driven by threaded clients."""

import threading
import time
import types
from functools import partial

import numpy as np
import pytest
import torch

from kubeshare_tpu.isolation import protocol as jprotocol
from kubeshare_tpu.isolation.tokensched import PyTokenCore as JaxCore
from kubeshare_tpu_torch.isolation import programs, protocol
from kubeshare_tpu_torch.isolation.client import ProxyClient, RemoteBuffer
from kubeshare_tpu_torch.isolation.proxy import ChipProxy
from kubeshare_tpu_torch.isolation.tokensched import (PyTokenCore,
                                                      TokenScheduler)
from kubeshare_tpu_torch.models import common, mnist, tinymlp, transformer
from kubeshare_tpu_torch.ops.flash_attention import flash_attention
from kubeshare_tpu_torch.utils.tree import tree_leaves

WINDOW, BASE, MIN = 1000.0, 100.0, 10.0
TINY = {"program": "train_step", "model": "tinymlp",
        "optimizer": {"name": "fused_adam", "lr": 1e-2}}
LM = {"program": "train_step", "model": "transformer", "attention": "flash",
      "optimizer": {"name": "fused_adam", "lr": 1e-2}}
# the transformer the proxy resolves in these tests (see ``small_lm``)
SMALL_LM = {"seq_len": 32, "vocab": 64, "dim": 32, "layers": 1}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # the suite runs in parallel workers: keep torch's CPU kernels from
    # taking every core from the timing-sensitive tests of other workers
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# --- token scheduler ---------------------------------------------------------

def test_py_core_matches_jax_core_on_trace():
    """Both Python cores through one deterministic trace (the style of
    test_tokensched.py's cross-check): same grants, quotas, wakes and
    window usage at every step."""
    port, ref = PyTokenCore(WINDOW, BASE, MIN), JaxCore(WINDOW, BASE, MIN)
    for c in (port, ref):
        c.add_client("a", 0.6, 0.8)
        c.add_client("b", 0.2, 0.4)
    now = 0.0
    grants = 0
    for i in range(300):
        for c in (port, ref):
            c.request_token("a" if i % 3 else "b")
        gp, gr = port.poll(now), ref.poll(now)
        assert gp == gr
        if isinstance(gp, tuple):
            grants += 1
            burst = min(gp[1], 37.0)
            now += burst
            port.release_token(gp[0], burst, now)
            ref.release_token(gr[0], burst, now)
        else:
            now = max(now + 1.0, gp if gp < float("inf") else now + 1.0)
        for name in ("a", "b"):
            assert port.window_usage(name, now) == ref.window_usage(name,
                                                                    now)
    assert grants > 100


def test_core_validates_like_jax():
    for bad in ((0.0, 1.0), (0.5, 1.5), (0.8, 0.4)):
        with pytest.raises(ValueError):
            PyTokenCore().add_client("x", *bad)
        with pytest.raises(ValueError):
            JaxCore().add_client("x", *bad)


def test_facade_serializes_holders_and_renews():
    sched = TokenScheduler(WINDOW, BASE, MIN)
    sched.add_client("a", 0.5, 1.0)
    sched.add_client("b", 0.5, 1.0)
    assert sched.acquire("a") == BASE
    acc = sched.accounting()
    assert acc["clients"]["a"]["holding"] and acc["share_sum"] == 1.0
    got = []
    t = threading.Thread(target=lambda: got.append(sched.acquire("b")))
    t.start()
    time.sleep(0.05)
    assert not got                      # b waits while a holds
    renew = threading.Thread(
        target=lambda: got.append(("a", sched.renew("a", 5.0))))
    renew.start()
    t.join(timeout=5)
    assert not t.is_alive() and got[0] == BASE
    sched.release("b", 5.0)
    renew.join(timeout=5)
    assert not renew.is_alive() and got[1] == ("a", BASE)
    assert sched.window_usage("a") == pytest.approx(5.0)
    sched.release("a", 1.0)
    sched.close()


def test_facade_acquire_timeout_cancels():
    sched = TokenScheduler(WINDOW, BASE, MIN)
    sched.add_client("a", 0.5, 1.0)
    sched.add_client("b", 0.5, 1.0)
    sched.acquire("a")
    with pytest.raises(TimeoutError):
        sched.acquire("b", timeout=0.05)
    assert sched.accounting()["waiting"] == []
    sched.release("a", 1.0)
    assert sched.acquire("a", timeout=1.0) == BASE   # b's request withdrawn


# --- wire ---------------------------------------------------------------------

@pytest.mark.parametrize("msg,blob", [
    ({"ok": True}, None),
    ({"ok": True, "handle": 3, "shape": [2, 2], "dtype": "float32"}, None),
    ({"op": "put", "name": "a"}, b"\x00" * 10),
])
def test_frames_are_byte_identical_to_jax(msg, blob):
    assert protocol._frame(msg, blob) == jprotocol._frame(msg, blob)


def test_ok_reply_keeps_its_space():
    assert b'"ok": true' in protocol._frame({"ok": True})[0]


def test_array_round_trip_matches_jax_wire():
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    raw = b"".join(bytes(p) for p in protocol.dump_array_parts(arr))
    assert raw == jprotocol.dump_array(arr)
    np.testing.assert_array_equal(protocol.load_array(raw), arr)
    scalar = protocol.load_array(b"".join(
        bytes(p) for p in protocol.dump_array_parts(np.float32(2.5))))
    assert scalar.shape == () and scalar == 2.5


# --- proxy --------------------------------------------------------------------

@pytest.fixture
def proxy():
    p = ChipProxy(device="cpu", scheduler=TokenScheduler(500.0, 30.0, 5.0))
    p.serve()
    yield p
    p.close()


def test_lockstep_register_grants_no_features(proxy):
    with protocol.Connection("127.0.0.1", proxy.port, timeout=10) as conn:
        reply, _ = conn.call({"op": "register", "name": "raw",
                              "request": 0.5, "limit": 1.0,
                              "features": ["seq", "resume"]})
        assert "features" not in reply
        assert reply["platforms"] == ["cpu"]
        # plain lockstep put/get still works on that connection
        reply, _ = conn.call({"op": "put", "name": "raw"},
                             blob=protocol.dump_array_parts(
                                 np.ones(3, np.float32)))
        _, blob = conn.call({"op": "get", "name": "raw",
                             "handle": reply["handle"]})
        np.testing.assert_array_equal(protocol.load_array(blob), np.ones(3))


def _client_setup(c, seed):
    carry = c.put_tree(programs.initial_carry(TINY, seed))
    batch = c.put_tree(tuple(tinymlp.batch_fn(seed + 1)))
    return carry, batch, c.compile_loop(TINY, carry, *batch)


def test_two_clients_chain_tinymlp(proxy):
    results, errors = {}, {}

    def trainer(name, seed):
        try:
            with ProxyClient("127.0.0.1", proxy.port, name, 0.5, 1.0,
                             timeout=30) as c:
                carry, batch, loop = _client_setup(c, seed)
                old = tree_leaves(carry)
                carry, loss = loop(64, carry, *batch)
                count0 = c.usage()["exec_count"]
                carry, loss = loop(64, carry, *batch)
                # one dispatch per burst, clamped to a power of two
                assert c.usage()["exec_count"] == count0 + 1
                assert loop.last_n & (loop.last_n - 1) == 0
                c.free(loss)
                first = None
                steps = 0
                for _ in range(6):
                    carry, loss = loop.chain(256, carry, *batch)
                    assert 1 <= loop.last_burst <= loop.last_n <= 256
                    steps += loop.last_n
                    value = float(c.get(loss))
                    first = value if first is None else first
                    c.free(loss)
                # the donated carry handles are gone on the proxy
                with pytest.raises(RuntimeError, match="KeyError"):
                    c.get(old[0])
                results[name] = (steps, first, value, c.usage())
        except BaseException as e:   # surfaced below
            errors[name] = e

    threads = [threading.Thread(target=trainer, args=(n, s))
               for n, s in (("a", 1), ("b", 2))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    if errors:
        raise next(iter(errors.values()))
    for steps, first, last, usage in results.values():
        assert steps > 0
        assert np.isfinite(last) and last < first
        assert usage["exec_ms_total"] > 0


def test_hbm_accounting_balances_after_chain(proxy):
    with ProxyClient("127.0.0.1", proxy.port, "acct", 0.5, 1.0,
                     timeout=30) as c:
        carry, batch, loop = _client_setup(c, 3)
        # first dispatch of a fresh program: no timing yet, one step
        carry, loss = loop(64, carry, *batch)
        assert loop.last_n == 1 and loop.last_burst == 1
        c.free(loss)
        for _ in range(3):
            carry, loss = loop.chain(32, carry, *batch)
            c.free(loss)
        carry, loss = loop.chain(32, carry, *batch)
        acc = proxy.hbm_accounting()["acct"]
        assert acc["balanced"]
        live = sum(b.nbytes for b in tree_leaves((carry, batch, loss)))
        assert acc["hbm_used"] == live == c.usage()["hbm_used"]


def test_warmup_burst_feeds_no_cost_model():
    """A session's first burst of a program pays one-time costs and is
    not timed into the cost model: the second burst is one step again
    and sets step_ms, and only then do bursts grow."""
    # a burst budget (2 s) far above a CPU step, so growth is certain
    proxy = ChipProxy(device="cpu",
                      scheduler=TokenScheduler(10000.0, 1000.0, 5.0))
    proxy.serve()
    try:
        _check_warmup(proxy)
    finally:
        proxy.close()


def _check_warmup(proxy):
    with ProxyClient("127.0.0.1", proxy.port, "warm", 0.5, 1.0,
                     timeout=30) as c:
        carry, batch, loop = _client_setup(c, 4)
        (cost,) = proxy._costs.values()
        lasts = []
        for _ in range(3):
            carry, loss = loop(64, carry, *batch)
            c.free(loss)
            lasts.append((loop.last_n, cost.step_ms > 0.0))
        assert lasts[:2] == [(1, False), (1, True)]
        assert lasts[2][0] > 1
    # a second session's first burst of the same program feeds nothing
    # either, though the model it shares is already timed
    with ProxyClient("127.0.0.1", proxy.port, "warm-2", 0.5, 1.0,
                     timeout=30) as c:
        carry, batch, loop = _client_setup(c, 5)
        before = (cost.step_ms, cost.loop_step_ms)
        carry, loss = loop(64, carry, *batch)
        assert loop.last_n > 1
        assert (cost.step_ms, cost.loop_step_ms) == before


def test_memory_cap_refuses_before_allocation(proxy):
    params = programs.initial_carry(TINY, 0)
    carry_bytes = sum(a.nbytes for a in tree_leaves(params))
    batch = tuple(tinymlp.batch_fn(1))
    batch_bytes = sum(a.nbytes for a in batch)
    with ProxyClient("127.0.0.1", proxy.port, "tiny-cap", 0.5, 1.0,
                     memory=1024, timeout=30) as c:
        with pytest.raises(RuntimeError, match="HBMError"):
            c.put(np.zeros(512, np.float32))          # 2048 bytes > 1024
        assert c.usage()["hbm_used"] == 0
        assert proxy.hbm_accounting()["tiny-cap"]["buffer_bytes"] == 0
    # room for the inputs but not for one dispatch's outputs
    cap = carry_bytes + batch_bytes + 16
    with ProxyClient("127.0.0.1", proxy.port, "out-cap", 0.5, 1.0,
                     memory=cap, timeout=30) as c:
        carry = c.put_tree(params)
        batch_h = c.put_tree(batch)
        loop = c.compile_loop(TINY, carry, *batch_h)
        before = c.usage()
        with pytest.raises(RuntimeError, match="HBMError"):
            loop(1, carry, *batch_h)
        after = c.usage()
        assert after["hbm_used"] == before["hbm_used"]
        assert after["exec_count"] == before["exec_count"] == 0
        np.testing.assert_array_equal(c.get(tree_leaves(carry)[0]),
                                      tree_leaves(params)[0])


def test_compile_validates_spec_and_args(proxy):
    with ProxyClient("127.0.0.1", proxy.port, "val", 0.5, 1.0,
                     timeout=30) as c:
        carry, batch, _ = _client_setup(c, 0)
        with pytest.raises(RuntimeError, match="unknown program"):
            c.compile_loop({"program": "nope", "model": "tinymlp"}, carry,
                           *batch)
        with pytest.raises(RuntimeError, match="unknown model"):
            c.compile_loop({"program": "train_step", "model": "vgg"}, carry,
                           *batch)
        with pytest.raises(RuntimeError, match="optimizer"):
            c.compile_loop({"program": "train_step", "model": "tinymlp",
                            "optimizer": {"name": "sgd"}}, carry, *batch)
        with pytest.raises(RuntimeError, match="carry"):
            c.compile_loop(TINY, carry[0], *batch)
        mb = c.put_tree(tuple(mnist.batch_fn(0)))
        with pytest.raises(RuntimeError, match="consts"):
            c.compile_loop(TINY, carry, *mb)


def test_execute_refuses_aliased_carry(proxy):
    with ProxyClient("127.0.0.1", proxy.port, "alias", 0.5, 1.0,
                     timeout=30) as c:
        carry, batch, loop = _client_setup(c, 0)
        leaves = tree_leaves(carry)
        twice = [leaves[0]] * 2 + leaves[2:] + list(batch)
        with pytest.raises(RuntimeError, match="distinct"):
            c._conn.call({"op": "execute", "name": "alias",
                          "exec_id": loop._exec_id,
                          "args": [b.handle for b in twice], "repeat": 1})
        with pytest.raises(TypeError):
            loop(1, np.zeros(3), *batch)
        with pytest.raises(ValueError):
            loop(0, carry, *batch)
        assert isinstance(leaves[0], RemoteBuffer)


def test_proxy_unregister_frees_session(proxy):
    c = ProxyClient("127.0.0.1", proxy.port, "gone", 0.5, 1.0, timeout=30)
    c.put(np.ones(4, np.float32))
    assert "gone" in proxy.hbm_accounting()
    c.close()
    assert "gone" not in proxy.hbm_accounting()
    assert "gone" not in proxy.scheduler.accounting()["clients"]


# --- transformer through the proxy -------------------------------------------

def _lm_batch(seed):
    return common.synthetic_token_batch(seed, 2, 32, 64)


@pytest.fixture
def small_lm(monkeypatch):
    """The proxy resolves "transformer" to the LM at SMALL_LM's sizes: a
    spec cannot size a model, so the test swaps the module the proxy
    finds (the proxy runs in this process)."""
    small = types.SimpleNamespace(
        __name__=transformer.__name__,
        init=partial(transformer.init, **SMALL_LM),
        loss_fn=transformer.loss_fn, flash_loss_fn=transformer.flash_loss_fn,
        batch_fn=partial(common.synthetic_token_batch, batch_size=2,
                         seq_len=32, vocab=64))
    real = programs.get_model
    monkeypatch.setattr(programs, "get_model", lambda name: small
                        if name == "transformer" else real(name))


def test_two_clients_train_transformer_with_flash(proxy, small_lm,
                                                  monkeypatch):
    """Two threaded clients train a small transformer whose attention is
    the flash op, through compile_loop and chain: int token consts cross
    put, both make progress and the loss falls."""
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return flash_attention(*args, **kwargs)

    monkeypatch.setattr(transformer, "flash_attention", counted)
    results, errors = {}, {}

    def trainer(name, seed):
        try:
            with ProxyClient("127.0.0.1", proxy.port, name, 0.5, 1.0,
                             timeout=60) as c:
                batch = _lm_batch(seed + 1)
                carry = c.put_tree(programs.initial_carry(LM, seed))
                consts = c.put_tree(tuple(batch))
                assert [b.dtype for b in consts] == ["int64", "int64"]
                np.testing.assert_array_equal(c.get(consts[0]), batch[0])
                loop = c.compile_loop(LM, carry, *consts)
                carry, loss = loop(1, carry, *consts)
                first = float(c.get(loss))
                steps = 0
                for _ in range(4):
                    carry, loss = loop.chain(16, carry, *consts)
                    steps += loop.last_n
                    c.free(loss)
                carry, loss = loop(1, carry, *consts)
                results[name] = (steps, first, float(c.get(loss)))
        except BaseException as e:   # surfaced below
            errors[name] = e

    threads = [threading.Thread(target=trainer, args=(n, s))
               for n, s in (("lm-a", 1), ("lm-b", 2))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
        assert not t.is_alive()
    if errors:
        raise next(iter(errors.values()))
    for steps, first, last in results.values():
        assert steps >= 4
        assert np.isfinite(last) and last < first
    assert calls       # the flash op ran inside the proxy's programs


def test_programs_keep_separate_cost_models(proxy, small_lm):
    """A transformer program and an mnist program on one proxy: two
    program keys, two cost models, each timed by its own bursts."""
    with ProxyClient("127.0.0.1", proxy.port, "lm", 0.5, 1.0,
                     timeout=60) as a, \
            ProxyClient("127.0.0.1", proxy.port, "conv", 0.5, 1.0,
                        timeout=60) as b:
        mspec = {"program": "train_step", "model": "mnist"}
        carry, consts = _lm_setup(a)
        la = a.compile_loop(LM, carry, *consts)
        mb = b.put_tree(tuple(x[:8] for x in mnist.batch_fn(3)))
        mc = b.put_tree(programs.initial_carry(mspec, 0))
        lb = b.compile_loop(mspec, mc, *mb)
        assert len(proxy._costs) == 2
        ca, cb = (_executable(proxy, name).cost for name in ("lm", "conv"))
        assert ca is not cb
        for _ in range(2):      # warm-up burst, then the one that times
            carry, loss = la(4, carry, *consts)
            a.free(loss)
            mc, loss = lb(4, mc, *mb)
            b.free(loss)
        assert ca.step_ms > 0.0 and cb.step_ms > 0.0
        assert ca.step_ms != cb.step_ms


def _lm_setup(c):
    carry = c.put_tree(programs.initial_carry(LM, 0))
    return carry, c.put_tree(tuple(_lm_batch(1)))


def _executable(proxy, name):
    (exe,) = proxy._sessions[name].executables.values()
    return exe


def test_compile_validates_model_fields(proxy, small_lm):
    with ProxyClient("127.0.0.1", proxy.port, "fields", 0.5, 1.0,
                     timeout=60) as c:
        carry, consts = _lm_setup(c)
        with pytest.raises(RuntimeError, match="attention"):
            c.compile_loop(dict(LM, attention="ring"), carry, *consts)
        with pytest.raises(RuntimeError, match="unknown spec fields"):
            c.compile_loop(dict(LM, init={"experts": 2}), carry, *consts)
        floats = c.put_tree(tuple(x.astype(np.float32)
                                  for x in _lm_batch(1)))
        with pytest.raises(RuntimeError, match="consts"):
            c.compile_loop(LM, carry, *floats)
        tb = c.put_tree(tuple(tinymlp.batch_fn(0)))
        tc = c.put_tree(programs.initial_carry(TINY, 0))
        with pytest.raises(RuntimeError, match="carry"):
            c.compile_loop(LM, tc, *consts)
        with pytest.raises(RuntimeError, match="no attention"):
            c.compile_loop(dict(TINY, attention="flash"), tc, *tb)


def test_spec_cannot_size_the_model(monkeypatch):
    """A spec that asks for model sizes is refused before anything is
    built: the proxy builds only the model module's own sizes."""
    built = []
    monkeypatch.setattr(transformer, "init",
                        lambda *a, **k: built.append(1))
    spec = dict(LM, init={"vocab": 10_000_000, "dim": 10_000})
    with pytest.raises(ValueError, match="unknown spec fields"):
        programs.resolve(spec, [((4,), "float32")], 1)
    assert not built


def test_gate_failure_mid_chain_raises_and_frees_the_carry(proxy):
    """A token-gate failure after one or more bursts of a chain raises and
    frees the consumed carry, as the reference's ``_execute_chain`` does
    (``kubeshare_tpu/isolation/proxy.py:1634-1643``). The port keeps that
    behavior on purpose, with the reference's known defect: the valid
    partial chain is lost, where the memory-cap path of the same loop
    (``proxy.py:1609-1612`` there, ``_execute_chain``'s ``HBMError``
    branch here) returns it instead. The client re-puts its carry, and
    nothing stays charged."""
    with ProxyClient("127.0.0.1", proxy.port, "chainfail", 0.5, 1.0,
                     timeout=30) as c:
        carry, batch, loop = _client_setup(c, 5)
        real_gated = proxy._gated
        calls = []

        def failing_gate(sess, fn, timing):
            calls.append(1)
            if len(calls) == 2:          # the second burst's token wait
                raise RuntimeError("token gate down")
            return real_gated(sess, fn, timing)

        proxy._gated = failing_gate
        with pytest.raises(RuntimeError,
                           match="interrupted after 1 steps.*carry was "
                                 "consumed"):
            loop.chain(8, carry, *batch)
        del proxy._gated
        assert len(calls) == 2
        for buf in tree_leaves(carry):   # the consumed carry is gone
            with pytest.raises(RuntimeError, match="KeyError"):
                c.get(buf)
        acc = proxy.hbm_accounting()["chainfail"]
        assert acc["balanced"]
        assert acc["hbm_used"] == sum(b.nbytes for b in tree_leaves(batch))
        # the consts survive; a re-put carry trains on
        carry = c.put_tree(programs.initial_carry(TINY, 5))
        carry, loss = loop.chain(4, carry, *batch)
        assert np.isfinite(float(c.get(loss)))
