"""The elastic plane's effective shares and the gang token wire of the
port against the JAX package's: ``set_effective`` on both cores and on
``TokenScheduler``, the coordinator's all-or-nothing
``set_effective_gang`` and ``restore_base``, and ``serve``'s ``gang_*``
ops on one script of requests, with the gangs a connection registered
withdrawn when it drops. No device is involved.
"""

import time

import pytest

from kubeshare_tpu.gang import coordinator as jcoord_mod
from kubeshare_tpu.isolation import protocol as jprotocol
from kubeshare_tpu.isolation import tokensched as jts
from kubeshare_tpu_torch.gang import coordinator as tcoord_mod
from kubeshare_tpu_torch.isolation import protocol as tprotocol
from kubeshare_tpu_torch.isolation import tokensched as tts

PACKAGES = {"jax": (jts, jcoord_mod, jprotocol),
            "port": (tts, tcoord_mod, tprotocol)}


def _cores():
    return {"jax-python": jts.PyTokenCore(1000, 30, 5),
            "port-python": tts.PyTokenCore(1000, 30, 5),
            "port-native": tts.NativeTokenCore(1000, 30, 5)}


def _script(core) -> list:
    """One script of core calls on a virtual clock: the grants, window
    usage and errors it gives."""
    out = []

    def call(fn, *args):
        try:
            out.append(("ok", fn(*args)))
        except (KeyError, ValueError, RuntimeError) as e:
            out.append((type(e).__name__, str(e)))

    call(core.add_client, "a", 0.25, 0.5)
    call(core.add_client, "b", 0.25, 0.5)
    now = 0.0
    for i in range(24):
        name = "ab"[i % 2]
        call(core.request_token, name)
        got = core.poll(now)
        out.append(("poll", got))
        if isinstance(got, tuple):
            now += got[1]
            call(core.release_token, got[0], got[1], now)
        else:
            now = got if got != float("inf") else now + 100.0
        if i == 6:
            call(core.set_effective, "a", 0.75, 1.0)   # a burst credit
        if i == 16:
            call(core.set_effective, "a", 0.25, 0.5)   # revoked
    call(core.set_effective, "nobody", 0.5, 1.0)
    call(core.set_effective, "a", 0.6, 0.5)
    call(core.set_effective, "a", 0.0, 0.5)
    out.append(("usage", round(core.window_usage("a", now), 6),
                round(core.window_usage("b", now), 6)))
    return out


def test_set_effective_on_every_core_matches_jax():
    """The port's Python and native cores answer the JAX core's script
    call for call: the credit moves the grants, the revoke moves them
    back, and unknown clients and bad shares raise alike."""
    results = {name: _script(core) for name, core in _cores().items()}
    want = results.pop("jax-python")
    assert any(r[0] == "KeyError" for r in want)
    for name, got in results.items():
        assert got == want, name


@pytest.mark.parametrize("native", [False, True])
def test_scheduler_set_effective_matches_jax(native):
    out = {}
    for pkg, (ts, _, _) in PACKAGES.items():
        s = ts.TokenScheduler(1000, 30, 5, native=native and pkg == "port")
        s.add_client("a", 0.25, 0.5)
        s.add_client("b", 0.5, 1.0)
        rec = [s.set_effective("a", 0.5, 1.0), s.effective("a"),
               s.shares()["a"], s.accounting()["share_sum"]]
        for bad in (("zz", 0.5, 1.0), ("a", 0.5, 1.5)):
            try:
                s.set_effective(*bad)
            except (KeyError, ValueError) as e:
                rec.append(type(e).__name__)
        s.remove_client("a")
        with pytest.raises(KeyError):
            s.effective("a")
        s.close()
        try:                     # a closed core: False, or no client
            rec.append(s.set_effective("b", 0.5, 1.0))
        except KeyError as e:
            rec.append(f"KeyError {e}")
        out[pkg] = rec
    # after close the Python cores have no client left; the native core
    # refuses the call (its handle is freed), so the scheduler says False
    assert out["port"][:-1] == out["jax"][:-1]
    assert out["port"][-1] == (False if native else out["jax"][-1])
    assert out["port"][:4] == [True, (0.5, 1.0), (0.25, 0.5), 1.0]


class _Refusing:
    """A scheduler whose core predates the call."""

    def __init__(self, sched):
        self._s = sched

    def __getattr__(self, name):
        return getattr(self._s, name)

    def set_effective(self, name, request, limit):
        return False


def test_set_effective_gang_is_all_or_nothing_as_in_jax():
    """A gang over three chips takes one effective share on every member;
    a member that refuses undoes the members already adjusted; a gone
    client refuses too; ``restore_base`` puts every member back."""
    out = {}
    for pkg, (ts, cm, _) in PACKAGES.items():
        scheds = {c: ts.TokenScheduler(1000, 30, 5, native=False)
                  for c in ("c0", "c1", "c2")}
        for c, s in scheds.items():
            s.add_client(f"g-{c}", 0.25, 0.5)
        coord = cm.GangTokenCoordinator()
        for c, s in scheds.items():
            coord.attach_chip(c, s)
        coord.register_gang("g", [(c, f"g-{c}") for c in scheds])
        eff = lambda: [scheds[c].effective(f"g-{c}") for c in sorted(scheds)]
        rec = [coord.set_effective_gang("g", 0.5, 1.0), eff()]
        coord.restore_base("g")
        rec.append(eff())
        coord.attach_chip("c2", _Refusing(scheds["c2"]))
        rec += [coord.set_effective_gang("g", 0.5, 1.0), eff()]
        coord.attach_chip("c2", scheds["c2"])
        scheds["c1"].remove_client("g-c1")
        rec += [coord.set_effective_gang("g", 0.5, 1.0),
                scheds["c0"].effective("g-c0"),
                coord.set_effective_gang("nope", 0.5, 1.0)]
        coord.restore_base("nope")
        out[pkg] = rec
    assert out["port"] == out["jax"]
    assert out["port"][0] is True and out["port"][3] is False
    assert out["port"][4] == [(0.25, 0.5)] * 3


def _served(pkg: str, with_coordinator: bool):
    ts, cm, _ = PACKAGES[pkg]
    scheds = {c: ts.TokenScheduler(1000, 30, 5, native=False)
              for c in ("c0", "c1")}
    coord = None
    if with_coordinator:
        coord = cm.GangTokenCoordinator()
        for c, s in scheds.items():
            coord.attach_chip(c, s)
    srv = ts.serve(scheds["c0"], coordinator=coord)
    return scheds, coord, srv


def _wire_script(pkg: str) -> list:
    scheds, coord, srv = _served(pkg, True)
    _, _, protocol = PACKAGES[pkg]
    for c, s in scheds.items():
        s.add_client(f"m-{c}", 0.5, 1.0)
    conn = protocol.Connection("127.0.0.1", srv.server_address[1])
    out = []

    def call(msg):
        try:
            reply = conn.call(msg)[0]
            if "state" in reply:
                reply = dict(reply, state={
                    k: v for k, v in reply["state"].items()})
                for g in reply["state"].get("gangs", {}).values():
                    g.pop("grant_wait_p50_ms", None)
                    g.pop("grant_wait_p99_ms", None)
            out.append(reply)
        except RuntimeError as e:
            out.append(("error", str(e)))

    call({"op": "gang_state"})
    call({"op": "gang_acquire"})
    call({"op": "gang_register", "gang": "ns/g",
          "members": [["c1", "m-c1"], ["c0", "m-c0"]], "namespace": "ns"})
    call({"op": "gang_state"})
    call({"op": "gang_acquire", "gang": "ns/g", "timeout": 5})
    call({"op": "gang_state"})
    call({"op": "gang_release", "gang": "ns/g", "used_ms": 3.0})
    call({"op": "gang_acquire", "gang": "nope", "timeout": 0.1})
    call({"op": "gang_state"})
    conn.close()
    deadline = time.monotonic() + 5
    while coord.gangs() and time.monotonic() < deadline:
        time.sleep(0.02)
    out.append(("after disconnect", coord.gangs()))
    srv.shutdown()
    srv.server_close()
    for s in scheds.values():
        s.close()
    return out


def test_gang_wire_matches_jax_and_withdraws_on_disconnect():
    """The same script of gang requests gets the same replies from both
    servers: state, register, a two-chip acquire holding both members,
    release, errors for a missing or unknown gang; the connection's drop
    unregisters its gang."""
    port, jax_side = _wire_script("port"), _wire_script("jax")
    assert port == jax_side
    assert port[4] == {"ok": True, "held": {"c0": 30, "c1": 30}}
    assert port[-1] == ("after disconnect", [])


@pytest.mark.parametrize("op", ["gang_register", "gang_acquire",
                                "gang_release", "gang_state"])
def test_gang_ops_without_a_coordinator_are_unknown(op):
    replies = []
    for pkg in PACKAGES:
        scheds, _, srv = _served(pkg, False)
        conn = PACKAGES[pkg][2].Connection("127.0.0.1",
                                           srv.server_address[1])
        with pytest.raises(RuntimeError) as e:
            conn.call({"op": op, "gang": "g"})
        replies.append(str(e.value))
        conn.close()
        srv.shutdown()
        srv.server_close()
        for s in scheds.values():
            s.close()
    assert replies[0] == replies[1] == f"unknown op {op!r}"
