"""The port's elastic plane against the JAX package's: the orchestrator's
plans, layouts, refusals, flips and rollbacks on the same engine
operations, its journal and ``recover``, the demand-ramp sim, the
service's attached ``/elastic`` with its doctor check and topcli view,
and the data plane — ``restate`` and ``ElasticTrainer`` on 4 gloo ranks
(``utils.virtualcpu.RankPool``) against JAX's on 4 virtual CPU devices.

Mirrors ``tests/test_elastic.py`` (its chaos case is in
``tests/test_torch_chaos.py``), and pins one divergence on purpose: on a
sharded plane the port's flip applies where the JAX flip rolls back.
Control-plane results are compared exactly: both
sides run on one fake clock, and journal records are compared without
their times. Data-plane tolerances: tinymlp losses and params within
rtol 1e-4, atol 1e-5 of JAX's (JAX's own test's), with ``optax.adam``
beside the port's fused Adam; within rtol 1e-5, atol 1e-6 of the port's
unresized run (the same sums in another order); re-laid and checkpointed
state bit for bit.
"""

import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from kubeshare_tpu import constants as JC
from kubeshare_tpu import doctor as jdoctor
from kubeshare_tpu import elastic as jelastic
from kubeshare_tpu import rightsize as jrightsize
from kubeshare_tpu import topcli as jtopcli
from kubeshare_tpu.autopilot import CooldownLedger as JLedger
from kubeshare_tpu.autopilot import Planner as JPlanner
from kubeshare_tpu.elastic import sim as jsim
from kubeshare_tpu.gang import coordinator as jcoordinator
from kubeshare_tpu.obs import decisions as jdecisions
from kubeshare_tpu.obs import flight as jflight
from kubeshare_tpu.scheduler import dispatcher as jdispatcher
from kubeshare_tpu.scheduler import engine as jengine
from kubeshare_tpu.scheduler import service as jservice
from kubeshare_tpu.scheduler import shard as jshard
from kubeshare_tpu.telemetry import registry as jregistry
from kubeshare_tpu.topology import cell as jcell
from kubeshare_tpu.topology import discovery as jdiscovery
from kubeshare_tpu_torch import constants as C
from kubeshare_tpu_torch import doctor, elastic, rightsize, topcli
from kubeshare_tpu_torch.chaos import invariants
from kubeshare_tpu_torch.autopilot import CooldownLedger, Planner
from kubeshare_tpu_torch.elastic import sim
from kubeshare_tpu_torch.gang import coordinator
from kubeshare_tpu_torch.obs import decisions
from kubeshare_tpu_torch.obs import flight
from kubeshare_tpu_torch.scheduler import dispatcher
from kubeshare_tpu_torch.scheduler import engine
from kubeshare_tpu_torch.scheduler import service
from kubeshare_tpu_torch.scheduler import shard
from kubeshare_tpu_torch.telemetry import registry
from kubeshare_tpu_torch.topology import cell
from kubeshare_tpu_torch.topology import discovery
from kubeshare_tpu_torch.utils.virtualcpu import RankPool

import torch_ranks

PORT = types.SimpleNamespace(
    C=C, el=elastic, sim=sim, Ledger=CooldownLedger, Planner=Planner,
    coordinator=coordinator, decisions=decisions, flight=flight,
    dispatcher=dispatcher, engine=engine, service=service,
    registry=registry, cell=cell, discovery=discovery, doctor=doctor,
    topcli=topcli, rz=rightsize, shard=shard)
JAX = types.SimpleNamespace(
    C=JC, el=jelastic, sim=jsim, Ledger=JLedger, Planner=JPlanner,
    coordinator=jcoordinator, decisions=jdecisions, flight=jflight,
    dispatcher=jdispatcher, engine=jengine, service=jservice,
    registry=jregistry, cell=jcell, discovery=jdiscovery, doctor=jdoctor,
    topcli=jtopcli, rz=jrightsize, shard=jshard)
SIDES = (PORT, JAX)
GANG = "ns/ring"

#: tinymlp against JAX's trainer (JAX's own test's tolerance)
JAX_RTOL, JAX_ATOL = 1e-4, 1e-5
#: against the port's unresized run: the same sums in another order
BASE_RTOL, BASE_ATOL = 1e-5, 1e-6
LR = 1e-2


@pytest.fixture(autouse=True)
def private_recorders(monkeypatch):
    """Each dispatcher dumps into a recorder of its own, and a test fails
    if the JAX default recorder dumped all the same."""
    for side in SIDES:
        rec = side.flight.FlightRecorder()
        monkeypatch.setattr(side.dispatcher, "default_recorder",
                            lambda rec=rec: rec)
    rec = jflight.default_recorder()
    fired = []
    real = rec.trigger
    monkeypatch.setattr(rec, "trigger",
                        lambda reason, **kw: fired.append(reason)
                        or real(reason, **kw))
    yield
    assert fired == []


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def make_disp(side, hosts=2, mesh=(2, 2), clock=None):
    by_host: dict = {}
    for chip in side.discovery.FakeTopology(hosts=hosts, mesh=mesh).chips():
        by_host.setdefault(chip.host, []).append(chip)
    eng = side.engine.SchedulerEngine(**({"clock": clock} if clock else {}))
    for host, chips in sorted(by_host.items()):
        eng.add_node(host, chips)
    return side.dispatcher.Dispatcher(eng, **({"clock": clock}
                                              if clock else {}))


def bind_gang(side, disp, request="0.5", headcount=4):
    for i in range(headcount):
        disp.submit("ns", f"ring-{i}", {
            side.C.POD_TPU_REQUEST: request, side.C.POD_TPU_LIMIT: "1.0",
            side.C.POD_GROUP_NAME: "ring",
            side.C.POD_GROUP_HEADCOUNT: str(headcount),
            side.C.POD_GROUP_THRESHOLD: "1.0"})
    disp.step(0.0)
    return GANG


def gang_state(disp) -> dict:
    with disp.lock:
        return {p.key: (p.node_name, list(p.bookings), p.port,
                        list(p.chip_ids))
                for p in disp.engine.pod_status.values()
                if p.group_key == GANG}


def make_orch(side, disp, clock, gangcoord=None, journal=None, **cfg_kw):
    cfg_kw.setdefault("cooldown_s", 0.0)
    cfg = side.el.ElasticConfig(**cfg_kw)
    return side.el.ElasticOrchestrator(
        disp, gang_coordinator=gangcoord,
        cooldowns=side.Ledger(cooldown_s=cfg.cooldown_s, clock=clock),
        cfg=cfg, journal_path=journal, clock=clock)


def journal(path) -> list:
    out = []
    for line in open(path).read().splitlines():
        rec = json.loads(line)
        rec.pop("t", None)
        out.append(rec)
    return out


def both(fn):
    """``fn(side)`` on each package; the two results must be equal."""
    got, want = fn(PORT), fn(JAX)
    assert got == want
    return got


# --------------------------------------------------------------------------
# the orchestrator on the real engine
# --------------------------------------------------------------------------

def test_the_cooldown_rail_is_shared_with_the_planner():
    def drive(side):
        clk = FakeClock()
        disp = make_disp(side, clock=clk)
        bind_gang(side, disp)
        led = side.Ledger(cooldown_s=60.0, clock=clk)
        planner = side.Planner(disp, clock=clk, cooldowns=led)
        orch = side.el.ElasticOrchestrator(disp, cooldowns=led, clock=clk)
        planner.note_moved(f"{GANG}-1")
        first = orch.resize(GANG, 4, now=clk.t)
        clk.t += 61.0
        second = orch.resize(GANG, 4, now=clk.t)
        moved = [m["pod"] for m in second.get("moves", [])]
        return (first, second,
                [planner.cooling(k, now=clk.t) for k in moved])

    first, second, cooling = both(drive)
    assert first["reason"] == "cooldown"
    assert second["outcome"] == "applied" and cooling and all(cooling)


def test_a_grow_then_shrink_round_trip_matches_jax():
    def drive(side):
        clk = FakeClock()
        disp = make_disp(side, clock=clk)
        gc = side.coordinator.GangTokenCoordinator(clock=clk)
        disp.attach_gang_coordinator(gc)
        bind_gang(side, disp)
        orch = make_orch(side, disp, clk, gangcoord=gc)
        out = [gang_state(disp)]
        for target in (4, 2):
            out += [orch.resize(GANG, target, now=clk.t),
                    gang_state(disp)]
        return out + [orch.snapshot(), dict(orch.by_outcome)]

    out = both(drive)
    grow, shrink = out[1], out[3]
    assert grow["outcome"] == shrink["outcome"] == "applied"
    assert (grow["from_chips"], grow["to_chips"]) == (2, 4)
    assert grow["layout"].count("@") == 4
    assert out[5]["gangs"][GANG]["chips"] == 2


def _veto_all(side, disp, orch, clk):
    with disp.lock:
        disp.engine.veto_health("tpu-host-0", True)
        disp.engine.veto_health("tpu-host-1", True)
    return orch.resize(GANG, 4, now=clk.t)


def _cooling(side, disp, orch, clk):
    orch.cooldowns.cooldown_s = 60.0
    orch.cooldowns.note(f"{GANG}-2")
    return orch.resize(GANG, 4, now=clk.t)


def _pause_timeout(side, disp, orch, clk):
    gc = side.coordinator.GangTokenCoordinator(clock=clk)
    gc.pause = lambda gang, timeout=None: False
    orch.gangcoord = gc
    return orch.resize(GANG, 4, now=clk.t)


REFUSALS = {
    "unknown-gang": lambda s, d, o, c: o.resize("ns/ghost", 2, now=c.t),
    "target-zero": lambda s, d, o, c: o.resize(GANG, 0, now=c.t),
    "target-past-members": lambda s, d, o, c: o.resize(GANG, 5, now=c.t),
    "noop": lambda s, d, o, c: o.resize(GANG, 2, now=c.t),
    "move-budget": lambda s, d, o, c: (
        setattr(o.cfg, "max_moves", 0) or o.resize(GANG, 4, now=c.t)),
    "no-free-chips": _veto_all,
    "shrink-no-capacity": lambda s, d, o, c: o.resize(GANG, 1, now=c.t),
    "cooldown": _cooling,
    "pause-timeout": _pause_timeout,
}
REASONS = {"target-zero": "target-out-of-range",
           "target-past-members": "target-out-of-range",
           "shrink-no-capacity": "no-capacity"}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_every_refusal_rail_answers_as_jax_does(case):
    def drive(side):
        clk = FakeClock()
        disp = make_disp(side, clock=clk)
        bind_gang(side, disp)
        orch = make_orch(side, disp, clk)
        before = gang_state(disp)
        out = REFUSALS[case](side, disp, orch, clk)
        assert gang_state(disp) == before          # nothing moved
        return out, dict(orch.by_outcome), orch.snapshot()["gangs"]

    out, by_outcome, _gangs = both(drive)
    reason = REASONS.get(case, case)
    if case == "no-free-chips":
        assert out["reason"] in ("no-free-chips", "no-capacity")
    else:
        assert out["reason"] == reason
    assert out["outcome"] == ("noop" if case == "noop" else "refused")


def _flip_case(case: str):
    def drive(side, tmp):
        clk = FakeClock()
        hosts, mesh = ((4, (1, 1)) if case == "port-slots" else (2, (2, 2)))
        disp = make_disp(side, hosts=hosts, mesh=mesh, clock=clk)
        gc = side.coordinator.GangTokenCoordinator(clock=clk)
        disp.attach_gang_coordinator(gc)
        bind_gang(side, disp)
        path = str(tmp / f"{case}-{side is PORT}.jsonl")
        orch = make_orch(side, disp, clk, gangcoord=gc, journal=path)
        eng = disp.engine
        before = gang_state(disp)
        counts = {n: bm.count() for n, bm in eng.ports.items()}
        plans = []

        def steal(plan, only_last=False):
            moves = plan["moves"][-1:] if only_last else plan["moves"]
            with disp.lock:
                for mv in moves:
                    c = eng.leaf_cells[mv["to_chip"]]
                    side.cell.reserve_resource(c, c.available, 0)

        if case == "restate-raises":
            def restate(plan):
                raise RuntimeError("restate blew up")
        elif case == "flip-conflict":
            def restate(plan):
                plans.append(plan)
                if not plan.get("revert"):
                    steal(plan)
        elif case == "port-slots":
            def restate(plan):
                plans.append(plan)
                if not plan.get("revert"):
                    steal(plan, only_last=True)
        else:                                     # sync-raises
            def restate(plan):
                plans.append(plan)

            def boom(_pod):
                raise RuntimeError("sync exploded")

            disp._sync_gang = boom
        orch.register_restater(GANG, restate)
        out = orch.resize(GANG, 4, now=clk.t)
        assert gang_state(disp) == before
        assert {n: bm.count() for n, bm in eng.ports.items()} == counts
        paused = {s["gang"]: s["paused"] for s in gc.grant_states(clk.t)}
        return (out, plans, journal(path), side.el.recover(path),
                paused.get(GANG, False))
    return drive


@pytest.mark.parametrize("case", ["restate-raises", "flip-conflict",
                                  "port-slots", "sync-raises"])
def test_a_failed_resize_rolls_back_whole_as_jax(case, tmp_path):
    drive = _flip_case(case)
    got, want = drive(PORT, tmp_path), drive(JAX, tmp_path)
    assert got == want
    out, plans, records, rec, paused = got
    assert out["outcome"] == "rolled_back" and not paused
    assert rec[GANG]["mesh"] == "old"
    events = [r["event"] for r in records]
    if case == "restate-raises":
        assert events == ["plan", "pause", "abort"]
    else:
        # the data plane followed the control plane back
        assert events == ["plan", "pause", "restate", "unrestate", "abort"]
        assert [p.get("revert", False) for p in plans] == [False, True]
        assert plans[1]["to_chips"] == plans[0]["from_chips"]


def test_shrink_packing_respects_memory_headroom_as_jax():
    def drive(side):
        clk = FakeClock()
        disp = make_disp(side, clock=clk)
        bind_gang(side, disp)
        orch = make_orch(side, disp, clk)
        grow = orch.resize(GANG, 4, now=clk.t)
        chips = sorted({b[1][0][0] for b in gang_state(disp).values()})
        with disp.lock:
            full = disp.engine.leaf_cells[chips[0]]
            side.cell.reserve_resource(full, 0.0, full.free_memory)
        return grow, orch.resize(GANG, 3, now=clk.t), chips

    grow, out, chips = both(drive)
    assert out["outcome"] == "applied" and len(out["moves"]) == 1
    assert out["moves"][0]["to_chip"] in chips[:3]
    assert out["moves"][0]["to_chip"] != chips[0]


@pytest.mark.parametrize("cut", ["whole", "before-flip", "torn", "absent"])
def test_journal_recovery_matches_jax(cut, tmp_path):
    def drive(side):
        clk = FakeClock()
        disp = make_disp(side, clock=clk)
        bind_gang(side, disp)
        path = str(tmp_path / f"{side is PORT}.jsonl")
        orch = make_orch(side, disp, clk, journal=path)
        out = orch.resize(GANG, 4, now=clk.t)
        lines = open(path).read().splitlines()
        probe = str(tmp_path / f"{cut}-{side is PORT}.jsonl")
        if cut != "absent":
            with open(probe, "w") as f:
                f.write("\n".join(lines if cut == "whole" else lines[:3])
                        + "\n")
                if cut == "torn":
                    f.write('{"event": "flip", "gang": "' + GANG
                            + '", "chi')
        return out["layout"], journal(path), side.el.recover(probe)

    layout, records, rec = both(drive)
    assert [r["event"] for r in records] == ["plan", "pause", "restate",
                                            "flip", "resume"]
    if cut == "absent":
        assert rec == {}
    elif cut == "whole":
        assert rec[GANG]["mesh"] == "new" and rec[GANG]["layout"] == layout
    else:
        assert rec[GANG]["mesh"] == "old"


def test_the_port_recovers_a_jax_journal_and_back(tmp_path):
    def drive(side):
        clk = FakeClock()
        disp = make_disp(side, clock=clk)
        bind_gang(side, disp)
        path = str(tmp_path / f"{side is PORT}.jsonl")
        orch = make_orch(side, disp, clk, journal=path)
        orch.resize(GANG, 4, now=clk.t)
        orch.resize(GANG, 1, now=clk.t)
        orch.resize(GANG, 3, now=clk.t)
        return path

    port_path, jax_path = drive(PORT), drive(JAX)
    assert elastic.recover(jax_path) == jelastic.recover(jax_path) == \
        jelastic.recover(port_path) == elastic.recover(port_path)


def test_a_disabled_plane_is_inert_and_its_stream_unchanged(tmp_path):
    def drive(side):
        clk = FakeClock()
        disp = make_disp(side, clock=clk)
        dec = side.decisions.DecisionRecorder(clock=clk, seed=1)
        disp.attach_decisions(dec)
        bind_gang(side, disp)
        before = dict(dec.counts())
        path = str(tmp_path / f"off-{side is PORT}.jsonl")
        off = side.el.ElasticOrchestrator(disp, enabled=False,
                                          journal_path=path, clock=clk)
        out = off.resize(GANG, 4, now=clk.t)
        inert = (dict(dec.counts()) == before, os.path.exists(path),
                 off.resizes_total)
        make_orch(side, disp, clk).resize(GANG, 4, now=clk.t)
        return out, inert, dec.counts().get("elastic-resize"), off.snapshot()

    out, inert, recorded, snap = both(drive)
    assert out["outcome"] == "disabled"
    assert inert == (True, False, 0) and recorded == 1
    assert snap["enabled"] is False


def test_an_elastic_flip_on_a_sharded_plane_applies_where_jax_rolls_back():
    """A divergence on purpose. On a 2-shard cell-route plane the port's
    flip re-homes each member in its shard's engine, publishes the
    gang's whole membership through ``_sync_gang_fleet`` and wakes the
    owning shard: the grow applies, the gang coordinator holds the new
    chips and the cross-shard invariants stay clean. The JAX flip reaches
    for the plane's ``_sync_gang``/``_cond``, which a sharded dispatcher
    lacks, and rolls the gang back whole."""
    def drive(side):
        clk = FakeClock()
        by_host: dict = {}
        for chip in side.discovery.FakeTopology(hosts=2,
                                                mesh=(2, 2)).chips():
            by_host.setdefault(chip.host, []).append(chip)
        disp = side.shard.make_dispatcher(by_host, shards=2, route="cell",
                                          clock=clk)
        gc = side.coordinator.GangTokenCoordinator(clock=clk)
        disp.attach_gang_coordinator(gc)
        bind_gang(side, disp)
        before = gang_state(disp)
        out = make_orch(side, disp, clk, gangcoord=gc).resize(
            GANG, 4, now=clk.t)
        after = gang_state(disp)
        with disp.lock:
            found = invariants.check_cross_shard(
                [sh.engine for sh in disp.shards], set())
        held = sorted({b[0][0] for k, (_n, b, _p, _i) in after.items()
                       if gc.gang_for(b[0][0], k) == GANG})
        return out, before, after, found, held

    got, want = drive(PORT), drive(JAX)
    out, before, after, found, held = got
    assert out["outcome"] == "applied" and out["to_chips"] == 4
    chips = {b[0][0] for _node, b, _port, _ids in after.values()}
    assert len(chips) == 4 and held == sorted(chips)
    assert len({port for _n, _b, port, _i in after.values()}) == 4
    assert found == []
    jout, jbefore, jafter, jfound, _ = want
    assert jout["outcome"] == "rolled_back" and "_cond" in jout["reason"]
    assert jafter == jbefore == before and jfound == []
    assert out["moves"] == jout["moves"]


class _FakeSlo:
    def __init__(self):
        self.tenants: dict = {}

    def burn(self, tenant, fast=3.0, slow=3.0):
        self.tenants[tenant] = [{"objective": "grant-wait-p99<=500ms",
                                 "burn_fast": fast, "burn_slow": slow,
                                 "firing": True, "budget_remaining": 0.1}]

    def state(self, now=None):
        return {"tenants": dict(self.tenants)}


class _RecordingElastic:
    def __init__(self):
        self.calls: list = []

    def resize(self, gang, target, reason=""):
        self.calls.append((gang, target, reason))
        return {"gang": gang, "outcome": "applied"}


@pytest.mark.parametrize("grow", [False, True], ids=["off", "on"])
def test_the_rightsizers_elastic_grow_matches_jax(grow):
    """A hot gang tenant: with ``elastic_grow`` off the plan has no
    ``elastic`` key and still grows the gang's token share; with it on
    the plan proposes one more chip and apply hands it to the elastic
    plane."""
    def drive(side):
        clk = FakeClock()
        disp = make_disp(side, clock=clk)
        gc = side.coordinator.GangTokenCoordinator(clock=clk)
        disp.attach_gang_coordinator(gc)
        dec = side.decisions.DecisionRecorder(clock=clk, seed=1)
        disp.attach_decisions(dec)
        gang = bind_gang(side, disp)
        slo = _FakeSlo()
        slo.burn("ns")
        rec = _RecordingElastic()
        rz = side.rz.Rightsizer(
            disp, slo=slo, gang_coordinator=gc, clock=clk,
            cfg=side.rz.RightsizeConfig(elastic_grow=grow), elastic=rec)
        plan = rz.plan(clk.t)
        result = rz.apply({"resizes": [], "moves": [],
                           "elastic": plan.get("elastic", [])})
        return gang, plan, result, rec.calls, dict(dec.counts())

    gang, plan, result, calls, _counts = both(drive)
    assert any(r["gang"] == gang for r in plan["resizes"])
    if not grow:
        assert "elastic" not in plan and calls == []
        return
    (prop,) = plan["elastic"]
    assert prop["gang"] == gang and prop["reason"] == "slo-firing"
    assert (prop["from_chips"], prop["to_chips"]) == (2, 3)
    assert calls == [(gang, 3, "rightsize-grow")]
    assert result["elastic"] == [{"gang": gang, "outcome": "applied"}]


@pytest.mark.parametrize("leg", ["elastic", "static", "bare"])
def test_the_demand_ramp_sim_matches_jax(leg, tmp_path):
    kw = {"elastic": {}, "static": {"elastic": False},
          "bare": {"attach": False}}[leg]
    got = sim.simulate_elastic(
        seed=7, journal_path=str(tmp_path / "p.jsonl"), **kw)
    want = jsim.simulate_elastic(
        seed=7, journal_path=str(tmp_path / "j.jsonl"), **kw)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    if leg == "elastic":
        assert got["resizes_applied"] == 3
        assert got["chips"] == {"start": 2, "final": 1, "min": 1, "max": 4}
        assert got["goodput_ratio"] >= 0.9
    else:
        # the disabled leg's decision stream is the bare one's
        assert got["decision_kinds"] == sim.simulate_elastic(
            seed=7, attach=False)["decision_kinds"]
        assert not any(k.startswith("elastic")
                       for k in got["decision_kinds"])


# --------------------------------------------------------------------------
# the service, the doctor and topcli
# --------------------------------------------------------------------------

def _http(method, port, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=5) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _doctor_line(side, port: int) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        side.doctor.check_elastic(f"127.0.0.1:{port}", 5.0)
    return buf.getvalue().replace(str(port), "PORT")


def test_the_service_serves_an_attached_elastic_plane_as_jax():
    def drive(side):
        svc = side.service.SchedulerService(
            side.engine.SchedulerEngine(), side.registry.TelemetryRegistry())
        svc.serve()
        try:
            resize = {"gang": "a/b", "target_chips": 2}
            out = [_http("GET", svc.port, "/elastic"),
                   _http("POST", svc.port, "/elastic/resize", resize),
                   _doctor_line(side, svc.port)]
            svc.attach_elastic(side.el.ElasticOrchestrator(
                svc.dispatcher, clock=lambda: 5.0))
            state = _http("GET", svc.port, "/elastic")
            out += [state, _http("POST", svc.port, "/elastic/resize",
                                 resize),
                    _doctor_line(side, svc.port)]
            svc.elastic.by_outcome = {"rolled_back": 3, "applied": 1}
            out.append(_doctor_line(side, svc.port))
            out.append(side.topcli.render_elastic(
                {"elastic": _http("GET", svc.port, "/elastic")[1],
                 "chips": 8}))
        finally:
            svc.close()
        return out

    out = both(drive)
    assert out[0] == (200, {"attached": False, "enabled": False})
    assert out[1][0] == 409 and "elastic" in out[1][1]["error"]
    assert out[2].split()[:2] == ["elastic", "skip"]
    assert out[3][0] == 200 and out[3][1]["attached"]
    assert out[4][0] == 409 and out[4][1]["reason"] == "unknown-gang"
    assert out[5].split()[:2] == ["elastic", "ok"]
    assert out[6].split()[:2] == ["elastic", "fail"]


def test_topcli_renders_an_attached_resize_as_jax():
    def drive(side):
        clk = FakeClock()
        disp = make_disp(side, clock=clk)
        bind_gang(side, disp)
        orch = make_orch(side, disp, clk, cooldown_s=120.0)
        orch.resize(GANG, 4, now=clk.t)
        return side.topcli.render_elastic({"elastic": orch.snapshot(),
                                           "chips": 8})

    out = both(drive)
    assert GANG in out and "2 -> 4" in out and "applied" in out


def _service_cli(args, tmp_path):
    reg = registry.TelemetryRegistry()
    reg.serve(port=0)
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeshare_tpu_torch.scheduler.service",
         "--registry-port", str(reg.port), "--port", "0",
         "--no-remote-write", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    return reg, proc


def test_the_service_cli_attaches_both_planes(tmp_path):
    ap_journal = str(tmp_path / "autopilot.jsonl")
    el_journal = str(tmp_path / "elastic.jsonl")
    reg, proc = _service_cli(
        ["--autopilot", "--autopilot-budget", "3", "--autopilot-journal",
         ap_journal, "--elastic", "--elastic-journal", el_journal],
        tmp_path)
    try:
        line = proc.stdout.readline()
        assert line.startswith("READY"), proc.stderr.read()
        port = int(line.split()[1])
        code, ap = _http("GET", port, "/autopilot")
        assert code == 200 and ap["attached"] and ap["enabled"]
        code, plan = _http("POST", port, "/autopilot/plan", {})
        assert code == 200 and plan["plan"]["budget"] == 3
        code, el = _http("GET", port, "/elastic")
        assert code == 200 and el["attached"] and el["enabled"]
        assert el["cooldowns"]["cooldown_s"] == 120.0
        code, out = _http("POST", port, "/elastic/resize",
                          {"gang": "a/b", "target_chips": 2})
        assert code == 409 and out["reason"] == "unknown-gang"
        code, rs = _http("GET", port, "/rightsize")
        assert rs == {"attached": False, "enabled": False}
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=20)
        reg.close()
    assert rc == 0


# --------------------------------------------------------------------------
# the data plane on 4 gloo ranks
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pool():
    with RankPool(4) as p:
        yield p


def _jax_tinymlp():
    """JAX's tinymlp params and 12 batches, as numpy (the same inputs
    both packages train on)."""
    import jax

    from kubeshare_tpu.models import tinymlp as jtiny

    params = jax.tree_util.tree_map(np.asarray,
                                    jtiny.init(jax.random.PRNGKey(0)))
    batches = [tuple(np.asarray(a) for a in
                     jtiny.batch_fn(jax.random.PRNGKey(100 + i)))
               for i in range(12)]
    return params, batches


def _jax_restate(transition: str, params):
    import jax
    import optax

    from kubeshare_tpu.elastic import restate_state
    from kubeshare_tpu.parallel.mesh import make_mesh, param_sharding

    devs = jax.devices()
    if transition == "grow-shrink":
        meshes = [make_mesh(devs[:n]) for n in (2, 4, 1)]
    else:
        meshes = [make_mesh(devs[:4], dp=dp, tp=tp)
                  for dp, tp in ((4, 1), (2, 2))]
    p = jax.device_put(params, param_sharding(meshes[0], params))
    s = optax.adam(LR).init(p)
    s = jax.device_put(s, param_sharding(meshes[0], s))
    out = []
    for mesh in meshes[1:]:
        p, s, stats = restate_state(p, s, mesh)
        out.append(stats)
    return out


@pytest.mark.parametrize("transition", ["grow-shrink", "relayout"])
def test_restate_stats_equal_jax_and_keep_every_value(pool, transition):
    params, _ = _jax_tinymlp()
    steps = pool.run(torch_ranks.elastic_restate, transition, params,
                     LR)[0]
    want = _jax_restate(transition, params)
    assert [stats for stats, _, _ in steps] == want
    key = "donated" if transition == "relayout" else "resharded"
    assert all(s[key] == 13 for s in want)    # 4 params, count, mu, nu
    leaves = [np.asarray(x) for x in
              __import__("jax").tree_util.tree_leaves(params)]
    for _, whole, _ in steps:
        # params come back bit for bit, Adam's fresh state zeros
        for got, want_leaf in zip(whole[:4], leaves):
            np.testing.assert_array_equal(got, want_leaf)
        assert all(not np.any(w) for w in whole[4:])


def _jax_trainer(params, batches, resize_at):
    import jax
    import optax

    from kubeshare_tpu.elastic import ElasticTrainer
    from kubeshare_tpu.models import tinymlp as jtiny

    devs = jax.devices()
    tr = ElasticTrainer(jtiny.loss_fn, optax.adam(LR), params,
                        devices=devs[:2])
    for i, b in enumerate(batches):
        if i in resize_at:
            tr.resize(devs[:resize_at[i]])
        tr.train_step(b)
    return tr


def test_the_trainer_resizes_2_4_1_with_zero_lost_steps(pool):
    params, batches = _jax_tinymlp()
    runs = pool.run(torch_ranks.elastic_trainer, params, batches, LR,
                    {4: [0, 1, 2, 3], 8: [0]})
    el, base = runs[0]["elastic"], runs[0]["base"]
    assert el["step"] == base["step"] == 12              # zero lost steps
    assert [(s, c) for s, c, _ in el["resizes"]] == [(4, 4), (8, 1)]
    assert el["count"] == 12.0
    jtr = _jax_trainer(params, batches, {4: 4, 8: 1})
    assert [(r["step"], r["chips"]) for r in jtr.resizes] == [(4, 4),
                                                             (8, 1)]
    assert [s for _, _, s in el["resizes"]] == [r["stats"]
                                               for r in jtr.resizes]
    np.testing.assert_allclose(el["losses"], jtr.losses,
                               rtol=JAX_RTOL, atol=JAX_ATOL)
    np.testing.assert_allclose(el["losses"], base["losses"],
                               rtol=BASE_RTOL, atol=BASE_ATOL)
    import jax
    for got, b, want in zip(el["params"], base["params"],
                            jax.tree_util.tree_leaves(jtr.params)):
        np.testing.assert_allclose(got, np.asarray(want),
                                   rtol=JAX_RTOL, atol=JAX_ATOL)
        np.testing.assert_allclose(got, b, rtol=BASE_RTOL, atol=BASE_ATOL)
    # ranks 2 and 3 trained only on the 4-rank mesh, and hold nothing now
    for r in (2, 3):
        e = runs[r]["elastic"]
        assert e["step"] == 12 and len(e["losses"]) == 4
        assert not e["in_mesh"] and e["params"] == [None] * 4


def test_restate_via_checkpoint_is_bit_exact(pool, tmp_path):
    params, batches = _jax_tinymlp()
    saved, restored, step, trained, meshes = pool.run(
        torch_ranks.elastic_checkpoint, str(tmp_path / "ck"), params,
        batches[:2], LR)[0]
    assert step == trained == 2
    assert all(m == (0,) for m in meshes)
    for a, b in zip(saved, restored):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("steal", [False, True], ids=["applied", "flip-fails"])
def test_the_orchestrator_resizes_a_gang_of_ranks(pool, tmp_path, steal):
    """The smoke's elastic drive at tinymlp size: rank 0's orchestrator
    takes the gang 2 → 4 → 1 chips mid-run and the ranks follow; with the
    second resize's flip made to fail, the trainer follows the mirrored
    plan back to 4 ranks and keeps training there."""
    params, batches = _jax_tinymlp()
    path = str(tmp_path / "elastic.jsonl")
    runs = pool.run(torch_ranks.elastic_orchestrated, path, params,
                    batches, LR, {4: 4, 8: 1}, 8 if steal else None)
    r0 = runs[0]
    assert r0["step"] == 12 and all(r["step"] == 12 for r in runs[1:])
    start, grow = r0["outcomes"][:2]
    assert (start["from_chips"], start["to_chips"]) == (1, 2)
    assert (grow["outcome"], grow["from_chips"], grow["to_chips"]) == (
        "applied", 2, 4)
    base = pool.run(torch_ranks.elastic_trainer, params, batches, LR,
                    {})[0]["base"]
    np.testing.assert_allclose(r0["losses"], base["losses"],
                               rtol=BASE_RTOL, atol=BASE_ATOL)
    if steal:
        assert r0["outcomes"][2]["outcome"] == "rolled_back"
        assert r0["resizes"] == [(4, 4), (8, 1), (8, 4)]
        assert r0["chips"] == 4
        assert r0["recover"]["sim/trainer"]["mesh"] == "old"
        assert all(r["resizes"] == 3 for r in runs[1:])
    else:
        assert r0["outcomes"][2]["outcome"] == "applied"
        assert r0["resizes"] == [(4, 4), (8, 1)]
        assert r0["chips"] == 1
        rec = r0["recover"]["sim/trainer"]
        assert rec["mesh"] == "new" and len(rec["chips"]) == 1
