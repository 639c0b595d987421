"""The port's autopilot plane against the JAX package's: the token
scheduler's ``on_demand`` hook on both cores, the shared cooldown ledger,
fragmentation scoring, the planner with its budget, hysteresis, cooldown
and veto rails, the journaled rebalancer with gang units and crash
recovery, elastic quota lending and revocation, the controller's cycle,
and the service's attached ``/autopilot`` with its doctor check and
topcli view.

Mirrors ``tests/test_autopilot.py``. Each case drives both packages with
the same seeded operations on fake fleets and fake clocks and compares
what they return: plans and snapshots exactly (they are rounded to 6
decimals by both), window fractions to 1e-9. No device is involved. Each
side's dispatcher and rebalancer dump a private flight recorder, never
the JAX default one (its retained dumps are what ``tests/test_ha.py``
counts).
"""

import contextlib
import io
import json
import random
import threading
import types
import urllib.error
import urllib.request

import pytest

from kubeshare_tpu import autopilot as jautopilot
from kubeshare_tpu import constants as JC
from kubeshare_tpu import doctor as jdoctor
from kubeshare_tpu import topcli as jtopcli
from kubeshare_tpu.autopilot import elastic as jelastic
from kubeshare_tpu.autopilot import rebalancer as jrebalancer
from kubeshare_tpu.chaos import invariants as jinvariants
from kubeshare_tpu.gang import coordinator as jcoordinator
from kubeshare_tpu.isolation import tokensched as jtokensched
from kubeshare_tpu.obs import flight as jflight
from kubeshare_tpu.resilience import faults as jfaults
from kubeshare_tpu.scheduler import dispatcher as jdispatcher
from kubeshare_tpu.scheduler import engine as jengine
from kubeshare_tpu.scheduler import service as jservice
from kubeshare_tpu.telemetry import registry as jregistry
from kubeshare_tpu.topology import cell as jcell
from kubeshare_tpu.topology import discovery as jdiscovery
from kubeshare_tpu_torch import autopilot
from kubeshare_tpu_torch import constants as C
from kubeshare_tpu_torch import doctor, topcli
from kubeshare_tpu_torch.autopilot import elastic as elastic_mod
from kubeshare_tpu_torch.autopilot import rebalancer
from kubeshare_tpu_torch.chaos import invariants
from kubeshare_tpu_torch.gang import coordinator
from kubeshare_tpu_torch.isolation import tokensched
from kubeshare_tpu_torch.obs import flight
from kubeshare_tpu_torch.resilience import faults
from kubeshare_tpu_torch.scheduler import dispatcher
from kubeshare_tpu_torch.scheduler import engine
from kubeshare_tpu_torch.scheduler import service
from kubeshare_tpu_torch.telemetry import registry
from kubeshare_tpu_torch.topology import cell
from kubeshare_tpu_torch.topology import discovery

PORT = types.SimpleNamespace(
    C=C, ap=autopilot, doctor=doctor, topcli=topcli, elastic=elastic_mod,
    rebalancer=rebalancer,
    invariants=invariants, coordinator=coordinator, tokensched=tokensched,
    flight=flight, faults=faults, dispatcher=dispatcher, engine=engine,
    service=service, registry=registry, cell=cell, discovery=discovery)
JAX = types.SimpleNamespace(
    C=JC, ap=jautopilot, doctor=jdoctor, topcli=jtopcli, elastic=jelastic,
    rebalancer=jrebalancer,
    invariants=jinvariants, coordinator=jcoordinator,
    tokensched=jtokensched, flight=jflight, faults=jfaults,
    dispatcher=jdispatcher, engine=jengine, service=jservice,
    registry=jregistry, cell=jcell, discovery=jdiscovery)
SIDES = (PORT, JAX)

#: window fractions (lent credit, effective shares) agree to this
SHARE_TOL = 1e-9


@pytest.fixture(autouse=True)
def private_recorders(monkeypatch):
    """Each dispatcher and rebalancer dumps into a recorder of its own,
    and a test fails if the JAX default recorder dumped all the same;
    no fault injector outlives its test."""
    for side in SIDES:
        rec = side.flight.FlightRecorder()
        for mod in (side.dispatcher, side.rebalancer):
            monkeypatch.setattr(mod, "default_recorder",
                                lambda rec=rec: rec)
    rec = jflight.default_recorder()
    fired = []
    real = rec.trigger
    monkeypatch.setattr(rec, "trigger",
                        lambda reason, **kw: fired.append(reason)
                        or real(reason, **kw))
    yield
    for side in SIDES:
        side.faults.install(None)
    assert fired == []


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def make_engine(side, hosts=2, mesh=(2, 2), clock=None):
    eng = side.engine.SchedulerEngine(**({"clock": clock} if clock else {}))
    by_host: dict = {}
    for chip in side.discovery.FakeTopology(hosts=hosts, mesh=mesh).chips():
        by_host.setdefault(chip.host, []).append(chip)
    for host, chips in sorted(by_host.items()):
        eng.add_node(host, chips)
    return eng


def shared(side, request="0.5", limit="1.0", **extra):
    labels = {side.C.POD_TPU_REQUEST: request, side.C.POD_TPU_LIMIT: limit}
    labels.update(extra)
    return labels


def gang(side, name, headcount=2, request="0.5"):
    return shared(side, request=request,
                  **{side.C.POD_GROUP_NAME: name,
                     side.C.POD_GROUP_HEADCOUNT: str(headcount),
                     side.C.POD_GROUP_THRESHOLD: "1.0"})


def fragged_cluster(side, registry_=None):
    """JAX's scenario: two waves pack both 2x2 hosts (0.6 + 0.4 a chip),
    then every 0.6 pod leaves — 8 slivers, score 1.0."""
    eng = make_engine(side)
    disp = side.dispatcher.Dispatcher(eng, registry_)
    a = [disp.submit("ns", f"a{i}", shared(side, "0.6")) for i in range(8)]
    disp.step()
    b = [disp.submit("ns", f"b{i}", shared(side, "0.4")) for i in range(8)]
    disp.step()
    assert all(disp.outcome(k).status == "bound" for k in a + b)
    for k in a:
        disp.delete(k)
    return eng, disp, b


def churned(side, seed: int, hosts: int, mesh):
    """A seeded churn of shared pods and two-member gangs on a fake
    fleet: the same ops on either package."""
    rng = random.Random(seed)
    eng = make_engine(side, hosts=hosts, mesh=mesh)
    disp = side.dispatcher.Dispatcher(eng)
    live: list = []
    for i in range(60):
        if live and rng.random() < 0.35:
            disp.delete(live.pop(rng.randrange(len(live))))
        elif rng.random() < 0.15:
            for m in range(2):
                live.append(disp.submit("g", f"g{i}-{m}",
                                        gang(side, f"g{i}", 2, "0.5")))
        else:
            req = rng.choice(("0.2", "0.25", "0.4", "0.5", "0.6"))
            live.append(disp.submit("ns", f"p{i}", shared(side, req)))
        disp.step(float(i))
    for _ in range(3):
        disp.step(100.0)
    return eng, disp


def make_planner(side, disp, **kw):
    kw.setdefault("budget", 8)
    kw.setdefault("min_improvement", 0.05)
    kw.setdefault("cooldown_s", 60.0)
    kw.setdefault("clock", lambda: 0.0)
    return side.ap.Planner(disp, **kw)


def bookings(eng) -> dict:
    return {k: (p.node_name, list(p.bookings), p.port)
            for k, p in sorted(eng.pod_status.items())}


def journal(path) -> list:
    """The journal's records without their wall-clock times."""
    out = []
    for line in open(path).read().splitlines():
        rec = json.loads(line)
        rec.pop("t", None)
        out.append(rec)
    return out


# --------------------------------------------------------------------------
# the token scheduler's demand hook (the repair)
# --------------------------------------------------------------------------

def _sched(side, native: bool, clock=None):
    kw = {"native": native} if side is PORT else {"native": False}
    return side.tokensched.TokenScheduler(
        window_ms=10_000.0, base_quota_ms=100.0, min_quota_ms=5.0,
        clock=clock, chip="t", **kw)


def _demand_trace(side, native: bool, op: str) -> list:
    """What the hook saw on each call: the name, whether the lock was
    held (another thread could not take it), and whether the client
    held the token yet (the grant not decided)."""
    clk = FakeClock(0.0)
    sched = _sched(side, native, clk)
    sched.add_client("a", 0.5, 1.0)
    sched.add_client("b", 0.5, 1.0)
    seen = []

    def hook(name):
        took = []
        t = threading.Thread(
            target=lambda: took.append(sched._cond.acquire(blocking=False)))
        t.start()
        t.join()
        if took[0]:
            sched._cond.release()
        seen.append((name, not took[0], name in sched._held_since))

    sched.on_demand = hook
    sched.acquire("a", timeout=5.0)
    clk.t += 10.0
    if op == "renew":
        sched.renew("a", used_ms=10.0, timeout=5.0)
    else:
        sched.release("a", used_ms=10.0)
        sched.acquire("b", timeout=5.0)
    return seen


@pytest.mark.parametrize("op", ["acquire", "renew"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_on_demand_fires_under_the_lock_before_the_grant(native, op):
    got = _demand_trace(PORT, native, op)
    assert got == _demand_trace(JAX, False, op)
    assert len(got) == 2 and all(locked and not holding
                                 for _, locked, holding in got)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_on_demand_exceptions_are_swallowed(native):
    sched = _sched(PORT, native)
    sched.add_client("a", 0.5, 1.0)

    def boom(name):
        raise RuntimeError("policy bug")

    sched.on_demand = boom
    quota = sched.acquire("a", timeout=5.0)
    assert quota > 0 and "a" in sched._held_since
    sched.renew("a", used_ms=1.0, timeout=5.0)
    sched.release("a", used_ms=1.0)


# --------------------------------------------------------------------------
# the cooldown ledger
# --------------------------------------------------------------------------

def _ledger_script(side) -> list:
    clk = FakeClock(0.0)
    led = side.ap.CooldownLedger(cooldown_s=10.0, clock=clk)
    out = [led.cooling("a/p"), led.remaining("a/p")]
    led.note("a/p")
    out += [led.cooling("a/p"), led.remaining("a/p")]
    clk.t += 6.0
    out += [led.remaining("a/p"), led.snapshot()]
    led.note("b/q", now=3.0)
    clk.t += 5.0
    out += [led.cooling("a/p"), led.cooling("b/q"), led.snapshot(),
            led.remaining("b/q", now=12.5)]
    led.forget("b/q")
    out += [led.cooling("b/q"), led.snapshot(now=100.0)]
    return out


def test_the_cooldown_ledger_answers_as_jax_does():
    assert _ledger_script(PORT) == _ledger_script(JAX)


# --------------------------------------------------------------------------
# fragmentation scoring
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 7, 23])
@pytest.mark.parametrize("fleet", [(2, (2, 2)), (4, (1, 2))],
                         ids=["2x2x2", "4x1x2"])
def test_fragmentation_view_matches_jax_on_seeded_fleets(fleet, seed):
    views = []
    for side in SIDES:
        eng, _disp = churned(side, seed, *fleet)
        views.append((side.ap.fragmentation_view(eng),
                      side.ap.fragmentation_score(eng)))
    assert views[0] == views[1]


def test_fragmentation_view_sanity_and_veto_as_jax():
    out = []
    for side in SIDES:
        eng, disp, b = fragged_cluster(side)
        view = side.ap.fragmentation_view(eng)
        assert view["score"] == pytest.approx(1.0)
        assert view["stranded_free"] == pytest.approx(4.8)
        eng.veto_health("tpu-host-1", True)
        vetoed = side.ap.fragmentation_view(eng)
        assert set(vetoed["per_node"]) == {"tpu-host-0"}
        eng.veto_health("tpu-host-1", False)
        for k in b:
            disp.delete(k)
        out.append((view, vetoed, side.ap.fragmentation_view(eng)))
    assert out[0] == out[1]
    assert out[0][2]["largest_placeable_gang"] == 4


# --------------------------------------------------------------------------
# the planner and its rails
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [3, 7, 11])
def test_the_planner_matches_jax_on_seeded_churn(seed):
    out = []
    for side in SIDES:
        eng, disp = churned(side, seed, 2, (2, 2))
        before = bookings(eng)
        planner = make_planner(side, disp, budget=6)
        plan = planner.plan(now=0.0)
        assert bookings(eng) == before          # a pure dry run
        result = side.ap.Rebalancer(disp, planner=planner).apply(plan)
        applied = side.ap.fragmentation_view(eng)["score"]
        out.append((plan, result, bookings(eng), applied,
                    planner.plan(now=1.0)))
    assert out[0] == out[1]
    plan, result, _, applied, again = out[0]
    assert len(result["applied"]) == len(plan["moves"])
    assert applied == pytest.approx(plan["fragmentation_after"], abs=1e-6)
    # every pod just moved is cooling: the next plan skips them
    assert {s["pod"] for s in again["skipped"]
            if s["reason"] == "cooldown"} >= {
        mv["pod"] for mv in plan["moves"] if not mv["group"]}


RAILS = {
    "budget": dict(kw={"budget": 2}),
    "hysteresis": dict(kw={"min_improvement": 100.0}),
    "cooldown": dict(kw={"cooldown_s": 60.0}, cool=True),
    "veto": dict(kw={}, veto="tpu-host-0"),
}


@pytest.mark.parametrize("rail", sorted(RAILS))
def test_each_planner_rail_acts_as_jax_does(rail):
    spec = RAILS[rail]
    out = []
    for side in SIDES:
        eng, disp, b = fragged_cluster(side)
        planner = make_planner(side, disp, **spec["kw"])
        if spec.get("cool"):
            for k in b:
                planner.note_moved(k, now=0.0)
        if spec.get("veto"):
            eng.veto_health(spec["veto"], True)
        out.append(planner.plan(now=30.0))
    assert out[0] == out[1]
    plan = out[0]
    if rail == "budget":
        assert len(plan["moves"]) == 2
    elif rail == "hysteresis":
        assert plan["moves"] == [] and "hysteresis" in plan["reason"]
    elif rail == "cooldown":
        assert plan["moves"] == []
        assert {s["reason"] for s in plan["skipped"]} == {"cooldown"}
    else:
        assert all(mv["node"] != "tpu-host-0" for mv in plan["moves"])


def _bound_gang(side):
    eng = make_engine(side)
    disp = side.dispatcher.Dispatcher(eng)
    keys = [disp.submit("ns", f"g-{i}", gang(side, "g1"))
            for i in range(2)]
    for _ in range(3):
        disp.step()
    assert all(disp.outcome(k).status == "bound" for k in keys)
    return eng, disp, keys


@pytest.mark.parametrize("full", [False, True], ids=["fits", "full"])
def test_plan_migration_moves_whole_gangs_as_jax_does(full):
    out = []
    for side in SIDES:
        eng, disp, keys = _bound_gang(side)
        if full:
            with disp.lock:
                for c in eng.leaf_cells.values():
                    if c.available > 0:
                        side.cell.reserve_resource(c, c.available,
                                                   c.free_memory)
        out.append(disp.plan_migration(keys[0]))
    assert out[0] == out[1]
    if full:
        assert out[0] is None
    else:
        assert {mv["pod"] for mv in out[0]["moves"]} == {"ns/g-0", "ns/g-1"}


def test_the_planner_works_on_a_sharded_plane():
    """A divergence on purpose: on a sharded plane (4 hosts in 2 shards,
    JAX's slivers on each) the JAX planner reads the fleet façade's free
    list, which it lacks, and raises; the port's books each trial move on
    the pod's shard, and its prediction holds when the plan is
    applied."""
    from kubeshare_tpu.scheduler.shard import build_sharded as jbuild
    from kubeshare_tpu_torch.scheduler.shard import build_sharded

    def fleet(side):
        out = {}
        for chip in side.discovery.FakeTopology(hosts=4,
                                                mesh=(2, 2)).chips():
            out.setdefault(chip.host, ([], True))[0].append(chip)
        return out

    planes = []
    for side, build in ((PORT, build_sharded), (JAX, jbuild)):
        plane = build(fleet(side), 2, route="cell")
        a = [plane.submit("ns", f"a{i}", shared(side, "0.6"))
             for i in range(16)]
        plane.step()
        b = [plane.submit("ns", f"b{i}", shared(side, "0.4"))
             for i in range(16)]
        plane.step()
        for k in a:
            plane.delete(k)
        planes.append(plane)
    plane, jplane = planes
    with pytest.raises(AttributeError, match="free_list"):
        make_planner(JAX, jplane).plan(now=0.0)
    planner = make_planner(PORT, plane)
    plan = planner.plan(now=0.0)
    assert plan["moves"] and plan["improvement"] > 0
    result = autopilot.Rebalancer(plane, planner=planner).apply(plan)
    assert len(result["applied"]) == len(plan["moves"])
    assert autopilot.fragmentation_view(plane.engine)["score"] == \
        pytest.approx(plan["fragmentation_after"], abs=1e-6)


# --------------------------------------------------------------------------
# the rebalancer: gang units, rollback, journal recovery
# --------------------------------------------------------------------------

def test_a_gang_unit_rolls_back_whole_as_jax_does():
    out = []
    for side in SIDES:
        eng, disp, keys = _bound_gang(side)
        before = bookings(eng)
        calls = []

        def mover(mv, binding):
            calls.append(mv["pod"])
            return len(calls) < 2            # the second member fails

        mplan = disp.plan_migration(keys[0])
        group = eng.pod_status[keys[0]].group_key
        reb = side.ap.Rebalancer(disp, session_mover=mover)
        result = reb.apply({"generated_at": 0.0,
                            "moves": [dict(mv, group=group)
                                      for mv in mplan["moves"]]})
        # every member is back on its node (a node-local manager port
        # may be a new one, in both packages)
        assert {k: b[0] for k, b in bookings(eng).items()} == \
            {k: b[0] for k, b in before.items()}
        out.append((result, reb.applied_total, reb.rolled_back_total,
                    {k: eng.pod_status[k].group_rank for k in keys},
                    bookings(eng)))
    assert out[0] == out[1]
    assert out[0][0]["applied"] == [] and len(out[0][0]["rolled_back"]) == 2


def test_a_fault_injected_move_rolls_back_and_the_batch_goes_on():
    out = []
    for side in SIDES:
        eng, disp, b = fragged_cluster(side)
        side.faults.install(side.faults.Injector(side.faults.FaultSpec(
            kill_conn_after_frames=1, kill_conn_tag="autopilot-migrate")))

        def mover(mv, binding, side=side):
            inj = side.faults.active()
            return not (inj and inj.should_kill_connection(
                "autopilot-migrate", 1))

        planner = make_planner(side, disp)
        plan = planner.plan(now=0.0)
        result = side.ap.Rebalancer(disp, session_mover=mover,
                                    planner=planner).apply(plan)
        side.faults.install(None)
        out.append((plan, result, bookings(eng)))
    assert out[0] == out[1]
    plan, result, _ = out[0]
    assert len(result["failed"]) == len(result["rolled_back"]) == 1
    assert len(result["applied"]) == len(plan["moves"]) - 1


class Crash(BaseException):
    """Process death, not a move error."""


def test_a_crash_mid_batch_recovers_from_the_journal_as_jax(tmp_path):
    out = []
    for side in SIDES:
        path = str(tmp_path / f"{side is PORT}.jsonl")
        eng, disp, b = fragged_cluster(side)
        plan = make_planner(side, disp).plan(now=0.0)
        calls = []

        def mover(mv, binding):
            calls.append(mv["pod"])
            if len(calls) == 2:
                raise Crash()
            return True

        reb = side.ap.Rebalancer(disp, journal_path=path,
                                 session_mover=mover)
        assert reb.recovered is None
        with pytest.raises(Crash):
            reb.apply(plan)
        reb2 = side.ap.Rebalancer(disp, journal_path=path)
        third = reb2.apply({"generated_at": 0.0,
                            "moves": [plan["moves"][2]]})
        out.append((reb2.recovered, third, journal(path), bookings(eng)))
    assert out[0] == out[1]
    recovered, third, records, _ = out[0]
    assert recovered["batch"] == "batch-1"
    assert len(recovered["completed"]) == 1
    assert third["batch"] == "batch-2"
    assert [r["event"] for r in records].count("batch_recovered") == 1


def test_a_registry_restart_mid_apply_never_double_moves(tmp_path):
    """JAX's double fault: the registry restarts mid-batch and the
    process dies on the next move. The new incarnation folds the journal,
    moves nothing twice, and the engine and both journals stay clean."""
    out = []
    for side in SIDES:
        reg_path = str(tmp_path / f"reg-{side is PORT}.jsonl")
        ap_path = str(tmp_path / f"ap-{side is PORT}.jsonl")
        eng, disp, b = fragged_cluster(
            side, side.registry.TelemetryRegistry(journal=reg_path))
        plan = make_planner(side, disp).plan(now=0.0)
        calls = []

        def mover(mv, binding, side=side, disp=disp):
            calls.append(mv["pod"])
            if len(calls) == 1:
                disp.registry._journal.close()
                disp.registry = side.registry.TelemetryRegistry(
                    journal=reg_path)
            if len(calls) == 2:
                raise Crash()
            return True

        reb = side.ap.Rebalancer(disp, journal_path=ap_path,
                                 session_mover=mover)
        with pytest.raises(Crash):
            reb.apply(plan)
        reb2 = side.ap.Rebalancer(disp, journal_path=ap_path)
        result = reb2.apply(make_planner(side, disp).plan(now=0.0))
        assert not result["rolled_back"]
        inv = side.invariants
        assert inv.check_autopilot_journal_idempotent(ap_path) == []
        assert inv.check_engine(eng) == []
        disp.registry._journal.close()
        assert inv.check_registry_replay_idempotent(reg_path) == []
        out.append((reb2.recovered, result, journal(ap_path),
                    bookings(eng)))
    assert out[0] == out[1]


# --------------------------------------------------------------------------
# elastic quota: idle-share lending and demand-triggered revocation
# --------------------------------------------------------------------------

def _hot_pair(side, native: bool):
    """JAX's pair: idle lender A (0.6/1.0) and hot borrower B (0.2/0.3,
    ~0.26 of a 10 s window) on a fake ms clock."""
    clk = FakeClock()
    sched = _sched(side, native, clk)
    sched.add_client("A", 0.6, 1.0)
    sched.add_client("B", 0.2, 0.3)
    quota = side.ap.ElasticQuota({"t": sched})
    for _ in range(4):
        sched.acquire("B", timeout=5.0)
        clk.t += 650.0
        sched.release("B", used_ms=650.0)
        clk.t += 50.0
    return clk, sched, quota


def _close(a, b) -> bool:
    return all(abs(x - y) <= SHARE_TOL for x, y in zip(a, b))


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_idle_headroom_is_lent_to_the_hot_borrower_as_jax(native):
    out = []
    for side, nat in ((PORT, native), (JAX, False)):
        _clk, sched, quota = _hot_pair(side, nat)
        summary = quota.step()
        out.append((summary, quota.snapshot(), sched.effective("B"),
                    sched.shares()))
    (summary, snap, eff, base), jax_out = out
    assert summary == jax_out[0] and snap == jax_out[1]
    assert base == jax_out[3] == {"A": (0.6, 1.0), "B": (0.2, 0.3)}
    assert _close(eff, jax_out[2]) and _close(eff, (0.65, 0.75))
    assert summary["t"]["lent"] == pytest.approx(0.45, abs=SHARE_TOL)
    assert summary["t"]["lenders"] == ["A"]
    assert summary["t"]["borrowers"] == ["B"]


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_credit_is_revoked_within_the_lenders_own_acquire(native):
    out = []
    for side, nat in ((PORT, native), (JAX, False)):
        clk, sched, quota = _hot_pair(side, nat)
        quota.step()
        clk.t += 500.0
        hook = sched.on_demand
        at_hook = []

        def watch(name, hook=hook, sched=sched, at_hook=at_hook):
            hook(name)
            # still inside the acquire, before its grant decision
            at_hook.append((name, sched.effective("B"),
                            name in sched._held_since))

        sched.on_demand = watch
        sched.acquire("A", timeout=5.0)
        after = (quota.revocations, quota.reclaimed_ms,
                 quota.snapshot()["chips"]["t"])
        sched.release("A", used_ms=1.0)
        out.append((at_hook, after, quota.step()))
    assert out[0] == out[1]
    at_hook, (revocations, reclaimed, credits), again = out[0]
    assert at_hook == [("A", (0.2, 0.3), False)]
    assert revocations == 1 and credits == {}
    assert reclaimed == pytest.approx(0.45 * 500.0, rel=1e-9)
    assert again["t"]["lent"] == pytest.approx(0.45, rel=1e-3)


def test_lending_is_inert_without_borrowers_or_peers():
    out = []
    for side in SIDES:
        sched = _sched(side, False, FakeClock())
        sched.add_client("solo", 0.5, 1.0)
        quota = side.ap.ElasticQuota({"t": sched})
        first = quota.step()
        sched.add_client("other", 0.3, 0.5)
        out.append((first, quota.step(), sched.effective("solo"),
                    sched.effective("other")))
    assert out[0] == out[1]
    assert out[0][0]["t"]["lent"] == out[0][1]["t"]["lent"] == 0.0


def test_lending_skips_and_counts_when_set_effective_refuses():
    out = []
    for side in SIDES:
        _clk, sched, quota = _hot_pair(side, False)
        sched.set_effective = lambda *a, **kw: False
        before = side.elastic._SKIPPED.value("no-set-effective")
        summary = quota.step()
        out.append((summary, quota.snapshot()["chips"].get("t", {}),
                    sched.effective("B"),
                    side.elastic._SKIPPED.value("no-set-effective")
                    - before))
    assert out[0] == out[1]
    assert out[0][0]["t"]["lent"] == 0.0 and out[0][3] == 1


def test_gang_credit_is_raised_uniformly_and_restored():
    """A borrower that is a gang member is raised on every member chip
    through ``set_effective_gang``, and the lender's demand restores the
    whole gang at the next step."""
    out = []
    for side in SIDES:
        clk = FakeClock()
        scheds = {}
        for chip in ("c0", "c1"):
            s = scheds[chip] = _sched(side, False, clk)
            s.add_client("A", 0.6, 1.0)
            s.add_client("B", 0.2, 0.3)
        coord = side.coordinator.GangTokenCoordinator(clock=clk)
        for chip, s in scheds.items():
            coord.attach_chip(chip, s)
        coord.register_gang("g", [("c0", "B"), ("c1", "B")])
        quota = side.ap.ElasticQuota(scheds, gang_coordinator=coord)
        s0 = scheds["c0"]
        for _ in range(4):
            s0.acquire("B", timeout=5.0)
            clk.t += 650.0
            s0.release("B", used_ms=650.0)
            clk.t += 50.0
        step = quota.step()
        raised = {c: s.effective("B") for c, s in scheds.items()}
        s0.acquire("A", timeout=5.0)       # the lender's demand returns
        mid = {c: s.effective("B") for c, s in scheds.items()}
        clk.t += 6000.0
        s0.release("A", used_ms=6000.0)    # busy: no longer a lender
        quota.step()
        restored = {c: s.effective("B") for c, s in scheds.items()}
        out.append((step, raised, mid, restored, quota.revocations))
    assert out[0] == out[1]
    step, raised, mid, restored, _ = out[0]
    assert step["c0"]["borrowers"] == ["B"]
    assert raised["c0"] == raised["c1"] != (0.2, 0.3)
    # the lender's chip is whole at once, its sibling at the next step
    assert mid == {"c0": (0.2, 0.3), "c1": raised["c1"]}
    assert restored == {"c0": (0.2, 0.3), "c1": (0.2, 0.3)}


# --------------------------------------------------------------------------
# the controller
# --------------------------------------------------------------------------

def test_the_autopilot_cycle_closes_the_loop_as_jax():
    out = []
    for side in SIDES:
        eng, disp, b = fragged_cluster(side)
        planner = make_planner(side, disp)
        ap = side.ap.Autopilot(disp, planner=planner,
                               rebalancer=side.ap.Rebalancer(
                                   disp, planner=planner))
        first = ap.cycle(now=0.0)
        again = ap.cycle(now=1.0)
        out.append((first, again, ap.snapshot(), bookings(eng)))
    assert out[0] == out[1]
    first, again, snap, _ = out[0]
    assert len(first["applied"]) == len(first["moves"]) > 0
    assert first["fragmentation_applied"] == pytest.approx(
        first["fragmentation_after"], abs=1e-9)
    assert again["applied"] == [] and snap["cycles"] == 2


def test_a_disabled_autopilot_is_inert(monkeypatch):
    out = []
    for side in SIDES:
        eng, disp, b = fragged_cluster(side)
        ap = side.ap.Autopilot(disp, planner=make_planner(side, disp),
                               enabled=False)

        def boom(*a, **k):
            raise AssertionError("a disabled autopilot touched the "
                                 "dispatcher")

        monkeypatch.setattr(disp, "plan_migration", boom)
        monkeypatch.setattr(disp, "apply_move", boom)
        out.append((ap.cycle(now=0.0), ap.plan(now=0.0), ap.apply(),
                    ap.snapshot()))
    assert out[0] == out[1]
    assert out[0][0] == {"enabled": False, "moves": [], "applied": [],
                         "rolled_back": [], "failed": []}
    assert out[0][3]["enabled"] is False
    assert out[0][3]["fragmentation"] == pytest.approx(1.0)


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
    """The doctor's autopilot line, the service's port masked."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        side.doctor.check_autopilot(f"127.0.0.1:{port}", 5.0)
    return buf.getvalue().replace(str(port), "PORT")


def _service_drive(side) -> list:
    svc = side.service.SchedulerService(side.engine.SchedulerEngine(),
                                        side.registry.TelemetryRegistry())
    svc.serve()
    try:
        out = [_http("GET", svc.port, "/autopilot"),
               _http("POST", svc.port, "/autopilot/plan", {}),
               _http("POST", svc.port, "/autopilot/apply", {}),
               _doctor_line(side, svc.port)]
        planner = side.ap.Planner(svc.dispatcher, clock=lambda: 0.0)
        svc.attach_autopilot(side.ap.Autopilot(
            svc.dispatcher, planner=planner,
            rebalancer=side.ap.Rebalancer(svc.dispatcher,
                                          planner=planner)))
        state = _http("GET", svc.port, "/autopilot")
        plan = _http("POST", svc.port, "/autopilot/plan", {})
        applied = _http("POST", svc.port, "/autopilot/apply", {})
        for _code, body in (plan, applied):
            body.get("plan", body).pop("generated_at", None)
        out += [state, plan, applied, _doctor_line(side, svc.port),
                side.topcli.render_autopilot({"autopilot": state[1],
                                              "chips": 0})]
    finally:
        svc.close()
    return out


def test_the_service_serves_an_attached_autopilot_as_jax():
    got, want = _service_drive(PORT), _service_drive(JAX)
    assert got == want
    assert got[0] == (200, {"attached": False, "enabled": False})
    assert got[1][0] == 409 and "autopilot" in got[1][1]["error"]
    assert got[3].split()[:2] == ["autopilot", "skip"]
    assert got[4][0] == 200 and got[4][1]["attached"]
    assert got[5][0] == 200 and got[5][1]["plan"]["moves"] == []
    assert got[6][0] == 200 and got[6][1]["applied"] == []
    assert got[7].split()[:2] == ["autopilot", "ok"]
    assert "fragmentation" in got[8]
