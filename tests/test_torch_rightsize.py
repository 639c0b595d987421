"""The port's rightsizer against the JAX package's: the signal joins, the
grow / shrink / pack rails, the whole-plan apply with its rollback and
journal, ``resize_request``, the sharded plane, the decision stream, the
service's ``/rightsize`` and ``simulate_rightsize``.

Mirrors ``tests/test_rightsize.py``, case for case. Each case runs the
same calls on both packages over the same fake SLO, ledger and blame
planes and one fake clock; plans, apply results, journals (without
their times) and engine bookings are compared exactly, and the JAX
test's own assertions are then held on the port's result.
``simulate_rightsize`` is compared as its JSON at seeds 0 and 7 on one
shard and two.
"""

import json
import math
import types
import urllib.error
import urllib.request

import pytest

from kubeshare_tpu import constants as JC
from kubeshare_tpu import rightsize as jrightsize
from kubeshare_tpu import topcli as jtopcli
from kubeshare_tpu.autopilot import Planner as JPlanner
from kubeshare_tpu.autopilot import rebalancer as jrebalancer
from kubeshare_tpu.isolation.tokensched import TokenScheduler as JTokens
from kubeshare_tpu.obs import flight as jflight
from kubeshare_tpu.obs.decisions import DecisionRecorder as JRecorder
from kubeshare_tpu.obs.ledger import ChipTimeLedger as JLedger
from kubeshare_tpu.scheduler import SchedulerEngine as JEngine
from kubeshare_tpu.scheduler import Unschedulable as JUnschedulable
from kubeshare_tpu.scheduler import dispatcher as jdispatcher
from kubeshare_tpu.scheduler.service import SchedulerService as JService
from kubeshare_tpu.scheduler.shard import make_dispatcher as jmake
from kubeshare_tpu.telemetry import TelemetryRegistry as JRegistry
from kubeshare_tpu.topology.discovery import FakeTopology as JFake
from kubeshare_tpu_torch import constants as C
from kubeshare_tpu_torch import rightsize, topcli
from kubeshare_tpu_torch.autopilot import Planner
from kubeshare_tpu_torch.autopilot import rebalancer
from kubeshare_tpu_torch.isolation.tokensched import TokenScheduler
from kubeshare_tpu_torch.obs import flight
from kubeshare_tpu_torch.obs.decisions import DecisionRecorder
from kubeshare_tpu_torch.obs.ledger import ChipTimeLedger
from kubeshare_tpu_torch.scheduler import SchedulerEngine, Unschedulable
from kubeshare_tpu_torch.scheduler import dispatcher
from kubeshare_tpu_torch.scheduler.service import SchedulerService
from kubeshare_tpu_torch.scheduler.shard import make_dispatcher
from kubeshare_tpu_torch.telemetry import TelemetryRegistry
from kubeshare_tpu_torch.topology.discovery import FakeTopology

PORT = types.SimpleNamespace(
    C=C, rz=rightsize, topcli=topcli, Planner=Planner,
    Tokens=TokenScheduler, Recorder=DecisionRecorder,
    Ledger=ChipTimeLedger, Engine=SchedulerEngine,
    Unschedulable=Unschedulable, dispatcher=dispatcher,
    make_dispatcher=make_dispatcher, Service=SchedulerService,
    Registry=TelemetryRegistry, Fake=FakeTopology, flight=flight,
    rebalancer=rebalancer)
JAX = types.SimpleNamespace(
    C=JC, rz=jrightsize, topcli=jtopcli, Planner=JPlanner,
    Tokens=JTokens, Recorder=JRecorder, Ledger=JLedger, Engine=JEngine,
    Unschedulable=JUnschedulable, dispatcher=jdispatcher,
    make_dispatcher=jmake, Service=JService, Registry=JRegistry,
    Fake=JFake, flight=jflight, rebalancer=jrebalancer)


@pytest.fixture(autouse=True)
def private_recorders(monkeypatch):
    """Each dispatcher and rebalancer dumps into a recorder of its own,
    and a test fails if the JAX default recorder dumped all the same."""
    for side in (PORT, JAX):
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
    assert fired == []


def both(case):
    """``case(side)`` on the port and on JAX; the results must agree."""
    got, want = case(PORT), case(JAX)
    assert got == want
    return got


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


class FakeSlo:
    """state() in the exact shape SloEvaluator.state returns."""

    def __init__(self):
        self.tenants: dict = {}

    def burn(self, tenant, fast=0.0, slow=0.0, firing=False,
             budget=1.0):
        self.tenants[tenant] = [{"objective": "grant-wait-p99<=500ms",
                                 "burn_fast": fast, "burn_slow": slow,
                                 "firing": firing,
                                 "budget_remaining": budget}]

    def state(self, now=None):
        return {"tenants": dict(self.tenants)}


class FakeLedger:
    """account() rows in the exact shape ChipTimeLedger.account
    returns — one synthetic chip per tenant."""

    def __init__(self):
        self.rows: dict = {}

    def idle(self, tenant, granted_s=600.0, active_frac=0.1,
             client=None):
        client = client or f"{tenant}/w0"
        self.rows[f"lgr::{tenant}"] = [
            {"tenant": client, "state": "granted-active",
             "overlap_s": granted_s * active_frac},
            {"tenant": client, "state": "granted-idle",
             "overlap_s": granted_s * (1.0 - active_frac)},
        ]

    def two_pods(self, tenant="cold"):
        self.rows[f"lgr::{tenant}"] = [
            {"tenant": f"{tenant}/w{i}", "state": state,
             "overlap_s": secs}
            for i in (0, 1)
            for state, secs in (("granted-active", 60.0),
                                ("granted-idle", 540.0))]

    def snapshot(self, now=None):
        return {"chips": {c: {} for c in self.rows}}

    def account(self, chip, start, end, now=None):
        return list(self.rows.get(chip, ()))


class FakeBlame:
    def __init__(self, edges=()):
        self._edges = list(edges)

    def edges(self):
        return list(self._edges)


def make_disp(side, hosts=1, mesh=(2, 2), clock=None, shards=1):
    by_host: dict = {}
    for chip in side.Fake(hosts=hosts, mesh=mesh).chips():
        by_host.setdefault(chip.host, []).append(chip)
    kw = {"clock": clock} if clock else {}
    if shards > 1:
        return side.make_dispatcher(by_host, shards=shards, **kw)
    eng = side.Engine(**kw)
    for host, chips in sorted(by_host.items()):
        eng.add_node(host, chips)
    return side.dispatcher.Dispatcher(eng, **kw)


def shared(side, request="0.5", limit="1.0", **extra):
    labels = {side.C.POD_TPU_REQUEST: request, side.C.POD_TPU_LIMIT: limit}
    labels.update(extra)
    return labels


def make_rz(side, disp, clock, slo=None, ledger=None, blame=None,
            **cfg_kw):
    cfg = side.rz.RightsizeConfig(**cfg_kw)
    planner = side.Planner(disp, cooldown_s=cfg.cooldown_s, clock=clock)
    return side.rz.Rightsizer(disp, slo=slo, ledger=ledger, blame=blame,
                              planner=planner, cfg=cfg, clock=clock)


def bookings(disp) -> dict:
    with disp.lock:
        return {k: list(p.bookings)
                for k, p in sorted(disp.engine.pod_status.items())}


def one_pod(side, request="0.6", mesh=(1, 1), ns="cold"):
    clk = FakeClock()
    disp = make_disp(side, hosts=1, mesh=mesh, clock=clk)
    key = disp.submit(ns, "w0", shared(side, request))
    disp.step()
    return clk, disp, key


# --------------------------------------------------------------------------
# signals: pure joins
# --------------------------------------------------------------------------

def test_default_tenant_is_the_namespace():
    for client in ("team-a/worker-0", "bare", "a/b/c", ""):
        assert rightsize.default_tenant(client) == \
            jrightsize.default_tenant(client)
    assert rightsize.default_tenant("team-a/worker-0") == "team-a"
    assert rightsize.default_tenant("bare") == "bare"


def test_burn_state_worst_objective_wins():
    state = {"tenants": {"t": [
        {"objective": "a", "burn_fast": 0.5, "burn_slow": 2.0,
         "firing": False, "budget_remaining": 0.9},
        {"objective": "b", "burn_fast": 3.0, "burn_slow": 0.1,
         "firing": True, "budget_remaining": 0.2},
    ], "u": []}}
    b = both(lambda side: side.rz.burn_state(state))
    assert b["t"]["burn_fast"] == 3.0 and b["t"]["burn_slow"] == 2.0
    assert b["t"]["firing"] is True
    assert b["t"]["budget_remaining"] == 0.2
    assert b["t"]["objectives"] == ["a", "b"]
    assert b["u"]["budget_remaining"] == 1.0


def test_tenant_demand_joins_real_ledger_windows():
    def case(side):
        clk = [0.0]
        ledger = side.Ledger(clock=lambda: clk[0])
        # tenant "ns": granted [0, 100], active [0, 30] -> idle 0.7
        ledger.grant("chip0", "ns/w0", tpu_class="latency", now=0.0)
        ledger.execute_begin("chip0", now=0.0)
        ledger.execute_end("chip0", now=30.0)
        ledger.release("chip0", now=100.0)
        ledger.grant("chip1", "other/w0", tpu_class="latency", now=40.0)
        ledger.release("chip1", now=90.0)
        clk[0] = 100.0
        return side.rz.tenant_demand(ledger, 0.0, 100.0, now=100.0)
    d = both(case)
    assert d["ns"]["granted_s"] == pytest.approx(100.0)
    assert d["ns"]["active_s"] == pytest.approx(30.0)
    assert d["ns"]["idle_frac"] == pytest.approx(0.7)
    assert d["ns"]["chips"] == ["chip0"]
    assert d["other"]["idle_frac"] == pytest.approx(1.0)


def test_blamed_neighbours_ranked_filtered():
    blame = FakeBlame([
        {"victim": "hot/w0", "blamed": "cold/w0", "wait_s": 5.0},
        {"victim": "hot/w0", "blamed": "warm/w0", "wait_s": 9.0},
        {"victim": "hot/w0", "blamed": "hot/w1", "wait_s": 99.0},
        {"victim": "hot/w0", "blamed": "mig/w0", "wait_s": 50.0,
         "kind": "migration"},
        {"victim": "other/w0", "blamed": "cold/w0", "wait_s": 99.0},
    ])
    # own clients and migration pseudo-holders are filtered; ranked by
    # chip-seconds cost to THIS victim only
    ranked = both(lambda side: (side.rz.blamed_neighbours(blame, "hot"),
                                side.rz.blamed_neighbours(blame, "hot",
                                                          n=1)))
    assert ranked == (["warm", "cold"], ["warm"])


# --------------------------------------------------------------------------
# plan: grow / shrink targets and the rails
# --------------------------------------------------------------------------

def test_plan_grows_burning_tenant_one_step_into_headroom():
    def case(side):
        clk, disp, _ = one_pod(side, "0.3", ns="hot")
        slo = FakeSlo()
        slo.burn("hot", fast=20.0, slow=20.0, firing=True, budget=0.1)
        return make_rz(side, disp, clk, slo=slo).plan()
    plan = both(case)
    (r,) = plan["resizes"]
    assert r["direction"] == "grow" and r["reason"] == "slo-firing"
    assert r["from"] == pytest.approx(0.3)
    assert r["to"] == pytest.approx(0.3 + rightsize.RightsizeConfig()
                                    .grow_step)
    assert plan["tenants"]["hot"]["firing"] is True
    assert plan["chip_equivalents"]["proposed"] == pytest.approx(0.4)


def test_grow_gates_on_fast_window_and_slow_inhibits_shrink():
    def case(side):
        clk, disp, _ = one_pod(side, "0.6", ns="t")
        slo = FakeSlo()
        # the slow window remembers an ended starvation spell: fast has
        # decayed, slow is still hot -> neither grow NOR shrink
        slo.burn("t", fast=0.2, slow=8.0, firing=False)
        ledger = FakeLedger()
        ledger.idle("t", granted_s=600.0, active_frac=0.05)
        return make_rz(side, disp, clk, slo=slo, ledger=ledger).plan()
    plan = both(case)
    assert plan["resizes"] == []
    assert plan["tenants"]["t"]["burn_slow"] == 8.0


def test_plan_shrinks_sustained_idle_to_grant_utilization():
    def case(side):
        clk, disp, _ = one_pod(side, "0.6")
        ledger = FakeLedger()
        ledger.idle("cold", granted_s=600.0, active_frac=0.1)
        return make_rz(side, disp, clk, ledger=ledger).plan()
    plan = both(case)
    (r,) = plan["resizes"]
    assert r["direction"] == "shrink" and r["reason"] == "sustained-idle"
    # share x (active/granted) x (1 + headroom), snapped UP to the
    # quantum: 0.6 * 0.1 * 1.25 = 0.075 -> 0.10
    assert r["to"] == pytest.approx(0.1)
    assert plan["chip_equivalents"]["proposed"] == pytest.approx(0.1)


def test_shrink_needs_coverage_and_idle_threshold():
    def case(side):
        clk, disp, _ = one_pod(side, "0.6")
        ledger = FakeLedger()
        # 30 s of a 600 s window (coverage 0.05 < min_coverage 0.1):
        # absent tenants are not judged
        ledger.idle("cold", granted_s=30.0, active_frac=0.1)
        rz = make_rz(side, disp, clk, ledger=ledger)
        absent = rz.plan()["resizes"]
        # full coverage but busy (idle 0.2 < idle_frac 0.5): left alone
        ledger.idle("cold", granted_s=600.0, active_frac=0.8)
        return absent, rz.plan()["resizes"]
    assert both(case) == ([], [])


def test_hysteresis_drops_subthreshold_deltas():
    def case(side):
        clk, disp, _ = one_pod(side, "0.12")
        ledger = FakeLedger()
        # target: 0.12 * 0.5 * 1.25 = 0.075 -> quantized 0.10; |delta|
        # 0.02 is under min_delta 0.04
        ledger.idle("cold", granted_s=600.0, active_frac=0.5)
        return make_rz(side, disp, clk, ledger=ledger).plan()
    plan = both(case)
    assert plan["resizes"] == []
    assert {"tenant": "cold", "reason": "hysteresis"} in plan["skipped"]


def test_shrink_spacing_one_shrink_per_window():
    def case(side):
        clk, disp, _ = one_pod(side, "0.6")
        ledger = FakeLedger()
        ledger.idle("cold", granted_s=600.0, active_frac=0.1)
        rz = make_rz(side, disp, clk, ledger=ledger)
        first = [r["to"] for r in rz.cycle()["applied"]]
        # the idle ratio was measured over the OLD share: a second
        # shrink inside the window would compound it geometrically
        clk.t += rz.cfg.window_s / 2
        held = rz.plan()["resizes"]
        # a full window later (fresh signal) the tenant may shrink again
        clk.t += rz.cfg.window_s
        ledger.idle("cold", granted_s=600.0, active_frac=0.2)
        return first, held, rz.plan()["resizes"]
    first, held, again = both(case)
    assert first == [pytest.approx(0.1)]
    assert held == []
    (r,) = again
    assert r["direction"] == "shrink"


def test_cooldown_rail_is_shared_with_the_autopilot_planner():
    """One Planner owns the cooldown for BOTH planes: a pod the
    autopilot just moved is not immediately resized, and a pod the
    rightsizer just resized is cooling for the planner too."""
    def case(side):
        clk, disp, _ = one_pod(side, "0.6")
        ledger = FakeLedger()
        ledger.idle("cold", granted_s=600.0, active_frac=0.1)
        rz = make_rz(side, disp, clk, ledger=ledger, cooldown_s=120.0)
        planner = rz.planner
        planner.note_moved("cold/w0", clk.t)
        plan = rz.plan()
        clk.t += 121.0
        out = rz.cycle()
        return (plan["resizes"], plan["skipped"], len(out["applied"]),
                planner.cooling("cold/w0", clk.t),
                planner.cooling("cold/w0", clk.t + 121.0))
    resizes, skipped, applied, cooling, later = both(case)
    assert resizes == []
    assert {"tenant": "cold", "reason": "cooldown"} in skipped
    assert applied == 1 and cooling is True and later is False


def test_blame_picks_the_neighbour_to_squeeze_for_a_grow():
    def case(side):
        clk, disp, _ = one_pod(side, "0.3", ns="hot")
        disp.submit("cold", "w0", shared(side, "0.7"))
        disp.step()
        slo = FakeSlo()
        slo.burn("hot", fast=20.0, slow=20.0, firing=True)
        ledger = FakeLedger()
        # busy enough to dodge the sustained-idle shrink (idle 0.45 <
        # 0.5) yet measured low enough that blame can squeeze it:
        # 0.7 * 0.55 * 1.25 = 0.48 -> quantized 0.50
        ledger.idle("cold", granted_s=600.0, active_frac=0.55)
        blame = FakeBlame([{"victim": "hot/w0", "blamed": "cold/w0",
                            "wait_s": 12.0}])
        rz = make_rz(side, disp, clk, slo=slo, ledger=ledger,
                     blame=blame)
        plan = rz.plan()
        return plan, rz.apply(plan), bookings(disp)
    plan, out, booked = both(case)
    by_dir = {r["direction"]: r for r in plan["resizes"]}
    assert by_dir["shrink"]["reason"] == "blame-shrink"
    assert by_dir["shrink"]["pod"] == "cold/w0"
    assert by_dir["shrink"]["to"] == pytest.approx(0.5)
    assert by_dir["grow"]["pod"] == "hot/w0"
    assert by_dir["grow"]["to"] == pytest.approx(0.4)
    # shrinks execute first in apply order
    assert plan["resizes"][0]["direction"] == "shrink"
    assert len(out["applied"]) == 2 and out["failed"] == []
    assert booked["hot/w0"][0][1] == pytest.approx(0.4)


def test_grow_without_headroom_or_blame_is_skipped():
    def case(side):
        clk, disp, _ = one_pod(side, "0.3", ns="hot")
        disp.submit("other", "w0", shared(side, "0.7"))
        disp.step()
        slo = FakeSlo()
        slo.burn("hot", fast=20.0, slow=20.0, firing=True)
        return make_rz(side, disp, clk, slo=slo).plan()
    plan = both(case)
    assert plan["resizes"] == []
    assert any(s["reason"] == "no-headroom" for s in plan["skipped"])
    assert plan["tenants"]["hot"]["reason"] == "no-headroom"


# --------------------------------------------------------------------------
# pack: consolidation toward receivers, anti-oscillation
# --------------------------------------------------------------------------

def _slivers(side, clk, keep_one: bool):
    disp = make_disp(side, hosts=2, mesh=(2, 2), clock=clk)
    a = [disp.submit("ns", f"a{i}", shared(side, "0.6")) for i in range(8)]
    disp.step()
    b = [disp.submit("ns", f"b{i}", shared(side, "0.4")) for i in range(8)]
    disp.step()
    assert all(disp.outcome(k).status == "bound" for k in a + b)
    for k in (a[1:] if keep_one else a):
        disp.delete(k)
    return disp, a


def test_pack_moves_slivers_toward_loaded_nodes_once():
    def case(side):
        clk = FakeClock()
        disp, a = _slivers(side, clk, keep_one=True)
        receiver = disp.engine.pod_status[a[0]].node_name
        rz = make_rz(side, disp, clk, pack_util=0.45, move_budget=8)
        plan = rz.plan()
        # a pod planned into a pack stays put for pack_cooldown_s even
        # if the plan was never applied
        again = rz.plan()["moves"]
        clk.t += rz.cfg.pack_cooldown_s + 1.0
        later = rz.plan()
        out = rz.apply(later)
        return receiver, plan, again, later["moves"], out, bookings(disp)
    receiver, plan, again, later, out, booked = both(case)
    assert plan["resizes"] == []
    assert plan["moves"], "slivers should consolidate"
    assert all(m["node"] == receiver for m in plan["moves"])
    assert all(m["reason"] == "pack" for m in plan["moves"])
    assert again == [] and later
    assert out["moves"]["applied"]


def test_pack_inert_when_every_chip_is_a_sliver():
    def case(side):
        clk = FakeClock()
        disp, _ = _slivers(side, clk, keep_one=False)
        rz = make_rz(side, disp, clk, pack_util=0.45, move_budget=8)
        return rz.plan()["moves"]
    assert both(case) == []


# --------------------------------------------------------------------------
# apply: actuation, whole-plan rollback, journal
# --------------------------------------------------------------------------

@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_apply_rebooks_engine_and_pushes_effective_share(native):
    """The share reaches the chip's token scheduler as its effective
    share, on both of the port's cores; the base share stays."""
    def case(side):
        clk, disp, key = one_pod(side, "0.6")
        chip = disp.engine.pod_status[key].bookings[0][0]
        ms = FakeClock(0.0)
        kw = {"native": native} if side is PORT else {}
        sched = side.Tokens(window_ms=10_000.0, clock=ms, chip=chip, **kw)
        sched.add_client(key, 0.6, 1.0)
        ledger = FakeLedger()
        ledger.idle("cold", granted_s=600.0, active_frac=0.1)
        rz = make_rz(side, disp, clk, ledger=ledger)
        rz.schedulers = {chip: sched}
        out = rz.cycle()
        try:
            return ([r["to"] for r in out["applied"]], bookings(disp),
                    sched.effective(key), sched.shares()[key])
        finally:
            sched.close()
    applied, booked, (eff_req, _lim), base = both(case)
    assert applied == [pytest.approx(0.1)]
    assert booked["cold/w0"][0][1] == pytest.approx(0.1)
    assert eff_req == pytest.approx(0.1)
    assert base == (0.6, 1.0)


def _journal(path) -> list:
    return [{k: v for k, v in json.loads(line).items() if k != "t"}
            for line in path.read_text().splitlines()]


def test_apply_rolls_the_whole_batch_back_on_member_failure(tmp_path):
    def case(side):
        clk, disp, _ = one_pod(side, "0.6", mesh=(2, 2))
        disp.submit("cold", "w1", shared(side, "0.6"))
        disp.step()
        ledger = FakeLedger()
        ledger.two_pods()
        journal = tmp_path / f"{id(side)}.jsonl"
        rz = make_rz(side, disp, clk, ledger=ledger)
        rz.journal_path = str(journal)
        inner = disp.resize_request

        def failing(key, new_request):
            if key == "cold/w1" and new_request < 0.6:
                raise side.Unschedulable("chaos: resize shot mid-batch")
            return inner(key, new_request)

        disp.resize_request = failing
        plan = rz.plan()
        out = rz.apply(plan)
        return (len(plan["resizes"]), out, rz.rolled_back_total,
                rz.applied_total, bookings(disp), _journal(journal),
                dict(rz._last_shrunk))
    n, out, back, applied, booked, journal, shrunk = both(case)
    assert n == 2
    # whole-plan atomic: w1 failed, so the already-applied w0 resize
    # was reverted
    assert [f["pod"] for f in out["failed"]] == ["cold/w1"]
    assert [r["pod"] for r in out["rolled_back"]] == ["cold/w0"]
    assert out["applied"] == [] and back == 1 and applied == 0
    for k in ("cold/w0", "cold/w1"):
        assert booked[k][0][1] == pytest.approx(0.6)
    assert [r["event"] for r in journal] == [
        "batch_begin", "resize_done", "resize_rolled_back", "batch_end"]
    # a rolled-back shrink must NOT stamp the shrink-spacing rail
    assert "cold" not in shrunk


def test_journal_records_the_applied_batch(tmp_path):
    def case(side):
        clk, disp, _ = one_pod(side, "0.6")
        ledger = FakeLedger()
        ledger.idle("cold", granted_s=600.0, active_frac=0.1)
        journal = tmp_path / f"{id(side)}.jsonl"
        rz = make_rz(side, disp, clk, ledger=ledger)
        rz.journal_path = str(journal)
        rz.cycle()
        return _journal(journal), rz.snapshot()
    recs, snap = both(case)
    assert [r["event"] for r in recs] == \
        ["batch_begin", "resize_done", "batch_end"]
    assert recs[0]["resizes"] == [{"pod": "cold/w0", "from": 0.6,
                                   "to": 0.1}]
    assert recs[2]["applied"] == 1
    assert snap["cycles"] == 1 and snap["applied_total"] == 1


# --------------------------------------------------------------------------
# resize_request: re-booking semantics
# --------------------------------------------------------------------------

def test_resize_request_rebooks_and_rescales_defaulted_hbm():
    def case(side):
        disp = make_disp(side, hosts=1, mesh=(1, 1))
        key = disp.submit("ns", "w0", shared(side, "0.6"))
        disp.step()
        eng = disp.engine
        chip, _req, mem = eng.pod_status[key].bookings[0]
        cell = eng.leaf_cells[chip]
        before = (mem, cell.full_memory)
        out = disp.resize_request(key, 0.2)
        return (before, out, list(eng.pod_status[key].bookings[0]),
                cell.available, cell.free_memory)
    (mem, full), out, (chip2, req2, mem2), avail, free = both(case)
    assert mem == int(math.floor(0.6 * full))
    assert out == {"pod": "ns/w0", "chip": chip2, "from": 0.6, "to": 0.2}
    assert req2 == pytest.approx(0.2)
    assert mem2 == int(math.floor(0.2 * full))
    assert avail == pytest.approx(0.8) and free == full - mem2


def test_resize_request_keeps_an_explicit_hbm_cap():
    def case(side):
        disp = make_disp(side, hosts=1, mesh=(1, 1))
        chip0 = next(iter(disp.engine.leaf_cells))
        explicit = disp.engine.leaf_cells[chip0].full_memory // 4
        key = disp.submit("ns", "w0", shared(
            side, "0.6", **{side.C.POD_TPU_MEMORY: str(explicit)}))
        disp.step()
        first = disp.engine.pod_status[key].bookings[0][2]
        disp.resize_request(key, 0.2)
        return explicit, first, disp.engine.pod_status[key].bookings[0][2]
    explicit, first, after = both(case)
    assert first == explicit and after == explicit


def test_resize_request_refuses_unfittable_grow_and_bad_targets():
    def case(side):
        disp = make_disp(side, hosts=1, mesh=(1, 1))
        key = disp.submit("ns", "w0", shared(side, "0.3"))
        disp.step()
        disp.submit("ns", "w1", shared(side, "0.5"))
        disp.step()
        errors = []
        for k, to in ((key, 0.9), (key, 0.0), (key, 1.5),
                      ("ns/ghost", 0.5)):
            with pytest.raises(side.Unschedulable) as e:
                disp.resize_request(k, to)
            errors.append(str(e.value))
        chip = disp.engine.pod_status[key].bookings[0][0]
        return (errors, disp.engine.pod_status[key].bookings[0][1],
                disp.engine.leaf_cells[chip].available)
    _errors, req, avail = both(case)
    assert req == pytest.approx(0.3)
    assert avail == pytest.approx(0.2)


def test_resize_request_refuses_whole_chip_pods():
    def case(side):
        disp = make_disp(side, hosts=1, mesh=(2, 2))
        key = disp.submit("ns", "w0", {side.C.POD_TPU_REQUEST: "2",
                                       side.C.POD_TPU_LIMIT: "2"})
        disp.step()
        with pytest.raises(side.Unschedulable,
                           match="fractional single-chip") as e:
            disp.resize_request(key, 0.5)
        return str(e.value)
    both(case)


# --------------------------------------------------------------------------
# sharded plane, decision recorder, service, sim
# --------------------------------------------------------------------------

def test_rightsizer_works_behind_the_sharded_plane():
    def case(side):
        clk = FakeClock()
        disp = make_disp(side, hosts=2, mesh=(2, 2), clock=clk, shards=2)
        disp.submit("cold", "w0", shared(side, "0.6"))
        disp.submit("cold", "w1", shared(side, "0.6"))
        disp.step()
        ledger = FakeLedger()
        ledger.two_pods()
        out = make_rz(side, disp, clk, ledger=ledger).cycle()
        return out, bookings(disp)
    out, booked = both(case)
    # resize_request delegates to each pod's owning shard; the fleet
    # facade's pod_status sees the re-booked shares
    assert len(out["applied"]) == 2
    for k in ("cold/w0", "cold/w1"):
        assert booked[k][0][1] < 0.6


def test_decision_stream_bit_identical_when_disabled():
    def case(side):
        clk = FakeClock()
        disp = make_disp(side, hosts=1, mesh=(1, 1), clock=clk)
        decisions = side.Recorder(clock=clk, seed=7)
        disp.attach_decisions(decisions)
        disp.submit("cold", "w0", shared(side, "0.6"))
        disp.step()
        baseline = dict(decisions.counts())
        ledger = FakeLedger()
        ledger.idle("cold", granted_s=600.0, active_frac=0.1)
        planner = side.Planner(disp, clock=clk)
        off = side.rz.Rightsizer(disp, ledger=ledger, planner=planner,
                                 enabled=False, clock=clk)
        out = off.cycle()
        inert = (out, off.plan(), off.apply(), dict(decisions.counts()))
        on = side.rz.Rightsizer(disp, ledger=ledger, planner=planner,
                                enabled=True, clock=clk)
        on.cycle()
        return baseline, inert, dict(decisions.counts())
    baseline, (out, plan, applied, counts_off), counts = both(case)
    assert out["enabled"] is False and out["applied"] == []
    assert plan["enabled"] is False and applied["applied"] == []
    # disabled => inert: not one decision record
    assert counts_off == baseline
    assert counts.get("rightsize-plan") == 1
    assert counts.get("rightsize-apply") == 1
    assert counts.get("resize") == 1


def _http(method, port, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=5) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def test_service_exposes_rightsize_plane():
    def case(side):
        svc = side.Service(side.Engine(), side.Registry())
        svc.serve()
        try:
            got = [_http("GET", svc.port, "/rightsize"),
                   _http("POST", svc.port, "/rightsize/plan", {}),
                   _http("POST", svc.port, "/rightsize/apply", {})]
            svc.attach_rightsize(side.rz.Rightsizer(svc.dispatcher))
            got.append(_http("GET", svc.port, "/rightsize"))
            # plans carry the service's monotonic clock's reading
            code, out = _http("POST", svc.port, "/rightsize/plan", {})
            out["plan"].pop("generated_at")
            got.append((code, out))
            code, out = _http("POST", svc.port, "/rightsize/apply", {})
            out.pop("generated_at")
            got.append((code, out))
            got.append(_http("GET", svc.port, "/rightsize")[1]["cycles"])
            return got
        finally:
            svc.close()
    got = both(case)
    assert got[0] == (200, {"attached": False, "enabled": False})
    assert got[1][0] == 409 and "rightsizer" in got[1][1]["error"]
    assert got[2][0] == 409
    status, state = got[3]
    assert status == 200 and state["attached"] and state["enabled"]
    assert state["cycles"] == 0
    assert got[4][0] == 200 and got[4][1]["plan"]["resizes"] == []
    assert got[5][0] == 200 and got[5][1]["applied"] == []
    assert got[6] == 1


def test_topcli_renders_the_rightsize_join():
    detached = {"rightsize": {"attached": False}, "chips": 8,
                "booked_total": 2.4}
    snap = {"rightsize": {
        "attached": True, "enabled": True, "cycles": 3,
        "applied_total": 5, "rolled_back_total": 0,
        "chip_equivalents": {"declared": 3.9, "current": 2.2,
                             "proposed": 2.0},
        "tenants": {"cold-0": {
            "share": 0.6, "proposed": 0.1, "declared": 0.6,
            "burn_fast": 0.0, "burn_slow": 0.2,
            "budget_remaining": 0.9, "firing": False,
            "idle_frac": 0.88, "reason": "sustained-idle"}},
        "pending_resizes": [{"pod": "cold-0/w0", "from": 0.6,
                             "to": 0.1, "direction": "shrink",
                             "reason": "sustained-idle", "gang": ""}],
        "pending_moves": [{"pod": "cold-0/w0", "from": "chip-0",
                           "node": "host-1"}],
    }, "chips": 8, "booked_total": 2.2}
    off, on = both(lambda side: (side.topcli.render_rightsize(detached),
                                 side.topcli.render_rightsize(snap)))
    assert "not attached" in off and "--rightsize" in off
    assert "8 chips" in off
    assert "declared 3.9" in on and "booked 2.2" in on
    assert "sustained-idle" in on
    assert "plan: cold-0/w0" in on and "pack: cold-0/w0" in on


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("shards", [1, 2])
def test_simulate_rightsize_equals_jax(seed, shards):
    """The seeded churn sim (30 virtual minutes) gives JAX's JSON byte
    for byte, rightsized and static."""
    kw = dict(seed=seed, hosts=2, shards=shards, horizon_s=1800.0)
    for on in (True, False):
        got = rightsize.simulate_rightsize(rightsize=on, **kw)
        want = jrightsize.simulate_rightsize(rightsize=on, **kw)
        assert json.dumps(got, sort_keys=True) == \
            json.dumps(want, sort_keys=True)
        assert got["ledger_conservation_ok"] is True
        if not on:
            assert got["resizes_applied"] == 0
            assert not any(k.startswith("rightsize") or k == "resize"
                           for k in got["decision_kinds"])


def test_sim_deterministic_and_replay_clean():
    kw = dict(seed=11, hosts=2, horizon_s=900.0)
    a = rightsize.simulate_rightsize(rightsize=True, **kw)
    b = rightsize.simulate_rightsize(rightsize=True, **kw)
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    assert a["resizes_applied"] > 0
    assert a["ledger_conservation_ok"] is True
    static = rightsize.simulate_rightsize(rightsize=False, **kw)
    assert static["resizes_applied"] == 0
    assert not any(k.startswith("rightsize") or k == "resize"
                   for k in static["decision_kinds"])


@pytest.mark.slow
def test_sim_acceptance_bars_on_the_ci_scenario():
    """The JAX test's acceptance bars on the port: every declared SLO
    met, >= 30% fewer steady chip-equivalents than static shares, zero
    new alerts, on the hour-long seed-7 scenario, equal to JAX's."""
    kw = dict(seed=7, hosts=2, horizon_s=3600.0)
    sized = rightsize.simulate_rightsize(rightsize=True, **kw)
    static = rightsize.simulate_rightsize(rightsize=False, **kw)
    assert sized == jrightsize.simulate_rightsize(rightsize=True, **kw)
    assert sized["slo_met"] is True and sized["firing_at_end"] == []
    declared = static["chip_equivalents"]["steady"]
    assert sized["chip_equivalents"]["steady"] <= 0.7 * declared
    sized_alerts = {tuple(x) for x in sized["alerts_firing"]}
    static_alerts = {tuple(x) for x in static["alerts_firing"]}
    assert sized_alerts <= static_alerts
    assert sized["rightsizer"]["rolled_back_total"] == 0
