"""The port's dispatcher and health watch against the JAX package's: the
same submits, deletes, steps, lease silences and evictions on one fake
clock give the same statuses, queue order, Permit releases and
timeouts, ``Overloaded`` reasons, eviction lists, requeues, gang GC,
registry records, invariant snapshots and decision streams.

Mirrors ``tests/test_dispatcher.py`` and ``tests/test_healthwatch.py``.
Trace ids are random and stay out of every comparison. Each side's
dispatcher dumps a private flight recorder on a node eviction, never the
JAX default one (its retained dumps are what ``tests/test_ha.py``
counts).
"""

import random
import types

import pytest

from kubeshare_tpu import constants as JC
from kubeshare_tpu.gang import coordinator as jcoord
from kubeshare_tpu.obs import decisions as jdecisions
from kubeshare_tpu.obs import flight as jflight
from kubeshare_tpu.scheduler import dispatcher as jdispatcher
from kubeshare_tpu.scheduler import engine as jengine
from kubeshare_tpu.scheduler import healthwatch as jhealthwatch
from kubeshare_tpu.telemetry import heartbeat as jheartbeat
from kubeshare_tpu.telemetry import registry as jregistry
from kubeshare_tpu.topology import discovery as jdiscovery
from kubeshare_tpu_torch import constants as C
from kubeshare_tpu_torch.gang import coordinator
from kubeshare_tpu_torch.obs import decisions
from kubeshare_tpu_torch.obs import flight
from kubeshare_tpu_torch.scheduler import dispatcher
from kubeshare_tpu_torch.scheduler import engine
from kubeshare_tpu_torch.scheduler import healthwatch
from kubeshare_tpu_torch.telemetry import heartbeat
from kubeshare_tpu_torch.telemetry import registry
from kubeshare_tpu_torch.topology import discovery

TTL = 5.0
MISS = 3
RECOVER_K = 2
QUARANTINE = 10.0

PORT = types.SimpleNamespace(
    engine=engine, dispatcher=dispatcher, healthwatch=healthwatch,
    heartbeat=heartbeat, registry=registry, discovery=discovery,
    decisions=decisions, coordinator=coordinator, flight=flight)
JAX = types.SimpleNamespace(
    engine=jengine, dispatcher=jdispatcher, healthwatch=jhealthwatch,
    heartbeat=jheartbeat, registry=jregistry, discovery=jdiscovery,
    decisions=jdecisions, coordinator=jcoord, flight=jflight)


@pytest.fixture(autouse=True)
def private_recorders(monkeypatch):
    """Each dispatcher dumps into a recorder of its own, and a test fails
    if the JAX default recorder dumped all the same."""
    for mods in (PORT, JAX):
        rec = mods.flight.FlightRecorder()
        monkeypatch.setattr(mods.dispatcher, "default_recorder",
                            lambda rec=rec: rec)
    rec = jflight.default_recorder()
    fired = []
    real = rec.trigger
    monkeypatch.setattr(rec, "trigger",
                        lambda reason, **kw: fired.append(reason)
                        or real(reason, **kw))
    yield
    assert fired == []


def test_the_shared_constants_agree():
    for name in ("SCHEDULER_NAME", "SCHEDULER_DIR", "LEASE_TTL_S",
                 "HEALTH_MISS_THRESHOLD", "HEALTH_RECOVER_K",
                 "HEALTH_QUARANTINE_S"):
        assert getattr(C, name) == getattr(JC, name), name
    assert dispatcher.GC_PERIOD_S == jdispatcher.GC_PERIOD_S
    assert dispatcher.RETRY_BACKOFF_S == jdispatcher.RETRY_BACKOFF_S
    assert dispatcher.MAX_RESULTS == jdispatcher.MAX_RESULTS


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def shared(request="0.5", limit="1.0", **extra):
    labels = {C.POD_TPU_REQUEST: request, C.POD_TPU_LIMIT: limit}
    labels.update(extra)
    return labels


def gang(name, headcount=2, threshold=1.0, priority="10", **kw):
    return shared(**{C.POD_GROUP_NAME: name,
                     C.POD_GROUP_HEADCOUNT: str(headcount),
                     C.POD_GROUP_THRESHOLD: str(threshold),
                     C.POD_PRIORITY: priority}, **kw)


class Side:
    """One package's engine, registry, dispatcher, health watch, decision
    recorder, gang coordinator and heartbeaters on the shared clock."""

    def __init__(self, mods, clock, hosts=2, mesh=(2, 2), health=True,
                 **disp_kw):
        self.mods = mods
        self.clock = clock
        self.engine = mods.engine.SchedulerEngine(clock=clock)
        by_host = {}
        for chip in mods.discovery.FakeTopology(hosts=hosts,
                                                mesh=mesh).chips():
            by_host.setdefault(chip.host, []).append(chip)
        for host, chips in by_host.items():
            self.engine.add_node(host, chips)
        self.registry = mods.registry.TelemetryRegistry(clock=clock)
        disp_kw.setdefault("retry_backoff_s", 1.0)
        self.disp = mods.dispatcher.Dispatcher(
            self.engine, self.registry, clock=clock, **disp_kw)
        self.decisions = mods.decisions.DecisionRecorder(clock=clock)
        self.disp.attach_decisions(self.decisions)
        self.coord = mods.coordinator.GangTokenCoordinator()
        self.disp.attach_gang_coordinator(self.coord)
        self.hw = None
        self.beaters = {}
        self.silent = set()
        if health:
            self.hw = mods.healthwatch.HealthWatch(
                self.registry, ttl_s=TTL, miss_threshold=MISS,
                recover_k=RECOVER_K, quarantine_s=QUARANTINE, clock=clock)
            self.disp.attach_healthwatch(self.hw)
            self.beaters = {
                node: mods.heartbeat.Heartbeater(self.registry, node,
                                                 ttl_s=TTL)
                for node in sorted(self.engine.chips_by_node)}
            self.beat()

    def beat(self):
        for node, hb in self.beaters.items():
            if node not in self.silent:
                hb.beat_once()

    def submit(self, ns, name, labels, uid=""):
        """The pod key, or the refusal as (type, reason, text)."""
        try:
            return self.disp.submit(ns, name, labels, uid=uid)
        except self.mods.dispatcher.Overloaded as e:
            return ("overloaded", e.reason, str(e))
        except ValueError as e:          # LabelError
            return ("label-error", str(e))


def strip_trace(obj):
    if isinstance(obj, dict):
        return {k: strip_trace(v) for k, v in obj.items()
                if k not in ("trace_id", "trace")}
    if isinstance(obj, list):
        return [strip_trace(v) for v in obj]
    return obj


def decision_stream(side):
    mods = side.mods.decisions
    return [strip_trace(mods.canonical_entry(e))
            for e in side.decisions.entries()]


def view(side, keys):
    d = side.disp
    out = {
        "status": {k: d.status(k) for k in sorted(keys)},
        "pending": list(d._pending),
        "parked": sorted(d._parked),
        "records": side.registry.pods(),
        "evictions": sorted((e["victim"], e["preemptor"], e["node"])
                            for e in d.evictions()),
        "invariants": d.invariant_snapshot(),
        "groups": sorted(side.engine.groups._groups),
        "gangs": {g: sorted(s["members"])
                  for g, s in side.coord.snapshot()["gangs"].items()},
        "shed_total": d.shed_total,
        "leaves": {cid: (round(leaf.available, 9), leaf.free_memory,
                         leaf.healthy)
                   for cid, leaf in side.engine.leaf_cells.items()},
    }
    if side.hw is not None:
        out["health"] = side.hw.snapshot()
        out["veto"] = sorted(side.engine.health_veto)
        out["evicted_total"] = side.hw.evicted_total
    return out


class Twin:
    """The same operations on both sides, compared after each."""

    def __init__(self, **kw):
        self.clock = FakeClock()
        self.port = Side(PORT, self.clock, **kw)
        self.jax = Side(JAX, self.clock, **kw)
        self.keys = set()

    def both(self, fn):
        mine, theirs = fn(self.port), fn(self.jax)
        assert mine == theirs
        return mine

    def submit(self, ns, name, labels, uid=""):
        self.keys.add(f"{ns}/{name}")
        return self.both(lambda s: s.submit(ns, name, labels, uid))

    def step(self):
        return self.both(lambda s: s.disp.step())

    def delete(self, key):
        return self.both(lambda s: s.disp.delete(key))

    def advance(self, seconds, dt=1.0):
        end = self.clock.t + seconds
        while self.clock.t < end:
            self.clock.t = min(end, self.clock.t + dt)
            for side in (self.port, self.jax):
                side.beat()
            self.step()
            self.check()

    def silence(self, node, on=True):
        for side in (self.port, self.jax):
            (side.silent.add if on else side.silent.discard)(node)

    def check(self):
        mine, theirs = view(self.port, self.keys), view(self.jax, self.keys)
        assert mine == theirs
        assert decision_stream(self.port) == decision_stream(self.jax)
        return mine


# --- the JAX tests' scenarios, side by side --------------------------------

def test_a_regular_pod_binds_in_one_step():
    tw = Twin(hosts=1, health=False)
    key = tw.submit("ns", "p", shared())
    tw.step()
    v = tw.check()
    assert v["status"][key]["status"] == "bound"
    assert v["records"][key]["node"] == "tpu-host-0"


def test_a_trickling_gang_is_held_then_released():
    tw = Twin(hosts=1, mesh=(2,), health=False)
    blocker = tw.submit("ns", "blocker", shared("1", "1"))
    tw.step()
    k1 = tw.submit("ns", "g-0", gang("g", request="1", limit="1"))
    k2 = tw.submit("ns", "g-1", gang("g", request="1", limit="1"))
    tw.step()
    v = tw.check()
    assert {v["status"][k1]["status"], v["status"][k2]["status"]} == {
        "parked", "pending"}
    tw.delete(blocker)
    tw.clock.t += 1.5
    tw.step()
    v = tw.check()
    assert all(v["status"][k]["status"] == "bound" for k in (k1, k2))
    assert set(v["gangs"]) == {"ns/g"}


def test_a_gang_permit_timeout_rejects_the_whole_gang():
    tw = Twin(hosts=1, mesh=(1,), health=False)
    k1 = tw.submit("ns", "g-0", gang("g", request="0.5"))
    k2 = tw.submit("ns", "g-1", gang("g", request="0.6"))
    tw.step()
    v = tw.check()
    assert v["status"][k1]["status"] == "parked"
    assert v["records"]
    tw.clock.t += 2.0 * 2 + 1.0
    tw.step()
    v = tw.check()
    for k in (k1, k2):
        assert v["status"][k]["status"] == "rejected"
        assert "timeout" in v["status"][k]["reason"]
    assert v["records"] == {}


def test_the_queue_orders_by_priority_then_time():
    tw = Twin(hosts=1, health=False)
    for i in range(3):
        tw.submit("ns", f"fill-{i}", shared("1", "1"))
    tw.step()
    lo = tw.submit("ns", "lo", shared("1", "1", **{C.POD_PRIORITY: "1"}))
    hi = tw.submit("ns", "hi", shared("1", "1", **{C.POD_PRIORITY: "90"}))
    tw.step()
    v = tw.check()
    assert v["status"][hi]["status"] == "bound"
    assert v["status"][lo]["status"] == "pending"


def test_an_unschedulable_pod_retries_after_its_backoff():
    tw = Twin(hosts=1, mesh=(1,), health=False)
    a = tw.submit("ns", "a", shared("1", "1"))
    b = tw.submit("ns", "b", shared("1", "1"))
    tw.step()
    tw.delete(a)
    tw.clock.t += 0.5          # inside the backoff: still pending
    tw.step()
    assert tw.check()["status"][b]["status"] == "pending"
    tw.clock.t += 0.6
    tw.step()
    assert tw.check()["status"][b]["status"] == "bound"


@pytest.mark.parametrize("case", ["max-pending", "fair-share"])
def test_overloaded_admission_gives_the_same_reasons(case):
    tw = Twin(hosts=1, mesh=(1,), health=False, max_pending=8)
    tw.submit("a", "hog", shared("1", "1"))
    tw.step()
    if case == "max-pending":
        outs = [tw.submit("a", f"p{i}", shared("1", "1"))
                for i in range(10)]
    else:
        # a holds 5 of 8; with b active its fair share is 4
        outs = [tw.submit("a", f"p{i}", shared("1", "1")) for i in range(5)]
        outs += [tw.submit("b", "q0", shared("1", "1"))]
        outs += [tw.submit("a", "late", shared("1", "1"))]
    refused = [o for o in outs if isinstance(o, tuple)]
    assert refused and all(o[1] in ("max-pending", "fair-share")
                           for o in refused)
    assert any(o[1] == case for o in refused)
    v = tw.check()
    assert v["shed_total"] == len(refused)
    # a resubmit of a queued pod is not new load
    assert tw.submit("a", "p0", shared("1", "1")) == "a/p0"


def test_a_guarantee_pod_requests_evictions_of_opportunistic_pods():
    tw = Twin(hosts=1, mesh=(2,), health=False)
    fill = [tw.submit("ns", f"opp-{i}", shared("1", "1",
                                               **{C.POD_PRIORITY: "0"}))
            for i in range(2)]
    tw.step()
    g = tw.submit("ns", "guarantee", shared("1", "1",
                                            **{C.POD_PRIORITY: "50"}))
    tw.step()
    v = tw.check()
    assert v["evictions"], v
    victim = v["evictions"][0][0]
    assert victim in fill
    tw.delete(victim)          # the bridge's delete, seen as DELETED
    tw.step()
    tw.clock.t += 1.1
    tw.step()
    v = tw.check()
    assert v["status"][g]["status"] == "bound"
    assert v["evictions"] == []


def test_a_deadline_times_a_pending_pod_out():
    tw = Twin(hosts=1, mesh=(1,), health=False)
    tw.submit("ns", "hog", shared("1", "1"))
    late = tw.submit("ns", "late", shared("1", "1",
                                          **{C.POD_DEADLINE: "3"}))
    tw.step()
    for _ in range(4):
        tw.clock.t += 1.0
        tw.step()
    assert tw.check()["status"][late]["status"] == "timed-out"


def test_group_gc_runs_on_its_period():
    """A deleted gang's group expires, and the 30 s GC drops it."""
    tw = Twin(hosts=1, health=False)
    k = tw.submit("ns", "g-0", gang("g", headcount=3))
    tw.step()
    assert tw.check()["groups"] == ["ns/g"]
    tw.delete(k)
    seen = []
    for _ in range(30):
        tw.clock.t += dispatcher.GC_PERIOD_S
        tw.step()
        seen.append(tw.check()["groups"])
    assert seen[0] == ["ns/g"] and seen[-1] == []


# --- the health watch ------------------------------------------------------

def test_a_silent_node_is_declared_dead_and_its_pods_rebind():
    tw = Twin(hosts=2)
    key = tw.submit("ns", "p", shared())
    tw.step()
    victim = tw.check()["status"][key]["node"]
    tw.silence(victim)
    tw.advance(TTL + 2.0)
    assert tw.check()["health"][victim]["state"] == "suspect"
    tw.advance(MISS * TTL + TTL)
    v = tw.check()
    assert v["health"][victim]["state"] == "dead"
    assert victim in v["veto"] and v["evicted_total"] == 1
    assert v["status"][key]["status"] == "bound"
    assert v["status"][key]["node"] != victim
    tw.silence(victim, on=False)
    tw.advance(TTL)
    assert tw.check()["health"][victim]["state"] == "quarantined"
    tw.advance(QUARANTINE + TTL)
    assert tw.check()["health"][victim]["state"] == "up"


def test_a_dead_member_evicts_its_whole_gang():
    tw = Twin(hosts=2, mesh=(2,))
    k0 = tw.submit("ns", "g-0", gang("g", request="1", limit="1"))
    k1 = tw.submit("ns", "g-1", gang("g", request="1", limit="1"))
    tw.step()
    victim = tw.check()["status"][k0]["node"]
    tw.silence(victim)
    tw.advance(MISS * TTL + 2 * TTL)
    v = tw.check()
    assert v["health"][victim]["state"] == "dead"
    for k in (k0, k1):
        assert v["status"][k]["status"] in ("bound", "pending", "parked")
        assert v["status"][k].get("node") != victim


def test_evict_node_requeues_and_reports_node_lost():
    """The only node dies: its pods wait in the queue as "node lost"."""
    tw = Twin(hosts=1)
    keys = [tw.submit("ns", f"p{i}", shared()) for i in range(3)]
    tw.step()
    assert sorted(tw.both(lambda s: s.disp.evict_node("tpu-host-0"))) == (
        sorted(keys))
    v = tw.check()
    for k in keys:
        assert v["status"][k]["status"] == "pending"
        assert v["status"][k]["reason"] == "node lost (tpu-host-0)"
    assert v["records"] == {}


def test_evict_node_tries_migrate_fn_first():
    tw = Twin(hosts=2, health=False)
    key = tw.submit("ns", "p", shared())
    tw.step()
    node = tw.check()["status"][key]["node"]
    plans = {}

    def evict(side):
        def migrate(pod, plan):
            plans.setdefault(side.mods.dispatcher.__name__, plan["node"])
            return True
        return side.disp.evict_node(node, migrate_fn=migrate)

    assert tw.both(evict) == [key]
    assert len(set(plans.values())) == 1
    tw.step()
    tw.check()


# --- a seeded churn through both dispatchers -------------------------------

LABEL_MIX = [
    lambda r: shared("0.5", "1.0"),
    lambda r: shared("0.25", "0.5"),
    lambda r: shared("1", "1"),
    lambda r: shared("2", "2"),
    lambda r: shared("0.5", "1.0", **{C.POD_PRIORITY: "0"}),
    lambda r: shared("1", "1", **{C.POD_PRIORITY: "60"}),
    lambda r: shared("0.3", "0.6", **{C.POD_TPU_MEMORY: str(2 ** 32)}),
    lambda r: shared("0.5", "1.0", **{C.POD_DEADLINE: "4"}),
    lambda r: gang(f"g{r.randrange(3)}", headcount=2, request="0.5"),
    lambda r: gang(f"h{r.randrange(2)}", headcount=3, threshold=0.6,
                   request="1", limit="1"),
    lambda r: shared("1.5", "1"),                 # a label error
]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_a_seeded_churn_runs_the_same_on_both(seed):
    rng = random.Random(seed)
    tw = Twin(hosts=3, mesh=(2, 2), max_pending=12)
    nodes = sorted(tw.port.engine.chips_by_node)
    for _ in range(160):
        op = rng.random()
        if op < 0.45:
            ns = rng.choice(["a", "b", "c"])
            name = f"p{rng.randrange(24)}"
            uid = f"u{rng.randrange(3)}" if rng.random() < 0.2 else ""
            tw.submit(ns, name, rng.choice(LABEL_MIX)(rng), uid=uid)
        elif op < 0.6 and tw.keys:
            tw.delete(rng.choice(sorted(tw.keys)))
        elif op < 0.8:
            tw.step()
        elif op < 0.95:
            tw.advance(rng.choice([0.5, 1.0, 2.5, 6.0]))
        else:
            node = rng.choice(nodes)
            tw.silence(node, on=node not in tw.port.silent)
        tw.check()
    tw.advance(MISS * TTL + QUARANTINE + 3 * TTL, dt=2.0)
    v = tw.check()
    assert v["invariants"]["ok"]
    kinds = {e["kind"] for e in decision_stream(tw.port)}
    assert {"fleet", "submit", "outcome", "delete", "view"} <= kinds
    statuses = {st["status"] for st in v["status"].values()}
    assert {"bound", "deleted"} <= statuses
