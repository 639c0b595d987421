"""The port's sharded dispatcher against the JAX package's: the same
submits, deletes and steps on one fake clock, at 2 and 4 shards, on the
cell and the score route, give the same outcomes, queues, bookings,
registry records, invariant snapshots and decision streams after every
operation (exact). Then a cross-shard gang whose commit fails midway
rolls back alike, ``make_dispatcher(shards=1)`` is the plain dispatcher,
and the port's divergences: the fleet façade takes the registry's
capacity sync, the replay books each record on its node's shard, and a
frozen plane runs no health detection.

Mirrors ``tests/test_shard.py``. Trace ids are random and stay out of
every comparison; each dispatcher dumps a private flight recorder.
"""

import random
import types

import pytest

from kubeshare_tpu.obs import decisions as jdecisions
from kubeshare_tpu.scheduler import shard as jshard
from kubeshare_tpu.telemetry import registry as jregistry
from kubeshare_tpu.topology import discovery as jdiscovery
from kubeshare_tpu_torch import constants as C
from kubeshare_tpu_torch.obs import decisions
from kubeshare_tpu_torch.scheduler import shard
from kubeshare_tpu_torch.scheduler.dispatcher import Dispatcher
from kubeshare_tpu_torch.scheduler.healthwatch import HealthWatch
from kubeshare_tpu_torch.telemetry import registry
from kubeshare_tpu_torch.telemetry.aggregator import (
    sync_engine_from_registry)
from kubeshare_tpu_torch.topology import discovery

from test_torch_dispatcher import (FakeClock, gang,  # noqa: F401
                                   private_recorders, shared, strip_trace)

PORT = types.SimpleNamespace(shard=shard, registry=registry,
                             discovery=discovery, decisions=decisions)
JAX = types.SimpleNamespace(shard=jshard, registry=jregistry,
                            discovery=jdiscovery, decisions=jdecisions)


def fleet_of(mods, hosts, mesh):
    by_host = {}
    for chip in mods.discovery.FakeTopology(hosts=hosts, mesh=mesh).chips():
        by_host.setdefault(chip.host, []).append(chip)
    return by_host


class Plane:
    """One package's sharded dispatcher over its own registry, with a
    decision recorder, on the shared clock."""

    def __init__(self, mods, clock, shards, route, hosts=4, mesh=(2, 2)):
        self.mods = mods
        self.registry = mods.registry.TelemetryRegistry(clock=clock)
        self.plane = mods.shard.build_sharded(
            fleet_of(mods, hosts, mesh), shards, clock=clock, route=route,
            registry=self.registry, retry_backoff_s=1.0)
        self.decisions = mods.decisions.DecisionRecorder(clock=clock)
        self.plane.attach_decisions(self.decisions)

    def submit(self, ns, name, labels):
        try:
            return self.plane.submit(ns, name, labels)
        except ValueError as e:          # LabelError
            return ("label-error", str(e))


def view(side, keys):
    p = side.plane
    return {
        "status": {k: p.status(k) for k in sorted(keys)},
        "pending": [sorted(sh._pending) for sh in p.shards],
        "parked": [sorted(sh._parked) for sh in p.shards],
        "owners": {k: [i for i, sh in enumerate(p.shards)
                       if k in sh.engine.pod_status] for k in sorted(keys)},
        "leaves": [{cid: (round(leaf.available, 9), leaf.free_memory)
                    for cid, leaf in sh.engine.leaf_cells.items()}
                   for sh in p.shards],
        "records": side.registry.pods(),
        "invariants": p.invariant_snapshot(),
        "evictions": sorted((e["victim"], e["preemptor"])
                            for e in p.evictions()),
    }


def stream(side):
    return [strip_trace(side.mods.decisions.canonical_entry(e))
            for e in side.decisions.entries()]


class Twin:
    def __init__(self, shards, route, **kw):
        self.clock = FakeClock()
        self.port = Plane(PORT, self.clock, shards, route, **kw)
        self.jax = Plane(JAX, self.clock, shards, route, **kw)
        self.keys = set()

    def both(self, fn):
        mine, theirs = fn(self.port), fn(self.jax)
        assert mine == theirs
        return mine

    def submit(self, ns, name, labels):
        self.keys.add(f"{ns}/{name}")
        return self.both(lambda s: s.submit(ns, name, labels))

    def check(self):
        mine, theirs = view(self.port, self.keys), view(self.jax, self.keys)
        assert mine == theirs
        assert stream(self.port) == stream(self.jax)
        return mine


MIX = [
    lambda r: shared("0.5", "1.0"),
    lambda r: shared("0.25", "0.5"),
    lambda r: shared("1", "1"),
    lambda r: shared("2", "2"),
    lambda r: shared("0.5", "1.0", **{C.POD_PRIORITY: "0"}),
    lambda r: shared("1", "1", **{C.POD_PRIORITY: "60"}),
    lambda r: shared("0.5", "1.0", **{C.POD_DEADLINE: "4"}),
    lambda r: gang(f"g{r.randrange(3)}", headcount=2, request="0.5"),
    lambda r: gang(f"w{r.randrange(3)}", headcount=2, request="1",
                   limit="1"),
    lambda r: shared("1.5", "1"),                 # a label error
]


@pytest.mark.parametrize("route", ["cell", "score"])
@pytest.mark.parametrize("shards", [2, 4])
def test_a_seeded_churn_runs_the_same_on_both_planes(shards, route):
    rng = random.Random(shards * 10 + len(route))
    tw = Twin(shards, route)
    groups = {}
    for _ in range(160):
        op = rng.random()
        if op < 0.45:
            ns, name = rng.choice(["a", "b"]), f"p{rng.randrange(30)}"
            labels = rng.choice(MIX)(rng)
            tw.submit(ns, name, labels)
            groups.setdefault(f"{ns}/{name}",
                              f"{ns}/{labels.get(C.POD_GROUP_NAME, name)}")
        elif op < 0.6 and tw.keys:
            # a gang goes whole: the cross-shard checker counts a gang
            # with some members deleted as torn
            group = groups[rng.choice(sorted(tw.keys))]
            for key in sorted(k for k, g in groups.items() if g == group):
                tw.both(lambda s: s.plane.delete(key))
        elif op < 0.85:
            tw.both(lambda s: s.plane.step())
        else:
            tw.clock.t += rng.choice([0.5, 1.0, 2.5, 6.0])
            tw.both(lambda s: s.plane.step())
        tw.check()
    for _ in range(6):
        tw.clock.t += 2.0
        tw.both(lambda s: s.plane.step())
        v = tw.check()
    assert v["invariants"]["ok"]
    statuses = {st["status"] for st in v["status"].values()}
    assert {"bound", "deleted"} <= statuses
    kinds = {e["kind"] for e in stream(tw.port)}
    assert {"fleet", "submit", "outcome", "delete", "view"} <= kinds


def names_homing_to(plane, shard_id, count, prefix, labels=None):
    out, i = [], 0
    while len(out) < count:
        if plane.home_shard("ns", f"{prefix}{i}", labels) == shard_id:
            out.append(f"{prefix}{i}")
        i += 1
    return out


def test_a_cross_shard_gang_rolls_back_a_failed_commit_alike():
    """Four whole-device members over two one-node shards of two devices
    each: only a cross-shard commit holds them. The commit fails after
    two members on both planes; every booking comes back, then the next
    attempt binds the whole gang alike."""
    tw = Twin(2, "cell", hosts=2, mesh=(2,))
    gname = next(f"g{i}" for i in range(100)
                 if tw.port.plane.home_shard(
                     "ns", "m", {C.POD_GROUP_NAME: f"g{i}"}) == 0)
    assert tw.jax.plane.home_shard("ns", "m",
                                   {C.POD_GROUP_NAME: gname}) == 0
    for i in range(4):
        tw.submit("ns", f"{gname}-{i}",
                  gang(gname, headcount=4, request="1", limit="1"))
    for side in (tw.port, tw.jax):
        side.plane.fail_commit_at = 2
    tw.both(lambda s: s.plane.step())
    v = tw.check()
    assert all(st["status"] == "pending" for st in v["status"].values())
    assert all(a == 1.0 for leaves in v["leaves"]
               for a, _ in leaves.values())
    assert v["records"] == {} and v["invariants"]["ok"]
    assert tw.port.plane.fail_commit_at is None
    tw.clock.t += 2.0
    tw.both(lambda s: s.plane.step())
    v = tw.check()
    assert all(st["status"] == "bound" for st in v["status"].values())
    assert sorted({st["node"] for st in v["status"].values()}) == [
        "tpu-host-0", "tpu-host-1"]
    assert any(e["kind"] == "gang-cross-shard" for e in stream(tw.port))


def test_spillover_rehomes_a_pod_alike():
    tw = Twin(2, "cell", hosts=2, mesh=(2,))
    for nm in names_homing_to(tw.port.plane, 0, 2, "blk"):
        tw.submit("ns", nm, shared("1", "1"))
    tw.both(lambda s: s.plane.step())
    spiller = names_homing_to(tw.port.plane, 0, 1, "sp")[0]
    tw.submit("ns", spiller, shared("1", "1"))
    for _ in range(3):
        tw.clock.t += 1.0
        tw.both(lambda s: s.plane.step())
        v = tw.check()
    assert v["status"][f"ns/{spiller}"]["status"] == "bound"
    assert v["owners"][f"ns/{spiller}"] == [1]
    assert any(e["kind"] == "shard-spill" for e in stream(tw.port))


def test_make_dispatcher_with_one_shard_is_the_plain_dispatcher():
    clock = FakeClock()
    for mods, plain in ((shard, Dispatcher), (jshard, None)):
        d = mods.make_dispatcher(fleet_of(PORT if mods is shard else JAX,
                                          2, (2, 2)),
                                 shards=1, clock=clock)
        assert not isinstance(d, mods.ShardedDispatcher)
        if plain is not None:
            assert type(d) is plain
        key = d.submit("ns", "p", shared())
        d.step()
        assert d.outcome(key).status == "bound"
    with pytest.raises(ValueError):
        shard.make_dispatcher(shard.SchedulerEngine(), shards=2)


def test_the_shard_plan_matches_the_jax_plan():
    for hosts, n in ((8, 4), (5, 2), (64, 4)):
        mine = shard.ShardPlan(fleet_of(PORT, hosts, (2,)), n)
        theirs = jshard.ShardPlan(fleet_of(JAX, hosts, (2,)), n)
        assert mine.assign == theirs.assign
        assert [mine.shard_of(f"late-{i}") for i in range(20)] == [
            theirs.shard_of(f"late-{i}") for i in range(20)]


# --- the port's divergences -------------------------------------------------

def test_the_fleet_engine_takes_the_registry_capacity_sync():
    """The JAX façade has no ``set_fleet``: its sharded service and
    standby skip their capacity sync. The port's routes each node to its
    shard; a node the plan never saw goes to its hash shard."""
    clock = FakeClock()
    reg = registry.TelemetryRegistry(clock=clock)
    fleet = fleet_of(PORT, 4, (2,))
    plane = shard.build_sharded(fleet, 2, clock=clock, registry=reg)
    assert not hasattr(jshard._FleetEngine, "set_fleet")
    for host, chips in fleet_of(PORT, 5, (2,)).items():
        reg.put_capacity(host, [c.to_labels() for c in chips],
                         healthy=host != "tpu-host-1")
    sync_engine_from_registry(plane.engine, reg)
    assert plane.engine.nodes == [f"tpu-host-{i}" for i in range(5)]
    new_home = plane.plan.shard_of("tpu-host-4")
    assert "tpu-host-4" in plane.shards[new_home].engine.chips_by_node
    assert plane.engine.node_health["tpu-host-1"] is False
    for i, sh in enumerate(plane.shards):
        assert all(plane.plan.shard_of(n) == i
                   for n in sh.engine.chips_by_node)


def test_the_sharded_replay_books_each_record_on_its_nodes_shard():
    clock = FakeClock()
    reg = registry.TelemetryRegistry(clock=clock)
    fleet = fleet_of(PORT, 4, (2,))
    lead = shard.build_sharded(fleet, 2, clock=clock, registry=reg,
                               route="score")
    keys = [lead.submit("ns", f"w{i}", shared("1", "1")) for i in range(6)]
    lead.step()
    assert set(reg.pods()) == set(keys)
    standby = shard.build_sharded(fleet, 2, clock=clock, registry=reg)
    assert sorted(standby.replay_bound()) == sorted(keys)
    for key in keys:
        node = reg.pods()[key]["node"]
        owners = [i for i, sh in enumerate(standby.shards)
                  if key in sh.engine.pod_status]
        assert owners == [standby.plan.shard_of(node)]
        assert standby.status(key)["node"] == node
    assert standby.invariant_snapshot()["ok"]
    # a record the leader withdrew since leaves the standby's copy too
    reg.drop_pod(keys[0])
    standby.replay_bound(standby=True)
    assert keys[0] not in standby.engine.pod_status
    assert standby.invariant_snapshot()["bound"] == 5


def test_a_frozen_plane_runs_no_health_detection():
    clock = FakeClock()
    reg = registry.TelemetryRegistry(clock=clock)
    plane = shard.build_sharded(fleet_of(PORT, 2, (2,)), 2, clock=clock,
                                registry=reg)
    polls = []
    hw = HealthWatch(reg, clock=clock)
    hw.poll = lambda now, d: polls.append(now)
    hw.due = lambda now: True
    plane.attach_healthwatch(hw)
    plane.step()
    assert len(polls) == 1
    plane.freeze("standby")
    plane.step()
    assert len(polls) == 1
    plane.unfreeze()
    plane.step()
    assert len(polls) == 2


def test_a_sharded_leaders_records_replay_on_a_plain_dispatcher():
    """The records a sharded leader publishes are the single-lock
    dispatcher's: a plain standby replays them."""
    clock = FakeClock()
    reg = registry.TelemetryRegistry(clock=clock)
    plane = shard.build_sharded(fleet_of(PORT, 2, (2,)), 2, clock=clock,
                                registry=reg, route="cell")
    key = plane.submit("ns", "a", shared())
    plane.step()
    assert key in reg.pods()
    plain = shard.make_dispatcher(fleet_of(PORT, 2, (2,)), shards=1,
                                  clock=clock, registry=reg)
    assert plain.replay_bound() == [key]
    assert plain.status(key)["node"] == plane.status(key)["node"]
