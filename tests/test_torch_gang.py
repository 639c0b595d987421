"""The port's gang token coordinator and cluster-invariant oracle against
the JAX package's.

The coordinator: both run in auto-drive (the chaos plane's virtual-time
mode) over per-device token schedulers on one virtual clock, and give
the same reserve, commit, partial-release, backoff and preemption
sequence, the same grant states and the same snapshot at every tick.
The oracle: the same corrupted bookings give the same violations.

Mirrors the coordinator cases of ``tests/test_gang.py`` and the engine
cases of ``tests/test_chaos.py``.
"""

import random
import types

import pytest

from kubeshare_tpu.chaos import invariants as jinv
from kubeshare_tpu.gang import coordinator as jcoord
from kubeshare_tpu.isolation import tokensched as jts
from kubeshare_tpu.obs import decisions as jdec
from kubeshare_tpu.preempt import PreemptionPolicy as JaxPolicy
from kubeshare_tpu.scheduler import engine as jengine
from kubeshare_tpu.topology import discovery as jdiscovery
from kubeshare_tpu_torch import constants as C
from kubeshare_tpu_torch.chaos import invariants as inv
from kubeshare_tpu_torch.gang import GangTokenCoordinator
from kubeshare_tpu_torch.gang import coordinator
from kubeshare_tpu_torch.isolation import tokensched
from kubeshare_tpu_torch.obs import decisions as dec
from kubeshare_tpu_torch.preempt import PreemptionPolicy
from kubeshare_tpu_torch.scheduler import engine
from kubeshare_tpu_torch.topology import discovery

PORT = types.SimpleNamespace(coordinator=coordinator, ts=tokensched,
                             policy=PreemptionPolicy, decisions=dec,
                             engine=engine, discovery=discovery, inv=inv)
JAX = types.SimpleNamespace(coordinator=jcoord, ts=jts, policy=JaxPolicy,
                            decisions=jdec, engine=jengine,
                            discovery=jdiscovery, inv=jinv)


def test_the_package_exports_the_coordinator():
    assert GangTokenCoordinator is coordinator.GangTokenCoordinator


class Drive:
    """One side: a coordinator over ``nchips`` schedulers, all on one
    virtual clock (seconds for the coordinator, ms for the cores)."""

    def __init__(self, mods, nchips=2, gangs=(("ns/g", "best-effort"),),
                 preempt=False, seed=5, auto_hold_s=0.05):
        self.t = 0.0
        self.policy = None
        self.decisions = mods.decisions.DecisionRecorder(
            clock=lambda: self.t)
        if preempt:
            self.policy = mods.policy(grace_ms=10.0, min_hold_ms=0.0)
            self.policy.decisions = self.decisions
        self.coord = mods.coordinator.GangTokenCoordinator(
            reserve_window_s=0.08, backoff_base_s=0.005,
            backoff_max_s=0.03, clock=lambda: self.t,
            rng=random.Random(seed), auto_hold_s=auto_hold_s,
            preempt=self.policy)
        self.coord.auto_drive = True
        self.scheds = {}
        for i in range(nchips):
            chip = f"chip-{i}"
            self.scheds[chip] = mods.ts.TokenScheduler(
                1000.0, 100.0, 10.0, native=False,
                clock=lambda: self.t * 1000.0, chip=chip,
                preempt=self.policy)
            self.coord.attach_chip(chip, self.scheds[chip])
        for gang, cls in gangs:
            members = []
            for chip, sched in sorted(self.scheds.items()):
                sched.add_client(f"{gang}/{chip}", 0.4, 1.0, tpu_class=cls)
                members.append((chip, f"{gang}/{chip}"))
            self.coord.register_gang(gang, members, namespace="ns",
                                     tpu_class=cls)
        self.solo_held = False

    def solo(self, chip="chip-1"):
        self.scheds[chip].add_client("solo", 0.3, 1.0)
        self.scheds[chip].acquire("solo", timeout=0)
        self.solo_held = True

    def tick(self, dt=0.01, solo_release_at=None, chip="chip-1"):
        self.t = round(self.t + dt, 9)
        if self.solo_held and (
                self.scheds[chip].preempted("solo")
                or (solo_release_at is not None
                    and self.t >= solo_release_at)):
            self.scheds[chip].release("solo", 5.0)
            self.solo_held = False
        self.coord.step(self.t)
        return self.view()

    def view(self):
        snap = self.coord.snapshot()
        return {"snapshot": snap,
                "grants": self.coord.grant_states(self.t),
                "holders": {c: s.core.holder()
                            for c, s in self.scheds.items()},
                "solo": self.solo_held}


def run_both(ticks, setup=lambda d: None, **kw):
    port, jax = Drive(PORT, **kw), Drive(JAX, **kw)
    setup(port)
    setup(jax)
    views = []
    for i in range(ticks):
        mine, theirs = port.tick(**ticks_kw(i)), jax.tick(**ticks_kw(i))
        assert mine == theirs, i
        views.append(mine)
    strip = [{k: v for k, v in e.items() if k != "t"}
             for e in port.decisions.entries()]
    assert strip == [{k: v for k, v in e.items() if k != "t"}
                     for e in jax.decisions.entries()]
    return views, port, jax


def ticks_kw(i):
    return {}


def test_an_uncontended_gang_cycles_reserve_hold_release():
    views, port, _ = run_both(40)
    g = views[-1]["snapshot"]["gangs"]["ns/g"]
    assert g["grants"] >= 3 and g["partial_releases"] == 0
    states = {v["snapshot"]["gangs"]["ns/g"]["state"] for v in views}
    assert {"held", "idle"} <= states


def test_a_cotenant_holding_one_chip_forces_partial_releases_and_backoff():
    views, port, _ = run_both(30, setup=lambda d: d.solo())
    g = views[-1]["snapshot"]["gangs"]["ns/g"]
    assert g["grants"] == 0 and g["partial_releases"] >= 1
    assert all(v["holders"]["chip-1"] == "solo" for v in views)


def test_a_latency_gang_preempts_a_best_effort_gang():
    """The best-effort gang would hold for 10 s; each failed reserve
    window of the latency gang preempts it atomically, and it yields at
    its next step (in auto-drive the latency gang is then backing off,
    in both packages, and the best-effort gang takes the devices back)."""
    views, port, jax = run_both(
        60, gangs=(("ns/be", "best-effort"), ("ns/lat", "latency")),
        preempt=True, auto_hold_s=10.0)
    gangs = views[-1]["snapshot"]["gangs"]
    assert gangs["ns/be"]["preemptions"] >= 3
    assert any(v["snapshot"]["gangs"]["ns/be"]["preempt_requested"]
               for v in views)
    kinds = [e["kind"] for e in port.decisions.entries()]
    assert "gang-preempt" in kinds
    assert port.policy.snapshot() == jax.policy.snapshot()


@pytest.mark.parametrize("seed", [1, 2])
def test_membership_changes_and_pauses_run_alike(seed):
    rng = random.Random(seed)
    port, jax = Drive(PORT, nchips=3), Drive(JAX, nchips=3)
    for i in range(120):
        op = rng.random()
        if op < 0.05:
            for d in (port, jax):
                d.coord.pause("ns/g", timeout=0)
        elif op < 0.1:
            for d in (port, jax):
                d.coord.resume("ns/g")
        elif op < 0.13:
            chips = sorted(rng.sample(["chip-0", "chip-1", "chip-2"], 2))
            for d in (port, jax):
                d.coord.register_gang(
                    "ns/g", [(c, f"ns/g/{c}") for c in chips],
                    namespace="ns")
        elif op < 0.15:
            for d in (port, jax):
                d.coord.unregister_gang("ns/g")
        assert port.tick() == jax.tick(), i


# --- the invariant oracle ---------------------------------------------------

def fleet(mods, clock):
    eng = mods.engine.SchedulerEngine(clock=clock)
    by_host = {}
    for chip in mods.discovery.FakeTopology(hosts=2, mesh=(2, 2)).chips():
        by_host.setdefault(chip.host, []).append(chip)
    for host, chips in by_host.items():
        eng.add_node(host, chips)
    for i in range(5):
        eng.schedule(eng.submit("ns", f"p{i}", {
            C.POD_TPU_REQUEST: "0.5", C.POD_TPU_LIMIT: "1.0",
            C.POD_TPU_MEMORY: str(2 ** 30)}))
    members = [eng.submit("ns", f"g{i}", {
        C.POD_TPU_REQUEST: "1", C.POD_TPU_LIMIT: "1",
        C.POD_GROUP_NAME: "g", C.POD_GROUP_HEADCOUNT: "2",
        C.POD_GROUP_THRESHOLD: "1.0"}) for i in range(2)]
    for pod in members:
        eng.schedule(pod)
    return eng


def corrupt(eng, how):
    leaf = eng.leaf_cells[sorted(eng.leaf_cells)[0]]
    pods = sorted(eng.pod_status.values(), key=lambda p: p.key)
    if how == "available":
        leaf.available -= 0.25
    elif how == "memory":
        leaf.free_memory -= 4096
    elif how == "double-booking":
        bound = next(p for p in pods if p.bookings)
        chip, comp, mem = bound.bookings[0]
        bound.bookings = list(bound.bookings) + [(chip, 2.0, 10 ** 15)]
    elif how == "torn-gang":
        member = next(p for p in pods if p.group_name)
        member.node_name = ""


@pytest.mark.parametrize("how", ["none", "available", "memory",
                                 "double-booking", "torn-gang"])
def test_check_engine_gives_the_same_violations(how):
    out = []
    for mods in (PORT, JAX):
        eng = fleet(mods, lambda: 50.0)
        corrupt(eng, how)
        out.append((mods.inv.check_engine(eng),
                    mods.inv.check_engine(eng, in_flight={"ns/g0"}),
                    mods.inv.check_gang_atomicity(eng),
                    mods.inv.check_cluster(engine=eng)))
    assert out[0] == out[1]
    if how == "none":
        assert out[0][0] == []
    else:
        assert out[0][0], how


def test_grant_atomicity_and_token_shares_check_alike():
    out = []
    for mods in (PORT, JAX):
        d = Drive(mods)
        d.solo()
        for _ in range(6):
            d.tick()
        d.t += 1.0                    # a reserve window far past due
        out.append((mods.inv.check_gang_grant_atomicity(d.coord, now=d.t),
                    mods.inv.check_token_shares(d.scheds)))
    assert out[0] == out[1]
