"""The port's control-plane HA against the JAX package's ``ha/``: the same
``step(now)`` sequences on one fake clock give the same epochs,
takeovers, freezes and ``leadership`` decisions; a follower registry
holds the leader's capacity, pods and leases after the same writes,
rebases on a stream change and answers writes 307 with the leader's
address. Then the port's own: a warm standby over the sharded plane
takes a leader's bound pods over, its replay drops pods the leader has
withdrawn, two services share one registry, and the registry CLI's
``--follower-of`` is promoted by SIGHUP.

Mirrors ``tests/test_ha.py``. Each standby and dispatcher dumps a private
flight recorder; a test fails if the JAX default recorder dumped.
"""

import json
import os
import signal
import subprocess
import sys
import time
import types
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from kubeshare_tpu import ha as jha
from kubeshare_tpu.ha import standby as jstandby
from kubeshare_tpu.obs import decisions as jdecisions
from kubeshare_tpu.obs import flight as jflight
from kubeshare_tpu.scheduler import dispatcher as jdispatcher
from kubeshare_tpu.scheduler import engine as jengine
from kubeshare_tpu.scheduler.service import SchedulerService as JaxService
from kubeshare_tpu.telemetry import aggregator as jaggregator
from kubeshare_tpu.telemetry import registry as jregistry
from kubeshare_tpu.topology import discovery as jdiscovery
from kubeshare_tpu_torch import constants as C
from kubeshare_tpu_torch import ha
from kubeshare_tpu_torch.ha import standby
from kubeshare_tpu_torch.obs import decisions
from kubeshare_tpu_torch.obs import flight
from kubeshare_tpu_torch.scheduler import dispatcher
from kubeshare_tpu_torch.scheduler import engine
from kubeshare_tpu_torch.scheduler import shard
from kubeshare_tpu_torch.scheduler.bridge import ServiceClient
from kubeshare_tpu_torch.scheduler.service import SchedulerService
from kubeshare_tpu_torch.telemetry import aggregator
from kubeshare_tpu_torch.telemetry import registry
from kubeshare_tpu_torch.topology import discovery

REPO = Path(__file__).resolve().parent.parent

PORT = types.SimpleNamespace(
    ha=ha, standby=standby, decisions=decisions, flight=flight,
    dispatcher=dispatcher, engine=engine, aggregator=aggregator,
    registry=registry, discovery=discovery)
JAX = types.SimpleNamespace(
    ha=jha, standby=jstandby, decisions=jdecisions, flight=jflight,
    dispatcher=jdispatcher, engine=jengine, aggregator=jaggregator,
    registry=jregistry, discovery=jdiscovery)


@pytest.fixture(autouse=True)
def private_recorders(monkeypatch):
    """Each side's standby and dispatcher dump into a recorder of their
    own (kept on ``mods.rec``); a test fails if the JAX default recorder
    dumped all the same."""
    for mods in (PORT, JAX):
        mods.rec = mods.flight.FlightRecorder()
        for mod in (mods.standby, mods.dispatcher):
            monkeypatch.setattr(mod, "default_recorder",
                                lambda rec=mods.rec: rec)
    rec = jflight.default_recorder()
    fired = []
    real = rec.trigger
    monkeypatch.setattr(rec, "trigger",
                        lambda reason, **kw: fired.append(reason)
                        or real(reason, **kw))
    yield
    assert fired == []


class Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def capacity(mods, reg, hosts=1, mesh=(2, 2)):
    by_host = {}
    for chip in mods.discovery.FakeTopology(hosts=hosts, mesh=mesh).chips():
        by_host.setdefault(chip.host, []).append(chip.to_labels())
    for host, labels in by_host.items():
        reg.put_capacity(host, labels)


def shared(request="0.5", limit="1.0", **extra):
    labels = {C.POD_TPU_REQUEST: request, C.POD_TPU_LIMIT: limit}
    labels.update(extra)
    return labels


def leadership(mods, rec):
    return [{k: v for k, v in mods.decisions.canonical_entry(e).items()
             if k not in ("trace_id",)}
            for e in rec.entries() if e["kind"] == "leadership"]


# --- leadership ---------------------------------------------------------------

def test_the_same_election_steps_give_the_same_epochs():
    """Two candidates on one lease, a renewal, an expiry, a takeover and
    the deposed holder learning the new epoch, step for step alike."""
    out = {}
    for label, mods in (("port", PORT), ("jax", JAX)):
        clock = Clock()
        reg = mods.registry.TelemetryRegistry(clock=clock)
        a = mods.ha.LeadershipManager(reg, "scheduler", "a", ttl_s=5.0,
                                      clock=clock)
        b = mods.ha.LeadershipManager(reg, "scheduler", "b", ttl_s=5.0,
                                      clock=clock)
        trace = []
        for dt, who in ((0, a), (0, b), (2, a), (2, b), (6, b), (0, a),
                        (1, a), (1, b), (7, a), (0, b), (0, a)):
            clock.t += dt
            trace.append((who.holder, who.step(), who.epoch,
                          who.takeovers, who.is_leader))
        trace.append(reg.leader("scheduler"))
        out[label] = (trace, a.state(), b.state())
    assert out["port"] == out["jax"]
    assert [t[2] for t in out["port"][0][:-1]][:5] == [1, 1, 1, 1, 2]


def two_dispatchers(mods, clock, reg):
    """A primary with its engine synced and a standby with an empty one,
    each in the election, each with its own decision recorder."""
    eng = mods.engine.SchedulerEngine(clock=clock)
    mods.aggregator.sync_engine_from_registry(eng, reg)
    primary = mods.dispatcher.Dispatcher(eng, reg, clock=clock)
    standby_ = mods.dispatcher.Dispatcher(
        mods.engine.SchedulerEngine(clock=clock), reg, clock=clock)
    recs = [mods.decisions.DecisionRecorder(clock=clock) for _ in range(2)]
    pha = mods.ha.WarmStandby(primary, reg, "primary", ttl_s=5.0,
                              clock=clock, decisions=recs[0])
    sha = mods.ha.WarmStandby(standby_, reg, "standby", ttl_s=5.0,
                              clock=clock, resync_period_s=1.0,
                              decisions=recs[1])
    return primary, standby_, pha, sha, recs


def ha_view(primary, standby_, pha, sha, reg, mods, recs):
    def st(s):
        return {k: v for k, v in s.state().items()
                if k != "last_error"}
    return {
        "primary": (primary.frozen, primary.frozen_reason, st(pha)),
        "standby": (standby_.frozen, standby_.frozen_reason, st(sha)),
        "standby_pods": sorted((k, p.node_name, p.chip_ids)
                               for k, p in standby_.engine.pod_status.items()),
        "records": reg.pods(),
        "leadership": [leadership(mods, r) for r in recs],
        "dumps": [d["reason"] for d in mods.rec.state()["dumps"]],
    }


def test_a_standby_takes_over_alike():
    """The primary leads and binds; the standby stays frozen and warm;
    the primary goes silent past the TTL; the standby takes over at epoch
    2 with the bound pod, records a ``leadership`` decision and a
    ``leadership-transition`` dump; the ex-leader finds itself deposed."""
    views = {}
    for label, mods in (("port", PORT), ("jax", JAX)):
        clock = Clock()
        reg = mods.registry.TelemetryRegistry(clock=clock)
        capacity(mods, reg)
        primary, standby_, pha, sha, recs = two_dispatchers(mods, clock,
                                                            reg)
        args = (primary, standby_, pha, sha, reg, mods, recs)
        trace = [pha.step(), sha.step()]
        primary.submit("ns", "p0", shared())
        primary.submit("ns", "p1", shared("1", "1"))
        primary.step()
        standby_.submit("ns", "q", shared())
        standby_.step()                 # frozen: q stays pending
        trace.append(standby_.status("ns/q"))
        views.setdefault(label, []).append(ha_view(*args))
        for dt in (2.0, 2.0, 6.0, 0.0):
            clock.t += dt
            trace += [pha.step(), sha.step()]
            views[label].append(ha_view(*args))
        standby_.step()                 # unfrozen: q is placed now
        trace.append(standby_.status("ns/q")["status"])
        views[label].append(ha_view(*args))
        views[label].append(trace)
    assert views["port"] == views["jax"]
    last = views["port"][-2]
    assert last["standby"][2]["role"] == "leader"
    assert last["standby"][2]["epoch"] == 2
    assert last["primary"][0] is True and "deposed" in last["primary"][1]
    assert [e["epoch"] for e in last["leadership"][1]] == [2]
    assert last["dumps"].count("leadership-transition") == 2
    assert {k for k, _, _ in last["standby_pods"]} == {"ns/p0", "ns/p1",
                                                       "ns/q"}
    assert views["port"][-1][-1] == "bound"


def test_a_fenced_publish_freezes_a_deposed_dispatcher_alike():
    out = {}
    for label, mods in (("port", PORT), ("jax", JAX)):
        clock = Clock()
        reg = mods.registry.TelemetryRegistry(clock=clock)
        capacity(mods, reg)
        eng = mods.engine.SchedulerEngine(clock=clock)
        mods.aggregator.sync_engine_from_registry(eng, reg)
        disp = mods.dispatcher.Dispatcher(eng, reg, clock=clock)
        disp.attach_fencing(lambda: 1)
        reg.acquire_leader("scheduler", "usurper", 2, ttl_s=60.0)
        disp.submit("ns", "p0", shared())
        disp.step()
        out[label] = (disp.frozen, disp.frozen_reason, reg.pods(),
                      disp.status("ns/p0"), list(reg.fence_log))
    assert out["port"] == out["jax"]
    assert out["port"][0] is True and out["port"][2] == {}


# --- replication --------------------------------------------------------------

def registry_state(reg):
    return {"capacity": reg.capacity(), "pods": reg.pods(),
            "leases": {k: {f: v for f, v in lease.items()
                           if f not in ("age_s", "ts")}
                       for k, lease in reg.leases().items()}}


def test_a_follower_holds_the_leaders_state_alike(tmp_path):
    out = {}
    for label, mods in (("port", PORT), ("jax", JAX)):
        clock = Clock()
        j = str(tmp_path / f"{label}-leader.jsonl")
        leader = mods.registry.TelemetryRegistry(journal=j, clock=clock)
        follower = mods.registry.TelemetryRegistry(
            journal=str(tmp_path / f"{label}-f.jsonl"), clock=clock)
        repl = mods.ha.ReplicationFollower(follower, leader, clock=clock)
        capacity(mods, leader, hosts=2)
        leader.put_lease("tpu-host-0", 3)
        leader.put_pod("ns/p0", {"node": "tpu-host-0", "request": "0.5"})
        steps = [repl.step(), repl.in_sync(), repl.rebases]
        same = registry_state(follower) == registry_state(leader)
        leader.drop_pod("ns/p0")
        leader.put_pod("ns/p1", {"node": "tpu-host-1"})
        steps += [repl.step(), repl.cursor, repl.head]
        same2 = registry_state(follower) == registry_state(leader)
        leader.close()
        # a restarted leader starts a new stream: the follower rebases
        leader2 = mods.registry.TelemetryRegistry(journal=j, clock=clock)
        leader2.put_lease("tpu-host-0", 9)
        repl.source = leader2
        steps += [repl.step(), repl.rebases]
        same3 = registry_state(follower) == registry_state(leader2)
        with pytest.raises(mods.registry.NotLeaderError):
            follower.put_lease("n0", 1)
        repl.promote()
        follower.put_lease("n0", 1)
        out[label] = (steps, same, same2, same3, registry_state(follower),
                      {k: v for k, v in repl.status().items()
                       if k != "lag_s"})
        leader2.close()
        follower.close()
    assert out["port"] == out["jax"]
    assert out["port"][1:4] == (True, True, True)
    assert out["port"][0][2] == 0 and out["port"][0][-1] == 1


def test_a_follower_answers_writes_307_with_the_leader(tmp_path):
    """Over HTTP, a port follower of a port leader: reads carry the
    replica headers, a write answers 307 naming the leader, and a client
    given both endpoints follows it to the leader."""
    leader = registry.TelemetryRegistry()
    leader.serve()
    follower = registry.TelemetryRegistry(
        journal=str(tmp_path / "f.jsonl"))
    hint = f"127.0.0.1:{leader.port}"
    ha.ReplicationFollower(follower, registry.RegistryClient(
        "127.0.0.1", leader.port), leader_hint=hint).step()
    follower.serve()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{follower.port}/capacity") as r:
            assert r.headers["X-Kubeshare-Replica"] == "follower"
            assert r.headers["X-Kubeshare-Leader"] == hint
        req = urllib.request.Request(
            f"http://127.0.0.1:{follower.port}/lease/n0",
            data=json.dumps({"epoch": 1}).encode(), method="PUT")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req)
        assert ei.value.code == 307 and hint in ei.value.headers["Location"]
        client = registry.RegistryClient(
            [f"127.0.0.1:{follower.port}", hint])
        client.put_lease("n1", 4)
        assert leader.leases()["n1"]["epoch"] == 4
    finally:
        leader.close()
        follower.close()


def test_a_port_follower_tails_a_jax_leader_over_http(tmp_path):
    leader = jregistry.TelemetryRegistry()
    leader.serve()
    follower = registry.TelemetryRegistry()
    try:
        capacity(JAX, leader, hosts=2)
        leader.put_pod("ns/p", {"node": "tpu-host-1"})
        leader.put_lease("tpu-host-1", 2)
        repl = ha.ReplicationFollower(
            follower, registry.RegistryClient("127.0.0.1", leader.port))
        assert repl.step() and repl.in_sync()
        assert registry_state(follower) == registry_state(leader)
    finally:
        leader.close()
        follower.close()


# --- the port's standby over the sharded plane --------------------------------

def test_a_sharded_standby_takes_the_leaders_pods_over():
    """A sharded leader binds; a sharded standby keeps warm, drops a pod
    the leader withdrew, takes over with every bound pod on the shard of
    its node, and places a pod it held frozen. The JAX standby cannot
    sync the sharded plane (its fleet façade has no ``set_fleet``)."""
    clock = Clock()
    reg = registry.TelemetryRegistry(clock=clock)
    capacity(PORT, reg, hosts=4, mesh=(2,))
    fleet = {}
    for chip in discovery.FakeTopology(hosts=4, mesh=(2,)).chips():
        fleet.setdefault(chip.host, []).append(chip)
    lead = shard.build_sharded(fleet, 2, clock=clock, registry=reg)
    warm = shard.build_sharded(fleet, 2, clock=clock, registry=reg)
    pha = ha.WarmStandby(lead, reg, "a", ttl_s=5.0, clock=clock)
    sha = ha.WarmStandby(warm, reg, "b", ttl_s=5.0, clock=clock,
                         resync_period_s=1.0)
    assert pha.step() and not sha.step()
    keys = [lead.submit("ns", f"w{i}", shared("1", "1")) for i in range(5)]
    lead.step()
    assert set(reg.pods()) == set(keys)
    clock.t += 1.5
    assert pha.step() and not sha.step()
    assert set(warm.engine.pod_status) == set(keys)
    lead.delete(keys[0])
    warm.submit("ns", "late", shared("1", "1"))
    clock.t += 1.5
    assert not sha.step()
    assert keys[0] not in warm.engine.pod_status
    warm.step()
    assert warm.status("ns/late")["status"] == "pending"
    clock.t += 6.0
    assert sha.step() and sha.lead.epoch == 2 and not warm.frozen
    for key in keys[1:]:
        node = reg.pods()[key]["node"]
        assert warm.status(key) == {**warm.status(key), "status": "bound",
                                    "node": node}
        assert key in warm.shards[warm.plan.shard_of(node)].engine.pod_status
    warm.step()
    assert warm.status("ns/late")["status"] == "bound"
    inv = warm.invariant_snapshot()
    assert inv["ok"] and inv["bound"] == 5
    assert not pha.step() and lead.frozen


# --- the service --------------------------------------------------------------

def test_a_frozen_standby_service_answers_as_jax_does():
    """Two services per package on one registry: the first leads, the
    second answers ``POST /schedule`` 202 pending while frozen, and
    ``/ha`` and ``/metrics`` say so, alike."""
    out = {}
    for label, (svc_cls, mods) in (("port", (SchedulerService, PORT)),
                                   ("jax", (JaxService, JAX))):
        reg = mods.registry.TelemetryRegistry()
        capacity(mods, reg)
        svcs = []
        for holder in ("a", "b"):
            svc = svc_cls(mods.engine.SchedulerEngine(), reg,
                          retry_backoff_s=3600.0)
            svc.attach_standby(holder, ttl_s=60.0)
            svcs.append(svc)
        try:
            got = [svcs[0].standby.step(), svcs[1].standby.step()]
            for svc in svcs:
                svc.serve()
            for svc, name in zip(svcs, ("p", "q")):
                code, body = svc.schedule("ns", name, shared())
                got.append((code, body["status"]))
            for svc in svcs:
                st = svc.ha_state()
                got.append({k: st[k] for k in ("attached", "role", "epoch",
                                               "frozen", "holder")})
                text = svc.render_metrics()
                got.append([line for line in text.splitlines()
                            if line.startswith(("kubeshare_ha_leader ",
                                                "kubeshare_ha_epoch "))])
            got.append(sorted(reg.pods()))
        finally:
            for svc in svcs:
                svc.close()
        out[label] = got
    assert out["port"] == out["jax"]
    assert out["port"][2] == (200, "bound")
    assert out["port"][3] == (202, "pending")


def test_the_service_cli_runs_sharded_in_an_election():
    reg = registry.TelemetryRegistry()
    reg.serve(port=0)
    capacity(PORT, reg, hosts=4, mesh=(2,))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = []
    try:
        for holder in ("svc-a", "svc-b"):
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "kubeshare_tpu_torch.scheduler.service", "--registry-port",
                 str(reg.port), "--host", "127.0.0.1", "--port", "0",
                 "--no-remote-write", "--shards", "2", "--ha-ttl", "2",
                 "--ha-holder", holder], cwd=str(REPO), env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            line = procs[-1].stdout.readline()
            assert line.startswith("READY "), procs[-1].stderr.read()
            procs[-1].url = f"http://127.0.0.1:{line.split()[1]}"
        a, b = (ServiceClient(p.url) for p in procs)

        def role(c):
            return c._call("GET", "/ha")[1]

        deadline = time.monotonic() + 30
        while ((role(a)["role"] != "leader" or role(a)["frozen"])
               and time.monotonic() < deadline):
            time.sleep(0.1)
        assert role(a)["epoch"] == 1 and role(b)["role"] == "standby"
        assert a.schedule("ns", "w", shared("1", "1"))[0] == 200
        procs[0].kill()
        procs[0].wait()
        t0 = time.monotonic()
        while role(b)["role"] != "leader" or role(b)["frozen"]:
            assert time.monotonic() - t0 < 30
            time.sleep(0.1)
        assert role(b)["epoch"] == 2 and role(b)["frozen"] is False
        assert b.status("ns", "w")[1]["status"] == "bound"
        assert b.invariants()["ok"]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
                try:
                    proc.wait(timeout=20)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        reg.close()


# --- the registry CLI ---------------------------------------------------------

def test_the_registry_cli_follows_and_sighup_promotes(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))

    def start(label, *args):
        log = tmp_path / f"{label}.log"
        proc = subprocess.Popen(
            [sys.executable, "-m", "kubeshare_tpu_torch.telemetry.registry",
             "--host", "127.0.0.1", "--port", "0", *args], cwd=str(REPO),
            env=env, stdout=subprocess.PIPE, stderr=open(log, "w"),
            text=True)
        proc.log = log
        line = proc.stdout.readline()
        assert line.startswith("READY "), log.read_text()
        return proc, int(line.split()[1])

    def wait_for(cond, what, procs):
        deadline = time.monotonic() + 30
        while not cond():
            assert time.monotonic() < deadline, (what, [
                p.log.read_text()[-2000:] for p in procs])
            time.sleep(0.05)

    lead, lead_port = start("leader")
    follow, follow_port = start("follower", "--follower-of",
                                f"127.0.0.1:{lead_port}",
                                "--replication-poll", "0.1")
    try:
        rc = registry.RegistryClient("127.0.0.1", lead_port)
        capacity(PORT, rc, hosts=2)
        rc.put_pod("ns/p", {"node": "tpu-host-0"})
        fc = registry.RegistryClient("127.0.0.1", follow_port)
        wait_for(lambda: fc.pods() == rc.pods()
                 and fc.capacity() == rc.capacity(), "the follower's copy",
                 (lead, follow))
        assert fc.replication()["role"] == "follower"
        lead.send_signal(signal.SIGTERM)
        assert lead.wait(timeout=20) == 0, lead.log.read_text()
        follow.send_signal(signal.SIGHUP)

        def promoted():
            try:
                fc.put_lease("n0", 1)
            except Exception:
                return False
            return True

        wait_for(promoted, "a write to the promoted follower", (follow,))
        assert fc.replication()["role"] == "leader"
        assert fc.leases()["leases"]["n0"]["epoch"] == 1
        assert fc.pods()["ns/p"]["node"] == "tpu-host-0"
        follow.send_signal(signal.SIGTERM)
        assert follow.wait(timeout=20) == 0, follow.log.read_text()
    finally:
        for proc in (lead, follow):
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def test_a_takeover_parks_a_gang_its_leader_held_at_the_barrier():
    """The leader reserved and published one member of a pair whose
    sibling cannot fit, and died with it parked. The JAX standby books
    the member as bound, a torn gang; the port's parks it at the barrier
    and, past the deadline, rejects it and withdraws its record."""
    out = {}
    for label, mods in (("port", PORT), ("jax", JAX)):
        clock = Clock()
        reg = mods.registry.TelemetryRegistry(clock=clock)
        capacity(mods, reg, mesh=(2,))
        primary, standby_, pha, sha, recs = two_dispatchers(mods, clock,
                                                            reg)
        assert pha.step() and not sha.step()
        primary.submit("ns", "fill", shared("1", "1"))
        primary.step()
        pair = {C.POD_GROUP_NAME: "g", C.POD_GROUP_HEADCOUNT: "2",
                C.POD_GROUP_THRESHOLD: "1.0", C.POD_PRIORITY: "10"}
        for i in range(2):
            primary.submit("ns", f"g-{i}", shared("1", "1", **pair))
        primary.step()
        assert sorted(primary._parked) == ["ns/g-0"]
        assert "ns/g-0" in reg.pods()          # published at the barrier
        clock.t += 6.0                          # the leader is silent
        assert sha.step()
        st = standby_.status("ns/g-0")["status"]
        inv = standby_.invariant_snapshot()
        clock.t += 10.0                         # past the permit deadline
        standby_.step()
        out[label] = (st, inv["ok"], standby_.status("ns/g-0")["status"],
                      sorted(reg.pods()))
    assert out["port"] == ("parked", True, "rejected", ["ns/fill"])
    assert out["jax"][0] == "bound" and out["jax"][1] is False


def test_a_standby_keeps_a_replayed_pods_model():
    """A pod the leader bound on a model it pinned stays on that model
    when the new leader requeues it off a lost node, after a warm
    standby's replay and a plain restart's alike (the JAX replay drops
    the pin and moves it to another generation)."""
    clock = Clock()
    got = {}
    for label, reg_mod, eng_mod, disp_mod, agg_mod, disc_mod in (
            ("port", registry, engine, dispatcher, aggregator, discovery),
            ("jax", jregistry, jengine, jdispatcher, jaggregator,
             jdiscovery)):
        reg = reg_mod.TelemetryRegistry(clock=clock)
        for model, host in (("TPU-v4", "v4-host"), ("TPU-v5e", "v5e-host")):
            chips = disc_mod.FakeTopology(hosts=1, mesh=(2,),
                                          model=model).chips()
            reg.put_capacity(host, [dict(c.to_labels(), node=host,
                                         chip_id=f"{model}-{host}-{c.index}")
                                    for c in chips])
        eng = eng_mod.SchedulerEngine(clock=clock)
        agg_mod.sync_engine_from_registry(eng, reg)
        lead = disp_mod.Dispatcher(eng, reg, clock=clock)
        lead.submit("ns", "p",
                    shared("1", "1", **{C.POD_TPU_MODEL: "TPU-v4"}))
        lead.step()
        node = lead.status("ns/p")["node"]
        assert node == "v4-host"
        records = reg.pods()
        replays = ((("standby", True), ("restart", False))
                   if label == "port" else (("restart", None),))
        for how, standby_ in replays:
            warm = disp_mod.Dispatcher(eng_mod.SchedulerEngine(clock=clock),
                                       reg, clock=clock)
            agg_mod.sync_engine_from_registry(warm.engine, reg)
            replayed = (warm.replay_bound() if standby_ is None else
                        warm.replay_bound(records, standby=standby_))
            assert replayed == ["ns/p"]
            warm.engine.veto_health(node, True)   # the health watch's hold
            warm.evict_node(node)
            warm.step()
            got[label, how] = warm.status("ns/p")
    assert got["port", "standby"]["status"] == "pending"
    assert got["port", "restart"]["status"] == "pending"
    assert got["jax", "restart"]["node"] == "v5e-host"   # the reference


def test_a_cli_takes_a_signal_caught_by_another_thread():
    """A signal sent to the process may be taken by any of its threads
    (the registry follower's pull thread, a server's), whose C-level
    handler only flags it for the main thread: ``ready_until_signal``
    must still run the handlers, SIGHUP's and SIGTERM's."""
    script = (
        "import signal, sys, threading, time\n"
        "from kubeshare_tpu_torch.utils import ready_until_signal\n"
        "signal.signal(signal.SIGHUP, lambda *a: print('HUP', flush=True))\n"
        "def other():\n"
        "    time.sleep(0.5)\n"
        "    signal.pthread_kill(threading.get_ident(), signal.SIGHUP)\n"
        "    time.sleep(0.5)\n"
        "    signal.pthread_kill(threading.get_ident(), signal.SIGTERM)\n"
        "    time.sleep(60)\n"
        "threading.Thread(target=other, daemon=True).start()\n"
        "ready_until_signal('READY')\n"
        "print('STOPPED', flush=True)\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(REPO),
                          env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=30)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["READY", "HUP", "STOPPED"]
