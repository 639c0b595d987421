"""The port's scheduler service against the JAX package's: the same HTTP
requests give the same codes and bodies, each service over its own
package's registry, in process. Then the service CLI: it serves, pushes
its metrics to the registry, stops on SIGTERM right after ``READY`` with
rc 0, runs sharded and in a leader election, and attaches the
rightsizer with each of its flags.

Mirrors ``tests/test_sim_service.py``'s service cases and the service
parts of ``test_healthwatch.py``, ``test_decisions.py`` and
``test_gang.py``. Trace ids and the parked deadline's seconds (a wall
clock reading) stay out of the comparison.
"""

import inspect
import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from kubeshare_tpu.obs import decisions as jdec
from kubeshare_tpu.obs import flight as jflight
from kubeshare_tpu.scheduler import SchedulerEngine as JaxEngine
from kubeshare_tpu.scheduler.service import SchedulerService as JaxService
from kubeshare_tpu.telemetry import TelemetryRegistry as JaxRegistry
from kubeshare_tpu.topology.discovery import FakeTopology as JaxFake
from kubeshare_tpu_torch import constants as C
from kubeshare_tpu_torch.obs import decisions as dec
from kubeshare_tpu_torch.preempt import PreemptionPolicy
from kubeshare_tpu_torch.scheduler import SchedulerEngine
from kubeshare_tpu_torch.scheduler.bridge import ServiceClient
from kubeshare_tpu_torch.scheduler.service import SchedulerService
from kubeshare_tpu_torch.scheduler.service import main as service_main
from kubeshare_tpu_torch.telemetry import TelemetryRegistry
from kubeshare_tpu_torch.topology.discovery import FakeTopology

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def quiet_and_fresh(monkeypatch):
    """Fresh process-global decision recorders on both sides, and a test
    fails if the JAX default flight recorder dumped."""
    dec.reset_for_tests()
    jdec.reset_for_tests()
    rec = jflight.default_recorder()
    fired = []
    real = rec.trigger
    monkeypatch.setattr(rec, "trigger",
                        lambda reason, **kw: fired.append(reason)
                        or real(reason, **kw))
    yield
    dec.reset_for_tests()
    jdec.reset_for_tests()
    assert fired == []


def serve(engine_cls, registry_cls, fake_cls, service_cls, hosts=1,
          mesh=(2, 2), **kw):
    reg = registry_cls()
    by_host = {}
    for chip in fake_cls(hosts=hosts, mesh=mesh).chips():
        by_host.setdefault(chip.host, []).append(chip.to_labels())
    for host, labels in by_host.items():
        reg.put_capacity(host, labels)
    # a long backoff: only the requests below move the queue, not the
    # loop thread's retries on the wall clock
    svc = service_cls(engine_cls(), reg, retry_backoff_s=3600.0, **kw)
    svc.serve()
    return svc


def both_services(**kw):
    return (serve(SchedulerEngine, TelemetryRegistry, FakeTopology,
                  SchedulerService, **kw),
            serve(JaxEngine, JaxRegistry, JaxFake, JaxService, **kw))


def call(svc, method, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{svc.port}{path}",
                                 method=method, data=data)
    if data is not None:
        req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            raw = r.read()
            code = r.status
    except urllib.error.HTTPError as e:
        raw, code = e.read(), e.code
    try:
        return code, json.loads(raw)
    except ValueError:
        return code, raw.decode()


def scrub(obj):
    if isinstance(obj, dict):
        return {k: scrub(v) for k, v in obj.items()
                if k not in ("trace_id", "deadline_s", "lease_age_s",
                             "since_s")}
    if isinstance(obj, (list, tuple)):
        return [scrub(v) for v in obj]
    return obj


def same(pair, method, path, body=None):
    mine = call(pair[0], method, path, body)
    theirs = call(pair[1], method, path, body)
    assert scrub(mine) == scrub(theirs), (method, path)
    return mine


def shared(request="0.5", limit="1.0", **extra):
    labels = {C.POD_TPU_REQUEST: request, C.POD_TPU_LIMIT: limit}
    labels.update(extra)
    return labels


def pod(name, labels, ns="ns", uid=""):
    return {"namespace": ns, "name": name, "labels": labels, "uid": uid}


@pytest.fixture
def pair():
    p = both_services()
    yield p
    for svc in p:
        svc.close()


def test_schedule_statuses_and_deletes_answer_alike(pair):
    code, body = same(pair, "POST", "/schedule", pod("a", shared()))
    assert code == 200 and body["status"] == "bound"
    assert body["annotations"][C.POD_CELL_ID]
    assert same(pair, "POST", "/schedule",
                pod("b", shared("1", "1")))[0] == 200
    code, body = same(pair, "POST", "/schedule", pod("big", shared("4", "4")))
    assert code == 202 and body["status"] == "pending" and body["reason"]
    code, body = same(pair, "POST", "/schedule",
                      pod("bad", {C.POD_TPU_REQUEST: "2",
                                  C.POD_TPU_LIMIT: "1"}))
    assert code == 409
    assert same(pair, "GET", "/pods/ns/a")[1]["status"] == "bound"
    assert same(pair, "GET", "/pods/ns/none")[1] == {"status": "unknown"}
    assert same(pair, "DELETE", "/pods/ns/a") == (200, {"ok": True})
    assert same(pair, "GET", "/pods/ns/a")[1]["status"] == "deleted"
    state = same(pair, "GET", "/state")[1]
    assert set(state["pods"]) == {"ns/b", "ns/big"}
    for svc in pair:
        assert set(svc.registry.pods()) == {"ns/b"}


def test_a_gang_waits_for_its_sibling_then_parks_alike(pair):
    g = {C.POD_GROUP_NAME: "g", C.POD_GROUP_HEADCOUNT: "2",
         C.POD_GROUP_THRESHOLD: "1.0", C.POD_PRIORITY: "10"}
    code, body = same(pair, "POST", "/schedule", pod("g-0", shared(**g)))
    assert code == 202 and body["status"] == "pending"   # 1 of 2 known
    code, body = same(pair, "POST", "/schedule", pod("g-1", shared(**g)))
    assert code == 202 and body["status"] == "parked"    # at the barrier
    # the coordinator learns a gang once it is bound, not while parked
    assert same(pair, "GET", "/gangs")[1]["count"] == 0
    inv = same(pair, "GET", "/invariants")[1]
    assert inv["ok"] and inv["parked"] == 1 and inv["pending"] == 1


def test_the_service_serves_its_decision_trace():
    """The port's own ``GET /decisions/trace``: the recorder's ring as a
    decision trace that ``replay_trace`` re-drives (the JAX service serves
    only the ``/decisions`` summary). A sharded service books its fleet
    before it attaches the recorder, so its trace opens with the whole
    fleet; the single-lock one syncs after, in both packages, and its
    fleet entry is empty."""
    from kubeshare_tpu_torch.replay import decision_diff, replay_trace

    svc = serve(SchedulerEngine, TelemetryRegistry, FakeTopology,
                SchedulerService, hosts=2, shards=2, shard_route="cell")
    try:
        for name, req in (("a", "0.5"), ("b", "0.5"), ("c", "1")):
            labels = shared(req, "1" if req == "1" else "1.0")
            assert call(svc, "POST", "/schedule", pod(name, labels))[0] \
                == 200
        assert call(svc, "DELETE", "/pods/ns/b")[0] == 200
        with urllib.request.urlopen(
                f"http://127.0.0.1:{svc.port}/decisions/trace",
                timeout=10) as r:
            assert r.headers["Content-Type"] == "application/x-ndjson"
            text = r.read().decode()
        assert text == dec.trace_jsonl(svc.decisions)
    finally:
        svc.close()
    parsed = dec.parse_trace_jsonl(text)
    entries = parsed["entries"]
    assert parsed["header"]["dropped"] == 0
    assert entries[0]["kind"] == "fleet" and len(entries[0]["nodes"]) == 2
    kinds = [e["kind"] for e in entries]
    assert kinds.count("submit") == 3 and kinds.count("delete") == 1
    # the service's clock is the host's: replay from the fleet's instant
    t0 = entries[0]["t"]
    for e in entries:
        e["t"] = round(e["t"] - t0, 6)
    # a tick well under the requests' spacing, as the service steps at
    # each request
    rep = replay_trace({"header": parsed["header"], "entries": entries},
                       tick_s=0.0002,
                       config={"shards": 2, "shard_route": "cell"})
    diff = decision_diff(entries, rep.entries(), shard_equivalence=True)
    assert diff["pods"] == {"recorded": 3, "replayed": 3}
    assert diff["identical"], diff


def test_resync_and_replay_answer_alike(pair):
    code, body = same(pair, "POST", "/schedule", pod("a", shared()))
    resync = {"namespace": "ns", "name": "r", "labels": shared(),
              "annotations": body["annotations"], "node": body["node"]}
    assert same(pair, "POST", "/resync", resync) == (200, {"ok": True})
    assert same(pair, "GET", "/pods/ns/r")[1]["status"] == "bound"
    same(pair, "GET", "/state")


def test_detached_planes_and_unknown_paths_answer_alike(pair):
    for path in ("/autopilot", "/rightsize", "/elastic", "/ha", "/preempt",
                 "/serving", "/healthz", "/evictions", "/health", "/slo",
                 "/ledger", "/nope"):
        same(pair, "GET", path)
    for path in ("/autopilot/plan", "/autopilot/apply", "/rightsize/plan",
                 "/rightsize/apply"):
        assert same(pair, "POST", path, {})[0] == 409
    assert same(pair, "POST", "/elastic/resize",
                {"gang": "g", "target_chips": 2})[0] == 409
    assert same(pair, "POST", "/nope", {})[0] == 404
    assert same(pair, "DELETE", "/nope")[0] == 404
    for svc in pair:
        assert call(svc, "GET", "/flightrecorder")[0] == 200
        assert call(svc, "GET", "/prof")[0] == 200


def test_the_decision_stream_counts_alike(pair):
    same(pair, "POST", "/schedule", pod("a", shared()))
    same(pair, "POST", "/schedule", pod("big", shared("4", "4")))
    same(pair, "DELETE", "/pods/ns/a")
    mine, theirs = (call(svc, "GET", "/decisions")[1] for svc in pair)
    assert mine["kinds"] == theirs["kinds"]
    assert {"fleet", "submit", "outcome", "delete"} <= set(mine["kinds"])

    def entries(body):      # "t" is the wall clock of each service
        return [{k: v for k, v in scrub(e).items() if k != "t"}
                for e in body["recent"] if e["kind"] != "rng"]

    assert entries(mine) == entries(theirs)


def test_the_scheduler_gauges_render_alike(pair):
    same(pair, "POST", "/schedule", pod("a", shared()))
    same(pair, "POST", "/schedule", pod("big", shared("4", "4")))
    bodies = []
    for svc in pair:
        text = call(svc, "GET", "/metrics")[1]
        bodies.append([line for line in text.splitlines()
                       if "kubeshare_scheduler_" in line])
    assert bodies[0] == bodies[1] and len(bodies[0]) == 15


def test_overload_answers_429_alike():
    pair = both_services(mesh=(1,), max_pending=2)
    try:
        assert same(pair, "POST", "/schedule",
                    pod("hog", shared("1", "1")))[0] == 200
        codes = [same(pair, "POST", "/schedule",
                      pod(f"p{i}", shared("1", "1")))[0] for i in range(4)]
        assert codes == [202, 202, 429, 429]
        body = same(pair, "GET", "/pods/ns/p3")[1]
        assert body["status"] == "overloaded"
        health = same(pair, "GET", "/health")[1]
        assert health["shed_total"] == 2 and health["max_pending"] == 2
    finally:
        for svc in pair:
            svc.close()


def test_a_preempt_policy_records_into_the_services_decisions():
    svc = serve(SchedulerEngine, TelemetryRegistry, FakeTopology,
                SchedulerService)
    try:
        pol = PreemptionPolicy()
        svc.attach_preempt(pol)
        assert pol.decisions is svc.decisions
        assert svc.gangcoord.preempt is pol
        pol.note_preemption("c", "ns/h", "latency", "best-effort")
        assert call(svc, "GET", "/decisions")[1]["kinds"][
            "token-preempt"] == 1
        assert call(svc, "GET", "/preempt")[1]["attached"] is True
    finally:
        svc.close()


def test_sharded_construction_serves_as_the_jax_sharded_service():
    """``shards=2`` over two hosts: each shard owns one host, and the
    same requests give the same answers as the JAX sharded service."""
    sharded = both_services(hosts=2, shards=2, shard_route="score")
    try:
        for svc in sharded:
            assert len(svc.dispatcher.shards) == 2
        state = same(sharded, "GET", "/state")[1]
        assert state["nodes"] == ["tpu-host-0", "tpu-host-1"]
        assert len(state["leaves"]) == 8
        for i in range(5):
            assert same(sharded, "POST", "/schedule",
                        pod(f"w{i}", shared("1", "1")))[0] == 200
        assert same(sharded, "GET", "/invariants")[1]["ok"]
        same(sharded, "GET", "/state")
        same(sharded, "GET", "/ha")
    finally:
        for svc in sharded:
            svc.close()


def test_the_service_client_speaks_to_the_service(pair):
    client = ServiceClient(f"http://127.0.0.1:{pair[0].port}")
    code, body = client.schedule("ns", "a", shared())
    assert code == 200 and body["node"] == "tpu-host-0"
    assert client.status("ns", "a")[1]["status"] == "bound"
    assert client.invariants()["ok"]
    assert client.autopilot() == {"attached": False, "enabled": False}
    assert client.evictions() == []
    assert client.delete("ns", "a") == (200, {"ok": True})


# --- the CLI ----------------------------------------------------------------

def _spawn(args):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.Popen(
        [sys.executable, "-m", "kubeshare_tpu_torch.scheduler.service",
         *args], cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def test_the_service_cli_stops_on_sigterm_right_after_ready():
    """Signalled the moment it prints READY, the CLI exits 0 (the JAX CLI
    prints READY before it installs its handlers)."""
    reg = TelemetryRegistry()
    reg.serve(port=0)
    try:
        for _ in range(2):
            proc = _spawn(["--registry-port", str(reg.port), "--port", "0",
                           "--host", "127.0.0.1", "--health"])
            line = proc.stdout.readline()
            proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(timeout=20)
            finally:
                if proc.poll() is None:
                    proc.kill()
                err = proc.stderr.read()
            assert line.startswith("READY "), err
            assert int(line.split()[1]) > 0
            assert rc == 0, err
    finally:
        reg.close()


def test_the_service_cli_serves_and_pushes_its_metrics():
    reg = TelemetryRegistry()
    reg.serve(port=0)
    for chip in FakeTopology(hosts=1, mesh=(2,)).chips():
        reg.put_capacity(chip.host, [c.to_labels() for c in FakeTopology(
            hosts=1, mesh=(2,)).chips()])
        break
    proc = _spawn(["--registry-port", str(reg.port), "--port", "0",
                   "--host", "127.0.0.1", "--push-period", "0.2",
                   "--preempt"])
    try:
        line = proc.stdout.readline()
        assert line.startswith("READY "), proc.stderr.read()
        client = ServiceClient(f"http://127.0.0.1:{line.split()[1]}")
        code, body = client.schedule("ns", "a", shared())
        assert code == 200 and reg.pods()["ns/a"]["node"] == "tpu-host-0"
        assert client._call("GET", "/preempt")[1]["attached"] is True
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if reg.tsdb.series_count() > 0:
                break
            time.sleep(0.1)
        assert reg.tsdb.series_count() > 0
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=20)
        reg.close()
    assert rc == 0


@pytest.mark.parametrize("flags", [
    ["--shards", "2"], ["--shards", "4", "--shard-route", "cell"],
    ["--ha-holder", "a"], ["--ha-holder", "a", "--ha-ttl", "5"],
    ["--ha-holder", "a", "--ha-resync-period", "2"]],
    ids=lambda f: "-".join(f[::2]))
def test_the_shard_and_ha_flags_start_a_service_answering_ha_and_state(
        flags):
    reg = TelemetryRegistry()
    reg.serve(port=0)
    by_host = {}
    for chip in FakeTopology(hosts=4, mesh=(2,)).chips():
        by_host.setdefault(chip.host, []).append(chip.to_labels())
    for host, labels in by_host.items():
        reg.put_capacity(host, labels)
    proc = _spawn(["--registry-port", str(reg.port), "--port", "0",
                   "--host", "127.0.0.1", "--no-remote-write", *flags])
    try:
        line = proc.stdout.readline()
        assert line.startswith("READY "), proc.stderr.read()
        client = ServiceClient(f"http://127.0.0.1:{line.split()[1]}")
        code, state = client.state()
        assert code == 200 and len(state["leaves"]) == 8
        ha = client._call("GET", "/ha")[1]
        if "--ha-holder" in flags:
            assert ha["attached"] is True and ha["holder"] == "a"
            deadline = time.monotonic() + 30
            while ((ha["role"] != "leader" or ha["frozen"])
                   and time.monotonic() < deadline):
                time.sleep(0.1)
                ha = client._call("GET", "/ha")[1]
            assert ha["role"] == "leader" and ha["epoch"] == 1
            assert ha["frozen"] is False
        else:
            assert ha == {"attached": False, "frozen": False}
        assert client.schedule("ns", "a", shared("1", "1"))[0] == 200
        assert client.invariants()["ok"]
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=20)
        reg.close()
    assert rc == 0


@pytest.mark.parametrize("flag", [
    ["--rightsize"], ["--rightsize-journal", "r.jsonl"], ["--elastic-grow"]],
    ids=lambda f: f[0])
def test_the_service_cli_attaches_the_rightsizer_with_each_flag(
        flag, tmp_path):
    """Each of the rightsizer's three flags starts the service, beside
    ``--rightsize`` (the other two act only through it): ``GET
    /rightsize`` answers attached, ``POST /rightsize/plan`` 200 and
    ``POST /rightsize/apply`` runs a cycle, as the JAX service does
    once a rightsizer is attached."""
    if flag[0] == "--rightsize-journal":
        flag = [flag[0], str(tmp_path / flag[1])]
    extra = ["--elastic"] if flag[0] == "--elastic-grow" else []
    args = sorted({"--rightsize", *flag[:1]}) + flag[1:] + extra
    reg = TelemetryRegistry()
    reg.serve(port=0)
    proc = _spawn(["--registry-port", str(reg.port), "--port", "0",
                   "--host", "127.0.0.1", "--no-remote-write", *args])
    try:
        line = proc.stdout.readline()
        assert line.startswith("READY "), proc.stderr.read()
        client = ServiceClient(f"http://127.0.0.1:{line.split()[1]}")
        code, state = client._call("GET", "/rightsize")
        assert code == 200 and state["attached"] and state["enabled"]
        assert state["cycles"] == 0
        assert state["config"]["elastic_grow"] is (
            flag[0] == "--elastic-grow")
        code, out = client._call("POST", "/rightsize/plan", {})
        assert code == 200 and out["plan"]["resizes"] == []
        assert ("elastic" in out["plan"]) is (flag[0] == "--elastic-grow")
        code, out = client._call("POST", "/rightsize/apply", {})
        assert code == 200 and out["applied"] == []
        assert client._call("GET", "/rightsize")[1]["cycles"] == 1
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=20)
        reg.close()
    assert rc == 0


def test_every_unported_plane_flag_of_the_reference_cli_is_refused():
    """Each flag of the JAX CLI is served by the port: the set of flags
    the port refuses is now empty, and none is accepted and ignored."""
    import kubeshare_tpu.scheduler.service as jservice
    flags = set(re.findall(r'add_argument\("(--[a-z-]+)"',
                           inspect.getsource(jservice.main)))
    ported = set(re.findall(r'add_argument\("(--[a-z-]+)"',
                            inspect.getsource(service_main)))
    assert flags <= ported
    assert {"--rightsize", "--rightsize-journal", "--elastic-grow"} <= flags
