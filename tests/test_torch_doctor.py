"""The port's doctor and topcli against the JAX package's, and the node's
remote write.

The doctor runs with ``--skip-chip`` against a live registry and
scheduler of each package, built by the same calls: the same checks
answer with the same status and exit code (exact), and dead endpoints
fail the same 16 checks. Its chip check probes the card with torch and
fails here, with no card, rather than skip or report the CPU. topcli
renders each view the JAX topcli renders over the same fleet and pods,
and ``--replay-diff`` renders a trace pair or a saved diff report as the
JAX one does, with its exit codes. The launcher's and
the proxy's CLIs remote-write to a live port registry and mark their
instances stale on a clean stop.

Mirrors ``tests/test_doctor.py`` and ``tests/test_topcli.py``.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest

from kubeshare_tpu import doctor as jdoctor
from kubeshare_tpu import topcli as jtopcli
from kubeshare_tpu.ha import standby as jstandby
from kubeshare_tpu.obs import decisions as jdecisions
from kubeshare_tpu.obs import flight as jflight
from kubeshare_tpu.scheduler import SchedulerEngine as JaxEngine
from kubeshare_tpu.scheduler.service import SchedulerService as JaxService
from kubeshare_tpu.telemetry import TelemetryRegistry as JaxRegistry
from kubeshare_tpu.topology.discovery import FakeTopology as JaxFake
from kubeshare_tpu_torch import constants as C
from kubeshare_tpu_torch import doctor, topcli
from kubeshare_tpu_torch.ha import standby
from kubeshare_tpu_torch.obs import decisions, flight
from kubeshare_tpu_torch.scheduler import SchedulerEngine
from kubeshare_tpu_torch.scheduler.service import SchedulerService
from kubeshare_tpu_torch.telemetry import TelemetryRegistry
from kubeshare_tpu_torch.telemetry.registry import RegistryClient
from kubeshare_tpu_torch.topology.discovery import FakeTopology

REPO = Path(__file__).resolve().parent.parent

PORT = types.SimpleNamespace(engine=SchedulerEngine, service=SchedulerService,
                             registry=TelemetryRegistry, fake=FakeTopology,
                             doctor=doctor, topcli=topcli)
JAX = types.SimpleNamespace(engine=JaxEngine, service=JaxService,
                            registry=JaxRegistry, fake=JaxFake,
                            doctor=jdoctor, topcli=jtopcli)


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """Fresh process-global decision recorders on both sides, private
    flight recorders for the standbys, and a test fails if the JAX
    default flight recorder dumped."""
    decisions.reset_for_tests()
    jdecisions.reset_for_tests()
    for mod, flight_mod in ((standby, flight), (jstandby, jflight)):
        private = flight_mod.FlightRecorder()
        monkeypatch.setattr(mod, "default_recorder",
                            lambda rec=private: rec)
    rec = jflight.default_recorder()
    fired = []
    real = rec.trigger
    monkeypatch.setattr(rec, "trigger",
                        lambda reason, **kw: fired.append(reason)
                        or real(reason, **kw))
    yield
    decisions.reset_for_tests()
    jdecisions.reset_for_tests()
    assert fired == []


class Stack:
    """One package's registry and scheduler service over HTTP, with a
    two-node fleet, two bound pods and one over capacity."""

    def __init__(self, mods, ha_holder=""):
        self.reg = mods.registry()
        self.reg.serve()
        by_host = {}
        for chip in mods.fake(hosts=2, mesh=(2,)).chips():
            by_host.setdefault(chip.host, []).append(chip.to_labels())
        for host, labels in by_host.items():
            self.reg.put_capacity(host, labels)
        self.svc = mods.service(mods.engine(), self.reg,
                                retry_backoff_s=3600.0)
        if ha_holder:
            self.svc.attach_standby(ha_holder, ttl_s=60.0)
            self.svc.standby.step()
        self.svc.serve()
        for name, req in (("a", "0.5"), ("b", "1"), ("big", "4")):
            self.svc.schedule("ns", name, {C.POD_TPU_REQUEST: req,
                                           C.POD_TPU_LIMIT: req})
        self.registry = f"127.0.0.1:{self.reg.port}"
        self.scheduler = f"127.0.0.1:{self.svc.port}"

    def close(self):
        self.svc.close()
        self.reg.close()


def run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def statuses(out):
    return [tuple(line.split()[:2]) for line in out.splitlines() if line]


def scrub(text, stack):
    """Addresses and ages out; the rest of a line must match."""
    text = (text.replace(stack.registry, "REGISTRY")
            .replace(stack.scheduler, "SCHEDULER"))
    return re.sub(r"age \d+(\.\d+)?s", "age Ns", text)


@pytest.fixture
def stacks(tmp_path, monkeypatch):
    monkeypatch.setenv("KUBESHARE_TPU_FAKE_TOPOLOGY", "1:2x2")
    pair = (Stack(PORT, ha_holder="a"), Stack(JAX, ha_holder="a"))
    (tmp_path / "config").mkdir()
    (tmp_path / "config" / "chip-0").write_text("0\n")
    yield pair
    for stack in pair:
        stack.close()


# --- the doctor ---------------------------------------------------------------

def test_the_doctor_answers_a_live_stack_as_jax_does(stacks, tmp_path,
                                                     capsys):
    got = {}
    for label, mods, stack in (("port", PORT, stacks[0]),
                               ("jax", JAX, stacks[1])):
        got[label] = run(mods.doctor.main, [
            "--skip-chip", "--registry", stack.registry, "--scheduler",
            stack.scheduler, "--base-dir", str(tmp_path)], capsys)
    (rc, out, _), (jrc, jout, _) = got["port"], got["jax"]
    assert rc == jrc == 0, out
    assert statuses(out) == statuses(jout)
    lines = dict((line.split()[0], line) for line in out.splitlines())
    assert lines["ha"].split()[1] == "ok" and "leader at epoch 1" in lines[
        "ha"]
    assert "2 node(s)" in lines["scheduler"]
    for name in ("invariants", "gangs", "decisions", "autopilot",
                 "rightsize", "elastic", "serving"):
        assert scrub(lines[name], stacks[0]) == scrub(
            dict((x.split()[0], x) for x in jout.splitlines())[name],
            stacks[1]), name


def test_dead_endpoints_fail_the_same_checks(capsys, monkeypatch):
    monkeypatch.setenv("KUBESHARE_TPU_FAKE_TOPOLOGY", "1:2x2")
    argv = ["--skip-chip", "--registry", "127.0.0.1:1", "--scheduler",
            "127.0.0.1:1"]
    rc, out, _ = run(doctor.main, argv, capsys)
    jrc, jout, _ = run(jdoctor.main, argv, capsys)
    assert rc == jrc == 1
    assert statuses(out) == statuses(jout)
    assert out.count("fail") == 16


def test_the_chip_check_fails_with_no_card(capsys):
    """Here there is no CUDA card: the probe fails, naming that, and
    never reports the CPU as the chip."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: this checks its absence")
    assert doctor.check_chip(120.0) is False
    line = capsys.readouterr().out
    assert line.split()[:2] == ["chip", "fail"], line
    assert "no CUDA card" in line and "cpu" not in line.lower()


def test_live_discovery_fails_with_no_card(capsys, monkeypatch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: this checks its absence")
    monkeypatch.delenv("KUBESHARE_TPU_FAKE_TOPOLOGY", raising=False)
    assert doctor.check_discovery(True, 120.0) is False
    assert capsys.readouterr().out.split()[:2] == ["discovery", "fail"]
    assert doctor.check_discovery(False, 120.0) is True
    assert capsys.readouterr().out.split()[:2] == ["discovery", "skip"]


def test_the_doctor_cli_runs_against_a_port_stack(stacks):
    port = stacks[0]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "kubeshare_tpu_torch.doctor", "--skip-chip",
         "--registry", port.registry, "--scheduler", port.scheduler],
        capture_output=True, text=True, timeout=120, env=env,
        cwd=str(REPO))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert re.search(r"^ha\s+ok\s", proc.stdout, re.M), proc.stdout
    assert re.search(r"^chip\s+skip\s", proc.stdout, re.M)


# --- topcli -------------------------------------------------------------------

VIEWS = [[], ["--json"], ["--health"], ["--invariants"], ["--gangs"],
         ["--autopilot"], ["--rightsize"], ["--elastic"], ["--serving"],
         ["--locks"], ["--why", "ns"], ["--fleet"], ["--latency"],
         ["--health", "--json"], ["--invariants", "--json"]]
#: views whose text does not move with timing or process-global counters
SAME_TEXT = ([], ["--invariants"], ["--gangs"], ["--autopilot"],
             ["--rightsize"], ["--elastic"], ["--invariants", "--json"])


@pytest.mark.parametrize("view", VIEWS, ids=lambda v: "-".join(v) or "fleet")
def test_each_topcli_view_renders_as_jax_does(stacks, capsys, view):
    got = {}
    for label, mods, stack in (("port", PORT, stacks[0]),
                               ("jax", JAX, stacks[1])):
        got[label] = run(mods.topcli.main, [
            "--registry", stack.registry, "--scheduler", stack.scheduler,
            *view], capsys)
    (rc, out, err), (jrc, jout, _) = got["port"], got["jax"]
    assert rc == jrc == 0, err
    assert out.strip()
    if "--json" in view:
        json.loads(out)
    if view in SAME_TEXT:
        assert scrub(out, stacks[0]) == scrub(jout, stacks[1])
    else:
        assert len(out.splitlines()) > 0 and (
            out.splitlines()[0].split()[:1] == jout.splitlines()[0].split()[:1])


def test_topcli_replay_diff_on_a_trace_pair_and_a_saved_report(
        tmp_path, capsys):
    """Traces the port recorded and replayed with a nudged scorer: the
    pair diffs with exit 1 and a trace against itself with exit 0; a
    saved ``decision_diff`` report renders without ``--against``, exit 1
    when it holds a diff and 0 when it does not. The JAX topcli prints
    the same on the same files."""
    from kubeshare_tpu_torch.replay import (decision_diff, record_trace,
                                            replay_trace)
    from kubeshare_tpu_torch.sim.simulator import churn_events

    class Nudged(SchedulerEngine):
        def score(self, pod, node):
            s = super().score(pod, node)
            return s + 50.0 if node.endswith("-0") else s

    by_host: dict = {}
    for c in FakeTopology(hosts=4, mesh=(2, 2)).chips():
        by_host.setdefault(c.host, []).append(c.to_labels())
    rec = record_trace(churn_events(30, seed=3), by_host, seed=11,
                       tick_s=0.25)
    rep = replay_trace(decisions.trace_jsonl(rec), tick_s=0.25,
                       engine_factory=lambda clk: Nudged(clock=clk))
    files = {}
    for name, text in (
            ("rec", decisions.trace_jsonl(rec)),
            ("rep", decisions.trace_jsonl(rep)),
            ("diff", json.dumps(decision_diff(rec.entries(),
                                              rep.entries()))),
            ("same", json.dumps(decision_diff(rec.entries(),
                                              rec.entries())))):
        files[name] = tmp_path / name
        files[name].write_text(text)
    for argv, want in (
            ([files["rec"], "--against", files["rep"]], 1),
            ([files["rec"], "--against", files["rec"]], 0),
            ([files["diff"]], 1), ([files["diff"], "--json"], 1),
            ([files["same"]], 0)):
        argv = ["--replay-diff", *map(str, argv)]
        rc, out, err = run(topcli.main, argv, capsys)
        assert (rc, out, err) == run(jtopcli.main, argv, capsys), argv
        assert rc == want, argv
        if "--json" in argv:
            doc = json.loads(out)
            assert doc["moved"] and not doc["identical"]
        elif want:
            assert "decision replay diff" in out and " -> " in out
        else:
            assert "bit-identical" in out


def test_topcli_exits_2_on_an_unreachable_registry(capsys):
    rc, _, err = run(topcli.main, ["--registry", "127.0.0.1:1"], capsys)
    assert rc == 2 and "unreachable" in err


def test_topcli_critpath_over_port_spans(tmp_path, capsys):
    from kubeshare_tpu_torch.obs.trace import Tracer

    tr = Tracer()
    tid = "t" * 16
    root = tr.begin("submit", tid, pod="ns/a")
    tr.record("queue-wait", tid, root.start_ms, root.start_ms + 5,
              parent_id=root.span_id)
    tr.finish(root)
    path = tmp_path / "spans.jsonl"
    assert tr.export_jsonl(str(path), trace_id=tid) == 2
    rc, out, err = run(topcli.main, ["--critpath", "--spans", str(path)],
                       capsys)
    jrc, jout, _ = run(jtopcli.main, ["--critpath", "--spans", str(path)],
                       capsys)
    assert rc == jrc and out == jout, err


# --- remote write from the node -----------------------------------------------

def _spawn(args, extra_env=None):
    env = dict(os.environ, PYTHONPATH=str(REPO), **(extra_env or {}))
    return subprocess.Popen([sys.executable, "-m", *args], cwd=str(REPO),
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _instances(rc):
    return {i["instance"]: i for i in rc.instances()["instances"]}


def _wait(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while True:
        got = cond()
        if got:
            return got
        assert time.monotonic() < deadline
        time.sleep(0.1)


def test_the_launcher_and_proxy_remote_write_to_the_registry(tmp_path):
    reg = TelemetryRegistry()
    reg.serve()
    rc = RegistryClient("127.0.0.1", reg.port)
    procs = []
    try:
        procs.append(_spawn(
            ["kubeshare_tpu_torch.nodeagent.launcherd", "--backend", "fake",
             "--node", "node-x", "--base-dir", str(tmp_path),
             "--registry-host", "127.0.0.1", "--registry-port",
             str(reg.port), "--push-period", "0.2"],
            {"KUBESHARE_TPU_FAKE_TOPOLOGY": "1:1"}))
        procs.append(_spawn(
            ["kubeshare_tpu_torch.isolation.proxy", "--device", "cpu",
             "--remote-write", f"127.0.0.1:{reg.port}", "--push-period",
             "0.2", "--instance", "proxy-x"]))
        for proc in procs:
            line = proc.stdout.readline()
            assert line.startswith("READY"), proc.stderr.read()
        inst = _wait(lambda: (lambda i: i if {"node-x", "proxy-x"} <= set(i)
                              else None)(_instances(rc)))
        assert inst["node-x"]["job"] == "launcherd"
        assert inst["proxy-x"]["job"] == "chipproxy"
        assert not inst["node-x"]["stale"] and not inst["proxy-x"]["stale"]
        for name in ("node-x", "proxy-x"):
            _wait(lambda: rc.query(
                "kubeshare_remote_write_pushes_total", agg="increase",
                window_s=60.0, matchers={"instance": name})["groups"])
        for proc in procs:
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=30) == 0, proc.stderr.read()
        inst = _instances(rc)
        assert inst["node-x"]["stale"] and inst["proxy-x"]["stale"]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        reg.close()
