"""The port's node config daemon and the placement path on the CPU: a
pod's labels go through the engine, its binding through the registry,
configd writes the device's client file, and the launcher starts and
stops the pod's manager.

Mirrors the configd and queryip cases of ``tests/test_nodeagent.py``;
the three daemon CLIs added here are each stopped the moment they print
``READY`` (the JAX package's deadlock on a signal right after it).
"""

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from kubeshare_tpu.nodeagent import configd as jconfigd
from kubeshare_tpu.nodeagent import queryip as jqueryip
from kubeshare_tpu.telemetry import registry as jregistry
from kubeshare_tpu_torch import constants as C
from kubeshare_tpu_torch.nodeagent import configd, queryip
from kubeshare_tpu_torch.nodeagent.files import read_chip_clients
from kubeshare_tpu_torch.nodeagent.launcherd import LauncherDaemon
from kubeshare_tpu_torch.scheduler import SchedulerEngine
from kubeshare_tpu_torch.telemetry import aggregator, registry
from kubeshare_tpu_torch.telemetry.collector import CapacityCollector

REPO = Path(__file__).resolve().parent.parent
GIB = 1024 ** 3


def rec(node, chips, request="0.5", limit="1.0", memory="0", port="50051"):
    return {"node": node, "chip_id": chips, "request": request,
            "limit": limit, "memory": memory, "port": port}


RECORDS = {
    "ns/a": rec("n0", "c0", "0.5", "1.0", str(GIB), "50051"),
    "ns/b": rec("n0", "c0", "0.25", "0.5", "0", "50052"),
    "ns/c": rec("n0", "c1,c2", "2", "2", "0", "0"),          # whole chips
    "ns/d": rec("n0", "c1", "0.3", "1", "12", "50053"),
    "ns/e": rec("n0", "c2", "x", "1", "0", "50054"),          # malformed
    "ns/f": rec("n0", "", "0.5", "1", "0", "50055"),
    "ns/0": rec("n0", "c1,c3", "1", "1", "4", "0"),
}


def wait_for(predicate, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return False


def test_records_become_the_jax_client_entries():
    mine = configd.records_to_entries(RECORDS)
    theirs = jconfigd.records_to_entries(RECORDS)
    assert ({k: [e.to_json() for e in v] for k, v in mine.items()}
            == {k: [e.to_json() for e in v] for k, v in theirs.items()})
    assert sorted(mine) == ["c0", "c1", "c3"]


def test_configd_writes_the_jax_daemons_files(tmp_path):
    reg = registry.TelemetryRegistry()
    for key, record in RECORDS.items():
        reg.put_pod(key, record)
    reg.put_pod("ns/other", rec("n1", "c0"))
    chips = ["c0", "c1", "c2", "c3", "c4/x"]
    written = []
    for mod, sub in ((configd, "port"), (jconfigd, "jax")):
        daemon = mod.ConfigDaemon(reg, "n0", chips,
                                  base_dir=str(tmp_path / sub))
        written.append(daemon.sync_once())
        written.append(daemon.sync_once())     # unchanged: no rewrite
    assert written[0] == written[2] == chips and written[1] == written[3] == []
    for family in ("config", "podmanagerport"):
        names = sorted(os.listdir(tmp_path / "port" / family))
        assert names == sorted(os.listdir(tmp_path / "jax" / family))
        for name in names:
            assert ((tmp_path / "port" / family / name).read_bytes()
                    == (tmp_path / "jax" / family / name).read_bytes())
    # a record going away rewrites only its device's file
    reg.drop_pod("ns/b")
    daemon = configd.ConfigDaemon(reg, "n0", chips,
                                  base_dir=str(tmp_path / "port"))
    daemon.sync_once()
    reg.drop_pod("ns/a")
    assert daemon.sync_once() == ["c0"]
    assert read_chip_clients("c0", str(tmp_path / "port")) == []


def test_queryip_writes_the_jax_file(tmp_path):
    for ip, port in (("10.0.0.7", 9006), ("10.0.0.8", 0)):
        mine = queryip.write_scheduler_ip(ip, port, str(tmp_path / "p"))
        theirs = jqueryip.write_scheduler_ip(ip, port, str(tmp_path / "j"))
        assert Path(mine).read_bytes() == Path(theirs).read_bytes()
        assert queryip.read_scheduler_ip(theirs) == (ip, port)


def stand_in(*_args, **_kw):
    """A process that just sleeps: the lifecycle is what is under test."""
    return [sys.executable, "-c", "import time; time.sleep(120)"], dict(
        os.environ)


def test_a_pod_goes_from_its_labels_to_a_manager_and_back(tmp_path,
                                                          monkeypatch):
    """The placement path on the CPU: registry over HTTP, a fake
    collector, the engine synced from the registry, configd, and the
    launcher with stand-in proxy and manager commands."""
    monkeypatch.setenv("KUBESHARE_TPU_FAKE_TOPOLOGY", "2:2x2")
    reg = registry.TelemetryRegistry()
    reg.serve(port=0)
    rc = registry.RegistryClient("127.0.0.1", reg.port)
    col = CapacityCollector(rc, node="tpu-host-0", backend="fake",
                            lease_ttl_s=1.0)
    col.collect_once()
    col.start()
    chip_ids = [c.chip_id for c in col.last_chips]
    base = str(tmp_path)
    daemon = configd.ConfigDaemon(rc, "tpu-host-0", chip_ids, base_dir=base,
                                  period_s=0.05).start()
    launcher = LauncherDaemon(chip_ids, base_dir=base, poll_s=0.05,
                              proxy_cmd=stand_in, pmgr_cmd=stand_in).start()
    try:
        eng = SchedulerEngine()
        assert aggregator.sync_engine_from_registry(eng, rc) == ["tpu-host-0"]
        labels = {C.POD_TPU_REQUEST: "0.5", C.POD_TPU_LIMIT: "1.0",
                  C.POD_TPU_MODEL: "TPU-v4"}
        bound = {}
        for name in ("a", "b"):
            pod = eng.submit("ns", name, labels)
            bound[pod.key] = (pod, eng.schedule(pod))
            aggregator.publish_binding(rc, pod, bound[pod.key][1])
        chip = bound["ns/a"][1].chip_ids[0]

        def managers():
            return {name: (port, proc.poll() is None) for (c, name), (
                port, proc) in launcher._managers.items() if c == chip}

        want = {k: (b.port, True) for k, (_, b) in bound.items()}
        assert bound["ns/b"][1].chip_ids == [chip]
        assert wait_for(lambda: managers() == want), managers()
        assert [e.name for e in read_chip_clients(chip, base)] == sorted(want)
        assert len(launcher._proxies) == len(chip_ids)
        # the lease beats; the engine saw the collector's capacity
        assert "tpu-host-0" in rc.leases()["leases"]
        eng.delete_pod("ns/a")
        aggregator.withdraw(rc, "ns/a")
        proc = launcher._managers[(chip, "ns/a")][1]
        assert wait_for(lambda: managers() == {"ns/b": want["ns/b"]})
        assert proc.poll() is not None
        pod = eng.submit("ns", "c", labels)
        b = eng.schedule(pod)
        assert b.port == bound["ns/a"][1].port + 2   # round-robin ports
    finally:
        launcher.stop()
        daemon.stop()
        col.stop()
        reg.close()
    assert reg.capacity() == {} and reg.leases() == {}


def _spawn(args, env=None):
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = str(REPO)
    return subprocess.Popen([sys.executable, "-m", *args], cwd=str(REPO),
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.mark.parametrize("cli", ["registry", "collector", "configd"])
def test_a_daemon_stops_on_sigterm_right_after_ready(cli, tmp_path):
    """Signalled the moment it prints READY, each CLI exits 0 (the JAX
    registry, collector and configd install their handlers after the
    line, and their handler's ``Event.set`` can deadlock the main
    thread). The collector drops its capacity and lease on the way out."""
    reg = registry.TelemetryRegistry()
    reg.serve(port=0)
    env = dict(os.environ, KUBESHARE_TPU_FAKE_TOPOLOGY="1:2x2")
    args = {
        "registry": ["kubeshare_tpu_torch.telemetry.registry", "--host",
                     "127.0.0.1", "--port", "0",
                     "--journal", str(tmp_path / "j.jsonl")],
        "collector": ["kubeshare_tpu_torch.telemetry.collector",
                      "--registry-port", str(reg.port), "--node",
                      "tpu-host-0", "--backend", "fake"],
        "configd": ["kubeshare_tpu_torch.nodeagent.configd",
                    "--registry-port", str(reg.port), "--node",
                    "tpu-host-0", "--backend", "fake", "--base-dir",
                    str(tmp_path / "sched")],
    }[cli]
    try:
        for _ in range(3):
            proc = _spawn(args, env)
            line = proc.stdout.readline()
            proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(timeout=20)
            finally:
                if proc.poll() is None:
                    proc.kill()
                err = proc.stderr.read()
            assert line.startswith("READY"), err
            assert rc == 0, err
            if cli == "registry":
                assert int(line.split()[1]) > 0
            if cli == "collector":
                assert reg.capacity() == {} and reg.leases() == {}
            if cli == "configd":
                assert len(os.listdir(tmp_path / "sched" / "config")) == 4
    finally:
        reg.close()


def test_the_launcher_beats_its_nodes_lease(tmp_path):
    """``--registry-host``: the launcher publishes the node's lease, as
    the JAX daemon does, and its process is the lease's life. A node the
    fake fleet does not hold has no devices, so no proxy starts."""
    reg = jregistry.TelemetryRegistry()       # the wire is one
    reg.serve(port=0)
    env = dict(os.environ, KUBESHARE_TPU_FAKE_TOPOLOGY="1:2x2")
    proc = _spawn(["kubeshare_tpu_torch.nodeagent.launcherd", "--node",
                   "edge-0", "--backend", "fake", "--base-dir",
                   str(tmp_path), "--registry-host", "127.0.0.1",
                   "--registry-port", str(reg.port), "--lease-ttl", "0.6"],
                  env)
    try:
        assert proc.stdout.readline().startswith("READY")
        assert wait_for(lambda: reg.leases().get("edge-0", {}).get(
            "epoch", 0) >= 3)
        assert reg.stale_nodes() == []
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=20) == 0
        epoch = reg.leases()["edge-0"]["epoch"]
        assert wait_for(lambda: reg.stale_nodes() == ["edge-0"])
        assert reg.leases()["edge-0"]["epoch"] == epoch
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        reg.close()
