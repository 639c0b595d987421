"""The port's node agent: client files, the launcher daemon, the proxy
process it spawns and device discovery, against the JAX package's.

Mirrors the file and launcher cases of ``tests/test_nodeagent.py``; the
launcher's real commands run here with the proxy on the CPU
(``--device cpu``).
"""

import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from kubeshare_tpu.nodeagent import files as jfiles
from kubeshare_tpu.topology import discovery as jdiscovery
from kubeshare_tpu_torch import attach
from kubeshare_tpu_torch import constants as C
from kubeshare_tpu_torch.isolation import protocol
from kubeshare_tpu_torch.isolation.client import ExecutionGate
from kubeshare_tpu_torch.nodeagent import launcherd
from kubeshare_tpu_torch.nodeagent.files import (ClientEntry,
                                                 list_chip_files,
                                                 read_chip_clients,
                                                 write_chip_clients)
from kubeshare_tpu_torch.nodeagent.launcherd import LauncherDaemon
from kubeshare_tpu_torch.topology import discovery

REPO = Path(__file__).resolve().parent.parent
CHIP = "TPU-v4-tpu-host-0-0"


def entry(name="ns/p", request=0.5, limit=1.0, memory=0, port=50051):
    return ClientEntry(name, request, limit, memory, port)


def wait_for(predicate, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return False


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# --- files -------------------------------------------------------------------

def test_chip_files_roundtrip(tmp_path):
    base = str(tmp_path)
    clients = [entry("ns/a", port=50051), entry("ns/b", 0.3, 0.5, 1024, 50052)]
    config_path, port_path = write_chip_clients(CHIP, clients, base)
    assert os.path.exists(config_path) and os.path.exists(port_path)
    assert read_chip_clients(CHIP, base) == clients
    assert list_chip_files(base) == [CHIP]
    # an empty list still writes the files (the launcher kills managers)
    write_chip_clients(CHIP, [], base)
    assert read_chip_clients(CHIP, base) == []


def test_chip_files_are_the_jax_packages_bytes(tmp_path):
    """Either package's launcher reads the other's files: the same
    entries give the same bytes on disk, and each reads the other's."""
    clients = [("ns/a", 0.5, 1.0, 0, 50051), ("ns/b", 0.3, 0.5, 1024, 50052)]
    port_paths = write_chip_clients(
        CHIP, [ClientEntry(*c) for c in clients], str(tmp_path / "port"))
    jax_paths = jfiles.write_chip_clients(
        CHIP, [jfiles.ClientEntry(*c) for c in clients],
        str(tmp_path / "jax"))
    for mine, theirs in zip(port_paths, jax_paths):
        assert Path(mine).read_bytes() == Path(theirs).read_bytes()
    assert [tuple(vars(e).values()) for e in read_chip_clients(
        CHIP, str(tmp_path / "jax"))] == clients
    assert [tuple(vars(e).values()) for e in jfiles.read_chip_clients(
        CHIP, str(tmp_path / "port"))] == clients


# --- launcher lifecycle --------------------------------------------------------

def stub_cmd(*_args, **_kw):
    """A process that just sleeps — lifecycle is what is under test."""
    return [sys.executable, "-c", "import time; time.sleep(60)"], dict(
        os.environ)


@pytest.fixture
def launcher(tmp_path):
    daemon = LauncherDaemon([CHIP], base_dir=str(tmp_path), poll_s=0.05,
                            proxy_cmd=stub_cmd, pmgr_cmd=stub_cmd,
                            spawn_proxies=False)
    yield daemon, str(tmp_path)
    daemon.stop()


def test_launcher_spawns_and_kills_managers(launcher):
    daemon, base = launcher
    write_chip_clients(CHIP, [entry("ns/a", port=50051)], base)
    daemon.start()
    assert wait_for(lambda: (CHIP, "ns/a") in daemon._managers)
    _, proc = daemon._managers[(CHIP, "ns/a")]
    assert proc.poll() is None
    write_chip_clients(CHIP, [entry("ns/a", port=50051),
                              entry("ns/b", port=50052)], base)
    assert wait_for(lambda: (CHIP, "ns/b") in daemon._managers)
    # the first client leaves: its manager dies (launcher.py:58-66)
    write_chip_clients(CHIP, [entry("ns/b", port=50052)], base)
    assert wait_for(lambda: (CHIP, "ns/a") not in daemon._managers)
    assert wait_for(lambda: proc.poll() is not None)


def test_launcher_restarts_dead_manager(launcher):
    daemon, base = launcher
    write_chip_clients(CHIP, [entry("ns/a", port=50051)], base)
    daemon.start()
    assert wait_for(lambda: (CHIP, "ns/a") in daemon._managers)
    _, proc = daemon._managers[(CHIP, "ns/a")]
    proc.terminate()
    assert wait_for(lambda: daemon._managers.get(
        (CHIP, "ns/a"), (0, proc))[1] is not proc)


def test_launcher_port_change_restarts_manager(launcher):
    daemon, base = launcher
    write_chip_clients(CHIP, [entry("ns/a", port=50051)], base)
    daemon.start()
    assert wait_for(lambda: (CHIP, "ns/a") in daemon._managers)
    write_chip_clients(CHIP, [entry("ns/a", port=50099)], base)
    assert wait_for(lambda: daemon._managers.get(
        (CHIP, "ns/a"), (0, None))[0] == 50099)


def test_launcher_restarts_dead_proxy_and_stops_all(tmp_path):
    daemon = LauncherDaemon([CHIP, "TPU-v4-tpu-host-0-1"],
                            base_dir=str(tmp_path), poll_s=0.05,
                            proxy_cmd=stub_cmd, pmgr_cmd=stub_cmd)
    try:
        daemon.start()
        assert len(daemon._proxies) == 2
        assert daemon.token_port(CHIP) == C.SCHD_PORT_START + 1000
        first = daemon._proxies[CHIP]
        first.kill()
        assert wait_for(lambda: daemon._proxies[CHIP] is not first)
    finally:
        procs = list(daemon._proxies.values())
        daemon.stop()
    assert all(p.poll() is not None for p in procs)


def test_default_commands_pin_the_device_and_turn_attach_off(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    cmd, env = launcherd.default_proxy_cmd(CHIP, 1, 49902, 50902)
    assert cmd[1:] == ["-m", "kubeshare_tpu_torch.isolation.proxy", "-P",
                       "49902", "-S", "50902"]
    assert env["CUDA_VISIBLE_DEVICES"] == "1"
    assert env[C.ENV_ATTACH_MODE] == "off"
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4,5")
    assert launcherd.default_proxy_cmd(CHIP, 1, 1, 2)[1][
        "CUDA_VISIBLE_DEVICES"] == "5"
    cmd, env = launcherd.default_pmgr_cmd("ns/a", 50051, 0.5, 1.0, 50901)
    assert cmd[1:] == ["-m", "kubeshare_tpu_torch.isolation.podmgr"]
    assert env["SCHEDULER_PORT"] == "50901"
    assert env[C.ENV_POD_MANAGER_PORT] == "50051"
    assert env[C.ENV_POD_NAME] == "ns/a"
    assert env[C.ENV_ATTACH_MODE] == "off"


# --- the proxy process and the whole node path on the CPU ----------------------

def _cpu_env():
    return dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")


def test_proxy_main_serves_tokens_and_stops_on_sigterm():
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeshare_tpu_torch.isolation.proxy",
         "--device", "cpu", "-P", "0", "-S", "0", "-w", "1000"],
        stdout=subprocess.PIPE, text=True, env=_cpu_env(), cwd=str(REPO))
    try:
        line = proc.stdout.readline().split()
        assert line[0] == "READY" and line[2] == "TOKENS", line
        gate = ExecutionGate.connect("127.0.0.1", int(line[3]), "ns/t", 0.5,
                                     1.0, barrier=lambda: None)
        gate()
        time.sleep(0.02)
        gate.close()
        with protocol.Connection("127.0.0.1", int(line[3])) as conn:
            conn.call({"op": "attach", "name": "ns/t"})
            reply, _ = conn.call({"op": "usage"})
        assert reply["window_ms"] == 1000.0
        assert reply["used_ms"] >= 15.0
        gate._conn.close()
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0


def test_launcher_runs_the_node_path_on_cpu(tmp_path):
    """The launcher's real commands: the per-device proxy process (on the
    CPU here) serving tokens, and the pod manager per client entry; a
    gate through the manager is charged on the proxy's scheduler; removing
    the entry kills its manager, which unregisters the pod."""
    exec_port, token_port = free_port(), free_port()

    def proxy_cmd(chip_id, index, _exec, _tokens):
        cmd, env = launcherd.default_proxy_cmd(chip_id, index, exec_port,
                                               token_port)
        return cmd + ["--device", "cpu", "-w", "1000"], dict(
            env, **_cpu_env())

    def pmgr_cmd(name, port, request, limit, _tokens):
        cmd, env = launcherd.default_pmgr_cmd(name, port, request, limit,
                                              token_port)
        return cmd, dict(env, PYTHONPATH=str(REPO))

    base = str(tmp_path)
    mgr_port = free_port()
    write_chip_clients(CHIP, [entry("ns/a", port=mgr_port)], base)
    daemon = LauncherDaemon([CHIP], base_dir=base, poll_s=0.05,
                            proxy_cmd=proxy_cmd, pmgr_cmd=pmgr_cmd)

    def usage(name):
        with protocol.Connection("127.0.0.1", token_port) as conn:
            conn.call({"op": "attach", "name": name})
            return conn.call({"op": "usage"})[0]["used_ms"]

    def dials(port):
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return True
        except OSError:
            return False

    try:
        daemon.start()
        assert wait_for(lambda: dials(mgr_port), 60), "manager never served"
        gate = ExecutionGate.connect("127.0.0.1", mgr_port, "x", 0.5, 1.0,
                                     barrier=lambda: None)
        for _ in range(3):
            gate()
            time.sleep(0.02)
        gate.close()
        assert usage("ns/a") >= 30.0
        gate._conn.close()
        write_chip_clients(CHIP, [], base)
        with pytest.raises(RuntimeError, match="KeyError"):
            wait_for(lambda: usage("ns/a") < 0, 10)
    finally:
        daemon.stop()


# --- discovery ----------------------------------------------------------------

@pytest.mark.parametrize("spec", ["1:2x2", "2:2x2@TPU-v5e", "3:1@TPU-v4",
                                  "2:2x2x2"])
def test_fake_discovery_matches_jax(spec, monkeypatch):
    monkeypatch.setenv("KUBESHARE_TPU_FAKE_TOPOLOGY", spec)
    mine = discovery.discover_chips("auto")
    theirs = jdiscovery.discover_chips("auto")
    assert [c.to_labels() for c in mine] == [c.to_labels() for c in theirs]
    host = theirs[-1].host
    assert [c.chip_id for c in discovery.discover_chips("fake", host=host)] \
        == [c.chip_id for c in jdiscovery.discover_chips("fake", host=host)]


def test_cuda_discovery_without_a_card_raises(monkeypatch):
    monkeypatch.delenv("KUBESHARE_TPU_FAKE_TOPOLOGY", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        discovery.discover_chips("auto")
    with pytest.raises(ValueError):
        discovery.discover_chips("jax")


def test_cuda_chip_ids_parse_as_a_device_pin(monkeypatch):
    """A GPU's chip id keeps the ``<model>-<host>-<index>`` grammar the
    attach's device pin parses (a GPU name has spaces and dashes)."""
    class Props:
        name = "NVIDIA H100 80GB HBM3"
        total_memory = 80 * 1024**3

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: Props)
    chips = discovery.discover_chips("cuda", host="gpu-node-7")
    assert [c.chip_id for c in chips] == [
        "NVIDIA-H100-80GB-HBM3-gpu-node-7-0",
        "NVIDIA-H100-80GB-HBM3-gpu-node-7-1"]
    assert chips[1].memory == 80 * 1024**3 and chips[1].coords == ()
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    monkeypatch.setenv(C.ENV_VISIBLE_CHIPS, chips[1].chip_id)
    assert attach._pin_visible_devices()
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "1"
