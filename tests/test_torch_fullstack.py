"""The port's whole deployment on the CPU, the twin of
``tests/test_fullstack.py``, every piece the port's own:

    admission webhook  →  fake kube-apiserver  →  pod-event bridge
    →  scheduler service (dispatcher, engine, health watch)
    →  telemetry registry (capacity and lease from a fake collector)
    →  config daemon → the device's client file
    →  launcher → a per-device proxy process (``--device cpu``) and the
       pod's manager process
    →  a gate-mode tenant process of the small LM preset, attached only
       by the shim from the env a kubelet builds from the pod object.

The pod is labels-only until the webhook completes it. The tenant's
steps are charged on the proxy's token scheduler under the pod's name;
deleting the pod on the apiserver stops its manager. The CPU has no
allocator stats, so a memory grant would stop the tenant (it fails
closed): the kubelet env here leaves ``KUBESHARE_TPU_MEM`` out, after
checking the pod object carries it. No JAX is compiled, and a 60 s alarm
bounds the test.
"""

import base64
import copy
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

from chip_smoke import FakeKubeApi
from kubeshare_tpu_torch import constants as C
from kubeshare_tpu_torch.isolation import protocol
from kubeshare_tpu_torch.nodeagent import configd, launcherd
from kubeshare_tpu_torch.nodeagent.files import read_chip_clients
from kubeshare_tpu_torch.scheduler import SchedulerEngine
from kubeshare_tpu_torch.scheduler import webhook
from kubeshare_tpu_torch.scheduler.bridge import (KubeClient, PodEventBridge,
                                                  ServiceClient)
from kubeshare_tpu_torch.scheduler.service import SchedulerService
from kubeshare_tpu_torch.telemetry import registry
from kubeshare_tpu_torch.telemetry.collector import CapacityCollector

REPO = Path(__file__).resolve().parent.parent
SHIM = REPO / "kubeshare_tpu_torch" / "_shim"
NODE = "tpu-host-0"
LIMIT_S = 60


@pytest.fixture
def alarm():
    def expired(*_):
        raise TimeoutError(f"the full stack took more than {LIMIT_S} s")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def wait_for(cond, timeout=30.0, period=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(period)
    return False


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def admit(port, obj):
    """The apiserver's call to the mutating webhook, and the patch
    applied as the apiserver applies it."""
    review = {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
              "request": {"uid": "r", "kind": {"kind": "Pod"},
                          "object": obj}}
    req = urllib.request.Request(f"http://127.0.0.1:{port}/mutate",
                                 method="POST",
                                 data=json.dumps(review).encode())
    with urllib.request.urlopen(req, timeout=10) as r:
        resp = json.load(r)["response"]
    assert resp["allowed"], resp
    patch = json.loads(base64.b64decode(resp["patch"]))
    return webhook.apply_json_patch(obj, patch)


def kubelet_env(pod):
    """The container's env as a kubelet builds it from the pod object:
    the downward-API entries the webhook injected, resolved."""
    return webhook.resolve_downward_env(pod, pod["spec"]["containers"][0])


def test_a_labels_only_pod_reaches_an_attached_tenant(tmp_path, monkeypatch,
                                                      alarm):
    monkeypatch.setenv("KUBESHARE_TPU_FAKE_TOPOLOGY", "1:1")
    reg = registry.TelemetryRegistry()
    reg.serve(port=0)
    rc = registry.RegistryClient("127.0.0.1", reg.port)
    col = CapacityCollector(rc, node=NODE, backend="fake", lease_ttl_s=1.0)
    col.collect_once()
    col.start()
    chip = col.last_chips[0].chip_id
    svc = SchedulerService(SchedulerEngine(), rc, healthwatch=True)
    svc.serve()
    api = FakeKubeApi()
    bridge = PodEventBridge(ServiceClient(f"http://127.0.0.1:{svc.port}"),
                            KubeClient(api.url), reconnect_s=0.1,
                            poll_s=0.1).start()
    hook = webhook.WebhookServer(host="127.0.0.1").start()
    token_port = free_port()
    base = str(tmp_path)

    def proxy_cmd(chip_id, index, _exec, _tokens):
        cmd, env = launcherd.default_proxy_cmd(chip_id, index, free_port(),
                                               token_port)
        return cmd + ["--device", "cpu", "-w", "1000"], dict(
            env, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")

    def pmgr_cmd(name, port, request, limit, _tokens):
        cmd, env = launcherd.default_pmgr_cmd(name, port, request, limit,
                                              token_port)
        return cmd, dict(env, PYTHONPATH=str(REPO))

    daemon = configd.ConfigDaemon(rc, NODE, [chip], base_dir=base,
                                  period_s=0.05).start()
    launcher = launcherd.LauncherDaemon([chip], base_dir=base, poll_s=0.05,
                                        proxy_cmd=proxy_cmd,
                                        pmgr_cmd=pmgr_cmd).start()
    try:
        obj = {"metadata": {"namespace": "ns", "name": "lm", "labels": {
                   C.POD_TPU_REQUEST: "0.5", C.POD_TPU_LIMIT: "1.0"}},
               "spec": {"containers": [{"name": "lm", "image": "lm"}]}}
        admitted = admit(hook.port, copy.deepcopy(obj))
        assert admitted["spec"]["schedulerName"] == C.SCHEDULER_NAME
        code, _ = api.request("POST", "/api/v1/namespaces/ns/pods",
                              admitted)
        assert code == 201
        assert wait_for(lambda: api.pods["ns/lm"]["spec"].get("nodeName"))
        pod = api.pods["ns/lm"]
        ann = pod["metadata"]["annotations"]
        assert pod["spec"]["nodeName"] == NODE
        assert ann[C.POD_TPU_CHIP_ID] == chip
        assert [k for k, key, _ in api.writes] == ["create", "patch", "bind"]
        port = int(ann[C.POD_MANAGER_PORT])
        assert wait_for(lambda: [e.port for e in read_chip_clients(
            chip, base)] == [port])

        def dials():
            try:
                socket.create_connection(("127.0.0.1", port), 1).close()
                return True
            except OSError:
                return False

        assert wait_for(dials, 30), "the pod's manager never served"
        env = kubelet_env(pod)
        assert env[C.ENV_POD_MANAGER_PORT] == str(port)
        assert env[C.ENV_VISIBLE_CHIPS] == chip
        assert int(env.pop(C.ENV_TPU_MEMORY)) > 0
        proc_env = {k: v for k, v in os.environ.items()
                    if not k.startswith("KUBESHARE_TPU_")}
        proc_env.update(env, PYTHONPATH=os.pathsep.join([str(SHIM),
                                                         str(REPO)]),
                        KUBESHARE_TPU_TRANSFORMER_PRESET="small",
                        OMP_NUM_THREADS="1")
        out = subprocess.run(
            [sys.executable, "-m", "kubeshare_tpu_torch.models.transformer",
             "--device", "cpu", "--steps", "3"], env=proc_env, cwd=str(REPO),
            capture_output=True, text=True, timeout=LIMIT_S)
        assert out.returncode == 0, out.stderr[-3000:]
        with protocol.Connection("127.0.0.1", token_port) as conn:
            conn.call({"op": "attach", "name": "ns/lm"})
            used = conn.call({"op": "usage"})[0]["used_ms"]
        assert used > 0, "the tenant's steps were never charged"
        assert svc.invariants_state()["ok"]

        proc = launcher._managers[(chip, "ns/lm")][1]
        code, _ = api.request("DELETE", "/api/v1/namespaces/ns/pods/lm")
        assert code == 200
        assert wait_for(lambda: proc.poll() is not None
                        and (chip, "ns/lm") not in launcher._managers)
        assert rc.pods() == {} and read_chip_clients(chip, base) == []
    finally:
        launcher.stop()
        daemon.stop()
        hook.stop()
        bridge.stop()
        api.close()
        svc.close()
        col.stop()
        reg.close()
