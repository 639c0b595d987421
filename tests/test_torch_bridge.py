"""The port's pod-event bridge and admission webhook against the JAX
package's.

The bridge: each package's bridge drives its own package's scheduler
service, in process, against a fake kube-apiserver of its own holding the
same pod objects; both make the same annotate, bind and delete calls
with the same bodies, apart from the one divergence on purpose: the
port never sends a DELETE without a uid precondition
(``test_a_delete_without_uid_is_preconditioned_on_the_pod_read``).
The webhook: the same JSON patch and ``AdmissionReview`` for the same
pods, in function and over HTTP. Then both CLIs stop on SIGTERM right
after ``READY`` with rc 0.

Mirrors ``tests/test_bridge.py`` and ``tests/test_webhook.py``.
"""

import base64
import copy
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from chip_smoke import FakeKubeApi
from kubeshare_tpu.obs import decisions as jdec
from kubeshare_tpu.obs import flight as jflight
from kubeshare_tpu.scheduler import SchedulerEngine as JaxEngine
from kubeshare_tpu.scheduler import bridge as jbridge
from kubeshare_tpu.scheduler import webhook as jwebhook
from kubeshare_tpu.scheduler.service import SchedulerService as JaxService
from kubeshare_tpu.telemetry import TelemetryRegistry as JaxRegistry
from kubeshare_tpu.topology.discovery import FakeTopology as JaxFake
from kubeshare_tpu_torch import constants as C
from kubeshare_tpu_torch.obs import decisions as dec
from kubeshare_tpu_torch.scheduler import SchedulerEngine
from kubeshare_tpu_torch.scheduler import bridge
from kubeshare_tpu_torch.scheduler import webhook
from kubeshare_tpu_torch.scheduler.service import SchedulerService
from kubeshare_tpu_torch.telemetry import TelemetryRegistry
from kubeshare_tpu_torch.topology.discovery import FakeTopology

REPO = Path(__file__).resolve().parent.parent
SCHED = C.SCHEDULER_NAME


@pytest.fixture(autouse=True)
def quiet_and_fresh(monkeypatch):
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


def shared(request="0.5", limit="1.0", **extra):
    labels = {C.POD_TPU_REQUEST: request, C.POD_TPU_LIMIT: limit}
    labels.update(extra)
    return labels


def pod_obj(name, labels, ns="default", scheduler=SCHED, node="",
            annotations=None):
    return {"metadata": {"namespace": ns, "name": name, "labels": labels,
                         "annotations": dict(annotations or {})},
            "spec": {"schedulerName": scheduler, "nodeName": node,
                     "containers": [{"name": "main", "image": "lm"}]}}


class Side:
    """One package's registry, service, fake apiserver and bridge."""

    def __init__(self, pkg, mesh=(2,)):
        engine_cls, registry_cls, fake_cls, service_cls, self.mod = pkg
        self.registry = registry_cls()
        chips = fake_cls(hosts=1, mesh=mesh).chips()
        self.registry.put_capacity(chips[0].host,
                                   [c.to_labels() for c in chips])
        self.svc = service_cls(engine_cls(), self.registry,
                               retry_backoff_s=3600.0)
        self.svc.serve()
        self.api = FakeKubeApi()
        self.bridge = self.mod.PodEventBridge(
            self.mod.ServiceClient(f"http://127.0.0.1:{self.svc.port}"),
            self.mod.KubeClient(self.api.url), scheduler_name=SCHED)

    def create(self, pod):
        code, body = self.api.request(
            "POST", f"/api/v1/namespaces/{pod['metadata']['namespace']}"
            "/pods", copy.deepcopy(pod))
        assert code == 201, body
        return body

    def event(self, etype, key):
        obj = self.api.pods.get(key)
        if obj is None:
            obj = next(o for _, t, o in reversed(self.api.events)
                       if f"{o['metadata']['namespace']}/"
                          f"{o['metadata']['name']}" == key)
        self.bridge.handle(etype, copy.deepcopy(obj))

    def close(self):
        self.svc.close()
        self.api.close()


PORT = (SchedulerEngine, TelemetryRegistry, FakeTopology, SchedulerService,
        bridge)
JAX = (JaxEngine, JaxRegistry, JaxFake, JaxService, jbridge)


@pytest.fixture
def sides():
    s = (Side(PORT), Side(JAX))
    yield s
    for side in s:
        side.close()


def same_writes(sides):
    mine, theirs = (side.api.writes for side in sides)
    assert mine == theirs
    return mine


def test_the_shared_names_agree():
    assert bridge.SCHEDULER_NAME == jbridge.SCHEDULER_NAME == SCHED
    assert webhook.VOLUME_NAME == jwebhook.VOLUME_NAME
    assert (bridge.ServiceClient.RETRY_ATTEMPTS,
            bridge.ServiceClient.RETRY_BACKOFF_S) == (
        jbridge.ServiceClient.RETRY_ATTEMPTS,
        jbridge.ServiceClient.RETRY_BACKOFF_S)


def test_a_relist_annotates_and_binds_alike(sides):
    pods = [pod_obj("a", shared()), pod_obj("b", shared("1", "1")),
            pod_obj("bad", {C.POD_TPU_REQUEST: "2", C.POD_TPU_LIMIT: "1"}),
            pod_obj("big", shared("4", "4")),
            pod_obj("other", shared(), scheduler="default-scheduler")]
    for side in sides:
        for p in pods:
            side.create(p)
        side.bridge.sync_once()
    writes = same_writes(sides)
    kinds = [(k, key) for k, key, _ in writes if k != "create"]
    assert kinds == [("patch", "default/a"), ("bind", "default/a"),
                     ("patch", "default/b"), ("bind", "default/b")]
    for side in sides:
        a = side.api.pods["default/a"]
        assert a["spec"]["nodeName"] == "tpu-host-0"
        assert a["metadata"]["annotations"][C.POD_MANAGER_PORT]
        assert set(side.bridge._awaiting) == {"default/big"}
    # the MODIFIED echoes of the bridge's own writes change nothing
    for side in sides:
        for key in ("default/a", "default/b"):
            side.event("MODIFIED", key)
    same_writes(sides)


def test_a_deleted_pod_releases_and_a_pending_one_binds_on_poll(sides):
    for side in sides:
        side.create(pod_obj("a", shared("1", "1")))
        side.create(pod_obj("b", shared("1", "1")))
        side.create(pod_obj("c", shared("1", "1")))
        side.bridge.sync_once()
        assert set(side.bridge._awaiting) == {"default/c"}
        code, _ = side.api.request("DELETE",
                                   "/api/v1/namespaces/default/pods/a")
        assert code == 200
        side.event("DELETED", "default/a")
        assert "default/a" not in side.registry.pods()
        # the dispatcher's retry binds c; the bridge learns it by polling
        side.svc.dispatcher._retry_at["default/c"] = 0.0
        side.svc.dispatcher.step()
        side.bridge.poll_pending()
        assert side.bridge._awaiting == {}
        assert side.api.pods["default/c"]["spec"]["nodeName"]
    writes = same_writes(sides)
    assert [k for k, key, _ in writes if key == "default/c"] == [
        "create", "patch", "bind"]


def test_an_already_bound_pod_is_resynced_alike(sides):
    first = sides[0].create(pod_obj("a", shared()))
    sides[0].bridge.sync_once()
    bound = sides[0].api.pods["default/a"]
    ann = bound["metadata"]["annotations"]
    node = bound["spec"]["nodeName"]
    states = []
    for side in sides:
        fresh = Side(PORT if side is sides[0] else JAX)
        try:
            fresh.create(pod_obj("r", shared(), node=node, annotations=ann))
            fresh.bridge.sync_once()
            states.append((fresh.svc.pod_status("default/r"),
                           fresh.api.writes[1:]))
        finally:
            fresh.close()
    assert states[0] == states[1]
    assert states[0][0]["status"] == "bound" and states[0][1] == []
    assert first["metadata"]["uid"]


def test_an_eviction_request_deletes_with_the_victims_uid_alike(sides):
    for side in sides:
        for i in range(2):
            side.create(pod_obj(f"opp-{i}", shared(
                "1", "1", **{C.POD_PRIORITY: "0"})))
        side.bridge.sync_once()
        side.create(pod_obj("vip", shared("1", "1",
                                          **{C.POD_PRIORITY: "50"})))
        side.event("ADDED", "default/vip")
        side.bridge.execute_evictions()
    mine, theirs = (side.api.deletes for side in sides)
    assert mine == theirs and len(mine) == 1
    key, body = mine[0]
    assert body["preconditions"]["uid"].startswith(f"uid-{key}")


def test_a_delete_without_uid_is_preconditioned_on_the_pod_read():
    """The divergence on purpose. With ``uid=''`` the JAX client sends a
    bare DELETE; the port reads the pod and preconditions on its uid, so
    a pod recreated under the name between the read and the delete
    survives (409 counts as done, as does 404)."""
    api = FakeKubeApi()
    try:
        path = "/api/v1/namespaces/default/pods"
        api.request("POST", path, pod_obj("x", shared()))
        uid = api.pods["default/x"]["metadata"]["uid"]
        jbridge.KubeClient(api.url).delete_pod("default", "x")
        assert api.deletes[-1] == ("default/x", {})      # unguarded
        api.request("POST", path, pod_obj("x", shared()))
        uid2 = api.pods["default/x"]["metadata"]["uid"]
        assert uid2 != uid
        bridge.KubeClient(api.url).delete_pod("default", "x")
        assert api.deletes[-1] == ("default/x",
                                   {"preconditions": {"uid": uid2}})
        assert "default/x" not in api.pods
        # a recreation between the read and the delete: the newer pod
        # stays, where the JAX client's bare DELETE would have killed it
        api.request("POST", path, pod_obj("x", shared()))
        stale = api.pods["default/x"]
        client = bridge.KubeClient(api.url)
        client.get_pod = lambda ns, name: stale
        api.request("DELETE", f"{path}/x")
        api.request("POST", path, pod_obj("x", shared()))
        newer = api.pods["default/x"]["metadata"]["uid"]
        client.delete_pod("default", "x")
        assert api.deletes[-1][1] == {
            "preconditions": {"uid": stale["metadata"]["uid"]}}
        assert api.pods["default/x"]["metadata"]["uid"] == newer
        jbridge.KubeClient(api.url).delete_pod("default", "x")
        assert "default/x" not in api.pods               # killed
    finally:
        api.close()


def test_a_delete_of_a_missing_pod_counts_as_done():
    api = FakeKubeApi()
    try:
        bridge.KubeClient(api.url).delete_pod("default", "gone")
        assert api.deletes == []        # the read found nothing to delete
        bridge.KubeClient(api.url).delete_pod("default", "gone", uid="u1")
        assert api.deletes == [("default/gone",
                                {"preconditions": {"uid": "u1"}})]
    finally:
        api.close()


def test_a_watch_error_raises_watch_expired_alike():
    for mod in (bridge, jbridge):
        b = mod.PodEventBridge(mod.ServiceClient("http://127.0.0.1:1"),
                               mod.KubeClient("http://127.0.0.1:1"))
        with pytest.raises(mod.WatchExpired, match="code 410"):
            b.handle("ERROR", {"code": 410, "message": "too old"})


@pytest.mark.parametrize("obj", [
    {}, pod_obj("a", shared()),
    pod_obj("b", shared(), node="n1", annotations={C.POD_CELL_ID: "x"}),
    {"metadata": {"name": "d", "deletionTimestamp": "now"}, "spec": {}}])
def test_pod_fields_agree(obj):
    assert bridge.pod_fields(obj) == jbridge.pod_fields(obj)


def test_the_service_client_fails_over_to_a_live_endpoint():
    reg = TelemetryRegistry()
    chips = FakeTopology(hosts=1, mesh=(1,)).chips()
    reg.put_capacity(chips[0].host, [c.to_labels() for c in chips])
    svc = SchedulerService(SchedulerEngine(), reg)
    svc.serve()
    try:
        client = bridge.ServiceClient(
            f"http://127.0.0.1:1,http://127.0.0.1:{svc.port}", seed=1)
        code, body = client.schedule("ns", "a", shared())
        assert code == 200 and client.base_url.endswith(str(svc.port))
        assert client.status("ns", "a")[1]["status"] == "bound"
    finally:
        svc.close()


def test_the_bridge_threads_follow_the_watch_stream():
    side = Side(PORT)
    try:
        side.bridge.reconnect_s = 0.1
        side.bridge.poll_s = 0.1
        side.bridge.start()
        side.create(pod_obj("w", shared()))
        deadline = time.monotonic() + 20
        while (not side.api.pods["default/w"]["spec"].get("nodeName")
               and time.monotonic() < deadline):
            time.sleep(0.05)
        assert side.api.pods["default/w"]["spec"]["nodeName"]
        side.api.request("DELETE", "/api/v1/namespaces/default/pods/w")
        while "default/w" in side.registry.pods() and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        assert "default/w" not in side.registry.pods()
    finally:
        side.bridge.stop()
        side.close()


# --- the webhook ------------------------------------------------------------

WEBHOOK_PODS = [
    pod_obj("plain", shared()),
    pod_obj("whole", shared("1", "1")),
    pod_obj("two", shared("2", "2")),
    pod_obj("no-request", {C.POD_TPU_LIMIT: "1"}),
    pod_obj("gang", shared(**{C.POD_GROUP_NAME: "g",
                              C.POD_GROUP_HEADCOUNT: "2",
                              C.POD_GROUP_THRESHOLD: "1.0"})),
    pod_obj("partial", shared(**{C.POD_GROUP_NAME: "g",
                                 C.POD_GROUP_HEADCOUNT: "4",
                                 C.POD_GROUP_THRESHOLD: "0.5"})),
    pod_obj("other", {"app": "x"}),
    pod_obj("default-sched", shared(), scheduler="default-scheduler"),
    {"metadata": {"generateName": "gen-", "labels": shared()},
     "spec": {"containers": [
         {"name": "a", "env": [{"name": "X", "value": "1"}],
          "volumeMounts": [{"name": "v", "mountPath": "/v"}]},
         {"name": "b"}], "volumes": [{"name": "v"}]}},
]


@pytest.mark.parametrize("obj", WEBHOOK_PODS,
                         ids=lambda o: o["metadata"].get("name", "gen"))
def test_mutate_pod_gives_the_jax_patch(obj):
    patch = webhook.mutate_pod(copy.deepcopy(obj))
    assert patch == jwebhook.mutate_pod(copy.deepcopy(obj))
    assert webhook.mutate_pod(webhook.apply_json_patch(obj, patch)) == []


def test_a_malformed_label_is_denied_alike():
    bad = pod_obj("bad", {C.POD_TPU_REQUEST: "2", C.POD_TPU_LIMIT: "1"})
    review = {"apiVersion": "admission.k8s.io/v1",
              "kind": "AdmissionReview",
              "request": {"uid": "r1", "kind": {"kind": "Pod"},
                          "object": bad}}
    out = webhook.admission_response(review)
    assert out == jwebhook.admission_response(review)
    assert out["response"]["allowed"] is False


def test_the_downward_env_resolves_alike_against_a_bound_pod():
    obj = pod_obj("lm", shared())
    mutated = webhook.apply_json_patch(obj, webhook.mutate_pod(obj))
    assert mutated == jwebhook.apply_json_patch(obj, webhook.mutate_pod(obj))
    mutated["metadata"]["annotations"].update({
        C.POD_TPU_CHIP_ID: "GPU-x", C.POD_TPU_MEMORY: "1024",
        C.POD_MANAGER_PORT: "50051"})
    ctr = mutated["spec"]["containers"][0]
    env = webhook.resolve_downward_env(mutated, ctr)
    assert env == jwebhook.resolve_downward_env(mutated, ctr)
    assert env[C.ENV_POD_MANAGER_PORT] == "50051"
    assert env[C.ENV_VISIBLE_CHIPS] == "GPU-x"


def _post(port, review):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/mutate", method="POST",
        data=json.dumps(review).encode())
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.load(r)


def test_the_webhook_servers_answer_alike():
    servers = [webhook.WebhookServer(host="127.0.0.1").start(),
               jwebhook.WebhookServer(host="127.0.0.1").start()]
    try:
        for i, obj in enumerate(WEBHOOK_PODS):
            review = {"apiVersion": "admission.k8s.io/v1",
                      "kind": "AdmissionReview",
                      "request": {"uid": f"u{i}", "kind": {"kind": "Pod"},
                                  "object": obj}}
            mine, theirs = (_post(s.port, review) for s in servers)
            assert mine == theirs
            if mine["response"].get("patch"):
                patch = json.loads(base64.b64decode(
                    mine["response"]["patch"]))
                assert patch == webhook.mutate_pod(obj)
        garbage = {"request": {"uid": "g", "object": "not a pod"}}
        assert _post(servers[0].port, garbage) == _post(servers[1].port,
                                                        garbage)
    finally:
        for s in servers:
            s.stop()


# --- the CLIs ---------------------------------------------------------------

def _spawn(module, args):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.Popen([sys.executable, "-m", module, *args],
                            cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.mark.parametrize("cli", ["bridge", "webhook"])
def test_a_cli_stops_on_sigterm_right_after_ready(cli):
    """Signalled the moment it prints READY, each CLI exits 0; the
    webhook's line carries its port."""
    side = Side(PORT) if cli == "bridge" else None
    args = (["--service", f"http://127.0.0.1:{side.svc.port}",
             "--kube-api", side.api.url] if side else
            ["--port", "0"])
    try:
        for _ in range(2):
            proc = _spawn(f"kubeshare_tpu_torch.scheduler.{cli}", args)
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
            if cli == "webhook":
                assert int(line.split()[1]) > 0
    finally:
        if side:
            side.close()


def test_the_bridge_cli_binds_a_pod_from_the_watch():
    side = Side(PORT)
    proc = _spawn("kubeshare_tpu_torch.scheduler.bridge",
                  ["--service", f"http://127.0.0.1:{side.svc.port}",
                   "--kube-api", side.api.url])
    try:
        assert proc.stdout.readline().startswith("READY")
        side.create(pod_obj("cli", shared()))
        deadline = time.monotonic() + 20
        while (not side.api.pods["default/cli"]["spec"].get("nodeName")
               and time.monotonic() < deadline):
            time.sleep(0.05)
        assert side.api.pods["default/cli"]["spec"]["nodeName"]
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=20)
        side.close()
    assert rc == 0
