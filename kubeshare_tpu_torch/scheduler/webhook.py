"""Mutating admission webhook: the labels-only user contract.

The port's copy of ``kubeshare_tpu/scheduler/webhook.py``.

The reference's users write ``sharedgpu/`` labels + ``schedulerName`` and
nothing else (the reference's ``README.md:34-48``); env/volume injection
happens invisibly via the shadow-pod delete/recreate swap
(``pkg/scheduler/scheduler.go:515-528``, ``pod.go:348-476``). Recreating
pods churns UIDs and races controllers, so the TPU-native design keeps the
original pod and injects at *admission* instead: this webhook intercepts
pod CREATE, and for pods carrying ``sharedtpu/`` labels patches in

- ``spec.schedulerName`` (the user may omit even that),
- the downward-API env block that carries the binding (annotations the
  bridge writes BEFORE bind — ``scheduler/bridge.py:_write_back``) into
  the container,
- the kubeshare library hostPath volume + mount (≙ the reference's
  LD_PRELOAD library volume, ``pod.go:445-457``),
- gang identity env for coscheduled groups.

Malformed ``sharedtpu/`` labels are REJECTED here, at admission — the
user gets the validation error from ``kubectl apply`` instead of a pod
stuck Pending (the reference only logs it, ``pod.go:207-215``).

The server speaks the ``admission.k8s.io/v1`` AdmissionReview protocol
over HTTPS (cert/key from ``scripts/webhook-certs.sh``); tests drive the
pure :func:`mutate_pod` / :func:`admission_response` functions and a
plain-HTTP server instance directly.
"""

from __future__ import annotations

import base64
import copy
import http.server
import json
import ssl
import threading

from .. import constants as C
from ..utils.logger import get_logger
from .labels import LabelError, parse_pod_labels

log = get_logger("webhook")

VOLUME_NAME = "kubeshare-lib"


def _has_tpu_labels(labels: dict) -> bool:
    return any(k.startswith(C.DOMAIN) for k in labels)


def _env_entry(name: str, field_path: str) -> dict:
    return {"name": name,
            "valueFrom": {"fieldRef": {"fieldPath": field_path}}}


def injected_env(pr, labels: dict) -> list[dict]:
    """The downward-API env block for a parsed :class:`PodRequest`.

    Every ``fieldRef`` must resolve when the kubelet starts the container
    or it fails with CreateContainerConfigError — so annotation refs are
    emitted only when the engine is guaranteed to have written that
    annotation before bind (``engine.Binding.annotations``):
    ``tpu_chip_id``/``tpu_mem`` always; ``tpu_manager_port`` only for
    fractional (token-scheduled) pods; ``group_rank`` only for full
    gangs. Label refs only for labels the pod actually carries —
    ``tpu_request`` is optional (burst-only share defaults to 0), so an
    absent label gets a literal "0" instead of a dangling fieldRef.
    """
    env = [
        _env_entry(C.ENV_POD_NAME, "metadata.name"),
        _env_entry(C.ENV_VISIBLE_CHIPS,
                   f"metadata.annotations['{C.POD_TPU_CHIP_ID}']"),
        _env_entry(C.ENV_TPU_MEMORY,
                   f"metadata.annotations['{C.POD_TPU_MEMORY}']"),
    ]
    if 0.0 < pr.limit <= 1.0:
        # fractional share → pod manager + token runtime in the path
        env.append(_env_entry(
            C.ENV_POD_MANAGER_PORT,
            f"metadata.annotations['{C.POD_MANAGER_PORT}']"))
        if C.POD_TPU_REQUEST in labels:
            env.append(_env_entry(
                C.ENV_TPU_REQUEST,
                f"metadata.labels['{C.POD_TPU_REQUEST}']"))
        else:
            env.append({"name": C.ENV_TPU_REQUEST, "value": "0"})
        env.append(_env_entry(
            C.ENV_TPU_LIMIT, f"metadata.labels['{C.POD_TPU_LIMIT}']"))
    if pr.group_name:
        env.append(_env_entry(C.ENV_GROUP_NAME,
                              f"metadata.labels['{C.POD_GROUP_NAME}']"))
        if pr.min_available >= pr.headcount > 0:
            # FULL gangs only — partial gangs get no rank/size env
            # (engine.Binding.env:106-116 and its rationale)
            env += [
                _env_entry(C.ENV_NUM_PROCESSES,
                           f"metadata.labels['{C.POD_GROUP_HEADCOUNT}']"),
                _env_entry(C.ENV_PROCESS_ID,
                           f"metadata.annotations['{C.POD_GROUP_RANK}']"),
            ]
    return env


def mutate_pod(pod: dict, scheduler_name: str = C.SCHEDULER_NAME,
               library_path: str = C.LIBRARY_PATH) -> list[dict]:
    """Return the RFC-6902 JSONPatch that completes a labels-only pod.

    Raises :class:`LabelError` for malformed ``sharedtpu/`` labels (the
    caller turns that into an admission denial). Pods without TPU labels,
    and fields the user already set, are left untouched (idempotent —
    a re-applied fully-expanded pod gets an empty patch).
    """
    meta = pod.get("metadata") or {}
    labels = meta.get("labels") or {}
    if not _has_tpu_labels(labels):
        return []
    pr = parse_pod_labels(meta.get("namespace", "default"),
                          meta.get("name", "") or
                          meta.get("generateName", "pod"), labels)
    spec = pod.get("spec") or {}
    patch: list[dict] = []

    if not spec.get("schedulerName") or \
            spec.get("schedulerName") == "default-scheduler":
        patch.append({"op": "add" if "schedulerName" not in spec
                      else "replace",
                      "path": "/spec/schedulerName",
                      "value": scheduler_name})

    if not pr.needs_tpu:
        return patch  # group/priority labels only: no env/volume needed

    env_block = injected_env(pr, labels)
    for i, ctr in enumerate(spec.get("containers") or []):
        have = {e.get("name") for e in (ctr.get("env") or [])}
        missing = [e for e in env_block if e["name"] not in have]
        if "env" not in ctr:
            patch.append({"op": "add", "path": f"/spec/containers/{i}/env",
                          "value": missing})
        else:
            patch += [{"op": "add",
                       "path": f"/spec/containers/{i}/env/-", "value": e}
                      for e in missing]
        mounts = {m.get("name") for m in (ctr.get("volumeMounts") or [])}
        if VOLUME_NAME not in mounts:
            mount = {"name": VOLUME_NAME, "mountPath": library_path}
            if "volumeMounts" not in ctr:
                patch.append({"op": "add",
                              "path": f"/spec/containers/{i}/volumeMounts",
                              "value": [mount]})
            else:
                patch.append({"op": "add",
                              "path": f"/spec/containers/{i}/volumeMounts/-",
                              "value": mount})

    volumes = {v.get("name") for v in (spec.get("volumes") or [])}
    if VOLUME_NAME not in volumes:
        vol = {"name": VOLUME_NAME, "hostPath": {"path": library_path}}
        if "volumes" not in spec:
            patch.append({"op": "add", "path": "/spec/volumes",
                          "value": [vol]})
        else:
            patch.append({"op": "add", "path": "/spec/volumes/-",
                          "value": vol})
    return patch


def resolve_downward_env(pod: dict, container: dict) -> dict[str, str]:
    """Materialize a container's downward-API env from the pod object —
    what the kubelet does at container start. Tests use it to prove that
    every fieldRef this webhook injects resolves against a bound pod.
    Raises :class:`KeyError` for a fieldRef to a missing label/annotation
    (the kubelet's CreateContainerConfigError)."""
    meta = pod.get("metadata") or {}
    out: dict[str, str] = {}
    for e in container.get("env") or []:
        if "value" in e:
            out[e["name"]] = e["value"]
            continue
        ref = (e.get("valueFrom") or {}).get("fieldRef") or {}
        path = ref.get("fieldPath", "")
        if path == "metadata.name":
            out[e["name"]] = meta.get("name", "")
        elif path == "metadata.namespace":
            out[e["name"]] = meta.get("namespace", "")
        elif path.startswith("metadata.labels['"):
            out[e["name"]] = (meta.get("labels") or {})[path[17:-2]]
        elif path.startswith("metadata.annotations['"):
            out[e["name"]] = (meta.get("annotations") or {})[path[22:-2]]
        elif path:
            raise KeyError(f"unsupported fieldPath {path!r}")
    return out


def apply_json_patch(obj: dict, patch: list[dict]) -> dict:
    """Apply the add/replace subset of RFC 6902 this webhook emits —
    used by tests and the fake API server to mirror what a real
    apiserver would do with the returned patch."""
    out = copy.deepcopy(obj)
    for op in patch:
        parts = [p.replace("~1", "/").replace("~0", "~")
                 for p in op["path"].lstrip("/").split("/")]
        tgt = out
        for p in parts[:-1]:
            tgt = tgt[int(p)] if isinstance(tgt, list) else tgt[p]
        last = parts[-1]
        if isinstance(tgt, list):
            if last == "-":
                tgt.append(op["value"])
            elif op["op"] == "add":
                tgt.insert(int(last), op["value"])
            else:
                tgt[int(last)] = op["value"]
        else:
            tgt[last] = op["value"]
    return out


def admission_response(review: dict,
                       scheduler_name: str = C.SCHEDULER_NAME) -> dict:
    """AdmissionReview request → AdmissionReview response (v1)."""
    req = review.get("request") or {}
    uid = req.get("uid", "")
    resp: dict = {"uid": uid, "allowed": True}
    pod = req.get("object") or {}
    if (req.get("kind") or {}).get("kind", "Pod") == "Pod":
        try:
            patch = mutate_pod(pod, scheduler_name=scheduler_name)
        except LabelError as e:
            resp = {"uid": uid, "allowed": False,
                    "status": {"code": 422, "message": f"sharedtpu: {e}"}}
            patch = []
        if patch:
            resp["patchType"] = "JSONPatch"
            resp["patch"] = base64.b64encode(
                json.dumps(patch).encode()).decode()
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "response": resp}


class _Handler(http.server.BaseHTTPRequestHandler):
    server_version = "kubeshare-tpu-webhook"

    def log_message(self, fmt, *args):  # route through our logger
        log.debug(fmt, *args)

    def _reply(self, code: int, body: dict) -> None:
        data = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if self.path.startswith("/healthz"):
            self._reply(200, {"ok": True})
        else:
            self._reply(404, {"error": "not found"})

    def do_POST(self):
        if not self.path.startswith("/mutate"):
            self._reply(404, {"error": "not found"})
            return
        # Recover the request uid BEFORE the fallible work: an error
        # reply whose uid does not echo the request's is itself rejected
        # by the apiserver as a webhook failure — which would turn this
        # intended denial into whatever failurePolicy says.
        uid = ""
        try:
            n = int(self.headers.get("Content-Length", "0"))
            review = json.loads(self.rfile.read(n))
            uid = str((review.get("request") or {}).get("uid", ""))
            self._reply(200, admission_response(
                review, scheduler_name=self.server.scheduler_name))
        except Exception as e:  # malformed review: deny, never crash
            log.warning("mutate failed: %s", e)
            self._reply(200, {
                "apiVersion": "admission.k8s.io/v1",
                "kind": "AdmissionReview",
                "response": {"uid": uid, "allowed": False,
                             "status": {"code": 400, "message": str(e)}}})


class WebhookServer(http.server.ThreadingHTTPServer):
    """The admission server. HTTPS when cert/key given (production —
    the API server refuses plain-HTTP webhooks); HTTP for tests."""

    daemon_threads = True

    def __init__(self, host: str = "0.0.0.0", port: int = 0,
                 cert_file: str = "", key_file: str = "",
                 scheduler_name: str = C.SCHEDULER_NAME):
        super().__init__((host, port), _Handler)
        self.scheduler_name = scheduler_name
        if cert_file:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(cert_file, key_file or cert_file)
            self.socket = ctx.wrap_socket(self.socket, server_side=True)
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self.server_address[1]

    def start(self) -> "WebhookServer":
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True, name="webhook")
        self._thread.start()
        return self

    def stop(self) -> None:
        self.shutdown()
        self.server_close()
        if self._thread:
            self._thread.join(timeout=5.0)


def main(argv=None) -> None:
    """The webhook CLI: prints ``READY <port>`` (so ``--port 0`` can be
    used) with its signal handlers already in place
    (``utils.ready_until_signal``) and stops on SIGTERM or SIGINT."""
    import argparse

    from ..utils import ready_until_signal

    parser = argparse.ArgumentParser(
        prog="kubeshare_tpu_torch.scheduler.webhook")
    parser.add_argument("--port", type=int, default=9008)
    parser.add_argument("--cert", default="",
                        help="TLS cert (PEM); required in-cluster")
    parser.add_argument("--key", default="", help="TLS key (PEM)")
    parser.add_argument("--scheduler-name", default=C.SCHEDULER_NAME)
    args = parser.parse_args(argv)

    server = WebhookServer(port=args.port, cert_file=args.cert,
                           key_file=args.key,
                           scheduler_name=args.scheduler_name)
    server.start()
    log.info("admission webhook on :%d (%s)", server.port,
             "https" if args.cert else "http")
    try:
        ready_until_signal(f"READY {server.port}")
    finally:
        server.stop()


if __name__ == "__main__":
    main()
