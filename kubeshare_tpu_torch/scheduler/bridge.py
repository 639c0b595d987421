"""Kubernetes pod-event bridge: the top of the control loop.

The port's copy of ``kubeshare_tpu/scheduler/bridge.py``.

The reference compiles its engine *into* kube-scheduler
(``cmd/kubeshare-scheduler/main.go:26-37``), so pod events arrive through
informers and decisions leave through the framework's Bind. The TPU-native
scheduler is a k8s-independent HTTP service (:mod:`.service`); this bridge
closes the loop around it:

- **watch** the API server for pods whose ``spec.schedulerName`` is ours
  (a plain chunked JSON-lines HTTP stream — no client library needed),
- **drive** ``POST /schedule`` / ``DELETE /pods`` on the scheduler service,
- **write back** the decision: annotations first (so ``fieldRef``-declared
  env resolves before the container starts), then the ``Binding``
  subresource — the reference's Reserve-annotate + Bind in-process steps
  (``pkg/scheduler/pod.go:348-476``, ``scheduler.go:589-614``).
- **replay**: on (re)start, already-bound pods found in the initial list
  are fed to ``POST /resync`` — the informer re-queue behavior of
  ``pod.go:47-78``.

Unlike the reference, no shadow-pod delete/recreate is needed for env
injection: the share parameters ride as annotations, and the pod template
exposes them via the downward API
(``env: valueFrom: fieldRef: metadata.annotations['sharedtpu/...']`` —
see ``doc/deploy.md``).

Everything is injectable for tests: point ``KubeClient`` at a fake API
server and ``ServiceClient`` at an in-process scheduler service.
"""

from __future__ import annotations

import json
import os
import random
import ssl
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

from .. import constants as C
from ..obs import metrics as obs_metrics
from ..utils.logger import get_logger

log = get_logger("bridge")

_SVC_RETRIES = obs_metrics.default_registry().counter(
    "kubeshare_service_client_retries_total",
    "ServiceClient HTTP attempts retried after a transient failure.",
    labels=("op",))

SCHEDULER_NAME = "kubeshare-tpu-scheduler"
SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


def _sa_path(name: str) -> str | None:
    path = os.path.join(SA_DIR, name)
    return path if os.path.exists(path) else None


class KubeClient:
    """Minimal API-server client: list / watch / annotate / bind.

    In-cluster defaults (service-account token + CA + the
    ``KUBERNETES_SERVICE_HOST`` env) apply when constructor args are
    omitted; tests pass an explicit plain-HTTP ``base_url``.
    """

    def __init__(self, base_url: str = "", token: str = "",
                 ca_file: str = "", timeout: float = 30.0):
        if not base_url:
            host = os.environ.get("KUBERNETES_SERVICE_HOST", "")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            if not host:
                raise RuntimeError(
                    "no --kube-api given and KUBERNETES_SERVICE_HOST unset")
            base_url = f"https://{host}:{port}"
        self.base_url = base_url.rstrip("/")
        if not token:
            tok_path = _sa_path("token")
            token = open(tok_path).read().strip() if tok_path else ""
        self.token = token
        self.timeout = timeout
        self._ctx = None
        if self.base_url.startswith("https"):
            ca = ca_file or _sa_path("ca.crt")
            self._ctx = (ssl.create_default_context(cafile=ca) if ca
                         else ssl.create_default_context())

    def _request(self, method: str, path: str, body: dict | None = None,
                 content_type: str = "application/json",
                 timeout: float | None = None):
        req = urllib.request.Request(self.base_url + path, method=method)
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        data = None
        if body is not None:
            data = json.dumps(body).encode()
            req.add_header("Content-Type", content_type)
        return urllib.request.urlopen(
            req, data=data, timeout=timeout or self.timeout,
            context=self._ctx)

    # -- reads ---------------------------------------------------------------

    def list_pods(self, scheduler_name: str) -> tuple[list[dict], str]:
        """All pods claiming *scheduler_name* + the list resourceVersion
        (the watch bookmark). ``spec.schedulerName`` is a supported pod
        field selector, so the server filters for us."""
        sel = urllib.parse.quote(f"spec.schedulerName={scheduler_name}")
        with self._request("GET", f"/api/v1/pods?fieldSelector={sel}") as r:
            obj = json.load(r)
        return (obj.get("items") or [],
                obj.get("metadata", {}).get("resourceVersion", ""))

    def watch_pods(self, scheduler_name: str, resource_version: str):
        """Yield ``(type, pod)`` watch events; returns when the server
        closes the stream (caller re-lists and re-watches)."""
        sel = urllib.parse.quote(f"spec.schedulerName={scheduler_name}")
        path = (f"/api/v1/pods?watch=1&fieldSelector={sel}"
                f"&allowWatchBookmarks=true")
        if resource_version:
            path += f"&resourceVersion={resource_version}"
        # A watch is long-lived by design: no read timeout beyond the
        # server's own (the caller loops on reconnect).
        with self._request("GET", path, timeout=3600.0) as resp:
            for line in resp:
                if not line.strip():
                    continue
                evt = json.loads(line)
                yield evt.get("type", ""), evt.get("object", {})

    # -- writes --------------------------------------------------------------

    def annotate(self, namespace: str, name: str,
                 annotations: dict[str, str]) -> None:
        body = {"metadata": {"annotations": annotations}}
        self._request(
            "PATCH", f"/api/v1/namespaces/{namespace}/pods/{name}",
            body=body, content_type="application/merge-patch+json").close()

    def get_pod(self, namespace: str, name: str) -> dict:
        with self._request(
                "GET", f"/api/v1/namespaces/{namespace}/pods/{name}") as r:
            return json.load(r)

    def delete_pod(self, namespace: str, name: str, uid: str = "") -> None:
        """Evict a pod (preemption). ``uid`` becomes a server-side
        precondition so a recreated same-name pod is never the one
        killed. 404 (already gone) and 409 (uid mismatch — the targeted
        incarnation is gone) both count as success.

        Without a ``uid`` the pod is read first and the DELETE carries
        the uid found, so no DELETE ever goes out unpreconditioned. The
        JAX client sends a bare DELETE then, which kills whatever pod
        holds the name, a newer one created under it included.
        """
        path = f"/api/v1/namespaces/{namespace}/pods/{name}"
        try:
            if not uid:
                uid = (self.get_pod(namespace, name).get("metadata")
                       or {}).get("uid", "")
                if not uid:
                    raise RuntimeError(
                        f"pod {namespace}/{name} has no uid to "
                        "precondition its delete on")
            self._request("DELETE", path,
                          body={"preconditions": {"uid": uid}}).close()
        except urllib.error.HTTPError as e:
            if e.code not in (404, 409):
                raise

    def bind(self, namespace: str, name: str, node: str,
             uid: str = "") -> None:
        body = {
            "apiVersion": "v1", "kind": "Binding",
            "metadata": {"name": name, "namespace": namespace},
            "target": {"apiVersion": "v1", "kind": "Node", "name": node},
        }
        if uid:
            body["metadata"]["uid"] = uid
        self._request(
            "POST", f"/api/v1/namespaces/{namespace}/pods/{name}/binding",
            body=body).close()


class ServiceClient:
    """HTTP client for :class:`.service.SchedulerService`.

    Transient transport failures (connection refused while the service
    restarts, socket timeouts) are retried with jittered backoff — the
    same counted idiom as ``RegistryClient`` — so a scheduler bounce
    mid-chaos does not fail watchers that could simply redial.  HTTP
    error *responses* are never retried: the service answered, and the
    schedule/resync bodies are idempotent only on the service side.

    **HA (doc/ha.md):** ``base_url`` may be a list (or comma-separated
    string) of scheduler endpoints — a primary/standby pair. Each
    transport failure rotates to the next endpoint before the backoff,
    so the bridge follows a takeover without reconfiguration (the
    deposed scheduler's frozen dispatcher still *answers*, it just
    parks pods — the 202 poll loop rides out the transition).
    ``schedule`` is the one non-idempotent op: it is only re-sent when
    the failure proves the request never reached a server (connection
    refused), never after an ambiguous timeout.
    """

    RETRY_ATTEMPTS = 3
    RETRY_BACKOFF_S = 0.05

    def __init__(self, base_url: str | list[str], timeout: float = 30.0,
                 seed: int | None = None):
        if isinstance(base_url, str):
            endpoints = base_url.split(",")
        else:
            endpoints = list(base_url)
        self._bases = [u.strip().rstrip("/") for u in endpoints
                       if u.strip()]
        if not self._bases:
            raise ValueError("ServiceClient needs at least one endpoint")
        self._idx = 0
        self.timeout = timeout
        self._rng = random.Random(seed)
        self._open = urllib.request.urlopen   # injectable for tests

    @property
    def base_url(self) -> str:
        """The currently preferred endpoint (back-compat accessor)."""
        return self._bases[self._idx]

    @staticmethod
    def _unambiguous(exc: Exception) -> bool:
        """True when the request provably never reached a server
        (connection refused) — the only transport failure a
        non-idempotent op may be resent after."""
        reason = getattr(exc, "reason", exc)
        return isinstance(reason, ConnectionRefusedError)

    def _call(self, method: str, path: str, body: dict | None = None,
              idempotent: bool = True) -> tuple[int, dict]:
        data = None
        if body is not None:
            data = json.dumps(body).encode()
        op = f"{method} /{path.strip('/').split('/')[0].split('?')[0]}"
        last_exc: Exception = OSError("unreachable")
        for attempt in range(self.RETRY_ATTEMPTS):
            if attempt:
                _SVC_RETRIES.inc(op)
                time.sleep(self.RETRY_BACKOFF_S * (2 ** (attempt - 1))
                           * (0.5 + self._rng.random()))
            req = urllib.request.Request(self.base_url + path,
                                         method=method)
            if data is not None:
                req.add_header("Content-Type", "application/json")
            try:
                # chaos drill: a partitioned/bounced service looks like
                # a transport failure (resilience/faults.py)
                from ..resilience import faults as _faults
                inj = _faults.active()
                if inj is not None and inj.should_drop_service_call():
                    raise OSError("injected service connection drop")
                with self._open(req, data=data,
                                timeout=self.timeout) as r:
                    return r.status, json.load(r)
            except urllib.error.HTTPError as e:
                try:
                    return e.code, json.load(e)
                except Exception:
                    return e.code, {"error": str(e)}
            except (urllib.error.URLError, OSError) as exc:
                last_exc = exc
                log.warning("service %s %s attempt %d/%d failed: %s",
                            method, path, attempt + 1,
                            self.RETRY_ATTEMPTS, exc)
                if not idempotent and not self._unambiguous(exc):
                    raise   # may have been received: never double-send
                if len(self._bases) > 1:
                    # rotate before the backoff: after a takeover the
                    # next endpoint is simply the live one (doc/ha.md)
                    self._idx = (self._idx + 1) % len(self._bases)
        raise last_exc

    def schedule(self, namespace: str, name: str, labels: dict,
                 uid: str = "") -> tuple[int, dict]:
        return self._call("POST", "/schedule",
                          {"namespace": namespace, "name": name,
                           "labels": labels, "uid": uid},
                          idempotent=False)

    def resync(self, namespace: str, name: str, labels: dict,
               annotations: dict, node: str, uid: str = "") -> tuple[int, dict]:
        return self._call("POST", "/resync",
                          {"namespace": namespace, "name": name,
                           "labels": labels, "annotations": annotations,
                           "node": node, "uid": uid})

    def evictions(self) -> list[dict]:
        code, body = self._call("GET", "/evictions")
        if code != 200:
            raise RuntimeError(f"/evictions returned {code}")
        return body.get("evictions", [])

    def health(self) -> dict:
        """Liveness snapshot (``GET /health``, doc/health.md)."""
        code, body = self._call("GET", "/health")
        if code != 200:
            raise RuntimeError(f"/health returned {code}")
        return body

    def autopilot(self) -> dict:
        """Autopilot snapshot (``GET /autopilot``, doc/autopilot.md);
        ``{"attached": false}`` when the plane is off, RuntimeError when
        the scheduler predates it."""
        code, body = self._call("GET", "/autopilot")
        if code != 200:
            raise RuntimeError(f"/autopilot returned {code}")
        return body

    def rightsize(self) -> dict:
        """Capacity-rightsizer snapshot (``GET /rightsize``,
        doc/autopilot.md Rightsizing); ``{"attached": false}`` when the
        plane is off, RuntimeError when the scheduler predates it."""
        code, body = self._call("GET", "/rightsize")
        if code != 200:
            raise RuntimeError(f"/rightsize returned {code}")
        return body

    def elastic(self) -> dict:
        """Elastic training-plane snapshot (``GET /elastic``,
        doc/elastic.md): per-gang mesh shape, last resize, pause
        percentiles; ``{"attached": false}`` when the plane is off,
        RuntimeError when the scheduler predates it."""
        code, body = self._call("GET", "/elastic")
        if code != 200:
            raise RuntimeError(f"/elastic returned {code}")
        return body

    def elastic_resize(self, gang: str, target_chips: int,
                       reason: str = "operator") -> tuple[int, dict]:
        """``POST /elastic/resize`` — returns (status, body); 409
        carries the refusal reason."""
        return self._call("POST", "/elastic/resize",
                          {"gang": gang, "target_chips": target_chips,
                           "reason": reason}, idempotent=False)

    def serving(self) -> dict:
        """Serving front-door join view (``GET /serving``,
        doc/serving.md); ``{"attached": false}`` when no front door is
        wired, RuntimeError when the scheduler predates it."""
        code, body = self._call("GET", "/serving")
        if code != 200:
            raise RuntimeError(f"/serving returned {code}")
        return body

    def invariants(self) -> dict:
        """Cluster-invariant snapshot (``GET /invariants``,
        doc/chaos.md): the chaos plane's catalog evaluated on the live
        engine. RuntimeError when the scheduler predates it."""
        code, body = self._call("GET", "/invariants")
        if code != 200:
            raise RuntimeError(f"/invariants returned {code}")
        return body

    def slo(self) -> dict:
        """Per-tenant SLO snapshot (``GET /slo``): objectives, burn
        rates, budget remaining, alert timeline. RuntimeError when the
        scheduler predates the SLO plane."""
        code, body = self._call("GET", "/slo")
        if code != 200:
            raise RuntimeError(f"/slo returned {code}")
        return body

    def flightrecorder(self) -> dict:
        """Flight-recorder summary + latest black-box dump
        (``GET /flightrecorder``)."""
        code, body = self._call("GET", "/flightrecorder")
        if code != 200:
            raise RuntimeError(f"/flightrecorder returned {code}")
        return body

    def decisions(self) -> dict:
        """Decision-recorder summary (``GET /decisions``,
        doc/replay.md): ring fill, per-kind decision counts, recent
        tail. RuntimeError when the scheduler predates the replay
        plane."""
        code, body = self._call("GET", "/decisions")
        if code != 200:
            raise RuntimeError(f"/decisions returned {code}")
        return body

    def gangs(self) -> dict:
        """Gang isolation plane snapshot (``GET /gangs``, doc/gang.md):
        membership, grant state, grant-wait percentiles per gang.
        RuntimeError when the scheduler predates the plane."""
        code, body = self._call("GET", "/gangs")
        if code != 200:
            raise RuntimeError(f"/gangs returned {code}")
        return body

    def ledger(self) -> dict:
        """Chip-time ledger + blame graph (``GET /ledger``,
        doc/observability.md): per-chip interval accounting and
        per-(victim, blamed, chip) wait attribution. RuntimeError when
        the scheduler predates the contention plane."""
        code, body = self._call("GET", "/ledger")
        if code != 200:
            raise RuntimeError(f"/ledger returned {code}")
        return body

    def prof(self) -> dict:
        """Runtime contention profiler snapshot (``GET /prof``,
        doc/observability.md "Locks, phases, and profiles"): ranked
        tracked-lock wait/hold table with holder sites, and dispatcher
        phase attribution with coverage. RuntimeError when the
        scheduler predates the profiler plane."""
        code, body = self._call("GET", "/prof")
        if code != 200:
            raise RuntimeError(f"/prof returned {code}")
        return body

    def ha(self) -> dict:
        """Control-plane HA snapshot (``GET /ha``, doc/ha.md):
        leadership role, lease epoch, takeover history, replication
        lag; ``{"attached": false}`` when the scheduler is not in an
        election, RuntimeError when it predates the HA plane."""
        code, body = self._call("GET", "/ha")
        if code != 200:
            raise RuntimeError(f"/ha returned {code}")
        return body

    def delete(self, namespace: str, name: str) -> tuple[int, dict]:
        return self._call("DELETE", f"/pods/{namespace}/{name}")

    def state(self) -> tuple[int, dict]:
        return self._call("GET", "/state")

    def status(self, namespace: str, name: str) -> tuple[int, dict]:
        return self._call("GET", f"/pods/{namespace}/{name}")


def pod_fields(pod: dict) -> dict:
    """The slice of a Pod object the bridge acts on."""
    meta = pod.get("metadata", {})
    spec = pod.get("spec", {})
    return {
        "namespace": meta.get("namespace", "default"),
        "name": meta.get("name", ""),
        "uid": meta.get("uid", ""),
        "labels": meta.get("labels") or {},
        "annotations": meta.get("annotations") or {},
        "node": spec.get("nodeName", ""),
        "scheduler": spec.get("schedulerName", ""),
        "deleting": bool(meta.get("deletionTimestamp")),
    }


class WatchExpired(RuntimeError):
    """The watch's resourceVersion aged out (410 Gone) — relist now."""


class PodEventBridge:
    """Convert pod events into scheduler-service calls and write back."""

    def __init__(self, service: ServiceClient, kube: KubeClient,
                 scheduler_name: str = SCHEDULER_NAME,
                 reconnect_s: float = 2.0, poll_s: float = 1.0):
        self.service = service
        self.kube = kube
        self.scheduler_name = scheduler_name
        self.reconnect_s = reconnect_s
        self.poll_s = poll_s
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        # pods we have already bound (or resynced) this incarnation, so a
        # MODIFIED echo of our own bind/annotate write is not re-scheduled
        self._settled: set[str] = set()
        # pods whose /schedule returned 202 (parked at the gang barrier /
        # unschedulable-retrying): the dispatcher's own loop will bind them
        # later with no pod event to wake us, so a poller watches their
        # status and performs the deferred write-back
        self._awaiting: dict[str, tuple[str, str, str]] = {}
        # (victim key, uid) pairs already deleted on the API this
        # incarnation (dedupe: the scheduler keeps requesting until it
        # OBSERVES the deletion). uid-qualified so a victim recreated
        # under the same name is evictable again if re-requested.
        self._evicted: set[tuple[str, str]] = set()

    # -- event handling ------------------------------------------------------

    def handle(self, etype: str, pod: dict) -> None:
        if etype == "ERROR":
            # The apiserver reports watch errors in-band as Status
            # objects; 410 Gone means our resourceVersion aged out of
            # etcd's window — the remaining stream is useless and only a
            # fresh LIST re-establishes a valid bookmark. Raise so run()
            # drops the stream and re-enters sync_once immediately
            # (client-go's reflector does the same relist).
            code = int(pod.get("code", 0) or 0)
            raise WatchExpired(f"watch ERROR event (code {code}): "
                               f"{pod.get('message', '')}")
        f = pod_fields(pod)
        if f["scheduler"] != self.scheduler_name or not f["name"]:
            return
        key = f"{f['namespace']}/{f['name']}"
        if etype == "DELETED" or f["deleting"]:
            self._settled.discard(key)
            self._awaiting.pop(key, None)
            self.service.delete(f["namespace"], f["name"])
            log.info("pod %s deleted → released", key)
            return
        if etype not in ("ADDED", "MODIFIED", ""):
            return  # BOOKMARK / ERROR: nothing to act on
        if f["node"]:
            # Already bound. Ours (has our cell annotation) and not yet
            # replayed this incarnation → resync; otherwise ignore.
            if key not in self._settled and C.POD_CELL_ID in f["annotations"]:
                self.service.resync(f["namespace"], f["name"], f["labels"],
                                    f["annotations"], f["node"], f["uid"])
                self._settled.add(key)
                log.info("pod %s already bound to %s → resynced",
                         key, f["node"])
            return
        if key in self._settled:
            return
        code, result = self.service.schedule(
            f["namespace"], f["name"], f["labels"], f["uid"])
        if code == 200:
            self._write_back(key, f["namespace"], f["name"], f["uid"],
                             result)
        elif code == 202:
            self._awaiting[key] = (f["namespace"], f["name"], f["uid"])
            log.info("pod %s pending: %s", key, result.get("reason", ""))
        else:
            log.warning("pod %s rejected (%d): %s", key, code,
                        result.get("error") or result.get("reason"))

    def _write_back(self, key: str, namespace: str, name: str, uid: str,
                    result: dict) -> None:
        # Annotate BEFORE bind: fieldRef env resolves when the kubelet
        # starts the container, which the bind triggers.
        self.kube.annotate(namespace, name, result.get("annotations", {}))
        self.kube.bind(namespace, name, result["node"], uid)
        self._settled.add(key)
        self._awaiting.pop(key, None)
        log.info("pod %s bound to %s", key, result["node"])

    def execute_evictions(self) -> None:
        """Carry out the dispatcher's preemption plans: delete each
        requested victim on the API server (a guarantee pod displacing
        opportunistic filler). The victim's DELETED watch event then
        releases its booking through the normal path, and the preemptor
        binds on a later dispatcher cycle. Deletes are deduped per
        incarnation by (victim, uid) — a recreated same-name victim is
        a new target; the request list itself converges server-side
        once the victim is observed gone.

        Known race (accepted; kube-scheduler preemption carries the
        same): a request CANCELLED after this fetch but before the
        delete lands still kills its victim. The window is one poll
        period, and victims are opportunistic filler — restartable by
        contract (priority <= 0)."""
        try:
            requests = self.service.evictions()
        except Exception as e:
            log.warning("eviction fetch failed: %s", e)
            return
        for req in requests:
            key = req.get("victim", "")
            ident = (key, req.get("uid", ""))
            if not key or ident in self._evicted:
                continue
            ns, _, name = key.partition("/")
            try:
                self.kube.delete_pod(ns, name, uid=req.get("uid", ""))
            except Exception as e:
                log.warning("eviction of %s failed (will retry): %s",
                            key, e)
                continue
            self._evicted.add(ident)
            log.info("evicted %s (preempted by %s)",
                     key, req.get("preemptor", "?"))
        # dedupe entries expire once the scheduler stops requesting them
        live = {(r.get("victim"), r.get("uid", "")) for r in requests}
        self._evicted &= live

    def poll_pending(self) -> None:
        """Write back pods the dispatcher bound after their 202: a gang
        member released by Permit (or an unschedulable retry that fit once
        capacity freed) generates no pod event, so polling is the only
        wake-up."""
        for key, (ns, name, uid) in list(self._awaiting.items()):
            try:
                code, st = self.service.status(ns, name)
            except Exception as e:
                log.warning("status poll of %s failed: %s", key, e)
                continue
            state = st.get("status") if code == 200 else None
            if state == "bound":
                self._write_back(key, ns, name, uid, st)
            elif state not in ("parked", "pending"):
                # terminal (rejected / deleted / unknown): stop polling —
                # a future MODIFIED event re-enters via handle()
                self._awaiting.pop(key, None)
                log.info("pod %s left the queue: %s", key, state)

    def sync_once(self) -> str:
        """List current pods, feed each through :meth:`handle`, and
        release engine bookings for pods that vanished while the watch
        was down; returns the resourceVersion to watch from.

        A pod deleted during a watch outage never yields a DELETED event,
        so the relist must converge by diffing the engine's live pod set
        against the API server's — the informer-resync behavior of the
        reference (``pkg/scheduler/pod.go:91-136``). The engine snapshot
        is taken BEFORE the list: a pod scheduled concurrently with the
        sync appears in the list but maybe not the snapshot (safe — not
        reaped), never the other way around.
        """
        engine_pods: set[str] | None = None
        last_err: Exception | None = None
        attempts = 3
        for attempt in range(attempts):
            try:
                code, st = self.service.state()
                if code == 200:
                    engine_pods = set(st.get("pods") or {})
                    break
                last_err = RuntimeError(f"/state returned {code}")
            except Exception as e:
                last_err = e
            if attempt < attempts - 1:  # no pointless sleep after last try
                time.sleep(0.5 * (attempt + 1))
        if engine_pods is None:
            # Defer the whole relist rather than degrade: proceeding with
            # an empty engine set would skip the deletion reconcile, and
            # pods deleted during the watch gap would stay booked until
            # the NEXT watch drop (the round-3 leak this path exists to
            # close). The run() loop retries after reconnect_s.
            raise RuntimeError(
                f"engine state unavailable ({last_err}); deferring relist")
        items, version = self.kube.list_pods(self.scheduler_name)
        listed = set()
        for pod in items:
            f = pod_fields(pod)
            if f["name"]:
                listed.add(f"{f['namespace']}/{f['name']}")
            try:
                self.handle("ADDED", pod)
            except Exception as e:
                log.warning("sync of %s failed: %s",
                            pod.get("metadata", {}).get("name"), e)
        for key in engine_pods - listed:
            ns, _, name = key.partition("/")
            try:
                self.service.delete(ns, name)
            except Exception as e:
                log.warning("reconcile delete of %s failed: %s", key, e)
                continue
            self._settled.discard(key)
            self._awaiting.pop(key, None)
            log.info("pod %s vanished during watch gap → released", key)
        return version

    # -- loop ----------------------------------------------------------------

    def run(self) -> None:
        """List+watch until :meth:`stop`; reconnects with a fixed backoff
        (a dropped watch is routine — the API server times streams out)."""
        while not self._stop.is_set():
            relist_now = False
            try:
                version = self.sync_once()
                for etype, obj in self.kube.watch_pods(
                        self.scheduler_name, version):
                    if self._stop.is_set():
                        return
                    try:
                        self.handle(etype, obj)
                    except WatchExpired as e:
                        # 410 Gone: the stream is dead — relist NOW for
                        # a fresh bookmark (no reconnect backoff: the
                        # server is healthy, only our version aged out —
                        # client-go's reflector relists immediately too)
                        log.info("watch expired: %s — relisting", e)
                        relist_now = True
                        break
                    except Exception as e:
                        log.warning("event %s failed: %s", etype, e)
            except Exception as e:
                log.warning("watch dropped: %s", e)
            if not relist_now:
                self._stop.wait(self.reconnect_s)

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            self.execute_evictions()
            self.poll_pending()

    def start(self) -> "PodEventBridge":
        self._threads = [
            threading.Thread(target=self.run, daemon=True,
                             name="pod-event-bridge"),
            threading.Thread(target=self._poll_loop, daemon=True,
                             name="pod-event-bridge-poll"),
        ]
        for t in self._threads:
            t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)


def main(argv=None) -> None:
    """The bridge CLI: prints ``READY`` with its signal handlers already in
    place (``utils.ready_until_signal``) and stops on SIGTERM or SIGINT."""
    import argparse

    from ..utils import ready_until_signal

    parser = argparse.ArgumentParser(
        prog="kubeshare_tpu_torch.scheduler.bridge")
    parser.add_argument("--service", required=True,
                        help="scheduler service base URL, e.g. "
                             "http://kubeshare-tpu-scheduler:9007; a "
                             "comma-separated list enables failover "
                             "across a primary/standby pair (doc/ha.md)")
    parser.add_argument("--kube-api", default="",
                        help="API server base URL (default: in-cluster env)")
    parser.add_argument("--scheduler-name", default=SCHEDULER_NAME)
    parser.add_argument("--once", action="store_true",
                        help="process the current pod list and exit "
                             "(no watch) — for debugging")
    args = parser.parse_args(argv)

    bridge = PodEventBridge(ServiceClient(args.service),
                            KubeClient(args.kube_api),
                            scheduler_name=args.scheduler_name)
    if args.once:
        bridge.sync_once()
        return
    bridge.start()
    try:
        ready_until_signal("READY")
    finally:
        bridge.stop()


if __name__ == "__main__":
    main()
