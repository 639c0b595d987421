"""The scheduler as a deployable service.

The port's copy of ``kubeshare_tpu/scheduler/service.py``.

The reference compiles its engine into a full kube-scheduler binary
(``cmd/kubeshare-scheduler/main.go:26-37``); the TPU-native engine is
k8s-independent, so the deployable unit is this HTTP service wrapped
around the :class:`~.dispatcher.Dispatcher` — the enforcing loop that
owns the Less-ordered queue, the gang Permit barrier with
timeout-unreserve, the unschedulable retry backoff, the 30 s group GC,
and the startup replay of bound pods from the registry.

API (JSON):

- ``POST /schedule``  {"namespace","name","labels"{,"uid"}} → one
  synchronous scheduling attempt:
  200 bound (annotations + env) · 202 parked at the gang barrier or
  pending with the unschedulable reason (poll ``GET /pods/...``) ·
  409 rejected (bad labels / gang rejection)
- ``GET  /pods/<ns>/<name>``  current disposition of a pod
- ``POST /resync``    {"namespace","name","labels","annotations","node"}
- ``DELETE /pods/<ns>/<name>``
- ``GET  /state``     engine snapshot (nodes, leaves, pods)
- ``GET  /health``    per-node liveness states + shed/evicted totals
  (doc/health.md; empty when the health plane is off)
- ``GET  /autopilot`` fragmentation score + move/credit state
  (doc/autopilot.md; ``{"attached": false, "enabled": false}`` when the
  plane is off)
- ``POST /autopilot/plan``   dry-run: emit a migration plan, touch nothing
- ``POST /autopilot/apply``  plan + execute one cycle (409 when detached)
- ``GET  /elastic``   elastic training plane: per-gang mesh, last resize,
  pause percentiles, cooldowns (doc/elastic.md; detached as above)
- ``POST /elastic/resize``  {"gang","target_chips"{,"reason"}} → 200
  applied or noop, 409 refused / rolled back / detached
- ``GET  /rightsize`` SLO-driven capacity rightsizer state: per-tenant
  burn vs budget, current/proposed shares, chip-equivalents
  (doc/autopilot.md, Rightsizing; detached as above)
- ``POST /rightsize/plan``   dry-run: emit a resize plan, touch nothing
- ``POST /rightsize/apply``  plan + execute one cycle (409 when detached)
- ``GET  /serving``   serving front-door join view: per-tenant queues,
  admit/shed totals, batch stats (doc/serving.md; ``{"attached":
  false}`` when no front door is wired)
- ``GET  /slo``       per-tenant objectives, burn rates, budget remaining,
  and the alert event timeline (doc/observability.md, SLO plane)
- ``GET  /flightrecorder``  flight-recorder summary + the latest black-box
  dump (always-on bounded ring; dumped on alert/eviction/crash triggers)
- ``GET  /gangs``     gang isolation plane: every bound gang's membership,
  grant state, and grant-wait percentiles (doc/gang.md)
- ``GET  /ledger``    chip-time ledger + blame graph: per-chip interval
  accounting and per-(victim, blamed, chip) wait attribution
  (doc/observability.md, contention attribution)
- ``GET  /preempt``   preemption plane: policy config + enforcement stats
  (preemptions fired, quantum reclaimed, gang preemptions; ``attached:
  false`` until a policy is wired — doc/isolation-wire.md)
- ``GET  /ha``        control-plane HA: leadership role, lease epoch,
  takeover history, frozen state, replication lag (doc/ha.md;
  ``attached: false`` when this service is not in an election)
- ``GET  /decisions`` decision-recorder summary (doc/replay.md)
- ``GET  /decisions/trace`` the recorder's whole ring as a decision trace
  (JSONL, what ``replay.replay_trace`` and ``topcli --replay-diff``
  read); the port's own: the JAX service serves only the summary
- ``GET  /evictions`` outstanding preemption eviction requests
- ``GET  /healthz``

Overload shedding: with ``max_pending`` set, ``POST /schedule`` answers
**429** with the typed reason ("max-pending" hard cap or "fair-share"
per-namespace) when the bounded admission queue refuses the pod.

The creator of a gang member is NOT blocked while the gang forms (the
reference's Permit blocks a scheduler goroutine, never the pod's
creator): ``/schedule`` returns 202 for a parked member and the caller
polls — or simply keeps submitting the rest of the gang.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..obs import flight as obs_flight
from ..obs import prof as obs_prof
from ..obs import slo as obs_slo
from ..telemetry.aggregator import sync_engine_from_registry
from ..telemetry.registry import RegistryClient, TelemetryRegistry
from ..utils.logger import get_logger
from .dispatcher import Dispatcher, Overloaded
from .engine import SchedulerEngine, Unschedulable
from .healthwatch import HealthWatch
from .labels import LabelError

log = get_logger("schedsvc")

class SchedulerService:
    def __init__(self, engine: SchedulerEngine,
                 registry: RegistryClient | TelemetryRegistry,
                 replay: bool = True, healthwatch=None,
                 shards: int = 1, shard_route: str = "cell",
                 **dispatcher_kw):
        """``healthwatch``: None/False = no liveness plane (pre-health
        behavior); True = a default :class:`HealthWatch` over
        ``registry``; or pass a configured instance.

        ``shards > 1`` runs the sharded plane (doc/sharding.md): the
        fleet is synced from the registry once, carved into subtree
        shards, and served through a
        :class:`~.shard.ShardedDispatcher` behind the same endpoints
        (``self.engine`` becomes the merged fleet façade).  Per-shard
        registry capacity sync is off in this mode — the subtree
        inventory is fixed at build time."""
        self.engine = engine
        self.registry = registry
        self.shards = max(1, int(shards))
        if self.shards > 1:
            from .shard import build_sharded

            try:
                sync_engine_from_registry(engine, registry)
            except Exception as e:
                log.warning("sharded build: initial fleet sync "
                            "failed: %s", e)
            fleet = {}
            for node, models in engine.chips_by_node.items():
                chips = sorted((c for cs in models.values() for c in cs),
                               key=lambda c: c.chip_id)
                fleet[node] = (chips,
                               engine.node_health.get(node, True))
            self.dispatcher = build_sharded(
                fleet, self.shards, route=shard_route,
                registry=registry, **dispatcher_kw)
            self.engine = self.dispatcher.engine
        else:
            self.dispatcher = Dispatcher(
                engine, registry,
                sync=lambda: sync_engine_from_registry(engine, registry),
                **dispatcher_kw)
        if healthwatch is True:
            healthwatch = HealthWatch(registry)
        self.healthwatch: HealthWatch | None = healthwatch or None
        if self.healthwatch is not None:
            self.dispatcher.attach_healthwatch(self.healthwatch)
        # the SLO plane is always on (like the flight recorder): with no
        # declared objectives evaluation is a no-op over an empty dict
        self.slo = obs_slo.default_evaluator()
        self.dispatcher.attach_slo(self.slo)
        # contention attribution plane (doc/observability.md): the
        # process-global chip-time ledger + blame graph back GET /ledger
        # and topcli --why; always on, empty until hooks feed them
        from ..obs.blame import default_blame
        from ..obs.ledger import default_ledger
        self.ledger = default_ledger()
        self.blame = default_blame()
        # gang isolation plane (doc/gang.md): the dispatcher publishes
        # every bound gang's membership here; with no gangs the
        # coordinator is an empty snapshot
        from ..gang import GangTokenCoordinator
        self.gangcoord = GangTokenCoordinator(ledger=self.ledger)
        self.dispatcher.attach_gang_coordinator(self.gangcoord)
        # preemption plane (..preempt): None until attach_preempt, and
        # GET /preempt reports detached
        self.preempt = None
        # decision flight recorder (doc/replay.md): always on, like the
        # SLO plane — every placement decision this service makes is a
        # replayable trace on GET /decisions
        from ..obs.decisions import default_decisions
        self.decisions = default_decisions()
        self.dispatcher.attach_decisions(self.decisions)
        self._replay = replay
        self._server: ThreadingHTTPServer | None = None
        self.serving = None
        self.remote_write = None
        # control-plane HA (doc/ha.md): None until attach_standby —
        # GET /ha reports detached and no fencing is applied
        self.standby = None
        self._ha_thread: threading.Thread | None = None
        self._ha_stop = threading.Event()
        # the autopilot, rightsize and elastic planes: None until
        # attached, and their GETs answer detached
        self.autopilot = None
        self.rightsizer = None
        self.elastic = None

    def start_remote_write(self, instance: str | None = None,
                           job: str = "scheduler",
                           period_s: float | None = None):
        """Begin pushing this service's full exposition (scheduler
        gauges + process obs registry) to the registry's fleet TSDB.
        Works against both a ``RegistryClient`` and an in-process
        ``TelemetryRegistry`` (tests, sim)."""
        from ..telemetry.remote_write import (DEFAULT_PUSH_PERIOD_S,
                                              RemoteWriter)
        if instance is None:
            instance = (f"127.0.0.1:{self.port}" if self._server is not None
                        else "scheduler")
        self.remote_write = RemoteWriter(
            self.registry, instance, job,
            period_s=period_s or DEFAULT_PUSH_PERIOD_S,
            collect=self.render_metrics).start()
        return self.remote_write

    def attach_serving(self, frontdoor) -> "SchedulerService":
        """Wire a serving :class:`~..serving.FrontDoor` (doc/serving.md);
        exposes its join view on ``/serving``."""
        self.serving = frontdoor
        return self

    def attach_autopilot(self, autopilot) -> "SchedulerService":
        """Wire an :class:`~..autopilot.Autopilot` built over
        ``self.dispatcher`` (doc/autopilot.md); exposes it on
        ``/autopilot``."""
        self.autopilot = autopilot
        return self

    def attach_rightsize(self, rightsizer) -> "SchedulerService":
        """Wire a :class:`~..rightsize.Rightsizer` built over
        ``self.dispatcher`` (doc/autopilot.md, Rightsizing); exposes it
        on ``/rightsize``."""
        self.rightsizer = rightsizer
        return self

    def attach_elastic(self, orchestrator) -> "SchedulerService":
        """Wire an :class:`~..elastic.ElasticOrchestrator` built over
        ``self.dispatcher`` (doc/elastic.md); exposes it on ``/elastic``
        (GET = snapshot, POST /elastic/resize)."""
        self.elastic = orchestrator
        return self

    def attach_standby(self, holder: str, ttl_s: float = 5.0,
                       resync_period_s: float | None = None,
                       resync_source=None) -> "SchedulerService":
        """Join the ``leader:scheduler`` election (doc/ha.md). The
        dispatcher freezes until this service holds the lease: a primary
        simply acquires first and renews; a warm standby re-syncs its
        engine on a cadence and takes over at the next epoch when the
        lease expires. ``serve()`` starts the election thread; under a
        virtual clock drive ``self.standby.step(now)`` directly."""
        from ..ha import WarmStandby

        self.standby = WarmStandby(
            self.dispatcher, self.registry, holder, ttl_s=ttl_s,
            resync_period_s=resync_period_s, resync_source=resync_source,
            decisions=self.decisions)
        return self

    def attach_preempt(self, policy) -> "SchedulerService":
        """Wire a :class:`~..preempt.PreemptionPolicy`: the gang
        coordinator starts preempting lower-class gangs, and
        ``GET /preempt`` exposes the policy config + enforcement
        stats."""
        self.preempt = policy
        self.gangcoord.preempt = policy
        policy.decisions = self.decisions
        return self

    # -- operations --------------------------------------------------------

    def schedule(self, namespace: str, name: str, labels: dict,
                 uid: str = "") -> tuple[int, dict]:
        """Submit + one synchronous dispatch attempt. Returns
        (http_status, body)."""
        try:
            key = self.dispatcher.submit(namespace, name, labels, uid=uid)
        except Overloaded as e:
            return 429, {"status": "overloaded", "reason": e.reason,
                         "message": str(e)}
        self.dispatcher.step()
        status = self.dispatcher.status(key)
        state = status.get("status")
        if state == "bound":
            return 200, status
        if state in ("parked", "pending"):
            return 202, status
        if state == "overloaded":
            return 429, status
        return 409, status

    def pod_status(self, key: str) -> dict:
        return self.dispatcher.status(key)

    def delete(self, key: str) -> None:
        self.dispatcher.delete(key)

    def resync(self, namespace: str, name: str, labels: dict,
               annotations: dict, node: str, uid: str = "") -> None:
        self.dispatcher.resync(namespace, name, labels, annotations, node,
                               uid=uid)

    def state(self) -> dict:
        eng = self.engine
        with self.dispatcher.lock:  # the loop thread mutates continuously
            return self._state_locked(eng)

    def health(self) -> dict:
        """Liveness view for ``GET /health`` / ``kubeshare-top --health``."""
        d = self.dispatcher
        with d.lock:
            nodes = (self.healthwatch.snapshot(d._clock())
                     if self.healthwatch is not None else {})
            return {
                "enabled": self.healthwatch is not None,
                "nodes": nodes,
                "quarantined": sorted(self.engine.health_veto),
                "evicted_total": (self.healthwatch.evicted_total
                                  if self.healthwatch else 0),
                "shed_total": d.shed_total,
                "pending": len(d._pending),
                "max_pending": d.max_pending,
            }

    @staticmethod
    def detached_state() -> dict:
        """The body of a detached plane's GET (``/autopilot``,
        ``/rightsize``, ``/elastic``)."""
        return {"attached": False, "enabled": False}

    def autopilot_state(self) -> dict:
        """``GET /autopilot`` body; cheap when no autopilot is wired."""
        if self.autopilot is None:
            return self.detached_state()
        return self.autopilot.snapshot()

    def rightsize_state(self) -> dict:
        """``GET /rightsize`` body; cheap when no rightsizer is wired."""
        if self.rightsizer is None:
            return self.detached_state()
        return self.rightsizer.snapshot()

    def elastic_state(self) -> dict:
        """``GET /elastic`` body; cheap when no orchestrator is wired."""
        if self.elastic is None:
            return self.detached_state()
        return self.elastic.snapshot()

    def serving_state(self) -> dict:
        """``GET /serving`` body; cheap when no front door is wired."""
        if self.serving is None:
            return {"attached": False}
        return self.serving.state()

    def slo_state(self) -> dict:
        """``GET /slo`` body: objectives, burn rates, alert timeline."""
        return self.slo.state(now=self.dispatcher._clock())

    def invariants_state(self) -> dict:
        """``GET /invariants`` body: the chaos plane's cluster-invariant
        catalog evaluated on the live engine (doc/chaos.md) plus, when a
        front door is wired, the serving exactly-once ledger."""
        snap = self.dispatcher.invariant_snapshot()
        if self.serving is not None:
            from ..chaos import invariants as chaos_inv

            serving = chaos_inv.check_serving_exactly_once(self.serving)
            snap["checked"].append("serving-exactly-once")
            snap["violations"].extend(serving)
            snap["ok"] = snap["ok"] and not serving
        return snap

    def gangs_state(self) -> dict:
        """``GET /gangs`` body: every registered gang's membership,
        grant state, and grant-wait percentiles (doc/gang.md)."""
        snap = self.gangcoord.snapshot()
        snap["attached"] = True
        snap["count"] = len(snap["gangs"])
        return snap

    def ledger_state(self) -> dict:
        """``GET /ledger`` body: per-chip time accounting (current
        state, per-state sums, recent intervals) plus the blame graph's
        wait-attribution edges (doc/observability.md)."""
        snap = self.ledger.snapshot()
        snap["attached"] = True
        snap["blame"] = self.blame.state()
        return snap

    def preempt_state(self) -> dict:
        """``GET /preempt`` body: policy config + enforcement stats
        (preemptions fired, quantum reclaimed, gang preemptions), or
        ``attached: false`` when no policy is wired."""
        if self.preempt is None:
            return {"attached": False}
        snap = self.preempt.snapshot()
        snap["attached"] = True
        return snap

    def prof_state(self) -> dict:
        """``GET /prof`` body: per-lock wait/hold table + holder sites,
        dispatcher phase attribution with coverage, enabled flag
        (doc/observability.md, "Locks, phases, and profiles")."""
        snap = obs_prof.snapshot()
        snap["attached"] = True
        return snap

    def flightrecorder_state(self) -> dict:
        """``GET /flightrecorder`` body: ring summary + latest dump."""
        rec = obs_flight.default_recorder()
        state = rec.state()
        state["last"] = rec.last_dump()
        return state

    def decisions_state(self) -> dict:
        """``GET /decisions`` body: decision-recorder summary — ring
        fill, per-kind counts, recent tail (doc/replay.md)."""
        return self.decisions.state()

    def decisions_trace(self) -> str:
        """``GET /decisions/trace`` body: the recorder's ring as a
        decision trace (``obs.decisions.trace_jsonl``)."""
        from ..obs.decisions import trace_jsonl

        return trace_jsonl(self.decisions)

    def ha_state(self) -> dict:
        """``GET /ha`` body: leadership role, lease epoch, takeover
        history, frozen state (doc/ha.md); ``attached: false`` when this
        service is not in an election. Includes the registry's
        replication status when it exposes one."""
        if self.standby is None:
            return {"attached": False,
                    "frozen": bool(getattr(self.dispatcher, "frozen",
                                           False))}
        st = self.standby.state()
        repl = (getattr(self.registry, "replication_status", None)
                or getattr(self.registry, "replication", None))
        if repl is not None:
            try:
                st["replication"] = repl()
            except Exception as e:
                st["replication"] = {"error": str(e)}
        return st

    def render_metrics(self) -> str:
        """Scheduler-side Prometheus exposition (the reference's only
        scheduler observability is log lines; SURVEY §5). Complements the
        registry's load-bearing tpu_capacity/tpu_requirement families.
        Appends the process-wide obs registry (phase latencies, queue
        waits, bind latency, requeues) so one scrape sees everything."""
        from ..obs.metrics import render_default, render_help_type
        obs_prof.sync_metrics()   # flush lock/phase accumulators first
        d = self.dispatcher
        with d.lock:
            lines = [
                *render_help_type("kubeshare_scheduler_pending_pods", "gauge",
                                  "Pods in the Less-ordered pending queue."),
                f"kubeshare_scheduler_pending_pods {len(d._pending)}",
                *render_help_type("kubeshare_scheduler_parked_pods", "gauge",
                                  "Pods parked at the gang Permit barrier."),
                f"kubeshare_scheduler_parked_pods {len(d._parked)}",
                *render_help_type("kubeshare_scheduler_bound_pods", "gauge",
                                  "Pods currently bound to a node."),
                "kubeshare_scheduler_bound_pods "
                f"{sum(1 for p in self.engine.pod_status.values() if p.node_name)}",
                *render_help_type("kubeshare_scheduler_nodes", "gauge",
                                  "Nodes known to the scheduler engine."),
                f"kubeshare_scheduler_nodes {len(self.engine.chips_by_node)}",
                *render_help_type("kubeshare_scheduler_topology_rebuilds_total",
                                  "counter",
                                  "Cell-tree rebuilds triggered by capacity "
                                  "changes."),
                "kubeshare_scheduler_topology_rebuilds_total "
                f"{self.engine.rebuild_count}",
            ]
        if self.standby is not None:
            # HA gauges only exist once an election is joined — the
            # exposition stays byte-identical with HA off (doc/ha.md)
            lead = self.standby.lead
            lines += [
                *render_help_type("kubeshare_ha_leader", "gauge",
                                  "1 when this scheduler holds the "
                                  "leader:scheduler lease, else 0."),
                f"kubeshare_ha_leader {1 if lead.is_leader else 0}",
                *render_help_type("kubeshare_ha_epoch", "gauge",
                                  "Leadership epoch fencing this "
                                  "scheduler's registry writes."),
                f"kubeshare_ha_epoch {lead.epoch}",
                # takeovers are already counted by the obs registry
                # (kubeshare_ha_takeovers_total{domain=...}) — only the
                # gauges that need live standby state are hand-rendered
                *render_help_type(
                    "kubeshare_ha_last_takeover_timestamp_seconds",
                    "gauge",
                    "Scheduler-clock time of the last takeover "
                    "(0 = never)."),
                "kubeshare_ha_last_takeover_timestamp_seconds "
                f"{self.standby.last_takeover_ts}",
            ]
        return "\n".join(lines) + "\n" + render_default()

    @staticmethod
    def _state_locked(eng: SchedulerEngine) -> dict:
        return {
            "nodes": eng.nodes,
            "leaves": {cid: {"available": leaf.available,
                             "free_memory": leaf.free_memory,
                             "healthy": leaf.healthy}
                       for cid, leaf in eng.leaf_cells.items()},
            "pods": {key: {"node": p.node_name, "request": p.request,
                           "limit": p.limit, "memory": p.memory,
                           "chips": p.chip_ids, "port": p.port}
                     for key, p in eng.pod_status.items()},
        }

    # -- HTTP --------------------------------------------------------------

    def serve(self, host: str = "127.0.0.1",
              port: int = 0) -> ThreadingHTTPServer:
        # startup order matters: capacity first, bound-pod replay second,
        # only then the enforcement loop + new decisions (pod.go:47-78)
        if self._replay:
            try:
                sync_engine_from_registry(self.engine, self.registry)
                self.dispatcher.replay_bound()
            except Exception as e:
                log.warning("startup replay skipped: %s", e)
        self.dispatcher.start()
        if self.standby is not None and self._ha_thread is None:
            # election cadence well inside the lease TTL (the ttl/3
            # heartbeater rule) so a healthy leader never lapses
            period = max(0.2, self.standby.lead.ttl_s / 3.0)

            def _ha_loop():
                while not self._ha_stop.wait(period):
                    try:
                        self.standby.step()
                    except Exception:
                        log.exception("ha election step failed")

            self._ha_thread = threading.Thread(
                target=_ha_loop, daemon=True, name="ha-election")
            self._ha_thread.start()
        svc = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                log.debug("http: " + fmt, *args)

            def _reply(self, code: int, obj) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self) -> dict:
                length = int(self.headers.get("Content-Length", "0"))
                return json.loads(self.rfile.read(length) or b"{}")

            def do_GET(self):
                if self.path == "/healthz":
                    return self._reply(200, {"ok": True})
                if self.path in ("/metrics", "/decisions/trace"):
                    trace = self.path == "/decisions/trace"
                    body = (svc.decisions_trace() if trace
                            else svc.render_metrics()).encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/x-ndjson" if trace
                                     else "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if self.path == "/state":
                    return self._reply(200, svc.state())
                if self.path == "/health":
                    return self._reply(200, svc.health())
                if self.path == "/autopilot":
                    return self._reply(200, svc.autopilot_state())
                if self.path == "/elastic":
                    return self._reply(200, svc.elastic_state())
                if self.path == "/rightsize":
                    return self._reply(200, svc.rightsize_state())
                if self.path == "/serving":
                    return self._reply(200, svc.serving_state())
                if self.path == "/slo":
                    return self._reply(200, svc.slo_state())
                if self.path == "/flightrecorder":
                    return self._reply(200, svc.flightrecorder_state())
                if self.path == "/invariants":
                    return self._reply(200, svc.invariants_state())
                if self.path == "/gangs":
                    return self._reply(200, svc.gangs_state())
                if self.path == "/ledger":
                    return self._reply(200, svc.ledger_state())
                if self.path == "/preempt":
                    return self._reply(200, svc.preempt_state())
                if self.path == "/prof":
                    return self._reply(200, svc.prof_state())
                if self.path == "/decisions":
                    return self._reply(200, svc.decisions_state())
                if self.path == "/ha":
                    return self._reply(200, svc.ha_state())
                if self.path == "/evictions":
                    return self._reply(
                        200, {"evictions": svc.dispatcher.evictions()})
                parts = self.path.strip("/").split("/")
                if len(parts) == 3 and parts[0] == "pods":
                    return self._reply(
                        200, svc.pod_status(f"{parts[1]}/{parts[2]}"))
                self._reply(404, {"error": "not found"})

            def do_POST(self):
                try:
                    body = self._body()
                    if self.path == "/schedule":
                        code, result = svc.schedule(
                            body["namespace"], body["name"],
                            body.get("labels", {}), body.get("uid", ""))
                        return self._reply(code, result)
                    if self.path == "/resync":
                        svc.resync(body["namespace"], body["name"],
                                   body.get("labels", {}),
                                   body.get("annotations", {}),
                                   body.get("node", ""),
                                   body.get("uid", ""))
                        return self._reply(200, {"ok": True})
                    if self.path == "/autopilot/plan":
                        if svc.autopilot is None:
                            return self._reply(
                                409, {"error": "autopilot not attached"})
                        return self._reply(200,
                                           {"plan": svc.autopilot.plan()})
                    if self.path == "/autopilot/apply":
                        if svc.autopilot is None:
                            return self._reply(
                                409, {"error": "autopilot not attached"})
                        return self._reply(200, svc.autopilot.cycle())
                    if self.path == "/rightsize/plan":
                        if svc.rightsizer is None:
                            return self._reply(
                                409, {"error": "rightsizer not attached"})
                        return self._reply(
                            200, {"plan": svc.rightsizer.plan()})
                    if self.path == "/rightsize/apply":
                        if svc.rightsizer is None:
                            return self._reply(
                                409, {"error": "rightsizer not attached"})
                        return self._reply(200, svc.rightsizer.cycle())
                    if self.path == "/elastic/resize":
                        if svc.elastic is None:
                            return self._reply(
                                409, {"error": "elastic not attached"})
                        out = svc.elastic.resize(
                            body["gang"], int(body["target_chips"]),
                            reason=body.get("reason", "operator"))
                        code = (200 if out.get("outcome")
                                in ("applied", "noop") else 409)
                        return self._reply(code, out)
                except (LabelError, Unschedulable) as e:
                    return self._reply(409, {"error": str(e)})
                except Exception as e:
                    log.error("request failed: %s", e)
                    return self._reply(500, {"error": str(e)})
                self._reply(404, {"error": "not found"})

            def do_DELETE(self):
                parts = self.path.strip("/").split("/")
                if len(parts) == 3 and parts[0] == "pods":
                    svc.delete(f"{parts[1]}/{parts[2]}")
                    return self._reply(200, {"ok": True})
                self._reply(404, {"error": "not found"})

        server = ThreadingHTTPServer((host, port), Handler)
        server.daemon_threads = True
        threading.Thread(target=server.serve_forever, daemon=True,
                         name="scheduler-service").start()
        self._server = server
        log.info("scheduler service on %s:%d", *server.server_address[:2])
        return server

    @property
    def port(self) -> int:
        assert self._server is not None
        return self._server.server_address[1]

    def close(self) -> None:
        if self._ha_thread is not None:
            self._ha_stop.set()
            self._ha_thread.join(timeout=5.0)
            self._ha_thread = None
        if self.standby is not None and self.standby.lead.is_leader:
            # graceful handoff: drop the lease now so a standby takes
            # over at the next tick instead of waiting out the TTL
            try:
                self.standby.lead.resign()
            except Exception:
                log.exception("leadership resign on close failed")
        if self.remote_write is not None:
            self.remote_write.stop()
            self.remote_write = None
        if self.serving is not None and self.serving.batcher is not None:
            # graceful drain: ship every admitted serving request before
            # the dispatcher goes away — SIGTERM must not strand riders
            try:
                self.serving.batcher.flush()
            except Exception:
                log.exception("serving drain on close failed")
        self.dispatcher.stop()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


def main(argv=None) -> None:
    """The service CLI. It prints ``READY <port>`` once it serves, with
    its signal handlers already in place (``utils.ready_until_signal``;
    the JAX CLI installs them after its ``READY``), and stops on SIGTERM
    or SIGINT."""
    import argparse

    from ..topology.cellconfig import load_config
    from ..utils import ready_until_signal
    from .configwatch import ConfigWatcher

    parser = argparse.ArgumentParser(
        prog="kubeshare_tpu_torch.scheduler.service")
    from .. import constants as C

    parser.add_argument("--registry-host", default="127.0.0.1",
                        help="registry endpoint; a comma-separated "
                             "host[:port] list enables client failover "
                             "across replicas (doc/ha.md)")
    parser.add_argument("--registry-port", type=int,
                        default=C.REGISTRY_PORT)
    parser.add_argument("--port", type=int, default=C.SCHEDULER_PORT)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--max-pending", type=int, default=0,
                        help="bounded admission queue: shed new pods past "
                             "this many pending (0 = unbounded)")
    parser.add_argument("--health", action="store_true",
                        help="enable the lease-driven health plane "
                             "(detection -> eviction -> reschedule)")
    parser.add_argument("--shards", type=int, default=1,
                        help="cell-keyed scheduler shards (doc/"
                             "sharding.md): >1 partitions the fleet "
                             "into N subtree shards with per-shard "
                             "queues/locks behind the same endpoints "
                             "(1 = the single-lock dispatcher)")
    parser.add_argument("--shard-route", default="cell",
                        choices=("cell", "score"),
                        help="with --shards>1: 'cell' = per-subtree "
                             "placement with spillover + cross-shard "
                             "gangs (the throughput mode); 'score' = "
                             "global score walk, placement-identical "
                             "to single-lock (the migration mode)")
    parser.add_argument("--lease-ttl", type=float, default=C.LEASE_TTL_S,
                        help="heartbeat lease TTL the healthwatch assumes "
                             "for nodes that did not declare one")
    parser.add_argument("--config", default="",
                        help="optional topology YAML (auto-derived from "
                             "discovery when omitted); the file is watched "
                             "and the process exits on change for a clean "
                             "rebuild (config.go:122-136 parity)")
    parser.add_argument("--autopilot", action="store_true",
                        help="attach the autopilot plane: /autopilot "
                             "snapshot + explicit plan/apply endpoints "
                             "(doc/autopilot.md)")
    parser.add_argument("--autopilot-budget", type=int, default=8,
                        help="autopilot per-cycle migration budget")
    parser.add_argument("--autopilot-journal", default="",
                        help="JSONL move journal path (crash-safe batch "
                             "recovery); empty = no journal")
    parser.add_argument("--rightsize", action="store_true",
                        help="attach the SLO-driven capacity rightsizer: "
                             "/rightsize snapshot + plan/apply endpoints "
                             "(doc/autopilot.md, Rightsizing)")
    parser.add_argument("--rightsize-journal", default="",
                        help="JSONL resize journal path; empty = no "
                             "journal")
    parser.add_argument("--elastic", action="store_true",
                        help="attach the elastic SPMD training plane: "
                             "live gang sub-mesh grow/shrink on "
                             "/elastic + /elastic/resize "
                             "(doc/elastic.md)")
    parser.add_argument("--elastic-journal", default="",
                        help="elastic resize JSONL journal path (the "
                             "crash-recovery commit log); empty = no "
                             "journal")
    parser.add_argument("--elastic-grow", action="store_true",
                        help="with --rightsize and --elastic: let the "
                             "rightsizer propose whole-chip gang grows "
                             "through the elastic plane (off by "
                             "default)")
    parser.add_argument("--flight-dump-dir", default="",
                        help="persist flight-recorder black-box dumps as "
                             "JSONL files here (in-memory only when empty)")
    parser.add_argument("--flight-dump-cap", type=int,
                        default=obs_flight.MAX_DUMP_FILES,
                        help="max flight-*.jsonl files kept under "
                             "--flight-dump-dir (oldest pruned by mtime)")
    parser.add_argument("--no-remote-write", action="store_true",
                        help="do not push this process's metrics to the "
                             "registry fleet TSDB")
    parser.add_argument("--push-period", type=float, default=5.0,
                        help="remote-write push period in seconds")
    parser.add_argument("--preempt", action="store_true",
                        help="attach the preemption plane: latency-class "
                             "requests preempt best-effort holders past "
                             "grace (gang-atomic for gangs); /preempt "
                             "exposes config + enforcement stats")
    parser.add_argument("--prof", dest="prof", action="store_true",
                        default=True,
                        help="runtime contention profiler: tracked "
                             "locks + dispatcher phase attribution on "
                             "/prof (default on, bounded overhead — "
                             "doc/observability.md)")
    parser.add_argument("--no-prof", dest="prof", action="store_false",
                        help="disable the contention profiler (tracked "
                             "locks drop to delegated acquire/release)")
    parser.add_argument("--preempt-grace-ms", type=float, default=None,
                        help="how long a latency-class request waits "
                             "behind a lower-class holder before it is "
                             "preempted (default: policy default)")
    parser.add_argument("--ha-holder", default="",
                        help="join the leader:scheduler election under "
                             "this holder name (doc/ha.md): the "
                             "dispatcher freezes until this process "
                             "holds the lease and takes over with "
                             "epoch-fenced binds when it expires "
                             "(empty = HA off, pre-HA behavior)")
    parser.add_argument("--ha-ttl", type=float, default=5.0,
                        help="leadership lease TTL in seconds; the "
                             "election is stepped at ttl/3")
    parser.add_argument("--ha-resync-period", type=float, default=None,
                        help="standby warm-resync period in seconds "
                             "(default: the lease TTL)")
    args = parser.parse_args(argv)

    if args.flight_dump_dir:
        obs_flight.default_recorder().set_dump_dir(args.flight_dump_dir)
        obs_flight.default_recorder().set_dump_retention(args.flight_dump_cap)
    obs_prof.set_enabled(args.prof)
    # an unhandled exception dumps the black box before the process dies
    obs_flight.install_crash_handler()

    config = load_config(args.config) if args.config else None
    engine = SchedulerEngine(config=config)
    endpoints = [h.strip() for h in args.registry_host.split(",")
                 if h.strip()]
    registry = RegistryClient(
        endpoints if len(endpoints) > 1 else endpoints[0],
        args.registry_port)
    svc = SchedulerService(
        engine, registry,
        healthwatch=(HealthWatch(registry, ttl_s=args.lease_ttl)
                     if args.health else None),
        max_pending=args.max_pending or None,
        shards=args.shards, shard_route=args.shard_route)
    planner = rebalancer = None
    cooldowns = None
    if args.autopilot or args.rightsize or args.elastic:
        # the cooldown rail is SHARED: a pod the autopilot just moved
        # must not be immediately resized or elastically re-homed, and
        # vice versa — one ledger (and one planner / one journaled
        # rebalancer) backs all three planes
        from ..autopilot import CooldownLedger

        cooldowns = CooldownLedger()
    if args.autopilot or args.rightsize:
        from ..autopilot import Planner, Rebalancer

        planner = Planner(svc.dispatcher, budget=args.autopilot_budget,
                          cooldowns=cooldowns)
        rebalancer = Rebalancer(svc.dispatcher, planner=planner,
                                journal_path=(args.autopilot_journal
                                              or None),
                                gang_coordinator=svc.gangcoord)
    if args.autopilot:
        from ..autopilot import Autopilot

        svc.attach_autopilot(Autopilot(
            svc.dispatcher, planner=planner, rebalancer=rebalancer))
    if args.elastic:
        from ..elastic import ElasticOrchestrator

        svc.attach_elastic(ElasticOrchestrator(
            svc.dispatcher, gang_coordinator=svc.gangcoord,
            cooldowns=cooldowns,
            journal_path=(args.elastic_journal or None)))
    if args.rightsize:
        from ..rightsize import RightsizeConfig, Rightsizer

        cfg = RightsizeConfig(
            elastic_grow=bool(args.elastic_grow and args.elastic))
        svc.attach_rightsize(Rightsizer(
            svc.dispatcher, slo=svc.slo, ledger=svc.ledger,
            blame=svc.blame, planner=planner, rebalancer=rebalancer,
            gang_coordinator=svc.gangcoord, cfg=cfg,
            cooldowns=cooldowns, elastic=svc.elastic,
            journal_path=(args.rightsize_journal or None)))
    if args.preempt:
        from ..preempt import PreemptionPolicy

        kwargs = ({} if args.preempt_grace_ms is None
                  else {"grace_ms": args.preempt_grace_ms})
        svc.attach_preempt(PreemptionPolicy(**kwargs))
    if args.ha_holder:
        svc.attach_standby(args.ha_holder, ttl_s=args.ha_ttl,
                           resync_period_s=args.ha_resync_period)
    svc.serve(args.host, args.port)
    if not args.no_remote_write:
        svc.start_remote_write(period_s=args.push_period)
    watcher = ConfigWatcher(args.config).start() if args.config else None
    try:
        ready_until_signal(f"READY {svc.port}")
    finally:
        if watcher:
            watcher.stop()
        svc.close()


if __name__ == "__main__":
    main()
