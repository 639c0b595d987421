"""Deterministic chaos orchestration: nemesis + oracle + stopwatch.

The port's copy of ``kubeshare_tpu/chaos/orchestrator.py``.

:class:`ChaosRunner` replays a :class:`~.scenarios.Scenario` against a
*real* control plane — engine, dispatcher, registry (with an on-disk
journal), autopilot, serving front door + batcher — advanced on a
virtual clock in fixed ticks, so the same ``(scenario, seed)`` always
produces the identical timeline, invariant samples, and MTTR.  This is
the engine behind ``sim --chaos`` (doc/chaos.md).

Per scenario the runner:

1. executes the fault timeline, stepping the dispatcher and batcher on
   every tick and sampling the invariant catalog between fault windows;
2. after the last fault, drives the cluster until it **reconverges**
   (no pending/parked pods, serving queues drained, invariants clean)
   or the scenario's ``converge_bound_s`` expires;
3. records MTTR = convergence time − fault-window end, plus every
   invariant violation with its virtual timestamp.
"""

from __future__ import annotations

import os
import tempfile
from collections import deque

from . import invariants
from .scenarios import ChaosAction, Scenario, all_scenarios, build

#: virtual-time step; every plane is advanced once per tick
TICK_S = 0.05
#: invariant sampling period during fault windows
SAMPLE_EVERY_S = 0.5
#: heartbeat period for the synthetic node agents
LEASE_EVERY_S = 0.5


class _PartitionedRegistry:
    """Registry wrapper the dispatcher publishes through: while the
    partition window is open every call fails with ``OSError`` — the
    same face a real partition shows ``RegistryClient`` — so binding
    publishes exercise their rollback path."""

    def __init__(self, runner):
        self._runner = runner

    def __getattr__(self, name):
        inner = getattr(self._runner.registry, name)
        if not callable(inner):
            return inner

        def call(*a, **kw):
            if self._runner.partitioned():
                raise OSError("chaos: registry partitioned")
            return inner(*a, **kw)

        return call


class _LiveRegistry:
    """Registry proxy that always resolves the runner's CURRENT
    registry object — after a ``registry_leader_kill`` promotes the
    follower, every plane holding this proxy is already failed over
    (the virtual-time collapse of ``RegistryClient``'s multi-endpoint
    rotation)."""

    def __init__(self, runner):
        self._runner = runner

    def __getattr__(self, name):
        return getattr(self._runner.registry, name)


class _HaPlane:
    """In-process control-plane HA under the nemesis (doc/ha.md): a
    follower registry tailing the primary's op-stream, a warm-standby
    scheduler on the un-partitioned side, and epoch-fenced leadership
    for both dispatchers.  The registry partition window applies to the
    PRIMARY scheduler only — the standby and the replication stream
    live on the healthy side, which is exactly the asymmetric partition
    the fencing protocol exists for."""

    LEASE_TTL_S = 1.5

    def __init__(self, runner):
        from ..ha import ReplicationFollower, WarmStandby
        from ..scheduler import SchedulerEngine
        from ..scheduler.dispatcher import Dispatcher
        from ..telemetry.aggregator import sync_engine_from_registry
        from ..telemetry.registry import TelemetryRegistry

        self.runner = runner
        # takeover reconstruction reads capacity -> bound pods from the
        # registry, so the fleet must be on the bus first (in a real
        # deployment the collectors already put it there)
        eng = runner.disp.engine
        for node, models in sorted(eng.chips_by_node.items()):
            chips = sorted((c for chips_ in models.values()
                            for c in chips_), key=lambda c: c.chip_id)
            runner.registry.put_capacity(
                node, [c.to_labels() for c in chips],
                healthy=bool(eng.node_health.get(node, True)))
        self.follower_journal = os.path.join(runner.workdir,
                                             "follower.jsonl")
        self.follower = TelemetryRegistry(journal=self.follower_journal,
                                          clock=runner._clock)
        self.repl = ReplicationFollower(
            self.follower, _LiveRegistry(runner), leader_hint="primary",
            poll_s=TICK_S, clock=runner._clock)
        live = _LiveRegistry(runner)
        self.standby_engine = SchedulerEngine(clock=runner._clock)
        self.standby_disp = Dispatcher(
            self.standby_engine, registry=live, clock=runner._clock,
            sync=lambda: sync_engine_from_registry(self.standby_engine,
                                                   live),
            name="standby")
        self.primary_ha = WarmStandby(
            runner.disp, _PartitionedRegistry(runner), "primary",
            ttl_s=self.LEASE_TTL_S, clock=runner._clock,
            resync_period_s=0.5)
        self.standby_ha = WarmStandby(
            self.standby_disp, live, "standby",
            ttl_s=self.LEASE_TTL_S, clock=runner._clock,
            resync_period_s=0.5)
        self.silenced_until = -1.0
        self.promoted = False

    def tick(self, now: float) -> None:
        if now >= self.silenced_until:
            self.runner.disp.step(now)
            self.primary_ha.step(now)
        if not self.promoted:
            self.repl.step(now)
        self.standby_ha.step(now)
        self.standby_disp.step(now)
        self._drain_failover()

    def _drain_failover(self) -> None:
        """The bridge model: pods queued on a frozen dispatcher are
        resubmitted to the current leader — the informer replay a real
        control plane gets for free from the API server (the pods still
        exist there; only their scheduler died)."""
        runner = self.runner
        for src, dst, dst_ha in (
                (runner.disp, self.standby_disp, self.standby_ha),
                (self.standby_disp, runner.disp, self.primary_ha)):
            if not getattr(src, "frozen", False) \
                    or not dst_ha.lead.is_leader:
                continue
            with src.lock:
                keys = [k for k in src._pending
                        if k in runner._submitted]
            for key in keys:
                ns, name, labels = runner._submitted[key]
                src.delete(key)
                try:
                    dst.submit(ns, name, dict(labels))
                except Exception:
                    pass    # duplicate/raced resubmit — the next drain


class _CrashableServable:
    """LocalServable that hard-fails inside the crash window — the
    virtual-time stand-in for a proxy ``kill -9`` mid-batch.  Riders
    must fail loudly and stay accounted (serving-exactly-once)."""

    batch_size = 8

    def __init__(self, runner):
        self._runner = runner
        self.crashed_until = -1.0

    def execute(self, x):
        if self._runner.now < self.crashed_until:
            raise ConnectionResetError("chaos: servable crashed")
        return x * 2.0

    def close(self):
        pass


class ChaosRunner:
    """One scenario run over a real in-process control plane."""

    def __init__(self, seed: int = 0, workdir: str | None = None,
                 hosts: int = 2, mesh: tuple = (2, 2),
                 shards: int = 1, shard_route: str = "cell"):
        from ..scheduler import SchedulerEngine
        from ..scheduler.dispatcher import Dispatcher
        from ..scheduler.shard import make_dispatcher
        from ..serving.batcher import ContinuousBatcher
        from ..serving.frontdoor import FrontDoor
        from ..telemetry.registry import TelemetryRegistry
        from ..topology.discovery import FakeTopology

        self.seed = int(seed)
        self.now = 0.0
        if workdir is None:
            self._tmp = tempfile.TemporaryDirectory(prefix="chaos-")
            workdir = self._tmp.name
        self.workdir = workdir
        self.registry_journal = os.path.join(workdir, "registry.jsonl")
        self.autopilot_journal = os.path.join(workdir, "autopilot.jsonl")
        self.registry = TelemetryRegistry(journal=self.registry_journal,
                                          clock=self._clock)
        self._partition_until = -1.0
        self.shards = max(1, int(shards))
        by_host: dict = {}
        for chip in FakeTopology(hosts=hosts, mesh=mesh).chips():
            by_host.setdefault(chip.host, []).append(chip)
        self.nodes = sorted(by_host)
        if self.shards > 1:
            # the sharded plane under the same nemesis: per-subtree
            # engines behind the fleet façade, cell routing by default
            # so spillover + the cross-shard gang protocol get faulted
            self.disp = make_dispatcher(
                {h: list(c) for h, c in sorted(by_host.items())},
                shards=self.shards, route=shard_route,
                registry=_PartitionedRegistry(self), clock=self._clock)
            self.engine = self.disp.engine
        else:
            self.engine = SchedulerEngine(clock=self._clock)
            for host, chips in sorted(by_host.items()):
                self.engine.add_node(host, chips)
            self.disp = Dispatcher(self.engine,
                                   registry=_PartitionedRegistry(self),
                                   clock=self._clock)
        self.fd = FrontDoor(clock=self._clock)
        self.servable = _CrashableServable(self)
        self.batcher = ContinuousBatcher(self.fd, self.servable,
                                         max_wait_s=0.05,
                                         clock=self._clock)
        from ..gang import GangTokenCoordinator

        from ..obs.ledger import ChipTimeLedger

        self.autopilot = None
        self.rightsizer = None       # built lazily on rightsize_apply
        self.elastic = None          # built lazily on resize_gang
        self._synth_end: dict = {}   # synthetic ledger chip -> last end
        self.preempt = None          # PreemptionPolicy once preempt_on
        self.token_scheds: dict = {}
        # per-run chip-time ledger on the virtual clock: every mirrored
        # TokenScheduler and the coordinator feed it, and _sample checks
        # its conservation property (doc/observability.md)
        self.ledger = ChipTimeLedger(clock=self._clock)
        # virtual-clock coordinator: auto_drive (non-blocking step per
        # tick), used_scale 1.0 because the schedulers share the same
        # virtual-seconds clock
        self.gangcoord = GangTokenCoordinator(
            reserve_window_s=4 * TICK_S, backoff_base_s=TICK_S,
            backoff_max_s=4 * TICK_S, clock=self._clock, used_scale=1.0,
            auto_hold_s=TICK_S, ledger=self.ledger)
        self.gangcoord.auto_drive = True
        self.disp.attach_gang_coordinator(self.gangcoord)
        self.parked: dict[str, dict] = {}        # tenant -> manifest
        #: HA plane (ha_enable action): follower registry + standby
        #: scheduler + leadership for both dispatchers (doc/ha.md)
        self.ha: _HaPlane | None = None
        #: every submitted pod's (ns, name, labels) — the failover
        #: drain's stand-in for the API server's pod store
        self._submitted: dict[str, tuple] = {}
        self._serve_results: list = []
        self._lease_epoch = 0
        self._next_lease = 0.0
        self._deferred: deque = deque()          # flap-expanded actions
        self.timeline: list[dict] = []
        self.violations: list[dict] = []
        self.samples = 0

    # -- clocks + fault state -------------------------------------------

    def _clock(self) -> float:
        return self.now

    def partitioned(self) -> bool:
        return self.now < self._partition_until

    @property
    def active_disp(self):
        """The dispatcher currently holding ``leader:scheduler`` —
        submits route here and convergence/invariants are judged on it
        (without HA it is always the primary)."""
        if self.ha is not None and self.ha.standby_ha.lead.is_leader:
            return self.ha.standby_disp
        return self.disp

    @property
    def active_engine(self):
        return self.active_disp.engine

    # -- action execution -----------------------------------------------

    def _note(self, action: ChaosAction) -> None:
        self.timeline.append(dict(action.to_dict(),
                                  applied_at=round(self.now, 3)))

    def _apply(self, act: ChaosAction) -> None:
        from .. import constants as C

        self._note(act)
        p = act.params
        if act.action == "submit":
            prefix = p.get("prefix", "pod")
            ns = p.get("namespace", "chaos")
            labels = {C.POD_TPU_REQUEST: str(p.get("request", 0.5)),
                      C.POD_TPU_LIMIT: "1.0"}
            for i in range(int(p.get("count", 1))):
                self._submit(ns, f"{prefix}{i}", dict(labels))
        elif act.action == "submit_gang":
            labels = {C.POD_TPU_REQUEST: str(p.get("request", 0.5)),
                      C.POD_TPU_LIMIT: "1.0",
                      C.POD_GROUP_NAME: p["name"],
                      C.POD_GROUP_HEADCOUNT: str(p["headcount"]),
                      C.POD_GROUP_THRESHOLD: "1.0"}
            if p.get("class"):
                labels[C.POD_CLASS] = p["class"]
            for i in range(int(p["headcount"])):
                self._submit("chaos", f"{p['name']}-{i}", dict(labels))
        elif act.action == "delete_prefix":
            with self.disp.lock:
                keys = [k for k, pod in self.engine.pod_status.items()
                        if pod.name.startswith(act.target)]
            for k in keys:
                self.disp.delete(k)
        elif act.action == "node_down":
            with self.disp.lock:
                self.engine.veto_health(act.target, True)
                self.engine.set_node_health(act.target, False)
            self.disp.evict_node(act.target, self.now,
                                 reason="chaos: node down")
        elif act.action == "node_up":
            with self.disp.lock:
                self.engine.veto_health(act.target, False)
                self.engine.set_node_health(act.target, True)
        elif act.action == "flap":
            period = float(p.get("period_s", 0.5))
            at = act.at_s
            for i in range(int(p.get("count", 3))):
                self._deferred.append(ChaosAction(
                    at + (2 * i) * period, "node_down", act.target))
                self._deferred.append(ChaosAction(
                    at + (2 * i + 1) * period, "node_up", act.target))
        elif act.action == "shard_commit_fail":
            # arm the sharded plane's mid-commit failure injection: the
            # NEXT cross-shard gang commit dies after `at` members — a
            # no-op on the single-lock dispatcher (no cross-shard
            # commits exist to fail)
            if hasattr(self.disp, "fail_commit_at"):
                self.disp.fail_commit_at = int(p.get("at", 1))
        elif act.action == "registry_restart":
            self._restart_registry()
        elif act.action == "ha_enable":
            self.ha = _HaPlane(self)
        elif act.action == "leader_silence":
            # the primary scheduler stops entirely (process freeze):
            # no steps, no lease renewals — the standby's takeover clock
            self.ha.silenced_until = self.now + float(
                p.get("duration_s", 3.0))
        elif act.action == "registry_leader_kill":
            self._registry_leader_kill()
        elif act.action == "registry_partition":
            self._partition_until = self.now + float(
                p.get("duration_s", 1.0))
        elif act.action == "autopilot_apply":
            self._autopilot_cycle()
        elif act.action == "ledger_idle":
            self._ledger_idle(act.target or "chaos",
                              duration_s=float(p.get("duration_s", 4.0)),
                              active_frac=float(
                                  p.get("active_frac", 0.1)))
        elif act.action == "rightsize_apply":
            self._rightsize_cycle()
        elif act.action == "resize_gang":
            gang = (act.target if "/" in act.target
                    else f"chaos/{act.target}")
            self._elastic_resize(gang, int(p["target_chips"]))
        elif act.action == "preempt_on":
            from ..preempt import PreemptionPolicy

            kwargs = {}
            if "grace_ms" in p:
                kwargs["grace_ms"] = float(p["grace_ms"])
            self.preempt = PreemptionPolicy(**kwargs)
            self.gangcoord.preempt = self.preempt
            if "hold_s" in p:
                # stretch gang auto-holds past the reserve window so a
                # blocked latency gang actually reaches its grace bound
                self.gangcoord.auto_hold_s = float(p["hold_s"])
            for sched in self.token_scheds.values():
                sched.preempt = self.preempt
        elif act.action == "serve_submit":
            self._serve_submit(p.get("tenant", "t0"),
                               int(p.get("count", 1)))
        elif act.action == "servable_crash":
            self.servable.crashed_until = self.now + float(
                p.get("duration_s", 1.0))
        elif act.action == "park":
            manifest = self.fd.park(act.target)
            self.parked[act.target] = manifest
        elif act.action == "resume":
            manifest = self.parked.pop(act.target, None)
            if manifest is not None:
                self.fd.resume(manifest, now=self.now)
        else:
            raise ValueError(f"unknown chaos action {act.action!r}")

    def _submit(self, ns: str, name: str, labels: dict) -> None:
        self._submitted[f"{ns}/{name}"] = (ns, name, dict(labels))
        self.active_disp.submit(ns, name, labels)

    def _restart_registry(self) -> None:
        from ..telemetry.registry import TelemetryRegistry

        if self.registry._journal is not None:
            self.registry._journal.close()   # flush before the "restart"
        self.violations.extend(
            dict(v, at_s=round(self.now, 3)) for v in
            invariants.check_registry_replay_idempotent(
                self.registry_journal))
        self.registry = TelemetryRegistry(journal=self.registry_journal,
                                          clock=self._clock)

    def _registry_leader_kill(self) -> None:
        """Kill the primary registry abruptly and promote the follower:
        the journal is closed (replay idempotency asserted on the
        corpse), the follower stops tailing and flips writable, and
        every plane holding a ``_LiveRegistry`` proxy has already
        failed over — the ``RegistryClient`` multi-endpoint rotation,
        collapsed to virtual time.  Ops past the follower's last pull
        are lost: that is the documented bounded-lag trade, and the
        single-writer invariant must still hold on the survivor."""
        ha = self.ha
        if self.registry._journal is not None:
            self.registry._journal.close()
        self.violations.extend(
            dict(v, at_s=round(self.now, 3)) for v in
            invariants.check_registry_replay_idempotent(
                self.registry_journal))
        ha.repl.promote()
        ha.promoted = True
        self.registry = ha.follower
        self.registry_journal = ha.follower_journal

    def _autopilot_cycle(self) -> None:
        if self.autopilot is None:
            from ..autopilot import Autopilot, Planner, Rebalancer

            planner = Planner(self.disp, budget=8, min_improvement=0.01,
                              cooldown_s=30.0, clock=self._clock)
            reb = Rebalancer(self.disp, planner=planner,
                             journal_path=self.autopilot_journal,
                             clock=self._clock)
            self.autopilot = Autopilot(self.disp, planner=planner,
                                       rebalancer=reb,
                                       clock=self._clock)
        self.autopilot.cycle(now=self.now)

    def _ledger_idle(self, namespace: str, duration_s: float,
                     active_frac: float) -> None:
        """Feed the chip-time ledger a synthetic, mostly-idle grant
        window for every bound pod in *namespace* — the rightsizer's
        sustained granted-idle shrink signal, manufactured at virtual
        speed. Slices land on per-pod synthetic chips so the mirrored
        TokenSchedulers' real ledger feeds stay untouched and per-chip
        conservation keeps holding."""
        with self.disp.lock:
            keys = sorted(k for k, pod in self.engine.pod_status.items()
                          if k.startswith(namespace + "/")
                          and pod.node_name)
        for key in keys:
            chip = f"synthetic::{key}"
            start = max(self.now - duration_s,
                        self._synth_end.get(chip, 0.0))
            if self.now - start <= 0.0:
                continue
            self.ledger.grant(chip, key, tpu_class="latency", now=start)
            active = (self.now - start) * max(0.0, min(active_frac, 1.0))
            if active > 0.0:
                self.ledger.execute_begin(chip, now=start)
                self.ledger.execute_end(chip, now=start + active)
            self.ledger.release(chip, now=self.now)
            self._synth_end[chip] = self.now

    def _rightsize_cycle(self) -> None:
        if self.rightsizer is None:
            from ..rightsize import RightsizeConfig, Rightsizer

            # chaos-speed rails: the nemesis runs in seconds, not the
            # production 10-minute observation windows
            cfg = RightsizeConfig(window_s=4.0, cooldown_s=0.2,
                                  idle_frac=0.5, min_coverage=0.25,
                                  min_delta=0.04, pack_util=0.35,
                                  pack_cooldown_s=1.0)
            self.rightsizer = Rightsizer(
                self.disp, ledger=self.ledger,
                schedulers=self.token_scheds,
                gang_coordinator=self.gangcoord, cfg=cfg,
                journal_path=os.path.join(self.workdir,
                                          "rightsize.jsonl"),
                clock=self._clock)
        self._sync_token_scheds()
        self.rightsizer.cycle(now=self.now)

    def _elastic_resize(self, gang: str, target_chips: int) -> None:
        if self.elastic is None:
            from ..elastic import ElasticConfig, ElasticOrchestrator

            # chaos-speed rails: short cooldown so grow-then-shrink in
            # one run is possible, short REAL-time pause bound — the
            # single-threaded loop can't drain a non-idle gang, so a
            # busy gang must refuse fast instead of hanging the run
            cfg = ElasticConfig(pause_timeout_s=0.5, cooldown_s=0.2)
            self.elastic = ElasticOrchestrator(
                self.disp, gang_coordinator=self.gangcoord, cfg=cfg,
                journal_path=os.path.join(self.workdir,
                                          "elastic.jsonl"),
                clock=self._clock)
        # the loop is single-threaded, so a blocked pause() could never
        # be notified: set the pause flag with a zero timeout (the gang
        # STAYS paused on timeout by contract), then step the paused
        # gang through a few future ticks — a held grant releases, an
        # in-flight reserve completes-and-releases or expires, and no
        # new grant starts while paused — so the resize's own pause is
        # immediate
        if not self.gangcoord.pause(gang, timeout=0.0):
            for i in range(1, 13):
                self.gangcoord.step(self.now + i * TICK_S)
                states = {s["gang"]: s["state"]
                          for s in self.gangcoord.grant_states(self.now)}
                if states.get(gang, "idle") == "idle":
                    break
        self.elastic.resize(gang, target_chips, reason="chaos",
                            now=self.now)
        # unwind the pre-pause on plan-stage refusals (applied resizes
        # already resumed inside the orchestrator; extra resume is a
        # no-op)
        self.gangcoord.resume(gang)
        self._sync_token_scheds()

    def _serve_submit(self, tenant: str, count: int) -> None:
        import numpy as np

        from ..serving.frontdoor import Overloaded

        if tenant not in self.fd._tenants and tenant not in self.parked:
            self.fd.register_tenant(tenant, "latency")
        x = np.ones((1, 4), dtype=np.float32)
        for _ in range(count):
            try:
                self._serve_results.append(
                    self.fd.submit(tenant, x, tpu_class="latency"))
            except Overloaded:
                pass       # shed loudly == accounted, not a violation

    # -- token-share mirror ---------------------------------------------

    def _sync_token_scheds(self) -> None:
        """Mirror engine bookings into real per-chip TokenSchedulers so
        the token-shares invariant is checked against the actual
        accounting code, not a re-derivation."""
        from ..isolation.tokensched import TokenScheduler

        with self.active_disp.lock:
            want: dict[str, dict[str, float]] = {}
            for pod in self.active_engine.pod_status.values():
                for chip_id, compute, _mem in getattr(pod, "bookings", ()):
                    want.setdefault(chip_id, {})[pod.key] = compute
        for chip_id, clients in want.items():
            sched = self.token_scheds.get(chip_id)
            if sched is None:
                sched = TokenScheduler(native=False, clock=self._clock,
                                       chip=chip_id, ledger=self.ledger,
                                       ledger_clock=self._clock,
                                       preempt=self.preempt)
                self.token_scheds[chip_id] = sched
                self.gangcoord.attach_chip(chip_id, sched)
            have = sched.shares()
            for name in list(have):
                if name not in clients:
                    sched.remove_client(name)
            for name, req in clients.items():
                if name not in have:
                    sched.add_client(name, min(req, 1.0), 1.0)
        for chip_id in list(self.token_scheds):
            if chip_id not in want:
                self.gangcoord.detach_chip(chip_id)
                del self.token_scheds[chip_id]

    # -- invariant sampling ---------------------------------------------

    def _parked_pending(self) -> int:
        return sum(len(m.get("pending", ()))
                   for m in self.parked.values())

    def _sample(self, where: str, journals: bool = False) -> list[dict]:
        self.samples += 1
        self._sync_token_scheds()
        active = self.active_disp
        with active.lock:
            in_flight = (set(active._pending)
                         | set(active._parked))
            if self.shards > 1 and active is self.disp:
                found = invariants.check_cross_shard(
                    [sh.engine for sh in self.disp.shards], in_flight)
            else:
                found = invariants.check_engine(active.engine, in_flight)
        if self.ha is not None:
            deposed = [d for d in (self.disp, self.ha.standby_disp)
                       if d is not active]
            found.extend(invariants.check_single_writer(
                self.registry, active_engine=active.engine,
                deposed=deposed, final=journals))
        found.extend(invariants.check_token_shares(self.token_scheds))
        found.extend(invariants.check_gang_grant_atomicity(
            self.gangcoord, now=self.now, slack_s=2 * TICK_S))
        found.extend(invariants.check_ledger_conservation(
            self.ledger, now=self.now))
        found.extend(invariants.check_serving_exactly_once(
            self.fd, self._parked_pending()))
        if journals:
            found.extend(invariants.check_registry_replay_idempotent(
                self.registry_journal))
            found.extend(invariants.check_autopilot_journal_idempotent(
                self.autopilot_journal))
        stamped = [dict(v, at_s=round(self.now, 3), where=where)
                   for v in found]
        self.violations.extend(stamped)
        return stamped

    # -- the loop ---------------------------------------------------------

    def _tick(self) -> None:
        if self.now >= self._next_lease:
            self._lease_epoch += 1
            for node in self.nodes:
                if self.engine.node_health.get(node, False):
                    try:
                        self.registry.put_lease(node, self._lease_epoch,
                                                ttl_s=3.0)
                    except OSError:
                        pass            # partitioned — the point
            self._next_lease = self.now + LEASE_EVERY_S
        if self.ha is not None:
            self.ha.tick(self.now)   # steps BOTH dispatchers + leases
        else:
            self.disp.step(self.now)
        if self.gangcoord.gangs():
            # keep the mirror fresh so gang grants see real schedulers,
            # then advance every gang's grant cycle one notch
            self._sync_token_scheds()
            self.gangcoord.step(self.now)
        self.batcher.step(self.now)

    def _converged(self) -> bool:
        if self.partitioned() or self.now < self.servable.crashed_until:
            return False
        if self.ha is not None and self.now < self.ha.silenced_until:
            return False
        disps = [self.disp]
        if self.ha is not None:
            disps.append(self.ha.standby_disp)
        for disp in disps:
            with disp.lock:
                if disp._pending or disp._parked:
                    return False
        with self.fd.lock:
            if any(t.queue for t in self.fd._tenants.values()):
                return False
        return True

    def run(self, scenario: Scenario) -> dict:
        pending = deque(sorted(scenario.actions, key=lambda a: a.at_s))
        window_end = scenario.fault_window_end_s
        next_sample = SAMPLE_EVERY_S
        while pending or self._deferred or self.now <= window_end:
            while pending and pending[0].at_s <= self.now:
                self._apply(pending.popleft())
            self._deferred = deque(sorted(self._deferred,
                                          key=lambda a: a.at_s))
            while self._deferred and self._deferred[0].at_s <= self.now:
                act = self._deferred.popleft()
                self._note(act)
                window_end = max(window_end, act.at_s)
                if act.action == "node_down":
                    with self.disp.lock:
                        self.engine.veto_health(act.target, True)
                        self.engine.set_node_health(act.target, False)
                    self.disp.evict_node(act.target, self.now,
                                         reason="chaos: flap down")
                else:
                    with self.disp.lock:
                        self.engine.veto_health(act.target, False)
                        self.engine.set_node_health(act.target, True)
            self._tick()
            if self.now >= next_sample:
                self._sample("window")
                next_sample = self.now + SAMPLE_EVERY_S
            self.now = round(self.now + TICK_S, 6)
        # -- recovery verification ------------------------------------
        window_end = max(window_end, self._partition_until,
                         self.servable.crashed_until)
        converged_at = None
        deadline = window_end + scenario.converge_bound_s
        while self.now <= deadline:
            self._tick()
            self.batcher.flush(self.now)
            if self._converged():
                fresh = self._sample("convergence", journals=True)
                if not fresh:
                    converged_at = self.now
                    break
            self.now = round(self.now + TICK_S, 6)
        mttr = (max(0.0, converged_at - window_end)
                if converged_at is not None else None)
        if converged_at is None:
            self.violations.append(invariants.violation(
                "reconvergence",
                f"{scenario.name}: not converged within "
                f"{scenario.converge_bound_s:g}s of the fault window",
                at_s=round(self.now, 3)))
        return {
            "scenario": scenario.name,
            "seed": self.seed,
            "shards": self.shards,
            "converged": converged_at is not None,
            "mttr_s": round(mttr, 3) if mttr is not None else None,
            "fault_window_end_s": round(window_end, 3),
            "samples": self.samples,
            "violations": self.violations,
            "timeline": self.timeline,
        }

    def close(self) -> None:
        for sched in self.token_scheds.values():
            try:
                sched.close()
            except Exception:
                pass
        tmp = getattr(self, "_tmp", None)
        if tmp is not None:
            tmp.cleanup()


# -- suite entry points --------------------------------------------------


def run_scenario(name: str, seed: int = 0,
                 workdir: str | None = None, shards: int = 1) -> dict:
    runner = ChaosRunner(seed=seed, workdir=workdir, shards=shards)
    try:
        return runner.run(build(name, seed))
    finally:
        runner.close()


def run_suite(seed: int = 0, names: list | None = None,
              shards: int = 1) -> dict:
    """Run every scenario on one seed — the ``sim --chaos`` body.
    ``shards > 1`` runs the same nemesis against the sharded plane
    (cell route), sampling the cross-shard invariant catalog."""
    scenarios = ([build(n, seed) for n in names] if names
                 else all_scenarios(seed))
    results = []
    for scn in scenarios:
        runner = ChaosRunner(seed=seed, shards=shards)
        try:
            results.append(runner.run(scn))
        finally:
            runner.close()
    return {
        "seed": seed,
        "shards": shards,
        "scenarios": results,
        "invariant_violations": sum(len(r["violations"])
                                    for r in results),
        "converged": all(r["converged"] for r in results),
    }


def _percentile(values: list, q: float) -> float:
    if not values:
        return 0.0
    vals = sorted(values)
    idx = min(len(vals) - 1, int(round(q * (len(vals) - 1))))
    return vals[idx]


def run_matrix(seeds: list, names: list | None = None,
               shards: int = 1) -> dict:
    """Multi-seed aggregation — the ``bench-chaos`` body: per-scenario
    MTTR p50/p99 across seeds plus the zero-violation gate."""
    per_scenario: dict[str, dict] = {}
    total_violations = 0
    for seed in seeds:
        suite = run_suite(seed, names, shards=shards)
        total_violations += suite["invariant_violations"]
        for res in suite["scenarios"]:
            agg = per_scenario.setdefault(
                res["scenario"],
                {"mttr_samples_s": [], "violations": 0,
                 "converged": True})
            if res["mttr_s"] is not None:
                agg["mttr_samples_s"].append(res["mttr_s"])
            agg["violations"] += len(res["violations"])
            agg["converged"] = agg["converged"] and res["converged"]
    scenarios = {}
    for name, agg in sorted(per_scenario.items()):
        samples = agg.pop("mttr_samples_s")
        scenarios[name] = dict(
            agg,
            mttr_p50_s=round(_percentile(samples, 0.50), 3),
            mttr_p99_s=round(_percentile(samples, 0.99), 3),
            runs=len(seeds))
    return {
        "seeds": list(seeds),
        "shards": shards,
        "scenarios": scenarios,
        "invariant_violations": total_violations,
        "converged": all(s["converged"] for s in scenarios.values()),
    }
