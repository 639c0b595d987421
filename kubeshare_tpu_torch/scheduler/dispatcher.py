"""The dispatcher — the enforcing scheduling loop around the engine.

The port's copy of ``kubeshare_tpu/scheduler/dispatcher.py``.

The engine (:mod:`.engine`) is the reference's eight extension points as
pure functions; this module is the part of the kube-scheduler *framework*
the reference relies on to make them bite (``scheduler.go:233,247-267,
551-587``, ``pod.go:47-78``):

- a real queue ordered by ``queue_less`` (Less, scheduler.go:247-267);
- Permit that actually **blocks** gang members: a pod whose gang barrier
  is not reached parks with a deadline instead of binding
  (scheduler.go:551-575);
- Unreserve on timeout: when the deadline passes, every gang member is
  unreserved — bookings reclaimed, ports unmasked, registry records
  withdrawn — and rejected together (scheduler.go:534-549);
- unschedulable pods retry with backoff (the framework's requeue);
- ``groups.gc()`` on a 30 s cadence (scheduler.go:233);
- **startup replay**: bound pods are re-booked from the registry's
  requirement records before any new decision (``pod.go:47-78`` re-queues
  bound pods at informer start; here the records carry everything
  ``resync_bound`` needs).

The loop core is :meth:`step` — a pure function of (state, now) that
returns the delay until its next event — so tests drive it with a fake
clock; :meth:`start` runs the same step on a background thread.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field

from .. import constants as C
from ..obs import metrics as obs_metrics
from ..obs import prof as obs_prof
from ..obs.flight import default_recorder
from ..obs.trace import get_tracer
from ..topology.cell import reclaim_resource, reserve_resource
from ..utils.logger import get_logger
from .engine import Binding, SchedulerEngine, Unschedulable
from .labels import PodRequest
from .scoring import select_cells

log = get_logger("dispatcher")

GC_PERIOD_S = 30.0         # scheduler.go:233
RETRY_BACKOFF_S = 1.0      # unschedulable requeue delay
MAX_RESULTS = 4096         # resolved-outcome retention (live pods exempt)

_OBS = obs_metrics.default_registry()
_QUEUE_WAIT = _OBS.histogram(
    "kubeshare_sched_queue_wait_seconds",
    "Pod submit (or last requeue) to successful reservation.")
_GANG_WAIT = _OBS.histogram(
    "kubeshare_sched_gang_wait_seconds",
    "Time a reserved gang member spent parked at the Permit barrier.")
_BIND_LAT = _OBS.histogram(
    "kubeshare_sched_bind_latency_seconds",
    "Reservation to bound outcome (binding publish + permit).")
_REQUEUES = _OBS.counter(
    "kubeshare_sched_requeues_total",
    "Pods requeued with backoff after an unschedulable cycle.")
_SHEDS = _OBS.counter(
    "kubeshare_sched_sheds_total",
    "Submissions rejected by the bounded admission queue.",
    labels=("reason",))
_TIMEOUTS = _OBS.counter(
    "kubeshare_sched_deadline_timeouts_total",
    "Pending pods resolved timed-out past their sharedtpu/deadline.")
_HEALTH_EVICTIONS = _OBS.counter(
    "kubeshare_health_evictions_total",
    "Pods evicted off dead nodes, by what happened to their session.",
    labels=("outcome",))


class Overloaded(RuntimeError):
    """Typed admission rejection: the bounded queue (``max_pending``,
    per-namespace fair share) refused the submit (doc/health.md)."""

    def __init__(self, msg: str, reason: str = "max-pending"):
        super().__init__(msg)
        self.reason = reason


@dataclass
class Outcome:
    #: "bound" | "rejected" | "deleted" | "overloaded" | "timed-out"
    status: str
    reason: str = ""
    binding: Binding | None = None

    def to_dict(self) -> dict:
        out = {"status": self.status, "reason": self.reason}
        if self.binding is not None:
            out.update(node=self.binding.node,
                       annotations=self.binding.annotations,
                       env=self.binding.env)
        return out


@dataclass
class _Parked:
    pod: PodRequest
    binding: Binding
    deadline: float
    since: float = 0.0            # parked-at, for the gang-wait metric


def _binding_of(pod: PodRequest, engine=None) -> Binding:
    """Reconstruct the Binding of an already-booked pod (resync/replay
    paths) so status queries keep the full annotations + env contract.
    With *engine* given, gang/multi-chip pods regain their sub-mesh
    carve (doc/gang.md) so a resynced member's env matches the original
    bind."""
    carve_kw = {}
    if engine is not None and (pod.group_name or pod.multi_chip):
        carve_kw = engine.carve_annotation(pod.node_name, pod.cells)
    return Binding(pod.key, pod.node_name, list(pod.chip_ids),
                   [c.id for c in pod.cells],
                   [c.cell_type for c in pod.cells], pod.memory, pod.port,
                   request=pod.request, limit=pod.limit,
                   group=pod.group_name, group_size=pod.headcount,
                   group_rank=pod.group_rank, **carve_kw)


class Dispatcher:
    """Owns the engine: all mutations go through this object's lock."""

    def __init__(self, engine: SchedulerEngine, registry=None,
                 gc_period_s: float = GC_PERIOD_S,
                 retry_backoff_s: float = RETRY_BACKOFF_S,
                 clock=time.monotonic, sync=None,
                 max_pending: int | None = None,
                 name: str = "dispatcher"):
        self.engine = engine
        self.registry = registry
        #: lock/profiler family name — per-shard dispatchers get
        #: "dispatcher-shard<i>" so kubeshare_lock_* metrics and phase
        #: profiles stay attributable per shard (doc/sharding.md)
        self.name = name
        self.gc_period_s = gc_period_s
        self.retry_backoff_s = retry_backoff_s
        #: bounded admission: submits beyond this many pending pods are
        #: refused with :class:`Overloaded` (None = unbounded, the
        #: pre-health-plane behavior); under multi-namespace contention
        #: each namespace is capped at its fair share of the bound
        self.max_pending = max_pending
        self._clock = clock
        self._sync = sync               # callable(): refresh capacity
        # THE dispatcher lock (ROADMAP item 1): tracked so its
        # wait/hold seconds and holder sites are measurable
        # (doc/observability.md, "Locks, phases, and profiles"). Always
        # on the wall clock — the injectable scheduler clock may be
        # frozen, which would zero every hold.
        self._cond = obs_prof.TrackedCondition(name)
        #: per-phase attribution of the under-lock step time; the
        #: doctor's /prof probe and bench-profile assert the phases
        #: cover >= 95% of the measured span
        self.prof_phases = obs_prof.PhaseProfiler(name)
        self._pending: dict[str, PodRequest] = {}
        self._retry_at: dict[str, float] = {}
        self._parked: dict[str, _Parked] = {}
        self._results: dict[str, Outcome] = {}
        self._last_reason: dict[str, str] = {}
        #: eviction requests from preemption plans (victim key → detail);
        #: served via /evictions, executed by the bridge (API delete),
        #: completed by the victim's normal DELETED event
        self._evict_requested: dict[str, dict] = {}
        #: pods thrown off a dead node and not yet rebound: key →
        #: {"node", "since", "outcome"} — status() reports "node lost"
        #: instead of whatever generic reason later retries produce
        self._health_evicted: dict[str, dict] = {}
        #: lease-driven failure detector (attach_healthwatch); polled
        #: from the step loop under the lock
        self.healthwatch = None
        #: per-tenant SLO evaluator (attach_slo); evaluated every step
        #: on the dispatcher clock so alert timelines are deterministic
        #: under an injected clock
        self.slo = None
        #: gang token coordinator (attach_gang_coordinator): receives
        #: chip→member membership at bind/unbind so gang-atomic grants
        #: span exactly the bound sub-mesh (doc/gang.md)
        self.gangcoord = None
        #: decision flight recorder (attach_decisions): every submit,
        #: terminal outcome, preemption plan, eviction and move lands
        #: in its ring as a replayable trace (doc/replay.md)
        self.decisions = None
        #: set by ShardedDispatcher: this dispatcher is shard N of a
        #: sharded plane (None = standalone, the single-lock scheduler)
        self.shard_id: int | None = None
        #: optional per-shard event queue (scheduler.shard.ShardEvents):
        #: when set, scheduling outcomes/evictions/unschedulables are
        #: published so cross-shard consumers (healthwatch, SLO,
        #: autopilot triggers, spillover, gang rebalance) run
        #: event-driven instead of polling inside _step_inner
        self.events = None
        #: when False the attached SLO evaluator is NOT evaluated inside
        #: _step_inner — a sharded plane evaluates it once per pump off
        #: the shard locks (outcome recording via _resolve still runs)
        self.slo_inline = True
        self.shed_total = 0
        self._next_gc = 0.0
        #: engine.alloc_gen at the last recorded capacity view — the
        #: view is a pure function of (leaf cells, node health), both of
        #: which bump alloc_gen, so unchanged gen ⇒ unchanged view and
        #: the O(chips) rebuild can be skipped (1k-node replay cost)
        self._view_gen: int | None = None
        #: False on shards sharing one recorder: record_view's delta
        #: encoding assumes full-fleet views, so the sharded plane
        #: records ONE merged view itself (scheduler.shard)
        self.record_views = True
        #: leadership fence (attach_fencing): zero-arg callable giving
        #: the epoch stamped onto every registry write; the registry
        #: refuses a stale epoch 409 and the refusal freezes this
        #: dispatcher — split-brain never reaches the record set
        #: (doc/ha.md). None = unfenced, the exact pre-HA wire.
        self._fence_epoch = None
        #: a frozen dispatcher holds its queue instead of placing: the
        #: standby discipline before takeover, and the deposed leader's
        #: terminal state after a fenced 409 (freeze()/unfreeze())
        self.frozen = False
        self.frozen_reason = ""
        self._stop = False
        self._thread: threading.Thread | None = None

    def attach_healthwatch(self, hw) -> "Dispatcher":
        """Wire a :class:`~.healthwatch.HealthWatch`: every step polls
        it under the dispatcher lock, so detection → veto → eviction is
        serialized with scheduling decisions."""
        self.healthwatch = hw
        return self

    def attach_slo(self, evaluator) -> "Dispatcher":
        """Wire an :class:`~..obs.slo.SloEvaluator`: queue-wait samples
        and bind-availability outcomes feed it, every step re-evaluates
        burn rates, and alert transitions land in the flight recorder —
        a *firing* transition dumps the black box."""
        self.slo = evaluator
        rec = default_recorder()

        def _on_alert(event):
            rec.alert(event.to_dict())
            if event.state == "firing":
                rec.trigger("slo-alert", tenant=event.tenant,
                            objective=event.objective,
                            trace_id=event.trace_id)

        evaluator.add_listener(_on_alert)
        return self

    def attach_gang_coordinator(self, coord) -> "Dispatcher":
        """Wire a :class:`~..gang.coordinator.GangTokenCoordinator`:
        every gang bind/resync/move publishes the gang's chip→member
        map, every delete/eviction/rejection withdraws it — the
        coordinator's registry always mirrors the bound sub-mesh."""
        self.gangcoord = coord
        return self

    def attach_decisions(self, rec, record_fleet: bool = True
                         ) -> "Dispatcher":
        """Wire a :class:`~..obs.decisions.DecisionRecorder`: the
        decision path (submit, resolve, preempt, evict, move) records a
        replayable trace (doc/replay.md). Recording opens with a
        ``fleet`` entry — the engine's current chip inventory, what the
        shadow replayer rebuilds the candidate cluster from — and the
        engine's trace-id entropy is routed through the recorder so
        replay draws the same ids. ``record_fleet=False`` skips the
        fleet entry: a sharded plane shares ONE recorder across shards
        and records a single merged fleet entry itself
        (doc/sharding.md)."""
        self.decisions = rec
        self.engine.decisions = rec
        if not record_fleet:
            return self
        with self._cond:
            nodes = {}
            for node, models in sorted(self.engine.chips_by_node.items()):
                chips = sorted((c for chips_ in models.values()
                                for c in chips_),
                               key=lambda c: c.chip_id)
                nodes[node] = [c.to_labels() for c in chips]
            rec.record("fleet", self._clock(), nodes=nodes)
        return self

    def attach_fencing(self, epoch_fn) -> "Dispatcher":
        """Wire a leadership epoch source (:class:`~..ha.WarmStandby`):
        every registry write — publish, rebind, withdraw — carries
        ``epoch_fn()`` as a fence, and a 409 refusal freezes this
        dispatcher instead of letting a deposed leader double-book the
        fleet (doc/ha.md)."""
        self._fence_epoch = epoch_fn
        return self

    def _fence(self) -> int | None:
        return (None if self._fence_epoch is None
                else int(self._fence_epoch()))

    def freeze(self, reason: str = "") -> None:
        """Stop placing pods. Submits still land, reads still serve,
        the queue holds its state — only the placement pass stops, so
        an unfreeze resumes exactly where the freeze caught the queue.
        Idempotent; the later reason wins."""
        with self._cond:
            first = not self.frozen
            self.frozen = True
            if reason or first:
                self.frozen_reason = reason
            if first:
                log.warning("dispatcher frozen: %s", reason)
                default_recorder().note("dispatcher", "frozen",
                                        reason=reason)

    def unfreeze(self) -> None:
        """Resume placement (takeover / re-election thaw)."""
        with self._cond:
            if not self.frozen:
                return
            self.frozen = False
            self.frozen_reason = ""
            log.warning("dispatcher thawed: placement resumes")
            default_recorder().note("dispatcher", "thawed")
            self._cond.notify_all()

    def _freeze_fenced(self, exc) -> None:
        """A fenced 409 is the registry telling us a newer epoch leads:
        freeze in place (caller holds the lock)."""
        self.freeze(f"fenced at epoch {exc.fence}: "
                    f"epoch {exc.current} leads")

    def _decision_view(self) -> dict:
        """Compact capacity/health view ``{node: "free|health"}`` for
        the decision trace's delta-encoded ``view`` entries (caller
        holds the lock)."""
        eng = self.engine
        view = {}
        for node, models in eng.chips_by_node.items():
            free = 0.0
            for chips_ in models.values():
                for c in chips_:
                    cell = eng.leaf_cells.get(c.chip_id)
                    if cell is not None:
                        free += cell.available
            view[node] = "%.3f|%s" % (
                free, "up" if eng.node_health.get(node) else "down")
        return view

    def _sync_gang(self, pod: PodRequest) -> None:
        """Publish the CURRENT bound membership of *pod*'s gang to the
        coordinator (caller holds the lock). Empty membership (last
        member gone) withdraws the gang."""
        if self.gangcoord is None or not pod.group_name:
            return
        # (chip, client) pairs — fractional members may co-locate on
        # one chip, and each is its own token stream there
        members: list[tuple[str, str]] = []
        tpu_class = pod.tpu_class
        for other in self.engine.pod_status.values():
            if (other.group_name and other.group_key == pod.group_key
                    and other.node_name and other.chip_ids):
                for chip in other.chip_ids:
                    members.append((chip, other.key))
                tpu_class = other.tpu_class
        try:
            if members:
                self.gangcoord.register_gang(pod.group_key, members,
                                             namespace=pod.namespace,
                                             tpu_class=tpu_class)
            else:
                self.gangcoord.unregister_gang(pod.group_key)
        except Exception:
            # membership publication must never take the loop with it
            log.exception("gang coordinator publish failed for %s",
                          pod.group_key)

    @property
    def lock(self) -> threading.Condition:
        """The lock guarding the engine — external readers (GET /state)
        must snapshot under it; the loop thread mutates continuously."""
        return self._cond

    # -- intake ------------------------------------------------------------

    def _check_admission(self, namespace: str, name: str) -> None:
        """Bounded admission (caller holds the lock): refuse NEW load
        past ``max_pending``; resubmits of known pods always pass — a
        poll/retry of queued work is not new load. Under multi-namespace
        contention one namespace cannot take the whole queue: each is
        capped at ``max_pending // active_namespaces`` (doc/health.md)."""
        if self.max_pending is None:
            return
        key = f"{namespace}/{name}"
        if (key in self._pending or key in self._parked
                or key in self.engine.pod_status):
            return
        total = len(self._pending)
        if total >= self.max_pending:
            reason = "max-pending"
        else:
            active = {k.partition("/")[0] for k in self._pending}
            active.add(namespace)
            if len(active) < 2:
                return
            share = max(1, self.max_pending // len(active))
            mine = sum(1 for k in self._pending
                       if k.partition("/")[0] == namespace)
            if mine < share:
                return
            reason = "fair-share"
        self.shed_total += 1
        _SHEDS.inc(reason)
        msg = (f"admission queue full ({total}/{self.max_pending} "
               f"pending)" if reason == "max-pending" else
               f"namespace {namespace} over its fair share of the "
               f"admission queue ({self.max_pending} pending cap)")
        self._resolve(key, Outcome("overloaded", msg))
        log.warning("shed %s: %s", key, msg)
        raise Overloaded(msg, reason)

    def submit(self, namespace: str, name: str, labels: dict,
               uid: str = "") -> str:
        """Parse + enqueue; raises LabelError on bad labels and
        :class:`Overloaded` when the bounded admission queue refuses new
        load. Returns the pod key (poll with :meth:`status` /
        :meth:`outcome`)."""
        with self._cond:
            return self._submit_locked(namespace, name, labels, uid)

    def submit_many(self, items) -> list:
        """Batched admission: submit a burst under ONE lock acquisition
        instead of one per pod (doc/sharding.md). *items* is an iterable
        of ``(namespace, name, labels[, uid])``; returns per-item
        results — the pod key, or the :class:`Overloaded`/``LabelError``
        exception the item raised (the rest of the batch still lands)."""
        out = []
        with self._cond:
            for item in items:
                ns, name, labels = item[0], item[1], item[2]
                uid = item[3] if len(item) > 3 else ""
                try:
                    out.append(self._submit_locked(ns, name, labels, uid))
                except Exception as e:    # Overloaded / LabelError
                    out.append(e)
        return out

    def _submit_locked(self, namespace: str, name: str, labels: dict,
                       uid: str = "") -> str:
        tracer = get_tracer()
        adm_t0 = tracer.now_ms()
        dec = self.decisions
        if dec is None:
            self._check_admission(namespace, name)
        else:
            try:
                self._check_admission(namespace, name)
            except Overloaded as shed:
                # ONE entry on the shed path (it IS the admission
                # hot loop, bench_replay gates its cost): the
                # submit input and its denial together, spec
                # included so replay can re-drive the shed
                dec.record("submit", self._clock(),
                           pod=f"{namespace}/{name}",
                           labels=dict(labels), uid=uid,
                           shed=shed.reason)
                raise
            dec.record("submit", self._clock(),
                       pod=f"{namespace}/{name}",
                       labels=dict(labels), uid=uid)
        pod = self.engine.submit(namespace, name, labels, uid=uid)
        # the critical path's first segment: admission control +
        # label parse + enqueue, under the pod's fresh trace id
        tracer.record("admission", pod.trace_id, adm_t0,
                      tracer.now_ms(),
                      parent_id=(pod.trace_span.span_id
                                 if pod.trace_span else ""),
                      pod=pod.key)
        parked = self._parked.get(pod.key)
        if parked is not None:
            if parked.pod is pod:
                return pod.key      # already reserved, awaiting permit
            # new incarnation (uid change): engine.submit reclaimed the
            # old booking, so the parked entry's binding is stale —
            # drop it and requeue the new pod
            del self._parked[pod.key]
        if pod.node_name:           # already bound (resubmit of bound)
            return pod.key
        self._pending[pod.key] = pod
        self._results.pop(pod.key, None)
        self._cond.notify_all()
        return pod.key

    def delete(self, key: str) -> None:
        """Pod removal: reclaim + drop from every queue
        (deletePod, pod.go:91-136)."""
        with self._cond:
            if self.decisions is not None:
                self.decisions.record("delete", self._clock(), pod=key)
            pod = self.engine.pod_status.get(key)
            self._pending.pop(key, None)
            self._retry_at.pop(key, None)
            self._parked.pop(key, None)
            self.engine.delete_pod(key)
            self._withdraw(key)
            self._resolve(key, Outcome("deleted"))  # evicts + drops reason
            if pod is not None:
                self._sync_gang(pod)

    def outcome(self, key: str) -> Outcome | None:
        with self._cond:
            return self._results.get(key)

    def status(self, key: str) -> dict:
        """Current disposition of a pod: resolved outcome, or its queue
        state ("parked" at the gang barrier / "pending" with the last
        unschedulable reason / "unknown")."""
        with self._cond:
            out = self._results.get(key)
            if out is not None:
                return out.to_dict()
            parked = self._parked.get(key)
            if parked is not None:
                return {"status": "parked",
                        "deadline_s": max(0.0,
                                          parked.deadline - self._clock())}
            if key in self._pending:
                ev = self._health_evicted.get(key)
                if ev is not None:
                    # the load-bearing reason: later unschedulable
                    # retries must not bury WHY the pod is back in the
                    # queue (its node died under it)
                    return {"status": "pending",
                            "reason": f"node lost ({ev['node']})",
                            "evicted_from": ev["node"]}
                return {"status": "pending",
                        "reason": self._last_reason.get(key, "")}
            return {"status": "unknown"}

    def resync(self, namespace: str, name: str, labels: dict,
               annotations: dict, node: str, uid: str = "") -> None:
        """Re-book one already-bound pod (the per-pod resync endpoint)."""
        with self._cond:
            if self._sync is not None:
                self._sync()
            pod = self.engine.resync_bound(namespace, name, labels,
                                           annotations, node, uid=uid)
            # drop any queued state for this key: the next step() would
            # otherwise schedule the STALE PodRequest a second time,
            # leaking a reservation no delete can ever reach
            self._pending.pop(pod.key, None)
            self._retry_at.pop(pod.key, None)
            self._parked.pop(pod.key, None)
            self._resolve(pod.key, Outcome("bound",
                                           binding=_binding_of(pod,
                                                               self.engine)))
            self._sync_gang(pod)

    # -- the loop ----------------------------------------------------------

    def step(self, now: float | None = None) -> float:
        """One scheduling tick under the lock: GC, expire permits,
        schedule every ready pod. Returns seconds until the next timed
        event (inf when purely event-driven)."""
        with self._cond:
            return self._step_locked(self._clock() if now is None else now)

    def _step_locked(self, now: float) -> float:
        # phase attribution (doc/observability.md): lap-timer brackets
        # partition the whole under-lock span — queue-poll (GC, expiry,
        # pick, bookkeeping) / healthwatch / slo / filter-score /
        # publish / gang — so sharding work knows where lock-seconds go
        span = self.prof_phases.span()
        try:
            return self._step_inner(now, span)
        finally:
            span.close("queue-poll")

    def _step_inner(self, now: float, span) -> float:
        # The three pieces are separately callable so a sharded plane
        # (scheduler.shard) can run housekeeping per shard, drain ready
        # pods in a global queue_less order, and reconcile afterwards —
        # with identical sequencing to this single-lock path.
        self._pre_pass(now, span)
        self._drain_ready(now, span)
        self._post_pass(now)
        return self._next_delay(now)

    def _pre_pass(self, now: float, span) -> None:
        """Housekeeping before the scheduling pass (caller holds the
        lock): GC, healthwatch/SLO polls (when inline), flight-recorder
        samples, view deltas, permit-deadline expiry, pod deadlines."""
        if now >= self._next_gc:
            self.engine.groups.gc()
            self._next_gc = now + self.gc_period_s
        span.lap("queue-poll")

        if (self.healthwatch is not None and not self.frozen
                and self.healthwatch.due(now)):
            # a frozen dispatcher must not run detection either: the
            # leader owns the fleet; a standby evicting nodes off its
            # warm copy would fight the leader's bookings (doc/ha.md)
            # the due-gate keeps the phase bracket honest: a poll that
            # would no-op on its cadence must not lap time into the
            # "healthwatch" phase (phantom coverage — doc/sharding.md,
            # event-driven consumers run their own off-step span)
            try:
                self.healthwatch.poll(now, self)
            except Exception:
                # detection must never take the scheduling loop with it
                log.exception("healthwatch poll failed")
            span.lap("healthwatch")

        if self.slo is not None and self.slo_inline:
            try:
                self.slo.evaluate(now)
            except Exception:
                # same contract as healthwatch: alerting rides the loop,
                # it must never crash it
                log.exception("slo evaluation failed")
            span.lap("slo")
        # black-box cadence: cheap counter deltas so a dump shows what
        # the dispatcher was doing in the seconds before the trigger
        rec = default_recorder()
        rec.sample_deltas("dispatcher", {
            "queued": float(len(self._pending)),
            "parked": float(len(self._parked)),
            "requeues_total": _REQUEUES.value(),
            "timeouts_total": _TIMEOUTS.value(),
        })
        # ... and the top lock-wait totals, so a dump on an SLO alert
        # shows whether the control plane was lock-bound at that moment
        if obs_prof.enabled():
            rec.sample_deltas("lockcontention", obs_prof.top_wait_totals())
        if self.decisions is not None:
            # capacity/health view delta into the decision trace, and
            # the per-kind decision counts into the black box (delta
            # samples are their own rate limit: unchanged counts record
            # nothing). The O(chips) view rebuild is skipped whenever
            # alloc_gen is unchanged — the view is a pure function of
            # state that always bumps it (1k-node replay stays <60s).
            gen = self.engine.alloc_gen
            if self.record_views and gen != self._view_gen:
                self.decisions.record_view(now, self._decision_view())
                self._view_gen = gen
            rec.sample_deltas("decision", {
                k: float(v) for k, v in self.decisions.counts().items()})

        for key in [k for k, p in self._parked.items() if p.deadline <= now]:
            if key in self._parked:     # may be gone via gang rejection
                log.info("gang permit timeout for %s", key)
                self._reject_gang(self._parked[key].pod,
                                  "gang permit timeout")

        # per-pod deadlines: a pod still unbound past sharedtpu/deadline
        # resolves "timed-out" instead of retrying forever
        for key in [k for k, p in self._pending.items()
                    if p.deadline_s > 0
                    and now - p.timestamp >= p.deadline_s]:
            pod = self._pending.pop(key)
            self._retry_at.pop(key, None)
            self.engine.delete_pod(key)
            self._withdraw(key)
            _TIMEOUTS.inc()
            log.info("%s timed out after %.1fs unscheduled", key,
                     now - pod.timestamp)
            self._resolve(key, Outcome(
                "timed-out",
                f"unscheduled for {now - pod.timestamp:.1f}s "
                f"(deadline {pod.deadline_s:.1f}s)"))

    def _drain_ready(self, now: float, span) -> None:
        """Schedule every ready pod, highest queue_less first (caller
        holds the lock)."""
        if self.frozen:
            # the queue holds: pending pods keep their timestamps and
            # backoffs for the thaw (or the new leader's replay)
            return
        synced = False
        progressed = True
        while progressed:
            progressed = False
            key = self._pick(now)
            if key is not None:
                if not synced and self._sync is not None:
                    # once per pass, not per pod (set_fleet skips its
                    # rebuild when the capacity snapshot is unchanged)
                    try:
                        self._sync()
                    except Exception as e:
                        log.warning("capacity sync failed: %s", e)
                    synced = True
                pod = self._pending.pop(key)
                self._retry_at.pop(key, None)  # stale entries would make
                # the loop's next-event delay 0 forever (busy spin)
                span.lap("queue-poll")
                self._cycle(pod, now, span)
                progressed = True

    def _post_pass(self, now: float) -> None:
        # AFTER the pass (same-step binds must take effect immediately —
        # the bridge polls between steps): eviction requests complete
        # when the victim leaves the engine (its DELETED event ran
        # delete()) or was REPLACED (same key, new uid — a controller
        # recreated it; the old incarnation is gone, the new one is
        # innocent), and are CANCELLED when the preemptor no longer
        # needs them (bound, or deleted) — a stale request must never
        # kill filler for a satisfied pod.
        for key, req in list(self._evict_requested.items()):
            victim = self.engine.pod_status.get(key)
            if victim is None or victim.uid != req.get("uid", victim.uid):
                del self._evict_requested[key]
                # fast-track the preemptor onto the freed capacity: its
                # retry backoff must not leave a window where a fresh
                # opportunistic arrival beats it to the chip (queue_less
                # already ranks the guarantee pod first once READY)
                pre = req.get("preemptor", "")
                if pre in self._pending:
                    self._retry_at[pre] = now
                    self._cond.notify_all()
                continue
            pre = self.engine.pod_status.get(req.get("preemptor", ""))
            if pre is None or pre.node_name:
                log.info("eviction of %s cancelled (preemptor %s %s)",
                         key, req.get("preemptor"),
                         "bound" if pre is not None else "gone")
                del self._evict_requested[key]

    def _next_delay(self, now: float) -> float:
        """Seconds until the next timed event (caller holds the lock)."""
        nxt = self._next_gc
        for parked in self._parked.values():
            nxt = min(nxt, parked.deadline)
        for t in self._retry_at.values():
            nxt = min(nxt, t)
        for pod in self._pending.values():
            if pod.deadline_s > 0:
                nxt = min(nxt, pod.timestamp + pod.deadline_s)
        if self.healthwatch is not None:
            nxt = min(nxt, now + self.healthwatch.seconds_until_due(now))
        return max(0.0, nxt - now)

    def _pick(self, now: float) -> str | None:
        """Highest-priority ready pod per queue_less (the Less-ordered
        active queue, scheduler.go:247-267)."""
        best: str | None = None
        for key, pod in self._pending.items():
            if self._retry_at.get(key, 0.0) > now:
                continue
            if best is None or self.engine.queue_less(pod,
                                                      self._pending[best]):
                best = key
        return best

    def _cycle(self, pod: PodRequest, now: float,
               span=obs_prof._NULL_SPAN, placer=None) -> None:
        """One scheduling cycle. ``placer(pod) -> Binding`` (when given)
        replaces ``engine.schedule`` — the sharded plane's global score
        router places across shard engines through this seam while every
        other step of the cycle (publish, permit, metrics, resolve)
        stays this exact code path (doc/sharding.md)."""
        tracer = get_tracer()
        parent = pod.trace_span.span_id if pod.trace_span else ""
        ok, msg = self.engine.pre_filter(pod)
        if not ok:
            self._requeue(pod, now, msg)
            span.lap("filter-score")
            return
        try:
            binding = (self.engine.schedule(pod) if placer is None
                       else placer(pod))
        except Unschedulable as e:
            preempted = self._maybe_preempt(pod, now)
            if not preempted:
                self._requeue(pod, now, str(e))
            span.lap("filter-score")
            return
        span.lap("filter-score")
        # queue-wait ends the moment a reservation succeeded. The wait is
        # measured on the scheduler clock (injectable in tests); the span
        # is back-dated on the tracer clock, clamped into the root span so
        # fake-clock durations cannot escape the submit timeline.
        wait_s = max(0.0, now - pod.timestamp)
        _QUEUE_WAIT.observe(value=wait_s, exemplar=pod.trace_id)
        if self.slo is not None:
            self.slo.record(pod.namespace, "queue-wait", value_s=wait_s,
                            now=now, trace_id=pod.trace_id)
        wait_end = tracer.now_ms()
        wait_start = wait_end - wait_s * 1000.0
        if pod.trace_span is not None:
            wait_start = max(wait_start, pod.trace_span.start_ms)
        tracer.record("queue-wait", pod.trace_id, wait_start, wait_end,
                      parent_id=parent, pod=pod.key)
        bind_t0 = time.perf_counter()   # wall-clock: metric-only
        bind_ts0 = tracer.now_ms()
        if self.registry is not None and pod.needs_tpu:
            from ..telemetry.aggregator import publish_binding
            from ..telemetry.registry import FencedWriteError

            try:
                publish_binding(self.registry, pod, binding,
                                fence=self._fence())
            except FencedWriteError as e:
                # a newer epoch leads — we are deposed. Roll back and
                # freeze; the pod stays queued for the real leader (or
                # our own thaw after re-election). Distinct from the
                # transient branch below: retrying a fenced write can
                # never succeed at this epoch.
                self.engine.unreserve(pod)
                self._requeue(pod, now, f"publish fenced: {e}")
                self._freeze_fenced(e)
                span.lap("publish")
                return
            except Exception as e:
                # transient registry failure must not kill the loop thread
                # nor leak the fresh reservation — roll back and retry
                self.engine.unreserve(pod)
                self._requeue(pod, now, f"binding publish failed: {e}")
                span.lap("publish")
                return
        decision, timeout_s = self.engine.permit(pod)
        if decision == "wait":
            self._parked[pod.key] = _Parked(pod, binding, now + timeout_s,
                                            since=now)
            log.info("%s parked at gang barrier (%.1fs)", pod.key, timeout_s)
            span.lap("gang")
            return
        _BIND_LAT.observe(
            value=time.perf_counter() - bind_t0)  # wall-clock: metric-only
        tracer.record("bind", pod.trace_id, bind_ts0, tracer.now_ms(),
                      parent_id=parent, node=binding.node)
        self._resolve(pod.key, Outcome("bound", binding=binding))
        span.lap("publish")
        # the pod completing the barrier releases every parked member
        # (Allow all waiting group members, scheduler.go:577-584)
        if pod.group_name:
            for key in [k for k, p in self._parked.items()
                        if p.pod.group_key == pod.group_key]:
                parked = self._parked.pop(key)
                gang_s = max(0.0, now - parked.since)
                _GANG_WAIT.observe(value=gang_s)
                member = parked.pod
                end = tracer.now_ms()
                start = end - gang_s * 1000.0
                if member.trace_span is not None:
                    start = max(start, member.trace_span.start_ms)
                tracer.record(
                    "gang-wait", member.trace_id, start, end,
                    parent_id=(member.trace_span.span_id
                               if member.trace_span else ""),
                    pod=member.key)
                self._resolve(key, Outcome("bound", binding=parked.binding))
            self._sync_gang(pod)
            span.lap("gang")

    def _maybe_preempt(self, pod: PodRequest, now: float) -> bool:
        """A blocked guarantee pod may displace opportunistic pods
        (engine.find_preemption). The plan only REQUESTS evictions — the
        control plane deletes the victims on the API server, their
        DELETED events reclaim the bookings, and this pod binds on a
        later cycle. Returns True when a plan was adopted."""
        plan = self.engine.find_preemption(pod)
        if plan is None:
            # a previous plan may have evaporated (capacity shifted so
            # even full eviction no longer helps) — its outstanding
            # requests would kill filler without unblocking anyone
            for key, req in list(self._evict_requested.items()):
                if req.get("preemptor") == pod.key:
                    log.info("eviction of %s cancelled (plan for %s "
                             "evaporated)", key, pod.key)
                    del self._evict_requested[key]
            return False
        # this preemptor's previous plan may have shifted (capacity moved
        # between retries) — keep only the victims the CURRENT plan needs
        for key, req in list(self._evict_requested.items()):
            if (req.get("preemptor") == pod.key
                    and key not in plan["victims"]):
                del self._evict_requested[key]
        fresh = []
        for key in plan["victims"]:
            victim = self.engine.pod_status.get(key)
            uid = victim.uid if victim is not None else ""
            req = self._evict_requested.get(key)
            if req is not None:
                req["uid"] = uid      # victim may have been recreated —
                continue              # keep the request live, new target
            fresh.append(key)
            self._evict_requested[key] = {
                "victim": key, "preemptor": pod.key, "node": plan["node"],
                "uid": uid}
        if fresh:
            log.info("%s preempts %d opportunistic pod(s) on %s: %s",
                     pod.key, len(fresh), plan["node"], ", ".join(fresh))
        if self.decisions is not None:
            self.decisions.record("preempt", now, pod=pod.key,
                                  node=plan["node"],
                                  victims=sorted(plan["victims"]))
        self._requeue(pod, now,
                      f"preempting {len(plan['victims'])} opportunistic "
                      f"pod(s) on {plan['node']}")
        return True

    def evictions(self) -> list[dict]:
        """Outstanding eviction requests (victims not yet observed gone)."""
        with self._cond:
            return [dict(v) for v in self._evict_requested.values()]

    def plan_migration(self, key: str, exclude=()) -> dict | None:
        """Dry-run a destination for live-migrating a bound pod's proxy
        session off its node (drain/rebalance tooling): the same
        filter→score→normalize pipeline as a scheduling cycle, with a
        transient reservation per planned member so later members see
        the capacity earlier ones would consume — every booking is
        rolled back before returning, the plan stays advisory.
        ``exclude`` adds nodes the mover already knows are unusable
        (e.g. the one being drained, when the pod is not bound there).

        Gang semantics: for a member of a bound gang the plan covers
        EVERY bound member — planning one member alone would silently
        split the gang — and is None unless all of them place
        (doc/autopilot.md, safety rails). Whole-chip gangs steered by an
        active placement plan refuse migration here (their members'
        filter pins them to planned slots); the autopilot only ever
        moves fractional pods, which never hold gang plans.

        Returns ``{"pod", "from", "node", "scores", "moves"}`` or None.
        ``pod``/``from``/``node``/``scores`` describe the queried pod
        (the pre-gang-aware contract, kept for the health plane's
        migrate_fn); ``moves`` lists ``{"pod", "from", "node"}`` for the
        full move-set, in apply order."""
        with self._cond:
            pod = self.engine.pod_status.get(key)
            if pod is None:
                return None
            if pod.group_name:
                members = [m for m in self.engine._group_members(pod)
                           if m.node_name]
                if pod not in members:
                    return None       # queried member itself is unbound
                # queried pod first so "node"/"scores" describe it
                members.sort(key=lambda m: (m.key != key, m.key))
            else:
                members = [pod]
            booked: list[tuple] = []   # transient (cell, compute, mem)
            moves: list[dict] = []
            head: dict | None = None
            try:
                for m in members:
                    placed = self._plan_member_locked(m, exclude, booked)
                    if placed is None:
                        return None    # all-or-nothing: no silent split
                    moves.append({"pod": m.key, "from": m.node_name,
                                  "node": placed["node"]})
                    if m.key == key:
                        head = placed
            finally:
                for cell, compute, memory in reversed(booked):
                    reclaim_resource(cell, compute, memory)
            return {"pod": key, "from": pod.node_name,
                    "node": head["node"], "scores": head["scores"],
                    "moves": moves}

    def _plan_member_locked(self, pod: PodRequest, exclude,
                            booked: list) -> dict | None:
        """One member of a migration plan: filter→score→normalize, then
        verify cell choice with select_cells and book it transiently (in
        ``booked``, caller rolls back) so gang siblings planned after
        this one cannot be promised the same capacity."""
        skip = set(exclude) | ({pod.node_name} if pod.node_name else set())
        candidates = []
        for node in self.engine.nodes:
            if node in skip:
                continue
            fit, why = self.engine.filter(pod, node)
            if fit:
                candidates.append(node)
            else:
                log.debug("plan_migration: %s rejected %s: %s",
                          node, pod.key, why)
        if not candidates:
            return None
        raw = {n: self.engine.score(pod, n) for n in candidates}
        norm = self.engine.normalize_scores(raw)
        for node in sorted(candidates, key=lambda n: (-norm[n], n)):
            cells = select_cells(self.engine.free_list, node, pod,
                                 self.engine.chip_priority,
                                 self.engine._group_cells(pod),
                                 self.engine.mesh_shape)
            if not cells:
                continue      # scored but un-selectable (raced capacity)
            if pod.multi_chip:
                for cell in cells:
                    booked.append((cell, cell.available, cell.free_memory))
                    reserve_resource(cell, cell.available, cell.free_memory)
            else:
                cell = cells[0]
                memory = pod.memory or int(
                    math.floor(pod.request * cell.full_memory))
                booked.append((cell, pod.request, memory))
                reserve_resource(cell, pod.request, memory)
            return {"node": node, "scores": dict(norm)}
        return None

    def apply_move(self, key: str, node: str) -> Binding:
        """Re-bind one bound pod onto *node* in place — the executor for
        an accepted migration plan (autopilot rebalancer, doc/autopilot.md):
        unreserve → reserve on the destination → re-publish the binding,
        preserving the gang rank (= jax.distributed process_id) across
        the move so a migrated member keeps its identity. On failure the
        source booking is restored and the source stays authoritative —
        mirroring migrate.py's flip-last contract; if even the source
        re-reserve fails (capacity raced away mid-move) the pod is cold
        requeued like a health eviction. Raises Unschedulable when the
        move did not happen."""
        with self._cond:
            now = self._clock()
            pod = self.engine.pod_status.get(key)
            if pod is None or not pod.node_name:
                raise Unschedulable(f"{key}: not a bound pod")
            if node == pod.node_name:
                raise Unschedulable(f"{key}: already on {node}")
            source = pod.node_name
            rank = pod.group_rank
            self.engine.unreserve(pod)    # also resets group_rank
            pod.group_rank = rank         # the member keeps its rank
            try:
                binding = self._rebind_locked(pod, node)
                self._sync_gang(pod)
                if self.decisions is not None:
                    self.decisions.record("move", now, pod=key, src=source,
                                          dst=node)
                return binding
            except Unschedulable as move_err:
                pod.group_rank = rank
                try:
                    self._rebind_locked(pod, source)
                    self._sync_gang(pod)
                except Unschedulable as back_err:
                    # catastrophic: neither side holds capacity anymore —
                    # fall back to the eviction path (cold requeue, no
                    # backoff) so the pod is rebound somewhere
                    log.error("move of %s (%s -> %s) failed AND the "
                              "source re-reserve failed (%s); requeueing",
                              key, source, node, back_err)
                    pod.timestamp = now
                    self._pending[key] = pod
                    self._retry_at[key] = now
                    self._last_reason[key] = (f"rebalance move failed "
                                              f"({source} -> {node})")
                    self._results.pop(key, None)
                    self._withdraw(key)
                    self._sync_gang(pod)
                    self._cond.notify_all()
                raise Unschedulable(
                    f"{key}: move {source} -> {node} failed "
                    f"({move_err}); source restored") from move_err

    def resize_request(self, key: str, new_request: float) -> dict:
        """Re-book a bound fractional pod's compute share in place — the
        executor for an accepted rightsize plan (doc/autopilot.md,
        Rightsizing). The pod keeps its chip and port; the compute
        fraction booked on the leaf (and every ancestor) moves, and an
        HBM cap that was *defaulted* from the compute fraction rescales
        with it (an explicitly declared cap is kept — the tenant asked
        for that much memory regardless of share), so the chaos
        oracle's booking-conservation invariant holds by construction.
        Grows are bounded by the leaf's free capacity — a grow that
        does not fit raises :class:`Unschedulable` and nothing changes
        (the rightsizer migrates a neighbour away and retries on a
        later cycle). Returns ``{"pod", "chip", "from", "to"}``
        describing what was re-booked."""
        with self._cond:
            now = self._clock()
            pod = self.engine.pod_status.get(key)
            if pod is None or not pod.node_name:
                raise Unschedulable(f"{key}: not a bound pod")
            if not pod.needs_tpu or pod.multi_chip or not pod.bookings:
                raise Unschedulable(
                    f"{key}: only fractional single-chip pods resize")
            if not (0.0 < new_request <= 1.0):
                raise Unschedulable(
                    f"{key}: resize target {new_request} out of (0, 1]")
            chip_id, old_request, memory = pod.bookings[0]
            if abs(new_request - old_request) <= 1e-9:
                return {"pod": key, "chip": chip_id,
                        "from": old_request, "to": old_request}
            cell = self.engine.leaf_cells.get(chip_id)
            if cell is None:
                raise Unschedulable(f"{key}: booked chip {chip_id} gone")
            grow = new_request - old_request
            if grow > 0 and cell.available + 1e-9 < grow:
                raise Unschedulable(
                    f"{key}: chip {chip_id} has {cell.available:.3f} "
                    f"free, grow needs {grow:.3f}")
            # HBM: a cap defaulted from the compute fraction
            # (engine.reserve, pod.go:419-424) tracks the new fraction;
            # an explicit cap is the tenant's own number and stays
            if memory == int(math.floor(old_request * cell.full_memory)):
                new_memory = int(
                    math.floor(new_request * cell.full_memory))
            else:
                new_memory = memory
            mem_grow = new_memory - memory
            if mem_grow > 0 and cell.free_memory < mem_grow:
                raise Unschedulable(
                    f"{key}: chip {chip_id} has {cell.free_memory} "
                    f"HBM free, grow needs {mem_grow}")
            reclaim_resource(cell, old_request, memory)
            reserve_resource(cell, new_request, new_memory)
            pod.bookings[0] = (chip_id, new_request, new_memory)
            pod.request = new_request
            pod.memory = new_memory
            pod.limit = max(pod.limit, new_request)
            self.engine.alloc_gen += 1
            if self.decisions is not None:
                self.decisions.record("resize", now, pod=key, chip=chip_id,
                                      src=old_request, dst=new_request)
            self._cond.notify_all()   # freed share may unblock a waiter
            return {"pod": key, "chip": chip_id,
                    "from": old_request, "to": new_request}

    def _rebind_locked(self, pod: PodRequest, node: str) -> Binding:
        """Reserve + publish + resolve for an in-place move (caller holds
        the lock and has already unreserved). Publish failure rolls the
        fresh reservation back, same as a scheduling cycle."""
        binding = self.engine.reserve(pod, node)
        if self.registry is not None and pod.needs_tpu:
            from ..telemetry.aggregator import publish_binding
            from ..telemetry.registry import FencedWriteError

            try:
                publish_binding(self.registry, pod, binding,
                                fence=self._fence())
            except FencedWriteError as e:
                self.engine.unreserve(pod)
                self._freeze_fenced(e)
                raise Unschedulable(f"binding publish fenced: {e}")
            except Exception as e:
                self.engine.unreserve(pod)
                raise Unschedulable(f"binding publish failed: {e}")
        self._resolve(pod.key, Outcome("bound", binding=binding))
        return binding

    def evict_node(self, node: str, now: float | None = None, *,
                   reason: str = "node lost",
                   migrate_fn=None) -> list[str]:
        """Throw every pod off a dead node and requeue it (the
        healthwatch's dead transition, doc/health.md). Gang semantics
        stay intact: ONE dead member evicts the WHOLE group and resets
        its placement plan — a half-reserved gang slot must never leak.
        ``migrate_fn(pod, plan)`` (when given) is tried first for
        groupless bound pods: True means the pod's proxy session was
        live-migrated to ``plan["node"]`` (resilience/migrate.py) and
        the requeue is a formality; False/raise falls back to the cold
        requeue. Returns the evicted keys."""
        with self._cond:   # re-entrant: the healthwatch calls this
            return self._evict_node_locked(
                node, self._clock() if now is None else now, reason,
                migrate_fn)

    def _evict_node_locked(self, node: str, now: float, reason: str,
                           migrate_fn) -> list[str]:
        eng = self.engine
        keys: list[str] = []
        seen_groups: set[str] = set()
        for pod in list(eng.pod_status.values()):
            if pod.node_name != node:
                continue
            if pod.group_name:
                if pod.group_key in seen_groups:
                    continue
                seen_groups.add(pod.group_key)
                # one dead member re-plans the whole gang
                for member in eng._group_members(pod):
                    if member.key not in keys:
                        keys.append(member.key)
            elif pod.key not in keys:
                keys.append(pod.key)
        if not keys:
            return []
        tracer = get_tracer()
        evicted: list[str] = []
        for key in keys:
            pod = eng.pod_status.get(key)
            if pod is None:
                continue
            if pod.group_name:
                group = eng.group_of(pod)
                group.plan = None
                group.plan_taken = {}
                group.plan_stale_gen = -1
                group.plan_checked_gen = -1
            outcome = "requeued"
            if (migrate_fn is not None and pod.node_name == node
                    and not pod.group_name):
                plan = self.plan_migration(key, exclude=(node,))
                if plan is not None:
                    try:
                        if migrate_fn(pod, plan):
                            outcome = "migrated"
                    except Exception as e:
                        log.warning("migration of %s off %s failed, "
                                    "cold requeue: %s", key, node, e)
            eng.unreserve(pod)        # bookings, rank, port, plan slot
            self._parked.pop(key, None)
            self._retry_at.pop(key, None)
            self._withdraw(key)
            self._results.pop(key, None)   # the stale bound outcome
            pod.timestamp = now            # queue-wait restarts here
            self._pending[key] = pod
            self._retry_at[key] = now      # no backoff: reschedule NOW
            self._last_reason[key] = f"{reason} ({node})"
            self._health_evicted[key] = {"node": node, "since": now,
                                         "outcome": outcome}
            _HEALTH_EVICTIONS.inc(outcome)
            _REQUEUES.inc()
            ts = tracer.now_ms()
            tracer.record("node-lost-evict", pod.trace_id, ts, ts,
                          parent_id=(pod.trace_span.span_id
                                     if pod.trace_span else ""),
                          pod=key, node=node, outcome=outcome)
            evicted.append(key)
        if self.gangcoord is not None:
            synced_groups: set[str] = set()
            for key in evicted:
                pod = eng.pod_status.get(key)
                if (pod is not None and pod.group_name
                        and pod.group_key not in synced_groups):
                    synced_groups.add(pod.group_key)
                    self._sync_gang(pod)
        log.warning("node %s lost: evicted %d pod(s): %s", node,
                    len(evicted), ", ".join(evicted))
        if self.decisions is not None:
            self.decisions.record("evict", now, node=node, reason=reason,
                                  pods=list(evicted))
        if self.events is not None:
            self.events.emit(self.shard_id, "evict", node, now,
                             pods=len(evicted))
        # a node loss is a black-box trigger: dump what the system was
        # doing in the run-up (doc/observability.md, flight recorder)
        rec = default_recorder()
        rec.note("dispatcher", "node-evicted", node=node, reason=reason,
                 pods=len(evicted))
        rec.trigger("node-eviction", node=node, pods=len(evicted))
        self._cond.notify_all()
        return evicted

    def _requeue(self, pod: PodRequest, now: float, reason: str) -> None:
        _REQUEUES.inc()
        self._pending[pod.key] = pod
        self._retry_at[pod.key] = now + self.retry_backoff_s
        self._last_reason[pod.key] = reason
        if self.events is not None:
            self.events.emit(self.shard_id, "unschedulable", pod.key,
                             now, reason=reason)
        log.debug("%s unschedulable, retrying in %.1fs: %s",
                  pod.key, self.retry_backoff_s, reason)

    def _reject_gang(self, pod: PodRequest, reason: str) -> None:
        """Unreserve + reject every member (Unreserve, scheduler.go:534-549
        — the gang fails together). Members are fully deleted from the
        engine: a rejected member kept in pod_status would be a phantom
        sibling that lets a lone resubmit pass pre_filter forever."""
        members = [pod.key] + self.engine.unreserve(pod)
        for key in members:
            self.engine.delete_pod(key)   # reclaim + group expiry
            self._pending.pop(key, None)
            self._retry_at.pop(key, None)
            self._parked.pop(key, None)
            self._withdraw(key)
            self._resolve(key, Outcome("rejected", reason))
        self._sync_gang(pod)              # whole gang gone → withdraw

    def _withdraw(self, key: str) -> None:
        if self.registry is None:
            return
        from ..telemetry.aggregator import withdraw
        from ..telemetry.registry import FencedWriteError
        try:
            withdraw(self.registry, key, fence=self._fence())
        except FencedWriteError as e:
            self._freeze_fenced(e)
            log.warning("withdraw %s fenced: %s", key, e)
        except Exception as e:
            log.warning("withdraw %s failed: %s", key, e)

    def _resolve(self, key: str, outcome: Outcome) -> None:
        if self.decisions is not None and outcome.status != "overloaded":
            # overloaded already rode its single shed submit entry
            # (submit(), hot-path economy); everything else is a
            # decision output the replay diff compares
            self.decisions.record(
                "outcome", self._clock(), pod=key, status=outcome.status,
                reason=outcome.reason,
                node=(outcome.binding.node if outcome.binding is not None
                      else ""))
        if self.slo is not None and outcome.status in (
                "bound", "rejected", "timed-out"):
            # availability SLI: did the tenant's pod reach bound?
            # ("deleted"/"overloaded" are the user's own actions)
            self.slo.record(key.partition("/")[0], "availability",
                            ok=outcome.status == "bound",
                            now=self._clock())
        self._results.pop(key, None)   # re-insert at the back (LRU order)
        self._results[key] = outcome
        if self.events is not None:
            self.events.emit(self.shard_id, "outcome", key,
                             self._clock(), status=outcome.status)
        self._last_reason.pop(key, None)
        self._health_evicted.pop(key, None)  # rebound (or gone): the
        # "node lost" story ends with a terminal disposition
        # bound retention: without eviction a long-running scheduler keeps
        # an Outcome (with its Binding) for every pod EVER seen
        scan = len(self._results) - MAX_RESULTS
        for old in list(self._results):
            if scan <= 0:
                break
            scan -= 1
            if old not in self.engine.pod_status:   # never evict live pods
                del self._results[old]
        self._cond.notify_all()

    # -- startup replay ----------------------------------------------------

    def replay_bound(self) -> list[str]:
        """Re-book every requirement record from the registry (crash
        recovery; the informer's bound-pod re-queue, pod.go:47-78). Call
        once, after capacity is synced and before start()."""
        if self.registry is None:
            return []
        replayed = []
        with self._cond:
            for key, rec in sorted(self.registry.pods().items()):
                namespace, _, name = key.partition("/")
                labels = {C.POD_TPU_REQUEST: rec.get("request", "0"),
                          C.POD_TPU_LIMIT: rec.get("limit", "0")}
                if rec.get("priority", "0") not in ("", "0"):
                    labels[C.POD_PRIORITY] = rec["priority"]
                if rec.get("group_name"):
                    labels[C.POD_GROUP_NAME] = rec["group_name"]
                    labels[C.POD_GROUP_HEADCOUNT] = rec.get("headcount", "0")
                    labels[C.POD_GROUP_THRESHOLD] = rec.get("threshold", "0")
                annotations = {
                    C.POD_TPU_CHIP_ID: rec.get("chip_id", ""),
                    C.POD_TPU_MEMORY: rec.get("memory", "0"),
                    C.POD_MANAGER_PORT: rec.get("port", "0"),
                    C.POD_CELL_ID: rec.get("cell_id", ""),
                }
                try:
                    pod = self.engine.resync_bound(
                        namespace, name, labels, annotations,
                        rec.get("node", ""), uid=rec.get("uid", ""))
                    self._results[key] = Outcome(
                        "bound", binding=_binding_of(pod, self.engine))
                    self._sync_gang(pod)
                    replayed.append(key)
                except Exception as e:
                    log.error("replay of %s failed: %s", key, e)
        if replayed:
            log.info("replayed %d bound pods from the registry",
                     len(replayed))
        return replayed

    # -- invariants --------------------------------------------------------

    def invariant_snapshot(self) -> dict:
        """One consistent pass of the chaos plane's engine invariants
        (no-double-booking, booking-consistency, gang-atomicity) plus
        queue counters, under the dispatcher lock — served on
        ``GET /invariants`` and probed by ``doctor`` (doc/chaos.md)."""
        from ..chaos import invariants as chaos_inv

        with self._cond:
            in_flight = set(self._pending) | set(self._parked)
            violations = chaos_inv.check_engine(self.engine, in_flight)
            checked = ["no-double-booking", "booking-consistency",
                       "gang-atomicity"]
            if self.gangcoord is not None:
                violations = violations + chaos_inv.\
                    check_gang_grant_atomicity(self.gangcoord)
                checked.append("gang-grant-atomicity")
            return {
                "ok": not violations,
                "violations": violations,
                "checked": checked,
                "pending": len(self._pending),
                "parked": len(self._parked),
                "bound": sum(1 for p in self.engine.pod_status.values()
                             if p.node_name),
            }

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Dispatcher":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dispatcher")
        self._thread.start()
        return self

    def _run(self) -> None:
        while True:
            with self._cond:
                if self._stop:
                    return
                try:
                    delay = self._step_locked(self._clock())
                except Exception:
                    # the loop thread must survive anything a cycle throws
                    log.exception("dispatcher step failed")
                    delay = self.retry_backoff_s
                # cap the sleep so wall-clock deadlines stay honored even
                # when no notify arrives
                self._cond.wait(min(delay, 0.2))

    def stop(self, drain: bool = True) -> None:
        """Stop the loop thread.  With ``drain`` (the default) one last
        scheduling pass runs first, so work that can bind right now is
        bound-and-resolved instead of abandoned in the queue — the
        graceful half of a SIGTERM; parked gangs stay parked (their
        reservations survive a restart via the registry replay)."""
        with self._cond:
            if drain and not self._stop:
                try:
                    self._step_locked(self._clock())
                except Exception:
                    log.exception("drain step on stop failed")
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
