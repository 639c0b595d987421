"""Sharded dispatch: cell-keyed scheduler shards (doc/sharding.md).

The port's copy of ``kubeshare_tpu/scheduler/shard.py``. It diverges
on purpose where the JAX plane cannot serve a warm standby: the fleet
façade takes the registry's capacity sync (``_FleetEngine.set_fleet``),
the replay books each record on the shard that owns its node, and a
frozen plane's pump runs no health detection.

ROADMAP item 1, the scale-out move: instead of one dispatcher lock
serializing the whole control plane, the fleet is partitioned by
cell/topology-subtree into N shards.  Each shard is a full
:class:`~.dispatcher.Dispatcher` over its own
:class:`~.engine.SchedulerEngine` (its subtree's capacity), with its
own pending queue and its own ``TrackedCondition`` — so
``kubeshare_lock_*`` wait/hold metrics and phase profiles stay
attributable per shard ("dispatcher-shard0", "dispatcher-shard1", ...).

Two routing policies:

- ``route="cell"`` — the fleet-scale fast path.  A pod's home shard is
  the stable hash of its key (gang members hash by group key, so a
  gang always shares a home).  Each shard runs the filter→score→
  reserve pipeline *independently over only its subtree* — at 4 shards
  each placement scans a quarter of the fleet, which is where the
  near-linear throughput scaling comes from (bench_shard.json).  Pods
  a full home shard cannot place spill over to foreign shards, and
  gangs that do not fit any single subtree go through the optimistic
  cross-shard trial-book→commit protocol below.  Placements may
  legitimately differ from the single-lock scheduler (a shard scores
  its subtree, not the world); the chaos invariants
  (:func:`~..chaos.invariants.check_cross_shard`) gate correctness.

- ``route="score"`` — the shadow-safe migration mode (and default):
  pods still live in per-shard queues under per-shard locks, but
  placement runs the *global* filter→score→normalize walk across every
  shard's engine — byte-for-byte the same candidate ordering as
  ``engine.schedule`` on a single fleet-wide engine — and commits the
  reservation on the owning shard.  The drain holds ALL shard locks
  (ascending) for the pass: it reads and mutates every engine, so it
  deliberately trades the cell route's parallelism for parity.  A recorded single-lock trace
  replayed through this mode re-derives the *same pod→node multiset*
  (the replay-diff shard-equivalence gate), which is what lets a
  sharding rollout be verified against production traces before the
  cell route is switched on.

Cross-shard placements use sorted-total-order lock discipline (shard
locks are only ever taken in ascending shard index — the gang
coordinator's sorted-chip-order rule), so shards cannot hold-and-wait
in a cycle.  The gang trial-book reserves every member across the
involved engines, then commits all-or-nothing; any failure (including
an injected mid-commit shard failure — the chaos scenario) rolls back
every booking.

Healthwatch, SLO evaluation, autopilot triggers and gang rebalancing
run as *event-driven consumers* on the pump — fed by per-shard
:class:`ShardEvents` queues — instead of polls inside every shard's
``_step_inner``; their time is bracketed in the pump's own
PhaseProfiler span ("dispatcher-pump"), never phantom-lapped into a
shard's phases.
"""

from __future__ import annotations

import threading
import time
import zlib
from collections import deque

from ..obs import prof as obs_prof
from ..utils.logger import get_logger
from .dispatcher import Dispatcher, Outcome, Overloaded
from .engine import SchedulerEngine, Unschedulable
from .labels import PodRequest
from .podgroup import queue_less as _queue_less

log = get_logger("shard")

#: max pods spilled to foreign shards per cell-route pump (bounds the
#: cross-shard work a single step can take on)
SPILL_BATCH = 32


def _crc(s: str) -> int:
    return zlib.crc32(s.encode())


class ShardPlan:
    """Deterministic node→shard assignment keyed by topology subtree.

    In auto-derived topologies every node roots its own cell chain, so
    the subtree key is the node; nodes are walked in sorted order
    (name-adjacent nodes are rack/slice-adjacent in every fleet this
    repo models) and packed greedily into the chip-lightest shard —
    contiguous, balanced, and stable for a given (fleet, num_shards).
    """

    def __init__(self, fleet: dict, num_shards: int):
        self.num_shards = max(1, int(num_shards))
        self.assign: dict[str, int] = {}
        weights = [0] * self.num_shards
        share = max(1, sum(self._weight(v) for v in fleet.values())
                    ) / self.num_shards
        shard = 0
        for node in sorted(fleet):
            self.assign[node] = shard
            weights[shard] += self._weight(fleet[node])
            if weights[shard] >= share and shard < self.num_shards - 1:
                shard += 1

    @staticmethod
    def _weight(chips) -> int:
        if isinstance(chips, tuple):      # (chips, healthy)
            chips = chips[0]
        return max(1, len(chips))

    def shard_of(self, node: str) -> int:
        got = self.assign.get(node)
        if got is not None:
            return got
        # late-arriving node: stable hash (service fleets grow live)
        return _crc(node) % self.num_shards

    def nodes_of(self, shard: int) -> list[str]:
        return sorted(n for n, s in self.assign.items() if s == shard)


class ShardEvents:
    """Per-shard event queues feeding the pump's consumers.  ``emit``
    is called under a shard lock and must stay O(1); ``drain`` runs on
    the pump, off every shard lock."""

    def __init__(self, num_shards: int):
        self._queues = [deque() for _ in range(max(1, num_shards))]

    def emit(self, shard_id, kind: str, key: str, t: float, **fields):
        q = self._queues[shard_id or 0]
        q.append({"shard": shard_id or 0, "kind": kind, "key": key,
                  "t": t, **fields})

    def drain(self) -> list[dict]:
        out = []
        for q in self._queues:
            while q:
                out.append(q.popleft())
        return out

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues)


class _AllLocks:
    """Acquire every shard lock in ascending shard order (the
    sorted-total-order discipline) — the sharded plane's ``lock``
    property for fleet-wide readers (GET /state, chaos sampling,
    the replay drive loop's quiet check)."""

    def __init__(self, shards):
        self._shards = shards

    def __enter__(self):
        for sh in self._shards:
            sh._cond.acquire()
        return self

    def __exit__(self, *exc):
        for sh in reversed(self._shards):
            sh._cond.release()
        return False

    # Condition-ish surface for callers that notify (service handlers)
    def notify_all(self):
        for sh in self._shards:
            sh._cond.notify_all()


class _FleetEngine:
    """Read-mostly fleet-wide engine façade: routes per-node mutators
    to the owning shard's engine and merges read views — what
    HealthWatch, the replay input driver and status endpoints see as
    ``dispatcher.engine``."""

    def __init__(self, plane: "ShardedDispatcher"):
        self._plane = plane

    def _owner(self, node: str) -> Dispatcher:
        return self._plane.shards[self._plane.plan.shard_of(node)]

    # -- per-node mutators (under the owning shard's lock: the pump's
    # healthwatch poll runs OFF the shard locks, and handler threads
    # step/submit/delete concurrently) ---------------------------------
    def veto_health(self, node: str, vetoed: bool) -> None:
        sh = self._owner(node)
        with sh._cond:
            sh.engine.veto_health(node, vetoed)

    def set_node_health(self, node: str, healthy: bool) -> None:
        sh = self._owner(node)
        with sh._cond:
            sh.engine.set_node_health(node, healthy)

    def set_fleet(self, fleet: dict) -> None:
        """The registry's capacity sync, routed: each shard's engine
        takes its own nodes' part (a node the plan does not know goes
        to its hash shard). The port's own; the JAX façade has no
        ``set_fleet``, so its sharded service and standby skip their
        startup sync and replay."""
        parts: dict[int, dict] = {i: {} for i in
                                  range(len(self._plane.shards))}
        for node, entry in fleet.items():
            parts[self._plane.plan.shard_of(node)][node] = entry
        for i, sh in enumerate(self._plane.shards):
            if parts[i] or sh.engine.chips_by_node:
                with sh._cond:
                    sh.engine.set_fleet(parts[i])

    # -- merged read views ---------------------------------------------
    @property
    def chips_by_node(self) -> dict:
        out = {}
        for sh in self._plane.shards:
            out.update(sh.engine.chips_by_node)
        return out

    @property
    def node_health(self) -> dict:
        out = {}
        for sh in self._plane.shards:
            out.update(sh.engine.node_health)
        return out

    @property
    def pod_status(self) -> dict:
        out = {}
        for sh in self._plane.shards:
            out.update(sh.engine.pod_status)
        return out

    @property
    def leaf_cells(self) -> dict:
        out = {}
        for sh in self._plane.shards:
            out.update(sh.engine.leaf_cells)
        return out

    @property
    def nodes(self) -> list[str]:
        return sorted(self.chips_by_node)

    @property
    def health_veto(self) -> set:
        out: set = set()
        for sh in self._plane.shards:
            out |= sh.engine.health_veto
        return out

    @property
    def rebuild_count(self) -> int:
        return sum(sh.engine.rebuild_count for sh in self._plane.shards)

    @property
    def alloc_gen(self) -> int:
        return sum(sh.engine.alloc_gen for sh in self._plane.shards)


def build_sharded(fleet: dict, num_shards: int, *, clock=time.monotonic,
                  route: str = "score", registry=None,
                  gc_period_s: float | None = None,
                  retry_backoff_s: float | None = None,
                  max_pending: int | None = None,
                  engine_factory=None) -> "ShardedDispatcher":
    """Build a :class:`ShardedDispatcher` over *fleet* (``{node:
    [ChipInfo]}`` or ``{node: ([ChipInfo], healthy)}``).  Each shard's
    engine is fed its subtree via ONE ``set_fleet`` (one topology
    rebuild per shard, not one per node — the difference between
    seconds and minutes at 1k nodes)."""
    plan = ShardPlan(fleet, num_shards)
    disp_kw = {}
    if gc_period_s is not None:
        disp_kw["gc_period_s"] = gc_period_s
    if retry_backoff_s is not None:
        disp_kw["retry_backoff_s"] = retry_backoff_s
    shards = []
    for i in range(plan.num_shards):
        eng = (engine_factory(clock) if engine_factory is not None
               else SchedulerEngine(clock=clock))
        sub = {}
        for node in plan.nodes_of(i):
            chips = fleet[node]
            healthy = True
            if isinstance(chips, tuple):
                chips, healthy = chips
            sub[node] = (list(chips), healthy)
        if sub:
            eng.set_fleet(sub)
        # per-shard admission bound: the global cap split evenly so the
        # plane's aggregate bound matches the single-lock configuration
        cap = (None if max_pending is None
               else max(1, max_pending // plan.num_shards))
        shards.append(Dispatcher(eng, registry=registry, clock=clock,
                                 max_pending=cap,
                                 name=f"dispatcher-shard{i}", **disp_kw))
    return ShardedDispatcher(shards, plan, clock=clock, route=route)


class ShardedDispatcher:
    """N cell-keyed Dispatcher shards behind the single-dispatcher
    surface (submit/delete/status/step/start/stop/lock/...), plus the
    cross-shard machinery: global score routing, spillover, the
    optimistic gang trial-book→commit, and the event pump."""

    def __init__(self, shards: list[Dispatcher], plan: ShardPlan, *,
                 clock=time.monotonic, route: str = "score"):
        if route not in ("score", "cell"):
            raise ValueError(f"unknown shard route {route!r}")
        self.shards = shards
        self.plan = plan
        self.route = route
        self._clock = clock
        self.engine = _FleetEngine(self)
        self.events = ShardEvents(len(shards))
        #: off-step consumers' phase attribution: healthwatch / slo /
        #: spill / gang — bracketed here, never in a shard's span
        self.prof_pump = obs_prof.PhaseProfiler("dispatcher-pump")
        self.healthwatch = None
        self.slo = None
        self.gangcoord = None
        self.decisions = None
        #: autopilot trigger hook: called from the pump with the drained
        #: capacity events (binds/evictions) instead of the autopilot
        #: polling engine state on its own cadence
        self.on_capacity_events = None
        #: test hook (chaos "shard_commit_fail" action): member index at
        #: which the NEXT cross-shard gang commit raises mid-commit —
        #: the rollback path the satellite test exercises
        self.fail_commit_at: int | None = None
        #: summed per-engine alloc_gen at the last merged view entry
        self._view_gen: int | None = None
        #: plane-wide step serialization: the service steps from HTTP
        #: handler threads while _run steps on its own thread — two
        #: concurrent drains (or a drain racing the pump's cross-shard
        #: machinery) would interleave between per-shard lock windows.
        #: Tracked, so /prof shows plane-step contention; re-entrant,
        #: matching the per-shard dispatcher lock's discipline.
        self._step_lock = obs_prof.TrackedRLock("dispatcher-plane-step")
        self._stop = False
        self._thread: threading.Thread | None = None
        for i, sh in enumerate(shards):
            sh.shard_id = i
            sh.events = self.events
            sh.slo_inline = False
            # partial per-shard views would corrupt the shared
            # recorder's delta encoding; the plane records ONE merged
            # view per step instead (_record_view)
            sh.record_views = False

    # -- attach points (single-dispatcher surface) ---------------------

    def attach_healthwatch(self, hw) -> "ShardedDispatcher":
        """Event-driven: the pump polls it off the shard locks; its
        evictions route to owning shards through the fleet façade."""
        self.healthwatch = hw
        return self

    def attach_slo(self, evaluator) -> "ShardedDispatcher":
        self.slo = evaluator
        for sh in self.shards:
            sh.attach_slo(evaluator)   # outcome recording per shard
            sh.slo_inline = False      # ... but ONE evaluate per pump
        return self

    def attach_gang_coordinator(self, coord) -> "ShardedDispatcher":
        self.gangcoord = coord
        for sh in self.shards:
            sh.attach_gang_coordinator(coord)
        return self

    def attach_decisions(self, rec) -> "ShardedDispatcher":
        """ONE shared recorder: per-shard decision streams merge into a
        single seq space (record() is lock-free), under ONE fleet entry
        covering every subtree."""
        self.decisions = rec
        nodes = {}
        with self.lock:
            for sh in self.shards:
                for node, models in sorted(sh.engine.chips_by_node.items()):
                    chips = sorted((c for chips_ in models.values()
                                    for c in chips_),
                                   key=lambda c: c.chip_id)
                    nodes[node] = [c.to_labels() for c in chips]
        rec.record("fleet", self._clock(),
                   nodes=dict(sorted(nodes.items())))
        rec.meta.setdefault("shards", len(self.shards))
        rec.meta.setdefault("shard_route", self.route)
        for sh in self.shards:
            sh.attach_decisions(rec, record_fleet=False)
        return self

    def attach_fencing(self, epoch_fn) -> "ShardedDispatcher":
        """Every shard's registry writes carry the same leadership
        epoch (doc/ha.md): there is ONE ``leader:scheduler`` lease for
        the whole plane, not one per shard."""
        for sh in self.shards:
            sh.attach_fencing(epoch_fn)
        return self

    def freeze(self, reason: str = "") -> None:
        """Freeze every shard (standby discipline / deposed fence)."""
        for sh in self.shards:
            sh.freeze(reason)

    def unfreeze(self) -> None:
        for sh in self.shards:
            sh.unfreeze()

    @property
    def frozen(self) -> bool:
        return all(sh.frozen for sh in self.shards)

    # -- routing -------------------------------------------------------

    def home_shard(self, namespace: str, name: str,
                   labels: dict | None = None) -> int:
        """Stable home for a pod: gang members hash by group key (a
        gang always shares a home shard), everything else by pod key."""
        from .. import constants as C
        group = (labels or {}).get(C.POD_GROUP_NAME, "")
        key = (f"{namespace}/{group}" if group
               else f"{namespace}/{name}")
        return _crc(key) % len(self.shards)

    def _engine_owner(self, key: str) -> Dispatcher | None:
        """The shard whose ENGINE holds *key*'s record (and bookings)."""
        for sh in self.shards:
            if key in sh.engine.pod_status:
                return sh
        return None

    # -- intake (single-dispatcher surface) ----------------------------

    def _submit_shard(self, namespace: str, name: str,
                      labels: dict) -> int:
        """Where a submit must land: after a spill/re-home the pod's
        engine record (and any live booking) lives on a FOREIGN shard —
        an idempotent resubmit routed by home would mint a duplicate
        record there and could bind the same pod onto a second node,
        the cross-shard double-ownership :meth:`delete` guards against.
        Mirror it: the owning engine first, home only for unknown keys."""
        owner = self._engine_owner(f"{namespace}/{name}")
        if owner is not None:
            return owner.shard_id
        return self.home_shard(namespace, name, labels)

    def submit(self, namespace: str, name: str, labels: dict,
               uid: str = "") -> str:
        sh = self.shards[self._submit_shard(namespace, name, labels)]
        return sh.submit(namespace, name, labels, uid=uid)

    def submit_many(self, items) -> list:
        """Batched admission across shards: the burst is grouped by
        owning/home shard and each group lands under ONE acquisition of
        that shard's lock (one per shard per burst, not one per pod)."""
        groups: dict[int, list] = {}
        order = []
        for idx, item in enumerate(items):
            ns, name, labels = item[0], item[1], item[2]
            shard = self._submit_shard(ns, name, labels)
            groups.setdefault(shard, []).append((idx, item))
            order.append(None)
        for shard, batch in sorted(groups.items()):
            results = self.shards[shard].submit_many(
                [item for _, item in batch])
            for (idx, _), res in zip(batch, results):
                order[idx] = res
        return order

    def delete(self, key: str) -> None:
        """After a foreign placement the engine record (bookings) and
        the home's queue/result bookkeeping live on DIFFERENT shards:
        the reclaim must run where the bookings are, and the stale
        bookkeeping must go everywhere else — a delete routed to the
        home shard alone would leak the foreign booking forever."""
        target = self._engine_owner(key)
        others = [sh for sh in self.shards
                  if sh is not target
                  and (key in sh._pending or key in sh._parked
                       or key in sh._results)]
        if target is None:
            if others:
                target = others.pop(0)
            else:
                ns, _, name = key.partition("/")
                target = self.shards[self.home_shard(ns, name)]
        target.delete(key)
        for sh in others:
            with sh._cond:
                sh._pending.pop(key, None)
                sh._retry_at.pop(key, None)
                sh._parked.pop(key, None)
                sh._results.pop(key, None)
                sh._last_reason.pop(key, None)
                sh._preempt_memo.pop(key, None)
                sh._cond.notify_all()

    def outcome(self, key: str) -> Outcome | None:
        for sh in self.shards:
            out = sh.outcome(key)
            if out is not None:
                return out
        return None

    def status(self, key: str) -> dict:
        for sh in self.shards:
            st = sh.status(key)
            if st.get("status") != "unknown":
                return st
        return {"status": "unknown"}

    def evictions(self) -> list[dict]:
        out = []
        for sh in self.shards:
            out.extend(sh.evictions())
        return out

    def resync(self, namespace: str, name: str, labels: dict,
               annotations: dict, node: str, uid: str = "") -> None:
        self.shards[self.plan.shard_of(node)].resync(
            namespace, name, labels, annotations, node, uid=uid)

    def evict_node(self, node: str, now: float | None = None, *,
                   reason: str = "node lost", migrate_fn=None) -> list[str]:
        sh = self.shards[self.plan.shard_of(node)]
        return sh.evict_node(node, now, reason=reason, migrate_fn=migrate_fn)

    def replay_bound(self, records: dict | None = None,
                     standby: bool = False) -> list[str]:
        """Each record is booked on the shard that owns its node (the
        port's own: the JAX plane has every shard replay every record,
        booking a record of a foreign node with no device)."""
        if records is None:
            if not self.shards or self.shards[0].registry is None:
                return []
            records = self.shards[0].registry.pods()
        out = []
        for sh, part in zip(self.shards, self._by_shard(records)):
            out.extend(sh.replay_bound(records=part, standby=standby))
        return out

    def park_replayed(self, records: dict) -> list[str]:
        """:meth:`Dispatcher.park_replayed`, each record on the shard
        that owns its node."""
        out = []
        for sh, part in zip(self.shards, self._by_shard(records)):
            if part:
                out.extend(sh.park_replayed(part))
        return out

    def _by_shard(self, records: dict) -> list[dict]:
        parts: list[dict] = [{} for _ in self.shards]
        for key, rec in records.items():
            parts[self.plan.shard_of(rec.get("node", ""))][key] = rec
        return parts

    # -- rebalance/rightsize surface (doc/autopilot.md) ----------------
    # Moves and resizes run on the shard whose ENGINE holds the pod's
    # bookings: a shard's migration plan only ever proposes destinations
    # its own engine scores, so the booking mutation stays under one
    # shard lock and the per-shard oracle invariants keep holding.

    def plan_migration(self, key: str, exclude=()) -> dict | None:
        sh = self._engine_owner(key)
        return None if sh is None else sh.plan_migration(key, exclude)

    def apply_move(self, key: str, node: str):
        sh = self._engine_owner(key)
        if sh is None:
            raise Unschedulable(f"{key}: not a bound pod")
        if self.plan.shard_of(node) != sh.shard_id:
            raise Unschedulable(
                f"{key}: {node} lives on shard "
                f"{self.plan.shard_of(node)}, bookings on {sh.shard_id}; "
                "cross-shard moves go through the submit path")
        return sh.apply_move(key, node)

    def resize_request(self, key: str, new_request: float) -> dict:
        sh = self._engine_owner(key)
        if sh is None:
            raise Unschedulable(f"{key}: not a bound pod")
        return sh.resize_request(key, new_request)

    # -- aggregate state (drive()/service surface) ---------------------

    @property
    def lock(self) -> _AllLocks:
        return _AllLocks(self.shards)

    @property
    def _pending(self) -> dict:
        out = {}
        for sh in self.shards:
            out.update(sh._pending)
        return out

    @property
    def _parked(self) -> dict:
        out = {}
        for sh in self.shards:
            out.update(sh._parked)
        return out

    @property
    def max_pending(self):
        caps = [sh.max_pending for sh in self.shards]
        if any(c is None for c in caps):
            return None
        return sum(caps)

    @property
    def shed_total(self) -> int:
        return sum(sh.shed_total for sh in self.shards)

    @property
    def prof_phases(self):
        # the pump's profiler fronts for the plane; per-shard phases
        # live on each shard's own "dispatcher-shard<i>" profiler
        return self.prof_pump

    def invariant_snapshot(self) -> dict:
        from ..chaos import invariants as chaos_inv

        with self.lock:
            in_flight = set(self._pending) | set(self._parked)
            violations = chaos_inv.check_cross_shard(
                [sh.engine for sh in self.shards], in_flight)
            checked = ["no-double-booking", "booking-consistency",
                       "gang-atomicity", "cross-shard-pod-ownership",
                       "cross-shard-gang-atomicity"]
            if self.gangcoord is not None:
                violations = violations + chaos_inv.\
                    check_gang_grant_atomicity(self.gangcoord)
                checked.append("gang-grant-atomicity")
            return {
                "ok": not violations,
                "violations": violations,
                "checked": checked,
                "shards": len(self.shards),
                "pending": len(self._pending),
                "parked": len(self._parked),
                "bound": sum(1 for sh in self.shards
                             for p in sh.engine.pod_status.values()
                             if p.node_name),
            }

    # -- the loop ------------------------------------------------------

    def step(self, now: float | None = None) -> float:
        """One plane-wide tick: per-shard housekeeping, the scheduling
        pass (global order under ``route="score"``, independent shards
        under ``route="cell"``), cross-shard spill/gang work, then the
        event pump.  Returns seconds until the next timed event.

        Serialized plane-wide: the service steps synchronously from
        HTTP handler threads while the ``_run`` thread steps on its
        own cadence — only one tick may be in flight at a time."""
        with self._step_lock:
            now = self._clock() if now is None else now
            self._record_view(now)
            if self.route == "score":
                delay = self._step_score(now)
            else:
                delay = self._step_cell(now)
            pump_delay = self._pump(now)
            return max(0.0, min(delay, pump_delay))

    def _record_view(self, now: float) -> None:
        """One merged fleet-wide capacity/health view entry (shards have
        disjoint node sets, so per-shard views union cleanly), gated on
        the summed alloc_gen exactly like the single-lock path."""
        if self.decisions is None:
            return
        gen = self.engine.alloc_gen
        if gen == self._view_gen:
            return
        view: dict[str, str] = {}
        for sh in self.shards:
            with sh._cond:
                view.update(sh._decision_view())
        self.decisions.record_view(now, view)
        self._view_gen = gen

    def _step_score(self, now: float) -> float:
        # The whole pass runs under ALL shard locks (ascending — the
        # total-order discipline): the global placer filters, scores and
        # reserves on EVERY shard's engine and re-homes records across
        # shards, so holding only the home shard's lock would race the
        # submit/delete/resync handler threads mutating foreign engines
        # under their own locks.  Score route is the shadow-safe
        # migration mode — it trades the per-shard parallelism the cell
        # route keeps for exact global placement parity, so fleet-wide
        # serialization here is the contract, not a regression.
        with self.lock:
            for sh in self.shards:
                span = sh.prof_phases.span()
                sh._pre_pass(now, span)
                span.close("queue-poll")
            # global drain: across shards, always take THE queue_less-
            # least ready pod next — the same processing order the
            # single-lock _drain_ready derives, which is what makes
            # score-route replay placement-parity exact (doc/sharding.md)
            progressed = True
            synced: set[int] = set()
            while progressed:
                progressed = False
                best = None      # (shard, key, pod)
                for sh in self.shards:
                    if sh.frozen:
                        # the global drain bypasses _drain_ready, so the
                        # freeze gate (doc/ha.md) must repeat here
                        continue
                    key = sh._pick(now)
                    if key is None:
                        continue
                    pod = sh._pending.get(key)
                    if pod is None:
                        continue
                    if best is None or self._less(sh, pod,
                                                  best[0], best[2]):
                        best = (sh, key, pod)
                if best is None:
                    break
                sh, key, pod = best
                if sh.shard_id not in synced and sh._sync is not None:
                    try:
                        sh._sync()
                    except Exception as e:
                        log.warning("capacity sync failed: %s", e)
                    synced.add(sh.shard_id)
                sh._pending.pop(key, None)
                sh._retry_at.pop(key, None)
                span = sh.prof_phases.span()
                placer = (None if pod.group_name
                          else self._global_placer(sh))
                # _cycle laps its own phases (filter-score/publish/gang)
                # against this span; close("") leaves the tail uncharged
                # instead of double-charging the last phase
                sh._cycle(pod, now, span, placer=placer)
                span.close("")
                progressed = True
            delay = float("inf")
            for sh in self.shards:
                sh._post_pass(now)
                delay = min(delay, sh._next_delay(now))
        return delay

    @staticmethod
    def _less(sh_a: Dispatcher, pod_a: PodRequest,
              sh_b: Dispatcher, pod_b: PodRequest) -> bool:
        return _queue_less(pod_a, sh_a.engine.group_of(pod_a),
                           pod_b, sh_b.engine.group_of(pod_b))

    def _global_placer(self, home: Dispatcher):
        """A ``placer`` for :meth:`Dispatcher._cycle` that reproduces
        ``engine.schedule``'s global candidate walk across every shard
        engine — filter all fleet nodes, score, normalize over the full
        candidate set, reserve best-first — then re-homes the pod record
        onto the shard whose subtree won.  The caller must hold ALL
        shard locks (:meth:`_step_score` drains under ``self.lock``):
        this touches every shard's engine, not just the home's.  Gang
        pods never take this path (they pin to their home subtree or
        the trial-book)."""

        def place(pod: PodRequest):
            cand: list[tuple[str, Dispatcher]] = []
            for sh in self.shards:
                eng = sh.engine
                for node in eng.nodes:
                    fit, _why = eng.filter(pod, node)
                    if fit:
                        cand.append((node, sh))
            if not cand:
                raise Unschedulable(f"{pod.key}: no node passed filtering")
            raw = {node: sh.engine.score(pod, node) for node, sh in cand}
            norm = SchedulerEngine.normalize_scores(raw)
            last_err: Unschedulable | None = None
            for node, sh in sorted(cand,
                                   key=lambda t: (norm[t[0]], t[0]),
                                   reverse=True):
                try:
                    binding = sh.engine.reserve(pod, node)
                except Unschedulable as err:
                    last_err = err
                    continue
                if sh is not home:
                    self._rehome(home, sh, pod)
                return binding
            raise last_err if last_err is not None else Unschedulable(
                pod.key)

        return place

    @staticmethod
    def _rehome(src: Dispatcher, dst: Dispatcher, pod: PodRequest) -> None:
        """Move a pod's record between shard engines (both locks held or
        single-threaded context; the pod object itself carries
        timestamp/trace/bookings unchanged)."""
        src.engine.hand_over(pod.key)
        dst.engine.adopt(pod)

    def _step_cell(self, now: float) -> float:
        delay = float("inf")
        for sh in self.shards:
            delay = min(delay, sh.step(now))
        return delay

    # -- the pump: event-driven consumers ------------------------------

    def _pump(self, now: float) -> float:
        """Run the off-step consumers: healthwatch, SLO evaluation,
        autopilot triggers, spillover and cross-shard gang placement —
        fed by the per-shard event queues, bracketed in the pump's own
        profiler span (no phantom time in any shard's phases)."""
        span = self.prof_pump.span()
        events = self.events.drain()
        span.lap("events")
        delay = float("inf")
        if (self.healthwatch is not None and not self.frozen
                and self.healthwatch.due(now)):
            # a frozen plane runs no detection, as a frozen single-lock
            # dispatcher does (the port's own: the JAX pump polls on)
            try:
                # the fleet façade routes vetoes/evictions per shard
                self.healthwatch.poll(now, self)
            except Exception:
                log.exception("healthwatch pump failed")
            span.lap("healthwatch")
        if self.healthwatch is not None:
            delay = min(delay, self.healthwatch.seconds_until_due(now))
        if self.slo is not None:
            try:
                self.slo.evaluate(now)
            except Exception:
                log.exception("slo pump failed")
            span.lap("slo")
        if self.on_capacity_events is not None and events:
            capacity = [e for e in events
                        if e["kind"] in ("outcome", "evict")]
            if capacity:
                try:
                    self.on_capacity_events(capacity)
                except Exception:
                    log.exception("capacity-event consumer failed")
                span.lap("autopilot")
        if self.route == "cell":
            stuck = [e for e in events if e["kind"] == "unschedulable"]
            if stuck:
                self._spill(now, stuck)
                span.lap("spill")
                self._gang_rebalance(now, stuck)
                span.lap("gang")
        span.close("")
        return delay

    # -- cell-route cross-shard machinery -------------------------------

    def _spill(self, now: float, stuck: list[dict]) -> None:
        """Spillover: a groupless pod its home subtree cannot hold is
        re-homed onto a foreign shard that CAN filter it (trial-book:
        the reservation itself still happens on the new home's next
        cycle, under its own lock).  Bounded per pump; deterministic
        order (event order is per-shard FIFO)."""
        moved = 0
        seen: set[str] = set()
        for ev in stuck:
            if moved >= SPILL_BATCH:
                break
            key = ev["key"]
            if key in seen:
                continue
            seen.add(key)
            src = self.shards[ev["shard"]]
            with src._cond:
                pod = src._pending.get(key)
                if pod is None or pod.group_name:
                    continue
                # only spill a pod its home shard just failed to place
                if key not in src._last_reason:
                    continue
            for dst in self.shards:
                if dst is src:
                    continue
                fits = False
                with dst._cond:
                    for node in dst.engine.nodes:
                        ok, _ = dst.engine.filter(pod, node)
                        if ok:
                            fits = True
                            break
                if not fits:
                    continue
                self._transfer_pending(src, dst, key, now)
                moved += 1
                break

    def _transfer_pending(self, src: Dispatcher, dst: Dispatcher,
                          key: str, now: float) -> None:
        """Move one pending pod between shards, locks in ascending
        shard order (total-order discipline)."""
        first, second = sorted((src, dst), key=lambda s: s.shard_id)
        with first._cond, second._cond:
            pod = src._pending.pop(key, None)
            if pod is None:
                return
            reason = src._last_reason.pop(key, "")
            src._retry_at.pop(key, None)
            src._preempt_memo.pop(key, None)
            src.engine.hand_over(key)
            dst.engine.adopt(pod)
            dst._pending[key] = pod
            dst._retry_at[key] = now       # retry immediately, new home
            if reason:
                dst._last_reason[key] = reason
            if self.decisions is not None:
                self.decisions.record("shard-spill", now, pod=key,
                                      src=src.shard_id, dst=dst.shard_id)
            dst._cond.notify_all()

    def _gang_rebalance(self, now: float, stuck: list[dict]) -> None:
        """Cross-shard gang placement, event-driven: gangs whose members
        just failed their home subtree go through the optimistic
        trial-book→commit."""
        groups: set[tuple[int, str]] = set()
        for ev in stuck:
            src = self.shards[ev["shard"]]
            with src._cond:
                pod = src._pending.get(ev["key"])
                if pod is not None and pod.group_name:
                    groups.add((ev["shard"], pod.group_key))
        for shard, group_key in sorted(groups):
            try:
                self.place_gang_cross_shard(self.shards[shard],
                                            group_key, now)
            except Unschedulable:
                pass     # stays queued at home; retried on later events

    def place_gang_cross_shard(self, home: Dispatcher, group_key: str,
                               now: float) -> dict[str, str]:
        """The optimistic cross-shard protocol: under ALL shard locks
        (ascending — no hold-and-wait cycle possible), trial-book every
        member of the gang greedily across shard subtrees; if every
        member reserves, commit all (publish + resolve + re-home),
        else roll back every booking and leave the gang pending at
        home.  Returns ``{member_key: node}`` on success; raises
        :class:`Unschedulable` when the fleet cannot hold the gang.

        ``fail_commit_at`` (the chaos ``shard_commit_fail`` action)
        injects a mid-commit failure after that many members committed;
        the rollback must restore every shard — the cross-shard
        gang-atomicity invariant holds before and after."""
        with self.lock:      # ascending acquisition, all shards
            # subsume members already parked at the permit barrier: they
            # hold home-subtree reservations the trial-book supersedes —
            # reclaim them so the greedy pass places the WHOLE gang
            for key in [k for k, p in home._parked.items()
                        if p.pod.group_key == group_key]:
                parked = home._parked.pop(key)
                home.engine.unreserve(parked.pod)
                home._withdraw(key)
                home._pending[key] = parked.pod
            members = sorted(
                (p for p in home.engine.pod_status.values()
                 if p.group_key == group_key and not p.node_name
                 and p.key in home._pending),
                key=lambda p: p.key)
            if not members:
                raise Unschedulable(f"gang {group_key}: no pending members")
            headcount = members[0].headcount or len(members)
            if len(members) < headcount:
                raise Unschedulable(
                    f"gang {group_key}: {len(members)}/{headcount} "
                    f"members present")
            # pre-assign dense ranks so per-engine rank derivation can't
            # collide across shards (each engine only scans ITS members
            # for taken ranks — two shards would both hand out rank 0)
            old_ranks = {m.key: m.group_rank for m in members}
            ordinals, clean = home.engine._name_ordinals(members[0])
            for idx, m in enumerate(members):
                if m.group_rank < 0:
                    m.group_rank = (ordinals[m.key] if clean else idx)
            booked: list[tuple[Dispatcher, PodRequest, object]] = []
            committed: list[tuple[Dispatcher, PodRequest]] = []
            try:
                for m in members:
                    placed = None
                    for sh in self.shards:
                        for node in sh.engine.nodes:
                            ok, _why = sh.engine.filter(m, node)
                            if not ok:
                                continue
                            try:
                                binding = sh.engine.reserve(m, node)
                            except Unschedulable:
                                continue
                            placed = (sh, m, binding)
                            break
                        if placed is not None:
                            break
                    if placed is None:
                        raise Unschedulable(
                            f"gang {group_key}: member {m.key} fits no "
                            f"shard subtree")
                    booked.append(placed)
                # commit: all members reserved — publish + resolve.
                for idx, (sh, m, binding) in enumerate(booked):
                    if (self.fail_commit_at is not None
                            and idx >= self.fail_commit_at):
                        self.fail_commit_at = None
                        raise RuntimeError(
                            f"injected shard failure mid-commit "
                            f"(member {idx})")
                    if sh.registry is not None and m.needs_tpu:
                        from ..telemetry.aggregator import publish_binding
                        publish_binding(sh.registry, m, binding)
                    committed.append((sh, m))
                for sh, m, binding in booked:
                    home._pending.pop(m.key, None)
                    home._retry_at.pop(m.key, None)
                    if sh is not home:
                        self._rehome(home, sh, m)
                    home._resolve(m.key, Outcome("bound", binding=binding))
                if self.decisions is not None:
                    self.decisions.record(
                        "gang-cross-shard", now, gang=group_key,
                        members={m.key: b.node for _, m, b in booked})
                self._sync_gang_fleet(members[0])
                return {m.key: b.node for _, m, b in booked}
            except Exception as err:
                # rollback: reclaim every trial booking, withdraw any
                # published record, restore ranks — the gang stays
                # pending at home, whole
                for sh, m, _binding in booked:
                    try:
                        sh.engine.unreserve(m)
                    except Exception:
                        log.exception("rollback unreserve of %s failed",
                                      m.key)
                for sh, m in committed:
                    sh._withdraw(m.key)
                for m in members:
                    m.group_rank = old_ranks[m.key]
                    m.node_name = ""
                if isinstance(err, Unschedulable):
                    raise
                log.warning("cross-shard gang commit of %s failed, "
                            "rolled back: %s", group_key, err)
                raise Unschedulable(
                    f"gang {group_key}: cross-shard commit failed "
                    f"({err})") from err

    def _sync_gang_fleet(self, pod: PodRequest) -> None:
        """Publish the gang's FULL cross-shard membership to the
        coordinator (per-shard _sync_gang only sees its own engine)."""
        if self.gangcoord is None or not pod.group_name:
            return
        members: list[tuple[str, str]] = []
        tpu_class = pod.tpu_class
        for sh in self.shards:
            for other in sh.engine.pod_status.values():
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
            log.exception("gang coordinator publish failed for %s",
                          pod.group_key)

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "ShardedDispatcher":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="sharded-dispatcher")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop:
            try:
                delay = self.step(self._clock())
            except Exception:
                log.exception("sharded step failed")
                delay = 1.0
            time.sleep(min(delay, 0.2))

    def stop(self, drain: bool = True) -> None:
        if drain and not self._stop:
            try:
                self.step(self._clock())
            except Exception:
                log.exception("drain step on stop failed")
        self._stop = True
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


def make_dispatcher(engine_or_fleet, *, shards: int = 1, **kw):
    """The construction seam: ``shards <= 1`` returns the plain
    single-lock :class:`Dispatcher` (decision-bit-identical to the
    unsharded scheduler — sharding disabled IS the old code path);
    ``shards > 1`` builds a :class:`ShardedDispatcher` over the fleet.
    """
    if shards <= 1:
        if isinstance(engine_or_fleet, SchedulerEngine):
            kw.pop("route", None)
            kw.pop("engine_factory", None)
            return Dispatcher(engine_or_fleet, **kw)
        clock = kw.pop("clock", time.monotonic)
        factory = kw.pop("engine_factory", None)
        eng = (factory(clock) if factory is not None
               else SchedulerEngine(clock=clock))
        fleet = {}
        for node, chips in engine_or_fleet.items():
            healthy = True
            if isinstance(chips, tuple):
                chips, healthy = chips
            fleet[node] = (list(chips), healthy)
        if fleet:
            eng.set_fleet(fleet)
        kw.pop("route", None)
        return Dispatcher(eng, clock=clock, **kw)
    if isinstance(engine_or_fleet, SchedulerEngine):
        raise ValueError("sharded build needs the fleet inventory, "
                         "not a prebuilt engine")
    return build_sharded(engine_or_fleet, shards, **kw)
