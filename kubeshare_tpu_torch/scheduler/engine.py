"""The placement engine — the reference's eight extension points as a
standalone, Kubernetes-independent core.

The port's copy of ``kubeshare_tpu/scheduler/engine.py``.

Re-design of ``pkg/scheduler/scheduler.go:247-587`` + ``pod.go``. The
engine consumes parsed workloads (:mod:`.labels`) and chip inventories
(:mod:`..topology.discovery`), and produces :class:`Binding` records —
the annotations + environment the reference realizes via its delete/
recreate "shadow pod" swap (``scheduler.go:515-528``). That swap changes
the pod UID and is the reference's ugliest behavior (SURVEY §7.0.4); here
the binding is a value an admission webhook / node agent applies, so the
engine stays pure and replayable.

Extension-point parity map:

- ``queue_less``       ≙ Less (scheduler.go:247-267), via :mod:`.podgroup`
- ``pre_filter``       ≙ PreFilter (scheduler.go:275-324)
- ``filter``           ≙ Filter (scheduler.go:332-408 + filter.go)
- ``score``/``normalize_scores`` ≙ Score/NormalizeScore (scheduler.go:415-487)
- ``reserve``          ≙ Reserve (scheduler.go:489-531 + pod.go:348-476)
- ``unreserve``        ≙ Unreserve (scheduler.go:534-549)
- ``permit``           ≙ Permit gang barrier (scheduler.go:551-587)
- ``delete_pod``       ≙ deletePod reclaim (pod.go:91-136)
- ``resync_bound``     ≙ bound-pod crash resync (pod.go:528-617)
"""

from __future__ import annotations

import functools
import math
import re
import time
from dataclasses import dataclass, field

from .. import constants as C
from ..obs import metrics as obs_metrics
from ..obs import slo as obs_slo
from ..obs.trace import get_tracer, new_trace_id
from ..topology.cell import (CellConstructor, FreeList, build_cell_chains,
                             reclaim_resource, reserve_resource,
                             set_node_status)
from ..topology.cellconfig import TopologyConfig, config_from_chips
from ..topology.chip import ChipInfo
from ..utils.bitmap import RRBitmap
from ..utils.logger import get_logger
from .filtering import filter_node
from .labels import LabelError, PodRequest, parse_pod_labels
from .meshselect import node_mesh_shape
from .podgroup import PodGroup, PodGroupRegistry, queue_less
from .scoring import (normalize_scores, score_guarantee_node,
                      score_opportunistic_node, score_regular_node,
                      select_cells)

log = get_logger("scheduler")

PERMIT_WAIT_BASE_S = 2.0  # × headcount (scheduler.go:44,573)

#: per-extension-point wall time. `filter`/`score` are observed once per
#: scheduling cycle as aggregates over the candidate loop — filter also
#: runs inside find_preemption's victim simulation, where a per-call
#: observation would swamp the family with simulation noise.
_PHASE_LAT = obs_metrics.default_registry().histogram(
    "kubeshare_sched_phase_latency_seconds",
    "Scheduler extension-point wall time per scheduling cycle.",
    labels=("phase",))


def _timed_phase(phase: str):
    """Observe real wall time (perf_counter, never the injectable fake
    clock) for one extension point."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()    # wall-clock: metric-only
            try:
                return fn(*args, **kwargs)
            finally:
                _PHASE_LAT.observe(phase,
                    value=time.perf_counter() - t0)  # wall-clock: metric-only
        return wrapper
    return deco


class Unschedulable(RuntimeError):
    pass


@dataclass
class Binding:
    """The realized placement — annotations + env the reference injects
    into its recreated pod (pod.go:348-476), TPU vocabulary."""

    pod_key: str
    node: str
    chip_ids: list[str]
    cell_ids: list[str]
    models: list[str]
    memory: int
    port: int = 0                 # 0 for whole-chip pods (no manager)
    request: float = 0.0          # share params, re-injected as env for
    limit: float = 0.0            # the zero-touch attach shim
    group: str = ""               # gang identity + this member's slot —
    group_size: int = 0           # the jax.distributed contract
    group_rank: int = -1          # (parallel.runner reads these)
    chip_coords: list = field(default_factory=list)  # per-chip mesh coords
    mesh_shape: str = ""          # node mesh ("2x4") the coords live on

    @property
    def annotations(self) -> dict[str, str]:
        ann = {
            C.POD_TPU_CHIP_ID: ",".join(self.chip_ids),
            C.POD_CELL_ID: ",".join(self.cell_ids),
            C.POD_TPU_MEMORY: str(self.memory),
            C.POD_TPU_MODEL: ",".join(self.models),
        }
        if self.port:
            ann[C.POD_MANAGER_PORT] = str(self.port)
        if self.group_rank >= 0:
            # Written back so resync after an engine restart restores the
            # SAME rank — a replacement member must never collide with a
            # live container whose env already says a given process_id.
            ann[C.POD_GROUP_RANK] = str(self.group_rank)
        return ann

    @property
    def env(self) -> dict[str, str]:
        if self.chip_coords and len(self.chip_coords) == len(self.chip_ids):
            # carved sub-mesh: "chip@x.y" entries (doc/gang.md). Seed
            # consumers strip the suffix; parallel.mesh.make_carved_mesh
            # rebuilds the planned block from it.
            from ..gang.carve import carve_env
            env = {C.ENV_VISIBLE_CHIPS: carve_env(self.chip_ids,
                                                  self.chip_coords)}
            if self.mesh_shape:
                env[C.ENV_MESH_SHAPE] = self.mesh_shape
        else:
            env = {C.ENV_VISIBLE_CHIPS: ",".join(self.chip_ids)}
        if self.port:
            env[C.ENV_POD_MANAGER_PORT] = str(self.port)
            env[C.ENV_POD_NAME] = self.pod_key
            # the zero-touch attach shim (kubeshare_tpu/attach.py) reads
            # these to register with the pod's share parameters; the
            # chip-proxy port is node-local and injected by the launcher
            env[C.ENV_TPU_REQUEST] = str(self.request)
            env[C.ENV_TPU_LIMIT] = str(self.limit)
            env[C.ENV_TPU_MEMORY] = str(self.memory)
        if self.group:
            env[C.ENV_GROUP_NAME] = self.group
        if self.group_rank >= 0:
            # FULL gangs only (threshold 1): jax.distributed needs the
            # exact process count at init, and a partial gang released at
            # min_available < headcount would hang every member waiting
            # for processes the scheduler never intends to place. Partial
            # gangs get the group name only (their elasticity story is
            # the workload's, as in the reference's torchelastic
            # manifests). Coordinator address is the manifest's job
            # (headless service on rank 0) — see parallel/runner.py.
            env[C.ENV_NUM_PROCESSES] = str(self.group_size)
            env[C.ENV_PROCESS_ID] = str(self.group_rank)
        return env


class SchedulerEngine:
    """Placement engine over the cell resource model."""

    def __init__(self, config: TopologyConfig | None = None,
                 permit_wait_base_s: float = PERMIT_WAIT_BASE_S,
                 mesh_shape: tuple[int, ...] | None = None,
                 clock=time.monotonic):
        self._config = config
        self._auto_config = config is None
        self.elements = None
        self.chip_priority: dict[str, int] = {}
        self.free_list: FreeList = {}
        self.leaf_cells: dict = {}
        self.chips_by_node: dict[str, dict[str, list[ChipInfo]]] = {}
        self.node_health: dict[str, bool] = {}
        #: health the capacity feed *reported*, before the veto below —
        #: needed to restore a node when its veto lifts
        self._reported_health: dict[str, bool] = {}
        #: nodes the healthwatch holds out of scoring (dead/quarantined).
        #: Capacity and health are independent axes: a capacity re-put
        #: with healthy=True must NOT resurrect a vetoed node — only
        #: :meth:`veto_health` lifts the veto (doc/health.md).
        self.health_veto: set[str] = set()
        self.ports: dict[str, RRBitmap] = {}
        self.pod_status: dict[str, PodRequest] = {}
        self.groups = PodGroupRegistry(clock=clock)
        self.permit_wait_base_s = permit_wait_base_s
        self.mesh_shape = mesh_shape
        self._clock = clock
        self._fleet_snapshot: tuple | None = None
        self._nodes_cache: list[str] | None = None
        #: decision recorder (set by Dispatcher.attach_decisions): when
        #: present, trace-id entropy is drawn through it so a shadow
        #: replay reproduces the recorded ids (doc/replay.md)
        self.decisions = None
        self.rebuild_count = 0   # topology rebuilds since start
        #: bumped whenever chip capacity can have changed (bookings,
        #: reclaims, topology/health changes) — consumed by the gang
        #: planner's negative memoization
        self.alloc_gen = 0
        if config is not None:
            self._build(config)

    # -- topology ----------------------------------------------------------

    def _build(self, config: TopologyConfig) -> None:
        self._config = config
        self.elements, self.chip_priority = build_cell_chains(config.cell_types)
        self.free_list = CellConstructor(self.elements, config.cells).build()

    def add_node(self, node_name: str, chips: list[ChipInfo],
                 healthy: bool = True) -> None:
        """Feed one node's chip inventory (≙ addNode + getGPUByNode +
        setNodeStatus, node.go:28-52). With no explicit cluster config the
        topology is auto-derived from the accumulated fleet (SURVEY §7.0.2
        — topology is discoverable on TPU; the reference requires a
        hand-written file). Auto-derivation rebuilds the cell trees on
        every new node and re-books live workloads onto the fresh trees —
        the same replay the crash resync performs."""
        known = node_name in self.chips_by_node
        self.alloc_gen += 1
        self._nodes_cache = None
        self._fleet_snapshot = None   # per-node edits invalidate the
        by_model: dict[str, list[ChipInfo]] = {}  # set_fleet no-op check
        for chip in chips:
            by_model.setdefault(chip.model, []).append(chip)
        changed = not known or self.chips_by_node[node_name] != by_model
        self.chips_by_node[node_name] = by_model
        self._reported_health[node_name] = healthy
        self.node_health[node_name] = (healthy
                                       and node_name not in self.health_veto)
        if node_name not in self.ports:
            bitmap = RRBitmap(C.POD_MANAGER_PORT_RANGE)
            bitmap.mask(0)  # parity: port base is never handed out
            self.ports[node_name] = bitmap
        if self._auto_config and (changed or self._config is None):
            self._rebuild_auto_config()
        else:
            if known and changed and not self._auto_config:
                log.warning("node %s inventory changed under an explicit "
                            "topology config; cells keep the configured "
                            "shape", node_name)
            set_node_status(self.free_list, self.chips_by_node,
                            self.leaf_cells, node_name,
                            self.node_health[node_name])

    def set_fleet(self, fleet: dict[str, tuple[list[ChipInfo], bool]]) -> None:
        """Batch inventory update: one rebuild for the whole fleet instead
        of one per node (the full-sync path). Nodes absent from *fleet*
        are removed — a departed collector's capacity must not stay
        schedulable (port bitmaps are kept so masks survive a flap).

        No-op when nothing changed: the service syncs capacity before
        every scheduling pass, and in auto-config mode an unconditional
        rebuild would reconstruct all cell trees and re-book every live
        pod per decision — O(cluster x pods) for a pod placed."""
        snapshot = tuple(sorted(
            (node, healthy, tuple(sorted(chips, key=lambda c: c.chip_id)))
            for node, (chips, healthy) in fleet.items()))
        if snapshot == self._fleet_snapshot:
            return
        self._fleet_snapshot = snapshot
        self._nodes_cache = None
        for gone in set(self.chips_by_node) - set(fleet):
            del self.chips_by_node[gone]
            self.node_health.pop(gone, None)
            self._reported_health.pop(gone, None)
            # the veto is NOT cleared: a dead node flapping out of and
            # back into the fleet stays quarantined until recovery
            log.info("node %s left the fleet", gone)
        for node_name, (chips, healthy) in fleet.items():
            by_model: dict[str, list[ChipInfo]] = {}
            for chip in chips:
                by_model.setdefault(chip.model, []).append(chip)
            self.chips_by_node[node_name] = by_model
            self._reported_health[node_name] = healthy
            self.node_health[node_name] = (
                healthy and node_name not in self.health_veto)
            if node_name not in self.ports:
                bitmap = RRBitmap(C.POD_MANAGER_PORT_RANGE)
                bitmap.mask(0)
                self.ports[node_name] = bitmap
        if self._auto_config:
            self._rebuild_auto_config()
        else:
            for node_name in fleet:
                set_node_status(self.free_list, self.chips_by_node,
                                self.leaf_cells, node_name,
                                self.node_health[node_name])

    def _rebuild_auto_config(self) -> None:
        self.rebuild_count += 1
        self.alloc_gen += 1
        all_chips = [c for models in self.chips_by_node.values()
                     for chips_ in models.values() for c in chips_]
        self._build(config_from_chips(all_chips))
        self.leaf_cells.clear()
        for node, healthy in self.node_health.items():
            set_node_status(self.free_list, self.chips_by_node,
                            self.leaf_cells, node, healthy)
        # replay live bookings onto the fresh trees, amount-exact (ports
        # stay masked — the bitmaps are per-node state, untouched)
        for pod in self.pod_status.values():
            if not pod.bookings:
                continue
            pod.cells = [self.leaf_cells[cid] for cid, _, _ in pod.bookings
                         if cid in self.leaf_cells]
            for chip_id, compute, memory in pod.bookings:
                cell = self.leaf_cells.get(chip_id)
                if cell is not None:
                    reserve_resource(cell, compute, memory)

    def set_node_health(self, node_name: str, healthy: bool) -> None:
        self._fleet_snapshot = None
        self.alloc_gen += 1
        self._reported_health[node_name] = healthy
        effective = healthy and node_name not in self.health_veto
        self.node_health[node_name] = effective
        set_node_status(self.free_list, self.chips_by_node, self.leaf_cells,
                        node_name, effective)

    def veto_health(self, node_name: str, vetoed: bool) -> None:
        """Hold a node out of scoring regardless of its reported health
        (the healthwatch's dead/quarantined hold, doc/health.md). The
        veto survives capacity re-puts — ``put_capacity`` for a
        quarantined node must not resurrect it; lifting the veto
        restores whatever health the capacity feed last reported."""
        if vetoed == (node_name in self.health_veto):
            return
        if vetoed:
            self.health_veto.add(node_name)
        else:
            self.health_veto.discard(node_name)
        if node_name in self.chips_by_node:
            self.set_node_health(
                node_name, self._reported_health.get(node_name, True))
        else:
            # not (currently) in the fleet: nothing to re-status, but the
            # next identical-capacity sync must still re-apply the veto
            self._fleet_snapshot = None

    @property
    def nodes(self) -> list[str]:
        # cached: schedule() reads this per placement, and re-sorting
        # 1k node names 100k times is real money at fleet scale; the
        # only membership mutators (add_node/set_fleet) invalidate it
        cached = self._nodes_cache
        if cached is None:
            cached = self._nodes_cache = sorted(self.chips_by_node)
        return cached

    # -- workload intake ---------------------------------------------------

    def submit(self, namespace: str, name: str, labels: dict,
               uid: str = "") -> PodRequest:
        """Parse + register a workload (≙ the pod informer's addPod +
        getPodLabels caching, pod.go:47-78,207-218)."""
        pod = parse_pod_labels(namespace, name, labels, uid=uid)
        cached = self.pod_status.get(pod.key)
        if cached is not None:
            if not uid or cached.uid == uid:
                return cached
            # Same key, new incarnation: the old pod's bookings would leak
            # forever if simply overwritten (its delete event can no longer
            # find them).
            self._reclaim(cached)
        pod.timestamp = self._clock()
        # root span of the pod's timeline: opened here, closed at
        # delete_pod; everything downstream (queue-wait, filter, reserve,
        # bind, token-grant) keys off this trace ID
        pod.trace_id = (new_trace_id() if self.decisions is None  # entropy: recorded
                        else self.decisions.rng_draw_hex(
                            "trace-id", pod.timestamp))
        pod.trace_span = get_tracer().begin("submit", pod.trace_id,
                                            pod=pod.key)
        if pod.slo_specs:
            # objectives are per tenant (namespace); declaring is
            # idempotent, so every pod of the tenant may restate them
            obs_slo.default_evaluator().declare(pod.namespace,
                                                pod.slo_specs)
        self.pod_status[pod.key] = pod
        self.groups.get_or_create(pod)
        return pod

    def group_of(self, pod: PodRequest) -> PodGroup:
        return self.groups.get_or_create(pod)

    def queue_less(self, pod_a: PodRequest, pod_b: PodRequest) -> bool:
        return queue_less(pod_a, self.group_of(pod_a),
                          pod_b, self.group_of(pod_b))

    def _group_members(self, pod: PodRequest) -> list[PodRequest]:
        if not pod.group_name:
            return []
        return [p for p in self.pod_status.values()
                if p.group_name == pod.group_name
                and p.namespace == pod.namespace]

    def _group_cells(self, pod: PodRequest) -> list:
        return [cell for member in self._group_members(pod)
                for cell in member.cells]

    # -- extension points --------------------------------------------------

    @_timed_phase("pre_filter")
    def pre_filter(self, pod: PodRequest) -> tuple[bool, str]:
        """Gang sanity gate (PreFilter, scheduler.go:275-324); label
        validity was already enforced at parse time."""
        group = self.group_of(pod)
        if not group.key:
            return True, "regular pod"
        if pod.min_available != group.min_available:
            return False, (f"pod min_available {pod.min_available} != group "
                           f"{group.name} min_available {group.min_available}")
        if pod.priority != group.priority:
            return False, (f"pod priority {pod.priority} != group "
                           f"{group.name} priority {group.priority}")
        total = len(self._group_members(pod))
        if total < group.min_available:
            return False, (f"group {group.name} has {total} pods < "
                           f"min_available {group.min_available}")
        self._ensure_gang_plan(pod, group)
        return True, ""

    @staticmethod
    def _plan_eligible(pod: PodRequest, group) -> bool:
        """Only a whole-chip member whose ask matches the plan's slot
        size AND model may take (or be constrained/steered by) a slot —
        a heterogeneous, fractional, or differently-model-pinned member
        consuming a slot would be silently mis-allocated, and
        constraining such a member to the planned nodes could deadlock
        it (a v5e-pinned pod steered onto a v4 block passes no filter
        anywhere)."""
        per = int(pod.request)
        if per < 1 or pod.request != per:
            return False
        if group.plan is None:
            return True
        if pod.model and group.plan_model and pod.model != group.plan_model:
            return False
        return bool(group.plan) and per == len(group.plan[0][1])

    def _ensure_gang_plan(self, pod: PodRequest, group) -> None:
        """Compute the gang's cross-host shape-aware placement once, when
        its first whole-chip member reaches PreFilter (gangplan module).
        Re-planning is allowed only while no member holds cells — after
        that, a fresh plan could contradict placements already made. A failed attempt is memoized per
        allocation generation: the fleet-wide block enumeration only
        re-runs after capacity actually changed."""
        if group.plan is not None or not pod.needs_tpu:
            return
        per = int(pod.request)
        if per < 1 or pod.request != per:
            return  # fractional members: locality scoring is the tool
        if group.plan_stale_gen == self.alloc_gen:
            return  # failed at this capacity state already
        if any(m.cells for m in self._group_members(pod)):
            return
        from .gangplan import fleet_leaf_cells, plan_gang

        models = ([pod.model] if pod.model else
                  sorted(self.chip_priority,
                         key=lambda m: -self.chip_priority.get(m, 0))
                  or [""])
        for model in models:
            leaves = fleet_leaf_cells(self.free_list, self.nodes, model)
            plan = plan_gang(leaves, group.headcount, per)
            if plan is not None:
                group.plan = plan
                group.plan_taken = {}
                group.plan_checked_gen = self.alloc_gen
                # the model the block was enumerated over (for "" pods,
                # the model of the chips actually chosen)
                group.plan_model = (model or
                                    self.leaf_cells[plan[0][1][0]].cell_type)
                log.info("gang %s planned: %d members x %d chip(s) of %s "
                         "over %s", group.name, group.headcount, per,
                         group.plan_model, {n for n, _ in plan})
                return
        group.plan_stale_gen = self.alloc_gen

    def _slot_intact(self, chip_ids) -> bool:
        for chip_id in chip_ids:
            cell = self.leaf_cells.get(chip_id)
            if (cell is None or not cell.healthy
                    or cell.available != cell.leaf_cell_number):
                return False
        return True

    def _plan_slot_for(self, group, pod: PodRequest,
                       node_name: str) -> int | None:
        """The plan slot this pod would consume on *node_name*: its rank's
        slot when it lives there and is free, else the first free slot on
        the node; None when the node has no free slot.

        Freshness is checked here, on the FILTER path: if any free slot's
        chips were poached since planning (members bind across cycles;
        unarrived members' chips are not booked), the whole plan is
        invalidated immediately — a stale plan must not keep steering the
        gang toward nodes that can no longer hold it (liveness: filter
        would otherwise reject every node forever)."""
        if group.plan is None:
            return None
        held = group.plan_taken.get(pod.key)
        if held is not None:  # idempotent: a retrying pod keeps its slot
            return held if group.plan[held][0] == node_name else None
        taken = set(group.plan_taken.values())
        if group.plan_checked_gen != self.alloc_gen:
            # Intactness can only change when capacity moved — memoized
            # per allocation generation (filter runs per node per cycle).
            for i, (_, chip_ids) in enumerate(group.plan):
                if i not in taken and not self._slot_intact(chip_ids):
                    log.info("gang %s plan invalidated: slot %d no "
                             "longer whole-free", group.name, i)
                    group.plan = None
                    group.plan_taken = {}
                    return None
            group.plan_checked_gen = self.alloc_gen
        rank = pod.group_rank
        if (0 <= rank < len(group.plan) and rank not in taken
                and group.plan[rank][0] == node_name):
            return rank
        for i, (node, _) in enumerate(group.plan):
            if node == node_name and i not in taken:
                return i
        return None

    def filter(self, pod: PodRequest, node_name: str) -> tuple[bool, str]:
        if not pod.needs_tpu:
            return True, ""
        ports = self.ports.get(node_name)
        if ports is None:
            return False, f"unknown node {node_name}"
        if pod.group_name:
            group = self.group_of(pod)
            if (group.plan is not None and self._plan_eligible(pod, group)
                    and self._plan_slot_for(group, pod, node_name) is None
                    and group.plan is not None):
                # (the second plan check matters: _plan_slot_for may have
                # just invalidated a stale plan — then this node must fall
                # through to normal filtering, not lose the cycle)
                # The gang has a contiguous multi-host block planned and
                # this node holds no free slot of it — placing a member
                # here would scatter the gang off its sub-mesh.
                return False, (f"node {node_name} not in gang "
                               f"{group.name}'s planned sub-mesh")
        if not pod.multi_chip and ports.count() >= C.POD_MANAGER_PORT_RANGE:
            return False, f"node {node_name} pod-manager port pool exhausted"
        models = self.chips_by_node.get(node_name, {})
        if pod.model:
            if pod.model not in models:
                return False, (f"node {node_name} has no {pod.model} chips")
            fit, _, _ = filter_node(self.free_list, node_name, pod.model,
                                    pod.request, pod.memory)
            return (fit, "" if fit else
                    f"node {node_name} cannot fit {pod.request}")
        # Per-model fit only — never summed across models. For multi-chip
        # pods a cross-model sum would admit a mesh workload spanning chip
        # generations (the reference's bug, scheduler.go:395-404); for
        # shared pods the sum is meaningless anyway (one leaf must fit).
        for model in models:
            fit, _, _ = filter_node(
                self.free_list, node_name, model, pod.request, pod.memory)
            if fit:
                return True, ""
        return False, f"node {node_name} cannot fit {pod.request}"

    #: added to a node's score when it holds the pod's own rank-slot of
    #: the gang plan — large enough to dominate the per-leaf formulas, so
    #: ranks land along the planned block (ring collectives then run on
    #: ICI neighbours) instead of in arrival order
    PLAN_RANK_BONUS = 10000.0

    def score(self, pod: PodRequest, node_name: str) -> float:
        from .filtering import node_leaf_cells
        if not pod.needs_tpu:
            return score_regular_node(bool(self.chips_by_node.get(node_name)))
        leaves = node_leaf_cells(self.free_list, node_name, pod.model)
        if pod.opportunistic:
            base = score_opportunistic_node(leaves, self.chip_priority)
        else:
            base = score_guarantee_node(leaves, self.chip_priority,
                                        self._group_cells(pod),
                                        self.mesh_shape)
        if pod.group_name:
            group = self.group_of(pod)
            if group.plan is not None and self._plan_eligible(pod, group):
                rank = self._prospective_rank(pod, group)
                if (rank is not None and rank < len(group.plan)
                        and rank not in group.plan_taken.values()
                        and group.plan[rank][0] == node_name):
                    base += self.PLAN_RANK_BONUS
        return base

    def _name_ordinals(self, pod: PodRequest) -> tuple[dict, bool]:
        """Trailing name ordinals of the gang's members + whether they
        are CLEAN (distinct, covering exactly [0, headcount) — the
        StatefulSet convention). Shared by rank preference at reserve
        time and plan-slot steering at score time, so the two can never
        diverge."""
        ordinals = {}
        for m in self._group_members(pod):
            match = re.search(r"(\d+)$", m.name)
            ordinals[m.key] = int(match.group(1)) if match else -1
        clean = (len(ordinals) == pod.headcount
                 and sorted(ordinals.values()) == list(range(pod.headcount)))
        return ordinals, clean

    def _prospective_rank(self, pod: PodRequest, group) -> int | None:
        """The rank this pod will get at reserve time, when predictable:
        its held rank, else its clean name ordinal."""
        if pod.group_rank >= 0:
            return pod.group_rank
        ordinals, clean = self._name_ordinals(pod)
        return ordinals[pod.key] if clean else None

    normalize_scores = staticmethod(normalize_scores)

    def carve_annotation(self, node_name: str, cells) -> dict:
        """Sub-mesh carve fields for a Binding (doc/gang.md): the chosen
        cells' mesh coords normalized to the node origin, plus the node
        mesh shape — {} when the node's leaves carry no usable
        coordinates, in which case the seed env format applies."""
        if not cells or any(not getattr(c, "coords", None) for c in cells):
            return {}
        leaves = [leaf for leaf in self.leaf_cells.values()
                  if leaf.node == node_name]
        derived = node_mesh_shape(leaves)
        if derived is None:
            return {}
        from ..gang.carve import format_mesh
        origin, mesh = derived
        coords = [tuple(x - o for x, o in zip(c.coords, origin))
                  for c in cells]
        return {"chip_coords": coords, "mesh_shape": format_mesh(mesh)}

    @_timed_phase("reserve")
    def reserve(self, pod: PodRequest, node_name: str) -> Binding:
        """Pick cells, book them, allocate the manager port, emit the
        binding (Reserve, scheduler.go:489-531 + pod.go:348-476)."""
        full_gang = (pod.group_name
                     and pod.min_available == pod.headcount)
        if full_gang and pod.group_rank < 0:
            # Rank = jax.distributed process_id: unique and dense in
            # [0, headcount), freed on unreserve/delete. The pod name's
            # trailing ordinal is PREFERRED when free ("...-0" gets rank
            # 0 regardless of scheduling order) so manifests can wire the
            # coordinator address to the -0 member deterministically;
            # otherwise smallest free. All ranks held (a replacement
            # racing the dead member's delete event) → unschedulable
            # until one frees, never a duplicate or out-of-range id.
            taken = {m.group_rank for m in self._group_members(pod)
                     if m.group_rank >= 0}
            free = [r for r in range(pod.headcount) if r not in taken]
            if not free:
                raise Unschedulable(
                    f"{pod.key}: all {pod.headcount} ranks of gang "
                    f"{pod.group_name} are held; delete a member first")
            pod.group_rank = self._preferred_rank(pod, free)
        group_kw = dict(group=pod.group_name, group_size=pod.headcount,
                        group_rank=pod.group_rank) if pod.group_name else {}
        if not pod.needs_tpu:
            pod.node_name = node_name
            return Binding(pod.key, node_name, [], [], [], 0, **group_kw)
        cells = self._consume_plan_slot(pod, node_name) or select_cells(
            self.free_list, node_name, pod, self.chip_priority,
            self._group_cells(pod), self.mesh_shape)
        if not cells:
            raise Unschedulable(
                f"{pod.key}: no cell on {node_name} fits "
                f"request={pod.request} memory={pod.memory}")
        pod.node_name = node_name
        pod.cells = cells
        pod.chip_ids = [c.chip_id for c in cells]
        if pod.group_name or pod.multi_chip:
            # sub-mesh carve (doc/gang.md): annotate the binding with the
            # selected cells' mesh coords so the env renders "chip@x.y"
            # and the gang's runner can rebuild the planned block
            group_kw.update(self.carve_annotation(node_name, cells))
        if pod.multi_chip:
            # whole leaves: book everything they have (pod.go:360-366),
            # recording the exact amounts — free memory at bind time, not
            # full memory — so reclaim can mirror them.
            memory = 0
            self.alloc_gen += 1
            for cell in cells:
                pod.bookings.append(
                    (cell.chip_id, cell.available, cell.free_memory))
                memory += cell.free_memory
                reserve_resource(cell, cell.available, cell.free_memory)
            pod.memory = memory
            return Binding(pod.key, node_name, pod.chip_ids,
                           [c.id for c in cells],
                           [c.cell_type for c in cells], memory,
                           **group_kw)
        cell = cells[0]
        memory_defaulted = pod.memory == 0
        if memory_defaulted:
            # default the HBM cap to the compute fraction of the chip
            # (pod.go:419-424)
            pod.memory = int(math.floor(pod.request * cell.full_memory))
        offset = self.ports[node_name].find_next_and_set()
        if offset < 0:
            # roll the assignment back completely — a half-populated pod
            # would double-reclaim on the framework's unreserve call, and
            # a kept default cap would carry this chip's HBM size to the
            # retry on a different chip generation
            pod.cells = []
            pod.chip_ids = []
            pod.node_name = ""
            if memory_defaulted:
                pod.memory = 0
            self._release_plan_slot(pod)
            raise Unschedulable(f"node {node_name} port pool exhausted")
        self.alloc_gen += 1
        reserve_resource(cell, pod.request, pod.memory)
        pod.bookings.append((cell.chip_id, pod.request, pod.memory))
        pod.port = C.POD_MANAGER_PORT_START + offset
        return Binding(pod.key, node_name, pod.chip_ids, [cell.id],
                       [cell.cell_type], pod.memory, pod.port,
                       request=pod.request, limit=pod.limit, **group_kw)

    def _consume_plan_slot(self, pod: PodRequest,
                           node_name: str) -> list | None:
        """Resolve and claim the gang-plan slot for this pod on this node;
        None (with the plan invalidated when stale) falls back to
        node-local selection."""
        if not pod.group_name:
            return None
        group = self.group_of(pod)
        if group.plan is None or not self._plan_eligible(pod, group):
            return None
        slot_id = self._plan_slot_for(group, pod, node_name)
        if slot_id is None:
            return None
        _, chip_ids = group.plan[slot_id]
        cells = []
        for chip_id in chip_ids:
            cell = self.leaf_cells.get(chip_id)
            if (cell is None or not cell.healthy or cell.node != node_name
                    or cell.available != cell.leaf_cell_number):
                # A planned chip was taken/unbound since planning (gang
                # members bind across cycles; unarrived members' chips
                # are not yet booked). The block is broken — drop the
                # plan; placed members keep their cells, the rest fall
                # back to node-local selection.
                log.info("gang %s plan invalidated: chip %s no longer "
                         "whole-free on %s", group.name, chip_id,
                         node_name)
                group.plan = None
                group.plan_taken = {}
                return None
            cells.append(cell)
        group.plan_taken[pod.key] = slot_id
        return cells

    def _release_plan_slot(self, pod: PodRequest) -> None:
        if not pod.group_name:
            return
        group = self.groups.get_or_create(pod)
        group.plan_taken.pop(pod.key, None)

    def _preferred_rank(self, pod: PodRequest, free: list[int]) -> int:
        """Name-ordinal rank, applied ALL-or-nothing: only when every gang
        member's name carries a distinct trailing ordinal covering exactly
        [0, headcount) (the StatefulSet convention) does "...-0" get rank
        0 — a half-applied preference could land process_id 0 on a pod
        other than the one the manifest wired as coordinator. Otherwise
        smallest free, with a log line so the mismatch is diagnosable."""
        ordinals, clean = self._name_ordinals(pod)
        if clean and ordinals[pod.key] in free:
            return ordinals[pod.key]
        if not clean:
            log.info("gang %s: member names are not dense 0-indexed "
                     "ordinals (%s); assigning ranks by arrival — wire "
                     "the coordinator address to the rank-0 annotation, "
                     "not a fixed pod name", pod.group_name,
                     sorted(ordinals.values()))
        else:
            # Clean names but this pod's ordinal is held (e.g. ranks
            # restored from a pre-ordinal resync): the coordinator may
            # not live on the '-0' pod — say so, it is the one mismatch
            # a name-wired manifest cannot survive silently.
            log.warning("gang %s: %s's name-ordinal %d is already held; "
                        "assigning %d — coordinator wiring by pod name "
                        "may not match rank 0", pod.group_name, pod.name,
                        ordinals[pod.key], free[0])
        return free[0]

    @_timed_phase("find_preemption")
    def find_preemption(self, pod: PodRequest,
                        nodes: list[str] | None = None) -> dict | None:
        """Victim search for a blocked GUARANTEE pod: the fewest
        opportunistic bookings on one node whose removal lets *pod* pass
        filtering. Returns ``{"node", "victims": [pod keys]}`` or None.

        Pure simulation — victims' bookings are temporarily reclaimed,
        filtering re-run, and everything restored EXACTLY before
        returning; actually evicting is the control plane's job (the
        dispatcher requests it, the bridge deletes the pods, the normal
        DELETED event reclaims for real).

        Extends the reference's priority semantics (opportunistic pods
        are explicitly the displaceable filler, ``constants.go:13-15``,
        ``README.md:41-43``) with the displacement itself — the
        reference never evicts, so a late guarantee pod starves behind
        opportunistic ones until they exit on their own.
        """
        if not pod.needs_tpu or pod.opportunistic:
            return None
        best: dict | None = None
        for node in (nodes if nodes is not None else list(self.nodes)):
            fit, why = self.filter(pod, node)
            if fit:
                # the block is NOT capacity on this node (a reserve-time
                # refusal, e.g. gang rank exhaustion) — evictions here
                # would kill filler without ever unblocking the pod
                continue
            if "cannot fit" not in why:
                # non-capacity failure (model mismatch, port pool, gang
                # sub-mesh): no amount of eviction produces a fit — skip
                # the whole simulation on this node
                continue
            candidates = [
                p for p in self.pod_status.values()
                if p.node_name == node and p.opportunistic and p.bookings
                and not (pod.group_name and p.group_key == pod.group_key)
            ]
            # Cheapest eviction first: lowest priority, then SMALLEST
            # blast radius (a gang member drags its whole gang with it —
            # preferring standalone pods keeps the victim count at what
            # the fit actually needs), then newest (least sunk work).
            def eviction_cost(p):
                gang_size = (len(self._group_members(p)) if p.group_name
                             else 1)
                return (p.priority, gang_size, -p.timestamp)

            candidates.sort(key=eviction_cost)
            reclaimed: list[PodRequest] = []
            plan: dict | None = None
            try:
                for victim in candidates:
                    for chip_id, compute, memory in victim.bookings:
                        cell = self.leaf_cells.get(chip_id)
                        if cell is not None:
                            reclaim_resource(cell, compute, memory)
                    reclaimed.append(victim)
                    fit, _ = self.filter(pod, node)
                    if fit:
                        # Drop greedily-taken victims that contributed
                        # nothing: re-reserve each (newest-first) and
                        # keep it OUT of the plan if the pod still fits
                        # without its chips (the fit may have come from
                        # a later, unrelated chip).
                        needed = []
                        for v in reversed(reclaimed):
                            for chip_id, compute, memory in v.bookings:
                                cell = self.leaf_cells.get(chip_id)
                                if cell is not None:
                                    reserve_resource(cell, compute,
                                                     memory)
                            still_fit, _ = self.filter(pod, node)
                            if still_fit:
                                continue          # v was unnecessary
                            for chip_id, compute, memory in v.bookings:
                                cell = self.leaf_cells.get(chip_id)
                                if cell is not None:
                                    reclaim_resource(cell, compute,
                                                     memory)
                            needed.append(v)
                        # evicting part of a gang strands the rest —
                        # the eviction list pulls in whole groups
                        keys: list[str] = []
                        for v in needed:
                            if v.group_name:
                                keys.extend(m.key for m in
                                            self._group_members(v)
                                            if m.key not in keys)
                            elif v.key not in keys:
                                keys.append(v.key)
                        # restore state for the victims we kept reclaimed
                        reclaimed = needed
                        plan = {"node": node, "victims": keys}
                        break
            finally:
                for victim in reclaimed:
                    for chip_id, compute, memory in victim.bookings:
                        cell = self.leaf_cells.get(chip_id)
                        if cell is not None:
                            reserve_resource(cell, compute, memory)
            if plan is not None and (best is None or
                                     len(plan["victims"])
                                     < len(best["victims"])):
                best = plan
        return best

    def unreserve(self, pod: PodRequest) -> list[str]:
        """Roll back a reservation; returns group members that should be
        rejected with it (Unreserve, scheduler.go:534-549)."""
        self._reclaim(pod)
        if not pod.group_name:
            return []
        return [p.key for p in self._group_members(pod) if p.key != pod.key]

    def permit(self, pod: PodRequest) -> tuple[str, float]:
        """Gang barrier: ``("allow", 0)`` when enough members are bound,
        else ``("wait", timeout_s)`` (Permit, scheduler.go:551-587)."""
        group = self.group_of(pod)
        if not group.key:
            return "allow", 0.0
        bound = sum(1 for p in self._group_members(pod)
                    if p.node_name and p.key != pod.key)
        if bound + 1 < group.min_available:
            return "wait", self.permit_wait_base_s * group.headcount
        return "allow", 0.0

    # -- lifecycle ---------------------------------------------------------

    def _reclaim(self, pod: PodRequest) -> None:
        # Reclaim exactly what reserve/resync booked — the recorded
        # amounts, not re-derived ones (a multi-chip leaf's free memory at
        # bind time is not its full memory when a fraction already lived
        # there).
        if pod.bookings:
            self.alloc_gen += 1
        for chip_id, compute, memory in pod.bookings:
            cell = self.leaf_cells.get(chip_id)
            if cell is not None:
                reclaim_resource(cell, compute, memory)
        pod.bookings = []
        pod.group_rank = -1       # rank returns to the gang's free pool
        self._release_plan_slot(pod)
        if pod.port:
            self.ports[pod.node_name].unmask(
                pod.port - C.POD_MANAGER_PORT_START)
            pod.port = 0
        pod.cells = []
        pod.chip_ids = []
        pod.node_name = ""

    def delete_pod(self, pod_key: str) -> None:
        """Reclaim a finished/removed workload (deletePod, pod.go:91-136)."""
        pod = self.pod_status.pop(pod_key, None)
        if pod is None:
            return
        if pod.trace_span is not None:
            get_tracer().finish(pod.trace_span)
            pod.trace_span = None
        self._reclaim(pod)
        if pod.group_name and not any(
                p.group_name == pod.group_name
                and p.namespace == pod.namespace
                for p in self.pod_status.values()):
            self.groups.mark_expired(pod.group_key)
        # Opportunistic GC (the dispatcher also runs it on a 30s cadence,
        # scheduler.go:233): without it a long-running engine accumulates
        # expired group entries indefinitely.
        self.groups.gc()

    def resync_bound(self, namespace: str, name: str, labels: dict,
                     annotations: dict, node_name: str,
                     uid: str = "") -> PodRequest:
        """Re-book an already-bound workload after an engine restart from
        the annotations written at reserve time (processBoundPod/
        setPodStatus, pod.go:547-617) — state reconstruction without any
        persisted store. Idempotent: a pod already booked (startup
        replay, then a per-pod /resync of the same key) is reclaimed
        first, never double-booked."""
        cached = self.pod_status.get(f"{namespace}/{name}")
        if cached is not None:
            self._reclaim(cached)
        pod = parse_pod_labels(namespace, name, labels, uid=uid,
                               node_name=node_name, lenient=True)
        pod.timestamp = self._clock()
        self.pod_status[pod.key] = pod
        self.groups.get_or_create(pod)
        memory = int(annotations.get(C.POD_TPU_MEMORY, "0") or 0)
        chip_ids = [c for c in
                    annotations.get(C.POD_TPU_CHIP_ID, "").split(",") if c]
        cells = []
        for chip_id in chip_ids:
            cell = self.leaf_cells.get(chip_id)
            if cell is None:
                log.warning("resync %s: chip %s not in topology",
                            pod.key, chip_id)
                continue
            cells.append(cell)
            if pod.multi_chip:
                booked = (cell.leaf_cell_number, cell.full_memory)
            else:
                booked = (pod.request, memory)
            pod.bookings.append((chip_id, *booked))
            self.alloc_gen += 1
            reserve_resource(cell, *booked)
        pod.cells = cells
        pod.chip_ids = [c.chip_id for c in cells]
        pod.memory = memory
        rank = annotations.get(C.POD_GROUP_RANK, "")
        if rank != "":
            # The live container's env already carries this process_id —
            # restoring it keeps replacements from colliding with it.
            pod.group_rank = int(rank)
        port = int(annotations.get(C.POD_MANAGER_PORT, "0") or 0)
        if (C.POD_MANAGER_PORT_START <= port
                < C.POD_MANAGER_PORT_START + C.POD_MANAGER_PORT_RANGE
                and node_name in self.ports):
            self.ports[node_name].mask(port - C.POD_MANAGER_PORT_START)
            pod.port = port
        elif port:
            log.warning("resync %s: port %d outside the pool, ignored",
                        pod.key, port)
        return pod

    # -- one full scheduling cycle (the framework loop, for tests/sim) -----

    def schedule(self, pod: PodRequest,
                 nodes: list[str] | None = None) -> Binding:
        tracer = get_tracer()
        parent = pod.trace_span.span_id if pod.trace_span else ""
        ok, msg = self.pre_filter(pod)
        if not ok:
            raise Unschedulable(f"{pod.key}: {msg}")
        candidates = []
        with tracer.span("filter", pod.trace_id, parent) as fspan:
            t0 = time.perf_counter()    # wall-clock: metric-only
            for node in (nodes if nodes is not None else self.nodes):
                fit, why = self.filter(pod, node)
                if fit:
                    candidates.append(node)
                else:
                    log.debug("filter: %s rejected %s: %s",
                              node, pod.key, why)
            _PHASE_LAT.observe("filter",
                value=time.perf_counter() - t0)  # wall-clock: metric-only
            fspan.attrs["candidates"] = len(candidates)
        if not candidates:
            raise Unschedulable(f"{pod.key}: no node passed filtering")
        t0 = time.perf_counter()        # wall-clock: metric-only
        raw = {node: self.score(pod, node) for node in candidates}
        norm = self.normalize_scores(raw)
        _PHASE_LAT.observe("score",
            value=time.perf_counter() - t0)  # wall-clock: metric-only
        # Walk candidates best-first: a reserve-time refusal (select_cells
        # sees different constraints than the filter DFS, e.g. raced
        # capacity) falls back to the next-ranked node instead of aborting
        # the whole cycle on a feasible pod.
        last_err: Unschedulable | None = None
        with tracer.span("reserve", pod.trace_id, parent) as rspan:
            for node in sorted(candidates, key=lambda n: (norm[n], n),
                               reverse=True):
                try:
                    binding = self.reserve(pod, node)
                    rspan.attrs["node"] = node
                    return binding
                except Unschedulable as err:
                    last_err = err
        raise last_err if last_err is not None else Unschedulable(pod.key)
