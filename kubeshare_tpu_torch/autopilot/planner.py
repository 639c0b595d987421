"""Fragmentation scoring + bounded migration planning (doc/autopilot.md).

The port's copy of ``kubeshare_tpu/autopilot/planner.py``.

The planner is the *decision* half of the autopilot's placement loop: it
reads the engine's capacity view under the dispatcher lock, scores how
much fractional free capacity is stranded (free slivers no whole-chip
pod can use), and emits a bounded, simulated-and-verified batch of
migration moves. Nothing here mutates durable state — every candidate
move-set is trial-booked on the real engine (the same select_cells the
apply path will run, so prediction and execution cannot diverge) and
rolled back before the plan is returned.

Safety rails (ParvaGPU's re-packing discipline):
  * hysteresis — a plan below ``min_improvement`` (relative) is dropped;
  * per-pod move cooldown — a pod migrated recently is not a candidate;
  * never move onto a health-vetoed node;
  * per-cycle migration budget — at most ``budget`` member moves;
  * gang members move atomically or not at all (the dispatcher's
    gang-aware plan_migration returns the full move-set or None).
"""

from __future__ import annotations

import math
import time

from ..obs import metrics as obs_metrics
from ..topology.cell import reclaim_resource, reserve_resource
from ..scheduler.scoring import select_cells
from ..utils.logger import get_logger
from .cooldown import CooldownLedger

log = get_logger("autopilot")

_OBS = obs_metrics.default_registry()
_FRAG = _OBS.gauge(
    "kubeshare_autopilot_fragmentation_score",
    "Stranded fraction of free leaf capacity (0 = every free chip is "
    "whole-free, 1 = all free capacity is fractional slivers).")
_LPG = _OBS.gauge(
    "kubeshare_autopilot_largest_placeable_gang",
    "Largest whole-chip gang a single node can still place "
    "(max per-node count of whole-free leaves).")
_PLAN_LAT = _OBS.histogram(
    "kubeshare_autopilot_plan_latency_seconds",
    "Wall time of one planner pass (candidate scan + trial bookings).")
_MOVES = _OBS.counter(
    "kubeshare_autopilot_moves_total",
    "Autopilot migration moves by disposition.",
    labels=("outcome",))


def fragmentation_view(engine) -> dict:
    """Pure read of the capacity view (caller holds the dispatcher
    lock). Health-vetoed and unhealthy leaves are excluded — capacity
    the scheduler will not use is not *stranded*, it is gone.

    The score is ``stranded_free / total_free`` where stranded is the
    free capacity of partially-occupied leaves: exactly the space a
    whole-chip (gang) pod cannot claim. ``largest_placeable_gang`` is
    the co-scheduling headroom the score is a proxy for."""
    per_node: dict[str, dict] = {}
    for cell in engine.leaf_cells.values():
        if not cell.healthy or cell.node in engine.health_veto:
            continue
        n = per_node.setdefault(cell.node, {
            "leaves": 0, "free": 0.0, "stranded": 0.0, "whole_free": 0})
        n["leaves"] += 1
        n["free"] += cell.available
        if cell.available >= cell.leaf_cell_number:
            n["whole_free"] += 1
        elif cell.available > 0:
            n["stranded"] += cell.available
    total_free = sum(n["free"] for n in per_node.values())
    stranded = sum(n["stranded"] for n in per_node.values())
    for n in per_node.values():
        n["fragmentation"] = round(
            n["stranded"] / n["free"], 6) if n["free"] > 0 else 0.0
        n["free"] = round(n["free"], 6)
        n["stranded"] = round(n["stranded"], 6)
    return {
        "score": stranded / total_free if total_free > 0 else 0.0,
        "stranded_free": stranded,
        "total_free": total_free,
        "largest_placeable_gang": max(
            (n["whole_free"] for n in per_node.values()), default=0),
        "per_node": per_node,
    }


def fragmentation_score(engine) -> float:
    return fragmentation_view(engine)["score"]


class Planner:
    """Emits bounded, verified migration plans; owns the hysteresis and
    cooldown state. One planner per dispatcher."""

    def __init__(self, dispatcher, budget: int = 8,
                 min_improvement: float = 0.05, cooldown_s: float = 120.0,
                 clock=time.monotonic, cooldowns: CooldownLedger | None = None):
        self.dispatcher = dispatcher
        self.budget = budget
        self.min_improvement = min_improvement
        self._clock = clock
        # One shared actuation rail (autopilot/cooldown.py): the
        # rightsizer and elastic orchestrator hold the same ledger, so
        # a move, share-change, and sub-mesh resize on one pod all
        # observe one cooldown window.
        self.cooldowns = cooldowns or CooldownLedger(
            cooldown_s=cooldown_s, clock=clock)

    @property
    def cooldown_s(self) -> float:
        return self.cooldowns.cooldown_s

    # -- cooldown bookkeeping (the rebalancer reports applied moves) ----

    def note_moved(self, key: str, now: float | None = None) -> None:
        self.cooldowns.note(key, now)

    def _cooling(self, key: str, now: float) -> bool:
        return self.cooldowns.cooling(key, now)

    def cooling(self, key: str, now: float | None = None) -> bool:
        """Public cooldown probe — the rightsizer and elastic plane
        share this rail so a just-moved pod is not immediately resized
        and a just-resized pod is not immediately moved
        (doc/autopilot.md, Rightsizing)."""
        return self.cooldowns.cooling(key, now)

    # -- candidate selection --------------------------------------------

    def _candidates(self, eng) -> list:
        """Bound fractional pods, one entry per gang (the dispatcher
        expands the rest of the move-set). Whole-chip pods are never
        candidates: they ARE the shape fragmentation strands, moving
        them cannot un-strand a sliver. Order matters — pods whose
        departure leaves their chip whole-free first (each such move is
        a guaranteed de-strand), then smallest request (cheapest session
        to stream, most likely to fit into existing slivers)."""
        out, seen = [], set()
        for pod in eng.pod_status.values():
            if not pod.node_name or not pod.bookings or pod.multi_chip:
                continue
            if pod.group_name:
                if pod.group_key in seen:
                    continue
                seen.add(pod.group_key)
            out.append(pod)

        def rank(pod):
            chip_id, compute, _ = pod.bookings[0]
            cell = eng.leaf_cells.get(chip_id)
            vacates = (cell is not None and
                       cell.available + compute >= cell.leaf_cell_number
                       - 1e-9)
            return (not vacates, pod.request, pod.key)

        out.sort(key=rank)
        return out

    # -- trial booking ---------------------------------------------------

    def _engine_of(self, eng, key: str):
        """The engine that books ``key``: the dispatcher's own, or on a
        sharded plane the pod's shard's (its fleet façade has no free
        list; a move never leaves its shard). The JAX planner reads the
        façade and raises AttributeError there."""
        owner = getattr(self.dispatcher, "_engine_owner", None)
        shard = owner(key) if owner is not None else None
        return eng if shard is None else shard.engine

    def _simulate(self, eng, moves) -> tuple[list, bool]:
        """Apply a move-set to the real engine's cells (reclaim source
        bookings, book the destination through the same select_cells the
        apply path uses) and return the undo log. False = the set no
        longer fits (raced capacity) — the caller must _undo at once."""
        undo: list[tuple] = []   # (cell, compute, memory, redo_sign)
        for mv in moves:
            own = self._engine_of(eng, mv["pod"])
            member = own.pod_status.get(mv["pod"])
            if member is None or not member.bookings:
                self._undo(undo)
                return [], False
            for chip_id, compute, memory in member.bookings:
                cell = own.leaf_cells.get(chip_id)
                if cell is None:
                    continue
                reclaim_resource(cell, compute, memory)
                undo.append((cell, compute, memory, +1))
            cells = select_cells(own.free_list, mv["node"], member,
                                 own.chip_priority, own._group_cells(member),
                                 own.mesh_shape)
            if not cells:
                self._undo(undo)
                return [], False
            if member.multi_chip:
                for cell in cells:
                    reserve_resource(cell, cell.available, cell.free_memory)
                    undo.append((cell, cell.available, cell.free_memory, -1))
            else:
                cell = cells[0]
                memory = member.memory or int(
                    math.floor(member.request * cell.full_memory))
                reserve_resource(cell, member.request, memory)
                undo.append((cell, member.request, memory, -1))
        return undo, True

    @staticmethod
    def _undo(undo) -> None:
        for cell, compute, memory, sign in reversed(undo):
            if sign > 0:
                reserve_resource(cell, compute, memory)
            else:
                reclaim_resource(cell, compute, memory)

    # -- the planning pass ----------------------------------------------

    def plan(self, now: float | None = None) -> dict:
        """One planning pass: greedy best-first over candidates, each
        accepted move-set stays trial-booked so the next candidate is
        planned against the post-move cluster; everything is rolled back
        before returning. The returned plan is pure data — feed it to
        Rebalancer.apply (or a human) unchanged."""
        now = self._clock() if now is None else now
        t0 = time.perf_counter()        # wall-clock: metric-only
        d = self.dispatcher
        with d.lock:
            eng = d.engine
            view = fragmentation_view(eng)
            before = view["score"]
            _FRAG.set(value=before)
            _LPG.set(value=view["largest_placeable_gang"])
            current = before
            moves: list[dict] = []
            skipped: list[dict] = []
            applied_undo: list[tuple] = []
            try:
                for pod in self._candidates(eng):
                    if len(moves) >= self.budget:
                        break
                    if self._cooling(pod.key, now):
                        skipped.append({"pod": pod.key,
                                        "reason": "cooldown"})
                        continue
                    mplan = d.plan_migration(pod.key)
                    if mplan is None:
                        continue
                    mset = mplan["moves"]
                    if len(moves) + len(mset) > self.budget:
                        skipped.append({"pod": pod.key,
                                        "reason": "budget"})
                        continue
                    if any(self._cooling(mv["pod"], now) for mv in mset):
                        skipped.append({"pod": pod.key,
                                        "reason": "cooldown"})
                        continue
                    # rail: a dead-but-not-yet-vetoed race could slip a
                    # vetoed destination through filter — re-check here
                    if any(mv["node"] in eng.health_veto for mv in mset):
                        skipped.append({"pod": pod.key,
                                        "reason": "health-veto"})
                        continue
                    undo, ok = self._simulate(eng, mset)
                    if not ok:
                        continue
                    after = fragmentation_view(eng)["score"]
                    if after >= current - 1e-9:
                        self._undo(undo)    # move helps nobody — discard
                        continue
                    applied_undo.extend(undo)
                    current = after
                    for mv in mset:
                        moves.append(dict(mv, group=(pod.group_key
                                                     if pod.group_name
                                                     else "")))
            finally:
                self._undo(applied_undo)
            improvement = before - current
            plan = {
                "generated_at": now,
                "fragmentation_before": round(before, 6),
                "fragmentation_after": round(current, 6),
                "improvement": round(improvement, 6),
                "largest_placeable_gang": view["largest_placeable_gang"],
                "budget": self.budget,
                "moves": moves,
                "skipped": skipped,
            }
            if moves and improvement < self.min_improvement * max(
                    before, 1e-9):
                # hysteresis: churn for a sub-threshold gain is worse
                # than standing still (every move streams a session)
                plan["moves"] = []
                plan["fragmentation_after"] = round(before, 6)
                plan["improvement"] = 0.0
                plan["reason"] = (
                    f"improvement {improvement:.4f} below hysteresis "
                    f"threshold {self.min_improvement:.2f} x {before:.4f}")
            elif not moves:
                plan["reason"] = "no improving move"
        _MOVES.inc("planned", amount=float(len(plan["moves"])))
        _PLAN_LAT.observe(
            value=time.perf_counter() - t0)  # wall-clock: metric-only
        return plan
