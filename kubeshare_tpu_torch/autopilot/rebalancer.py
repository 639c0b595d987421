"""Plan execution with a move journal + atomic gang units
(doc/autopilot.md).

The port's copy of ``kubeshare_tpu/autopilot/rebalancer.py``.

The rebalancer is the *acting* half of the autopilot: it takes a plan
emitted by :mod:`.planner` and walks it move by move through
``Dispatcher.apply_move`` (engine re-bind + registry re-publish) and —
when a ``session_mover`` is wired — the resilience plane's
drain→freeze→stream→flip path (``resilience/migrate.py``), whose
contract this module inherits: *the source stays authoritative until
the flip*, so any failure rolls the pod back to where it was.

Every move is journaled (JSONL, fsynced) around its execution, so a
rebalancer that crashes mid-batch can tell on restart which moves
completed (durable in the registry — nothing to do) and which were
never flipped (source-authoritative — nothing to undo). There is no
state in between: apply_move commits or restores under one dispatcher
lock acquisition, and the session flip is the move's last step.

Gang units are atomic: when any member move fails, every member already
moved in that unit is moved back to its source before the batch
continues — a half-migrated gang would strand its torch.distributed mesh
across nodes.
"""

from __future__ import annotations

import json
import os
import re
import time

from ..obs import metrics as obs_metrics
from ..obs.flight import default_recorder
from ..obs.trace import get_tracer
from ..utils.logger import get_logger

log = get_logger("autopilot")

_OBS = obs_metrics.default_registry()
_MOVES = _OBS.counter(
    "kubeshare_autopilot_moves_total",
    "Autopilot migration moves by disposition.",
    labels=("outcome",))


class Rebalancer:
    """Executes accepted plans; owns the journal. One per dispatcher."""

    def __init__(self, dispatcher, journal_path: str | None = None,
                 session_mover=None, planner=None, clock=time.time,
                 gang_coordinator=None,
                 gang_pause_timeout_s: float = 5.0):
        """``session_mover(move, binding) -> bool`` streams the pod's
        proxy session to the new binding (resilience/migrate.py in a
        real deployment); False or an exception fails the move. None
        means engine-only moves (sim, tests, cold workloads).
        ``planner`` (optional) gets ``note_moved`` per applied move so
        its cooldown rail sees what actually happened.
        ``gang_coordinator`` (optional, doc/gang.md) is paused around a
        gang unit's moves: no gang-atomic token grant is in flight while
        member bindings flip, so a mid-migration gang never runs an SPMD
        step on a half-moved mesh — and never observes a partial-grant
        window."""
        self.dispatcher = dispatcher
        self.journal_path = journal_path
        self.session_mover = session_mover
        self.planner = planner
        self.gang_coordinator = gang_coordinator
        self.gang_pause_timeout_s = gang_pause_timeout_s
        self._clock = clock
        self._batch_seq = 0
        self.applied_total = 0
        self.rolled_back_total = 0
        #: crash-recovery report from the previous incarnation's journal
        #: (None = clean shutdown or no journal)
        self.recovered = self._recover() if journal_path else None

    # -- journal ---------------------------------------------------------

    def _journal(self, rec: dict) -> None:
        if not self.journal_path:
            return
        try:
            with open(self.journal_path, "a") as f:
                f.write(json.dumps(dict(rec, t=round(self._clock(), 3)),
                                   sort_keys=True) + "\n")
                f.flush()
                os.fsync(f.fileno())
        except OSError as e:   # a full disk must not wedge the cluster
            log.warning("autopilot journal write failed: %s", e)

    def _recover(self):
        """Close out a batch the previous incarnation left open. Moves
        journaled ``move_done`` flipped before the crash — their
        bindings are durable in the registry, replay rebinds them on
        the new node. Moves never journaled done were at worst mid
        apply_move, which commits-or-restores atomically under the
        dispatcher lock — the source record is still the authoritative
        one, so abandoning them IS the rollback."""
        try:
            with open(self.journal_path) as f:
                lines = f.readlines()
        except OSError:
            return None
        batches: dict[str, dict] = {}
        order: list[str] = []
        for line in lines:
            try:
                rec = json.loads(line)
            except ValueError:
                continue       # torn tail write from the crash itself
            batch, event = rec.get("batch"), rec.get("event")
            if not batch:
                continue
            m = re.match(r"batch-(\d+)$", batch)
            if m:
                self._batch_seq = max(self._batch_seq, int(m.group(1)))
            if event == "batch_begin":
                batches[batch] = {"moves": rec.get("moves", []),
                                  "done": [], "ended": False}
                order.append(batch)
            elif batch in batches:
                if event == "move_done":
                    batches[batch]["done"].append(rec.get("pod"))
                elif event in ("batch_end", "batch_recovered"):
                    batches[batch]["ended"] = True
        open_batches = [b for b in order if not batches[b]["ended"]]
        if not open_batches:
            return None
        batch = open_batches[-1]
        info = batches[batch]
        abandoned = [mv.get("pod") for mv in info["moves"]
                     if mv.get("pod") not in info["done"]]
        self._journal({"event": "batch_recovered", "batch": batch,
                       "completed": info["done"], "abandoned": abandoned})
        log.warning("autopilot journal: batch %s was open at crash — "
                    "%d move(s) completed, %d abandoned (source "
                    "authoritative)", batch, len(info["done"]),
                    len(abandoned))
        return {"batch": batch, "completed": list(info["done"]),
                "abandoned": abandoned}

    # -- execution -------------------------------------------------------

    def _units(self, moves) -> list[list[dict]]:
        """Group a plan's move list into atomic units: members of one
        gang (same non-empty ``group`` annotation) form one unit."""
        units: dict[str, list] = {}
        order: list[str] = []
        for mv in moves:
            key = mv.get("group") or mv["pod"]
            if key not in units:
                units[key] = []
                order.append(key)
            units[key].append(mv)
        return [units[k] for k in order]

    def _move_session(self, mv: dict, binding) -> None:
        mover = self.session_mover
        if mover is None:
            return
        if not mover(mv, binding):
            raise RuntimeError(
                f"session move {mv['from']} -> {mv['node']} refused")

    def apply(self, plan: dict) -> dict:
        """Execute every move in *plan*. Returns ``{"batch", "applied",
        "rolled_back", "failed"}`` (move dicts). Catches ``Exception``
        per move — a failed move rolls its gang unit back and the batch
        continues; anything harsher (process death) leaves the journal
        open for :meth:`_recover`."""
        moves = list(plan.get("moves", []))
        result = {"batch": None, "applied": [], "rolled_back": [],
                  "failed": []}
        if not moves:
            return result
        tracer = get_tracer()
        self._batch_seq += 1
        batch = f"batch-{self._batch_seq}"
        result["batch"] = batch
        self._journal({"event": "batch_begin", "batch": batch,
                       "moves": moves})
        for unit in self._units(moves):
            gang = unit[0].get("group") or ""
            paused = False
            if gang and self.gang_coordinator is not None:
                # grant freeze BEFORE the first member flips: pause
                # returns only once any in-flight gang grant drained, so
                # the flip happens inside a zero-partial-grant window
                paused = self.gang_coordinator.pause(
                    gang, timeout=self.gang_pause_timeout_s)
                self._journal({"event": "gang_paused", "batch": batch,
                               "gang": gang, "drained": paused})
                if not paused:
                    log.warning("gang %s: grant drain timed out before "
                                "migration; moving anyway (coordinator "
                                "stays paused for the flip)", gang)
            try:
                self._apply_unit(unit, batch, result, tracer,
                                 generated_at=plan.get("generated_at"))
            finally:
                if gang and self.gang_coordinator is not None:
                    self.gang_coordinator.resume(gang)
                    self._journal({"event": "gang_resumed",
                                   "batch": batch, "gang": gang})
        self._journal({"event": "batch_end", "batch": batch,
                       "applied": len(result["applied"]),
                       "rolled_back": len(result["rolled_back"])})
        if result["failed"] or result["rolled_back"]:
            # a rollback means live pods were yanked back mid-flight —
            # snapshot the black box while the run-up is still in the
            # ring (doc/observability.md, flight recorder)
            default_recorder().trigger(
                "autopilot-rollback", batch=batch,
                failed=len(result["failed"]),
                rolled_back=len(result["rolled_back"]))
        return result

    def _apply_unit(self, unit, batch, result, tracer,
                    generated_at=None) -> None:
        """One atomic unit: apply every member move, roll the whole
        unit back on any member's failure."""
        flipped: list[dict] = []   # engine state moved to dest
        failed = None
        for mv in unit:
            t0 = tracer.now_ms()
            try:
                binding = self.dispatcher.apply_move(mv["pod"],
                                                     mv["node"])
                flipped.append(mv)
                self._move_session(mv, binding)
            except Exception as e:
                self._journal({"event": "move_failed", "batch": batch,
                               "pod": mv["pod"], "node": mv["node"],
                               "error": str(e)})
                log.warning("autopilot move %s -> %s failed: %s",
                            mv["pod"], mv["node"], e)
                failed = mv
                break
            self._journal({"event": "move_done", "batch": batch,
                           "pod": mv["pod"], "from": mv.get("from", ""),
                           "node": mv["node"]})
            tracer.record("autopilot-move", "", t0, tracer.now_ms(),
                          pod=mv["pod"], source=mv.get("from", ""),
                          dest=mv["node"], batch=batch)
        if failed is None:
            for mv in unit:
                result["applied"].append(mv)
                self.applied_total += 1
                _MOVES.inc("applied")
                if self.planner is not None:
                    self.planner.note_moved(mv["pod"], now=generated_at)
            return
        # gang atomicity: undo the members (incl. the failed move's
        # own flip when apply_move succeeded but the session didn't)
        result["failed"].append(failed)
        _MOVES.inc("failed")
        for mv in reversed(flipped):
            try:
                self.dispatcher.apply_move(mv["pod"],
                                           mv.get("from", ""))
                self._journal({"event": "move_rolled_back",
                               "batch": batch, "pod": mv["pod"],
                               "node": mv.get("from", "")})
            except Exception as e:
                # apply_move already requeued the pod — journal the
                # truth, the registry record stays consistent
                self._journal({"event": "rollback_failed",
                               "batch": batch, "pod": mv["pod"],
                               "error": str(e)})
                log.error("rollback of %s to %s failed: %s",
                          mv["pod"], mv.get("from", ""), e)
            result["rolled_back"].append(mv)
            self.rolled_back_total += 1
            _MOVES.inc("rolled_back")
