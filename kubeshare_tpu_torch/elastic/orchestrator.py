"""The elastic resize orchestrator (doc/elastic.md).

The port's copy of ``kubeshare_tpu/elastic/orchestrator.py``.

Takes a RUNNING gang from N to M chips with zero lost steps, composing
four planes that each already existed but were never connected:

  * **pause/resume** — :meth:`GangTokenCoordinator.pause` drain-waits
    the gang to idle before any booking moves, so no member is cut
    mid-execute;
  * **placement** — member re-homing is trial-booked on the real
    engine with the same ``reserve_resource``/``reclaim_resource``
    primitives the autopilot's gang-aware ``plan_migration`` uses,
    whole-gang or nothing, and observes the one shared
    :class:`~..autopilot.cooldown.CooldownLedger` rail so elastic,
    autopilot and rightsizer never fight over a pod;
  * **carve** — the committed chip set renders through
    :func:`~..gang.carve.carve_env` into the new ``TPU_VISIBLE_CHIPS``
    layout the training processes rebuild their DeviceMesh from
    (``elastic/restate.py`` re-shards the live state);
  * **journal** — a plan→pause→restate→flip→resume state machine in
    fsynced JSONL. The ``flip`` record is the single commit point: a
    crash before it recovers to the old mesh, after it to the new one,
    never a torn hybrid (:func:`recover`).

Not to be confused with :class:`~..autopilot.elastic.ElasticQuota`,
which lends idle *shares* within a fixed placement; this plane changes
the placement itself — the number of chips under a training job.

Disabled ⇒ inert: no engine reads, no journal, no decision records —
the decision stream is bit-identical to a build without the plane.
"""

from __future__ import annotations

import json
import math
import os
import time
from collections import deque
from dataclasses import asdict, dataclass

from ..autopilot.cooldown import CooldownLedger
from ..gang.carve import carve_env
from ..obs import metrics as obs_metrics
from ..topology.cell import reclaim_resource, reserve_resource
from ..utils.logger import get_logger

log = get_logger("elastic")

_OBS = obs_metrics.default_registry()
_RESIZES = _OBS.counter(
    "kubeshare_elastic_resizes_total",
    "Elastic gang resizes by direction and disposition.",
    labels=("direction", "outcome"))
_MOVES = _OBS.counter(
    "kubeshare_elastic_member_moves_total",
    "Gang member re-homings committed by elastic flips.")
_PAUSE = _OBS.histogram(
    "kubeshare_elastic_resize_pause_seconds",
    "Gang drain-pause duration during an elastic resize (plan accepted "
    "through resume).")
_CHIPS = _OBS.gauge(
    "kubeshare_elastic_gang_chips",
    "Distinct chips under each gang after its last elastic resize.",
    labels=("gang",))


@dataclass
class ElasticConfig:
    """Rails; pure data so the snapshot returns it verbatim."""

    #: drain-wait bound for the pause step; a gang that cannot go idle
    #: within it refuses the resize (old mesh keeps running)
    pause_timeout_s: float = 30.0
    #: per-member actuation cooldown (shared ledger default when the
    #: caller does not inject one)
    cooldown_s: float = 120.0
    #: member re-homings per resize — a resize needing more refuses
    max_moves: int = 16


def _home(d, key: str):
    """The dispatcher whose engine books *key*: *d* itself, or on a
    sharded plane the owning shard (*d* when no shard holds it)."""
    owner = getattr(d, "_engine_owner", None)
    shard = owner(key) if owner is not None else None
    return d if shard is None else shard


class _FlipError(RuntimeError):
    """A flip-stage verification failed; the caller rolls back."""


class ElasticOrchestrator:
    """One per dispatcher; the service exposes it on ``/elastic``."""

    def __init__(self, dispatcher, gang_coordinator=None, cooldowns=None,
                 enabled: bool = True, cfg: ElasticConfig | None = None,
                 journal_path: str | None = None, clock=time.monotonic):
        self.dispatcher = dispatcher
        self.gangcoord = gang_coordinator
        self.cfg = cfg or ElasticConfig()
        self.cooldowns = cooldowns or CooldownLedger(
            cooldown_s=self.cfg.cooldown_s, clock=clock)
        self.enabled = enabled
        self.journal_path = journal_path
        self._clock = clock
        self._seq = 0
        self.resizes_total = 0
        self.by_outcome: dict[str, int] = {}
        #: gang -> last resize result (for /elastic and topcli)
        self.last_resize: dict[str, dict] = {}
        #: gang -> recent pause durations, seconds (p99 source)
        self._pause_waits: dict[str, deque] = {}
        #: gang -> restate callback run between pause and flip (the
        #: training process re-shards its live state here; tests and
        #: the sim register ElasticTrainer.restate)
        self._restaters: dict[str, object] = {}

    # -- registration ----------------------------------------------------

    def register_restater(self, gang: str, fn) -> None:
        """``fn(plan)`` runs between pause and flip; raising aborts the
        resize back to the old mesh. If the flip itself then fails,
        ``fn`` is invoked once more with the mirrored plan
        (``revert: True``, ``to_chips`` = the original chips) so the
        data plane follows the control plane back — restaters must
        therefore be revertible: a second call with the old chip set
        restores the old layout."""
        self._restaters[gang] = fn

    def unregister_restater(self, gang: str) -> None:
        self._restaters.pop(gang, None)

    # -- journal (rightsizer idiom: JSONL, fsynced, advisory) ------------

    def _journal(self, rec: dict) -> None:
        if not self.journal_path:
            return
        try:
            with open(self.journal_path, "a") as f:
                f.write(json.dumps(dict(rec, t=round(self._clock(), 3)),
                                   sort_keys=True) + "\n")
                f.flush()
                os.fsync(f.fileno())
        except OSError as e:
            log.warning("elastic journal write failed: %s", e)

    # -- planning --------------------------------------------------------

    @staticmethod
    def _revert_plan(plan: dict) -> dict:
        """The mirror of *plan*: re-homes the data plane back onto the
        original chip set after a failed flip. ``revert: True`` lets a
        restater tell an un-restate from a fresh resize."""
        return {"gang": plan["gang"],
                "from_chips": plan["to_chips"],
                "to_chips": plan["from_chips"],
                "direction": ("shrink" if plan["direction"] == "grow"
                              else "grow"),
                "revert": True,
                "moves": [{"pod": mv["pod"],
                           "from_chip": mv["to_chip"],
                           "to_chip": mv["from_chip"],
                           "request": mv["request"]}
                          for mv in reversed(plan["moves"])]}

    @staticmethod
    def _dest_memory(req: float, mem: int, src, dst) -> int:
        # same rule as Dispatcher.resize_request: an HBM cap defaulted
        # from the compute fraction rescales to the new chip, an
        # explicit cap is the tenant's own number and stays
        if mem == int(math.floor(req * src.full_memory)):
            return int(math.floor(req * dst.full_memory))
        return mem

    def _members_locked(self, eng, gang: str) -> list:
        out = [p for p in eng.pod_status.values()
               if p.group_name and p.group_key == gang
               and p.node_name and p.bookings]
        out.sort(key=lambda p: (p.group_rank, p.key))
        return out

    def _plan_locked(self, eng, gang: str, target: int,
                     now: float) -> tuple[dict | None, str]:
        """Build the move-set under the dispatcher lock. Returns
        ``(plan, "")`` or ``(None, refusal_reason)``."""
        members = self._members_locked(eng, gang)
        if not members:
            return None, "unknown-gang"
        if any(len(p.bookings) != 1 for p in members):
            return None, "unsupported-member-shape"
        by_chip: dict[str, list] = {}
        for p in members:
            by_chip.setdefault(p.bookings[0][0], []).append(p)
        cur = sorted(by_chip)
        if target < 1 or target > len(members):
            return None, "target-out-of-range"
        if target == len(cur):
            return None, "noop"
        if any(self.cooldowns.cooling(p.key, now) for p in members):
            return None, "cooldown"
        moves: list[dict] = []
        if target < len(cur):
            # shrink: keep the most-loaded chips (fewest re-homings),
            # pack vacating members first-fit-decreasing onto the keeps
            def load(c):
                return sum(p.bookings[0][1] for p in by_chip[c])
            keep = sorted(cur, key=lambda c: (-load(c), c))[:target]
            keepset = set(keep)
            free = {c: (eng.leaf_cells[c].available
                        if c in eng.leaf_cells else 0.0) for c in keep}
            freemem = {c: (eng.leaf_cells[c].free_memory
                           if c in eng.leaf_cells else 0) for c in keep}
            movers = [p for c in cur if c not in keepset
                      for p in by_chip[c]]
            movers.sort(key=lambda p: (-p.bookings[0][1], p.key))
            for p in movers:
                _, req, mem = p.bookings[0]
                src = eng.leaf_cells.get(p.bookings[0][0])

                def need(c):
                    dst = eng.leaf_cells.get(c)
                    if src is None or dst is None:
                        return mem
                    return self._dest_memory(req, mem, src, dst)

                dest = next(
                    (c for c in sorted(keep,
                                       key=lambda c: (-free[c], c))
                     if free[c] + 1e-9 >= req
                     and freemem[c] >= need(c)), None)
                if dest is None:
                    return None, "no-capacity"
                free[dest] -= req
                freemem[dest] -= need(dest)
                moves.append({"pod": p.key,
                              "from_chip": p.bookings[0][0],
                              "to_chip": dest, "request": req})
            to_chips = sorted(keep)
        else:
            # grow: claim whole-free healthy non-vetoed leaves (a gang
            # chip must be entirely ours), preferring the gang's own
            # nodes, and seed each with a member from a crowded chip
            need = target - len(cur)
            gang_nodes = {p.node_name for p in members}
            cands = []
            for cid, cell in eng.leaf_cells.items():
                if cid in by_chip or not cell.healthy:
                    continue
                if cell.node in eng.health_veto:
                    continue
                if cell.available < cell.leaf_cell_number - 1e-9:
                    continue
                cands.append((cell.node not in gang_nodes,
                              cell.node, cid))
            cands.sort()
            if len(cands) < need:
                return None, "no-free-chips"
            new_chips = [cid for _, _, cid in cands[:need]]
            pool = []   # spare members, most-crowded chips first
            for c in sorted(cur, key=lambda c: (-len(by_chip[c]), c)):
                pool.extend(sorted(by_chip[c][1:],
                                   key=lambda p: (p.group_rank, p.key)))
            if len(pool) < need:
                return None, "no-spare-members"
            for cid, p in zip(new_chips, pool):
                moves.append({"pod": p.key,
                              "from_chip": p.bookings[0][0],
                              "to_chip": cid,
                              "request": p.bookings[0][1]})
            to_chips = sorted(set(cur) | set(new_chips))
        if len(moves) > self.cfg.max_moves:
            return None, "move-budget"
        if not self._trial_locked(eng, moves):
            return None, "no-capacity"
        return {"gang": gang, "from_chips": cur, "to_chips": to_chips,
                "direction": ("grow" if target > len(cur) else "shrink"),
                "moves": moves}, ""

    def _trial_locked(self, eng, moves: list[dict]) -> bool:
        """Trial-book the move-set on the real cells (the planner's
        ``_simulate`` discipline: later moves see the capacity earlier
        ones consume) and roll everything back before returning."""
        undo: list[tuple] = []
        ok = True
        for mv in moves:
            pod = eng.pod_status.get(mv["pod"])
            src = eng.leaf_cells.get(mv["from_chip"])
            dst = eng.leaf_cells.get(mv["to_chip"])
            if (pod is None or not pod.bookings or src is None
                    or dst is None
                    or pod.bookings[0][0] != mv["from_chip"]):
                ok = False
                break
            _, req, mem = pod.bookings[0]
            new_mem = self._dest_memory(req, mem, src, dst)
            reclaim_resource(src, req, mem)
            undo.append((src, req, mem, +1))
            if dst.available + 1e-9 < req or dst.free_memory < new_mem:
                ok = False
                break
            reserve_resource(dst, req, new_mem)
            undo.append((dst, req, new_mem, -1))
        for cell, c, m, sign in reversed(undo):
            if sign > 0:
                reserve_resource(cell, c, m)
            else:
                reclaim_resource(cell, c, m)
        return ok

    # -- the flip (commit point) -----------------------------------------

    def _flip_locked(self, d, plan: dict) -> str:
        """Re-verify and commit every member re-homing in place under
        the dispatcher lock (the ``resize_request`` in-place mutation
        idiom). Raises :class:`_FlipError` with everything rolled back
        when the cluster changed under the pause. Returns the new
        ``TPU_VISIBLE_CHIPS`` layout.

        On a sharded plane each member is re-homed in the engine of the
        shard that books it (the fleet façade has no port pools, groups
        or ``alloc_gen``), a target chip outside that shard rolls the
        flip back, and the gang sync and wake-up go through the plane's
        ``_sync_gang_fleet`` and the owning shards' conditions. The JAX
        flip reaches for ``_sync_gang`` and ``_cond`` on the plane and
        rolls back there."""
        from .. import constants as C

        eng = d.engine
        applied: list[tuple] = []

        def _rollback():
            for (pod, old_booking, old_node, old_port, old_cells,
                 old_chips, old_mem, new_port) in reversed(applied):
                ports = _home(d, pod.key).engine.ports
                chip, req, mem = pod.bookings[0]
                cell = eng.leaf_cells.get(chip)
                if cell is not None:
                    reclaim_resource(cell, req, mem)
                back = eng.leaf_cells.get(old_booking[0])
                if back is not None:
                    reserve_resource(back, old_booking[1], old_booking[2])
                if new_port:
                    if pod.node_name in ports:
                        ports[pod.node_name].unmask(
                            new_port - C.POD_MANAGER_PORT_START)
                    # the forward path freed the old node's slot when
                    # it claimed the new one — take it back, or the
                    # restored pod.port aliases a free slot the engine
                    # can hand to another pod
                    if old_port and old_node in ports:
                        ports[old_node].mask(
                            old_port - C.POD_MANAGER_PORT_START)
                pod.bookings[0] = old_booking
                pod.cells = old_cells
                pod.chip_ids = old_chips
                pod.memory = old_mem
                pod.node_name = old_node
                pod.port = old_port

        conds: dict = {}      # the dispatchers whose waiters to wake
        try:
            for mv in plan["moves"]:
                home = _home(d, mv["pod"])
                conds[id(home)] = home
                own = home.engine
                pod = own.pod_status.get(mv["pod"])
                src = own.leaf_cells.get(mv["from_chip"])
                dst = own.leaf_cells.get(mv["to_chip"])
                if (pod is None or len(pod.bookings) != 1
                        or pod.bookings[0][0] != mv["from_chip"]
                        or src is None or dst is None or not dst.healthy
                        or dst.node in own.health_veto):
                    raise _FlipError(
                        f"{mv['pod']}: membership or target changed "
                        "under the pause")
                chip, req, mem = pod.bookings[0]
                new_mem = self._dest_memory(req, mem, src, dst)
                if dst.available + 1e-9 < req \
                        or dst.free_memory < new_mem:
                    raise _FlipError(
                        f"{mv['pod']}: chip {dst.chip_id} capacity "
                        "raced away under the pause")
                old = (pod, (chip, req, mem), pod.node_name, pod.port,
                       list(pod.cells), list(pod.chip_ids), pod.memory,
                       0)
                new_port = 0
                if dst.node != pod.node_name and pod.port:
                    # the manager port is node-local: release the old
                    # node's slot, claim one on the destination
                    pool = own.ports.get(dst.node)
                    offset = -1 if pool is None \
                        else pool.find_next_and_set()
                    if offset < 0:
                        raise _FlipError(
                            f"{mv['pod']}: node {dst.node} port pool "
                            + ("missing" if pool is None
                               else "exhausted"))
                    new_port = C.POD_MANAGER_PORT_START + offset
                reclaim_resource(src, req, mem)
                reserve_resource(dst, req, new_mem)
                pod.bookings[0] = (dst.chip_id, req, new_mem)
                pod.cells = [dst]
                pod.chip_ids = [dst.chip_id]
                pod.memory = new_mem
                if new_port:
                    own.ports[old[2]].unmask(
                        old[3] - C.POD_MANAGER_PORT_START)
                    pod.port = new_port
                pod.node_name = dst.node
                applied.append(old[:7] + (new_port,))
            members = self._members_locked(eng, plan["gang"])
            if members:
                # the gang's placement plan (if any survived this
                # long) described the old chips — drop it, the
                # evict-path way (on every engine booking a member)
                firsts = {}
                for p in members:
                    home = _home(d, p.key)
                    firsts.setdefault(id(home), (home.engine, p))
                for own, first in firsts.values():
                    group = own.group_of(first)
                    group.plan = None
                    group.plan_taken = {}
                    group.plan_stale_gen = -1
                    own.alloc_gen += 1
                sync = getattr(d, "_sync_gang_fleet", None) or d._sync_gang
                sync(members[0])
                self._republish(d, [mv["pod"] for mv in plan["moves"]])
            chips = sorted({p.bookings[0][0] for p in members})
            coords = [getattr(eng.leaf_cells.get(c), "coords", ()) or ()
                      for c in chips]
        except Exception:
            # not just _FlipError: ANY failure mid-flip (a raced map, a
            # sync error after bookings moved) must restore the old
            # placement before it propagates — the caller only decides
            # how to report, never how to untear
            _rollback()
            for home in conds.values():
                home._cond.notify_all()
            raise
        for home in conds.values():
            home._cond.notify_all()
        return carve_env(chips, coords)

    @staticmethod
    def _republish(d, keys: list[str]) -> None:
        """Best-effort binding re-publication for moved members (the
        journal's flip record is authoritative; a publish failure is
        diagnosable, not fatal — same stance as resize_request). On a
        sharded plane each goes through the shard that books it."""
        from ..scheduler.dispatcher import _binding_of
        from ..telemetry.aggregator import publish_binding

        for key in keys:
            home = _home(d, key)
            if home.registry is None:
                continue
            pod = home.engine.pod_status.get(key)
            if pod is None or not pod.needs_tpu:
                continue
            try:
                publish_binding(home.registry, pod,
                                _binding_of(pod, home.engine),
                                fence=home._fence())
            except Exception as e:
                log.warning("elastic: re-publish of %s failed: %s",
                            key, e)

    # -- the resize state machine ----------------------------------------

    def _refuse(self, gang: str, target: int, reason: str,
                now: float, direction: str = "unknown") -> dict:
        out = {"gang": gang, "outcome": "refused", "reason": reason,
               "to_chips": target}
        if reason == "noop":
            out["outcome"] = "noop"
        self._finish(out, now, direction)
        return out

    def _finish(self, result: dict, now: float, direction: str) -> None:
        self.resizes_total += 1
        outcome = result["outcome"]
        self.by_outcome[outcome] = self.by_outcome.get(outcome, 0) + 1
        self.last_resize[result["gang"]] = dict(result,
                                                at=round(now, 3))
        _RESIZES.inc(direction, outcome)
        dec = getattr(self.dispatcher, "decisions", None)
        if dec is not None:
            dec.record("elastic-resize", now, gang=result["gang"],
                       outcome=outcome,
                       reason=result.get("reason", ""),
                       src=result.get("from_chips"),
                       dst=result.get("to_chips"),
                       moves=len(result.get("moves", [])))

    def resize(self, gang: str, target_chips: int,
               reason: str = "operator",
               now: float | None = None) -> dict:
        """Take *gang* to *target_chips* chips: plan → pause → restate
        → flip → resume. Never leaves a torn mesh — every exit path is
        either the old placement (refused / rolled_back) or the new one
        (applied), and the journal's flip record marks which."""
        if not self.enabled:
            return {"gang": gang, "outcome": "disabled",
                    "reason": "elastic plane disabled"}
        now = self._clock() if now is None else now
        d = self.dispatcher
        self._seq += 1
        seq = self._seq
        with d.lock:
            plan, why = self._plan_locked(d.engine, gang,
                                          int(target_chips), now)
        if plan is None:
            return self._refuse(gang, int(target_chips), why, now)
        direction = plan["direction"]
        base = {"gang": gang, "from_chips": len(plan["from_chips"]),
                "to_chips": len(plan["to_chips"]),
                "moves": plan["moves"], "reason": reason}
        self._journal({"event": "plan", "gang": gang, "seq": seq,
                       "from": plan["from_chips"],
                       "to": plan["to_chips"],
                       "moves": plan["moves"], "reason": reason})
        t0 = self._clock()
        if self.gangcoord is not None and not self.gangcoord.pause(
                gang, timeout=self.cfg.pause_timeout_s):
            self.gangcoord.resume(gang)
            self._journal({"event": "abort", "gang": gang, "seq": seq,
                           "step": "pause", "reason": "pause-timeout"})
            out = dict(base, outcome="refused", reason="pause-timeout")
            self._finish(out, now, direction)
            return out
        self._journal({"event": "pause", "gang": gang, "seq": seq})
        resumed = False

        def _resume():
            # once-guard: every exit below resumes exactly one time,
            # and the finally backstop means no exception path —
            # however unexpected — can strand the gang drain-paused
            nonlocal resumed
            if not resumed:
                resumed = True
                if self.gangcoord is not None:
                    self.gangcoord.resume(gang)

        restate = self._restaters.get(gang)
        restated = False
        try:
            if restate is not None:
                try:
                    restate(dict(plan))
                except Exception as e:
                    _resume()
                    self._journal({"event": "abort", "gang": gang,
                                   "seq": seq, "step": "restate",
                                   "reason": str(e)})
                    out = dict(base, outcome="rolled_back",
                               reason=f"restate: {e}")
                    self._finish(out, now, direction)
                    return out
                restated = True
            self._journal({"event": "restate", "gang": gang,
                           "seq": seq})
            try:
                with d.lock:
                    layout = self._flip_locked(d, plan)
            except Exception as e:
                # _flip_locked restored the bookings before raising —
                # for ANY exception, not just _FlipError — so here we
                # only un-tear the data plane and report
                why = str(e) or type(e).__name__
                if restated:
                    # the trainer already re-sharded onto the target
                    # devices: run the mirrored plan so the resumed
                    # job computes on the chips it actually holds
                    try:
                        restate(self._revert_plan(plan))
                        self._journal({"event": "unrestate",
                                       "gang": gang, "seq": seq})
                    except Exception as ue:
                        log.error(
                            "elastic: un-restate of %s failed (%s); "
                            "data plane may disagree with the old "
                            "placement until the next restate", gang,
                            ue)
                        self._journal({"event": "unrestate-failed",
                                       "gang": gang, "seq": seq,
                                       "reason": str(ue)})
                        why += f"; un-restate failed: {ue}"
                _resume()
                self._journal({"event": "abort", "gang": gang,
                               "seq": seq, "step": "flip",
                               "reason": why})
                out = dict(base, outcome="rolled_back", reason=why)
                self._finish(out, now, direction)
                return out
            # COMMIT POINT: after this record recovery lands on the
            # new mesh; before it, on the old one
            self._journal({"event": "flip", "gang": gang, "seq": seq,
                           "layout": layout,
                           "chips": plan["to_chips"]})
            _resume()
            pause_s = self._clock() - t0
            self._journal({"event": "resume", "gang": gang,
                           "seq": seq, "pause_s": round(pause_s, 6)})
            self._pause_waits.setdefault(
                gang, deque(maxlen=256)).append(pause_s)
            _PAUSE.observe(value=pause_s)
            _MOVES.inc(amount=float(len(plan["moves"])))
            _CHIPS.set(gang, value=float(len(plan["to_chips"])))
            for mv in plan["moves"]:
                self.cooldowns.note(mv["pod"], now)
            out = dict(base, outcome="applied", layout=layout,
                       pause_s=round(pause_s, 6))
            self._finish(out, now, direction)
            return out
        finally:
            _resume()

    # -- introspection ---------------------------------------------------

    @staticmethod
    def _pct(waits, frac: float) -> float:
        if not waits:
            return 0.0
        ordered = sorted(waits)
        idx = min(len(ordered) - 1,
                  max(0, int(round(frac * (len(ordered) - 1)))))
        return ordered[idx]

    def snapshot(self) -> dict:
        """State for ``/elastic`` and ``topcli --elastic``; safe on a
        disabled (or fresh) instance."""
        gangs: dict[str, dict] = {}
        d = self.dispatcher
        with d.lock:
            eng = d.engine
            seen: set[str] = set()
            for p in eng.pod_status.values():
                if not p.group_name or p.group_key in seen:
                    continue
                seen.add(p.group_key)
                members = self._members_locked(eng, p.group_key)
                if not members:
                    continue
                chips = sorted({m.bookings[0][0] for m in members
                                if m.bookings})
                coords = [getattr(eng.leaf_cells.get(c), "coords",
                                  ()) or () for c in chips]
                waits = self._pause_waits.get(p.group_key, ())
                gangs[p.group_key] = {
                    "chips": len(chips),
                    "members": len(members),
                    "layout": carve_env(chips, coords),
                    "last_resize": self.last_resize.get(p.group_key),
                    "pause_p50_ms": round(
                        self._pct(waits, 0.50) * 1e3, 3),
                    "pause_p99_ms": round(
                        self._pct(waits, 0.99) * 1e3, 3),
                }
        return {
            "attached": True,
            "enabled": self.enabled,
            "config": asdict(self.cfg),
            "resizes_total": self.resizes_total,
            "by_outcome": dict(self.by_outcome),
            "gangs": gangs,
            "cooldowns": self.cooldowns.snapshot(),
        }


def recover(journal_path: str) -> dict:
    """Replay an elastic journal after a crash: per gang, the last
    ``flip`` record (the commit point) wins — a plan/pause/restate with
    no flip recovers to the OLD mesh, a flip with or without its resume
    to the NEW one. Torn trailing lines (the crash mid-write case) are
    ignored, the fsync discipline guarantees every earlier line is
    whole. Returns ``{gang: {"mesh": "old"|"new", "layout", "chips",
    "seq"}}``."""
    out: dict[str, dict] = {}
    if not journal_path or not os.path.exists(journal_path):
        return out
    with open(journal_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue     # torn tail
            gang = rec.get("gang")
            ev = rec.get("event")
            if not gang or not ev:
                continue
            st = out.setdefault(gang, {"mesh": "old", "layout": None,
                                       "chips": None, "seq": 0})
            st["seq"] = rec.get("seq", st["seq"])
            if ev == "plan":
                st["mesh"] = "old"
            elif ev == "flip":
                st["mesh"] = "new"
                st["layout"] = rec.get("layout")
                st["chips"] = rec.get("chips")
            elif ev == "abort":
                st["mesh"] = "old"
    return out
