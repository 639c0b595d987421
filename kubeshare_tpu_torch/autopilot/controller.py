"""The autopilot controller: plan/apply split + closed-loop cycle
(doc/autopilot.md).

The port's copy of ``kubeshare_tpu/autopilot/controller.py``.

Glue over the three parts: :class:`~.planner.Planner` (decides),
:class:`~.rebalancer.Rebalancer` (acts, journaled), and optional
:class:`~.elastic.ElasticQuota` (lends idle shares between moves).
``plan()`` is a pure dry run — the JSON it returns is the complete
decision record; ``apply()`` executes exactly that record; ``cycle()``
is plan-then-apply for closed-loop operation (sim, the service's
background cadence). Disabled ⇒ inert: no planning, no engine reads
beyond the snapshot, no quota adjustments — the cluster behaves as if
the plane did not exist.
"""

from __future__ import annotations

import time

from ..obs import metrics as obs_metrics
from ..obs.trace import get_tracer
from .planner import Planner, fragmentation_view

_OBS = obs_metrics.default_registry()
_FRAG = _OBS.gauge(
    "kubeshare_autopilot_fragmentation_score",
    "Stranded fraction of free leaf capacity (0 = every free chip is "
    "whole-free, 1 = all free capacity is fractional slivers).")


class Autopilot:
    """One instance per dispatcher; the service exposes it on
    ``/autopilot`` (GET = snapshot, POST plan/apply)."""

    def __init__(self, dispatcher, planner: Planner | None = None,
                 rebalancer=None, elastic=None, enabled: bool = True,
                 clock=time.monotonic):
        from .rebalancer import Rebalancer

        self.dispatcher = dispatcher
        self.planner = planner or Planner(dispatcher, clock=clock)
        self.rebalancer = rebalancer or Rebalancer(dispatcher,
                                                   planner=self.planner)
        if self.rebalancer.planner is None:
            self.rebalancer.planner = self.planner
        self.elastic = elastic
        self.enabled = enabled
        self._clock = clock
        self.cycles = 0
        self.last_plan: dict | None = None
        self.last_apply: dict | None = None

    def plan(self, now: float | None = None) -> dict:
        """Dry run: emit (and remember) a migration plan, touch nothing."""
        if not self.enabled:
            return {"enabled": False, "moves": []}
        tracer = get_tracer()
        t0 = tracer.now_ms()
        plan = self.planner.plan(now=now)
        tracer.record("autopilot-plan", "", t0, tracer.now_ms(),
                      moves=len(plan["moves"]),
                      frag_before=plan["fragmentation_before"],
                      frag_after=plan["fragmentation_after"])
        dec = getattr(self.dispatcher, "decisions", None)
        if dec is not None:
            dec.record("plan", now,
                       moves=[{"pod": m["pod"], "from": m["from"],
                               "node": m["node"]}
                              for m in plan.get("moves", [])],
                       frag_before=plan["fragmentation_before"],
                       frag_after=plan["fragmentation_after"])
        self.last_plan = plan
        return plan

    def apply(self, plan: dict | None = None) -> dict:
        """Execute *plan* (default: the last one emitted)."""
        if not self.enabled:
            return {"enabled": False, "applied": [], "rolled_back": [],
                    "failed": []}
        if plan is None:
            plan = self.last_plan or {"moves": []}
        result = self.rebalancer.apply(plan)
        dec = getattr(self.dispatcher, "decisions", None)
        if dec is not None:
            dec.record("apply",
                       applied=list(result.get("applied", [])),
                       rolled_back=list(result.get("rolled_back", [])),
                       failed=list(result.get("failed", [])))
        self.last_apply = result
        return result

    def cycle(self, now: float | None = None, apply: bool = True) -> dict:
        """One closed-loop pass: plan, optionally apply, step elastic
        quota. Returns the plan augmented with what actually happened."""
        if not self.enabled:
            return {"enabled": False, "moves": [], "applied": [],
                    "rolled_back": [], "failed": []}
        self.cycles += 1
        out = dict(self.plan(now=now))
        if apply and out.get("moves"):
            result = self.apply(out)
            out.update(applied=result["applied"],
                       rolled_back=result["rolled_back"],
                       failed=result["failed"])
        else:
            out.update(applied=[], rolled_back=[], failed=[])
        if self.elastic is not None:
            out["elastic"] = self.elastic.step()
        with self.dispatcher.lock:
            applied_view = fragmentation_view(self.dispatcher.engine)
        out["fragmentation_applied"] = round(applied_view["score"], 6)
        _FRAG.set(value=applied_view["score"])
        return out

    def snapshot(self) -> dict:
        """State for ``/autopilot`` and ``topcli --autopilot``; safe to
        call on a disabled (or fresh) instance."""
        with self.dispatcher.lock:
            view = fragmentation_view(self.dispatcher.engine)
        last_plan = self.last_plan
        return {
            "attached": True,
            "enabled": self.enabled,
            "fragmentation": round(view["score"], 6),
            "stranded_free": round(view["stranded_free"], 6),
            "total_free": round(view["total_free"], 6),
            "largest_placeable_gang": view["largest_placeable_gang"],
            "per_node": view["per_node"],
            "cycles": self.cycles,
            "applied_total": self.rebalancer.applied_total,
            "rolled_back_total": self.rebalancer.rolled_back_total,
            "pending_moves": list((last_plan or {}).get("moves", [])),
            "last_plan": last_plan,
            "last_apply": self.last_apply,
            "burst_credits": (self.elastic.snapshot()
                              if self.elastic is not None else None),
            "recovered": self.rebalancer.recovered,
        }
