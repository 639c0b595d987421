"""The SLO-driven capacity rightsizer (doc/autopilot.md, Rightsizing).

The port's copy of ``kubeshare_tpu/rightsize/controller.py``.

Every ``tpu_request`` enters the system as an operator guess; elastic
lending only redistributes *idle* headroom and never changes the base
share. This controller closes the remaining loop — it resizes the base
share itself, from measurement:

  * **grow** a tenant that is burning its SLO error budget
    (:func:`..rightsize.signals.burn_state`); when the chip has no free
    capacity, the blame graph picks the neighbour to shrink or migrate
    away first;
  * **shrink** a tenant whose ``granted-idle`` fraction stays above a
    threshold across a sustained ledger window
    (:func:`..rightsize.signals.tenant_demand`) down to measured demand
    plus headroom;
  * **pack** the freed capacity into fewer chips through the existing
    trial-booked :meth:`Dispatcher.plan_migration` /
    :meth:`Dispatcher.apply_move` path, so the chaos oracle's booking
    invariants keep holding.

The plan/apply split, per-tenant cooldown (shared with the autopilot's
:class:`~..autopilot.planner.Planner` — a just-moved pod is never
immediately resized and vice versa), hysteresis rails, JSONL journal
and decision-recorder entries all mirror the autopilot plane, so the
replay/shadow plane can diff rightsize decisions the same way it diffs
scheduling ones. Actuation is two-level: the engine re-books the new
fraction (:meth:`Dispatcher.resize_request`) and the chip's token
scheduler learns it via ``set_effective`` (gang members: uniformly, via
``GangTokenCoordinator.set_effective_gang``). Resize application is
whole-plan atomic: any member failing rolls every already-applied
resize in the batch back before returning.

Disabled ⇒ inert: no engine reads beyond the snapshot, no ledger/SLO
queries, no decision records — the scheduler's decision stream is
bit-identical to a build without the plane.
"""

from __future__ import annotations

import json
import math
import os
import time
from dataclasses import asdict, dataclass

from ..obs import metrics as obs_metrics
from ..obs.trace import get_tracer
from ..utils.logger import get_logger
from .signals import (blamed_neighbours, burn_state, default_tenant,
                      tenant_demand)

log = get_logger("rightsize")

_OBS = obs_metrics.default_registry()
_CYCLES = _OBS.counter(
    "kubeshare_rightsize_cycles_total",
    "Closed-loop rightsize cycles run.")
_RESIZES = _OBS.counter(
    "kubeshare_rightsize_resizes_total",
    "Share resizes by direction and disposition.",
    labels=("direction", "outcome"))
_SKIPPED = _OBS.counter(
    "kubeshare_rightsize_skipped_total",
    "Resize candidates skipped, by rail.",
    labels=("reason",))
_SHARE = _OBS.gauge(
    "kubeshare_rightsize_share",
    "Per-tenant share in chip-equivalents: as declared at submit vs "
    "as currently booked after resizes.",
    labels=("tenant", "kind"))
_EQUIV = _OBS.gauge(
    "kubeshare_rightsize_chip_equivalents",
    "Fleet-wide provisioned share, in chip-equivalents: what static "
    "declarations would hold vs what is booked now.",
    labels=("view",))
_BURN = _OBS.gauge(
    "kubeshare_rightsize_burn_slow",
    "Worst slow-window SLO burn rate per tenant at the last plan.",
    labels=("tenant",))
_PLAN_LAT = _OBS.histogram(
    "kubeshare_rightsize_plan_seconds",
    "Wall-clock latency of one rightsize planning pass.")


@dataclass
class RightsizeConfig:
    """Rails and thresholds; every field is pure data so the snapshot
    can return it verbatim."""

    #: sustained ledger window the shrink signal must hold across
    window_s: float = 600.0
    #: shrink when granted-idle / granted >= this over the window
    idle_frac: float = 0.5
    #: ...but only when the tenant actually held the chip for at least
    #: this fraction of the window (absent tenants are not judged)
    min_coverage: float = 0.1
    #: grow when the worst slow-window burn rate >= this (or firing)
    grow_burn: float = 1.0
    #: one grow step, in window fraction
    grow_step: float = 0.1
    #: shrink target = measured active fraction * (1 + headroom)
    shrink_headroom: float = 0.25
    #: resize targets snap up to this quantum
    share_quantum: float = 0.05
    min_share: float = 0.05
    max_share: float = 1.0
    #: hysteresis: proposed deltas smaller than this are dropped
    min_delta: float = 0.04
    #: per-pod cooldown between resizes/moves (shared with the planner)
    cooldown_s: float = 120.0
    #: resizes per cycle
    budget: int = 8
    #: consolidate chips whose booked share <= this after shrinks
    pack_util: float = 0.35
    #: migration moves per cycle (0 disables the pack stage)
    move_budget: int = 4
    #: a packed pod stays put this long — consolidation must converge,
    #: not oscillate between sliver chips
    pack_cooldown_s: float = 600.0
    #: propose elastic sub-mesh grows (doc/elastic.md) for gang tenants
    #: whose fast-burn window is hot. Off by default: turning it on
    #: lets the rightsizer scale training *jobs*, not just shares
    elastic_grow: bool = False
    #: chips added per elastic grow proposal
    elastic_grow_chips: int = 1


class Rightsizer:
    """One instance per dispatcher; the service exposes it on
    ``/rightsize`` (GET = snapshot, POST plan/apply)."""

    def __init__(self, dispatcher, slo=None, ledger=None, blame=None,
                 planner=None, rebalancer=None, schedulers=None,
                 gang_coordinator=None, enabled: bool = True,
                 cfg: RightsizeConfig | None = None,
                 journal_path: str | None = None,
                 clock=time.monotonic, tenant_fn=default_tenant,
                 cooldowns=None, elastic=None):
        """``schedulers`` maps chip_id -> TokenScheduler for the chips
        this process actuates directly (sim, chaos, tests; the live
        service's proxies learn the new share through the registry).
        ``cooldowns`` is the shared :class:`~..autopilot.cooldown.
        CooldownLedger` actuation rail (defaults to the planner's, so
        move / share-change / elastic resize on one pod observe one
        window); ``rebalancer`` executes pack moves with the
        autopilot's journaled gang-atomic semantics; ``elastic`` is the
        orchestrator grow proposals actuate through when
        ``cfg.elastic_grow`` is on."""
        from ..autopilot.planner import Planner
        from ..autopilot.rebalancer import Rebalancer

        self.dispatcher = dispatcher
        self.slo = slo
        self.ledger = ledger
        self.blame = blame
        self.planner = planner or Planner(
            dispatcher, cooldown_s=(cfg or RightsizeConfig()).cooldown_s,
            clock=clock, cooldowns=cooldowns)
        self.cooldowns = cooldowns or self.planner.cooldowns
        self.elastic = elastic
        self.rebalancer = rebalancer or Rebalancer(
            dispatcher, planner=self.planner,
            gang_coordinator=gang_coordinator)
        self.schedulers = schedulers if schedulers is not None else {}
        self.gang_coordinator = gang_coordinator
        self.enabled = enabled
        self.cfg = cfg or RightsizeConfig()
        self.journal_path = journal_path
        self._clock = clock
        self._tenant_fn = tenant_fn
        self.cycles = 0
        self.applied_total = 0
        self.rolled_back_total = 0
        self.last_plan: dict | None = None
        self.last_apply: dict | None = None
        self._batch_seq = 0
        #: share each pod declared at first sight — the static baseline
        #: the chip-equivalents comparison (and metrics) are against
        self._declared: dict[str, float] = {}
        #: pod -> last pack-move plan time (anti-oscillation rail)
        self._last_packed: dict[str, float] = {}
        #: tenant -> last applied shrink time. A tenant shrinks at most
        #: once per observation window: the idle signal is a trailing
        #: ratio over the OLD share, so chaining shrinks inside one
        #: window compounds it geometrically (0.6 -> 0.15 -> 0.05)
        #: and starves the tenant the signal said was safe
        self._last_shrunk: dict[str, float] = {}

    # -- journal (rebalancer idiom: JSONL, fsynced, advisory) -----------

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
            log.warning("rightsize journal write failed: %s", e)

    # -- helpers ---------------------------------------------------------

    def _quantize(self, frac: float) -> float:
        q = self.cfg.share_quantum
        return round(math.ceil(frac / q - 1e-9) * q, 6)

    def _pods_by_tenant(self, eng) -> dict[str, list]:
        """Bound fractional single-chip pods, grouped by tenant (the
        only resize-eligible population — whole-chip pods have nothing
        fractional to resize)."""
        out: dict[str, list] = {}
        for pod in eng.pod_status.values():
            if (not pod.node_name or not pod.needs_tpu
                    or pod.multi_chip or not pod.bookings):
                continue
            self._declared.setdefault(pod.key, pod.bookings[0][1])
            out.setdefault(self._tenant_fn(pod.key), []).append(pod)
        for pods in out.values():
            pods.sort(key=lambda p: p.key)
        return out

    def _shrink_spaced(self, tenant: str, now: float) -> bool:
        since = self._last_shrunk.get(tenant)
        return since is not None and \
            (now - since) < self.cfg.window_s

    def _target(self, tenant: str, current: float, burn: dict,
                demand: dict, npods: int,
                now: float) -> tuple[float, str]:
        """The tenant's proposed total share and the decision reason
        (""= leave it alone)."""
        cfg = self.cfg
        b = burn.get(tenant)
        d = demand.get(tenant)
        # the fast window only: it reacts within one sample batch AND
        # decays within one window once waits recover — gating on the
        # slow burn would keep growing a tenant for minutes after its
        # starvation spell ended (the slow window remembers it)
        growing = b is not None and (
            b["firing"] or b["burn_fast"] >= cfg.grow_burn)
        if growing:
            target = min(cfg.max_share * npods, current + cfg.grow_step)
            why = ("slo-firing" if b["firing"] else "burn-rate")
            return round(target, 6), why
        # shrink is inhibited by the SLOW window: a tenant that starved
        # any time in the last window keeps its share — the idle signal
        # it shows right after a grow is the pre-spike history, and
        # shrinking on it would re-starve the tenant (flapping)
        if b is not None and max(b["burn_fast"],
                                 b["burn_slow"]) >= cfg.grow_burn:
            return current, ""
        if self._shrink_spaced(tenant, now):
            _SKIPPED.inc("shrink-window")
            return current, ""
        if d is None:
            return current, ""
        coverage = d["granted_s"] / max(cfg.window_s, 1e-9)
        if coverage < cfg.min_coverage:
            return current, ""
        if d["idle_frac"] < cfg.idle_frac:
            return current, ""
        # grant utilization (active over granted) scaled onto the
        # current share — self-normalizing, so a tenant the ledger has
        # only seen for part of the window is not mistaken for idle
        util = d["active_s"] / max(d["granted_s"], 1e-9)
        target = self._quantize(current * util
                                * (1.0 + cfg.shrink_headroom))
        target = max(cfg.min_share * npods, min(target, current))
        return round(target, 6), "sustained-idle"

    def _squeeze_target(self, tenant: str, pod, demand: dict) \
            -> float | None:
        """What a blamed neighbour's pod shrinks to when a burning
        victim needs its chip: measured active + headroom. Coverage-
        guarded — a neighbour the ledger has no real data for is never
        squeezed on blame alone. None = not shrinkable."""
        cfg = self.cfg
        d = demand.get(tenant)
        if d is None:
            return None
        coverage = d["granted_s"] / max(cfg.window_s, 1e-9)
        if coverage < cfg.min_coverage:
            return None
        cur = pod.bookings[0][1]
        util = d["active_s"] / max(d["granted_s"], 1e-9)
        new = max(cfg.min_share,
                  self._quantize(cur * util
                                 * (1.0 + cfg.shrink_headroom)))
        if cur - new < cfg.min_delta:
            return None
        return round(new, 6)

    def _gang_of(self, pod) -> str:
        if self.gang_coordinator is None or not pod.bookings:
            return ""
        chip = pod.bookings[0][0]
        return self.gang_coordinator.gang_for(chip, pod.key) or ""

    @staticmethod
    def _gang_shape(eng, gang: str) -> tuple[int, int]:
        """(distinct booked chips, member count) of *gang* — the
        from/ceiling of an elastic grow proposal. Caller holds the
        dispatcher lock."""
        chips: set[str] = set()
        members = 0
        for p in eng.pod_status.values():
            if p.group_name and p.group_key == gang and p.bookings:
                members += 1
                chips.update(b[0] for b in p.bookings)
        return len(chips), members

    # -- planning --------------------------------------------------------

    def plan(self, now: float | None = None) -> dict:
        """Dry run: join burn + demand + blame into a resize/move plan,
        touch nothing. The returned dict is the complete decision
        record — feed it to :meth:`apply` unchanged."""
        if not self.enabled:
            return {"enabled": False, "resizes": [], "moves": []}
        now = self._clock() if now is None else now
        t0 = time.perf_counter()
        cfg = self.cfg
        d = self.dispatcher
        demand = tenant_demand(self.ledger, now - cfg.window_s, now, now,
                               self._tenant_fn) if self.ledger else {}
        burn = burn_state(self.slo.state(now)) if self.slo else {}
        resizes: list[dict] = []
        skipped: list[dict] = []
        moves: list[dict] = []
        tenants_view: dict[str, dict] = {}
        with d.lock:
            eng = d.engine
            by_tenant = self._pods_by_tenant(eng)
            ordered = sorted(
                by_tenant,
                key=lambda t: (-max(burn.get(t, {}).get("burn_slow", 0.0),
                                    burn.get(t, {}).get("burn_fast", 0.0)),
                               t))
            # phase 1: per-tenant targets through the rails
            targets: dict[str, tuple[float, float, str]] = {}
            for tenant in ordered:
                pods = by_tenant[tenant]
                current = round(sum(p.bookings[0][1] for p in pods), 6)
                target, why = self._target(tenant, current, burn,
                                           demand, len(pods), now)
                b_t = burn.get(tenant, {})
                tenants_view[tenant] = {
                    "share": current, "proposed": current,
                    "declared": round(sum(
                        self._declared.get(p.key, p.bookings[0][1])
                        for p in pods), 6),
                    "burn_fast": b_t.get("burn_fast", 0.0),
                    "burn_slow": b_t.get("burn_slow", 0.0),
                    "budget_remaining": b_t.get("budget_remaining", 1.0),
                    "firing": b_t.get("firing", False),
                    "idle_frac": demand.get(tenant, {}).get(
                        "idle_frac", 0.0),
                    "reason": "",
                }
                _BURN.set(tenant, value=b_t.get("burn_slow", 0.0))
                if not why:
                    continue
                if abs(target - current) < cfg.min_delta:
                    skipped.append({"tenant": tenant,
                                    "reason": "hysteresis"})
                    _SKIPPED.inc("hysteresis")
                    continue
                if any(self.cooldowns.cooling(p.key, now) for p in pods):
                    skipped.append({"tenant": tenant,
                                    "reason": "cooldown"})
                    _SKIPPED.inc("cooldown")
                    continue
                targets[tenant] = (current, target, why)
            # phase 2: materialize — shrinks FIRST (they free the very
            # capacity the grows consume, and apply executes in plan
            # order), then grows against the projected per-chip free,
            # squeezing blamed neighbours in when a grow doesn't fit.
            # Grows claim the resize budget first: they are the
            # SLO-critical half of the plan.
            grows = [t for t in ordered if t in targets
                     and targets[t][1] > targets[t][0]]
            shrinks = [t for t in ordered if t in targets
                       and targets[t][1] < targets[t][0]]
            picked: list[str] = []
            n_pods = 0
            for tenant in grows + shrinks:
                if n_pods + len(by_tenant[tenant]) > cfg.budget:
                    skipped.append({"tenant": tenant, "reason": "budget"})
                    _SKIPPED.inc("budget")
                    continue
                picked.append(tenant)
                n_pods += len(by_tenant[tenant])
            proj: dict[str, float] = {}   # chip -> projected free

            def chip_free(chip: str) -> float:
                if chip not in proj:
                    cell = eng.leaf_cells.get(chip)
                    proj[chip] = cell.available if cell is not None \
                        else 0.0
                return proj[chip]

            shrink_rs: list[dict] = []
            grow_rs: list[dict] = []

            def add_shrink(pod, new_req: float, tenant: str,
                           why: str) -> float:
                chip, cur_req, _mem = pod.bookings[0]
                gang = self._gang_of(pod)
                shrink_rs.append({
                    "pod": pod.key, "tenant": tenant, "chip": chip,
                    "from": cur_req, "to": new_req,
                    "direction": "shrink", "reason": why,
                    "mode": "effective-only" if gang else "rebook",
                    "gang": gang})
                _RESIZES.inc("shrink", "planned")
                if not gang:
                    chip_free(chip)
                    proj[chip] += cur_req - new_req
                return cur_req - new_req

            for tenant in picked:
                current, target, why = targets[tenant]
                if target >= current:
                    continue
                scale = target / current if current > 0 else 1.0
                freed = 0.0
                for pod in by_tenant[tenant]:
                    cur_req = pod.bookings[0][1]
                    new_req = max(cfg.min_share,
                                  round(cur_req * scale, 6))
                    if cur_req - new_req > 1e-9:
                        freed += add_shrink(pod, new_req, tenant, why)
                if freed:
                    tenants_view[tenant].update(
                        proposed=round(current - freed, 6), reason=why)
            squeezed: set[str] = set(t for t in picked
                                     if targets[t][1] < targets[t][0])
            elastic_props: list[dict] = []
            elastic_seen: set[str] = set()
            for tenant in picked:
                current, target, why = targets[tenant]
                if target <= current:
                    continue
                scale = target / current if current > 0 else 1.0
                grown = 0.0
                for pod in by_tenant[tenant]:
                    chip, cur_req, _mem = pod.bookings[0]
                    want = min(cfg.max_share, round(cur_req * scale, 6))
                    need = want - cur_req
                    if need <= 1e-9:
                        continue
                    gang = self._gang_of(pod)
                    if gang:
                        # gang members raise effective shares uniformly
                        # (no booking change) — headroom is the token
                        # window's, not the cell's
                        grow_rs.append({
                            "pod": pod.key, "tenant": tenant,
                            "chip": chip, "from": cur_req, "to": want,
                            "direction": "grow", "reason": why,
                            "mode": "effective-only", "gang": gang})
                        _RESIZES.inc("grow", "planned")
                        grown += need
                        # elastic grow (doc/elastic.md, off by default):
                        # a hot gang tenant gets a whole extra chip,
                        # not just a fatter token window — the fast-burn
                        # gate already admitted it into the grow set
                        if cfg.elastic_grow and gang not in elastic_seen:
                            elastic_seen.add(gang)
                            cur_chips, members = self._gang_shape(
                                eng, gang)
                            to_chips = min(
                                members,
                                cur_chips + cfg.elastic_grow_chips)
                            if to_chips > cur_chips:
                                elastic_props.append({
                                    "gang": gang, "tenant": tenant,
                                    "from_chips": cur_chips,
                                    "to_chips": to_chips,
                                    "reason": why})
                        continue
                    if chip_free(chip) + 1e-9 < need \
                            and self.blame is not None:
                        # the blame graph picks which neighbour on this
                        # chip makes room (Tally: measured interference,
                        # not declared demand)
                        for nb in blamed_neighbours(
                                self.blame, tenant,
                                tenant_fn=self._tenant_fn):
                            if nb == tenant or nb in squeezed \
                                    or nb in grows:
                                continue
                            nb_pod = next(
                                (p for p in by_tenant.get(nb, [])
                                 if p.bookings[0][0] == chip
                                 and not p.group_name), None)
                            if nb_pod is None or self.cooldowns.cooling(
                                    nb_pod.key, now):
                                continue
                            # same rails as a voluntary shrink: never
                            # squeeze a tenant that burned budget this
                            # window or one shrunk inside the window
                            nb_b = burn.get(nb)
                            if nb_b is not None and max(
                                    nb_b["burn_fast"],
                                    nb_b["burn_slow"]) >= cfg.grow_burn:
                                continue
                            if self._shrink_spaced(nb, now):
                                _SKIPPED.inc("shrink-window")
                                continue
                            nb_new = self._squeeze_target(
                                nb, nb_pod, demand)
                            if nb_new is None:
                                continue
                            squeezed.add(nb)
                            add_shrink(nb_pod, nb_new, nb,
                                       "blame-shrink")
                            tenants_view[nb].update(
                                proposed=nb_new, reason="blame-shrink")
                            if chip_free(chip) + 1e-9 >= need:
                                break
                    grant = min(need, max(0.0, chip_free(chip)))
                    new_req = round(cur_req + grant, 6)
                    if new_req - cur_req < cfg.min_delta:
                        skipped.append({"tenant": tenant,
                                        "pod": pod.key,
                                        "reason": "no-headroom"})
                        _SKIPPED.inc("no-headroom")
                        continue
                    proj[chip] -= grant
                    grow_rs.append({
                        "pod": pod.key, "tenant": tenant, "chip": chip,
                        "from": cur_req, "to": new_req,
                        "direction": "grow", "reason": why,
                        "mode": "rebook", "gang": ""})
                    _RESIZES.inc("grow", "planned")
                    grown += new_req - cur_req
                if grown:
                    tenants_view[tenant].update(
                        proposed=round(current + grown, 6), reason=why)
                elif why:
                    tenants_view[tenant]["reason"] = "no-headroom"
            resizes = shrink_rs + grow_rs
            # pack stage: chips left mostly empty by the shrinks above
            # are drained through the same trial-booked migration path
            # the autopilot uses — freed capacity lands on fewer chips
            if cfg.move_budget > 0:
                moves = self._plan_pack(eng, resizes, now)
            chip_equiv = {
                "declared": round(sum(
                    sum(self._declared.get(p.key, p.bookings[0][1])
                        for p in pods)
                    for pods in by_tenant.values()), 6),
                "current": round(sum(
                    sum(p.bookings[0][1] for p in pods)
                    for pods in by_tenant.values()), 6),
            }
        chip_equiv["proposed"] = round(
            chip_equiv["current"]
            + sum(r["to"] - r["from"] for r in resizes), 6)
        _EQUIV.set("declared", value=chip_equiv["declared"])
        _EQUIV.set("booked", value=chip_equiv["current"])
        for tenant, view in tenants_view.items():
            _SHARE.set(tenant, "declared", value=view["declared"])
            _SHARE.set(tenant, "booked", value=view["share"])
        plan = {"enabled": True, "generated_at": round(now, 3),
                "window_s": cfg.window_s, "resizes": resizes,
                "moves": moves, "skipped": skipped,
                "tenants": tenants_view,
                "chip_equivalents": chip_equiv}
        if cfg.elastic_grow:
            # key present only behind the flag: the off-path plan (and
            # decision stream below) stays bit-identical to a build
            # without the elastic plane
            plan["elastic"] = elastic_props
        _PLAN_LAT.observe(value=time.perf_counter() - t0)
        tracer = get_tracer()
        tracer.record("rightsize-plan", "", tracer.now_ms(),
                      tracer.now_ms(), resizes=len(resizes),
                      moves=len(moves))
        dec = getattr(self.dispatcher, "decisions", None)
        if dec is not None:
            extra = {}
            if cfg.elastic_grow:
                extra["elastic"] = [
                    {"gang": p["gang"], "to_chips": p["to_chips"],
                     "reason": p["reason"]} for p in elastic_props]
            dec.record("rightsize-plan", now,
                       resizes=[{"pod": r["pod"], "from": r["from"],
                                 "to": r["to"], "reason": r["reason"]}
                                for r in resizes],
                       moves=[{"pod": m["pod"], "from": m["from"],
                               "node": m["node"]} for m in moves],
                       chip_equivalents=chip_equiv, **extra)
        self.last_plan = plan
        return plan

    def _plan_pack(self, eng, resizes: list[dict], now: float) -> list:
        """Consolidation moves off low-utilization chips (caller holds
        the dispatcher lock). Advisory like every migration plan: the
        apply path re-verifies capacity and restores the source on
        failure."""
        cfg = self.cfg
        post: dict[str, float] = {}      # chip -> booked after resizes
        pods_on: dict[str, list] = {}
        delta = {r["pod"]: r["to"] - r["from"] for r in resizes
                 if r["mode"] == "rebook"}
        for pod in eng.pod_status.values():
            if (not pod.node_name or not pod.needs_tpu or pod.multi_chip
                    or not pod.bookings or pod.group_name):
                continue
            chip, req, _mem = pod.bookings[0]
            post[chip] = post.get(chip, 0.0) + req + delta.get(pod.key,
                                                               0.0)
            pods_on.setdefault(chip, []).append(pod)
        drain = {chip for chip, used in post.items()
                 if 0.0 < used <= cfg.pack_util}
        # pods only move TOWARD chips that already carry real load —
        # nodes whose every occupied chip is itself a drain candidate
        # are excluded, or consolidation would oscillate slivers
        # between equally-empty homes forever
        receivers = set()
        for chip, used in post.items():
            if used > cfg.pack_util:
                cell = eng.leaf_cells.get(chip)
                if cell is not None:
                    receivers.add(cell.node)
        if not drain or not receivers:
            return []
        exclude = tuple(n for n in eng.nodes if n not in receivers)
        moves: list[dict] = []
        resized = set(delta)
        for chip in sorted(drain, key=lambda c: (post[c], c)):
            for pod in sorted(pods_on.get(chip, []),
                              key=lambda p: p.key):
                if len(moves) >= cfg.move_budget:
                    return moves
                if pod.key in resized:
                    continue      # one actuation per pod per cycle
                last = self._last_packed.get(pod.key)
                if last is not None and \
                        now - last < cfg.pack_cooldown_s:
                    _SKIPPED.inc("pack-cooldown")
                    continue
                if self.cooldowns.cooling(pod.key, now):
                    _SKIPPED.inc("cooldown")
                    continue
                mplan = self.dispatcher.plan_migration(pod.key, exclude)
                if mplan is None or mplan["node"] == pod.node_name:
                    continue
                self._last_packed[pod.key] = now
                moves.append({"pod": pod.key, "from": mplan["from"],
                              "node": mplan["node"], "reason": "pack"})
        return moves

    # -- application -----------------------------------------------------

    def _actuate(self, rec: dict) -> None:
        """Engine re-book + token-scheduler effective push for ONE
        resize record; raises to signal failure (caller rolls the whole
        plan back)."""
        if rec["mode"] == "effective-only":
            coord = self.gang_coordinator
            if coord is None:
                raise RuntimeError(
                    f"{rec['pod']}: gang resize without a coordinator")
            if not coord.set_effective_gang(rec["gang"], rec["to"],
                                            max(rec["to"], rec["from"])):
                raise RuntimeError(
                    f"{rec['pod']}: gang {rec['gang']} refused the "
                    "effective resize")
            return
        self.dispatcher.resize_request(rec["pod"], rec["to"])
        sched = self.schedulers.get(rec["chip"])
        if sched is not None and not sched.set_effective(
                rec["pod"], rec["to"], max(rec["to"], rec["from"])):
            # the booking is authoritative; a pre-set_effective native
            # core just keeps granting at base — diagnosable, not fatal
            _SKIPPED.inc("no-set-effective")
            log.warning("chip %s: token core predates set_effective; "
                        "resize of %s is booking-only", rec["chip"],
                        rec["pod"])

    def _revert(self, rec: dict) -> None:
        if rec["mode"] == "effective-only":
            if self.gang_coordinator is not None:
                self.gang_coordinator.restore_base(rec["gang"])
            return
        self.dispatcher.resize_request(rec["pod"], rec["from"])
        sched = self.schedulers.get(rec["chip"])
        if sched is not None:
            sched.set_effective(rec["pod"], rec["from"],
                                max(rec["to"], rec["from"]))

    def apply(self, plan: dict | None = None) -> dict:
        """Execute *plan* (default: the last one emitted). Resizes are
        whole-plan atomic — one member failing reverts every resize
        already applied in this batch; pack moves then run through the
        rebalancer's journaled gang-atomic units."""
        if not self.enabled:
            return {"enabled": False, "applied": [], "rolled_back": [],
                    "failed": [], "moves": None}
        if plan is None:
            plan = self.last_plan or {"resizes": [], "moves": []}
        resizes = list(plan.get("resizes", []))
        now = self._clock()
        self._batch_seq += 1
        batch = f"rightsize-{self._batch_seq}"
        result = {"batch": batch, "applied": [], "rolled_back": [],
                  "failed": [], "moves": None}
        if resizes:
            self._journal({"event": "batch_begin", "batch": batch,
                           "resizes": [{k: r[k] for k in
                                        ("pod", "from", "to")}
                                       for r in resizes]})
        done: list[dict] = []
        for rec in resizes:
            try:
                self._actuate(rec)
            except Exception as e:
                log.warning("resize of %s failed (%s); rolling the "
                            "whole batch back", rec["pod"], e)
                result["failed"].append(dict(rec, error=str(e)))
                _RESIZES.inc(rec["direction"], "failed")
                for prev in reversed(done):
                    try:
                        self._revert(prev)
                    except Exception as back:
                        log.error("rollback of %s failed: %s",
                                  prev["pod"], back)
                    self._journal({"event": "resize_rolled_back",
                                   "batch": batch, "pod": prev["pod"]})
                    result["rolled_back"].append(prev)
                    _RESIZES.inc(prev["direction"], "rolled_back")
                    self.rolled_back_total += 1
                done = []
                break
            done.append(rec)
            self._journal({"event": "resize_done", "batch": batch,
                           "pod": rec["pod"], "to": rec["to"]})
        for rec in done:
            self.cooldowns.note(rec["pod"], now)
            if rec["to"] < rec["from"]:
                self._last_shrunk[rec["tenant"]] = now
            result["applied"].append(rec)
            _RESIZES.inc(rec["direction"], "applied")
            self.applied_total += 1
        if resizes:
            self._journal({"event": "batch_end", "batch": batch,
                           "applied": len(done)})
        moves = list(plan.get("moves", []))
        if moves and not result["failed"]:
            result["moves"] = self.rebalancer.apply({"moves": moves})
        props = list(plan.get("elastic", []))
        if props and not result["failed"] and self.cfg.elastic_grow \
                and self.elastic is not None:
            # whole-gang grows run through the elastic orchestrator's
            # own journaled state machine; it records and cools each
            # member itself, so a refused resize costs nothing here
            result["elastic"] = []
            for pr in props:
                out = self.elastic.resize(pr["gang"], pr["to_chips"],
                                          reason="rightsize-grow")
                result["elastic"].append(
                    {"gang": pr["gang"],
                     "outcome": out.get("outcome", "error")})
        dec = getattr(self.dispatcher, "decisions", None)
        if dec is not None:
            extra = {}
            if self.cfg.elastic_grow:
                extra["elastic"] = list(result.get("elastic", []))
            dec.record("rightsize-apply", now,
                       applied=[r["pod"] for r in result["applied"]],
                       rolled_back=[r["pod"]
                                    for r in result["rolled_back"]],
                       failed=[r["pod"] for r in result["failed"]],
                       moves=(result["moves"] or {}).get("applied", []),
                       **extra)
        self.last_apply = result
        return result

    def cycle(self, now: float | None = None,
              apply: bool = True) -> dict:
        """One closed-loop pass: plan, then apply when anything came
        out. Returns the plan augmented with what actually happened."""
        if not self.enabled:
            return {"enabled": False, "resizes": [], "moves": [],
                    "applied": [], "rolled_back": [], "failed": []}
        self.cycles += 1
        _CYCLES.inc()
        out = dict(self.plan(now=now))
        if apply and (out.get("resizes") or out.get("moves")):
            result = self.apply(out)
            out.update(applied=result["applied"],
                       rolled_back=result["rolled_back"],
                       failed=result["failed"],
                       move_result=result["moves"])
        else:
            out.update(applied=[], rolled_back=[], failed=[])
        return out

    def snapshot(self) -> dict:
        """State for ``/rightsize`` and ``topcli --rightsize``; safe on
        a disabled (or fresh) instance."""
        return {
            "attached": True,
            "enabled": self.enabled,
            "config": asdict(self.cfg),
            "cycles": self.cycles,
            "applied_total": self.applied_total,
            "rolled_back_total": self.rolled_back_total,
            "tenants": dict((self.last_plan or {}).get("tenants", {})),
            "chip_equivalents": dict(
                (self.last_plan or {}).get("chip_equivalents", {})),
            "pending_resizes": list(
                (self.last_plan or {}).get("resizes", [])),
            "pending_moves": list(
                (self.last_plan or {}).get("moves", [])),
            "last_plan": self.last_plan,
            "last_apply": self.last_apply,
        }
