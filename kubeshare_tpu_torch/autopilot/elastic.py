"""Elastic quota reclamation: revocable burst credit from idle shares
(doc/autopilot.md).

The port's copy of ``kubeshare_tpu/autopilot/elastic.py``.

A chip's token scheduler guarantees each client ``tpu_request`` of the
sliding window and caps it at ``tpu_limit``. When a client's *observed*
window utilization sits well below its guarantee, that headroom is dead
capacity — co-tenants pinned at their limit starve next to it (Tally's
non-intrusive reclamation argument, arXiv:2410.07381). This module
closes the loop from observation to policy:

  * **lenders** — clients with no façade-level demand whose utilization
    is below ``idle_frac`` of their guaranteed request;
  * **borrowers** — clients queued for the token or running hot against
    their effective limit (``hot_frac``);
  * ``lend_frac`` of the lenders' measured headroom is pushed into the
    scheduler as *effective* request/limit raises via ``set_effective``
    — base shares are never touched, so nothing a client was promised
    is ever violated;
  * revocation is **demand-triggered**, not poll-triggered: every
    ``TokenScheduler`` demand (acquire/renew) fires the ``on_demand``
    hook under the scheduler lock BEFORE the grant decision, so a
    lender's first re-request restores base shares within that same
    token cycle — the very grant it is waiting on is already decided
    under guaranteed shares.

The controller calls :meth:`step` on its cadence; hooks fire between
steps on their own. All per-chip state is mutated under that chip's
scheduler condition (the same lock the hook already holds), so the two
entry points cannot race; cross-chip totals use plain attributes guarded
by the same discipline (one chip's lock at a time, no nesting).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

from ..obs import metrics as obs_metrics
from ..utils.logger import get_logger

log = get_logger("autopilot")

_OBS = obs_metrics.default_registry()
_CREDIT = _OBS.gauge(
    "kubeshare_autopilot_burst_credit",
    "Revocable burst credit (window fraction) currently lent to a "
    "client on a chip; 0 after revocation.",
    labels=("chip", "client"))
_RECLAIMED = _OBS.counter(
    "kubeshare_autopilot_reclaimed_ms_total",
    "Idle guaranteed-share window time re-lent as burst credit, "
    "accrued at revocation/expiry (device-ms: credit fraction x ms "
    "outstanding).")
_REVOKES = _OBS.counter(
    "kubeshare_autopilot_credit_revocations_total",
    "Burst-credit revocations by trigger.",
    labels=("reason",))
_SKIPPED = _OBS.counter(
    "kubeshare_elastic_skipped_total",
    "Elastic lending cycles that granted nothing, by reason — "
    "\"no-set-effective\" means the chip's native token core predates "
    "effective shares and lending is inert on it.",
    labels=("reason",))


@dataclass
class _Credit:
    amount: float                       # window fraction lent
    lenders: set = field(default_factory=set)
    since_ms: float = 0.0
    gang: str = ""                      # non-empty: gang-uniform credit


class ElasticQuota:
    """One policy instance over any number of per-chip TokenSchedulers.

    With a ``gang_coordinator`` wired (doc/gang.md), credit for a
    borrower that is a gang member is applied *uniformly* across every
    member chip via ``set_effective_gang`` instead of adjusting one
    chip — a single-chip raise would be consumed by the gang-atomic
    grant's slowest member and leave the mesh skewed. Gang broadcasts
    never run under a chip's scheduler condition (the coordinator must
    take OTHER chips' conditions): they are queued inside the locked
    sections and flushed from :meth:`step` outside any chip lock. A
    lender-demand revocation restores the lender's own chip
    synchronously (that grant decision is already under base shares);
    sibling chips are restored at the next flush."""

    def __init__(self, schedulers: dict | None = None,
                 idle_frac: float = 0.5, lend_frac: float = 0.75,
                 hot_frac: float = 0.8, gang_coordinator=None):
        self.idle_frac = idle_frac
        self.lend_frac = lend_frac
        self.hot_frac = hot_frac
        self.gang_coordinator = gang_coordinator
        self._scheds: dict[str, object] = {}
        self._credits: dict[str, dict[str, _Credit]] = {}
        #: deferred coordinator calls ("grant"/"restore", ...) queued
        #: under chip conds, flushed lock-free by step()
        self._gang_ops: list[tuple] = []
        self.reclaimed_ms = 0.0
        self.revocations = 0
        for chip, sched in (schedulers or {}).items():
            self.attach(chip, sched)

    def attach(self, chip: str, sched) -> "ElasticQuota":
        self._scheds[chip] = sched
        sched.on_demand = functools.partial(self._on_demand, chip)
        return self

    # -- demand hook (fires inside acquire/renew, under sched._cond) -----

    def _on_demand(self, chip: str, name: str) -> None:
        credits = self._credits.get(chip)
        if not credits:
            return
        if any(name in cr.lenders for cr in credits.values()):
            # the lender wants its share back NOW — restore base shares
            # before the grant decision this demand triggers
            self._revoke_locked(chip, self._scheds[chip],
                                reason="lender-demand")

    # -- periodic step ---------------------------------------------------

    def step(self) -> dict:
        """Re-evaluate every chip: revoke stale credit, grant where a
        measurable idle/starved pair exists. Returns a per-chip summary
        (for the controller's cycle record)."""
        out = {}
        for chip, sched in self._scheds.items():
            with sched._cond:
                out[chip] = self._step_chip_locked(chip, sched)
        self._flush_gang_ops()
        return out

    def _flush_gang_ops(self) -> None:
        """Apply deferred gang-wide grants/restores. Runs with NO chip
        condition held — the coordinator takes each member chip's
        condition itself."""
        ops, self._gang_ops = self._gang_ops, []
        coord = self.gang_coordinator
        if coord is None or not ops:
            return
        restored: set[str] = set()
        for op in ops:
            if op[0] == "restore":
                gang = op[1]
                if gang in restored:
                    continue
                restored.add(gang)
                try:
                    coord.restore_base(gang)
                except Exception:
                    log.exception("gang %s: restore_base failed", gang)
                continue
            _, gang, chip, name, eff_req, eff_limit = op
            ok = False
            if self._gang_has_slack(gang, name, eff_req):
                try:
                    ok = coord.set_effective_gang(gang, eff_req,
                                                  eff_limit)
                except Exception:
                    log.exception("gang %s: set_effective_gang failed",
                                  gang)
            if not ok:
                self._drop_credit(chip, name, reason="gang-refused")

    def _gang_has_slack(self, gang: str, borrower: str,
                        eff_req: float) -> bool:
        """True when every member chip can absorb the raised request —
        one chip's idle headroom must not oversubscribe a sibling whose
        co-tenants the lender never saw. Measured against the siblings'
        co-tenants' *observed* window usage, not their promised shares:
        like the single-chip grant itself, an idle promise is exactly
        the capacity being lent."""
        members = self.gang_coordinator.gang_members(gang)
        if not members:
            return False
        for mchip, mname in members:
            sched = self._scheds.get(mchip)
            if sched is None:
                return False
            base = sched.shares()
            if mname not in base:
                return False
            total = eff_req
            for cname in base:
                if cname != mname:
                    try:
                        total += sched.window_usage(cname) / sched.window_ms
                    except KeyError:
                        pass       # removed between shares() and here
            if total > 1.0 + 1e-9:
                return False
        return True

    def _drop_credit(self, chip: str, name: str, reason: str) -> None:
        """Forget a recorded credit whose gang broadcast was refused —
        nothing was applied anywhere, so there is nothing to restore."""
        sched = self._scheds.get(chip)
        if sched is None:
            return
        with sched._cond:
            credits = self._credits.get(chip) or {}
            if credits.pop(name, None) is None:
                return
            if not credits:
                self._credits.pop(chip, None)
            _CREDIT.set(chip, name, value=0.0)
        self.revocations += 1
        _REVOKES.inc(reason)
        log.info("chip %s: gang credit for %s dropped (%s)",
                 chip, name, reason)

    def _step_chip_locked(self, chip: str, sched) -> dict:
        now = sched.now_ms()
        base = sched.shares()
        summary = {"lent": 0.0, "borrowers": [], "lenders": []}
        if len(base) < 2:
            if self._credits.get(chip):
                self._revoke_locked(chip, sched, reason="lone-client")
            return summary
        waiting = set(sched.waiting())
        usage = {}
        for name in base:
            try:
                usage[name] = sched.window_usage(name) / sched.window_ms
            except KeyError:      # removed between shares() and here
                usage[name] = 0.0
        credits = self._credits.get(chip) or {}
        if credits:
            # standing credit: keep it only while every lender is still
            # measurably idle — otherwise restore base shares and let
            # the next step re-grant from fresh numbers
            lenders = set().union(*(cr.lenders for cr in credits.values()))
            stale = any(n in waiting
                        or usage.get(n, 0.0) >= self.idle_frac * base[n][0]
                        for n in lenders)
            if stale:
                self._revoke_locked(chip, sched, reason="demand-returned")
            else:
                summary["lent"] = round(
                    sum(cr.amount for cr in credits.values()), 6)
                summary["lenders"] = sorted(lenders)
                summary["borrowers"] = sorted(credits)
                return summary
        headroom = {
            name: req - usage[name]
            for name, (req, _limit) in base.items()
            if name not in waiting and usage[name] < self.idle_frac * req}
        borrowers = [
            name for name, (_req, limit) in base.items()
            if name not in headroom
            and (name in waiting or usage[name] >= self.hot_frac * limit)]
        pool = sum(headroom.values()) * self.lend_frac
        if pool <= 1e-9 or not borrowers:
            return summary
        credits = {}
        per = pool / len(borrowers)
        now_lent = 0.0
        for name in borrowers:
            req, limit = base[name]
            new_limit = min(1.0, limit + per)
            grant = new_limit - limit
            if grant <= 1e-9:
                continue      # already at the whole window — nothing to lend
            gang = ""
            if self.gang_coordinator is not None:
                # chip-cond -> coordinator-lock nesting is the allowed
                # direction (same order the demand hook uses)
                gang = self.gang_coordinator.gang_for(chip, name) or ""
            if gang:
                # uniform raise across the gang — deferred, because the
                # broadcast needs every member chip's condition
                self._gang_ops.append(
                    ("grant", gang, chip, name,
                     min(req + grant, new_limit), new_limit))
            elif not sched.set_effective(name, min(req + grant, new_limit),
                                         new_limit):
                # core predates set_effective: no credit was (or can be)
                # granted on this chip — count it so inert lending shows
                # up on a dashboard instead of silently doing nothing
                _SKIPPED.inc("no-set-effective")
                log.warning("chip %s: token core predates set_effective; "
                            "elastic lending is inert here", chip)
                return summary
            credits[name] = _Credit(amount=grant, lenders=set(headroom),
                                    since_ms=now, gang=gang)
            _CREDIT.set(chip, name, value=grant)
            now_lent += grant
        if credits:
            self._credits[chip] = credits
            log.info("chip %s: lent %.3f of the window to %s (idle: %s)",
                     chip, now_lent, sorted(credits), sorted(headroom))
        summary["lent"] = round(now_lent, 6)
        summary["lenders"] = sorted(headroom)
        summary["borrowers"] = sorted(credits)
        return summary

    # -- revocation ------------------------------------------------------

    def _revoke_locked(self, chip: str, sched, reason: str) -> int:
        """Restore base shares for every borrower on *chip* (caller
        holds the chip's scheduler condition)."""
        credits = self._credits.pop(chip, None)
        if not credits:
            return 0
        now = sched.now_ms()
        base = sched.shares()
        for name, credit in credits.items():
            share = base.get(name)
            if share is not None:
                try:
                    sched.set_effective(name, share[0], share[1])
                except Exception:
                    log.exception("revoking credit of %s on %s failed",
                                  name, chip)
            if credit.gang:
                # this chip is whole as of the line above; sibling
                # chips are restored at the next step() flush (we
                # cannot take their conditions from under this one)
                self._gang_ops.append(("restore", credit.gang))
            lent_ms = credit.amount * max(0.0, now - credit.since_ms)
            self.reclaimed_ms += lent_ms
            _RECLAIMED.inc(amount=lent_ms)
            _CREDIT.set(chip, name, value=0.0)
        self.revocations += 1
        _REVOKES.inc(reason)
        log.info("chip %s: revoked burst credit of %s (%s)",
                 chip, sorted(credits), reason)
        return len(credits)

    # -- introspection ---------------------------------------------------

    def snapshot(self) -> dict:
        chips = {}
        for chip, sched in self._scheds.items():
            with sched._cond:
                credits = self._credits.get(chip) or {}
                chips[chip] = {
                    name: {"amount": round(cr.amount, 6),
                           "lenders": sorted(cr.lenders),
                           "since_ms": cr.since_ms,
                           "gang": cr.gang}
                    for name, cr in credits.items()}
        return {"chips": chips,
                "reclaimed_ms": round(self.reclaimed_ms, 3),
                "revocations": self.revocations}
