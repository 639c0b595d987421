"""Gang-atomic token grants: the co-scheduled gang, not the chip, is
the unit of time-slicing.

The port's copy of ``kubeshare_tpu/gang/coordinator.py``, the elastic
plane's uniform effective shares (``set_effective_gang``,
``restore_base``) included.

The per-chip :class:`~kubeshare_tpu_torch.isolation.tokensched.TokenScheduler`
stays the single source of truth for shares and window accounting; the
:class:`GangTokenCoordinator` sits above N of them and issues one grant
for the whole sub-mesh via two-phase reserve/commit:

* **reserve** — member chips are acquired one at a time in sorted chip
  order (every gang and every coordinator uses the same total order, so
  two gangs contending for overlapping chips cannot hold-and-wait in a
  cycle). The first chip may park for the caller's full deadline; each
  subsequent chip is bounded by ``reserve_window_s`` so a co-tenant
  single holding chip k can stall the gang for at most one window.
* **commit / back off** — only when *every* member holds its token does
  the gang run. A partial reservation is fully released (zero usage
  charged) and retried after a bounded, jittered backoff, so a gang can
  neither deadlock co-tenant singles nor live-lock itself.

Lock discipline (matches ``autopilot/elastic.py``): coordinator state
lives under ``self._lock``; **no TokenScheduler method is ever called
while holding it**. Chip-cond → coordinator-lock nesting (the elastic
``on_demand`` hook asking :meth:`gang_for`) is therefore safe, and the
reverse order never occurs.

``pause``/``resume`` give autopilot's gang-atomic migration a zero
partial-grant window: a paused gang admits no new reserve and ``pause``
returns only once in-flight holds have drained.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from ..obs import metrics as obs_metrics
from ..obs import prof as obs_prof
from ..obs.trace import get_tracer
from ..utils.logger import get_logger

log = get_logger("gang")

_OBS = obs_metrics.default_registry()
_GANG_GRANT_WAIT = _OBS.histogram(
    "kubeshare_gang_grant_wait_seconds",
    "Time a gang blocked between requesting a gang-atomic grant and "
    "holding every member chip's token.",
    labels=("gang", "namespace", "tpu_class"))
_GANG_HOLD = _OBS.histogram(
    "kubeshare_gang_hold_seconds",
    "Wall time a gang held its full token set before releasing it.",
    labels=("gang",))
_GANG_PARTIAL = _OBS.counter(
    "kubeshare_gang_partial_releases_total",
    "Partial gang reservations released (a member chip could not be "
    "acquired inside the reserve window).",
    labels=("gang",))
_GANG_PAUSED = _OBS.gauge(
    "kubeshare_gang_paused",
    "1 while gang grants are paused (migration flip in progress).",
    labels=("gang",))


def _percentile(samples: list[float], q: float) -> float:
    if not samples:
        return 0.0
    ordered = sorted(samples)
    idx = min(len(ordered) - 1, int(round(q * (len(ordered) - 1))))
    return ordered[idx]


@dataclass
class _Gang:
    gang_id: str
    #: sorted (chip, client) pairs — a chip may appear twice when two
    #: fractional members co-locate on it. The grant unit is the CHIP
    #: token (exclusive), acquired once per distinct chip through a
    #: representative client; co-located members run under that one
    #: hold. The full pair list still drives uniform effective-share
    #: broadcasts and the operator view.
    members: list[tuple[str, str]]
    namespace: str = ""
    tpu_class: str = "best-effort"
    state: str = "idle"                # idle | reserving | held
    #: chip -> (representative client, quota_ms)
    held: dict[str, tuple] = field(default_factory=dict)
    reserve_started: float = 0.0       # coordinator-clock seconds
    held_since: float = 0.0
    backoff_until: float = 0.0
    attempts: int = 0
    paused: bool = False
    #: the preemption plane asked this gang to yield its full hold at
    #: the next program boundary (gang-atomic preemption)
    preempt_requested: bool = False
    grants: int = 0
    partial_releases: int = 0
    preemptions: int = 0               # times this gang was preempted
    waits: deque = field(default_factory=lambda: deque(maxlen=256))


class GangTokenCoordinator:
    """Issues gang-atomic grants over per-chip TokenSchedulers.

    ``clock`` returns *seconds* (``time.monotonic`` by default; the
    chaos plane injects its virtual clock) and ``used_scale`` converts
    a hold duration on that clock into the schedulers' usage units —
    1000.0 for real schedulers (ms), 1.0 when the scheduler clock is the
    same virtual-seconds clock (chaos).
    """

    def __init__(self, reserve_window_s: float = 0.25,
                 backoff_base_s: float = 0.01, backoff_max_s: float = 0.2,
                 clock=None, used_scale: float = 1000.0, rng=None,
                 auto_hold_s: float = 0.05, ledger=None, preempt=None):
        self.reserve_window_s = reserve_window_s
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.used_scale = used_scale
        self.auto_hold_s = auto_hold_s
        #: when True, :meth:`step` drives every gang's grant cycle
        #: (non-blocking; the chaos plane's virtual-time mode). Blocking
        #: :meth:`acquire` is the live-runner mode — don't mix per gang.
        self.auto_drive = False
        self._clock = clock or time.monotonic
        #: chip-time ledger (obs/ledger.py). Member acquires/releases
        #: already land in the ledger through each chip's TokenScheduler;
        #: the coordinator overlays the gang-specific states — the
        #: two-phase ``reserving`` window, the commit, and migration
        #: pause windows — on this clock (seconds, same as ``clock``).
        self._ledger = ledger
        #: preemption policy (..preempt). Gang preemption
        #: routes through the same two-phase machinery: the decision is
        #: made once for the whole gang under ``self._lock`` and the
        #: per-chip marks/boosts are issued in sorted chip order — no
        #: partial-preemption window, no hold-and-wait cycle.
        self.preempt = preempt
        self._rng = rng or random.Random(0xD1CE)
        # tracked (doc/observability.md): gang reserve/commit and
        # pause windows all serialize here
        self._lock = obs_prof.TrackedCondition("gangcoord")
        self._scheds: dict[str, object] = {}
        self._gangs: dict[str, _Gang] = {}

    # -- membership ---------------------------------------------------

    def attach_chip(self, chip: str, sched) -> None:
        with self._lock:
            self._scheds[chip] = sched

    def detach_chip(self, chip: str) -> None:
        with self._lock:
            self._scheds.pop(chip, None)
            affected = [g for g in self._gangs.values() if chip in g.held]
        # a gang that held the vanished chip no longer holds its full
        # set — release the surviving members so no partial lingers
        for g in affected:
            self._release_held(g, used=0.0)

    @staticmethod
    def _pairs(members) -> list[tuple[str, str]]:
        """Normalize a membership spec — ``{chip: client}`` or an
        iterable of ``(chip, client)`` pairs — into the stored sorted
        pair list. The sorted order is the reserve order (deadlock
        avoidance), and duplicates of a chip are legal: two fractional
        members co-located on one chip are two token streams."""
        if isinstance(members, dict):
            return sorted(members.items())
        return sorted((str(c), str(cl)) for c, cl in members)

    @staticmethod
    def _reserve_plan(members) -> list[tuple[str, str]]:
        """One (chip, representative client) per distinct chip, in
        sorted chip order — the chip token is exclusive, so co-located
        members share a single hold taken through the first client."""
        plan: dict[str, str] = {}
        for chip, client in members:       # members already sorted
            plan.setdefault(chip, client)
        return sorted(plan.items())

    def register_gang(self, gang_id: str, members,
                      namespace: str = "",
                      tpu_class: str = "best-effort") -> None:
        """Publish (or re-publish, e.g. after a migration rebind) a
        gang's (chip, client) membership. Idempotent."""
        pairs = self._pairs(members)
        with self._lock:
            g = self._gangs.get(gang_id)
            if g is None:
                self._gangs[gang_id] = _Gang(gang_id, pairs,
                                             namespace, tpu_class)
                self._lock.notify_all()
                return
            stale = g.members != pairs
            g.namespace = namespace or g.namespace
            g.tpu_class = tpu_class or g.tpu_class
            if not stale:
                return
            g.members = pairs
        if stale:
            # membership flipped under a live grant: drop the stale holds
            self._release_held(self._gangs[gang_id], used=0.0)

    def unregister_gang(self, gang_id: str) -> None:
        with self._lock:
            g = self._gangs.get(gang_id)
        if g is None:
            return
        self._release_held(g, used=0.0)
        with self._lock:
            self._gangs.pop(gang_id, None)
            self._lock.notify_all()

    def gang_for(self, chip: str, client: str) -> str | None:
        """Which gang (if any) owns *client* on *chip* — the elastic
        plane's routing query. Safe to call under a chip cond."""
        with self._lock:
            for g in self._gangs.values():
                if (chip, client) in g.members:
                    return g.gang_id
        return None

    def gangs(self) -> list[str]:
        with self._lock:
            return sorted(self._gangs)

    def gang_members(self, gang_id: str) -> list[tuple[str, str]]:
        """Sorted ``(chip, client)`` pairs for a registered gang
        ([] when unknown)."""
        with self._lock:
            g = self._gangs.get(gang_id)
            return list(g.members) if g is not None else []

    # -- gang-atomic grant (blocking; live runners) -------------------

    @staticmethod
    def _remaining(deadline: float | None) -> float | None:
        if deadline is None:
            return None
        return max(0.0, deadline - time.monotonic())

    def _gang(self, gang_id: str) -> _Gang:
        # caller holds self._lock
        try:
            return self._gangs[gang_id]
        except KeyError:
            raise KeyError(f"gang {gang_id!r} not registered") from None

    def acquire(self, gang_id: str, timeout: float | None = None,
                trace_id: str = "") -> dict[str, float]:
        """Block until every member chip's token is held; returns
        ``{chip: quota_ms}``. Raises TimeoutError past *timeout*."""
        deadline = None if timeout is None else time.monotonic() + timeout
        t0 = time.monotonic()
        while True:
            with self._lock:
                g = self._gang(gang_id)
                while g.paused or g.state != "idle":
                    if not self._lock.wait(self._remaining(deadline)):
                        raise TimeoutError(
                            f"gang {gang_id}: grant wait timed out (paused "
                            f"or busy)")
                    g = self._gang(gang_id)
                g.state = "reserving"
                g.reserve_started = self._clock()
                g.held = {}
                g.attempts += 1
                plan = self._reserve_plan(g.members)
            failure = self._reserve(g, plan, deadline, trace_id)
            if failure is not None:
                self._release_held(g, used=0.0, partial=True)
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"gang {gang_id}: grant wait timed out ({failure})")
                if not self._maybe_preempt_blockers(g):
                    # no victim fired or draining for this plan: plain
                    # contention, back off. With a preemption in flight
                    # retry at once instead — the waiter must be parked
                    # on its anchor chip when the victim yields, so the
                    # directed grant lands on a live request rather
                    # than being skipped for a work-conserving rival.
                    self._backoff_sleep(g.attempts, deadline)
                continue
            committed = False
            with self._lock:
                if not g.paused:
                    committed = True
                    g.state = "held"
                    g.held_since = self._clock()
                    g.grants += 1
                    g.attempts = 0
                    wait_s = time.monotonic() - t0
                    g.waits.append(wait_s)
                    held = {chip: quota
                            for chip, (_cl, quota) in g.held.items()}
                    ns, cls = g.namespace, g.tpu_class
            if committed:
                self._mark_committed(held)
                self._note_grant(gang_id, ns, cls, wait_s, held, trace_id)
                return held
            # migration flip raced the commit: give the tokens back and
            # park until resume
            self._release_held(g, used=0.0)

    def _reserve(self, g: _Gang, plan, deadline, trace_id) -> str | None:
        """Phase 1: acquire each planned chip token in sorted chip
        order. Returns None on success, else a reason string (partials
        stay recorded in ``g.held`` for the caller to release)."""
        for i, (chip, client) in enumerate(plan):
            with self._lock:
                sched = self._scheds.get(chip)
            if sched is None:
                return f"chip {chip} not attached"
            if i == 0:
                per = self._remaining(deadline)
                if self.preempt is not None and self.preempt.enabled:
                    # with preemption on, the anchor chip's wait is
                    # bounded by the reserve window too: the failure
                    # path must come back around so the blocked gang's
                    # grace clock can trigger _maybe_preempt_blockers
                    per = (self.reserve_window_s if per is None
                           else min(per, self.reserve_window_s))
            else:
                per = self.reserve_window_s
                rem = self._remaining(deadline)
                if rem is not None:
                    per = min(per, rem)
            try:
                quota = sched.acquire(client, timeout=per, trace_id=trace_id)
            except TimeoutError:
                return f"chip {chip} reserve timed out"
            except (KeyError, RuntimeError) as exc:
                return f"chip {chip}: {exc}"
            with self._lock:
                g.held[chip] = (client, quota)
            self._mark_reserving(g, chip)
        return None

    def _mark_reserving(self, g: _Gang, chip: str) -> None:
        # overlay the gang two-phase window on the member acquire the
        # chip's TokenScheduler just recorded as a plain grant
        if self._ledger is not None:
            self._ledger.mark_reserving(
                chip, g.namespace or "default", g.tpu_class,
                gang=g.gang_id, now=self._clock())

    def _mark_committed(self, held) -> None:
        if self._ledger is not None:
            now = self._clock()
            for chip in held:
                self._ledger.commit(chip, now=now)

    def _backoff_sleep(self, attempt: int, deadline: float | None) -> None:
        delay = min(self.backoff_max_s,
                    self.backoff_base_s * (2 ** min(attempt, 10)))
        with self._lock:
            delay *= 0.5 + self._rng.random()     # jitter: 0.5x..1.5x
        rem = self._remaining(deadline)
        if rem is not None:
            delay = min(delay, rem)
        if delay > 0:
            time.sleep(delay)

    def _release_held(self, g: _Gang, used: float,
                      partial: bool = False) -> None:
        """Release whatever ``g.held`` records (full set or partial
        reservation) and return the gang to idle. Never called with
        ``self._lock`` held."""
        with self._lock:
            held = dict(g.held)
            was_partial = partial and bool(held)
        for chip in sorted(held):
            client, _quota = held[chip]
            with self._lock:
                sched = self._scheds.get(chip)
            if sched is None:
                continue
            try:
                sched.release(client, used)
            except (KeyError, RuntimeError):
                pass  # client/chip vanished mid-release (eviction)
        with self._lock:
            g.held = {}
            g.state = "idle"
            g.preempt_requested = False
            if was_partial:
                g.partial_releases += 1
            self._lock.notify_all()
        if was_partial:
            _GANG_PARTIAL.inc(g.gang_id)

    def release(self, gang_id: str, used_ms: float | None = None) -> None:
        """Release the gang's full token set. ``used_ms`` defaults to
        the hold duration on the coordinator clock × ``used_scale`` —
        the same usage charged on every member chip, mirroring that an
        SPMD step occupies the whole sub-mesh for its duration."""
        with self._lock:
            g = self._gang(gang_id)
            if g.state != "held":
                return
            hold_s = max(0.0, self._clock() - g.held_since)
        if used_ms is None:
            used_ms = hold_s * self.used_scale
        self._release_held(g, used=used_ms)
        _GANG_HOLD.observe(gang_id, value=hold_s)

    # -- gang-atomic preemption (..preempt) ---------------

    def preempted(self, gang_id: str) -> bool:
        """Has the preemption plane asked *gang_id* to yield its hold?
        The gang runner's program-boundary check — the gang-level
        analogue of ``TokenScheduler.preempted`` (auto-drive releases
        such a gang itself on the next step)."""
        with self._lock:
            g = self._gangs.get(gang_id)
            return bool(g is not None and g.preempt_requested)

    def _maybe_preempt_blockers(self, g: _Gang) -> bool:
        """A reserve attempt by *g* failed: if the policy says *g*'s
        class outranks a gang holding chips in *g*'s plan past grace,
        preempt that gang ATOMICALLY — one decision for the whole gang
        under ``self._lock``, then per-chip marks and directed grants
        issued in sorted chip order without the lock (the same total
        order and lock discipline as every other gang operation, so no
        hold-and-wait cycle and no partial-preemption window: the
        victim's members yield via their normal full-set release).
        Returns True when a victim fired now or is still draining a
        prior request overlapping *g*'s plan — the caller then retries
        without backoff so it is waiting when the victim yields."""
        policy = self.preempt
        if policy is None or not policy.enabled:
            return False
        now = self._clock()
        actions: list[tuple[str, str, str]] = []
        victims: list[str] = []
        draining = False
        with self._lock:
            waited_ms = max(0.0, now - g.reserve_started) * 1000.0
            plan = dict(self._reserve_plan(g.members))
            for b in self._gangs.values():
                if b.gang_id == g.gang_id or b.state != "held":
                    continue
                overlap = sorted(set(plan) & set(b.held))
                if not overlap:
                    continue
                if b.preempt_requested:
                    draining = True    # already asked; it is draining
                    continue
                held_ms = max(0.0, now - b.held_since) * 1000.0
                if not policy.should_preempt(g.tpu_class, b.tpu_class,
                                             waited_ms, held_ms):
                    continue
                b.preempt_requested = True
                b.preemptions += 1
                victims.append(b.gang_id)
                for chip in overlap:
                    actions.append((chip, b.held[chip][0], plan[chip]))
        for chip, holder_client, beneficiary in sorted(actions):
            with self._lock:
                sched = self._scheds.get(chip)
            if sched is None:
                continue
            mark = getattr(sched, "mark_preempted", None)
            if mark is not None:
                mark(holder_client)
            boost = getattr(sched, "add_boost", None)
            if boost is not None:
                boost(beneficiary)
        for victim in victims:
            policy.note_gang_preemption(victim, g.gang_id)
            log.debug("gang %s preempted for %s-class gang %s", victim,
                      g.tpu_class, g.gang_id)
        return bool(victims) or draining

    def _note_grant(self, gang_id: str, namespace: str, tpu_class: str,
                    wait_s: float, held: dict, trace_id: str) -> None:
        _GANG_GRANT_WAIT.observe(gang_id, namespace or "default",
                                 tpu_class or "best-effort",
                                 value=wait_s, exemplar=trace_id or None)
        if trace_id:
            tracer = get_tracer()
            end = tracer.now_ms()
            tracer.record("gang-grant", trace_id, end - wait_s * 1000.0, end,
                          gang=gang_id, chips=",".join(sorted(held)))

    # -- pause / resume (gang-atomic migration) -----------------------

    def pause(self, gang_id: str, timeout: float | None = None) -> bool:
        """Stop issuing grants to *gang_id* and wait for any in-flight
        grant to drain. Returns False (still paused) on timeout — the
        caller decides whether to proceed. Unknown gangs pause trivially
        (the move may precede the first bind publication)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            g = self._gangs.get(gang_id)
            if g is None:
                return True
            g.paused = True
            self._lock.notify_all()
            while g.state != "idle":
                if not self._lock.wait(self._remaining(deadline)):
                    _GANG_PAUSED.set(gang_id, value=1.0)
                    return False
            chips = [c for c, _cl in self._reserve_plan(g.members)]
        _GANG_PAUSED.set(gang_id, value=1.0)
        if self._ledger is not None:
            now = self._clock()
            for chip in chips:
                self._ledger.pause(chip, now=now)
        return True

    def resume(self, gang_id: str) -> None:
        with self._lock:
            g = self._gangs.get(gang_id)
            chips = ([c for c, _cl in self._reserve_plan(g.members)]
                     if g is not None else [])
            if g is not None:
                g.paused = False
                self._lock.notify_all()
        _GANG_PAUSED.set(gang_id, value=0.0)
        if self._ledger is not None:
            now = self._clock()
            for chip in chips:
                self._ledger.unpause(chip, now=now)

    # -- uniform effective shares (elastic plane) ---------------------

    def set_effective_gang(self, gang_id: str, request: float,
                           limit: float) -> bool:
        """Apply one effective (request, limit) to every member chip's
        client — all or nothing: on the first member refusing (a native
        core without ``ts_set_effective``, a client gone) the members
        already adjusted go back to their base shares and False is
        returned."""
        with self._lock:
            g = self._gangs.get(gang_id)
            if g is None:
                return False
            members = list(g.members)
        applied: list[tuple[str, str]] = []
        for chip, client in members:
            with self._lock:
                sched = self._scheds.get(chip)
            ok = False
            if sched is not None:
                try:
                    ok = sched.set_effective(client, request, limit)
                except KeyError:
                    ok = False
            if not ok:
                self._restore(applied)
                return False
            applied.append((chip, client))
        return True

    def restore_base(self, gang_id: str) -> None:
        """Return every member chip's client to its registered base share
        (the revocation path)."""
        with self._lock:
            g = self._gangs.get(gang_id)
            if g is None:
                return
            members = list(g.members)
        self._restore(members)

    def _restore(self, members) -> None:
        for chip, client in members:
            with self._lock:
                sched = self._scheds.get(chip)
            if sched is None:
                continue
            base = sched.shares().get(client)
            if base is not None:
                try:
                    sched.set_effective(client, *base)
                except KeyError:
                    pass

    # -- non-blocking auto-drive (chaos virtual time) -----------------

    def step(self, now: float | None = None) -> None:
        """Advance every gang's grant cycle one notch without blocking
        — reserve via try-acquire, commit when complete, release after
        ``auto_hold_s``, back off on an expired reserve window. Only
        active when ``auto_drive`` is set (chaos orchestrator)."""
        if not self.auto_drive:
            return
        now = self._clock() if now is None else now
        with self._lock:
            gangs = list(self._gangs.values())
        for g in gangs:
            self._step_gang(g, now)

    def _step_gang(self, g: _Gang, now: float) -> None:
        with self._lock:
            if g.paused:
                state = "paused" if g.state == "idle" else g.state
            else:
                state = g.state
            if state == "idle" and now < g.backoff_until:
                return
            if state == "idle":
                g.state = state = "reserving"
                g.reserve_started = now
            plan = self._reserve_plan(g.members)
            held = dict(g.held)
        if state == "paused":
            return
        if state == "held":
            # a preempt-requested hold yields at the next step — the
            # virtual-time program boundary (usage charged for the time
            # actually held; the remaining quantum is forfeited)
            if (now - g.held_since >= self.auto_hold_s or g.paused
                    or g.preempt_requested):
                self.release(g.gang_id)
            return
        # reserving: try-acquire every missing chip token this tick
        complete = True
        for chip, client in plan:
            if chip in held:
                continue
            with self._lock:
                sched = self._scheds.get(chip)
            if sched is None:
                complete = False
                continue
            try:
                quota = sched.acquire(client, timeout=0)
            except (TimeoutError, KeyError, RuntimeError):
                complete = False
                continue
            with self._lock:
                g.held[chip] = (client, quota)
                held[chip] = (client, quota)
            self._mark_reserving(g, chip)
        if complete and len(held) == len(plan):
            with self._lock:
                raced_pause = g.paused
                if not raced_pause:
                    g.state = "held"
                    g.held_since = now
                    g.grants += 1
                    g.attempts = 0
                    g.waits.append(max(0.0, now - g.reserve_started))
            if raced_pause:
                self._release_held(g, used=0.0)
            else:
                self._mark_committed(held)
            return
        if now - g.reserve_started > self.reserve_window_s:
            with self._lock:
                g.attempts += 1
                attempt = g.attempts
                delay = min(self.backoff_max_s,
                            self.backoff_base_s * (2 ** min(attempt, 10)))
                delay *= 0.5 + self._rng.random()
            self._release_held(g, used=0.0, partial=True)
            self._maybe_preempt_blockers(g)
            with self._lock:
                g.backoff_until = now + delay

    # -- introspection ------------------------------------------------

    def grant_states(self, now: float | None = None) -> list[dict]:
        """Per-gang grant state for the chaos invariant oracle —
        ``members`` is the distinct-chip reserve plan (the grant unit),
        comparable as a plain set against ``held``."""
        now = self._clock() if now is None else now
        with self._lock:
            return [{
                "gang": g.gang_id,
                "state": g.state,
                "paused": g.paused,
                "members": [c for c, _cl in self._reserve_plan(g.members)],
                "held": sorted(g.held),
                "reserve_age_s": (max(0.0, now - g.reserve_started)
                                  if g.state == "reserving" else 0.0),
            } for g in self._gangs.values()]

    def snapshot(self) -> dict:
        """Operator view (``GET /gangs``, ``topcli --gangs``)."""
        with self._lock:
            gangs = {}
            for g in self._gangs.values():
                waits = list(g.waits)
                gangs[g.gang_id] = {
                    "namespace": g.namespace,
                    "tpu_class": g.tpu_class,
                    "state": "paused" if g.paused else g.state,
                    "members": [f"{c}:{cl}" for c, cl in g.members],
                    "held": sorted(g.held),
                    "grants": g.grants,
                    "partial_releases": g.partial_releases,
                    "preemptions": g.preemptions,
                    "preempt_requested": g.preempt_requested,
                    "grant_wait_p50_ms": _percentile(waits, 0.50) * 1e3,
                    "grant_wait_p99_ms": _percentile(waits, 0.99) * 1e3,
                }
            return {
                "chips": sorted(self._scheds),
                "gangs": gangs,
                "reserve_window_s": self.reserve_window_s,
                "auto_drive": self.auto_drive,
            }
