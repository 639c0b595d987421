"""Class-priority preemption policy — counterpart of
``kubeshare_tpu/preempt/policy.py``.

The policy decides and counts; it owns no scheduler state and takes no
scheduler lock. The :class:`~kubeshare_tpu_torch.isolation.tokensched.
TokenScheduler` consults :meth:`PreemptionPolicy.should_preempt` under its
own condition each time a waiter re-evaluates, and reports outcomes
through the ``note_*`` hooks, which feed :meth:`snapshot` and these
families of the process registry:

- ``kubeshare_preempt_total`` — preemptions fired, by chip and the class
  pair (the waiter's class outranked the holder's);
- ``kubeshare_preempt_yield_seconds`` — mark-to-yield latency: how long a
  preempted holder kept the device before it released or sliced at a
  program boundary;
- ``kubeshare_preempt_reclaimed_ms_total`` — quantum milliseconds the
  preempted holder forfeited (granted quota minus charged usage);
- ``kubeshare_preempt_boost_grants_total`` — grants delivered out of FIFO
  order (the beneficiary, then the anti-starvation re-grant);
- ``kubeshare_preempt_gang_total`` — gang-atomic preemptions routed
  through the :class:`~kubeshare_tpu_torch.gang.coordinator.
  GangTokenCoordinator` two-phase protocol.

Anti-starvation: every preemption queues the *holder* directly behind the
beneficiary in the scheduler's directed-grant queue, so a best-effort
tenant that lost its quantum regains the device after exactly one
latency grant (``credits_repaid`` in the snapshot). The JAX policy's
decision-recorder hook (the replay plane) is not ported.
"""

from __future__ import annotations

import threading

from ..obs import metrics as obs_metrics

#: class -> priority; higher preempts lower. Unknown or empty classes rank
#: with best-effort, the default class everywhere else.
CLASS_PRIORITY = {"latency": 10, "best-effort": 0}

#: defaults (milliseconds): how long a higher-class request tolerates
#: waiting before the holder is marked, and the least tenure a holder gets
#: before it can be preempted (no thrashing of fresh grants)
DEFAULT_GRACE_MS = 5.0
DEFAULT_MIN_HOLD_MS = 2.0

_OBS = obs_metrics.default_registry()
_PREEMPTIONS = _OBS.counter(
    "kubeshare_preempt_total",
    "Preemptions fired: a higher-class waiter marked the holder "
    "preempted after grace expired.",
    labels=("chip", "waiter_class", "holder_class"))
_YIELD = _OBS.histogram(
    "kubeshare_preempt_yield_seconds",
    "Seconds between a holder being marked preempted and it yielding "
    "the chip (release or program-boundary slice).",
    labels=("chip",))
_RECLAIMED = _OBS.counter(
    "kubeshare_preempt_reclaimed_ms_total",
    "Forfeited quantum milliseconds reclaimed from preempted holders "
    "(granted quota minus charged usage at yield).",
    labels=("chip",))
_BOOSTS = _OBS.counter(
    "kubeshare_preempt_boost_grants_total",
    "Grants delivered out of FIFO order by the preemption plane "
    "(beneficiaries and anti-starvation re-grants).",
    labels=("chip", "kind"))
_GANG = _OBS.counter(
    "kubeshare_preempt_gang_total",
    "Gang-atomic preemptions: a higher-class gang preempted a lower-"
    "class gang across all member chips.",
    labels=("gang", "beneficiary"))


def class_priority(tpu_class: str) -> int:
    """Priority of ``tpu_class``; unknown or empty ranks best-effort."""
    return CLASS_PRIORITY.get(tpu_class or "best-effort", 0)


class PreemptionPolicy:
    """Pure decision core and stats, thread-safe. Decisions read no clock:
    callers pass elapsed milliseconds measured on their own."""

    def __init__(self, grace_ms: float = DEFAULT_GRACE_MS,
                 min_hold_ms: float = DEFAULT_MIN_HOLD_MS,
                 enabled: bool = True):
        self.grace_ms = float(grace_ms)
        self.min_hold_ms = float(min_hold_ms)
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        #: optional decision recorder: token and gang preemptions land in
        #: its replayable decision trace
        self.decisions = None
        self._stats = {
            "preemptions": 0,
            "gang_preemptions": 0,
            "boost_grants": 0,
            "credits_repaid": 0,
            "yields": 0,
            "reclaimed_ms": 0.0,
            "by_tenant": {},        # preempted tenant -> count
        }

    # -- decision (called under the scheduler's lock; must not block) --------

    def should_preempt(self, waiter_class: str, holder_class: str,
                       waited_ms: float, held_ms: float) -> bool:
        """True when the waiter outranks the holder, has waited past
        grace, and the holder has had its minimum tenure."""
        if not self.enabled:
            return False
        if class_priority(waiter_class) <= class_priority(holder_class):
            return False
        return waited_ms >= self.grace_ms and held_ms >= self.min_hold_ms

    # -- outcome hooks -------------------------------------------------------

    def note_preemption(self, chip: str, holder: str, waiter_class: str,
                        holder_class: str) -> None:
        with self._lock:
            self._stats["preemptions"] += 1
            by = self._stats["by_tenant"]
            by[holder] = by.get(holder, 0) + 1
        _PREEMPTIONS.inc(chip, waiter_class or "best-effort",
                         holder_class or "best-effort")
        if self.decisions is not None:
            self.decisions.record("token-preempt", chip=chip,
                                  holder=holder,
                                  waiter_class=waiter_class,
                                  holder_class=holder_class)

    def note_yield(self, chip: str, yield_s: float,
                   reclaimed_ms: float) -> None:
        with self._lock:
            self._stats["yields"] += 1
            self._stats["reclaimed_ms"] += max(0.0, reclaimed_ms)
        _YIELD.observe(chip, value=max(0.0, yield_s))
        if reclaimed_ms > 0.0:
            _RECLAIMED.inc(chip, amount=reclaimed_ms)

    def note_boost_grant(self, chip: str, credit: bool = False) -> None:
        kind = "credit" if credit else "beneficiary"
        with self._lock:
            self._stats["boost_grants"] += 1
            if credit:
                self._stats["credits_repaid"] += 1
        _BOOSTS.inc(chip, kind)

    def note_gang_preemption(self, gang: str, beneficiary: str) -> None:
        with self._lock:
            self._stats["gang_preemptions"] += 1
        _GANG.inc(gang, beneficiary)
        if self.decisions is not None:
            self.decisions.record("gang-preempt", gang=gang,
                                  beneficiary=beneficiary)

    # -- views ---------------------------------------------------------------

    def snapshot(self) -> dict:
        """The policy and its counts as JSON (the ``preempt_state`` op)."""
        with self._lock:
            stats = dict(self._stats)
            stats["by_tenant"] = dict(stats["by_tenant"])
            stats["reclaimed_ms"] = round(stats["reclaimed_ms"], 3)
        return {
            "enabled": self.enabled,
            "grace_ms": self.grace_ms,
            "min_hold_ms": self.min_hold_ms,
            "class_priority": dict(CLASS_PRIORITY),
            "stats": stats,
        }
