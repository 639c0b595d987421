"""Per-tenant SLOs: objectives, rolling error budgets, burn-rate alerts
— the port's copy of ``kubeshare_tpu/obs/slo.py``.

Tenants declare objectives as a comma-separated list in a tiny grammar
(the ``sharedtpu/slo`` label of the JAX package, ``FrontDoor.
register_tenant(slo_spec=...)`` in the port):

- ``<indicator>-p<QQ><=<bound><unit>`` — a latency objective: quantile
  ``QQ`` of ``indicator`` must stay at or under ``bound``. Units:
  ``ms``, ``s`` (default ``s``). Example: ``grant-wait-p99<=50ms``.
  A sample is *bad* when its value exceeds the bound; the error budget
  is ``1 - QQ/100`` (p99 → 1% of samples may exceed the bound).
- ``<indicator>>=<percent>`` — an availability objective: at least
  ``percent`` of events must be good. Example: ``availability>=99.9``
  (error budget 0.1%). Callers record good/bad outcomes directly.

Indicators are free-form names (``grant-wait``, ``serve``,
``serve-availability``); instrumentation sites record samples against
them and the evaluator only keeps state for (tenant, indicator) pairs
with a declared objective — undeclared samples cost one dict miss.

Alerting is multi-window burn rate: the burn rate is ``error_rate /
error_budget`` measured over a *fast* and a *slow* rolling window; an
alert fires when **both** exceed the threshold (the slow window proves
it is sustained, the fast window makes detection quick and clears the
alert promptly when the burn stops). All timestamps are caller-supplied
(``now=``), so the evaluator is deterministic on a virtual clock.
"""

from __future__ import annotations

import re
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .metrics import default_registry

# objective grammar: name[-pQQ] (<=|>=) number [unit]
_OBJ_RE = re.compile(
    r"^([a-z][a-z0-9_-]*?)"
    r"(?:-p(\d{1,2}(?:\.\d+)?))?"
    r"(<=|>=)"
    r"([0-9]+(?:\.[0-9]+)?)"
    r"(ms|s|%)?$")

DEFAULT_FAST_WINDOW_S = 60.0
DEFAULT_SLOW_WINDOW_S = 600.0
DEFAULT_BURN_THRESHOLD = 14.4      # SRE workbook: 2% budget in 1h
DEFAULT_MIN_SAMPLES = 5


class SloError(ValueError):
    """Malformed ``sharedtpu/slo`` label value."""


@dataclass(frozen=True)
class SloSpec:
    """One parsed objective."""

    indicator: str          # e.g. "grant-wait"
    raw: str                # original objective text, the stable key
    quantile: Optional[float] = None   # 0.99 for p99 latency objectives
    bound_s: Optional[float] = None    # latency bound in seconds
    target: float = 0.0                # fraction of samples that must be good

    @property
    def budget(self) -> float:
        """Error budget as a fraction (p99 → 0.01; 99.9% → 0.001)."""
        return max(1.0 - self.target, 1e-9)

    def is_bad(self, value_s: float) -> bool:
        """Latency objectives: does this sample burn budget?"""
        return self.bound_s is not None and value_s > self.bound_s

    def to_dict(self) -> dict:
        return {"indicator": self.indicator, "raw": self.raw,
                "quantile": self.quantile, "bound_s": self.bound_s,
                "target": self.target}


def parse_slo(label_value: str) -> List[SloSpec]:
    """Parse a ``sharedtpu/slo`` label value into specs.

    Raises :class:`SloError` on empty/duplicate/ungrammatical
    objectives — label validation happens at pod-parse time, mirroring
    the other ``sharedtpu/`` labels.
    """
    specs: List[SloSpec] = []
    seen = set()
    for part in str(label_value).split(","):
        raw = part.strip()
        if not raw:
            raise SloError("empty objective in %r" % label_value)
        m = _OBJ_RE.match(raw)
        if not m:
            raise SloError("bad objective %r (want e.g. "
                           "grant-wait-p99<=50ms or availability>=99.9)"
                           % raw)
        indicator, q, op, num, unit = m.groups()
        value = float(num)
        if q is not None:
            # latency shape: indicator-pQQ<=bound[ms|s]
            if op != "<=":
                raise SloError("latency objective %r must use <=" % raw)
            if unit == "%":
                raise SloError("latency objective %r cannot use %%" % raw)
            quantile = float(q) / 100.0
            if not 0.0 < quantile < 1.0:
                raise SloError("quantile out of range in %r" % raw)
            bound_s = value / 1000.0 if unit == "ms" else value
            if bound_s <= 0:
                raise SloError("non-positive bound in %r" % raw)
            spec = SloSpec(indicator=indicator, raw=raw, quantile=quantile,
                           bound_s=bound_s, target=quantile)
        else:
            # availability shape: indicator>=percent
            if op != ">=":
                raise SloError("availability objective %r must use >=" % raw)
            if unit not in (None, "%"):
                raise SloError("availability objective %r takes %% only"
                               % raw)
            if not 0.0 < value < 100.0:
                raise SloError("availability target out of range in %r"
                               % raw)
            spec = SloSpec(indicator=indicator, raw=raw,
                           target=value / 100.0)
        if spec.raw in seen:
            raise SloError("duplicate objective %r" % raw)
        seen.add(spec.raw)
        specs.append(spec)
    if not specs:
        raise SloError("empty slo label")
    return specs


@dataclass
class AlertEvent:
    """One alert transition — the typed event stream."""

    t: float
    tenant: str
    objective: str          # SloSpec.raw
    state: str              # "firing" | "resolved"
    burn_fast: float
    burn_slow: float
    trace_id: str = ""      # a recent budget-burning sample's trace

    def to_dict(self) -> dict:
        return {"t": round(self.t, 6), "tenant": self.tenant,
                "objective": self.objective, "state": self.state,
                "burn_fast": round(self.burn_fast, 3),
                "burn_slow": round(self.burn_slow, 3),
                "trace_id": self.trace_id}


class _ObjectiveState:
    """Rolling sample window + alert state for one (tenant, objective)."""

    __slots__ = ("spec", "samples", "firing", "last_bad_trace")

    def __init__(self, spec: SloSpec):
        self.spec = spec
        # (t, bad) events, pruned past the slow window on record/evaluate
        self.samples: deque = deque()
        self.firing = False
        self.last_bad_trace = ""

    def prune(self, now: float, slow_window_s: float) -> None:
        horizon = now - slow_window_s
        while self.samples and self.samples[0][0] < horizon:
            self.samples.popleft()

    def window_rates(self, now: float, fast_s: float,
                     slow_s: float) -> Tuple[float, float, int, int]:
        """(fast error rate, slow error rate, fast total, slow total)."""
        fast_total = fast_bad = slow_total = slow_bad = 0
        fast_horizon = now - fast_s
        for t, bad in self.samples:
            slow_total += 1
            slow_bad += bad
            if t >= fast_horizon:
                fast_total += 1
                fast_bad += bad
        fast_rate = fast_bad / fast_total if fast_total else 0.0
        slow_rate = slow_bad / slow_total if slow_total else 0.0
        return fast_rate, slow_rate, fast_total, slow_total


_REG = default_registry()
_BURN = _REG.gauge(
    "kubeshare_slo_burn_rate",
    "Error-budget burn rate (error rate / budget) per rolling window.",
    labels=("tenant", "objective", "window"))
_BUDGET = _REG.gauge(
    "kubeshare_slo_error_budget_remaining",
    "Fraction of the error budget left over the slow window (0-1).",
    labels=("tenant", "objective"))
_SAMPLES = _REG.counter(
    "kubeshare_slo_samples_total",
    "SLO samples recorded, by verdict.",
    labels=("tenant", "objective", "verdict"))
_TRANSITIONS = _REG.counter(
    "kubeshare_slo_alert_transitions_total",
    "Alert state transitions (firing / resolved).",
    labels=("tenant", "objective", "state"))
_FIRING = _REG.gauge(
    "kubeshare_slo_alerts_firing",
    "1 while the burn-rate alert for this objective is firing.",
    labels=("tenant", "objective"))


class SloEvaluator:
    """Tracks declared objectives and drives burn-rate alerting.

    Deterministic by construction: every mutation takes an explicit
    ``now`` (defaulting to ``clock()``, itself injectable), no internal
    timers. ``evaluate(now)`` is idempotent for a given sample history
    and returns only *new* transitions.
    """

    def __init__(self,
                 fast_window_s: float = DEFAULT_FAST_WINDOW_S,
                 slow_window_s: float = DEFAULT_SLOW_WINDOW_S,
                 burn_threshold: float = DEFAULT_BURN_THRESHOLD,
                 min_samples: int = DEFAULT_MIN_SAMPLES,
                 clock: Optional[Callable[[], float]] = None,
                 max_events: int = 1000):
        if fast_window_s <= 0 or slow_window_s < fast_window_s:
            raise ValueError("need 0 < fast_window_s <= slow_window_s")
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.burn_threshold = float(burn_threshold)
        self.min_samples = int(min_samples)
        self._clock = clock or time.time
        self._lock = threading.Lock()
        # (tenant, indicator) -> {objective raw -> _ObjectiveState}
        self._objectives: Dict[Tuple[str, str],
                               Dict[str, _ObjectiveState]] = {}
        self._events: deque = deque(maxlen=max_events)
        self._listeners: List[Callable[[AlertEvent], None]] = []

    # -- declaration ---------------------------------------------------------

    def declare(self, tenant: str, specs) -> None:
        """Register objectives for a tenant (idempotent; latest wins
        per objective). ``specs`` is a list of :class:`SloSpec` or a
        raw ``sharedtpu/slo`` label value."""
        if isinstance(specs, str):
            specs = parse_slo(specs)
        with self._lock:
            for spec in specs:
                states = self._objectives.setdefault(
                    (tenant, spec.indicator), {})
                if spec.raw not in states:
                    states[spec.raw] = _ObjectiveState(spec)

    def undeclare(self, tenant: str) -> None:
        with self._lock:
            for key in [k for k in self._objectives if k[0] == tenant]:
                del self._objectives[key]

    def tenants(self) -> List[str]:
        with self._lock:
            return sorted({t for t, _ in self._objectives})

    # -- recording -----------------------------------------------------------

    def record(self, tenant: str, indicator: str,
               value_s: Optional[float] = None,
               ok: Optional[bool] = None,
               now: Optional[float] = None,
               trace_id: str = "") -> None:
        """Record one sample against every matching objective.

        Latency objectives judge ``value_s`` against their bound;
        availability objectives take an explicit ``ok``. Samples for
        undeclared (tenant, indicator) pairs are dropped at the cost
        of one dict lookup.
        """
        with self._lock:
            states = self._objectives.get((tenant, indicator))
        if not states:
            return
        if now is None:
            now = self._clock()
        with self._lock:
            for state in states.values():
                spec = state.spec
                if spec.bound_s is not None:
                    if value_s is None:
                        continue
                    bad = spec.is_bad(value_s)
                elif ok is not None:
                    bad = not ok
                else:
                    continue
                state.samples.append((now, 1 if bad else 0))
                if bad and trace_id:
                    state.last_bad_trace = trace_id
                state.prune(now, self.slow_window_s)
                _SAMPLES.inc(tenant, spec.raw, "bad" if bad else "good")

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> List[AlertEvent]:
        """Re-derive burn rates; return new alert transitions."""
        if now is None:
            now = self._clock()
        transitions: List[AlertEvent] = []
        with self._lock:
            for (tenant, _ind), states in sorted(self._objectives.items()):
                for raw, state in sorted(states.items()):
                    spec = state.spec
                    state.prune(now, self.slow_window_s)
                    fast_rate, slow_rate, fast_n, _slow_n = \
                        state.window_rates(now, self.fast_window_s,
                                           self.slow_window_s)
                    burn_fast = fast_rate / spec.budget
                    burn_slow = slow_rate / spec.budget
                    _BURN.set(tenant, raw, "fast", value=burn_fast)
                    _BURN.set(tenant, raw, "slow", value=burn_slow)
                    _BUDGET.set(tenant, raw,
                                value=max(0.0, 1.0 - burn_slow))
                    should_fire = (burn_fast >= self.burn_threshold
                                   and burn_slow >= self.burn_threshold
                                   and fast_n >= self.min_samples)
                    # clear on the fast window alone: once the burn
                    # stops, the alert resolves at fast-window speed
                    should_clear = burn_fast < self.burn_threshold
                    event = None
                    if should_fire and not state.firing:
                        state.firing = True
                        event = AlertEvent(
                            t=now, tenant=tenant, objective=raw,
                            state="firing", burn_fast=burn_fast,
                            burn_slow=burn_slow,
                            trace_id=state.last_bad_trace)
                    elif state.firing and should_clear:
                        state.firing = False
                        event = AlertEvent(
                            t=now, tenant=tenant, objective=raw,
                            state="resolved", burn_fast=burn_fast,
                            burn_slow=burn_slow,
                            trace_id=state.last_bad_trace)
                    if event is not None:
                        transitions.append(event)
                        self._events.append(event)
                        _TRANSITIONS.inc(tenant, raw, event.state)
                    _FIRING.set(tenant, raw,
                                value=1.0 if state.firing else 0.0)
            listeners = list(self._listeners)
        for event in transitions:
            for fn in listeners:
                try:
                    fn(event)
                except Exception:
                    pass      # alerting must not break the control loop
        return transitions

    # -- listeners / introspection -------------------------------------------

    def add_listener(self, fn: Callable[[AlertEvent], None]) -> None:
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def events(self) -> List[AlertEvent]:
        with self._lock:
            return list(self._events)

    def firing(self) -> List[Tuple[str, str]]:
        """Currently-firing (tenant, objective) pairs."""
        with self._lock:
            return sorted(
                (tenant, raw)
                for (tenant, _i), states in self._objectives.items()
                for raw, state in states.items() if state.firing)

    def state(self, now: Optional[float] = None) -> dict:
        """Full snapshot: per tenant its objectives' burn rates and
        budgets, the alert events and the window settings."""
        if now is None:
            now = self._clock()
        out: Dict[str, list] = {}
        with self._lock:
            for (tenant, _ind), states in sorted(self._objectives.items()):
                for raw, state in sorted(states.items()):
                    spec = state.spec
                    fast_rate, slow_rate, fast_n, slow_n = \
                        state.window_rates(now, self.fast_window_s,
                                           self.slow_window_s)
                    out.setdefault(tenant, []).append({
                        "objective": raw,
                        "indicator": spec.indicator,
                        "target": spec.target,
                        "budget": spec.budget,
                        "burn_fast": round(fast_rate / spec.budget, 3),
                        "burn_slow": round(slow_rate / spec.budget, 3),
                        "budget_remaining": round(
                            max(0.0, 1.0 - slow_rate / spec.budget), 4),
                        "samples_fast": fast_n,
                        "samples_slow": slow_n,
                        "firing": state.firing,
                        "last_bad_trace": state.last_bad_trace,
                    })
            events = [e.to_dict() for e in self._events]
        return {"tenants": out, "events": events,
                "windows": {"fast_s": self.fast_window_s,
                            "slow_s": self.slow_window_s,
                            "burn_threshold": self.burn_threshold,
                            "min_samples": self.min_samples}}


_DEFAULT: Optional[SloEvaluator] = None
_default_lock = threading.Lock()


def default_evaluator() -> SloEvaluator:
    """Lazy process-wide evaluator instrumentation sites record into."""
    global _DEFAULT
    with _default_lock:
        if _DEFAULT is None:
            _DEFAULT = SloEvaluator()
        return _DEFAULT


def set_default_evaluator(ev: Optional[SloEvaluator]) -> None:
    """Install a configured evaluator (tests) as the process default."""
    global _DEFAULT
    with _default_lock:
        _DEFAULT = ev
