"""Failure detection over heartbeat leases — the health state machine.

The port's copy of ``kubeshare_tpu/scheduler/healthwatch.py``.

The reference's scheduler trusts its Prometheus scrape forever: a node
that dies keeps its last-exported ``gpu_capacity`` and its bound pods
until an operator intervenes. This watchdog closes the loop
(doc/health.md): it reads lease freshness from the telemetry registry
(:meth:`~..telemetry.registry.TelemetryRegistry.leases` — ages are
computed on the *registry's* clock, so no cross-host clock comparison
ever happens) and drives each node through

::

    up ──(age > ttl)──> suspect ──(age > miss_threshold*ttl)──> dead
     ^                     │                                      │
     │ (fresh beat)        │                                      │ beat
     └─────────────────────┘                     quarantined <────┘
     └──(k beats AND quarantine_s elapsed)────────── │

- **suspect** is free: one late beat recovers it, nothing was evicted;
- **dead** is acted on: the node is vetoed out of scoring
  (:meth:`~.engine.SchedulerEngine.veto_health`) and its bound pods are
  evicted and requeued (:meth:`~.dispatcher.Dispatcher.evict_node`) —
  gangs re-plan whole;
- **quarantined** is the flap damper: a dead node that beats again is
  held out of scoring until it proves itself with ``recover_k``
  consecutive beats AND ``quarantine_s`` of wall time — a node
  bouncing every few seconds never gets pods back just to kill them.

The watch is *poll-driven*, not threaded: :meth:`poll` runs inside
``Dispatcher.step`` under the dispatcher lock, so every transition and
eviction is serialized with scheduling decisions and a fake clock
drives the whole machine deterministically in tests.

Nodes that never published a lease are **unmonitored** — a fleet
deployed without heartbeaters keeps the pre-health-plane behavior
(capacity-reported health only).
"""

from __future__ import annotations

import time

from .. import constants as C
from ..obs import metrics as obs_metrics
from ..utils.logger import get_logger

log = get_logger("healthwatch")

UP, SUSPECT, DEAD, QUARANTINED = "up", "suspect", "dead", "quarantined"

_OBS = obs_metrics.default_registry()
_DETECT = _OBS.histogram(
    "kubeshare_health_detection_latency_seconds",
    "Node silence -> marked dead: lease age at the dead transition.",
    buckets=(1.0, 2.5, 5.0, 10.0, 15.0, 30.0, 60.0, 120.0, 300.0))
_TRANSITIONS = _OBS.counter(
    "kubeshare_health_transitions_total",
    "Health state-machine transitions by target state.",
    labels=("state",))


class NodeState:
    __slots__ = ("state", "last_epoch", "ok_streak", "last_transition")

    def __init__(self, now: float, epoch: int):
        self.state = UP
        self.last_epoch = epoch
        self.ok_streak = 0
        self.last_transition = now

    def to_dict(self, now: float, age_s: float) -> dict:
        return {"state": self.state, "lease_age_s": round(age_s, 3),
                "epoch": self.last_epoch,
                "since_s": round(max(0.0, now - self.last_transition), 3)}


class HealthWatch:
    """Lease-driven liveness for the fleet; one per dispatcher."""

    def __init__(self, registry, *, ttl_s: float = C.LEASE_TTL_S,
                 miss_threshold: int = C.HEALTH_MISS_THRESHOLD,
                 recover_k: int = C.HEALTH_RECOVER_K,
                 quarantine_s: float = C.HEALTH_QUARANTINE_S,
                 poll_period_s: float | None = None,
                 migrate_fn=None, clock=time.time):
        self.registry = registry
        #: snapshot-default timestamp source — injectable so replay and
        #: sims never read the wall clock on the decision path
        self._clock = clock
        self.ttl_s = float(ttl_s)
        self.miss_threshold = int(miss_threshold)
        self.recover_k = int(recover_k)
        self.quarantine_s = float(quarantine_s)
        # lease reads are an HTTP round trip against a remote registry —
        # once per TTL/2 bounds detection lag at half a beat period
        # without a registry GET on every scheduling tick
        self.poll_period_s = (float(poll_period_s)
                              if poll_period_s is not None
                              else self.ttl_s / 2.0)
        #: optional hook ``(pod, plan) -> bool``: attempt to live-migrate
        #: a resumable pod's proxy session to ``plan["node"]`` before the
        #: cold requeue (resilience/migrate.py); False/raise = fall back
        self.migrate_fn = migrate_fn
        self.nodes: dict[str, NodeState] = {}
        self._last_ages: dict[str, float] = {}
        self._next_poll = 0.0
        self.evicted_total = 0
        #: decision recorder borrowed from the dispatcher each poll;
        #: transitions are replay inputs (doc/replay.md)
        self._decisions = None

    # -- lease reading -----------------------------------------------------

    def _read_leases(self) -> dict[str, dict]:
        """{node: {"epoch", "ttl_s", "age_s"}} from either registry
        flavor (in-process returns the flat map; the HTTP client wraps
        it with the server clock)."""
        raw = self.registry.leases()
        if isinstance(raw, dict) and isinstance(raw.get("leases"), dict) \
                and "now" in raw:
            return raw["leases"]
        return raw

    # -- the poll ----------------------------------------------------------

    def due(self, now: float) -> bool:
        """Would :meth:`poll` actually run at *now*? The dispatcher's
        phase bracket gates on this so a cadence no-op never laps time
        into the ``healthwatch`` phase (phantom coverage), and the
        sharded plane's event pump uses it to skip idle cycles."""
        return now >= self._next_poll

    def seconds_until_due(self, now: float) -> float:
        """Seconds until :meth:`poll` would next do real work (0.0 when
        already due) — the public cadence surface the dispatcher's
        next-event delay and the sharded pump schedule against, instead
        of reaching into the poll timer directly."""
        return max(0.0, self._next_poll - now)

    def poll(self, now: float, dispatcher=None) -> list[str]:
        """Advance every node's state machine; returns nodes whose state
        changed. Runs under the dispatcher lock (its step calls this) —
        evictions it triggers are serialized with scheduling."""
        if now < self._next_poll:
            return []
        self._next_poll = now + self.poll_period_s
        self._decisions = getattr(dispatcher, "decisions", None)
        try:
            leases = self._read_leases()
        except Exception as e:
            # an unreachable registry is NOT node death — with no fresh
            # ages there is nothing safe to conclude; hold every state
            log.warning("lease read failed, health frozen: %s", e)
            return []
        changed: list[str] = []
        for node, lease in leases.items():
            if node.startswith("leader:"):
                # leadership leases (doc/ha.md) live in the same table
                # but are not nodes — expiry there is the standby's
                # takeover signal, not a death to evict over
                continue
            ttl = float(lease.get("ttl_s", self.ttl_s)) or self.ttl_s
            age = float(lease.get("age_s", 0.0))
            epoch = int(lease.get("epoch", 0))
            self._last_ages[node] = age
            st = self.nodes.get(node)
            if st is None:
                st = self.nodes[node] = NodeState(now, epoch)
                log.info("monitoring %s (epoch %d)", node, epoch)
            fresh = age <= ttl
            beat = epoch > st.last_epoch
            st.last_epoch = max(st.last_epoch, epoch)
            if st.state == UP and not fresh:
                # falls straight through to the suspect checks: a node
                # already past miss_threshold*ttl when first noticed is
                # dead THIS poll, not one poll period later
                self._transition(st, node, SUSPECT, now, changed)
            if st.state == SUSPECT:
                if fresh:
                    self._transition(st, node, UP, now, changed)
                elif age > self.miss_threshold * ttl:
                    _DETECT.observe(value=age)
                    self._transition(st, node, DEAD, now, changed)
                    self._on_dead(node, now, dispatcher)
            elif st.state == DEAD and fresh and beat:
                # it's back — but a fresh corpse gets no pods until it
                # proves itself (flap dampening)
                st.ok_streak = 0
                self._transition(st, node, QUARANTINED, now, changed)
            elif st.state == QUARANTINED:
                if not fresh:
                    st.ok_streak = 0
                    self._transition(st, node, DEAD, now, changed)
                else:
                    if beat:
                        st.ok_streak += 1
                    if (st.ok_streak >= self.recover_k
                            and now - st.last_transition
                            >= self.quarantine_s):
                        self._transition(st, node, UP, now, changed)
                        self._on_recovered(node, dispatcher)
        # leases dropped (decommission) stop being monitored entirely
        for gone in set(self.nodes) - set(leases):
            del self.nodes[gone]
            self._last_ages.pop(gone, None)
            log.info("%s dropped its lease; no longer monitored", gone)
        return changed

    def _transition(self, st: NodeState, node: str, state: str, now: float,
                    changed: list[str]) -> None:
        log.info("%s: %s -> %s", node, st.state, state)
        if self._decisions is not None:
            self._decisions.record("node-health", now, node=node,
                                   state=state, prev=st.state)
        st.state = state
        st.last_transition = now
        _TRANSITIONS.inc(state)
        changed.append(node)

    # -- actions -----------------------------------------------------------

    def _on_dead(self, node: str, now: float, dispatcher) -> None:
        if dispatcher is None:
            return
        dispatcher.engine.veto_health(node, True)
        evicted = dispatcher.evict_node(node, now,
                                        migrate_fn=self.migrate_fn)
        self.evicted_total += len(evicted)

    def _on_recovered(self, node: str, dispatcher) -> None:
        if dispatcher is not None:
            dispatcher.engine.veto_health(node, False)

    # -- views -------------------------------------------------------------

    def snapshot(self, now: float | None = None) -> dict:
        """Per-node health for /health and ``kubeshare-top --health``."""
        if now is None:
            now = self._clock()
        return {node: st.to_dict(now, self._last_ages.get(node, 0.0))
                for node, st in sorted(self.nodes.items())}
