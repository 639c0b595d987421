"""Warm-standby scheduler — takeover without a cold start.

A standby :class:`~..scheduler.service.SchedulerService` keeps its
engine warm while a primary leads (doc/ha.md): on a cadence it re-syncs
capacity from the registry and replays the bound-pod records through
``Dispatcher.replay_bound`` (``engine.resync_bound`` is idempotent, so
re-warming never double-books). When the ``leader:scheduler`` lease
expires, the standby acquires it at the next epoch and starts serving:
every bind it publishes is fenced by that epoch, so a partitioned old
dispatcher that comes back finds its writes refused 409 and freezes —
the split-brain never reaches the registry. The decision recorder
stamps a ``leadership`` entry and the flight recorder dumps a
``leadership-transition`` black box at every takeover, fencing epochs
attached, so the replay plane can diff across the transition.

The port's copy of ``kubeshare_tpu/ha/standby.py``. Its replay
diverges on purpose where the JAX standby takes over a state its leader
never had (``Dispatcher.replay_bound(standby=True)``): it drops the
bound pods whose records the leader has withdrawn since, a replayed pod
keeps the model it was bound to (as in every replay of the port's
dispatcher), and the members of a gang short of its
min_available (reserved at the Permit barrier when the leader died) are
left out while standing by and parked at the barrier at takeover
(``park_replayed``), where the JAX standby books them as a torn gang. It
drives a plain :class:`~..scheduler.dispatcher.Dispatcher` and a
:class:`~..scheduler.shard.ShardedDispatcher` alike: the sharded plane's
fleet engine takes the capacity sync, and its replay books each record
on the shard that owns the record's node.
"""

from __future__ import annotations

import time

from ..obs.flight import default_recorder
from ..scheduler.dispatcher import short_gangs
from ..utils.logger import get_logger
from .leadership import LeadershipManager

log = get_logger("ha.standby")

DOMAIN = "scheduler"


class WarmStandby:
    """Drive one dispatcher's leadership over the ``leader:scheduler``
    lease.

    The *primary* runs this too — it simply acquires first and renews.
    ``resync_source`` (optional) is a callable yielding
    ``(namespace, name, labels, annotations, node, uid)`` tuples of
    proxied session state to feed through ``dispatcher.resync`` at
    takeover — the bridge's informer-replay analog for state the
    registry does not hold.

    Drive :meth:`step` on a cadence well inside ``ttl_s`` — the chaos
    runner ticks it on the virtual clock; a live service threads it
    through the dispatcher loop.
    """

    def __init__(self, dispatcher, registry, holder: str,
                 ttl_s: float = 5.0, clock=time.time,
                 resync_period_s: float | None = None,
                 resync_source=None, decisions=None):
        self.dispatcher = dispatcher
        self.registry = registry
        self.lead = LeadershipManager(registry, DOMAIN, holder,
                                      ttl_s=ttl_s, clock=clock)
        self._clock = clock
        self.resync_period_s = (float(resync_period_s)
                                if resync_period_s is not None
                                else float(ttl_s))
        self.resync_source = resync_source
        self.decisions = (decisions if decisions is not None
                          else getattr(dispatcher, "decisions", None))
        self._next_resync = 0.0
        self.takeover_count = 0
        self.last_takeover_ts = 0.0
        # a standby must not place pods while someone else leads: fence
        # at epoch 0 (below any real leader) and freeze until takeover
        dispatcher.attach_fencing(lambda: self.lead.epoch)
        dispatcher.freeze("standby: not the leader")

    # -- the loop ----------------------------------------------------------

    def step(self, now: float | None = None) -> bool:
        """One HA tick: renew/contest the lease, then act on any
        transition. Returns post-tick leadership."""
        if now is None:
            now = self._clock()
        was = self.lead.is_leader
        leading = self.lead.step(now)
        if leading and not was:
            self._takeover(now)
        elif was and not leading:
            self._deposed()
        elif not leading:
            self._keep_warm(now)
        return leading

    def _keep_warm(self, now: float) -> None:
        """Standby cadence: re-sync capacity + bound pods so takeover
        is a lease write away, not a cold replay."""
        if now < self._next_resync:
            return
        self._next_resync = now + self.resync_period_s
        try:
            from ..telemetry.aggregator import sync_engine_from_registry
            with self.dispatcher.lock:
                sync_engine_from_registry(self.dispatcher.engine,
                                          self.registry)
            self._replay(takeover=False)
        except Exception as e:
            log.warning("warm resync failed (retried next period): %s", e)

    def _replay(self, takeover: bool) -> None:
        """Book the leader's records; a gang short of its min_available
        is parked at takeover and left out before."""
        records = self.registry.pods()
        short = short_gangs(records)
        self.dispatcher.replay_bound(
            records={k: r for k, r in records.items() if k not in short},
            standby=True)
        if takeover and short:
            self.dispatcher.park_replayed({k: records[k] for k in short})

    def _takeover(self, now: float) -> None:
        epoch = self.lead.epoch
        log.warning("taking over leader:%s at epoch %d", DOMAIN, epoch)
        # final reconstruction under the NEW epoch: capacity, then bound
        # pods, then proxied session state — the service startup order
        try:
            from ..telemetry.aggregator import sync_engine_from_registry
            with self.dispatcher.lock:
                sync_engine_from_registry(self.dispatcher.engine,
                                          self.registry)
            self._replay(takeover=True)
            if self.resync_source is not None:
                for (ns, name, labels, annotations, node,
                     uid) in self.resync_source():
                    self.dispatcher.resync(ns, name, labels, annotations,
                                           node, uid=uid)
        except Exception as e:
            log.error("takeover reconstruction incomplete: %s", e)
        self.takeover_count += 1
        self.last_takeover_ts = now
        self.dispatcher.unfreeze()
        if self.decisions is not None:
            # the replay plane diffs across this marker (doc/replay.md)
            self.decisions.record("leadership", now, domain=DOMAIN,
                                  holder=self.lead.holder, epoch=epoch,
                                  takeovers=self.takeover_count)
        rec = default_recorder()
        rec.note("ha", "takeover", domain=DOMAIN, holder=self.lead.holder,
                 epoch=epoch)
        rec.trigger("leadership-transition", domain=DOMAIN,
                    holder=self.lead.holder, epoch=epoch,
                    prev_epoch=epoch - 1)

    def _deposed(self) -> None:
        """The lease moved past us: freeze immediately rather than wait
        for a fenced 409 — both paths end in the same frozen state
        (the partition-freeze invariant, doc/chaos.md)."""
        log.warning("deposed from leader:%s; freezing dispatcher", DOMAIN)
        self.dispatcher.freeze(
            f"deposed: epoch {self.lead.epoch} leads now")

    # -- views -------------------------------------------------------------

    def state(self) -> dict:
        """``GET /ha`` body on the scheduler service."""
        st = self.lead.state()
        st.update({
            "attached": True,
            "role": "leader" if self.lead.is_leader else "standby",
            "frozen": bool(getattr(self.dispatcher, "frozen", False)),
            "takeovers": self.takeover_count,
            "last_takeover_ts": self.last_takeover_ts,
            "fence_epoch": self.lead.epoch,
        })
        return st
