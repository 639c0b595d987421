"""Leadership over a registry lease — the epoch-fenced election loop.

The port's copy of ``kubeshare_tpu/ha/leadership.py``.

There is no consensus protocol here and none is needed: the registry's
leases table is the single arbiter (doc/ha.md). A candidate holds the
``leader:<domain>`` lease by renewing it inside its TTL; a standby
watches the same lease and, the moment it expires, acquires it at
``epoch + 1``. The epoch is the *incarnation* — stable across renewals,
strictly monotonic across takeovers — and doubles as the fencing token
every mutating write of the leader carries, so a deposed leader that
kept running (a partition, a GC pause) has its writes refused 409 the
same way a zombie heartbeat is (``telemetry/heartbeat.py``).

The step loop mirrors the :class:`~..telemetry.heartbeat.Heartbeater`
idiom: poll-driven, virtual-clock friendly, and a 409 refusal jumps the
candidate's view of the epoch forward so the *next* expiry is contested
at a winning number.
"""

from __future__ import annotations

import time

from ..obs import metrics as obs_metrics
from ..utils.logger import get_logger

log = get_logger("ha.leadership")

_OBS = obs_metrics.default_registry()
_TAKEOVERS = _OBS.counter(
    "kubeshare_ha_takeovers_total",
    "Leadership acquisitions by domain (first election included).",
    labels=("domain",))
_DEPOSED = _OBS.counter(
    "kubeshare_ha_deposed_total",
    "Leadership losses observed by the deposed holder, by domain.",
    labels=("domain",))


class LeadershipManager:
    """Hold (or stalk) one ``leader:<domain>`` lease.

    Works against an in-process :class:`TelemetryRegistry` and a
    :class:`RegistryClient` alike — both expose ``acquire_leader`` /
    ``leader`` with identical semantics. Drive :meth:`step` on a
    cadence well inside ``ttl_s`` (the heartbeater's ttl/3 rule is a
    good one); every registry error keeps the current belief — an
    unreachable registry deposes nobody, exactly like the healthwatch
    freezing on a failed lease read.
    """

    def __init__(self, registry, domain: str, holder: str,
                 ttl_s: float = 5.0, clock=time.time):
        self.registry = registry
        self.domain = domain
        self.holder = holder
        self.ttl_s = float(ttl_s)
        self._clock = clock
        #: our incarnation epoch while leading; the best-known current
        #: epoch while standing by (what the next takeover must beat)
        self.epoch = 0
        self.is_leader = False
        self.takeovers = 0
        self.last_takeover_ts = 0.0
        self.last_error: str = ""

    # -- the loop ----------------------------------------------------------

    def step(self, now: float | None = None) -> bool:
        """One election/renewal tick; returns the post-tick leadership.
        Transitions (gained/lost) are visible to the caller by
        comparing ``is_leader`` across the call."""
        if now is None:
            now = self._clock()
        try:
            if self.is_leader:
                self._renew()
            else:
                self._contest(now)
            self.last_error = ""
        except Exception as e:   # registry unreachable: hold beliefs
            self.last_error = str(e)
            log.warning("leader:%s step failed (%s); state held",
                        self.domain, e)
        return self.is_leader

    def _renew(self) -> None:
        ok, epoch, holder = self.registry.acquire_leader(
            self.domain, self.holder, self.epoch, self.ttl_s)
        if not ok:
            # superseded: someone took the lease at a higher epoch
            # while we were away — we are the zombie now
            log.warning("leader:%s deposed: epoch %d superseded by "
                        "%d (%s)", self.domain, self.epoch, epoch, holder)
            _DEPOSED.inc(self.domain)
            self.is_leader = False
            self.epoch = epoch

    def _contest(self, now: float) -> None:
        lead = self.registry.leader(self.domain)
        if lead is not None and not lead.get("expired", False):
            self.epoch = max(self.epoch, int(lead.get("epoch", 0)))
            return   # live leader; keep standing by
        target = max(self.epoch, int(lead["epoch"]) if lead else 0) + 1
        ok, epoch, holder = self.registry.acquire_leader(
            self.domain, self.holder, target, self.ttl_s)
        if ok:
            self.epoch = target
            self.is_leader = True
            self.takeovers += 1
            self.last_takeover_ts = now
            _TAKEOVERS.inc(self.domain)
            log.info("leader:%s acquired by %s at epoch %d",
                     self.domain, self.holder, target)
        else:
            # lost the race; remember the winning epoch for next time
            self.epoch = epoch

    def resign(self) -> None:
        """Stop renewing without waiting for expiry (clean shutdown);
        the lease simply ages out for the standby to claim."""
        self.is_leader = False

    def state(self) -> dict:
        return {"domain": self.domain, "holder": self.holder,
                "is_leader": self.is_leader, "epoch": self.epoch,
                "ttl_s": self.ttl_s, "takeovers": self.takeovers,
                "last_takeover_ts": self.last_takeover_ts,
                "last_error": self.last_error}
