"""Heartbeat lease publisher — the node agent's liveness signal.

The port's copy of ``kubeshare_tpu/telemetry/heartbeat.py``.

The reference has no liveness plane at all: a dead node's capacity
lingers in Prometheus until scrape staleness ages it out, and nothing
requeues the pods bound there. Here every node agent runs one
:class:`Heartbeater` that PUTs a lease (monotonic epoch + TTL) into the
registry on a fixed period; the scheduler's healthwatch
(:mod:`..scheduler.healthwatch`) turns missing beats into node death,
eviction, and rescheduling. Wire format and tuning: ``doc/health.md``.

Epoch discipline — the whole point of the epoch is restart takeover:

- on start, the heartbeater reads the node's current lease from the
  registry and continues at ``epoch + 1``, so a restarted agent
  supersedes its previous incarnation instead of racing it;
- a rejected beat (409: someone published a higher epoch) re-reads and
  jumps past the winner — the LAST agent to take over owns the lease,
  and a zombie predecessor is refused by the registry's monotonic
  check.

Fault drills (``resilience/faults.py``): the publisher consults the
process-wide injector before every beat — ``suppress_heartbeats_node``
models a killed agent, ``flap_node``/``flap_beats`` a flapping one.
The suppression happens HERE, client-side, because that is what a dead
process looks like to the registry: silence, not an error.
"""

from __future__ import annotations

import threading

from .. import constants as C
from ..utils.logger import get_logger

log = get_logger("heartbeat")


class Heartbeater:
    """Publish one node's liveness lease on a fixed period."""

    def __init__(self, registry, node: str,
                 ttl_s: float = C.LEASE_TTL_S,
                 period_s: float | None = None):
        self.registry = registry
        self.node = node
        self.ttl_s = float(ttl_s)
        # default cadence: 3 beats per TTL, so one dropped packet never
        # makes a healthy node even *suspect*
        self.period_s = float(period_s) if period_s else self.ttl_s / 3.0
        self.epoch = 0
        self.beats_sent = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- one beat ----------------------------------------------------------

    def _current_epoch(self) -> int:
        """The registry's recorded epoch for this node (0 when none)."""
        try:
            raw = self.registry.leases()
        except Exception as e:
            log.warning("lease read failed: %s", e)
            return 0
        leases = raw.get("leases", raw) if isinstance(raw, dict) else {}
        entry = leases.get(self.node)
        return int(entry["epoch"]) if entry else 0

    def beat_once(self) -> bool:
        """One heartbeat; returns True when the registry accepted it.
        Suppressed (fault drill) and failed beats both return False —
        from the health plane's view they are the same silence."""
        from ..resilience import faults

        inj = faults.active()
        if inj is not None and inj.should_suppress_heartbeat(self.node):
            log.debug("heartbeat for %s suppressed by fault injector",
                      self.node)
            return False
        if self.epoch == 0:
            # first beat of this incarnation: supersede any predecessor
            self.epoch = self._current_epoch() + 1
        try:
            ok, current = self.registry.put_lease(self.node, self.epoch,
                                                  self.ttl_s)
        except Exception as e:
            log.warning("heartbeat for %s failed: %s", self.node, e)
            return False
        if not ok:
            # a newer incarnation took the lease; jump past it — last
            # publisher wins, and the registry referees via the epoch
            log.warning("lease epoch %d for %s superseded (current %d); "
                        "jumping ahead", self.epoch, self.node, current)
            self.epoch = current + 1
            return False
        self.beats_sent += 1
        self.epoch += 1
        return True

    # -- lifecycle ---------------------------------------------------------

    def run_forever(self) -> None:
        first = True
        while not self._stop.wait(0.0 if first else self.period_s):
            first = False
            self.beat_once()

    def start(self) -> "Heartbeater":
        self._thread = threading.Thread(target=self.run_forever, daemon=True,
                                        name=f"heartbeat-{self.node}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
