"""Registry replication — a follower tailing the leader's op-stream.

The port's copy of ``kubeshare_tpu/ha/replication.py``.

The leader's fsynced journal already *is* the replication log; this
module ships it (doc/ha.md). The follower pulls ``replicate(cursor)``
batches on a cadence, applies them through the same ``_apply`` path a
journal replay uses, journals them locally, and persists its cursor as
a journal record — so a follower restart resumes from where its own
disk is caught up to, and a cursor that fell behind the leader's
retained window (or a leader that restarted into a new stream id)
triggers a full snapshot rebase instead of a torn incremental.

Replication is *bounded-lag async by design*: the leader never waits
for a follower, and the follower's reads carry staleness marks rather
than pretending to be current. The TSDB is deliberately not part of
the stream — same restart semantics as a single registry.
"""

from __future__ import annotations

import threading
import time

from ..obs import metrics as obs_metrics
from ..utils.logger import get_logger

log = get_logger("ha.replication")

DEFAULT_POLL_S = 0.5

_OBS = obs_metrics.default_registry()
_LAG = _OBS.histogram(
    "kubeshare_ha_replication_lag_seconds",
    "Follower staleness at each successful sync: time since the "
    "previous one.",
    buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0))
_OPS = _OBS.counter(
    "kubeshare_ha_replicated_ops_total",
    "Ops applied on the follower, by batch kind.",
    labels=("kind",))


class ReplicationFollower:
    """Tail one leader registry into a local follower registry.

    ``follower`` is the local :class:`TelemetryRegistry` (flipped into
    follower mode here); ``source`` is the leader — an in-process
    registry or a :class:`RegistryClient` — anything with
    ``replicate(cursor, stream)``. Drive :meth:`step` directly under a
    virtual clock (chaos, bench) or :meth:`start` a thread for live
    deployments.
    """

    def __init__(self, follower, source, leader_hint: str = "",
                 poll_s: float = DEFAULT_POLL_S,
                 lag_bound_s: float = 5.0, clock=time.time):
        self.follower = follower
        self.source = source
        self.poll_s = float(poll_s)
        #: advertised bound (doctor's check_ha compares measured lag
        #: against this; the stream itself never blocks on it)
        self.lag_bound_s = float(lag_bound_s)
        self._clock = clock
        # resume from the durable cursor when the local journal has one
        # and it belongs to a stream we can name; a mismatch simply
        # rebases on the first pull
        self.cursor = int(getattr(follower, "_repl_cursor", None) or 0)
        self.stream: str | None = getattr(follower, "_repl_stream",
                                          None) or None
        self.last_sync_ts: float | None = None
        self._prev_sync: float | None = None
        self.head = 0
        self.synced = 0
        self.rebases = 0
        self.last_error = ""
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        follower.set_follower(leader_hint)
        follower._repl_status_fn = self.status

    # -- one pull ----------------------------------------------------------

    def step(self, now: float | None = None) -> bool:
        """One replication pull; True when the follower advanced (or
        was already at head). Errors leave the cursor untouched — the
        next pull re-covers the same ground (ops are idempotent
        upserts, and the cursor is only advanced after the batch
        lands)."""
        if now is None:
            now = self._clock()
        try:
            batch = self.source.replicate(self.cursor, stream=self.stream)
        except Exception as e:
            self.last_error = str(e)
            log.warning("replication pull failed: %s", e)
            return False
        self.last_error = ""
        ops = batch.get("ops", [])
        head = int(batch.get("head", self.cursor))
        stream = str(batch.get("stream", ""))
        if batch.get("rebase"):
            self.follower.apply_replicated(ops, head, stream, rebase=True)
            self.rebases += 1
            _OPS.inc("rebase")
            log.info("rebased from snapshot: %d ops, cursor -> %d",
                     len(ops), head)
            self.cursor = head
        elif ops:
            applied = self.follower.apply_replicated(
                ops, ops[-1]["seq"], stream)
            _OPS.inc("incremental")
            self.cursor = int(ops[-1]["seq"])
            log.debug("applied %d replicated ops, cursor %d/%d",
                      applied, self.cursor, head)
        self.stream = stream
        self.head = head
        self.last_sync_ts = now
        self.synced += 1
        _LAG.observe(value=0.0 if self._prev_sync is None
                     else min(now - self._prev_sync, 3600.0))
        self._prev_sync = now
        return True

    def lag_s(self, now: float | None = None) -> float:
        """Staleness: seconds since the last successful sync (0 when
        never synced is unknowable, so it reports +inf-ish large)."""
        if self.last_sync_ts is None:
            return float("inf")
        if now is None:
            now = self._clock()
        return max(0.0, now - self.last_sync_ts)

    def in_sync(self) -> bool:
        return self.last_sync_ts is not None and self.cursor >= self.head

    def status(self) -> dict:
        """Merged into ``GET /replication`` on the follower."""
        lag = self.lag_s()
        return {"cursor": self.cursor, "head": self.head,
                "lag_s": (-1.0 if lag == float("inf")
                          else round(lag, 3)),
                "lag_bound_s": self.lag_bound_s,
                "in_sync": self.in_sync(), "rebases": self.rebases,
                "synced": self.synced, "last_error": self.last_error}

    # -- promotion ---------------------------------------------------------

    def promote(self) -> None:
        """Stop tailing and flip the local registry into a writable
        leader (the registry-side half of a takeover; leadership
        acquisition is the :class:`LeadershipManager`'s job)."""
        self.stop()
        self.follower.promote()

    # -- thread ------------------------------------------------------------

    def start(self) -> "ReplicationFollower":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ha-replication")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            self.step()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
