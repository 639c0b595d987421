"""The telemetry registry — the cluster state bus.

The port's copy of ``kubeshare_tpu/telemetry/registry.py``. Its CLI runs
a replication follower with ``--follower-of`` (the port's ``ha/``), which
SIGHUP promotes to a writable leader.

The reference routes *scheduling decisions* through Prometheus: collectors
export ``gpu_capacity``, the aggregator exports ``gpu_requirement``, and
both the scheduler and the node daemon query them back over PromQL with a
5 s scrape + 5-10 s query window (``pkg/scheduler/gpu.go:22-37``,
``pkg/config/query.go:22-37``). That staleness is the reference's weakest
link — its own README plans to replace it (``README.md:133``).

This registry is the replacement: collectors PUSH capacity on change,
the scheduler PUSHES requirement records at bind time, and every consumer
GETs fresh state — no scrape window in the decision path. Prometheus stays
for *observability*: ``GET /metrics`` renders both metric families in
exposition format with the reference's shape (data in labels, value =
timestamp — ``collector.go:49-58``).

HTTP API (JSON bodies):

- ``PUT  /capacity/<node>``    {"chips": [chip labels...], "healthy": bool}
- ``GET  /capacity``           {node: {"chips": [...], "healthy", "ts"}}
- ``DELETE /capacity/<node>``
- ``PUT  /pods/<ns>/<name>``   requirement record (see aggregator)
- ``GET  /pods[?node=X]``      {key: record}
- ``DELETE /pods/<ns>/<name>``
- ``PUT  /lease/<node>``       {"epoch": int, "ttl_s": float} → 200 ok,
  409 + current epoch when the epoch is stale (zombie publisher)
- ``GET  /leases``             {"now": server_ts, "leases": {node: {...}}}
  — ``now`` is the registry's clock so agents can measure skew
- ``GET  /metrics``            Prometheus exposition (capacity+requirement)

**Leases** (doc/health.md): node agents heartbeat ``put_lease`` with a
monotonically increasing epoch; ``stale_nodes(now)`` lists nodes whose
lease age exceeds its TTL. Lease epochs are journaled, but on replay
each lease's timestamp is reset to construction time — a registry
restart grants the fleet one full TTL of grace instead of mass-expiring
every node that beat while the registry was down.

**Durability**: pass ``journal=<path>`` and every mutation is appended to
a JSONL journal (compacted to a snapshot every ``compact_every`` writes),
replayed on construction — a registry restart no longer loses bindings
and capacity. The reference survives restarts via the k8s API + pod
annotations; the dispatcher's startup ``replay_bound`` plays the same
role here and needs the registry to remember (``pod.go:47-78``).

**HA** (doc/ha.md): the journal doubles as a shipped op-stream — every
mutation also enters a bounded in-memory oplog with a monotonic ``seq``,
and ``GET /replicate?cursor=N`` returns the ops after N (a cursor behind
the retained window, or a ``stream`` id from a different leader
incarnation, answers with a full snapshot rebase). A follower registry
(``set_follower``) applies that stream locally, refuses every external
write with a 307-style leader hint, and marks its reads with explicit
staleness headers. Leadership itself is a lease in the leases table
under the reserved ``leader:<domain>`` keys (monotonic epoch + holder,
same zombie-refusal discipline as heartbeats); mutating pod writes may
carry a ``fence`` epoch that is checked against the ``leader:scheduler``
lease so a deposed scheduler's binds are refused 409. TSDB series stay
deliberately unreplicated — same restart semantics as before.
"""

from __future__ import annotations

import itertools
import json
import os
import random
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

from ..obs import metrics as obs_metrics
from ..obs import prof as obs_prof
# One exposition code path for the whole system: the canonical renderer
# lives in obs.metrics; these names stay importable here for callers
# that predate the obs package (collector.py, external tools).
from ..obs.metrics import prom_escape as _prom_escape  # noqa: F401
from ..obs.metrics import render_help_type, render_sample as render_metric
from ..obs.tsdb import TimeSeriesStore
from ..utils.logger import get_logger

log = get_logger("registry")

_RETRIES = obs_metrics.default_registry().counter(
    "kubeshare_registry_client_retries_total",
    "RegistryClient HTTP attempts retried after a transient failure.",
    labels=("op",))
_FENCED = obs_metrics.default_registry().counter(
    "kubeshare_ha_fenced_writes_total",
    "Pod writes carrying a fencing epoch, by acceptance result.",
    labels=("result",))
#: precomputed series key for the accepted fast path in
#: _check_fence_locked (the refused path keeps the full inc)
_FENCED_ACCEPTED = _FENCED._key(("accepted",))
_FAILOVERS = obs_metrics.default_registry().counter(
    "kubeshare_ha_client_failovers_total",
    "RegistryClient attempts re-targeted to another endpoint.",
    labels=("op",))

#: reserved lease-key namespace for leadership (doc/ha.md) — these keys
#: live in the same leases table as node heartbeats but are NOT nodes:
#: the healthwatch and stale_nodes skip them
LEADER_PREFIX = "leader:"
#: the one lease key the pod-write fence compares against, precomputed —
#: the fence check rides every bind (bench_failover gates it at <=2% of
#: an admission check)
_LEADER_SCHED_KEY = LEADER_PREFIX + "scheduler"
#: retained replication ops; a follower further behind rebases from a
#: full snapshot instead of an incremental batch
REPLICATION_WINDOW = 4096
#: accepted fencing epochs kept for the chaos plane's single-writer check
FENCE_LOG_CAP = 1024

_STREAM_IDS = itertools.count(1)


class FencedWriteError(Exception):
    """A mutating write carried a fencing epoch older than the current
    ``leader:scheduler`` lease — the writer was deposed (doc/ha.md)."""

    def __init__(self, fence: int, current: int):
        super().__init__(
            f"write fenced: epoch {fence} superseded by {current}")
        self.fence = int(fence)
        self.current = int(current)


class NotLeaderError(Exception):
    """A mutating call reached a follower replica; retarget at the
    leader it names (the in-process twin of the HTTP 307 hint)."""

    def __init__(self, leader: str):
        super().__init__(f"not the leader; writes go to {leader or '?'}")
        self.leader = leader


class TelemetryRegistry:
    """In-memory cluster state with an HTTP surface."""

    def __init__(self, journal: str | os.PathLike | None = None,
                 compact_every: int = 1000, clock=time.time,
                 tsdb: TimeSeriesStore | None = None):
        # tracked (doc/observability.md, "Locks, phases, and
        # profiles"): the registry store serializes every push,
        # query, and lease under this one lock
        self._lock = obs_prof.TrackedLock("registry")
        self._clock = clock
        #: fleet TSDB behind POST /push + GET /query. Deliberately NOT
        #: journaled: decision state (capacity/pods/leases) must survive
        #: a restart, remote-written samples must NOT — replaying them
        #: would resurrect instances that died while the registry was
        #: down as fresh-looking series. Instances re-appear within one
        #: push period; history restarts from zero.
        self.tsdb = tsdb if tsdb is not None else TimeSeriesStore(clock=clock)
        self._capacity: dict[str, dict] = {}
        self._pods: dict[str, dict] = {}
        #: node -> {"epoch", "ttl_s", "ts"}; ts is ALWAYS this registry's
        #: clock (set at receive / replay), never the publisher's
        self._leases: dict[str, dict] = {}
        self._server: ThreadingHTTPServer | None = None
        self._journal_path = Path(journal) if journal else None
        self._journal = None
        self._compact_every = compact_every
        self._writes = 0
        # -- replication plane (doc/ha.md) -- every mutation also enters
        # this bounded oplog under a per-incarnation stream id; followers
        # tail it through replicate(). All None/empty when HA is unused.
        self._stream_id = f"{os.getpid():x}.{next(_STREAM_IDS):x}"
        self._seq = 0
        self._oplog: deque = deque(maxlen=REPLICATION_WINDOW)
        self._follower_of: str | None = None
        self._repl_cursor: int | None = None
        self._repl_stream: str | None = None
        self._repl_status_fn = None   # ReplicationFollower.status hook
        #: accepted fencing epochs, in acceptance order — the chaos
        #: plane's check_single_writer reads this
        self.fence_log: deque = deque(maxlen=FENCE_LOG_CAP)
        if self._journal_path is not None:
            self._replay()
            self._journal = open(self._journal_path, "a", encoding="utf-8")
            # a crash mid-append leaves a torn line with no newline; start
            # the next record on a fresh line or the two would glue into
            # one unparseable record
            if self._journal.tell() > 0:
                with open(self._journal_path, "rb") as fh:
                    fh.seek(-1, os.SEEK_END)
                    if fh.read(1) != b"\n":
                        self._journal.write("\n")
                        self._journal.flush()

    # -- durability --------------------------------------------------------

    def _replay(self) -> None:
        if not self._journal_path.exists():
            return
        applied = bad = 0
        with open(self._journal_path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                    self._apply(rec)
                    applied += 1
                except (ValueError, KeyError):
                    # a torn final line from a crash mid-append is expected;
                    # anything else is still better skipped than fatal
                    bad += 1
        if applied or bad:
            log.info("journal replay: %d records (%d skipped), "
                     "%d nodes, %d pods", applied, bad,
                     len(self._capacity), len(self._pods))

    def _apply(self, rec: dict) -> None:
        op = rec["op"]
        if op == "put_capacity":
            self._capacity[rec["node"]] = {"chips": rec["chips"],
                                           "healthy": rec["healthy"],
                                           "ts": rec["ts"]}
        elif op == "drop_capacity":
            self._capacity.pop(rec["node"], None)
        elif op == "put_pod":
            self._pods[rec["key"]] = rec["record"]
        elif op == "drop_pod":
            self._pods.pop(rec["key"], None)
        elif op == "put_lease":
            # epochs survive the restart (zombie protection stays armed);
            # the timestamp is reset to NOW so every replayed lease gets
            # one full TTL of grace — a restart must not mass-expire a
            # fleet that kept beating while the registry was down. The
            # grace applies to leader:<domain> leases too: a failover is
            # a restart of the leadership plane, not of its epochs.
            lease = {"epoch": int(rec["epoch"]),
                     "ttl_s": float(rec["ttl_s"]),
                     "ts": self._clock()}
            if "holder" in rec:   # leadership leases carry their holder
                lease["holder"] = rec["holder"]
            self._leases[rec["node"]] = lease
        elif op == "drop_lease":
            self._leases.pop(rec["node"], None)
        elif op == "cursor":
            # a follower's durable replication cursor (doc/ha.md): where
            # in which leader stream its local journal is caught up to
            self._repl_cursor = int(rec["seq"])
            self._repl_stream = str(rec.get("stream", ""))
        else:
            raise KeyError(op)

    def _log(self, rec: dict) -> None:
        """Append one mutation (caller holds the lock). Every
        ``compact_every`` writes the journal is rewritten as a snapshot —
        an append-only file would otherwise grow with every heartbeat
        re-put of unchanged capacity."""
        if rec.get("op") != "cursor":
            # every state mutation ships to followers; the cursor record
            # is follower-local bookkeeping and never replicated onward
            self._seq += 1
            self._oplog.append(dict(rec, seq=self._seq))
        if self._journal is None:
            return
        self._journal.write(json.dumps(rec) + "\n")
        self._journal.flush()
        # fsync every record: an acknowledged binding that only reached the
        # page cache would vanish on power loss, and the dispatcher's
        # replay would then double-book the chip. Mutations are low-rate
        # (capacity heartbeats + bind/unbind), so the sync cost is noise.
        os.fsync(self._journal.fileno())
        self._writes += 1
        if self._writes >= self._compact_every:
            self._compact()

    def _compact(self) -> None:
        tmp = self._journal_path.with_suffix(".tmp")
        with open(tmp, "w", encoding="utf-8") as fh:
            for node, entry in self._capacity.items():
                fh.write(json.dumps({"op": "put_capacity", "node": node,
                                     **entry}) + "\n")
            for key, record in self._pods.items():
                fh.write(json.dumps({"op": "put_pod", "key": key,
                                     "record": record}) + "\n")
            for node, lease in self._leases.items():
                rec = {"op": "put_lease", "node": node,
                       "epoch": lease["epoch"], "ttl_s": lease["ttl_s"]}
                if "holder" in lease:
                    rec["holder"] = lease["holder"]
                fh.write(json.dumps(rec) + "\n")
            if self._repl_cursor is not None:
                fh.write(json.dumps({"op": "cursor",
                                     "seq": self._repl_cursor,
                                     "stream": self._repl_stream or ""})
                         + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        old = self._journal
        self._journal = None  # _log becomes a no-op if the swap fails
        try:
            old.close()
            os.replace(tmp, self._journal_path)  # atomic: old or new state
        finally:
            # Reopen unconditionally: on a failed replace we keep appending
            # to the pre-compaction journal (state is still consistent);
            # a reopen failure leaves journaling disabled but the registry
            # serving — better than erroring every write with memory and
            # disk silently diverged.
            try:
                self._journal = open(self._journal_path, "a",
                                     encoding="utf-8")
            except OSError as e:
                log.error("journal reopen failed, durability disabled: %s", e)
            self._writes = 0

    # -- state (thread-safe, also usable in-process) -----------------------

    def _writable(self) -> None:
        """Every external mutator calls this first: a follower replica
        never accepts writes — callers retarget at the leader it names
        (doc/ha.md, single-writer rule)."""
        if self._follower_of is not None:
            raise NotLeaderError(self._follower_of)

    def put_capacity(self, node: str, chips: list[dict],
                     healthy: bool = True) -> None:
        self._writable()
        with self._lock:
            entry = {"chips": chips, "healthy": healthy,
                     "ts": self._clock()}
            self._capacity[node] = entry
            self._log({"op": "put_capacity", "node": node, **entry})

    def drop_capacity(self, node: str) -> None:
        self._writable()
        with self._lock:
            self._capacity.pop(node, None)
            self._log({"op": "drop_capacity", "node": node})

    def capacity(self) -> dict[str, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._capacity.items()}

    def _check_fence_locked(self, fence: int) -> None:
        """Refuse a pod write whose fencing epoch is older than the
        current ``leader:scheduler`` lease epoch — the writer lost
        leadership and must freeze, not keep binding (doc/ha.md). A
        write with no fence is untouched: HA off means the exact
        pre-HA behavior."""
        cur = self._leases.get(_LEADER_SCHED_KEY)
        current = int(cur["epoch"]) if cur is not None else 0
        if fence < current:
            _FENCED.inc("refused")
            raise FencedWriteError(fence, current)
        # accepted is the bind hot path: a full labeled inc (tuple key +
        # lock) costs more than the rest of this check combined, so bump
        # the series cell directly — a lost increment under a rare
        # cross-thread race skews an advisory counter, never the fence
        # decision (the decision recorder takes the same stance)
        series = _FENCED._series
        series[_FENCED_ACCEPTED] = series.get(_FENCED_ACCEPTED, 0.0) + 1.0
        self.fence_log.append(fence)

    def put_pod(self, key: str, record: dict,
                fence: int | None = None) -> None:
        self._writable()
        with self._lock:
            if fence is not None:
                self._check_fence_locked(int(fence))
            rec = dict(record, ts=self._clock())
            self._pods[key] = rec
            self._log({"op": "put_pod", "key": key, "record": rec})

    def drop_pod(self, key: str, fence: int | None = None) -> None:
        self._writable()
        with self._lock:
            if fence is not None:
                self._check_fence_locked(int(fence))
            self._pods.pop(key, None)
            self._log({"op": "drop_pod", "key": key})

    def pods(self, node: str | None = None) -> dict[str, dict]:
        with self._lock:
            items = dict(self._pods)
        if node is None:
            return items
        return {k: v for k, v in items.items() if v.get("node") == node}

    # -- liveness leases (doc/health.md) -----------------------------------

    def put_lease(self, node: str, epoch: int,
                  ttl_s: float = 5.0) -> tuple[bool, int]:
        """One heartbeat. Epochs must be STRICTLY monotonic per node: a
        beat at or below the recorded epoch is refused — it comes from a
        zombie publisher (the pre-restart agent, or one cut off by a
        partition that a replacement already superseded; a live agent
        increments every beat, so equality can only be a second
        publisher racing on the same epoch). Returns
        ``(accepted, current_epoch)``."""
        epoch = int(epoch)
        self._writable()
        with self._lock:
            cur = self._leases.get(node)
            if cur is not None and epoch <= cur["epoch"]:
                return False, cur["epoch"]
            lease = {"epoch": epoch, "ttl_s": float(ttl_s),
                     "ts": self._clock()}
            self._leases[node] = lease
            self._log({"op": "put_lease", "node": node, "epoch": epoch,
                       "ttl_s": lease["ttl_s"]})
            return True, epoch

    def leases(self, now: float | None = None) -> dict[str, dict]:
        """{node: {"epoch", "ttl_s", "ts", "age_s"}} — age computed on
        the registry clock, so consumers never compare clocks."""
        with self._lock:
            if now is None:
                now = self._clock()
            return {node: dict(lease, age_s=max(0.0, now - lease["ts"]))
                    for node, lease in self._leases.items()}

    def stale_nodes(self, now: float | None = None) -> list[str]:
        """Nodes whose lease age exceeds its TTL (suspect or worse).
        Leadership leases are not nodes and never appear here."""
        return sorted(node for node, lease in self.leases(now).items()
                      if lease["age_s"] > lease["ttl_s"]
                      and not node.startswith(LEADER_PREFIX))

    def drop_lease(self, node: str) -> None:
        """Forget a node's lease (a decommission, not a death — the
        healthwatch stops monitoring it entirely)."""
        self._writable()
        with self._lock:
            self._leases.pop(node, None)
            self._log({"op": "drop_lease", "node": node})

    # -- leadership (doc/ha.md) --------------------------------------------

    def acquire_leader(self, domain: str, holder: str, epoch: int,
                       ttl_s: float = 5.0) -> tuple[bool, int, str]:
        """Acquire or renew the ``leader:<domain>`` lease. Semantics:

        - same holder at the SAME epoch while the lease is live → renew
          (timestamp refresh; the fencing epoch is the *incarnation*,
          stable across renewals, unlike per-beat node epochs);
        - no lease, or the current one expired, and ``epoch`` is
          strictly greater → takeover;
        - anything else → refused, with the current epoch + holder as
          the takeover hint (the heartbeat 409 discipline).

        Returns ``(accepted, current_epoch, current_holder)``."""
        key = LEADER_PREFIX + domain
        epoch = int(epoch)
        self._writable()
        with self._lock:
            now = self._clock()
            cur = self._leases.get(key)
            if cur is not None:
                live = (now - cur["ts"]) <= cur["ttl_s"]
                if (live and cur.get("holder") == holder
                        and epoch == cur["epoch"]):
                    cur["ts"] = now   # renewal, not a new incarnation
                    self._log({"op": "put_lease", "node": key,
                               "epoch": epoch, "ttl_s": cur["ttl_s"],
                               "holder": holder})
                    return True, epoch, holder
                if live or epoch <= cur["epoch"]:
                    # held by someone else, or the epoch does not
                    # advance past the old incarnation (fencing must
                    # stay monotonic even over an expired lease)
                    return False, cur["epoch"], cur.get("holder", "")
            lease = {"epoch": epoch, "ttl_s": float(ttl_s), "ts": now,
                     "holder": holder}
            self._leases[key] = lease
            self._log({"op": "put_lease", "node": key, "epoch": epoch,
                       "ttl_s": lease["ttl_s"], "holder": holder})
            log.info("leader:%s -> %s (epoch %d)", domain, holder, epoch)
            return True, epoch, holder

    def leader(self, domain: str) -> dict | None:
        """Current ``leader:<domain>`` lease (with age + expiry flag on
        this registry's clock), or None when nobody ever led."""
        with self._lock:
            cur = self._leases.get(LEADER_PREFIX + domain)
            if cur is None:
                return None
            age = max(0.0, self._clock() - cur["ts"])
            return {"domain": domain, "holder": cur.get("holder", ""),
                    "epoch": cur["epoch"], "ttl_s": cur["ttl_s"],
                    "age_s": age, "expired": age > cur["ttl_s"]}

    # -- replication (doc/ha.md) -------------------------------------------

    def replicate(self, cursor: int = 0, stream: str | None = None,
                  limit: int = 512) -> dict:
        """Serve one replication pull: the ops after *cursor* plus the
        stream head. A cursor that fell behind the retained window — or
        one from a different leader incarnation (``stream`` mismatch) —
        gets a full snapshot rebase instead, torn-tail free by
        construction (ops are whole JSON records, never byte ranges)."""
        cursor = int(cursor)
        with self._lock:
            head = self._seq
            tail = head - len(self._oplog)   # seq before the oldest op
            if (stream is not None and stream != self._stream_id) \
                    or cursor < tail:
                return {"stream": self._stream_id, "head": head,
                        "rebase": True, "ops": self._snapshot_ops()}
            ops = [op for op in self._oplog
                   if op["seq"] > cursor][:int(limit)]
            return {"stream": self._stream_id, "head": head,
                    "rebase": False, "ops": ops}

    def _snapshot_ops(self) -> list[dict]:
        """Current state as journal-style records (the _compact shape) —
        what a rebasing follower replays from scratch."""
        ops: list[dict] = []
        for node, entry in self._capacity.items():
            ops.append({"op": "put_capacity", "node": node, **entry})
        for key, record in self._pods.items():
            ops.append({"op": "put_pod", "key": key, "record": record})
        for node, lease in self._leases.items():
            rec = {"op": "put_lease", "node": node,
                   "epoch": lease["epoch"], "ttl_s": lease["ttl_s"]}
            if "holder" in lease:
                rec["holder"] = lease["holder"]
            ops.append(rec)
        return ops

    def apply_replicated(self, ops: list[dict], cursor: int,
                         stream: str, rebase: bool = False) -> int:
        """Apply one replication batch on a follower: each op goes
        through the same ``_apply`` the journal replay uses, is
        journaled locally, and the durable cursor record lands last —
        a crash mid-batch re-pulls from the old cursor and re-applies
        idempotent ops. ``rebase`` clears state first and rewrites the
        local journal as a snapshot. Returns ops applied; unparseable
        ops are skipped (the journal replay's torn-tail tolerance)."""
        applied = 0
        with self._lock:
            if rebase:
                self._capacity.clear()
                self._pods.clear()
                self._leases.clear()
            for rec in ops:
                rec = {k: v for k, v in rec.items() if k != "seq"}
                try:
                    self._apply(rec)
                    applied += 1
                except (ValueError, KeyError) as e:
                    log.warning("replicated op skipped: %s (%s)", rec, e)
                    continue
                if not rebase:
                    self._log(rec)
            self._repl_cursor = int(cursor)
            self._repl_stream = str(stream)
            if rebase and self._journal is not None:
                self._compact()   # snapshot-rewrite: old state is gone
            else:
                self._log({"op": "cursor", "seq": int(cursor),
                           "stream": str(stream)})
        return applied

    def set_follower(self, leader: str) -> None:
        """Enter follower mode: every external write is refused with
        *leader* as the retarget hint; replication is the only way
        state changes (doc/ha.md, single-writer rule)."""
        self._follower_of = leader

    def promote(self) -> None:
        """Leave follower mode — this replica starts accepting writes
        under its own stream id (downstream followers rebase)."""
        log.info("promoted: follower of %s -> leader", self._follower_of)
        self._follower_of = None
        self._repl_status_fn = None

    @property
    def is_follower(self) -> bool:
        return self._follower_of is not None

    def replication_status(self) -> dict:
        """``GET /replication`` body: role, stream position, and — on a
        follower — the tail status its ReplicationFollower reports."""
        with self._lock:
            st = {"role": "follower" if self._follower_of else "leader",
                  "stream": self._stream_id, "seq": self._seq,
                  "window": len(self._oplog)}
            cur = self._leases.get(LEADER_PREFIX + "scheduler")
            st["fence_epoch"] = int(cur["epoch"]) if cur else 0
            if self._follower_of:
                st["leader"] = self._follower_of
                if self._repl_cursor is not None:
                    st["cursor"] = self._repl_cursor
        fn = self._repl_status_fn
        if fn is not None:
            try:
                st.update(fn())
            except Exception:   # a torn follower must not break the probe
                pass
        return st

    def _read_marks(self) -> list[tuple[str, str]]:
        """Staleness marks for follower reads: headers, not body fields,
        so the wire stays byte-identical for non-HA deployments."""
        if self._follower_of is None:
            return []
        marks = [("X-Kubeshare-Replica", "follower"),
                 ("X-Kubeshare-Leader", self._follower_of)]
        fn = self._repl_status_fn
        if fn is not None:
            try:
                lag = fn().get("lag_s")
                if lag is not None:
                    marks.append(("X-Kubeshare-Staleness-S", f"{lag:.3f}"))
            except Exception:
                pass
        return marks

    # -- fleet TSDB (remote-write + query) ---------------------------------

    def push_metrics(self, instance: str, job: str,
                     snapshot: dict | None = None,
                     exposition: str | None = None,
                     now: float | None = None) -> int:
        """Ingest one remote-write push; returns samples stored. A
        follower refuses pushes like any other external write — series
        belong on the leader's (unreplicated) TSDB."""
        self._writable()
        return self.tsdb.ingest(instance, job, snapshot=snapshot,
                                exposition=exposition, now=now)

    def mark_instance_stale(self, instance: str) -> None:
        self.tsdb.mark_stale(instance)

    #: duck-type parity with RegistryClient so a RemoteWriter can push
    #: into an in-process registry in tests and the sim
    mark_stale = mark_instance_stale

    def render_metrics(self) -> str:
        """Prometheus exposition, reference metric shapes
        (collector.go:30-35, aggregator.go:22-39) under TPU names, plus
        the process's self-metrics from the obs default registry."""
        obs_prof.sync_metrics()   # flush lock accumulators into counters
        lines = render_help_type(
            "tpu_capacity", "gauge",
            "Schedulable chip inventory; chip identity in labels, "
            "value is the publish timestamp.")
        for node, entry in self.capacity().items():
            for chip in entry["chips"]:
                lines.append(render_metric("tpu_capacity", chip, entry["ts"]))
        lines.extend(render_help_type(
            "tpu_requirement", "gauge",
            "Bound pod requirements; binding record in labels, "
            "value is the bind timestamp."))
        for key, rec in self.pods().items():
            labels = {k: v for k, v in rec.items() if k != "ts"}
            ns, _, name = key.partition("/")
            labels.update({"namespace": ns, "pod": name})
            lines.append(render_metric("tpu_requirement", labels, rec["ts"]))
        leases = self.leases()
        if leases:
            lines.extend(render_help_type(
                "kubeshare_lease_age_seconds", "gauge",
                "Seconds since the node's last heartbeat lease, on the "
                "registry clock."))
            for node, lease in sorted(leases.items()):
                lines.append(render_metric("kubeshare_lease_age_seconds",
                                           {"node": node}, lease["age_s"]))
        return "\n".join(lines) + "\n" + obs_metrics.render_default()

    # -- HTTP server -------------------------------------------------------

    def serve(self, host: str = "127.0.0.1",
              port: int = 0) -> ThreadingHTTPServer:
        registry = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # route into our logger
                log.debug("http: " + fmt, *args)

            def _reply(self, code: int, body: bytes,
                       ctype: str = "application/json",
                       headers: list[tuple[str, str]] = ()) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                for name, value in headers:
                    self.send_header(name, value)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, obj) -> None:
                # follower reads carry explicit staleness marks as
                # headers (doc/ha.md); empty on a leader — the non-HA
                # wire is byte-identical
                self._reply(200, json.dumps(obj).encode(),
                            headers=registry._read_marks())

            def _not_leader(self, exc: NotLeaderError) -> None:
                """307-style leader hint: the follower refused the
                write and names where it belongs."""
                headers = ([("Location", exc.leader)] if exc.leader
                           else [])
                self._reply(307, json.dumps(
                    {"error": "not leader",
                     "leader": exc.leader}).encode(), headers=headers)

            def _body(self) -> dict:
                length = int(self.headers.get("Content-Length", "0"))
                return json.loads(self.rfile.read(length) or b"{}")

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/capacity":
                    return self._json(registry.capacity())
                if path == "/pods":
                    node = None
                    if "?" in self.path:
                        from urllib.parse import parse_qs
                        qs = parse_qs(self.path.split("?", 1)[1])
                        node = (qs.get("node") or [None])[0]
                    return self._json(registry.pods(node))
                if path == "/leases":
                    # server time in the body: doctor's clock-skew check
                    # compares it against the agent's local clock
                    return self._json({"now": registry._clock(),
                                       "leases": registry.leases()})
                if path == "/metrics":
                    return self._reply(200, registry.render_metrics().encode(),
                                       "text/plain; version=0.0.4")
                if path == "/query":
                    return self._query()
                if path == "/instances":
                    return self._json({"now": registry._clock(),
                                       "stale_after_s":
                                           registry.tsdb.stale_after_s,
                                       "instances":
                                           registry.tsdb.instances()})
                if path == "/replication":
                    return self._json(registry.replication_status())
                if path == "/replicate":
                    from urllib.parse import parse_qs
                    qs = (parse_qs(self.path.split("?", 1)[1])
                          if "?" in self.path else {})
                    stream = (qs.get("stream") or [None])[0]
                    return self._json(registry.replicate(
                        int((qs.get("cursor") or ["0"])[0]),
                        stream=stream,
                        limit=int((qs.get("limit") or ["512"])[0])))
                parts = path.strip("/").split("/")
                if len(parts) == 2 and parts[0] == "leader":
                    lead = registry.leader(parts[1])
                    return self._json(lead if lead is not None
                                      else {"domain": parts[1],
                                            "holder": "", "epoch": 0,
                                            "expired": True})
                if path == "/healthz":
                    return self._json({"ok": True})
                self._reply(404, b"{}")

            def _query(self):
                """GET /query — selector + window aggregation over the
                fleet TSDB. Query params: family (required), agg,
                window_s, by (comma-joined), q, match.<label>=<value>
                matchers; range=1 adds step_s/span_s and returns a
                point series (the --watch sparkline feed)."""
                from urllib.parse import parse_qs
                qs = (parse_qs(self.path.split("?", 1)[1])
                      if "?" in self.path else {})

                def one(key, default=None):
                    return (qs.get(key) or [default])[0]

                family = one("family")
                if not family:
                    return self._reply(400, json.dumps(
                        {"error": "family parameter required"}).encode())
                matchers = {k[6:]: v[0] for k, v in qs.items()
                            if k.startswith("match.")}
                try:
                    if one("range"):
                        res = registry.tsdb.range_query(
                            family, agg=one("agg", "sum"),
                            window_s=float(one("window_s", "60")),
                            step_s=float(one("step_s", "10")),
                            span_s=float(one("span_s", "300")),
                            matchers=matchers or None,
                            q=float(one("q", "0.99")))
                    else:
                        by = tuple(x for x in (one("by") or "").split(",")
                                   if x)
                        res = registry.tsdb.query(
                            family, agg=one("agg", "latest"),
                            window_s=float(one("window_s", "60")),
                            matchers=matchers or None, by=by,
                            q=float(one("q", "0.99")))
                except ValueError as e:
                    return self._reply(400, json.dumps(
                        {"error": str(e)}).encode())
                return self._json(res)

            def _fence(self) -> int | None:
                """Optional ?fence=<epoch> on pod writes (doc/ha.md)."""
                if "?" not in self.path:
                    return None
                from urllib.parse import parse_qs
                qs = parse_qs(self.path.split("?", 1)[1])
                fence = (qs.get("fence") or [None])[0]
                return None if fence is None else int(fence)

            def do_PUT(self):
                parts = self.path.split("?", 1)[0].strip("/").split("/")
                try:
                    return self._do_put(parts)
                except NotLeaderError as exc:
                    return self._not_leader(exc)
                except FencedWriteError as exc:
                    return self._reply(409, json.dumps(
                        {"error": "fenced", "fence": exc.fence,
                         "epoch": exc.current}).encode())

            def _do_put(self, parts):
                if len(parts) == 2 and parts[0] == "capacity":
                    body = self._body()
                    registry.put_capacity(parts[1], body.get("chips", []),
                                          bool(body.get("healthy", True)))
                    return self._json({"ok": True})
                if len(parts) == 3 and parts[0] == "pods":
                    registry.put_pod(f"{parts[1]}/{parts[2]}",
                                     self._body(), fence=self._fence())
                    return self._json({"ok": True})
                if len(parts) == 2 and parts[0] == "lease":
                    body = self._body()
                    ok, epoch = registry.put_lease(
                        parts[1], int(body.get("epoch", 0)),
                        float(body.get("ttl_s", 5.0)))
                    if not ok:
                        return self._reply(409, json.dumps(
                            {"ok": False, "epoch": epoch}).encode())
                    return self._json({"ok": True, "epoch": epoch})
                if len(parts) == 2 and parts[0] == "leader":
                    body = self._body()
                    ok, epoch, holder = registry.acquire_leader(
                        parts[1], str(body.get("holder", "")),
                        int(body.get("epoch", 0)),
                        float(body.get("ttl_s", 5.0)))
                    if not ok:
                        return self._reply(409, json.dumps(
                            {"ok": False, "epoch": epoch,
                             "holder": holder}).encode())
                    return self._json({"ok": True, "epoch": epoch,
                                       "holder": holder})
                if len(parts) == 1 and parts[0] == "push":
                    body = self._body()
                    instance = str(body.get("instance", ""))
                    if not instance:
                        return self._reply(400, json.dumps(
                            {"error": "instance required"}).encode())
                    now = body.get("now")
                    try:
                        n = registry.push_metrics(
                            instance, str(body.get("job", "")),
                            snapshot=body.get("snapshot"),
                            exposition=body.get("exposition"),
                            now=None if now is None else float(now))
                    except ValueError as e:
                        return self._reply(400, json.dumps(
                            {"error": str(e)}).encode())
                    return self._json({"ok": True, "samples": n})
                if len(parts) == 2 and parts[0] == "stale":
                    registry.mark_instance_stale(parts[1])
                    return self._json({"ok": True})
                self._reply(404, b"{}")

            do_POST = do_PUT

            def do_DELETE(self):
                parts = self.path.split("?", 1)[0].strip("/").split("/")
                try:
                    if len(parts) == 2 and parts[0] == "capacity":
                        registry.drop_capacity(parts[1])
                        return self._json({"ok": True})
                    if len(parts) == 3 and parts[0] == "pods":
                        registry.drop_pod(f"{parts[1]}/{parts[2]}",
                                          fence=self._fence())
                        return self._json({"ok": True})
                    if len(parts) == 2 and parts[0] == "lease":
                        registry.drop_lease(parts[1])
                        return self._json({"ok": True})
                except NotLeaderError as exc:
                    return self._not_leader(exc)
                except FencedWriteError as exc:
                    return self._reply(409, json.dumps(
                        {"error": "fenced", "fence": exc.fence,
                         "epoch": exc.current}).encode())
                self._reply(404, b"{}")

        server = ThreadingHTTPServer((host, port), Handler)
        server.daemon_threads = True
        threading.Thread(target=server.serve_forever, daemon=True,
                         name="telemetry-registry").start()
        self._server = server
        log.info("telemetry registry on %s:%d", *server.server_address[:2])
        return server

    @property
    def port(self) -> int:
        assert self._server is not None
        return self._server.server_address[1]

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        with self._lock:
            if self._journal is not None:
                self._journal.close()
                self._journal = None


class RegistryClient:
    """Thin HTTP client for the registry.

    Transient transport failures (connection refused during a registry
    restart, socket timeouts) are retried with jittered backoff so a
    capacity/requirement update is not silently dropped mid-push. HTTP
    error *responses* are not retried — the registry answered, and
    replaying a 4xx/5xx would not change it.

    **Failover** (doc/ha.md): pass a list of ``host:port`` endpoints
    and each transport failure rotates to the next one before the
    counted retry, with seeded jitter so a fleet of clients does not
    thunder in lockstep. A follower answering a write with a 307
    leader hint retargets the client at the leader (the follower
    refused without side effects, so the re-send is not a replay).
    Non-idempotent ops are never double-sent on an *ambiguous*
    failure — anything but a connection-refused may have reached the
    server, so they raise instead of resending. Lease beats stay on
    counted retries: the strictly-monotonic epoch protocol already
    makes a double-delivered beat safe (it is refused as a zombie and
    the next beat jumps past).
    """

    RETRY_ATTEMPTS = 3
    RETRY_BACKOFF_S = 0.05
    MAX_REDIRECTS = 2

    def __init__(self, host, port: int | None = None,
                 timeout: float = 5.0, seed: int | None = None):
        if isinstance(host, (list, tuple)):
            endpoints = list(host)
        elif port is None:
            endpoints = [str(host)]
        else:
            endpoints = [f"{host}:{port}"]
        self._bases = [e if "://" in e else f"http://{e}"
                       for e in endpoints]
        self._idx = 0
        self._timeout = timeout
        self._rng = random.Random(seed)
        self._open = urllib.request.urlopen   # injectable for tests

    @property
    def _base(self) -> str:
        """The currently preferred endpoint (back-compat accessor)."""
        return self._bases[self._idx]

    def _retarget(self, hint: str) -> None:
        base = hint if "://" in hint else f"http://{hint}"
        if base not in self._bases:
            self._bases.append(base)
        self._idx = self._bases.index(base)

    @staticmethod
    def _unambiguous(exc: Exception) -> bool:
        """True when the request provably never reached a server
        (connection refused) — the only transport failure a
        non-idempotent op may be resent after."""
        reason = getattr(exc, "reason", exc)
        return isinstance(reason, ConnectionRefusedError)

    def _fetch_raw(self, method: str, path: str, data: bytes | None,
                   op: str, idempotent: bool = True) -> bytes:
        last_exc: Exception = OSError("unreachable")
        attempt = redirects = 0
        while attempt < self.RETRY_ATTEMPTS:
            req = urllib.request.Request(self._base + path, data=data,
                                         method=method)
            if data is not None:
                req.add_header("Content-Type", "application/json")
            try:
                # control-plane fault drill: a partitioned registry looks
                # exactly like a transport failure (resilience/faults.py)
                from ..resilience import faults as _faults
                inj = _faults.active()
                if inj is not None and inj.should_partition_registry():
                    raise OSError("injected registry partition")
                with self._open(req, timeout=self._timeout) as resp:
                    return resp.read()
            except urllib.error.HTTPError as exc:
                if exc.code == 307 and redirects < self.MAX_REDIRECTS:
                    redirects += 1
                    hint = exc.headers.get("Location", "") \
                        if exc.headers else ""
                    if not hint:
                        try:
                            hint = json.loads(
                                exc.read() or b"{}").get("leader", "")
                        except ValueError:
                            hint = ""
                    if hint:
                        # the follower refused without side effects;
                        # re-sending at the leader is not a replay
                        self._retarget(hint)
                        _FAILOVERS.inc(op)
                        continue
                raise                 # the registry answered; don't replay
            except (urllib.error.URLError, OSError) as exc:
                last_exc = exc
                log.warning("registry %s %s attempt %d/%d failed: %s",
                            method, path, attempt + 1,
                            self.RETRY_ATTEMPTS, exc)
                if not idempotent and not self._unambiguous(exc):
                    raise   # may have been received: never double-send
                attempt += 1
                if len(self._bases) > 1:
                    # rotate before the backoff: the next endpoint may
                    # simply be the live one
                    self._idx = (self._idx + 1) % len(self._bases)
                    _FAILOVERS.inc(op)
                if attempt < self.RETRY_ATTEMPTS:
                    _RETRIES.inc(op)
                    time.sleep(self.RETRY_BACKOFF_S * (2 ** (attempt - 1))
                               * (0.5 + self._rng.random()))
        raise last_exc

    def _request(self, method: str, path: str, body: dict | None = None,
                 idempotent: bool = True):
        data = None if body is None else json.dumps(body).encode()
        # coarse op label (method + collection) to bound label cardinality
        op = f"{method} /{path.strip('/').split('/')[0].split('?')[0]}"
        payload = self._fetch_raw(method, path, data, op=op,
                                  idempotent=idempotent)
        return json.loads(payload) if payload else {}

    def put_capacity(self, node: str, chips: list[dict],
                     healthy: bool = True) -> None:
        self._request("PUT", f"/capacity/{node}",
                      {"chips": chips, "healthy": healthy})

    def capacity(self) -> dict[str, dict]:
        return self._request("GET", "/capacity")

    def drop_capacity(self, node: str) -> None:
        self._request("DELETE", f"/capacity/{node}")

    @staticmethod
    def _raise_fenced(exc: urllib.error.HTTPError,
                      fence: int | None) -> None:
        """Turn the registry's 409 fence refusal into the typed error
        the dispatcher freezes on (doc/ha.md); re-raise anything else."""
        if exc.code == 409 and fence is not None:
            try:
                detail = json.loads(exc.read() or b"{}")
            except ValueError:
                detail = {}
            if detail.get("error") == "fenced":
                raise FencedWriteError(int(detail.get("fence", fence)),
                                       int(detail.get("epoch", 0))) \
                    from exc
        raise exc

    def put_pod(self, key: str, record: dict,
                fence: int | None = None) -> None:
        path = f"/pods/{key}" + ("" if fence is None
                                 else f"?fence={int(fence)}")
        try:
            self._request("PUT", path, record)
        except urllib.error.HTTPError as exc:
            self._raise_fenced(exc, fence)

    def pods(self, node: str | None = None) -> dict[str, dict]:
        path = "/pods" if node is None else f"/pods?node={node}"
        return self._request("GET", path)

    def drop_pod(self, key: str, fence: int | None = None) -> None:
        path = f"/pods/{key}" + ("" if fence is None
                                 else f"?fence={int(fence)}")
        try:
            self._request("DELETE", path)
        except urllib.error.HTTPError as exc:
            self._raise_fenced(exc, fence)

    def put_lease(self, node: str, epoch: int,
                  ttl_s: float = 5.0) -> tuple[bool, int]:
        """Heartbeat; returns ``(accepted, current_epoch)``. A 409 means
        a newer epoch exists — the caller should jump past it."""
        try:
            body = self._request("PUT", f"/lease/{node}",
                                 {"epoch": int(epoch),
                                  "ttl_s": float(ttl_s)})
        except urllib.error.HTTPError as exc:
            if exc.code == 409:
                detail = json.loads(exc.read() or b"{}")
                return False, int(detail.get("epoch", epoch))
            raise
        return True, int(body.get("epoch", epoch))

    def leases(self) -> dict:
        """``{"now": server_ts, "leases": {node: {...}}}``."""
        return self._request("GET", "/leases")

    def drop_lease(self, node: str) -> None:
        self._request("DELETE", f"/lease/{node}")

    # -- leadership + replication (doc/ha.md) ------------------------------

    def acquire_leader(self, domain: str, holder: str, epoch: int,
                       ttl_s: float = 5.0) -> tuple[bool, int, str]:
        """Acquire/renew the ``leader:<domain>`` lease; a 409 carries
        the incumbent's epoch + holder as the takeover hint."""
        try:
            body = self._request("PUT", f"/leader/{domain}",
                                 {"holder": holder, "epoch": int(epoch),
                                  "ttl_s": float(ttl_s)})
        except urllib.error.HTTPError as exc:
            if exc.code == 409:
                detail = json.loads(exc.read() or b"{}")
                return (False, int(detail.get("epoch", epoch)),
                        str(detail.get("holder", "")))
            raise
        return (True, int(body.get("epoch", epoch)),
                str(body.get("holder", holder)))

    def leader(self, domain: str) -> dict | None:
        body = self._request("GET", f"/leader/{domain}")
        if not body.get("holder") and not body.get("epoch"):
            return None   # nobody ever led (in-process parity)
        return body

    def replicate(self, cursor: int = 0, stream: str | None = None,
                  limit: int = 512) -> dict:
        """One replication pull (``GET /replicate``)."""
        from urllib.parse import urlencode
        params = {"cursor": int(cursor), "limit": int(limit)}
        if stream:
            params["stream"] = stream
        return self._request("GET", "/replicate?" + urlencode(params))

    def replication(self) -> dict:
        """``GET /replication`` — role, stream position, follower lag."""
        return self._request("GET", "/replication")

    def metrics(self) -> str:
        return self._fetch_raw("GET", "/metrics", None,
                               op="GET /metrics").decode()

    # -- fleet TSDB (remote-write + query) ---------------------------------

    def push_metrics(self, instance: str, job: str,
                     snapshot: dict | None = None,
                     exposition: str | None = None,
                     now: float | None = None) -> int:
        """One remote-write push; returns the samples stored."""
        body: dict = {"instance": instance, "job": job}
        if snapshot is not None:
            body["snapshot"] = snapshot
        if exposition is not None:
            body["exposition"] = exposition
        if now is not None:
            body["now"] = float(now)
        # a push is the one append-shaped op: never resend it on an
        # ambiguous failure (the samples may already be ingested)
        res = self._request("POST", "/push", body, idempotent=False)
        return int(res.get("samples", 0))

    def query(self, family: str, agg: str = "latest",
              window_s: float = 60.0, matchers: dict | None = None,
              by=(), q: float = 0.99) -> dict:
        """``GET /query`` — one windowed aggregation across the fleet."""
        from urllib.parse import urlencode
        params = {"family": family, "agg": agg, "window_s": window_s,
                  "q": q}
        if by:
            params["by"] = ",".join(by)
        for k, v in (matchers or {}).items():
            params[f"match.{k}"] = v
        return self._request("GET", "/query?" + urlencode(params))

    def query_range(self, family: str, agg: str = "sum",
                    window_s: float = 60.0, step_s: float = 10.0,
                    span_s: float = 300.0,
                    matchers: dict | None = None,
                    q: float = 0.99) -> dict:
        from urllib.parse import urlencode
        params = {"family": family, "agg": agg, "window_s": window_s,
                  "step_s": step_s, "span_s": span_s, "q": q, "range": 1}
        for k, v in (matchers or {}).items():
            params[f"match.{k}"] = v
        return self._request("GET", "/query?" + urlencode(params))

    def instances(self) -> dict:
        """``{"now", "stale_after_s", "instances": [...]}`` — push
        freshness per known instance (doctor's freshness probe)."""
        return self._request("GET", "/instances")

    def mark_stale(self, instance: str) -> None:
        """Retire an instance's series now (clean shutdown)."""
        self._request("POST", f"/stale/{instance}")


def main(argv=None) -> None:
    """``python -m kubeshare_tpu_torch.telemetry.registry [--port N]
    [--journal PATH] [--follower-of HOST:PORT[,...]]`` — serve the
    registry; prints ``READY <port>`` once it listens, and stops on
    SIGTERM or SIGINT. A follower tails the leader's op stream, answers
    writes 307 to the leader, and is promoted to a writable leader by
    SIGHUP. Every handler is in place before ``READY``."""
    import argparse
    import signal

    from .. import constants as C
    from ..utils import ready_until_signal

    parser = argparse.ArgumentParser(
        prog="kubeshare_tpu_torch.telemetry.registry")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=C.REGISTRY_PORT,
                        help="0 picks a free port (printed with READY)")
    parser.add_argument("--journal", default="",
                        help="JSONL journal path; state survives restarts "
                             "when set (mount a PVC/hostPath there)")
    parser.add_argument("--follower-of", default="",
                        help="run as a replication follower tailing this "
                             "leader registry ('host:port' or a comma-"
                             "separated list, doc/ha.md): reads answer "
                             "with staleness marks, writes 307 to the "
                             "leader; SIGHUP promotes to writable leader")
    parser.add_argument("--replication-poll", type=float, default=0.5,
                        help="follower pull period in seconds")
    args = parser.parse_args(argv)

    registry = TelemetryRegistry(journal=args.journal or None)
    follower = None
    if args.follower_of:
        from ..ha import ReplicationFollower

        endpoints = [h.strip() for h in args.follower_of.split(",")
                     if h.strip()]
        source = RegistryClient(
            endpoints if len(endpoints) > 1 else endpoints[0])
        follower = ReplicationFollower(
            registry, source, leader_hint=endpoints[0],
            poll_s=args.replication_poll).start()
        # the promotion joins the pull thread: run it off the handler
        signal.signal(signal.SIGHUP, lambda *a: threading.Thread(
            target=follower.promote, name="ha-promote").start())
    registry.serve(args.host, args.port)
    try:
        ready_until_signal(f"READY {registry.port}")
    finally:
        if follower is not None:
            follower.stop()
        registry.close()


if __name__ == "__main__":
    main()
