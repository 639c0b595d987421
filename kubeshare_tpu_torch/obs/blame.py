"""Blame graph: who made a grant wait, for how long, on which device —
the port's copy of ``kubeshare_tpu/obs/blame.py``.

For every grant that waited, the wait window ``[granted_at - wait_s,
granted_at]`` is joined against the chip-time ledger (:mod:`.ledger`):
each occupied interval overlapping the window attributes its overlap to
the tenant that held the device, producing ``(victim_tenant,
blamed_tenant, chip)`` wait-second edges with trace-id exemplars. Free
time inside the window (scheduler gaps, window-cap throttling against
the victim's own limit) stays unattributed — blame only names tenants
that actually occupied the device. Paused windows (migration flips) are
attributed to the ``(migration)`` pseudo-tenant.

Edges carry a *kind*: ``hold`` (ordinary occupancy), ``migration`` (the
pseudo-tenant), or ``preempted`` — the blamed tenant's occupancy
overlapped ledger intervals tagged preempted, i.e. the holder had
already been marked and was draining to a program boundary for you.

The aggregate rides the metric family
``kubeshare_blame_wait_seconds_total``, and counter deltas feed the
flight recorder's rate-limited per-subsystem samples so an SLO-alert
dump carries the contention picture at firing time.
"""

from __future__ import annotations

import threading
from collections import deque

from . import metrics as obs_metrics
from .flight import default_recorder as flight_default_recorder
from .ledger import OCCUPIED_STATES, default_ledger

#: pseudo-tenant blamed for wait time spent under a migration pause
MIGRATION = "(migration)"

_MAX_EXEMPLARS = 4

_OBS = obs_metrics.default_registry()
_BLAME = _OBS.counter(
    "kubeshare_blame_wait_seconds_total",
    "Grant-wait seconds attributed to the tenant that occupied the chip "
    "during the victim's wait (contention blame edges).",
    labels=("victim", "blamed", "chip"))


class BlameGraph:
    """Aggregated wait attribution over a :class:`ChipTimeLedger`."""

    def __init__(self, ledger=None):
        self.ledger = ledger if ledger is not None else default_ledger()
        self._lock = threading.Lock()
        #: (victim, blamed, chip) -> edge record
        self._edges: dict[tuple, dict] = {}
        #: victim -> {"waited_s", "attributed_s", "waits"}
        self._victims: dict[str, dict] = {}
        self._attributed_s = 0.0
        self._waits = 0

    # -- ingestion ----------------------------------------------------

    def account_wait(self, chip: str, victim: str, tpu_class: str,
                     wait_s: float, now: float, trace_id: str = "",
                     granted: bool = True) -> list[tuple[str, float]]:
        """Attribute one grant wait (or timeout, ``granted=False``) that
        ended at *now* after blocking *wait_s* seconds. Returns the
        ``(blamed, seconds)`` attribution for the caller/tests."""
        if wait_s <= 0.0:
            return []
        rows = self.ledger.account(chip, now - wait_s, now, now=now)
        blamed_secs: dict[str, float] = {}
        preempted_secs: dict[str, float] = {}
        gangs: dict[str, str] = {}
        for row in rows:
            if row["state"] in OCCUPIED_STATES:
                tenant = row["tenant"]
                if not tenant or tenant == victim:
                    continue
            elif row["state"] == "paused":
                tenant = MIGRATION
            else:
                continue
            blamed_secs[tenant] = (blamed_secs.get(tenant, 0.0)
                                   + row["overlap_s"])
            if row.get("preempted"):
                preempted_secs[tenant] = (preempted_secs.get(tenant, 0.0)
                                          + row["overlap_s"])
            if row.get("gang"):
                gangs[tenant] = row["gang"]
        with self._lock:
            self._waits += 1
            vic = self._victims.setdefault(
                victim, {"waited_s": 0.0, "attributed_s": 0.0,
                         "waits": 0, "timeouts": 0})
            vic["waited_s"] += wait_s
            vic["waits"] += 1
            if not granted:
                vic["timeouts"] += 1
            for blamed, secs in blamed_secs.items():
                vic["attributed_s"] += secs
                self._attributed_s += secs
                edge = self._edges.setdefault(
                    (victim, blamed, chip),
                    {"wait_s": 0.0, "preempted_s": 0.0, "count": 0,
                     "exemplars": deque(maxlen=_MAX_EXEMPLARS),
                     "gangs": set()})
                edge["wait_s"] += secs
                edge["preempted_s"] += preempted_secs.get(blamed, 0.0)
                edge["count"] += 1
                if trace_id:
                    edge["exemplars"].append(trace_id)
                if blamed in gangs:
                    edge["gangs"].add(gangs[blamed])
            attributed = self._attributed_s
            n_edges = len(self._edges)
            n_waits = self._waits
        for blamed, secs in blamed_secs.items():
            _BLAME.inc(victim, blamed, chip, amount=secs)
        # black-box cadence (rate-limited inside): the contention state
        # in the run-up to an SLO alert firing
        flight_default_recorder().sample_deltas("contention", {
            "blame_wait_s": attributed,
            "blame_edges": float(n_edges),
            "waits_attributed": float(n_waits),
        })
        return sorted(blamed_secs.items(), key=lambda kv: -kv[1])

    # -- queries ------------------------------------------------------

    def edges(self) -> list[dict]:
        """All blame edges, heaviest first. ``kind`` distinguishes
        ordinary holds from migration pauses and preempted drains."""
        with self._lock:
            out = [{
                "victim": victim, "blamed": blamed, "chip": chip,
                "wait_s": round(rec["wait_s"], 6),
                "preempted_s": round(rec.get("preempted_s", 0.0), 6),
                "kind": ("migration" if blamed == MIGRATION
                         else "preempted"
                         if rec.get("preempted_s", 0.0) > 0.0
                         else "hold"),
                "count": rec["count"],
                "gangs": sorted(rec["gangs"]),
                "trace_ids": list(rec["exemplars"]),
            } for (victim, blamed, chip), rec in self._edges.items()]
        out.sort(key=lambda e: -e["wait_s"])
        return out

    def top_blamed(self, victim: str | None = None,
                   n: int = 5) -> list[dict]:
        """Blamed tenants ranked by attributed seconds, optionally for
        one victim."""
        agg: dict[str, dict] = {}
        for e in self.edges():
            if victim is not None and e["victim"] != victim:
                continue
            rec = agg.setdefault(e["blamed"], {
                "blamed": e["blamed"], "wait_s": 0.0,
                "preempted_s": 0.0, "count": 0,
                "chips": set(), "gangs": set(), "trace_ids": []})
            rec["wait_s"] += e["wait_s"]
            rec["preempted_s"] += e["preempted_s"]
            rec["count"] += e["count"]
            rec["chips"].add(e["chip"])
            rec["gangs"].update(e["gangs"])
            rec["trace_ids"].extend(e["trace_ids"])
        total = sum(r["wait_s"] for r in agg.values()) or 1.0
        out = []
        for rec in sorted(agg.values(), key=lambda r: -r["wait_s"])[:n]:
            out.append({
                "blamed": rec["blamed"],
                "wait_s": round(rec["wait_s"], 6),
                "preempted_s": round(rec["preempted_s"], 6),
                "share": round(rec["wait_s"] / total, 4),
                "count": rec["count"],
                "chips": sorted(rec["chips"]),
                "gangs": sorted(rec["gangs"]),
                "trace_ids": rec["trace_ids"][-_MAX_EXEMPLARS:],
            })
        return out

    def victims(self) -> dict[str, dict]:
        with self._lock:
            return {v: dict(rec) for v, rec in self._victims.items()}

    def total_attributed_s(self) -> float:
        with self._lock:
            return self._attributed_s

    def state(self) -> dict:
        """JSON view: edges, per-victim totals and the attributed sum."""
        return {
            "edges": self.edges(),
            "victims": {v: {k: (round(val, 6)
                               if isinstance(val, float) else val)
                            for k, val in rec.items()}
                        for v, rec in self.victims().items()},
            "waits_attributed": self._waits,
            "attributed_s": round(self.total_attributed_s(), 6),
        }


_default_lock = threading.Lock()
_default: BlameGraph | None = None


def default_blame() -> BlameGraph:
    """Process-global blame graph over the default ledger."""
    global _default
    with _default_lock:
        if _default is None:
            _default = BlameGraph(default_ledger())
        return _default
