"""``kubeshare-top``: live fleet view from the telemetry registry.

The port's copy of ``kubeshare_tpu/topcli.py``.

The reference has no operator console — fleet state lives across
Prometheus queries and ``kubectl describe`` (``pkg/collector``,
``pkg/aggregator``). Here the registry already holds both sides of the
story (capacity from collectors, requirements from the scheduler bridge,
``aggregator.go:22-39`` parity), so one read renders the whole fleet:
per-chip bookings, free fractions, and the pods on each chip.

Usage::

    python -m kubeshare_tpu_torch.topcli [--registry HOST:PORT] [--node N]
                                   [--scheduler HOST:PORT]
                                   [--watch SECONDS] [--json] [--latency]
                                   [--health] [--autopilot] [--rightsize]
                                   [--serving] [--gangs] [--fleet]
                                   [--why TARGET]
                                   [--critpath --spans PATH ...]

One-shot by default (script-friendly); ``--watch`` refreshes in place.
``--latency`` switches from the fleet table to the self-observability
view: phase-latency percentiles (p50/p90/p99 from the exposition's
histogram buckets, ``doc/observability.md``) plus per-chip token
utilization — scraped from the scheduler's ``/metrics`` when
``--scheduler`` is given, else the registry's. Under ``--watch`` the
scrapes feed a local :class:`~kubeshare_tpu_torch.obs.tsdb.TimeSeriesStore`
so percentiles come from *windowed* bucket increases — immune to the
negative-delta artifacts raw cumulative buckets show across a proxy
restart.
``--fleet`` renders the remote-write telemetry plane
(``doc/observability.md``): per-instance push freshness from the
registry's ``/instances`` plus fleet-wide windowed aggregations, each
one ``GET /query`` evaluated registry-side over every live instance —
not N per-process scrapes. Under ``--watch``, range queries add
sparkline history.
``--critpath`` is offline: it assembles spans sharing a trace ID from
``--spans`` files/dirs (tracer JSONL exports, flight-recorder dumps)
and attributes each traced request's wall time to named segments
(``obs/critpath.py``).
``--health`` renders the liveness plane (``doc/health.md``): per-node
lease age and health state (+ time since the last transition), joined
from the registry's ``/leases`` and — when ``--scheduler`` is given —
the scheduler's ``/health`` (state machine, shed/evicted totals).
``--autopilot`` renders the placement-optimization plane
(``doc/autopilot.md``): cluster fragmentation score, pending/applied
moves and per-chip burst credits from the scheduler's ``/autopilot``,
joined with the registry's capacity and lease views.
``--rightsize`` renders the capacity rightsizer (``doc/autopilot.md``,
Rightsizing): per-tenant SLO burn vs budget, current/proposed/declared
share and the controller's decision reason from the scheduler's
``/rightsize``, plus pending resizes and pack moves.
``--serving`` renders the inference front door (``doc/serving.md``):
per-tenant queue depth, admit/shed totals and request p50/p99 from the
scheduler's ``/serving``, joined with the registry's capacity view.
``--gangs`` renders the gang isolation plane (``doc/gang.md``): each
co-scheduled gang's membership, grant state, and gang grant-wait
p50/p99 from the scheduler's ``/gangs``.
``--why POD_OR_TENANT`` renders the contention-attribution report
(``doc/observability.md``): the scheduler's ``/ledger`` chip-time
intervals and blame edges joined with SLO burn state, gang pause
windows and eviction history — a ranked "your waits went to tenant Y
holding chip Z for W seconds" explanation.
Exit 0 on a healthy read, 2 when the registry is unreachable.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error

from . import constants as C
from .telemetry.registry import RegistryClient


def snapshot(client: RegistryClient, node: str | None = None,
             scheduler=None) -> dict:
    """One coherent fleet view: capacity + pods joined per chip (pods
    filtered server-side via ``/pods?node=``). With a scheduler client,
    outstanding preemption requests annotate their victims."""
    capacity = client.capacity()
    pods = client.pods(node)
    evictions: list = []
    if scheduler is not None:
        try:
            evictions = scheduler.evictions()
        except Exception as exc:
            # render the fleet anyway, but say the markers are missing —
            # a silently-dead scheduler endpoint would hide in-flight
            # preemptions for the whole session
            print(f"kubeshare-top: scheduler unreachable ({exc}) — "
                  "eviction markers unavailable", file=sys.stderr)
    if node is not None:
        capacity = {n: v for n, v in capacity.items() if n == node}
        evictions = [e for e in evictions if e.get("node") == node]
    evicting = {e.get("victim"): e.get("preemptor", "?")
                for e in evictions}

    now = time.time()
    nodes = []
    by_chip: dict[str, list] = {}
    for key, rec in sorted(pods.items()):
        for chip in filter(None, rec.get("chip_id", "").split(",")):
            by_chip.setdefault(chip, []).append((key, rec))

    total_chips = booked_total = 0
    for name, entry in sorted(capacity.items()):
        chips = []
        for labels in entry.get("chips", []):
            cid = labels.get("chip_id", "?")
            residents = by_chip.get(cid, [])
            # a fractional pod books its request on its one chip; a
            # whole-chip (integer) pod books 1.0 on EACH listed chip
            booked = sum(min(float(r.get("request", 0) or 0), 1.0)
                         for _, r in residents)
            chips.append({
                "chip_id": cid,
                "model": labels.get("model", "?"),
                "memory_gib": int(labels.get("memory", 0) or 0) >> 30,
                "coords": labels.get("coords", ""),
                "booked": round(booked, 3),
                "free": round(max(0.0, 1.0 - booked), 3),
                "pods": [{"key": k,
                          "request": r.get("request", "?"),
                          "limit": r.get("limit", "?"),
                          "priority": r.get("priority", "0"),
                          "group": r.get("group_name", ""),
                          "evicting_for": evicting.get(k, "")}
                         for k, r in residents],
            })
            total_chips += 1
            booked_total += booked
        nodes.append({"node": name,
                      "healthy": bool(entry.get("healthy", True)),
                      "age_s": round(now - entry.get("ts", now), 1),
                      "chips": chips})
    groups = {r.get("group_name") for r in pods.values()
              if r.get("group_name")}
    return {"nodes": nodes,
            "evictions": evictions,
            "fleet": {"chips": total_chips,
                      "booked": round(booked_total, 3),
                      "pods": len(pods), "gangs": len(groups),
                      "evicting": len(evictions)}}


def health_snapshot(client: RegistryClient, scheduler=None) -> dict:
    """Liveness join: registry leases (ground truth for age, computed on
    the registry's clock) + scheduler health states when reachable."""
    raw = client.leases()
    leases = raw.get("leases", raw) if isinstance(raw, dict) else {}
    sched: dict = {}
    if scheduler is not None:
        try:
            sched = scheduler.health()
        except Exception as exc:
            print(f"kubeshare-top: scheduler unreachable ({exc}) — "
                  "health states unavailable, showing raw leases",
                  file=sys.stderr)
    states = sched.get("nodes", {})
    nodes = []
    for name in sorted(set(leases) | set(states)):
        lease = leases.get(name, {})
        st = states.get(name, {})
        nodes.append({
            "node": name,
            "state": st.get("state", "unmonitored"),
            "lease_age_s": round(float(lease.get(
                "age_s", st.get("lease_age_s", 0.0))), 3),
            "ttl_s": lease.get("ttl_s"),
            "epoch": lease.get("epoch", st.get("epoch", 0)),
            "since_s": st.get("since_s"),
        })
    return {"nodes": nodes,
            "enabled": sched.get("enabled"),
            "quarantined": sched.get("quarantined", []),
            "evicted_total": sched.get("evicted_total", 0),
            "shed_total": sched.get("shed_total", 0),
            "pending": sched.get("pending"),
            "max_pending": sched.get("max_pending")}


def render_health(snap: dict) -> str:
    lines = ["HEALTH (lease liveness, doc/health.md)"]
    if not snap["nodes"]:
        lines.append("  no leases published — node agents are not "
                     "heartbeating (launcherd --registry-host)")
    else:
        lines.append(f"  {'node':<24} {'state':<12} {'lease age':>10} "
                     f"{'ttl':>6} {'epoch':>7} {'since':>8}")
        for n in snap["nodes"]:
            ttl = f"{n['ttl_s']:.0f}s" if n.get("ttl_s") else "-"
            since = (f"{n['since_s']:.0f}s" if n.get("since_s") is not None
                     else "-")
            lines.append(
                f"  {n['node']:<24} {n['state']:<12} "
                f"{n['lease_age_s']:>9.1f}s {ttl:>6} {n['epoch']:>7} "
                f"{since:>8}")
    if snap.get("enabled") is not None:
        pend = (f"{snap['pending']}/{snap['max_pending']}"
                if snap.get("max_pending") else f"{snap.get('pending', 0)}")
        lines.append(
            f"SCHEDULER: health plane "
            f"{'on' if snap['enabled'] else 'off'}, "
            f"{snap['evicted_total']} evicted, {snap['shed_total']} shed, "
            f"pending {pend}"
            + (", quarantined: " + ", ".join(snap["quarantined"])
               if snap.get("quarantined") else ""))
    return "\n".join(lines)


def autopilot_snapshot(client: RegistryClient, scheduler=None) -> dict:
    """Autopilot join (doc/autopilot.md): the scheduler's ``/autopilot``
    state (fragmentation, pending/applied moves, burst credits) over the
    registry's per-chip capacity + lease view, so each chip row shows
    its booked fraction, resident pods, lease age, and active credit."""
    state: dict = {}
    if scheduler is not None:
        try:
            state = scheduler.autopilot()
        except Exception as exc:
            print(f"kubeshare-top: scheduler unreachable ({exc}) — "
                  "autopilot state unavailable, showing capacity only",
                  file=sys.stderr)
    capacity = client.capacity()
    pods = client.pods()
    try:
        raw = client.leases()
        leases = raw.get("leases", raw) if isinstance(raw, dict) else {}
    except Exception:
        leases = {}
    by_chip: dict[str, list] = {}
    for key, rec in sorted(pods.items()):
        for chip in filter(None, rec.get("chip_id", "").split(",")):
            by_chip.setdefault(chip, []).append((key, rec))
    credits = (state.get("burst_credits") or {}).get("chips", {})
    chips = []
    for node, entry in sorted(capacity.items()):
        lease = leases.get(node, {})
        for labels in entry.get("chips", []):
            cid = labels.get("chip_id", "?")
            residents = by_chip.get(cid, [])
            booked = sum(min(float(r.get("request", 0) or 0), 1.0)
                         for _, r in residents)
            chip_credits = credits.get(cid, {})
            chips.append({
                "chip_id": cid,
                "node": node,
                "lease_age_s": round(float(lease.get("age_s", 0.0)), 1),
                "booked": round(booked, 3),
                "free": round(max(0.0, 1.0 - booked), 3),
                "pods": [k for k, _ in residents],
                "credits": {name: cr.get("amount", 0.0)
                            for name, cr in chip_credits.items()},
            })
    return {"autopilot": state or {"attached": False, "enabled": False},
            "chips": chips,
            "pending_moves": state.get("pending_moves", []),
            }


def render_autopilot(snap: dict) -> str:
    ap = snap["autopilot"]
    lines = ["AUTOPILOT (placement optimization, doc/autopilot.md)"]
    if not ap.get("attached"):
        lines.append("  not attached — start the scheduler with "
                     "--autopilot (or attach_autopilot)")
    else:
        lines.append(
            f"  {'enabled' if ap.get('enabled') else 'DISABLED'}  "
            f"fragmentation {ap.get('fragmentation', 0.0):.4f}  "
            f"largest placeable gang {ap.get('largest_placeable_gang', 0)}  "
            f"cycles {ap.get('cycles', 0)}")
        lines.append(
            f"  moves: {ap.get('applied_total', 0)} applied, "
            f"{ap.get('rolled_back_total', 0)} rolled back, "
            f"{len(snap.get('pending_moves', []))} pending")
        bc = ap.get("burst_credits") or {}
        if bc:
            lines.append(
                f"  elastic: {bc.get('reclaimed_ms', 0.0):.0f} device-ms "
                f"reclaimed, {bc.get('revocations', 0)} revocations")
        if ap.get("recovered"):
            rec = ap["recovered"]
            lines.append(
                f"  RECOVERED batch {rec.get('batch')}: "
                f"{len(rec.get('completed', []))} completed, "
                f"{len(rec.get('abandoned', []))} abandoned "
                "(source authoritative)")
    for mv in snap.get("pending_moves", []):
        lines.append(f"  plan: {mv.get('pod')}  {mv.get('from')} -> "
                     f"{mv.get('node')}"
                     + (f"  [gang {mv['group']}]" if mv.get("group")
                        else ""))
    if snap["chips"]:
        lines.append(f"  {'chip':<28} {'node':<18} {'lease':>7} "
                     f"{'booked':>7} {'free':>6}  credits")
        for c in snap["chips"]:
            credit = ", ".join(f"{name}+{amt:.2f}"
                               for name, amt in sorted(c["credits"].items()))
            lines.append(
                f"  {c['chip_id']:<28} {c['node']:<18} "
                f"{c['lease_age_s']:>6.1f}s {c['booked']:>7} "
                f"{c['free']:>6}  {credit or '-'}")
    return "\n".join(lines)


def rightsize_snapshot(client: RegistryClient, scheduler=None) -> dict:
    """Rightsizer join (doc/autopilot.md, Rightsizing): the scheduler's
    ``/rightsize`` state — per-tenant burn vs budget, current/proposed
    share, decision reason — over the registry's capacity view, so the
    share the controller wants and the chips it would free are one
    frame."""
    state: dict = {}
    if scheduler is not None:
        try:
            state = scheduler.rightsize()
        except Exception as exc:
            print(f"kubeshare-top: scheduler unreachable ({exc}) — "
                  "rightsize state unavailable, showing capacity only",
                  file=sys.stderr)
    chips = 0
    booked_total = 0.0
    try:
        capacity = client.capacity()
        pods = client.pods()
        chips = sum(len(e.get("chips", [])) for e in capacity.values())
        booked_total = sum(min(float(r.get("request", 0) or 0), 1.0)
                           for r in pods.values())
    except Exception:
        pass
    return {"rightsize": state or {"attached": False, "enabled": False},
            "chips": chips, "booked_total": round(booked_total, 3)}


def render_rightsize(snap: dict) -> str:
    rz = snap["rightsize"]
    lines = ["RIGHTSIZE (SLO-driven capacity rightsizer, "
             "doc/autopilot.md)"]
    if not rz.get("attached"):
        lines.append("  not attached — start the scheduler with "
                     "--rightsize (or attach_rightsize)")
        if snap.get("chips"):
            lines.append(f"  fleet: {snap['chips']} chips, "
                         f"{snap['booked_total']} chip-equivalents "
                         "booked (static)")
        return "\n".join(lines)
    eq = rz.get("chip_equivalents") or {}
    lines.append(
        f"  {'enabled' if rz.get('enabled') else 'DISABLED'}  "
        f"cycles {rz.get('cycles', 0)}  resizes: "
        f"{rz.get('applied_total', 0)} applied, "
        f"{rz.get('rolled_back_total', 0)} rolled back")
    if eq:
        lines.append(
            f"  chip-equivalents: declared {eq.get('declared', 0.0):g}  "
            f"booked {eq.get('current', 0.0):g}  "
            f"proposed {eq.get('proposed', 0.0):g}")
    tenants = rz.get("tenants") or {}
    if tenants:
        lines.append(
            f"  {'tenant':<20} {'share':>7} {'proposed':>9} "
            f"{'declared':>9} {'burn f/s':>12} {'budget':>7} "
            f"{'idle':>5}  reason")
        for name in sorted(tenants):
            t = tenants[name]
            burn = (f"{t.get('burn_fast', 0.0):.1f}/"
                    f"{t.get('burn_slow', 0.0):.1f}")
            flag = "!" if t.get("firing") else " "
            lines.append(
                f" {flag}{name:<20} {t.get('share', 0.0):>7g} "
                f"{t.get('proposed', 0.0):>9g} "
                f"{t.get('declared', 0.0):>9g} {burn:>12} "
                f"{t.get('budget_remaining', 1.0):>7.2f} "
                f"{t.get('idle_frac', 0.0):>5.2f}  "
                f"{t.get('reason') or '-'}")
    for r in rz.get("pending_resizes", []):
        lines.append(
            f"  plan: {r.get('pod')}  {r.get('from'):g} -> "
            f"{r.get('to'):g}  [{r.get('direction')}: "
            f"{r.get('reason')}]"
            + (f"  (gang {r['gang']})" if r.get("gang") else ""))
    for mv in rz.get("pending_moves", []):
        lines.append(f"  pack: {mv.get('pod')}  {mv.get('from')} -> "
                     f"{mv.get('node')}")
    return "\n".join(lines)


def elastic_snapshot(client: RegistryClient, scheduler=None) -> dict:
    """Elastic training-plane join (doc/elastic.md): the scheduler's
    ``/elastic`` state — per-gang mesh shape, last resize, pause
    percentiles — over the registry's capacity view, so the sub-mesh a
    gang runs on and the fleet it could grow into are one frame."""
    state: dict = {}
    if scheduler is not None:
        try:
            state = scheduler.elastic()
        except Exception as exc:
            print(f"kubeshare-top: scheduler unreachable ({exc}) — "
                  "elastic state unavailable, showing capacity only",
                  file=sys.stderr)
    chips = 0
    try:
        capacity = client.capacity()
        chips = sum(len(e.get("chips", [])) for e in capacity.values())
    except Exception:
        pass
    return {"elastic": state or {"attached": False, "enabled": False},
            "chips": chips}


def render_elastic(snap: dict) -> str:
    el = snap["elastic"]
    lines = ["ELASTIC (live gang sub-mesh resize, doc/elastic.md)"]
    if not el.get("attached"):
        lines.append("  not attached — start the scheduler with "
                     "--elastic (or attach_elastic)")
        if snap.get("chips"):
            lines.append(f"  fleet: {snap['chips']} chips")
        return "\n".join(lines)
    by = el.get("by_outcome") or {}
    outcomes = "  ".join(f"{k} {v}" for k, v in sorted(by.items()))
    lines.append(
        f"  {'enabled' if el.get('enabled') else 'DISABLED'}  "
        f"resizes {el.get('resizes_total', 0)}"
        + (f"  ({outcomes})" if outcomes else ""))
    gangs = el.get("gangs") or {}
    if gangs:
        lines.append(
            f"  {'gang':<24} {'chips':>5} {'members':>7} "
            f"{'pause p50/p99 ms':>17}  last resize")
        for name in sorted(gangs):
            g = gangs[name]
            last = g.get("last_resize") or {}
            if last:
                desc = (f"{last.get('from_chips', '?')} -> "
                        f"{last.get('to_chips', '?')} "
                        f"[{last.get('outcome')}"
                        + (f": {last['reason']}"
                           if last.get("reason") else "") + "]")
            else:
                desc = "-"
            lines.append(
                f"  {name:<24} {g.get('chips', 0):>5} "
                f"{g.get('members', 0):>7} "
                f"{g.get('pause_p50_ms', 0.0):>8.1f}/"
                f"{g.get('pause_p99_ms', 0.0):<8.1f}  {desc}")
        for name in sorted(gangs):
            layout = gangs[name].get("layout")
            if layout:
                lines.append(f"  mesh {name}: {layout}")
    cooling = (el.get("cooldowns") or {}).get("cooling") or {}
    if cooling:
        lines.append("  cooling: " + ", ".join(
            f"{k} ({v:.0f}s)" for k, v in sorted(cooling.items())))
    return "\n".join(lines)


def serving_snapshot(client: RegistryClient, scheduler=None) -> dict:
    """Serving join (doc/serving.md): the scheduler's ``/serving`` view
    (per-tenant queue depth, admit/shed totals, p50/p99) over the
    registry's capacity view, so operators see the front door and the
    fleet it is carving batches out of in one frame."""
    state: dict = {}
    if scheduler is not None:
        try:
            state = scheduler.serving()
        except Exception as exc:
            print(f"kubeshare-top: scheduler unreachable ({exc}) — "
                  "serving state unavailable, showing capacity only",
                  file=sys.stderr)
    try:
        capacity = client.capacity()
        chips = sum(len(e.get("chips", [])) for e in capacity.values())
    except Exception:
        chips = 0
    return {"serving": state or {"attached": False},
            "chips": chips}


def render_serving(snap: dict) -> str:
    sv = snap["serving"]
    lines = ["SERVING (continuous-batching front door, doc/serving.md)"]
    if not sv.get("attached"):
        lines.append("  not attached — run a serving front door and "
                     "attach_serving() it to the scheduler")
        return "\n".join(lines)
    tot = sv.get("totals", {})
    lines.append(
        f"  {tot.get('admitted', 0)} admitted / {tot.get('shed', 0)} "
        f"shed / {tot.get('completed', 0)} completed  "
        f"queued {tot.get('queued', 0)}  "
        f"batches {sv.get('batches', 0)} "
        f"(mean {sv.get('mean_batch_rows', 0.0):.1f} rows)"
        + (f"  over {snap['chips']} chip(s)" if snap.get("chips")
           else ""))
    bt = sv.get("batcher") or {}
    if bt:
        lines.append(
            f"  knobs: max_batch {bt.get('max_batch')}  "
            f"max_wait {_fmt_seconds(float(bt.get('max_wait_s', 0.0)))}  "
            f"executions {bt.get('executions', 0)}")
    tenants = sv.get("tenants", {})
    if tenants:
        lines.append(f"  {'tenant':<20} {'class':<12} {'queued':>6} "
                     f"{'admit':>6} {'shed':>5} {'done':>6} "
                     f"{'tokens':>7} {'p50':>8} {'p99':>8}")
        for name in sorted(tenants):
            t = tenants[name]
            lines.append(
                f"  {name:<20} {t.get('class', '?'):<12} "
                f"{t.get('queued', 0):>6} {t.get('admitted', 0):>6} "
                f"{t.get('shed', 0):>5} {t.get('completed', 0):>6} "
                f"{t.get('tokens', 0):>7} "
                f"{_fmt_seconds(t.get('p50_ms', 0.0) / 1e3):>8} "
                f"{_fmt_seconds(t.get('p99_ms', 0.0) / 1e3):>8}")
    return "\n".join(lines)


#: (label, family, agg, q, unit) — the fleet-wide aggregations the
#: --fleet view evaluates, one GET /query each, registry-side
FLEET_PANELS = (
    ("rpc p50", "kubeshare_proxy_rpc_latency_seconds",
     "quantile", 0.50, "s"),
    ("rpc p99", "kubeshare_proxy_rpc_latency_seconds",
     "quantile", 0.99, "s"),
    ("rpc rate", "kubeshare_proxy_rpc_latency_seconds_count",
     "rate", None, "/s"),
    ("queue wait p99", "kubeshare_sched_queue_wait_seconds",
     "quantile", 0.99, "s"),
    ("token util avg", "kubeshare_token_utilization_ratio",
     "avg", None, "ratio"),
    ("pending pods", "kubeshare_scheduler_pending_pods",
     "sum", None, ""),
    ("gang wait p99", "kubeshare_gang_grant_wait_seconds",
     "quantile", 0.99, "s"),
    ("blame wait rate", "kubeshare_blame_wait_seconds_total",
     "rate", None, "s/s"),
)

#: (label, family, agg, q, group_label, unit) — the --fleet GANGS panel
#: (the gang grant families, grouped per gang registry-side)
FLEET_GANG_PANELS = (
    ("wait p99", "kubeshare_gang_grant_wait_seconds",
     "quantile", 0.99, "gang", "s"),
    ("partials", "kubeshare_gang_partial_releases_total",
     "increase", None, "gang", ""),
    ("paused", "kubeshare_gang_paused",
     "latest", None, "gang", ""),
)

#: (label, family, agg, q, group_label, unit) — the --fleet PREEMPT
#: panel (the preemption families, grouped per chip registry-side)
FLEET_PREEMPT_PANELS = (
    ("preempts", "kubeshare_preempt_total",
     "increase", None, "chip", ""),
    ("yield p99", "kubeshare_preempt_yield_seconds",
     "quantile", 0.99, "chip", "s"),
    ("boosts", "kubeshare_preempt_boost_grants_total",
     "increase", None, "chip", ""),
)

#: (label, family, agg, q, group_label, unit) — the --fleet RIGHTSIZE
#: panel (the rightsizer's metric families, doc/autopilot.md: live
#: chip-equivalents by view, per-tenant slow burn, resize dispositions)
FLEET_RIGHTSIZE_PANELS = (
    ("chip-equiv", "kubeshare_rightsize_chip_equivalents",
     "latest", None, "view", ""),
    ("burn slow", "kubeshare_rightsize_burn_slow",
     "latest", None, "tenant", ""),
    ("resizes", "kubeshare_rightsize_resizes_total",
     "increase", None, "outcome", ""),
)

#: (label, family, agg, q, group_label, unit) — the --fleet LOCKS panel
#: (contention profiler families, grouped per tracked lock; the
#: control-plane analogue of CONTENTION's chip-time blame)
FLEET_LOCK_PANELS = (
    ("wait s/s", "kubeshare_lock_waited_seconds_total",
     "rate", None, "lock", "s/s"),
    ("hold p99", "kubeshare_lock_hold_seconds",
     "quantile", 0.99, "lock", "s"),
    ("contended", "kubeshare_lock_contended_total",
     "increase", None, "lock", ""),
)

#: (label, family, agg) — panels that get sparkline history in --watch
FLEET_SPARKS = (
    ("rpc rate", "kubeshare_proxy_rpc_latency_seconds_count", "rate"),
    ("pending pods", "kubeshare_scheduler_pending_pods", "sum"),
    # replication staleness across takeovers (doc/ha.md); renders '·'
    # until an HA follower pushes the family
    ("repl lag p99", "kubeshare_ha_replication_lag_seconds", "quantile"),
)

#: (label, family, agg, group_label) — the --fleet HA panel
#: (doc/ha.md): who holds leader:scheduler, at what epoch, takeovers
#: in the window, and when leadership last moved — per instance
FLEET_HA_PANELS = (
    ("leader", "kubeshare_ha_leader", "latest", "instance"),
    ("epoch", "kubeshare_ha_epoch", "latest", "instance"),
    ("takeovers", "kubeshare_ha_takeovers_total", "increase", "instance"),
    ("last takeover", "kubeshare_ha_last_takeover_timestamp_seconds",
     "latest", "instance"),
)

_SPARK_BARS = "▁▂▃▄▅▆▇█"


def _sparkline(values: list) -> str:
    """Unicode sparkline; ``None`` (no data at that step) renders '·'."""
    present = [v for v in values if v is not None]
    if not present:
        return "·" * len(values)
    lo, hi = min(present), max(present)
    span = (hi - lo) or 1.0
    out = []
    for v in values:
        if v is None:
            out.append("·")
        else:
            idx = int((v - lo) / span * (len(_SPARK_BARS) - 1))
            out.append(_SPARK_BARS[idx])
    return "".join(out)


def invariants_snapshot(client: RegistryClient, scheduler=None) -> dict:
    """Cluster-invariant view (doc/chaos.md): the scheduler's
    ``GET /invariants`` catalog — double-booking, booking consistency,
    gang atomicity, serving exactly-once — evaluated on the live
    engine under its own lock."""
    snap: dict = {}
    if scheduler is not None:
        try:
            snap = scheduler.invariants()
        except Exception as exc:
            print(f"kubeshare-top: scheduler unreachable ({exc}) — "
                  "invariants unavailable", file=sys.stderr)
    return snap or {"ok": None, "violations": [], "checked": []}


def render_invariants(snap: dict) -> str:
    lines = ["INVARIANTS (chaos-plane catalog, doc/chaos.md)"]
    if snap.get("ok") is None:
        lines.append("  unavailable — name a scheduler with --scheduler")
        return "\n".join(lines)
    lines.append(
        f"  {'OK' if snap['ok'] else 'VIOLATED'} — checked: "
        f"{', '.join(snap.get('checked', []))}")
    lines.append(
        f"  pods: {snap.get('bound', 0)} bound / "
        f"{snap.get('pending', 0)} pending / "
        f"{snap.get('parked', 0)} parked")
    for v in snap.get("violations", []):
        lines.append(f"  ! {v.get('invariant')}: {v.get('detail')}")
    return "\n".join(lines)


def gangs_snapshot(client: RegistryClient, scheduler=None) -> dict:
    """Gang isolation plane join view (doc/gang.md): the scheduler's
    ``GET /gangs`` — membership, grant state, and grant-wait
    percentiles per co-scheduled gang."""
    snap: dict = {}
    if scheduler is not None:
        try:
            snap = scheduler.gangs()
        except Exception as exc:
            print(f"kubeshare-top: scheduler unreachable ({exc}) — "
                  "gangs unavailable", file=sys.stderr)
    return snap or {"attached": None, "gangs": {}, "chips": []}


def render_gangs(snap: dict) -> str:
    lines = ["GANGS (gang-atomic token grants, doc/gang.md)"]
    if snap.get("attached") is None:
        lines.append("  unavailable — name a scheduler with --scheduler")
        return "\n".join(lines)
    gangs = snap.get("gangs", {})
    lines.append(f"  {len(gangs)} gang(s), "
                 f"{len(snap.get('chips', []))} chip(s) attached, "
                 f"reserve window {snap.get('reserve_window_s', 0):g}s")
    if not gangs:
        return "\n".join(lines)
    lines.append(f"  {'GANG':<28} {'STATE':<10} {'MEMBERS':>7} "
                 f"{'HELD':>5} {'GRANTS':>7} {'PARTIAL':>8} "
                 f"{'WAIT p50':>9} {'p99':>8}")
    for gid in sorted(gangs):
        g = gangs[gid]
        lines.append(
            f"  {gid:<28} {g.get('state', '?'):<10} "
            f"{len(g.get('members', [])):>7} "
            f"{len(g.get('held', [])):>5} {g.get('grants', 0):>7} "
            f"{g.get('partial_releases', 0):>8} "
            f"{g.get('grant_wait_p50_ms', 0.0):>7.1f}ms "
            f"{g.get('grant_wait_p99_ms', 0.0):>6.1f}ms")
        for member in g.get("members", []):
            lines.append(f"      {member}")
    return "\n".join(lines)


def locks_snapshot(client: RegistryClient, scheduler=None) -> dict:
    """Contention profiler join view (doc/observability.md "Locks,
    phases, and profiles"): the scheduler's ``GET /prof`` — ranked
    tracked-lock wait/hold table, holder sites, dispatcher phases."""
    snap: dict = {}
    if scheduler is not None:
        try:
            snap = scheduler.prof()
        except Exception as exc:
            print(f"kubeshare-top: scheduler unreachable ({exc}) — "
                  "lock profile unavailable", file=sys.stderr)
    return snap or {"attached": None, "locks": [], "phases": {}}


def render_locks(snap: dict) -> str:
    lines = ["LOCKS (runtime contention profiler, doc/observability.md)"]
    if snap.get("attached") is None:
        lines.append("  unavailable — name a scheduler with --scheduler")
        return "\n".join(lines)
    if not snap.get("enabled", True):
        lines.append("  profiler disabled (--no-prof) — totals are "
                     "frozen at the moment it was switched off")
    locks = snap.get("locks", [])
    if not locks:
        lines.append("  no tracked locks have been acquired yet")
    else:
        lines.append(f"  {'LOCK':<14} {'ACQS':>9} {'CONTENDED':>10} "
                     f"{'WAIT':>9} {'HELD':>9}  TOP HOLDER SITE")
        for row in locks:
            sites = row.get("top_sites", [])
            top = sites[0]["site"] if sites else "-"
            lines.append(
                f"  {row.get('name', '?'):<14} "
                f"{row.get('acquisitions', 0):>9} "
                f"{row.get('contended', 0):>10} "
                f"{_fmt_seconds(row.get('wait_total_s', 0.0)):>9} "
                f"{_fmt_seconds(row.get('hold_total_s', 0.0)):>9}  {top}")
            holder = row.get("holder")
            if holder:
                lines.append(
                    f"      held NOW by {holder.get('thread', '?')} for "
                    f"{holder.get('held_s', 0.0):.3f}s at "
                    f"{holder.get('site', '?')}")
    for name, ph in sorted((snap.get("phases") or {}).items()):
        span_s = ph.get("span_seconds", 0.0)
        lines.append(
            f"  PHASES {name}: {ph.get('spans', 0)} span(s), "
            f"{_fmt_seconds(span_s)} under lock, "
            f"coverage {ph.get('coverage', 0.0) * 100:.1f}%")
        phases = ph.get("phases", {})
        for pname in sorted(phases, key=lambda p: -phases[p]):
            share = phases[pname] / span_s if span_s else 0.0
            lines.append(f"      {pname:<14} "
                         f"{_fmt_seconds(phases[pname]):>9} "
                         f"({share * 100:.1f}%)")
    return "\n".join(lines)


def why_snapshot(client: RegistryClient, scheduler, target: str) -> dict:
    """Causal contention report for one pod or tenant
    (doc/observability.md, contention attribution): joins the
    scheduler's ``/ledger`` (chip-time intervals + blame edges), the
    ``/slo`` burn state, ``/gangs`` pause windows, and ``/evictions``
    into one ranked "your waits went to tenant Y on chip Z" report.
    The blame victim key is the tenant namespace, so a ``ns/pod``
    target reports its namespace's attribution."""
    tenant = target.partition("/")[0]
    out: dict = {"target": target, "tenant": tenant, "available": False,
                 "victim": {}, "ranked": [], "chips": {}, "slo": [],
                 "serving": {}, "paused_gangs": [], "evictions": []}
    if scheduler is None:
        return out
    try:
        ledger = scheduler.ledger()
    except Exception as exc:
        print(f"kubeshare-top: scheduler unreachable ({exc}) — "
              "ledger unavailable", file=sys.stderr)
        return out
    out["available"] = True
    blame = ledger.get("blame", {})
    out["victim"] = blame.get("victims", {}).get(tenant, {})
    agg: dict[str, dict] = {}
    for e in blame.get("edges", []):
        if e.get("victim") != tenant:
            continue
        rec = agg.setdefault(e["blamed"], {
            "blamed": e["blamed"], "wait_s": 0.0, "preempted_s": 0.0,
            "count": 0, "chips": set(), "gangs": set(), "trace_ids": []})
        rec["wait_s"] += e.get("wait_s", 0.0)
        rec["preempted_s"] += e.get("preempted_s", 0.0)
        rec["count"] += e.get("count", 0)
        rec["chips"].add(e.get("chip", ""))
        rec["gangs"].update(e.get("gangs", []))
        rec["trace_ids"].extend(e.get("trace_ids", []))
    total = sum(r["wait_s"] for r in agg.values()) or 1.0
    out["ranked"] = [
        {"blamed": r["blamed"], "wait_s": round(r["wait_s"], 6),
         "preempted_s": round(r["preempted_s"], 6),
         "share": round(r["wait_s"] / total, 4), "count": r["count"],
         "chips": sorted(r["chips"]), "gangs": sorted(r["gangs"]),
         "trace_ids": r["trace_ids"][-4:]}
        for r in sorted(agg.values(), key=lambda r: -r["wait_s"])]
    chips = ledger.get("chips", {})
    relevant = {c for r in out["ranked"] for c in r["chips"]}
    relevant |= {cid for cid, c in chips.items()
                 if c.get("tenant") == tenant}
    out["chips"] = {cid: chips[cid]
                    for cid in sorted(relevant) if cid in chips}
    try:
        out["slo"] = scheduler.slo().get("tenants", {}).get(tenant, [])
    except Exception:
        pass                      # plane predates /slo — partial report
    try:
        serving = scheduler.serving()
        if serving.get("attached"):
            # serving accounting join: the request-side symptom of the
            # chip-side contention the ledger attributes
            out["serving"] = serving.get("tenants", {}).get(tenant, {})
    except Exception:
        pass
    try:
        gangs = scheduler.gangs().get("gangs", {})
        out["paused_gangs"] = [
            {"gang": gid, "members": g.get("members", [])}
            for gid, g in sorted(gangs.items())
            if g.get("state") == "paused"]
    except Exception:
        pass
    try:
        out["evictions"] = [
            e for e in scheduler.evictions()
            if tenant in str(e.get("victim", ""))
            or tenant in str(e.get("preemptor", ""))]
    except Exception:
        pass
    return out


def render_why(snap: dict) -> str:
    lines = [f"WHY {snap['target']} (contention attribution, "
             "doc/observability.md)"]
    if not snap.get("available"):
        lines.append("  unavailable — name a scheduler with --scheduler "
                     "(GET /ledger)")
        return "\n".join(lines)
    vic = snap.get("victim") or {}
    if vic:
        lines.append(
            f"  tenant {snap['tenant']}: waited "
            f"{vic.get('waited_s', 0.0):.3f}s across "
            f"{vic.get('waits', 0)} grant(s) "
            f"({vic.get('timeouts', 0)} timed out), "
            f"{vic.get('attributed_s', 0.0):.3f}s attributed to "
            "co-tenants")
    else:
        lines.append(f"  tenant {snap['tenant']}: no recorded grant "
                     "waits — nothing to attribute")
    srv = snap.get("serving") or {}
    if srv:
        lines.append(
            f"  serving: {srv.get('queued', 0)} queued, "
            f"{srv.get('shed', 0)} shed, p99 "
            f"{srv.get('p99_ms', 0.0):.1f}ms "
            f"({srv.get('completed', 0)} completed)")
    for o in snap.get("slo", []):
        lines.append(
            f"  SLO {o.get('objective', '?')}: burn "
            f"{o.get('burn_fast', 0.0):g}x fast / "
            f"{o.get('burn_slow', 0.0):g}x slow, "
            f"{o.get('budget_remaining', 1.0):.0%} budget left"
            + ("  ** FIRING **" if o.get("firing") else ""))
    if snap.get("ranked"):
        lines.append("  RANKED BLAME (who occupied the chip during the "
                     "waits):")
        for i, r in enumerate(snap["ranked"], 1):
            tail = ""
            if r.get("preempted_s"):
                # the blamed tenant was preempted for this tenant — it
                # yielded, it did not just sit on the chip
                tail += (f"  [preempted for you: "
                         f"{r['preempted_s']:.3f}s]")
            if r.get("gangs"):
                tail += f"  [gang {', '.join(r['gangs'])}]"
            if r.get("trace_ids"):
                tail += f"  traces: {', '.join(t[:12] for t in r['trace_ids'][-2:])}"
            lines.append(
                f"  {i:>2}. {r['blamed']:<24} {r['wait_s']:>9.3f}s "
                f"({r['share']:>4.0%}) on {', '.join(r['chips'])}{tail}")
    if snap.get("chips"):
        lines.append("  CHIP TIMELINES (per-state seconds since first "
                     "touch):")
        for cid, c in snap["chips"].items():
            by = c.get("by_state", {})
            mix = "  ".join(f"{s} {by.get(s, 0.0):.2f}s"
                            for s in ("granted-active", "granted-idle",
                                      "reserving", "paused", "free")
                            if by.get(s))
            holder = (f"{c.get('tenant')} ({c.get('tpu_class') or '?'})"
                      if c.get("tenant") else c.get("state", "?"))
            lines.append(f"    {cid:<28} now {c.get('state', '?')} by "
                         f"{holder} for {c.get('since_s', 0.0):.2f}s")
            if mix:
                lines.append(f"      {mix}")
    for g in snap.get("paused_gangs", []):
        lines.append(f"  PAUSED gang {g['gang']} "
                     f"({len(g.get('members', []))} member(s)) — "
                     "migration flip in progress")
    for e in snap.get("evictions", []):
        lines.append(f"  EVICTION: {e.get('victim', '?')} for "
                     f"{e.get('preemptor', '?')} on "
                     f"{e.get('node', e.get('chip', '?'))}")
    return "\n".join(lines)


def fleet_snapshot(client: RegistryClient, window_s: float = 60.0) -> dict:
    """Telemetry-plane join: push freshness per instance (``/instances``)
    plus the FLEET_PANELS aggregations — each a single ``GET /query``
    evaluated by the registry's TSDB across every live instance."""
    inst = client.instances()
    panels = []
    for label, family, agg, q, unit in FLEET_PANELS:
        res = client.query(family, agg=agg, window_s=window_s,
                           q=q if q is not None else 0.99)
        groups = res.get("groups", [])
        panels.append({"label": label, "family": family, "agg": agg,
                       "q": q, "unit": unit,
                       "value": groups[0]["value"] if groups else None,
                       "series": res.get("series_matched", 0)})
    # per-instance RPC rate joins the freshness table — still ONE query,
    # grouped by instance registry-side
    res = client.query("kubeshare_proxy_rpc_latency_seconds_count",
                       agg="rate", window_s=window_s, by=("instance",))
    rates = {g["labels"].get("instance", ""): g["value"]
             for g in res.get("groups", [])}
    instances = inst.get("instances", [])
    for i in instances:
        i["rpc_rate"] = rates.get(i["instance"])
    # GANGS panel (doc/gang.md): the gang grant families grouped
    # per gang — one query per column, registry-side
    gangs: dict[str, dict] = {}
    for label, family, agg, q, group, unit in FLEET_GANG_PANELS:
        try:
            res = client.query(family, agg=agg, window_s=window_s,
                               q=q if q is not None else 0.99,
                               by=(group,))
        except Exception:
            continue          # plane not pushing yet; the table stands
        for g in res.get("groups", []):
            gid = g["labels"].get(group, "")
            gangs.setdefault(gid, {})[label] = g["value"]
    # PREEMPT panel (doc/preempt.md): the preemption families
    # grouped per chip — same one-query-per-column shape as GANGS
    preempt: dict[str, dict] = {}
    for label, family, agg, q, group, unit in FLEET_PREEMPT_PANELS:
        try:
            res = client.query(family, agg=agg, window_s=window_s,
                               q=q if q is not None else 0.99,
                               by=(group,))
        except Exception:
            continue          # plane not pushing yet; the table stands
        for g in res.get("groups", []):
            gid = g["labels"].get(group, "")
            preempt.setdefault(gid, {})[label] = g["value"]
    # RIGHTSIZE panel (doc/autopilot.md, Rightsizing): chip-equivalents
    # by view, per-tenant slow burn, resize dispositions — each row a
    # (label, group-key, value) triple since the group label varies
    rightsize: list[dict] = []
    for label, family, agg, q, group, unit in FLEET_RIGHTSIZE_PANELS:
        try:
            res = client.query(family, agg=agg, window_s=window_s,
                               q=q if q is not None else 0.99,
                               by=(group,))
        except Exception:
            continue          # plane not pushing yet; the table stands
        for g in res.get("groups", []):
            if g["value"] is None:
                continue
            rightsize.append({"label": label,
                              "key": g["labels"].get(group, ""),
                              "value": g["value"]})
    # LOCKS panel (doc/observability.md "Locks, phases, and profiles"):
    # tracked-lock wait rate / hold p99 / contended count per lock name
    locks: dict[str, dict] = {}
    for label, family, agg, q, group, unit in FLEET_LOCK_PANELS:
        try:
            res = client.query(family, agg=agg, window_s=window_s,
                               q=q if q is not None else 0.99,
                               by=(group,))
        except Exception:
            continue          # profiler not pushing yet; the table stands
        for g in res.get("groups", []):
            gid = g["labels"].get(group, "")
            locks.setdefault(gid, {})[label] = g["value"]
    # HA panel (doc/ha.md): leadership + takeover state per scheduler
    # instance — same one-query-per-column shape as GANGS
    ha: dict[str, dict] = {}
    for label, family, agg, group in FLEET_HA_PANELS:
        try:
            res = client.query(family, agg=agg, window_s=window_s,
                               by=(group,))
        except Exception:
            continue          # no HA deployment pushing; the table stands
        for g in res.get("groups", []):
            gid = g["labels"].get(group, "")
            ha.setdefault(gid, {})[label] = g["value"]
    # CONTENTION panel (doc/observability.md): blame wait-seconds per
    # second, grouped by blamed tenant — who is costing the fleet time
    contention = []
    try:
        res = client.query("kubeshare_blame_wait_seconds_total",
                           agg="rate", window_s=window_s, by=("blamed",))
        contention = sorted(
            ({"blamed": g["labels"].get("blamed", ""),
              "wait_s_per_s": g["value"]}
             for g in res.get("groups", []) if g["value"]),
            key=lambda r: -(r["wait_s_per_s"] or 0.0))
    except Exception:
        pass
    return {"now": inst.get("now"),
            "stale_after_s": inst.get("stale_after_s"),
            "window_s": float(window_s),
            "instances": instances, "panels": panels,
            "gangs": gangs, "preempt": preempt, "locks": locks,
            "rightsize": rightsize, "contention": contention, "ha": ha}


def fleet_history(client: RegistryClient, watch_s: float,
                  window_s: float = 60.0) -> dict:
    """Sparkline feed for ``--fleet --watch``: one range query per
    FLEET_SPARKS panel (instant query per step, registry-side)."""
    step = max(5.0, float(watch_s))
    hist = {}
    for label, family, agg in FLEET_SPARKS:
        try:
            rr = client.query_range(family, agg=agg, window_s=window_s,
                                    step_s=step, span_s=step * 40)
        except Exception:
            continue          # history is decoration; the table stands
        hist[label] = [p["value"] for p in rr.get("points", [])]
    return hist


def _fmt_panel(value, unit: str) -> str:
    if value is None:
        return "-"
    if unit == "s":
        return _fmt_seconds(float(value))
    if unit == "/s":
        return f"{value:.2f}/s"
    if unit == "ratio":
        return f"{value:.2f}"
    return f"{value:g}"


def render_fleet(snap: dict) -> str:
    lines = [f"FLEET TELEMETRY (remote-write TSDB, doc/observability.md) "
             f"— window {snap['window_s']:.0f}s"]
    insts = snap["instances"]
    if not insts:
        lines.append("  no instances have pushed — remote-write is the "
                     "feed (scheduler: on by default; chipproxy "
                     "--remote-write; launcherd --registry-host)")
    else:
        lines.append(f"  {'instance':<24} {'job':<12} {'age':>7} "
                     f"{'pushes':>7} {'series':>7} {'rpc/s':>8}  state")
        for i in insts:
            rate = (f"{i['rpc_rate']:.2f}" if i.get("rpc_rate") is not None
                    else "-")
            state = "STALE" if i.get("stale") else "live"
            lines.append(
                f"  {i['instance']:<24} {i.get('job', ''):<12} "
                f"{i['age_s']:>6.1f}s {i.get('pushes', 0):>7} "
                f"{i.get('samples', 0):>7} {rate:>8}  {state}")
    lines.append("AGGREGATES (one GET /query each, evaluated "
                 "registry-side across instances)")
    for p in snap["panels"]:
        lines.append(f"  {p['label']:<16} {_fmt_panel(p['value'], p['unit']):>10}"
                     f"   ({p['series']} series)")
    gangs = snap.get("gangs") or {}
    if gangs:
        lines.append("GANGS (gang-atomic grants, doc/gang.md)")
        lines.append(f"  {'gang':<28} {'wait p99':>9} {'partials':>9} "
                     f"{'paused':>7}")
        for gid in sorted(gangs):
            g = gangs[gid]
            wait = g.get("wait p99")
            partials = g.get("partials")
            lines.append(
                f"  {gid:<28} "
                f"{_fmt_seconds(wait) if wait is not None else '-':>9} "
                f"{partials if partials is not None else '-':>9} "
                f"{'yes' if g.get('paused') else 'no':>7}")
    preempt = snap.get("preempt") or {}
    if preempt:
        lines.append("PREEMPT (SLO-class preemptions, doc/preempt.md)")
        lines.append(f"  {'chip':<28} {'preempts':>9} {'yield p99':>10} "
                     f"{'boosts':>7}")
        for cid in sorted(preempt):
            p = preempt[cid]
            yld = p.get("yield p99")
            lines.append(
                f"  {cid:<28} "
                f"{p.get('preempts') if p.get('preempts') is not None else '-':>9} "
                f"{_fmt_seconds(yld) if yld is not None else '-':>10} "
                f"{p.get('boosts') if p.get('boosts') is not None else '-':>7}")
    rightsize = snap.get("rightsize") or []
    if rightsize:
        lines.append("RIGHTSIZE (SLO-driven capacity rightsizer, "
                     "doc/autopilot.md — topcli --rightsize drills in)")
        by_label: dict[str, list] = {}
        for row in rightsize:
            by_label.setdefault(row["label"], []).append(row)
        for label in ("chip-equiv", "burn slow", "resizes"):
            rows = by_label.get(label)
            if not rows:
                continue
            cells = "  ".join(
                f"{r['key']} {r['value']:g}"
                for r in sorted(rows, key=lambda r: r["key"]))
            lines.append(f"  {label:<16} {cells}")
    locks = snap.get("locks") or {}
    if locks:
        lines.append("LOCKS (tracked-lock contention, "
                     "doc/observability.md — topcli --locks drills in)")
        lines.append(f"  {'lock':<28} {'wait s/s':>9} {'hold p99':>9} "
                     f"{'contended':>10}")
        ranked = sorted(locks,
                        key=lambda k: -(locks[k].get("wait s/s") or 0.0))
        for lid in ranked:
            row = locks[lid]
            wait = row.get("wait s/s")
            hold = row.get("hold p99")
            lines.append(
                f"  {lid:<28} "
                f"{f'{wait:.3f}' if wait is not None else '-':>9} "
                f"{_fmt_seconds(hold) if hold is not None else '-':>9} "
                f"{row.get('contended') if row.get('contended') is not None else '-':>10}")
    ha = snap.get("ha") or {}
    if ha:
        lines.append("HA (epoch-fenced leadership, doc/ha.md — "
                     "GET /ha on each scheduler drills in)")
        lines.append(f"  {'instance':<24} {'role':<8} {'epoch':>6} "
                     f"{'takeovers':>10}  last takeover")
        now = snap.get("now")
        for gid in sorted(ha):
            row = ha[gid]
            role = ("leader" if row.get("leader") else
                    "-" if row.get("leader") is None else "standby")
            epoch = row.get("epoch")
            last = row.get("last takeover")
            if not last:
                ago = "never"
            elif now:
                ago = _fmt_seconds(max(0.0, float(now) - float(last))) \
                    + " ago"
            else:
                ago = f"@{last:.0f}"
            lines.append(
                f"  {gid:<24} {role:<8} "
                f"{f'{epoch:g}' if epoch is not None else '-':>6} "
                f"{row.get('takeovers') if row.get('takeovers') is not None else '-':>10}  "
                f"{ago}")
    contention = snap.get("contention") or []
    if contention:
        lines.append("CONTENTION (blame wait-seconds per second, by "
                     "blamed tenant — topcli --why drills in)")
        for row in contention[:8]:
            lines.append(f"  {row['blamed']:<28} "
                         f"{row['wait_s_per_s']:.3f} s/s")
    for label, values in (snap.get("history") or {}).items():
        lines.append(f"  {label:<16} {_sparkline(values)}")
    return "\n".join(lines)


def _fmt_seconds(s: float) -> str:
    if s != s:                       # NaN: series exists but has no samples
        return "-"
    if s < 0.001:
        return f"{s * 1e6:.0f}µs"
    if s < 1.0:
        return f"{s * 1e3:.1f}ms"
    return f"{s:.2f}s"


def latency_snapshot(text: str, store=None, window_s: float = 60.0,
                     now: float | None = None) -> dict:
    """Exposition text → ``{histograms: [...], utilization: [...]}``.

    One-shot (``store is None``): p50/p90/p99 estimated from the raw
    cumulative buckets (PromQL ``histogram_quantile`` math,
    ``obs.metrics.quantile_from_buckets``) — one row per label set.

    Watch mode feeds each scrape into a local
    :class:`~kubeshare_tpu_torch.obs.tsdb.TimeSeriesStore` and computes the
    percentiles from *windowed bucket increases* instead. Cumulative
    buckets go backwards when the scraped process restarts mid-session;
    the TSDB's reset-aware increase keeps the deltas non-negative, so
    the quantiles stay truthful across a proxy/scheduler restart.
    """
    from .obs.metrics import parse_exposition, quantile_from_buckets
    families = parse_exposition(text)
    if store is not None:
        store.ingest("scrape", "scrape", exposition=text, now=now)

    def _windowed(fname: str, labels: dict) -> dict:
        matchers = dict(labels)
        matchers["instance"] = "scrape"
        out = {}
        for pname, qv in (("p50", 0.50), ("p90", 0.90), ("p99", 0.99)):
            res = store.query(fname, agg="quantile", q=qv,
                              window_s=window_s, matchers=matchers,
                              now=now)
            g = res["groups"]
            v = g[0]["value"] if g else None
            out[pname] = float("nan") if v is None else v
        res = store.query(fname + "_count", agg="increase",
                          window_s=window_s, matchers=matchers, now=now)
        g = res["groups"]
        out["count"] = int(g[0]["value"]) if g and g[0]["value"] else 0
        return out

    hists = []
    for fname, fam in sorted(families.items()):
        if fam["type"] != "histogram":
            continue
        series: dict[tuple, dict] = {}
        for name, labels, value in fam["samples"]:
            key = tuple(sorted((k, v) for k, v in labels.items()
                               if k != "le"))
            s = series.setdefault(key, {"buckets": [], "sum": 0.0,
                                        "count": 0, "exemplar": None})
            if name.endswith("_bucket"):
                s["buckets"].append((float(labels["le"]), value))
            elif name.endswith("_sum"):
                s["sum"] = value
            elif name.endswith("_count"):
                s["count"] = int(value)
        # the slowest exemplar per series is the trace worth pulling
        # from the flight recorder (doc/observability.md)
        for _, labels, trace_id, value in fam.get("exemplars", ()):
            key = tuple(sorted((k, v) for k, v in labels.items()
                               if k != "le"))
            s = series.get(key)
            if s is not None and (s["exemplar"] is None
                                  or value > s["exemplar"]["value"]):
                s["exemplar"] = {"trace_id": trace_id, "value": value}
        for key, s in sorted(series.items()):
            bounds = [b for b, _ in sorted(s["buckets"])]
            cums = [int(c) for _, c in sorted(s["buckets"])]
            row = {
                "family": fname,
                "labels": dict(key),
                "count": s["count"],
                "sum_s": s["sum"],
                "p50": quantile_from_buckets(bounds, cums, 0.50),
                "p90": quantile_from_buckets(bounds, cums, 0.90),
                "p99": quantile_from_buckets(bounds, cums, 0.99),
                "exemplar": s["exemplar"],
            }
            if store is not None:
                row.update(_windowed(fname, dict(key)))
            hists.append(row)

    util = []
    fam = families.get("kubeshare_token_utilization_ratio")
    if fam:
        for _, labels, value in sorted(fam["samples"],
                                       key=lambda s: sorted(s[1].items())):
            util.append({"chip": labels.get("chip", "?"),
                         "client": labels.get("client", "?"),
                         "ratio": value})
    return {"histograms": hists, "utilization": util,
            "windowed_s": window_s if store is not None else None}


def render_latency(lat: dict, source: str) -> str:
    mode = (f"windowed {lat['windowed_s']:.0f}s, reset-aware"
            if lat.get("windowed_s") else "cumulative since start")
    lines = [f"LATENCY ({source}, {mode})"]
    rows = lat["histograms"]
    if not rows:
        lines.append("  no histogram families in the exposition — nothing "
                     "has been scheduled/executed since start")
    else:
        lines.append(f"  {'family':<42} {'labels':<22} {'count':>6} "
                     f"{'p50':>8} {'p90':>8} {'p99':>8}  exemplar")
        for r in rows:
            labels = ",".join(f"{k}={v}" for k, v in r["labels"].items())
            ex = r.get("exemplar")
            tail = (f"  {ex['trace_id'][:12]}"
                    f" @{_fmt_seconds(ex['value'])}" if ex else "")
            lines.append(
                f"  {r['family']:<42} {labels:<22} {r['count']:>6} "
                f"{_fmt_seconds(r['p50']):>8} {_fmt_seconds(r['p90']):>8} "
                f"{_fmt_seconds(r['p99']):>8}{tail}")
    if lat["utilization"]:
        lines.append("TOKEN UTILIZATION (window share per chip)")
        for u in lat["utilization"]:
            bar = "#" * int(min(max(u["ratio"], 0.0), 1.0) * 20)
            lines.append(f"  {u['chip']:<20} {u['client']:<20} "
                         f"{u['ratio']:>6.2f} |{bar:<20}|")
    return "\n".join(lines)


def _fetch_exposition(url: str, timeout: float = 5.0) -> str:
    import urllib.request
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode()


def _critpath_main(args) -> int:
    """Offline critical-path report over tracer/flight span files."""
    import glob
    import os
    from .obs import critpath
    paths = []
    for p in args.spans:
        if os.path.isdir(p):
            paths.extend(sorted(glob.glob(os.path.join(p, "*.jsonl"))))
        else:
            paths.append(p)
    if not paths:
        print("kubeshare-top: --critpath needs --spans FILE_OR_DIR ... "
              "(tracer JSONL exports and/or flight-recorder dumps)",
              file=sys.stderr)
        return 2
    spans = critpath.load_spans(paths)
    traces = critpath.assemble(spans, trace_id=args.trace)
    rep = critpath.report(traces)
    if args.json:
        print(json.dumps({"report": rep, "traces": traces}))
    else:
        sys.stdout.write(critpath.render_report(rep, traces))
    return 0 if traces else 2


def _replay_diff_main(args) -> int:
    """Offline decision-diff render: either a saved diff report (the
    ``decision_diff`` JSON ``bench_replay`` and ``trigger_on_diff``
    emit) or a pair of decision traces to diff on the spot."""
    from .obs.decisions import parse_trace_jsonl
    from .replay import decision_diff, render_diff

    try:
        with open(args.replay_diff) as fh:
            text = fh.read()
    except OSError as e:
        print(f"kubeshare-top: --replay-diff: {e}", file=sys.stderr)
        return 2
    try:
        first = text.lstrip().splitlines()[0] if text.strip() else ""
        doc = json.loads(first) if first.startswith("{") else None
    except ValueError:
        doc = None
    if doc is not None and doc.get("kind") == "header":
        # a decision trace, not a diff — needs the counterpart trace
        if not args.against:
            print("kubeshare-top: --replay-diff got a decision trace; "
                  "pass the candidate trace via --against FILE",
                  file=sys.stderr)
            return 2
        try:
            with open(args.against) as fh:
                other = fh.read()
        except OSError as e:
            print(f"kubeshare-top: --against: {e}", file=sys.stderr)
            return 2
        diff = decision_diff(parse_trace_jsonl(text)["entries"],
                             parse_trace_jsonl(other)["entries"],
                             shard_equivalence=args.shard_equiv)
    else:
        try:
            diff = json.loads(text)
        except ValueError as e:
            print(f"kubeshare-top: --replay-diff: not a diff report or "
                  f"decision trace: {e}", file=sys.stderr)
            return 2
    if args.json:
        print(json.dumps(diff))
    else:
        print(render_diff(diff))
    return 0 if diff.get("identical") else 1


def _opportunistic(priority: str) -> bool:
    """Match the scheduler's rule: priority <= 0 is opportunistic
    (``scheduler/labels.py``), not just the literal "0"."""
    try:
        return int(priority) <= 0
    except (TypeError, ValueError):
        return False


def render(snap: dict) -> str:
    lines = []
    for n in snap["nodes"]:
        state = "healthy" if n["healthy"] else "UNHEALTHY"
        lines.append(f"{n['node']}  ({state}, {len(n['chips'])} chips, "
                     f"capacity age {n['age_s']}s)")
        for c in n["chips"]:
            residents = ", ".join(
                f"{p['key']}({p['request']}/{p['limit']}"
                + (f" g={p['group']}" if p["group"] else "")
                + (" opp" if _opportunistic(p["priority"]) else "")
                + (f" EVICTING→{p['evicting_for']}"
                   if p.get("evicting_for") else "") + ")"
                for p in c["pods"]) or "-"
            lines.append(
                f"  {c['chip_id']:<28} {c['model']:<12} "
                f"{c['memory_gib']:>3}G  booked {c['booked']:<5} "
                f"free {c['free']:<5} {residents}")
    f = snap["fleet"]
    pct = 100.0 * f["booked"] / f["chips"] if f["chips"] else 0.0
    lines.append(f"FLEET: {f['chips']} chips, {f['booked']}/{f['chips']} "
                 f"booked ({pct:.0f}%), {f['pods']} pods, "
                 f"{f['gangs']} gangs"
                 + (f", {f['evicting']} evicting" if f.get("evicting")
                    else ""))
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="kubeshare-top",
                                     description=__doc__)
    parser.add_argument("--registry",
                        default=f"127.0.0.1:{C.REGISTRY_PORT}",
                        help="registry HOST:PORT (default: the well-known "
                             "service port, deploy/registry.yaml)")
    parser.add_argument("--node", default=None,
                        help="show one node only")
    parser.add_argument("--scheduler", default="",
                        help="scheduler HOST:PORT — annotate pods under "
                             "an outstanding preemption (/evictions)")
    parser.add_argument("--watch", type=float, default=0.0,
                        help="refresh every N seconds (0 = one shot)")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable snapshot instead of a table")
    parser.add_argument("--latency", action="store_true",
                        help="phase-latency percentiles + per-chip token "
                             "utilization from /metrics instead of the "
                             "fleet table")
    parser.add_argument("--health", action="store_true",
                        help="per-node lease age + health state (and "
                             "shed/evicted totals with --scheduler) "
                             "instead of the fleet table")
    parser.add_argument("--autopilot", action="store_true",
                        help="fragmentation score, pending/applied moves "
                             "and per-chip burst credits (needs "
                             "--scheduler for autopilot state) instead "
                             "of the fleet table")
    parser.add_argument("--rightsize", action="store_true",
                        help="SLO-driven capacity rightsizer join: "
                             "per-tenant burn vs budget, current/"
                             "proposed share and decision reason (needs "
                             "--scheduler for /rightsize state) instead "
                             "of the fleet table")
    parser.add_argument("--elastic", action="store_true",
                        help="elastic training-plane join: per-gang "
                             "mesh shape, last resize and pause p50/p99 "
                             "(needs --scheduler for /elastic state) "
                             "instead of the fleet table")
    parser.add_argument("--serving", action="store_true",
                        help="serving front-door join: per-tenant queue "
                             "depth, admit/shed rates and p50/p99 (needs "
                             "--scheduler for /serving state) instead "
                             "of the fleet table")
    parser.add_argument("--invariants", action="store_true",
                        help="chaos-plane invariant catalog: "
                             "double-booking, gang atomicity, serving "
                             "exactly-once on the live engine (needs "
                             "--scheduler for /invariants) instead of "
                             "the fleet table")
    parser.add_argument("--gangs", action="store_true",
                        help="gang isolation plane: per-gang membership, "
                             "grant state, and gang grant-wait p50/p99 "
                             "(needs --scheduler for /gangs) instead of "
                             "the fleet table")
    parser.add_argument("--locks", action="store_true",
                        help="runtime contention profiler: ranked "
                             "tracked-lock wait/hold table with top "
                             "holder sites, plus dispatcher phase "
                             "attribution (needs --scheduler for /prof) "
                             "instead of the fleet table")
    parser.add_argument("--why", default=None, metavar="POD_OR_TENANT",
                        help="contention attribution: ranked 'who made "
                             "this pod/tenant wait' report joining the "
                             "chip-time ledger, blame graph, SLO burn "
                             "state, gang pause windows and evictions "
                             "(needs --scheduler for /ledger)")
    parser.add_argument("--fleet", action="store_true",
                        help="remote-write telemetry plane: per-instance "
                             "push freshness + fleet-wide windowed "
                             "aggregations via the registry's GET /query "
                             "(sparkline history under --watch)")
    parser.add_argument("--critpath", action="store_true",
                        help="offline: assemble --spans files into a "
                             "per-segment critical-path report "
                             "(admission/queue/schedule/grant/transport/"
                             "execute)")
    parser.add_argument("--spans", nargs="*", default=[],
                        help="span JSONL files or directories for "
                             "--critpath (tracer exports, flight dumps)")
    parser.add_argument("--trace", default=None,
                        help="restrict --critpath to one trace id")
    parser.add_argument("--window", type=float, default=60.0,
                        help="aggregation window in seconds for --fleet "
                             "and watch-mode --latency (default 60)")
    parser.add_argument("--replay-diff", default=None, metavar="FILE",
                        help="offline: render a decision-diff report "
                             "(bench_replay/trigger_on_diff JSON), or "
                             "diff a recorded decision trace against "
                             "--against TRACE; exits 1 on a non-empty "
                             "diff (doc/replay.md)")
    parser.add_argument("--shard-equiv", action="store_true",
                        help="with --replay-diff/--against: compare "
                             "outcome equivalence classes (same per-spec "
                             "pod->node multiset, same denials) instead "
                             "of byte order — the sharded-vs-single-lock "
                             "gate (doc/sharding.md)")
    parser.add_argument("--against", default=None, metavar="TRACE",
                        help="candidate decision trace for --replay-diff "
                             "when FILE is itself a trace")
    args = parser.parse_args(argv)
    if args.critpath:
        return _critpath_main(args)
    if args.replay_diff:
        return _replay_diff_main(args)
    host, _, port = args.registry.rpartition(":")
    client = RegistryClient(host or "127.0.0.1", int(port))
    scheduler = None
    if args.scheduler:
        from .scheduler.bridge import ServiceClient
        base = (args.scheduler if "://" in args.scheduler
                else "http://" + args.scheduler)
        # advisory call: a hung scheduler must not stall --watch frames
        scheduler = ServiceClient(base, timeout=3.0)

    # --latency scrapes the scheduler when one is named (its exposition
    # embeds the process-wide obs registry), else the telemetry registry
    metrics_url = ""
    if args.latency:
        if args.scheduler:
            base = (args.scheduler if "://" in args.scheduler
                    else "http://" + args.scheduler)
            metrics_url = base.rstrip("/") + "/metrics"
        else:
            host_part = host or "127.0.0.1"
            metrics_url = f"http://{host_part}:{port}/metrics"

    # watch-mode --latency: consecutive scrapes feed a local TSDB so
    # quantiles come from reset-aware windowed increases, not raw
    # cumulative buckets (which go backwards across a proxy restart)
    lat_store = None
    lat_window = max(args.window, 5.0 * args.watch)
    if args.latency and args.watch > 0:
        from .obs.tsdb import TimeSeriesStore
        lat_store = TimeSeriesStore(stale_after_s=lat_window + args.watch,
                                    retention_s=2.0 * lat_window)

    try:
        while True:
            try:
                if args.autopilot:
                    aps = autopilot_snapshot(client, scheduler)
                    out = (json.dumps(aps) if args.json
                           else render_autopilot(aps))
                elif args.rightsize:
                    rzs = rightsize_snapshot(client, scheduler)
                    out = (json.dumps(rzs) if args.json
                           else render_rightsize(rzs))
                elif args.elastic:
                    els = elastic_snapshot(client, scheduler)
                    out = (json.dumps(els) if args.json
                           else render_elastic(els))
                elif args.serving:
                    svs = serving_snapshot(client, scheduler)
                    out = (json.dumps(svs) if args.json
                           else render_serving(svs))
                elif args.invariants:
                    ivs = invariants_snapshot(client, scheduler)
                    out = (json.dumps(ivs) if args.json
                           else render_invariants(ivs))
                elif args.gangs:
                    gs = gangs_snapshot(client, scheduler)
                    out = (json.dumps(gs) if args.json
                           else render_gangs(gs))
                elif args.locks:
                    lks = locks_snapshot(client, scheduler)
                    out = (json.dumps(lks) if args.json
                           else render_locks(lks))
                elif args.why:
                    ws = why_snapshot(client, scheduler, args.why)
                    out = (json.dumps(ws) if args.json
                           else render_why(ws))
                elif args.health:
                    hs = health_snapshot(client, scheduler)
                    out = json.dumps(hs) if args.json else render_health(hs)
                elif args.fleet:
                    fs = fleet_snapshot(client, window_s=args.window)
                    if args.watch > 0:
                        fs["history"] = fleet_history(
                            client, args.watch, window_s=args.window)
                    out = (json.dumps(fs) if args.json
                           else render_fleet(fs))
                elif args.latency:
                    lat = latency_snapshot(_fetch_exposition(metrics_url),
                                           store=lat_store,
                                           window_s=lat_window)
                    out = (json.dumps(lat) if args.json
                           else render_latency(lat, metrics_url))
                else:
                    snap = snapshot(client, args.node, scheduler)
                    out = json.dumps(snap) if args.json else render(snap)
            except (urllib.error.URLError, OSError, ValueError) as exc:
                target = metrics_url if args.latency else args.registry
                print(f"kubeshare-top: {target} "
                      f"unreachable: {exc}", file=sys.stderr)
                if args.watch <= 0:
                    return 2
                # watch mode rides out transient scrape failures (a
                # restarting scheduler, a dropped frame) instead of
                # dying mid-session; ctrl-c remains the exit
                time.sleep(args.watch)
                continue
            if args.watch > 0:
                if args.json:
                    print(out, flush=True)  # one parseable frame per line
                else:
                    # clear + home, then the frame — the classic refresh
                    sys.stdout.write("\x1b[2J\x1b[H" + out + "\n")
                    sys.stdout.flush()
                time.sleep(args.watch)
            else:
                print(out)
                return 0
    except KeyboardInterrupt:
        return 0  # ctrl-c is how --watch exits; not an error


if __name__ == "__main__":
    sys.exit(main())
