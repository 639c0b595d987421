"""Decision inputs for the capacity rightsizer (doc/autopilot.md,
Rightsizing).

The port's copy of ``kubeshare_tpu/rightsize/signals.py``.

The controller never trusts a declared ``tpu_request`` — Tally's
argument (arXiv:2410.07381) is that the contention signal must be
*measured* interference, and ParvaGPU's (arXiv:2409.14447) that the
right share is the smallest one that still meets the SLO. Three planes
already measure everything needed:

  * the chip-time ledger (:mod:`..obs.ledger`) splits every granted
    second into ``granted-active`` vs ``granted-idle`` — the
    idle fraction over a sustained window IS the over-provisioning
    signal;
  * the SLO evaluator (:mod:`..obs.slo`) turns per-tenant indicator
    samples into multi-window burn rates — a tenant burning its error
    budget is the under-provisioning signal;
  * the blame graph (:mod:`..obs.blame`) attributes a victim's waits to
    the co-tenants that held the chip — it picks WHICH neighbour a
    grow should shrink or migrate away.

This module is pure joins over those snapshots: no locks, no clocks,
no mutation — the controller stays testable against literal dicts.
"""

from __future__ import annotations


def default_tenant(client: str) -> str:
    """Map a token/ledger client name to its tenant. Clients are pod
    keys (``namespace/name``); the namespace is the tenant — the same
    convention the SLO evaluator's submit-path declaration uses."""
    head, sep, _rest = client.partition("/")
    return head if sep else client


def tenant_demand(ledger, start: float, end: float, now: float,
                  tenant_fn=default_tenant) -> dict:
    """Per-tenant measured demand over ``[start, end]``: chip-seconds
    spent ``granted-active`` vs ``granted-idle``, joined across every
    chip the ledger has seen. Returns::

        {tenant: {"active_s": .., "idle_s": .., "granted_s": ..,
                  "idle_frac": .., "chips": [..]}}

    ``idle_frac`` is idle over granted (0 when nothing was granted) —
    the shrink trigger compares it against the config threshold.
    """
    out: dict[str, dict] = {}
    snap = ledger.snapshot(now)
    for chip in snap.get("chips", {}):
        for row in ledger.account(chip, start, end, now=now):
            tenant = tenant_fn(row.get("tenant") or "")
            state = row.get("state")
            if not tenant or state not in ("granted-active",
                                           "granted-idle"):
                continue
            rec = out.setdefault(tenant, {"active_s": 0.0, "idle_s": 0.0,
                                          "chips": set()})
            rec["chips"].add(chip)
            if state == "granted-active":
                rec["active_s"] += row["overlap_s"]
            else:
                rec["idle_s"] += row["overlap_s"]
    for rec in out.values():
        granted = rec["active_s"] + rec["idle_s"]
        rec["granted_s"] = round(granted, 6)
        rec["idle_frac"] = round(rec["idle_s"] / granted, 6) if granted \
            else 0.0
        rec["active_s"] = round(rec["active_s"], 6)
        rec["idle_s"] = round(rec["idle_s"], 6)
        rec["chips"] = sorted(rec["chips"])
    return out


def burn_state(slo_state: dict) -> dict:
    """Collapse :meth:`SloEvaluator.state` to one burn record per
    tenant: the WORST objective wins (max burn, min remaining budget) —
    a grow must clear every declared objective, not the average one::

        {tenant: {"burn_fast": .., "burn_slow": .., "firing": bool,
                  "budget_remaining": .., "objectives": [raw, ..]}}
    """
    out: dict[str, dict] = {}
    for tenant, objectives in slo_state.get("tenants", {}).items():
        rec = {"burn_fast": 0.0, "burn_slow": 0.0, "firing": False,
               "budget_remaining": 1.0, "objectives": []}
        for obj in objectives:
            rec["burn_fast"] = max(rec["burn_fast"], obj["burn_fast"])
            rec["burn_slow"] = max(rec["burn_slow"], obj["burn_slow"])
            rec["budget_remaining"] = min(rec["budget_remaining"],
                                          obj["budget_remaining"])
            rec["firing"] = rec["firing"] or obj["firing"]
            rec["objectives"].append(obj["objective"])
        out[tenant] = rec
    return out


def blamed_neighbours(blame, victim_tenant: str, n: int = 5,
                      tenant_fn=default_tenant) -> list[str]:
    """Tenants ranked by chip-seconds they cost *victim_tenant*'s
    clients — the grow path's shrink/migrate-away candidates. Pseudo
    holders (migration pauses, preemption drains) and the victim's own
    clients are filtered out."""
    ranked: list[str] = []
    agg: dict[str, float] = {}
    for edge in blame.edges():
        if tenant_fn(edge["victim"]) != victim_tenant:
            continue
        blamed = tenant_fn(edge["blamed"])
        if not blamed or blamed == victim_tenant or \
                edge.get("kind") == "migration":
            continue
        agg[blamed] = agg.get(blamed, 0.0) + edge["wait_s"]
    for tenant, _secs in sorted(agg.items(), key=lambda kv: -kv[1]):
        ranked.append(tenant)
        if len(ranked) >= n:
            break
    return ranked
