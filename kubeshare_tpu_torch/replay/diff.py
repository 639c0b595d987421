"""Decision-diff: recorded vs replayed control-plane behavior
(doc/replay.md).

The port's copy of ``kubeshare_tpu/replay/diff.py``.

:func:`decision_diff` joins two decision traces — the ground truth and
a candidate build's shadow replay — on pod key and reports what the
candidate did *differently*: pods that *moved* (bound elsewhere),
were *denied* (terminal status/denial changed), or were *delayed*
(same placement, later bind), plus pods missing/extra entirely, rng
divergence, per-tenant SLO outcome deltas, and — when profiler
snapshots are supplied — per-phase latency deltas joined against
``kubeshare_prof_phase_seconds_total``'s source accumulators.

``bit_identical`` is the strictest bar (byte-equal canonical traces;
the same-build regression gate), ``identical`` the semantic one (no
behavioral differences). :func:`render_diff` turns the report into
the human-readable text ``topcli --replay-diff`` prints, and
:func:`trigger_on_diff` is the black-box hook: a non-empty diff dumps
both traces through the flight recorder for post-mortem.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from ..obs.decisions import trace_fingerprint

#: bind-time slack before a same-placement pod counts as "delayed"
DELAY_TOL_S = 0.25

_TERMINAL = ("bound", "rejected", "deleted", "overloaded", "timed-out")


def _outcome_index(entries: List[dict]) -> Dict[str, dict]:
    """Per pod: the last terminal outcome (``final``) AND the last
    ``bound`` outcome (``bound``, None if the pod never placed).
    Placement judgments use ``bound`` — a churn pod that bound, ran and
    was deleted ends "deleted" on both sides, which would hide a
    placement change if only final status were compared. Admission
    sheds record a single ``submit`` entry carrying ``shed`` (hot-path
    economy, see Dispatcher.submit) — those count as overloaded
    finals here."""
    out: Dict[str, dict] = {}
    for e in entries:
        kind = e.get("kind")
        if kind == "outcome" and e.get("status") in _TERMINAL:
            row = out.setdefault(e["pod"], {"bound": None, "final": None})
            row["final"] = e
            if e["status"] == "bound":
                row["bound"] = e
        elif kind == "submit" and "shed" in e:
            row = out.setdefault(e["pod"], {"bound": None, "final": None})
            row["final"] = {"kind": "outcome", "pod": e["pod"],
                            "t": e.get("t"), "status": "overloaded",
                            "reason": e["shed"]}
    return out


def _status_of(row: dict) -> dict:
    """The status a side is judged on: bound if it ever placed, else
    its final disposition."""
    if row["bound"] is not None:
        return {"status": "bound", "reason": ""}
    f = row["final"] or {}
    return {"status": f.get("status", "none"),
            "reason": f.get("reason", "")}


def phase_totals(prof_state: dict) -> Dict[str, float]:
    """Per-phase seconds from a ``PhaseProfiler.state()`` dict (the
    accumulators behind ``kubeshare_prof_phase_seconds_total``)."""
    return {k: float(v)
            for k, v in (prof_state or {}).get("phases", {}).items()}


def _spec_classes(entries: List[dict]) -> Dict[str, str]:
    """Pod key -> canonical spec-class key (sorted submit labels): pods
    with byte-identical labels are interchangeable placement-wise."""
    specs: Dict[str, str] = {}
    for e in entries:
        if e.get("kind") == "submit" and isinstance(e.get("labels"), dict):
            specs[e["pod"]] = json.dumps(e["labels"], sort_keys=True)
    return specs


def decision_diff(recorded: List[dict], replayed: List[dict], *,
                  tol_s: float = DELAY_TOL_S,
                  phases_recorded: Optional[dict] = None,
                  phases_replayed: Optional[dict] = None,
                  shard_equivalence: bool = False) -> dict:
    """Compare two decision traces; see module docstring for semantics.

    ``shard_equivalence=True`` relaxes the comparison to *outcome
    equivalence classes* (doc/sharding.md): a sharded plane drains
    shards' queues concurrently, so entry order, bind timestamps, rng
    interleaving — and which of two SPEC-IDENTICAL pods got which of
    two nodes — legitimately differ while the schedule stays the same.
    What must still match: the multiset of nodes each spec class bound
    to (a *real* move shifts a class's node multiset and is flagged),
    and every denial's terminal status. ``delayed``/``rng_divergence``
    are still reported but do not break ``identical`` in this mode."""
    rec_out = _outcome_index(recorded)
    rep_out = _outcome_index(replayed)
    moved, denied, delayed = [], [], []
    class_rec: Dict[str, Dict[str, int]] = {}
    class_rep: Dict[str, Dict[str, int]] = {}
    class_pods: Dict[str, list] = {}
    specs = _spec_classes(recorded)
    specs.update({k: v for k, v in _spec_classes(replayed).items()
                  if k not in specs})
    for pod in sorted(set(rec_out) & set(rep_out)):
        a, b = rec_out[pod], rep_out[pod]
        if a["bound"] is not None and b["bound"] is not None:
            ab, bb = a["bound"], b["bound"]
            if ab.get("node") != bb.get("node"):
                if shard_equivalence:
                    cls = specs.get(pod, pod)
                    for index, e in ((class_rec, ab), (class_rep, bb)):
                        nodes = index.setdefault(cls, {})
                        node = e.get("node")
                        nodes[node] = nodes.get(node, 0) + 1
                    class_pods.setdefault(cls, []).append(pod)
                else:
                    moved.append({"pod": pod,
                                  "recorded_node": ab.get("node"),
                                  "replayed_node": bb.get("node")})
            elif abs(bb["t"] - ab["t"]) > tol_s:
                delayed.append({"pod": pod,
                                "recorded_t": round(ab["t"], 6),
                                "replayed_t": round(bb["t"], 6),
                                "delta_s": round(bb["t"] - ab["t"], 6)})
        else:
            sa, sb = _status_of(a), _status_of(b)
            if sa["status"] != sb["status"]:
                denied.append({"pod": pod, "recorded": sa,
                               "replayed": sb})
    if shard_equivalence:
        # a class whose node multiset is unchanged was a pure swap among
        # interchangeable pods — equivalent, not moved
        for cls in sorted(class_rec):
            if class_rec[cls] != class_rep.get(cls, {}):
                for pod in class_pods[cls]:
                    moved.append({
                        "pod": pod,
                        "recorded_node": rec_out[pod]["bound"].get("node"),
                        "replayed_node": rep_out[pod]["bound"].get("node"),
                        "class_recorded": dict(sorted(class_rec[cls]
                                                      .items())),
                        "class_replayed": dict(sorted(class_rep
                                                      .get(cls, {})
                                                      .items()))})
    missing = sorted(set(rec_out) - set(rep_out))
    extra = sorted(set(rep_out) - set(rec_out))

    # entropy audit: paired draws whose values differ
    rec_rng = [e for e in recorded if e.get("kind") == "rng"]
    rep_rng = [e for e in replayed if e.get("kind") == "rng"]
    rng_div = sum(1 for a, b in zip(rec_rng, rep_rng)
                  if (a.get("label"), a.get("value"))
                  != (b.get("label"), b.get("value")))
    rng_div += abs(len(rec_rng) - len(rep_rng))

    # per-tenant SLO outcome deltas: did any namespace's bound/denied
    # mix shift under the candidate?
    slo: Dict[str, dict] = {}
    for outcomes, side in ((rec_out, "recorded"), (rep_out, "replayed")):
        for pod, row_out in outcomes.items():
            tenant = pod.partition("/")[0]
            row = slo.setdefault(tenant, {
                "recorded": {"bound": 0, "denied": 0},
                "replayed": {"bound": 0, "denied": 0}})
            bucket = ("bound" if row_out["bound"] is not None
                      else "denied")
            row[side][bucket] += 1
    slo_deltas = {t: row for t, row in sorted(slo.items())
                  if row["recorded"] != row["replayed"]}

    phases = {}
    if phases_recorded is not None and phases_replayed is not None:
        a_p, b_p = phase_totals(phases_recorded), phase_totals(phases_replayed)
        for phase in sorted(set(a_p) | set(b_p)):
            ra, rb = a_p.get(phase, 0.0), b_p.get(phase, 0.0)
            phases[phase] = {"recorded_s": round(ra, 6),
                             "replayed_s": round(rb, 6),
                             "delta_s": round(rb - ra, 6)}

    if shard_equivalence:
        # timing skew and rng interleaving are inherent to concurrent
        # shard drains; only real schedule changes break equivalence
        identical = not (moved or denied or missing or extra)
    else:
        identical = not (moved or denied or delayed or missing or extra
                         or rng_div)
    return {
        "bit_identical": (trace_fingerprint(recorded)
                          == trace_fingerprint(replayed)),
        "identical": identical,
        "equivalence": "shard" if shard_equivalence else "strict",
        "moved": moved,
        "denied": denied,
        "delayed": delayed,
        "missing": missing,
        "extra": extra,
        "rng_divergence": rng_div,
        "slo": slo_deltas,
        "phases": phases,
        "pods": {"recorded": len(rec_out), "replayed": len(rep_out)},
        "entries": {"recorded": len(recorded), "replayed": len(replayed)},
    }


def render_diff(diff: dict) -> str:
    """Human-readable report (``topcli --replay-diff``)."""
    lines = ["decision replay diff"]
    lines.append("  traces: %d recorded / %d replayed entries, "
                 "%d/%d pods with outcomes"
                 % (diff["entries"]["recorded"], diff["entries"]["replayed"],
                    diff["pods"]["recorded"], diff["pods"]["replayed"]))
    if diff.get("bit_identical"):
        lines.append("  bit-identical: the candidate reproduced the "
                     "recorded trace byte for byte")
        return "\n".join(lines)
    if diff.get("identical"):
        if diff.get("equivalence") == "shard":
            lines.append("  shard-equivalent: same placement classes "
                         "and denials (order/timing differences only)")
        else:
            lines.append("  no behavioral differences (traces differ "
                         "only in non-decision bytes)")
        return "\n".join(lines)
    for m in diff["moved"]:
        lines.append("  moved   %-28s %s -> %s"
                     % (m["pod"], m["recorded_node"], m["replayed_node"]))
    for d in diff["denied"]:
        lines.append("  changed %-28s %s (%s) -> %s (%s)"
                     % (d["pod"], d["recorded"]["status"],
                        d["recorded"]["reason"] or "-",
                        d["replayed"]["status"],
                        d["replayed"]["reason"] or "-"))
    for d in diff["delayed"]:
        lines.append("  delayed %-28s %+.3fs (bound at %.3f vs %.3f)"
                     % (d["pod"], d["delta_s"], d["replayed_t"],
                        d["recorded_t"]))
    for pod in diff["missing"]:
        lines.append(f"  missing {pod} (no outcome under the candidate)")
    for pod in diff["extra"]:
        lines.append(f"  extra   {pod} (outcome only under the candidate)")
    if diff["rng_divergence"]:
        lines.append("  rng: %d draw(s) diverged" % diff["rng_divergence"])
    for tenant, row in diff["slo"].items():
        lines.append("  slo     %-28s bound %d->%d, denied %d->%d"
                     % (tenant, row["recorded"]["bound"],
                        row["replayed"]["bound"], row["recorded"]["denied"],
                        row["replayed"]["denied"]))
    for phase, row in diff["phases"].items():
        if abs(row["delta_s"]) > 1e-9:
            lines.append("  phase   %-28s %+0.6fs (%0.6f -> %0.6f)"
                         % (phase, row["delta_s"], row["recorded_s"],
                            row["replayed_s"]))
    counts = ("%d moved, %d changed, %d delayed, %d missing, %d extra"
              % (len(diff["moved"]), len(diff["denied"]),
                 len(diff["delayed"]), len(diff["missing"]),
                 len(diff["extra"])))
    lines.append("  total: " + counts)
    return "\n".join(lines)


def trigger_on_diff(diff: dict, recorded: List[dict], replayed: List[dict],
                    flight=None) -> Optional[dict]:
    """Black-box hook (doc/observability.md): a non-empty decision diff
    fires a ``replay-diff`` trigger on the flight recorder and attaches
    both traces to the retained dump; with a dump dir configured the
    traces are persisted next to the flight dump for post-mortem."""
    if diff.get("identical"):
        return None
    import os

    from ..obs.flight import default_recorder

    rec = flight or default_recorder()
    rec.note("replay", "decision-diff", moved=len(diff["moved"]),
             denied=len(diff["denied"]), delayed=len(diff["delayed"]),
             missing=len(diff["missing"]), extra=len(diff["extra"]))
    dump = rec.trigger("replay-diff", moved=len(diff["moved"]),
                       denied=len(diff["denied"]),
                       delayed=len(diff["delayed"]))
    dump["recorded_trace"] = [dict(e) for e in recorded]
    dump["replayed_trace"] = [dict(e) for e in replayed]
    path = dump.get("path")
    if path:
        base = path[:-len(".jsonl")] if path.endswith(".jsonl") else path
        for tag, entries in (("recorded", recorded),
                             ("replayed", replayed)):
            try:
                with open(f"{base}-{tag}.jsonl", "w") as fh:
                    for e in entries:
                        fh.write(json.dumps(e, sort_keys=True) + "\n")
            except OSError:
                pass      # the in-memory dump is still authoritative
    return dump
