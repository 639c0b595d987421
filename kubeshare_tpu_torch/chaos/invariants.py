"""Cluster-wide invariant checks — the chaos plane's oracle.

The port's copy of ``kubeshare_tpu/chaos/invariants.py``.

Every check is a pure function over live plane objects (engine,
token scheduler, proxy, front door, journals) returning a list of
violation records; an empty list means the invariant held.  The chaos
orchestrator samples these between fault windows and at convergence
(doc/chaos.md, invariant catalog); ``GET /invariants`` and
``doctor --invariants`` expose the same catalog on a live scheduler.

The catalog (each maps to one ``check_*`` function below):

- **no-double-booking** — per leaf chip, the sum of fractional compute
  bookings never exceeds the leaf capacity, and memory bookings never
  exceed ``full_memory``;
- **booking-consistency** — the cell's ``available``/``free_memory``
  equal capacity minus the bookings recorded on pods (the two sides of
  the reservation double-entry);
- **gang-atomicity** — a gang is bound all-or-nothing: the number of
  bound members of any group is 0 or the full headcount;
- **gang-grant-atomicity** — no gang ever holds a strict subset of its
  member chips' tokens past the coordinator's reserve window (the
  two-phase gang grant either commits whole or releases whole,
  doc/gang.md);
- **token-shares** — per chip scheduler, effective fractional requests
  sum to <= 1.0 (Gemini's token contract survives elastic lending);
- **hbm-conservation** — per proxy session, bytes charged equal live
  buffer bytes plus staged-upload reservations (charged == held +
  refunded implies the residual equals what is actually resident);
- **serving-exactly-once** — every admitted request is accounted as
  completed, failed, still queued, or parked — never silently dropped;
- **ledger-conservation** — per chip, the chip-time ledger's interval
  states partition the timeline: no gaps, no overlaps, and the
  per-state sums equal elapsed time within 1%
  (``obs/ledger.py``, doc/observability.md);
- **journal-idempotency** — replaying a registry / session / autopilot
  journal twice yields exactly the state one replay yields.
"""

from __future__ import annotations

import json
import os

#: slack for float accumulation across many fractional bookings
EPS = 1e-6


def violation(invariant: str, detail: str, **ctx) -> dict:
    rec = {"invariant": invariant, "detail": detail}
    rec.update(ctx)
    return rec


# -- engine: bookings, cells, gangs -------------------------------------


def check_engine(engine, in_flight=(), *, gangs: bool = True) -> list[dict]:
    """No chip double-booked; cell accounting consistent; gangs atomic.

    Caller must hold the dispatcher lock (or otherwise own the engine)
    so the snapshot is not torn mid-reservation.  ``in_flight`` is the
    set of pod keys still pending/parked — a gang with a member there
    is mid-bind, not torn.  ``gangs=False`` skips the per-engine gang
    check: a shard engine only sees its slice of a cross-shard gang, so
    the sharded checker (:func:`check_cross_shard`) runs the atomicity
    check over the union instead.
    """
    out: list[dict] = []
    booked_c: dict[str, float] = {}
    booked_m: dict[str, int] = {}
    for pod in engine.pod_status.values():
        for chip_id, compute, memory in getattr(pod, "bookings", ()):
            booked_c[chip_id] = booked_c.get(chip_id, 0.0) + compute
            booked_m[chip_id] = booked_m.get(chip_id, 0) + int(memory)
    for chip_id, cell in engine.leaf_cells.items():
        cap = cell.leaf_cell_number
        comp = booked_c.get(chip_id, 0.0)
        mem = booked_m.get(chip_id, 0)
        if comp > cap + EPS:
            out.append(violation(
                "no-double-booking",
                f"chip {chip_id}: {comp:.6f} compute booked on "
                f"capacity {cap:g}", chip=chip_id))
        if cell.full_memory and mem > cell.full_memory:
            out.append(violation(
                "no-double-booking",
                f"chip {chip_id}: {mem} bytes booked on "
                f"{cell.full_memory} HBM", chip=chip_id))
        if abs((cap - comp) - cell.available) > EPS:
            out.append(violation(
                "booking-consistency",
                f"chip {chip_id}: cell.available={cell.available:.6f} "
                f"but capacity-booked={cap - comp:.6f}", chip=chip_id))
        if cell.full_memory and (cell.full_memory - mem) != cell.free_memory:
            out.append(violation(
                "booking-consistency",
                f"chip {chip_id}: cell.free_memory={cell.free_memory} "
                f"but full-booked={cell.full_memory - mem}", chip=chip_id))
    if gangs:
        out.extend(check_gang_atomicity(engine, in_flight))
    return out


def check_gang_atomicity(engine, in_flight=()) -> list[dict]:
    """Every gang is bound all-or-nothing (pod.go gang contract).
    Groups with a member in ``in_flight`` are mid-bind and skipped."""
    out: list[dict] = []
    groups: dict[str, list] = {}
    for pod in engine.pod_status.values():
        if pod.group_name:
            groups.setdefault(pod.group_key, []).append(pod)
    for gkey, members in groups.items():
        if any(p.key in in_flight for p in members):
            continue
        bound = [p for p in members if p.node_name]
        headcount = members[0].headcount or len(members)
        if bound and len(bound) != headcount:
            out.append(violation(
                "gang-atomicity",
                f"gang {gkey}: {len(bound)}/{headcount} members bound "
                f"(must be 0 or all)", gang=gkey))
    return out


def check_cross_shard(engines, in_flight=()) -> list[dict]:
    """The sharded plane's invariants (doc/sharding.md), on top of every
    shard's own :func:`check_engine`:

    - **cross-shard-pod-ownership** — exactly one shard engine holds
      each pod key (spillover/re-home moves the record, never copies
      it) and a pod's bookings land only on chips its owning engine
      knows;
    - **cross-shard-gang-atomicity** — a gang whose members live on
      several shards is still bound all-or-nothing ACROSS them (each
      per-engine check only sees its own slice, so a torn cross-shard
      commit is invisible to it).

    Caller must hold ALL shard locks (``ShardedDispatcher.lock`` — the
    ascending total order) so no trial-book is mid-flight across the
    snapshot.
    """
    out: list[dict] = []
    owner: dict[str, int] = {}
    groups: dict[str, list] = {}
    for idx, eng in enumerate(engines):
        out.extend(check_engine(eng, in_flight, gangs=False))
        chips = set(eng.leaf_cells)
        for key, pod in eng.pod_status.items():
            if key in owner:
                out.append(violation(
                    "cross-shard-pod-ownership",
                    f"pod {key} registered on shard {owner[key]} AND "
                    f"shard {idx}", pod=key))
            else:
                owner[key] = idx
            for chip_id, _c, _m in getattr(pod, "bookings", ()):
                if chip_id not in chips:
                    out.append(violation(
                        "cross-shard-pod-ownership",
                        f"pod {key} on shard {idx} books chip "
                        f"{chip_id} outside that shard's subtree",
                        pod=key, chip=chip_id))
            if pod.group_name:
                groups.setdefault(pod.group_key, []).append(pod)
    for gkey, members in groups.items():
        if any(p.key in in_flight for p in members):
            continue
        bound = [p for p in members if p.node_name]
        headcount = members[0].headcount or len(members)
        if bound and len(bound) != headcount:
            out.append(violation(
                "cross-shard-gang-atomicity",
                f"gang {gkey}: {len(bound)}/{headcount} members bound "
                f"across shards (must be 0 or all)", gang=gkey))
    return out


# -- gang isolation: grant atomicity ------------------------------------


def check_gang_grant_atomicity(coordinator, now=None,
                               slack_s: float = 0.0) -> list[dict]:
    """No partial gang ever holds a subset of member tokens past the
    reserve window (doc/gang.md, two-phase reserve/commit contract).

    A gang mid-reserve legitimately holds a partial set — but only for
    up to ``reserve_window_s`` (+ ``slack_s`` for sampling jitter);
    after that the coordinator must have released the partials. A gang
    in ``held`` must hold EVERY member chip, and an ``idle`` gang must
    hold none.
    """
    out: list[dict] = []
    window = coordinator.reserve_window_s + slack_s
    for st in coordinator.grant_states(now):
        gang, held, members = st["gang"], set(st["held"]), set(st["members"])
        if st["state"] == "held" and held != members:
            out.append(violation(
                "gang-grant-atomicity",
                f"gang {gang}: marked held with {len(held)}/{len(members)} "
                f"member tokens", gang=gang,
                held=sorted(held), members=sorted(members)))
        elif st["state"] == "idle" and held:
            out.append(violation(
                "gang-grant-atomicity",
                f"gang {gang}: idle but still holds {sorted(held)}",
                gang=gang, held=sorted(held)))
        elif (st["state"] == "reserving" and held
                and st["reserve_age_s"] > window):
            out.append(violation(
                "gang-grant-atomicity",
                f"gang {gang}: partial reservation "
                f"({len(held)}/{len(members)} tokens) outstanding "
                f"{st['reserve_age_s']:.3f}s > reserve window {window:.3f}s",
                gang=gang, held=sorted(held), members=sorted(members)))
    return out


# -- isolation: token shares + HBM double-entry -------------------------


def check_token_shares(scheds: dict) -> list[dict]:
    """Per chip scheduler, effective requests sum to <= 1.0."""
    out: list[dict] = []
    for chip, sched in scheds.items():
        total = 0.0
        for name in sched.shares():
            req, _limit = sched.effective(name)
            total += req
        if total > 1.0 + EPS:
            out.append(violation(
                "token-shares",
                f"chip {chip}: effective requests sum to {total:.6f} "
                f"> 1.0", chip=str(chip)))
    return out


def check_hbm_conservation(proxy) -> list[dict]:
    """Per session, charged HBM == resident buffers + staged holds.

    Uses :meth:`ChipProxy.hbm_accounting` (the introspection hook this
    plane added); sample at quiesce — a put in flight between charge
    and buffer insert is not a violation, merely a torn read.
    """
    out: list[dict] = []
    for name, acct in proxy.hbm_accounting().items():
        if not acct["balanced"]:
            out.append(violation(
                "hbm-conservation",
                f"session {name}: hbm_used={acct['hbm_used']} but "
                f"buffers={acct['buffer_bytes']} + "
                f"staged={acct['staged_bytes']}", session=name))
    return out


# -- serving: exactly-once accounting -----------------------------------


def check_serving_exactly_once(frontdoor,
                               parked_pending: int = 0) -> list[dict]:
    """admitted == completed + failed + queued + parked — no silent
    drops.  ``parked_pending`` is the number of requests currently held
    in park manifests (they left the queues without completing)."""
    with frontdoor.lock:
        admitted = frontdoor.admitted_total
        completed = frontdoor.completed_total
        failed = frontdoor.failed_total
        queued = sum(len(t.queue) for t in frontdoor._tenants.values())
    accounted = completed + failed + queued + parked_pending
    if admitted != accounted:
        return [violation(
            "serving-exactly-once",
            f"admitted={admitted} but completed={completed} + "
            f"failed={failed} + queued={queued} + "
            f"parked={parked_pending} = {accounted}")]
    return []


# -- chip-time ledger: timeline conservation ----------------------------


def check_ledger_conservation(ledger, now=None,
                              tolerance: float = 0.01) -> list[dict]:
    """The chip-time ledger's interval states partition every chip's
    timeline: gapless, non-overlapping, and summing to elapsed time
    within *tolerance* (obs/ledger.py — the contention-attribution
    substrate's accounting must itself conserve)."""
    return [violation("ledger-conservation", detail)
            for detail in ledger.check(now=now, tolerance=tolerance)]


# -- journals: replay idempotency ---------------------------------------


def _registry_fingerprint(journal_path) -> dict:
    from ..telemetry.registry import TelemetryRegistry

    # pin the clock: replay stamps lease receive-times with clock(), so
    # a wall clock would make two identical replays fingerprint apart
    reg = TelemetryRegistry(journal=journal_path, clock=lambda: 0.0)
    state = {"capacity": reg.capacity(), "pods": reg.pods(),
             "leases": reg.leases(now=0.0)}
    if reg._journal is not None:
        reg._journal.close()
    return state


def check_registry_replay_idempotent(journal_path) -> list[dict]:
    """Building the registry twice from one journal yields one state."""
    if not journal_path or not os.path.exists(journal_path):
        return []
    first = _registry_fingerprint(journal_path)
    second = _registry_fingerprint(journal_path)
    if json.dumps(first, sort_keys=True, default=str) != \
            json.dumps(second, sort_keys=True, default=str):
        return [violation(
            "journal-idempotency",
            "registry journal replay diverges on the second replay",
            journal=str(journal_path))]
    return []


def check_session_journal_idempotent(dirpath) -> list[dict]:
    """``SessionJournal.recover()`` twice returns identical manifests."""
    if not dirpath or not os.path.isdir(dirpath):
        return []
    from ..resilience.journal import SessionJournal

    def manifests():
        recovered = SessionJournal(dirpath).recover()
        return sorted(
            (json.dumps(m, sort_keys=True, default=str)
             for m in recovered))

    if manifests() != manifests():
        return [violation(
            "journal-idempotency",
            "session journal recover() diverges on the second replay",
            journal=str(dirpath))]
    return []


def _fold_autopilot_journal(path) -> dict:
    """Pure fold of the rebalancer journal into {batch: moves} state —
    the reference replay the real ``Rebalancer._recover`` must agree
    with.  Also detects double-moves: the same pod moved twice inside
    one batch means a replayed move re-executed."""
    state: dict = {"batches": {}, "open": None, "double_moves": []}
    if not path or not os.path.exists(path):
        return state
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue       # torn tail write from the crash itself
            event = rec.get("event")
            batch = rec.get("batch")
            if event == "batch_begin":
                state["open"] = batch
                state["batches"].setdefault(batch, [])
            elif event == "move_done":
                moves = state["batches"].setdefault(batch, [])
                sig = (rec.get("pod"), rec.get("from"), rec.get("node"))
                if sig in moves:
                    state["double_moves"].append(
                        {"batch": batch, "pod": rec.get("pod")})
                moves.append(sig)
            elif event in ("batch_end", "batch_recovered"):
                if state["open"] == batch:
                    state["open"] = None
    return state


def check_autopilot_journal_idempotent(path) -> list[dict]:
    """Folding the rebalancer journal twice yields one state, and no
    batch contains the same move twice (journaled replay must not
    double-move — doc/autopilot.md, crash recovery)."""
    out: list[dict] = []
    first = _fold_autopilot_journal(path)
    second = _fold_autopilot_journal(path)
    if first != second:
        out.append(violation(
            "journal-idempotency",
            "autopilot journal fold diverges on the second replay",
            journal=str(path)))
    for dup in first["double_moves"]:
        out.append(violation(
            "journal-idempotency",
            f"autopilot batch {dup['batch']} moved pod {dup['pod']} "
            f"twice", journal=str(path)))
    return out


# -- HA: single-writer across leadership transitions ---------------------


def check_single_writer(registry, active_engine=None, deposed=(),
                        final: bool = False) -> list[dict]:
    """Epoch-fenced leadership holds (doc/ha.md): fenced writes the
    registry ACCEPTED came from a non-decreasing epoch sequence — once
    epoch N+1 writes, epoch N never writes again — and (``final``, at
    convergence) every deposed dispatcher is frozen, every pod record
    the registry holds is backed by a booking on the active engine, and
    the nodes agree (no double-booking across the takeover).

    The transient checks are samplable mid-window; the ``final`` checks
    only hold once the partition healed and the deposed side observed
    the new epoch, so the runner asserts them at convergence.
    """
    out: list[dict] = []
    log = list(getattr(registry, "fence_log", ()))
    for a, b in zip(log, log[1:]):
        if b < a:
            out.append(violation(
                "single-writer",
                f"accepted fenced write regressed epoch {a} -> {b}: "
                f"two leaders wrote interleaved", epochs=[a, b]))
    if not final:
        return out
    for disp in deposed:
        if not getattr(disp, "frozen", True):
            out.append(violation(
                "deposed-frozen",
                "deposed dispatcher still placing after the takeover"))
    if active_engine is not None:
        for key, rec in registry.pods().items():
            pod = active_engine.pod_status.get(key)
            if pod is None:
                out.append(violation(
                    "lost-bound-pod",
                    f"registry holds {key} but the active engine does "
                    f"not — the takeover dropped a bound pod", pod=key))
            elif (pod.node_name and rec.get("node")
                    and pod.node_name != rec["node"]):
                out.append(violation(
                    "double-booking",
                    f"{key} booked on {pod.node_name} but the registry "
                    f"says {rec['node']}: stale epoch write survived",
                    pod=key))
    return out


# -- aggregate ----------------------------------------------------------


def check_cluster(engine=None, token_scheds=None, proxy=None,
                  frontdoor=None, parked_pending: int = 0,
                  registry_journal=None, session_journal_dir=None,
                  autopilot_journal=None, gang_coordinator=None,
                  gang_slack_s: float = 0.0, ledger=None) -> list[dict]:
    """Run every applicable check; None components are skipped."""
    out: list[dict] = []
    if engine is not None:
        out.extend(check_engine(engine))
    if ledger is not None:
        out.extend(check_ledger_conservation(ledger))
    if token_scheds:
        out.extend(check_token_shares(token_scheds))
    if gang_coordinator is not None:
        out.extend(check_gang_grant_atomicity(gang_coordinator,
                                              slack_s=gang_slack_s))
    if proxy is not None:
        out.extend(check_hbm_conservation(proxy))
    if frontdoor is not None:
        out.extend(check_serving_exactly_once(frontdoor, parked_pending))
    if registry_journal:
        out.extend(check_registry_replay_idempotent(registry_journal))
    if session_journal_dir:
        out.extend(check_session_journal_idempotent(session_journal_dir))
    if autopilot_journal:
        out.extend(check_autopilot_journal_idempotent(autopilot_journal))
    return out
