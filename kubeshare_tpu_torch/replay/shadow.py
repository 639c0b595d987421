"""Shadow-scheduler replay: drive a recorded decision trace through a
candidate Dispatcher/engine build in virtual time (doc/replay.md).

The port's copy of ``kubeshare_tpu/replay/shadow.py``.

The harness is symmetric by construction — :func:`record_trace` (the
ground-truth run) and :func:`replay_trace` (the candidate run) drive
the *same* tick loop (:func:`drive`) over the *same* virtual clock
(the chaos orchestrator's ``self.now`` pattern, orchestrator.py), so
on an unchanged build the two traces come out byte-identical and any
diff is attributable to the candidate's code, not the harness.

A trace's **input** entries (``submit`` / ``delete`` /
``node-health``) are re-applied at their recorded virtual timestamps;
everything else — placements, denials, preemption victims, autopilot
moves, view deltas, rng draws — is re-derived by the candidate build
and lands in its own fresh :class:`~..obs.decisions.DecisionRecorder`.
Recorded rng draws are primed into the candidate recorder so entropy
(trace ids) cannot silently diverge even across rng changes.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

from ..obs.decisions import DecisionRecorder, parse_trace_jsonl

#: virtual-time step, matching the chaos orchestrator's TICK_S
TICK_S = 0.05
#: virtual seconds the loop keeps stepping past the last event while
#: work is still in flight (pending/parked pods)
DRAIN_BOUND_S = 60.0


class VirtualClock:
    """The replay clock: ``now`` advanced by the drive loop only."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t


def build_cluster(clock, fleet_nodes: dict, config: Optional[dict] = None,
                  engine_factory: Optional[Callable] = None):
    """A fresh engine + dispatcher on *clock* from a trace's ``fleet``
    entry (``{node: [chip labels]}``). ``engine_factory(clock)`` swaps
    in a candidate engine build (the perturbation seam the bench
    uses); ``config`` re-applies the recorded dispatcher knobs, plus
    the sharding ones: ``shards`` (> 1 builds a
    :class:`~..scheduler.shard.ShardedDispatcher`) and ``shard_route``
    (``"score"``/``"cell"``). The fleet lands via ONE ``set_fleet``
    (one topology rebuild, not one per node — identical end state,
    and the difference between seconds and minutes at 1k nodes)."""
    from ..scheduler.shard import make_dispatcher
    from ..topology.chip import ChipInfo

    cfg = dict(config or {})
    fleet = {node: [ChipInfo.from_labels(lb) for lb in labels]
             for node, labels in sorted(fleet_nodes.items())}
    disp = make_dispatcher(
        fleet, shards=int(cfg.get("shards", 1)),
        route=cfg.get("shard_route", "score"),
        clock=clock,
        gc_period_s=float(cfg.get("gc_period_s", 30.0)),
        retry_backoff_s=float(cfg.get("retry_backoff_s", 1.0)),
        max_pending=cfg.get("max_pending"),
        engine_factory=engine_factory)
    return disp.engine, disp


def _apply_input(disp, entry: dict, now: float) -> None:
    """Re-drive one recorded input against the candidate dispatcher."""
    from ..scheduler.dispatcher import Overloaded

    kind = entry["kind"]
    if kind == "submit":
        ns, _, name = entry["pod"].partition("/")
        try:
            disp.submit(ns, name, dict(entry.get("labels", {})),
                        uid=entry.get("uid", ""))
        except Overloaded:
            pass            # the shed is itself a recorded outcome
    elif kind == "delete":
        disp.delete(entry["pod"])
    elif kind == "node-health":
        node, state = entry["node"], entry["state"]
        with disp.lock:
            dead = state in ("dead", "quarantined")
            disp.engine.veto_health(node, dead)
            if node in disp.engine.chips_by_node:
                disp.engine.set_node_health(node, not dead)
        if state == "dead":
            disp.evict_node(node, now, reason="replay: node dead")


def drive(disp, vclock: VirtualClock, inputs: List[dict], until: float,
          tick_s: float = TICK_S, drain_s: float = DRAIN_BOUND_S) -> float:
    """THE tick loop — identical for record and replay. Applies each
    input at its recorded ``t``, steps the dispatcher every ``tick_s``
    of virtual time, and past *until* keeps draining (bounded by
    ``drain_s``) while pods are still pending/parked. Returns the
    final virtual time."""
    pending = sorted(inputs, key=lambda e: (e["t"], e["seq"]))
    i = 0
    deadline = until + drain_s
    while True:
        now = vclock.t
        while i < len(pending) and pending[i]["t"] <= now + 1e-9:
            _apply_input(disp, pending[i], now)
            i += 1
        disp.step(now)
        if now >= until - 1e-9 and i >= len(pending):
            with disp.lock:
                quiet = not disp._pending and not disp._parked
            if quiet or now >= deadline - 1e-9:
                break
        vclock.t = round(now + tick_s, 6)
    return vclock.t


def record_trace(events: List[dict], fleet_nodes: dict, *, seed: int = 0,
                 tick_s: float = TICK_S, drain_s: float = DRAIN_BOUND_S,
                 config: Optional[dict] = None,
                 capacity: int = 65536,
                 engine_factory: Optional[Callable] = None
                 ) -> DecisionRecorder:
    """Ground-truth run: drive *events* (``{"t", "op", ...}`` dicts, op
    ``submit``/``delete``) through a fresh build, recording every
    decision. The returned recorder's trace is what
    :func:`replay_trace` replays."""
    vclock = VirtualClock()
    cfg = dict(config or {})
    eng, disp = build_cluster(vclock, fleet_nodes, cfg, engine_factory)
    rec = DecisionRecorder(capacity=capacity, clock=vclock, seed=seed)
    rec.meta.update(tick_s=tick_s, drain_s=drain_s, config=cfg)
    disp.attach_decisions(rec)
    inputs = []
    until = 0.0
    for seq, ev in enumerate(sorted(events,
                                    key=lambda e: (e["t"], e.get("name",
                                                   e.get("key", ""))))):
        until = max(until, ev["t"])
        if ev["op"] == "submit":
            inputs.append({"kind": "submit", "seq": seq, "t": ev["t"],
                           "pod": f"{ev['namespace']}/{ev['name']}",
                           "labels": dict(ev["labels"]),
                           "uid": ev.get("uid", "")})
        elif ev["op"] == "delete":
            inputs.append({"kind": "delete", "seq": seq, "t": ev["t"],
                           "pod": ev["key"]})
        else:
            raise ValueError(f"unknown event op {ev['op']!r}")
    drive(disp, vclock, inputs, until, tick_s, drain_s)
    return rec


def replay_trace(trace, *, engine_factory: Optional[Callable] = None,
                 tick_s: Optional[float] = None,
                 capacity: int = 65536,
                 config: Optional[dict] = None) -> DecisionRecorder:
    """Candidate run: feed a recorded trace (a :func:`~..obs.decisions.
    parse_trace_jsonl` dict, raw JSONL text, or a ground-truth
    :class:`DecisionRecorder`) through a candidate build in virtual
    time; returns the candidate's recorder for diffing. *config* keys
    override the recorded dispatcher config — ``{"shards": 4}`` replays
    a single-lock trace through a sharded build (the shard-equivalence
    gate, doc/sharding.md)."""
    from ..obs.decisions import trace_jsonl

    if isinstance(trace, DecisionRecorder):
        trace = parse_trace_jsonl(trace_jsonl(trace))
    elif isinstance(trace, str):
        trace = parse_trace_jsonl(trace)
    header = trace["header"]
    entries = trace["entries"]
    meta = header.get("meta", {})
    fleet = next((e for e in entries if e["kind"] == "fleet"), None)
    if fleet is None:
        raise ValueError("decision trace has no fleet entry; only "
                         "harness-recorded traces are replayable")
    vclock = VirtualClock()
    cfg = dict(meta.get("config") or {})
    cfg.update(config or {})
    eng, disp = build_cluster(vclock, fleet.get("nodes", {}),
                              cfg, engine_factory)
    rec = DecisionRecorder(capacity=capacity, clock=vclock,
                           seed=int(header.get("seed", 0)))
    rec.meta.update(meta)
    rec.prime_draws([e for e in entries if e["kind"] == "rng"])
    disp.attach_decisions(rec)
    inputs = [e for e in entries
              if e["kind"] in ("submit", "delete", "node-health")]
    until = max((e["t"] for e in inputs), default=0.0)
    drive(disp, vclock, inputs, until,
          tick_s if tick_s is not None
          else float(meta.get("tick_s", TICK_S)),
          float(meta.get("drain_s", DRAIN_BOUND_S)))
    return rec


def replay_wall_seconds(fn) -> tuple:
    """(result, wall seconds) — the bench's replay-speed measurement."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0
