"""Seeded demand-ramp simulation for the elastic plane, in virtual
time (``scripts/bench_elastic.py``).

The port's copy of ``kubeshare_tpu/elastic/sim.py``.

The fleet, dispatcher, gang coordinator, elastic orchestrator, cooldown
ledger and decision recorder are the REAL planes on a virtual clock —
only the workload is synthetic: one SPMD gang whose chip demand follows
a declared ramp (default 2 → 4 → 1). At each phase boundary the closed
loop asks ``ElasticOrchestrator.resize`` for the new demand; the gang's
goodput each tick is the useful chip-seconds it can extract,
``min(chips booked, chips demanded) × tick``, and a tick whose resize
applied is charged as drained (zero work — pause + restate).

The oracle the bench compares against is the clairvoyant static
allocator: it holds exactly ``demand`` chips in every phase with no
transition cost, so its goodput is the demand integral. An elastic run
is judged by ``goodput_ratio`` against that unreachable bound — the
acceptance bar is ≥ 0.9 across the ramp (bench_elastic.json).

Deterministic for a given seed: virtual clock, sorted iteration, no
wall-clock reads on any decision path. ``elastic=False`` is the
baseline leg: the orchestrator is attached but disabled, and the
decision stream must stay bit-identical to a run without the plane —
the bench's bit-identity gate.
"""

from __future__ import annotations

import os
import tempfile

from .. import constants as C
from ..autopilot.cooldown import CooldownLedger
from ..gang import GangTokenCoordinator
from ..obs.decisions import DecisionRecorder
from ..scheduler.dispatcher import Dispatcher
from ..scheduler.engine import SchedulerEngine
from ..topology.discovery import FakeTopology
from .orchestrator import ElasticConfig, ElasticOrchestrator

#: default demand ramp: (phase start, chips demanded)
RAMP = ((0.0, 2), (40.0, 4), (80.0, 1))


def _gang_labels(request: float, name: str, headcount: int) -> dict:
    return {C.POD_TPU_REQUEST: str(request),
            C.POD_TPU_LIMIT: "1.0",
            C.POD_GROUP_NAME: name,
            C.POD_GROUP_HEADCOUNT: str(headcount),
            C.POD_GROUP_THRESHOLD: "1.0"}


def _gang_chips(disp, gang: str) -> int:
    with disp.lock:
        chips = {c for pod in disp.engine.pod_status.values()
                 if pod.group_key == gang
                 for c, _r, _m in pod.bookings}
    return len(chips)


def simulate_elastic(seed: int = 7, hosts: int = 2, mesh=(2, 2),
                     horizon_s: float = 120.0, tick_s: float = 1.0,
                     ramp=RAMP, headcount: int = 4,
                     request: float = 0.25, elastic: bool = True,
                     attach: bool = True, journal_path: str | None = None,
                     cfg: ElasticConfig | None = None) -> dict:
    """Run the ramp scenario. ``elastic=False`` attaches the
    orchestrator disabled (bit-identity leg); ``attach=False`` builds
    no orchestrator at all (the stream the disabled leg must match)."""
    clk = [0.0]
    clock = lambda: clk[0]  # noqa: E731 - the virtual clock
    engine = SchedulerEngine(clock=clock)
    by_host: dict = {}
    for chip in FakeTopology(hosts=hosts, mesh=mesh).chips():
        by_host.setdefault(chip.host, []).append(chip)
    for host, chips in sorted(by_host.items()):
        engine.add_node(host, chips)
    disp = Dispatcher(engine, clock=clock)
    decisions = DecisionRecorder(clock=clock, seed=seed)
    disp.attach_decisions(decisions)
    gangcoord = GangTokenCoordinator(clock=clock, used_scale=1.0)
    disp.attach_gang_coordinator(gangcoord)

    gang = "sim/trainer"
    orch = None
    if attach:
        cfg = cfg or ElasticConfig(pause_timeout_s=5.0, cooldown_s=5.0)
        orch = ElasticOrchestrator(
            disp, gang_coordinator=gangcoord,
            cooldowns=CooldownLedger(cooldown_s=cfg.cooldown_s,
                                     clock=clock),
            enabled=elastic, cfg=cfg, journal_path=journal_path,
            clock=clock)

    for i in range(headcount):
        disp.submit("sim", f"trainer-{i}",
                    _gang_labels(request, "trainer", headcount))
    disp.step(0.0)

    ramp = sorted(ramp)
    boundaries = list(ramp)
    chips_series: list[int] = []
    resizes: list[dict] = []
    goodput = oracle = 0.0
    drained_ticks = 0

    steps = int(horizon_s / tick_s)
    for _ in range(steps):
        t0 = clk[0]
        demand = next(ch for start, ch in reversed(ramp) if start <= t0)
        applied_now = False
        while boundaries and boundaries[0][0] <= t0:
            _start, target = boundaries.pop(0)
            if orch is not None:
                out = orch.resize(gang, target, reason="sim-ramp",
                                  now=t0)
                resizes.append({"at_s": t0, "target": target,
                                "outcome": out.get("outcome")})
                applied_now = out.get("outcome") == "applied"
        chips = _gang_chips(disp, gang)
        chips_series.append(chips)
        # a tick that flipped is drained: pause + restate eat the step
        if applied_now:
            drained_ticks += 1
        else:
            goodput += min(chips, demand) * tick_s
        oracle += demand * tick_s
        clk[0] = t0 + tick_s

    out = {
        "seed": seed,
        "elastic": bool(elastic),
        "attached": bool(attach),
        "horizon_s": horizon_s,
        "ramp": [list(p) for p in ramp],
        "chips": {"start": chips_series[0], "final": chips_series[-1],
                  "min": min(chips_series), "max": max(chips_series)},
        "resizes": resizes,
        "resizes_applied": sum(1 for r in resizes
                               if r["outcome"] == "applied"),
        "drained_ticks": drained_ticks,
        "goodput_chip_s": round(goodput, 6),
        "oracle_chip_s": round(oracle, 6),
        "goodput_ratio": round(goodput / oracle, 6) if oracle else 1.0,
        "decision_kinds": decisions.counts(),
    }
    if orch is not None:
        out["by_outcome"] = dict(orch.by_outcome)
    return out


def main(argv=None) -> int:  # pragma: no cover - exercised by bench
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--static", action="store_true",
                    help="disable the orchestrator (baseline leg)")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="elastic-sim-") as td:
        print(json.dumps(simulate_elastic(
            seed=args.seed, elastic=not args.static,
            journal_path=os.path.join(td, "elastic.jsonl")), indent=2,
            sort_keys=True))
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
