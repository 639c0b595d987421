"""Seeded churn simulation for the rightsizer, in virtual time
(``sim --rightsize``).

The port's copy of ``kubeshare_tpu/rightsize/sim.py``.

The fleet, dispatcher, ledger, SLO evaluator, blame graph and decision
recorder are all the REAL planes on a virtual clock — only the
workload is synthetic: each tenant runs one fractional pod whose duty
cycle (fraction of the window it actually wants) is drawn from a
seeded profile and re-drawn at churn phase boundaries. Most tenants
are over-provisioned (declared ``tpu_request`` well above duty); a
couple are under-provisioned and burn their grant-wait SLO budget
under static shares.

Per tick the model serves each tenant at most its *booked* share
(measured, not declared — exactly what the ledger sees), accrues
backlog for unserved demand, and records the implied grant wait
against the tenant's SLO. The ledger gets real grant/execute/release
transitions, so ``granted-active`` vs ``granted-idle`` accounting —
the controller's shrink signal — is produced by the same code paths
production uses, and conservation stays checkable. Waits feed the
blame graph, so grows pick their squeeze victims the same way too.

Everything is deterministic for a given seed: virtual clock, seeded
RNG, sorted iteration. Two runs with the same arguments produce
byte-identical JSON — the bench and CI smoke gate on that.
"""

from __future__ import annotations

import random

from .. import constants as C
from ..obs.blame import BlameGraph
from ..obs.decisions import DecisionRecorder
from ..obs.ledger import ChipTimeLedger
from ..obs.slo import SloEvaluator
from ..scheduler.shard import make_dispatcher
from ..topology.discovery import FakeTopology
from .controller import RightsizeConfig, Rightsizer

#: the declared objective every sim tenant carries
SLO_OBJECTIVE = "grant-wait-p99<=500ms"
SLO_BOUND_S = 0.5
#: queued demand is bounded (clients time out and retry) — an unbounded
#: backlog would keep the implied wait above the SLO bound for minutes
#: after capacity catches up, which no real grant queue does
BACKLOG_CAP_S = 2.0


def _fleet(hosts: int, mesh=(2, 2)) -> dict:
    by_host: dict = {}
    for chip in FakeTopology(hosts=hosts, mesh=mesh).chips():
        by_host.setdefault(chip.host, []).append(chip)
    return by_host


def _labels(request: float) -> dict:
    return {C.POD_TPU_REQUEST: str(request), C.POD_TPU_LIMIT: "1.0"}


class _Tenant:
    __slots__ = ("name", "declared", "duty", "lo", "hi", "backlog",
                 "arrive_s", "depart_s", "alive")

    def __init__(self, name, declared, lo, hi, rng,
                 arrive_s=0.0, depart_s=None):
        self.name = name
        self.declared = declared
        self.lo, self.hi = lo, hi
        self.duty = round(rng.uniform(lo, hi), 4)
        self.backlog = 0.0
        self.arrive_s = arrive_s
        self.depart_s = depart_s
        self.alive = arrive_s <= 0.0

    def churn(self, rng) -> None:
        self.duty = round(rng.uniform(self.lo, self.hi), 4)

    @property
    def pod(self) -> str:
        return f"{self.name}/w0"


def simulate_rightsize(cold: int = 6, hot: int = 2, seed: int = 7,
                       hosts: int = 2, shards: int = 1,
                       horizon_s: float = 3600.0, tick_s: float = 5.0,
                       cadence_s: float = 30.0, phase_s: float = 900.0,
                       rightsize: bool = True,
                       cfg: RightsizeConfig | None = None) -> dict:
    """Run the churn scenario; ``rightsize=False`` is the static
    baseline (controller attached but disabled — the decision stream
    must stay empty, which the bench's replay gate checks)."""
    rng = random.Random(seed)
    clk = [0.0]
    clock = clk.__getitem__
    disp = make_dispatcher(_fleet(hosts), shards=shards, clock=lambda: clk[0])
    ledger = ChipTimeLedger(clock=lambda: clk[0])
    slo = SloEvaluator(clock=lambda: clk[0])
    blame = BlameGraph(ledger)
    decisions = DecisionRecorder(clock=lambda: clk[0], seed=seed)
    disp.attach_decisions(decisions)

    cfg = cfg or RightsizeConfig(window_s=600.0, cooldown_s=25.0,
                                 idle_frac=0.3, grow_step=0.1,
                                 min_delta=0.04, pack_util=0.35)
    rz = Rightsizer(disp, slo=slo, ledger=ledger, blame=blame,
                    enabled=rightsize, cfg=cfg, clock=lambda: clk[0])

    tenants: list[_Tenant] = []
    for i in range(cold):
        tenants.append(_Tenant(f"cold-{i}", declared=0.6,
                               lo=0.05, hi=0.15, rng=rng))
    for i in range(hot):
        tenants.append(_Tenant(f"hot-{i}", declared=0.25,
                               lo=0.45, hi=0.6, rng=rng))
    # churn: one cold tenant departs mid-run, a late one arrives — the
    # pack stage has real holes to consolidate and the controller sees
    # a tenant it has no history for
    if cold >= 2:
        tenants[cold - 1].depart_s = horizon_s * 0.5
    tenants.append(_Tenant("late-0", declared=0.4, lo=0.05, hi=0.15,
                           rng=rng, arrive_s=horizon_s * 0.55))

    for t in tenants:
        slo.declare(t.name, SLO_OBJECTIVE)
        if t.alive:
            disp.submit(t.name, "w0", _labels(t.declared))
    disp.step(0.0)

    alerts: list[dict] = []
    equiv_series: list[float] = []
    chips_series: list[int] = []
    resized = moved = 0
    next_cycle = cadence_s
    next_phase = phase_s
    declared_total = 0.0

    steps = int(horizon_s / tick_s)
    for step_i in range(steps):
        t0 = clk[0]
        t1 = t0 + tick_s
        # -- churn events ------------------------------------------------
        for t in tenants:
            if not t.alive and 0.0 < t.arrive_s <= t0:
                t.alive = True
                slo.declare(t.name, SLO_OBJECTIVE)
                disp.submit(t.name, "w0", _labels(t.declared))
                disp.step(t0)
            if t.alive and t.depart_s is not None and t.depart_s <= t0:
                t.alive = False
                disp.delete(t.pod)
                disp.step(t0)
        if t0 >= next_phase:
            next_phase += phase_s
            for t in tenants:
                t.churn(rng)
        # -- serve one tick against the booked shares --------------------
        pods = disp.engine.pod_status
        by_chip: dict[str, list] = {}
        booked_total = 0.0
        for t in sorted(tenants, key=lambda x: x.name):
            if not t.alive:
                continue
            pod = pods.get(t.pod)
            if pod is None or not pod.bookings:
                continue
            chip, share, _mem = pod.bookings[0]
            booked_total += share
            by_chip.setdefault(chip, []).append((t, share))
        for chip in sorted(by_chip):
            cursor = t0
            for t, share in by_chip[chip]:
                demand = t.duty * tick_s
                granted = share * tick_s
                served = min(t.backlog + demand, granted)
                t.backlog = min(max(0.0, t.backlog + demand - served),
                                BACKLOG_CAP_S)
                wait_s = t.backlog / max(share, 1e-6)
                ledger.grant(chip, t.pod, tpu_class="latency",
                             now=cursor)
                if served > 0.0:
                    ledger.execute_begin(chip, now=cursor)
                    ledger.execute_end(chip, now=cursor + served)
                ledger.release(chip, now=cursor + granted)
                cursor += granted
                slo.record(t.name, "grant-wait", value_s=wait_s,
                           now=t1)
                if wait_s > SLO_BOUND_S:
                    blame.account_wait(chip, t.pod, "latency",
                                       wait_s=min(wait_s, tick_s),
                                       now=t1)
        clk[0] = t1
        for event in slo.evaluate(t1):
            alerts.append(event.to_dict())
        equiv_series.append(round(booked_total, 6))
        chips_series.append(len(by_chip))
        declared_total = round(sum(t.declared for t in tenants
                                   if t.alive), 6)
        # -- the closed loop ---------------------------------------------
        if t1 >= next_cycle:
            next_cycle += cadence_s
            out = rz.cycle(t1)
            resized += len(out.get("applied", []))
            mv = out.get("move_result") or {}
            moved += len(mv.get("applied", []))

    tail = max(1, len(equiv_series) // 4)
    steady = equiv_series[-tail:]
    steady_mean = round(sum(steady) / len(steady), 6)
    cons_ok = ledger.check(clk[0]) == []
    return {
        "seed": seed,
        "rightsize": bool(rightsize),
        "shards": shards,
        "horizon_s": horizon_s,
        "tenants": {t.name: {"declared": t.declared,
                             "final_duty": t.duty,
                             "alive": t.alive} for t in tenants},
        "alerts": alerts,
        "alerts_firing": sorted({(a["tenant"], a["objective"])
                                 for a in alerts
                                 if a["state"] == "firing"}),
        "firing_at_end": slo.firing(),
        "slo_met": not slo.firing(),
        "chip_equivalents": {
            "declared": declared_total,
            "mean": round(sum(equiv_series) / len(equiv_series), 6),
            "steady": steady_mean,
            "final": equiv_series[-1],
        },
        "chips_in_use": {"start": chips_series[0],
                         "final": chips_series[-1],
                         "min": min(chips_series)},
        "resizes_applied": resized,
        "moves_applied": moved,
        "decision_kinds": decisions.counts(),
        "ledger_conservation_ok": cons_ok,
        "rightsizer": {"cycles": rz.cycles,
                       "applied_total": rz.applied_total,
                       "rolled_back_total": rz.rolled_back_total},
    }
