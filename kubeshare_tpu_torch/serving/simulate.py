"""Deterministic virtual-time serving simulation — counterpart of
``kubeshare_tpu/serving/simulate.py``.

Seeded Poisson arrivals per tenant drive a :class:`FrontDoor` and a
:class:`ContinuousBatcher` against a modeled device: executions are
instantaneous in host time but occupy the device for ``exec_time_s`` of
virtual time, so capacity is ``max_batch / exec_time_s`` rows/s and
offered load above it builds queues and sheds — the regime the serving
plane must be correct in. Same run, same seed, same stats: the event loop
is a heap of ``(time, seq, kind, payload)`` and the only clock is the loop
variable. The SLO evaluator (``slo=``) is not ported yet.
"""

from __future__ import annotations

import heapq
import random
from typing import Dict, List, Optional

import numpy as np

import torch

from ..obs.metrics import MetricsRegistry
from .accounting import ServingAccounting
from .batcher import ContinuousBatcher, LocalServable
from .frontdoor import FrontDoor, Overloaded


def simulate_serving(n_requests: int = 400, tenants: int = 4,
                     qps: float = 200.0, seed: int = 0,
                     latency_tenants: int = 1,
                     max_batch: int = 8, max_wait_s: float = 0.02,
                     exec_time_s: float = 0.01, max_queue: int = 64,
                     rate: Optional[float] = None,
                     slo=None, slo_every_s: float = 1.0,
                     features: int = 8) -> dict:
    """Run ``n_requests`` aggregate arrivals; return per-tenant stats.
    ``slo`` and ``slo_every_s`` keep the JAX signature: an evaluator
    raises ``NotImplementedError`` until the SLO module is ported."""
    if slo is not None:
        raise NotImplementedError("the SLO evaluator is not ported yet")
    rng = random.Random(seed)
    names = ["tenant-%d" % i for i in range(tenants)]
    classes = {n: ("latency" if i < latency_tenants else "best-effort")
               for i, n in enumerate(names)}
    acct = ServingAccounting(MetricsRegistry())
    now_box = [0.0]
    fd = FrontDoor(max_queue=max_queue, clock=lambda: now_box[0],
                   accounting=acct)
    for n in names:
        fd.register_tenant(n, tpu_class=classes[n], rate=rate,
                           burst=rate)
    weights = torch.arange(1, features + 1, dtype=torch.float32)
    servable = LocalServable(lambda x: x * weights, batch_size=max_batch)
    batcher = ContinuousBatcher(fd, servable, max_batch=max_batch,
                                max_wait_s=max_wait_s,
                                clock=lambda: now_box[0])

    per_rate = qps / max(1, tenants)
    events: List[tuple] = []
    seq = 0
    for n in names:
        t = rng.expovariate(per_rate)
        heapq.heappush(events, (t, seq, "arrive", n))
        seq += 1
    arrivals = {n: 0 for n in names}
    total_arrivals = 0
    chip_free_at = 0.0

    def maybe_serve(now: float) -> float:
        """Ship the batches the device can take; return chip_free_at."""
        free = chip_free_at
        while now >= free:
            if not batcher.ready(now):
                break
            done = batcher.step(now, force=True)
            if not done:
                break
            free = now + exec_time_s
        return free

    while events:
        now, _s, kind, payload = heapq.heappop(events)
        now_box[0] = now
        if kind == "arrive":
            tenant = payload
            arrivals[tenant] += 1
            total_arrivals += 1
            x = np.full((1, features),
                        float(arrivals[tenant]), dtype=np.float32)
            try:
                fd.submit(tenant, x, now=now,
                          trace_id="sim-%s-%d"
                          % (tenant, arrivals[tenant]))
            except Overloaded:
                pass
            if total_arrivals < n_requests:
                nxt = now + rng.expovariate(per_rate)
                heapq.heappush(events, (nxt, seq, "arrive", tenant))
                seq += 1
        chip_free_at = maybe_serve(now)
        deadline = batcher.next_deadline()
        if deadline is not None:
            wake = max(deadline, chip_free_at)
            heapq.heappush(events, (wake, seq, "svc", None))
            seq += 1

    # drain whatever is still queued, honouring the device's occupancy
    while fd.queued_rows():
        now_box[0] = max(now_box[0], chip_free_at)
        if batcher.step(now_box[0], force=True):
            chip_free_at = now_box[0] + exec_time_s

    stats: Dict[str, dict] = {}
    snap = acct.snapshot()
    for n in names:
        rec = snap["tenants"].get(n, {})
        stats[n] = {
            "class": classes[n],
            "offered": arrivals[n],
            "admitted": rec.get("admitted", 0),
            "shed": rec.get("shed", 0),
            "completed": rec.get("completed", 0),
            "p50_ms": rec.get("p50_ms", 0.0),
            "p99_ms": rec.get("p99_ms", 0.0),
        }
    # isolation is a within-class guarantee: latency tenants *should*
    # out-serve best-effort ones, so deviation is measured against the
    # mean of same-class peers (max over classes with >= 2 tenants)
    isolation_error = 0.0
    for cls in ("latency", "best-effort"):
        completed = [s["completed"] for s in stats.values()
                     if s["class"] == cls]
        if len(completed) < 2:
            continue
        mean = sum(completed) / len(completed)
        if mean:
            isolation_error = max(
                isolation_error,
                max(abs(c - mean) / mean for c in completed))
    out = {
        "tenants": stats,
        "duration_s": round(now_box[0], 6),
        "offered": total_arrivals,
        "admitted": fd.admitted_total,
        "shed": fd.shed_total,
        "completed": fd.completed_total,
        "dropped": fd.admitted_total - fd.completed_total
        - fd.failed_total,
        "isolation_error": round(isolation_error, 4),
        "executions": batcher.executions,
        "mean_batch_rows": snap["mean_batch_rows"],
        "capacity_qps": round(max_batch / exec_time_s, 3),
    }
    return out

