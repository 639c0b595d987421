"""Per-tenant serving accounting — tokens, bytes and executions by class.
Counterpart of ``kubeshare_tpu/serving/accounting.py``.

Every request that crosses the front door is charged to its ``(tenant,
tpu_class)`` pair: admissions, sheds (by reason), completed rows
("tokens"), bytes in and out, and the shared executions the tenant rode.
The same numbers back:

- metric families on a :class:`~kubeshare_tpu_torch.obs.metrics.
  MetricsRegistry` (request latency carries trace-id exemplars on its
  ``_bucket`` lines);
- :meth:`ServingAccounting.snapshot`, the JSON view, with per-tenant
  p50/p99 derived from the latency histogram by
  :func:`~kubeshare_tpu_torch.obs.metrics.quantile_from_buckets`;
- the simulation's isolation-error math (completed rows per tenant).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from ..obs.metrics import (MetricsRegistry, default_registry,
                           quantile_from_buckets)

#: batch occupancy in rows; the servable's batch_size bounds the top
BATCH_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                 float("inf"))


class ServingAccounting:
    """Mutable per-tenant ledger + metric families for the front door."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        reg = registry if registry is not None else default_registry()
        self._lock = threading.Lock()
        # tenant -> {"class", "admitted", "shed", "completed", "failed",
        #            "tokens", "bytes_in", "bytes_out", "executions"}
        self._tenants: Dict[str, dict] = {}
        self._batches = 0
        self._batch_rows = 0
        self.requests = reg.counter(
            "kubeshare_serving_requests_total",
            "Serving requests by tenant, workload class and outcome "
            "(admitted|shed|completed|failed).",
            labels=("tenant", "tpu_class", "outcome"))
        self.sheds = reg.counter(
            "kubeshare_serving_shed_total",
            "Requests refused at the serving front door, by reason "
            "(rate-limit|max-pending|fair-share).",
            labels=("tenant", "reason"))
        self.tokens = reg.counter(
            "kubeshare_serving_tokens_total",
            "Input rows (tokens) served, by tenant and workload class.",
            labels=("tenant", "tpu_class"))
        self.bytes = reg.counter(
            "kubeshare_serving_bytes_total",
            "Request/response payload bytes, by tenant, class and "
            "direction (in|out).",
            labels=("tenant", "tpu_class", "direction"))
        self.executions = reg.counter(
            "kubeshare_serving_executions_total",
            "Shared batch executions a tenant's requests rode, by "
            "tenant and class (one batch can count for many tenants).",
            labels=("tenant", "tpu_class"))
        self.queue_depth = reg.gauge(
            "kubeshare_serving_queue_depth",
            "Requests queued at the front door, by tenant.",
            labels=("tenant",))
        self.latency = reg.histogram(
            "kubeshare_serving_request_latency_seconds",
            "Submit-to-completion latency per request (queue wait + "
            "batch wait + execute), by tenant and class; bucket lines "
            "carry trace-id exemplars.",
            labels=("tenant", "tpu_class"))
        self.batch_rows = reg.histogram(
            "kubeshare_serving_batch_rows",
            "Rows coalesced per shared execution.",
            buckets=BATCH_BUCKETS)

    def _tenant(self, tenant: str, tpu_class: str) -> dict:
        rec = self._tenants.get(tenant)
        if rec is None:
            rec = {"class": tpu_class, "admitted": 0, "shed": 0,
                   "completed": 0, "failed": 0, "tokens": 0,
                   "bytes_in": 0, "bytes_out": 0, "executions": 0}
            self._tenants[tenant] = rec
        return rec

    def note_admitted(self, tenant: str, tpu_class: str,
                      rows: int) -> None:
        with self._lock:
            self._tenant(tenant, tpu_class)["admitted"] += 1
        self.requests.inc(tenant, tpu_class, "admitted")

    def note_shed(self, tenant: str, tpu_class: str,
                  reason: str) -> None:
        with self._lock:
            self._tenant(tenant, tpu_class)["shed"] += 1
        self.requests.inc(tenant, tpu_class, "shed")
        self.sheds.inc(tenant, reason)

    def note_completed(self, tenant: str, tpu_class: str,
                       latency_s: float, rows: int, bytes_in: int,
                       bytes_out: int, trace_id: str = "") -> None:
        with self._lock:
            rec = self._tenant(tenant, tpu_class)
            rec["completed"] += 1
            rec["tokens"] += int(rows)
            rec["bytes_in"] += int(bytes_in)
            rec["bytes_out"] += int(bytes_out)
            rec["executions"] += 1
        self.requests.inc(tenant, tpu_class, "completed")
        self.tokens.inc(tenant, tpu_class, amount=rows)
        self.bytes.inc(tenant, tpu_class, "in", amount=bytes_in)
        self.bytes.inc(tenant, tpu_class, "out", amount=bytes_out)
        self.executions.inc(tenant, tpu_class)
        self.latency.observe(tenant, tpu_class, value=latency_s,
                             exemplar=trace_id or None)

    def note_failed(self, tenant: str, tpu_class: str) -> None:
        with self._lock:
            self._tenant(tenant, tpu_class)["failed"] += 1
        self.requests.inc(tenant, tpu_class, "failed")

    def note_batch(self, rows: int) -> None:
        with self._lock:
            self._batches += 1
            self._batch_rows += int(rows)
        self.batch_rows.observe(value=rows)

    def set_queue_depth(self, tenant: str, depth: int) -> None:
        self.queue_depth.set(tenant, value=depth)

    def latency_quantile(self, tenant: str, tpu_class: str,
                         q: float) -> float:
        cums, _total, count = self.latency.snapshot(tenant, tpu_class)
        if not count:
            return 0.0
        return quantile_from_buckets(self.latency.buckets, cums, q)

    def snapshot(self) -> dict:
        """Per-tenant ledger with derived p50/p99, and the batch totals."""
        with self._lock:
            tenants = {t: dict(rec) for t, rec in self._tenants.items()}
            batches, batch_rows = self._batches, self._batch_rows
        for tenant, rec in tenants.items():
            cls = rec["class"]
            rec["p50_ms"] = round(
                self.latency_quantile(tenant, cls, 0.50) * 1e3, 3)
            rec["p99_ms"] = round(
                self.latency_quantile(tenant, cls, 0.99) * 1e3, 3)
        return {
            "tenants": tenants,
            "batches": batches,
            "batch_rows": batch_rows,
            "mean_batch_rows": round(batch_rows / batches, 3)
            if batches else 0.0,
        }
