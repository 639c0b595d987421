"""Request-level front door: per-tenant queues, admission, park/resume.
Counterpart of ``kubeshare_tpu/serving/frontdoor.py``.

Tenants submit small inference requests; the front door either *admits*
one into the tenant's FIFO or *sheds* it with :class:`Overloaded`, the
typed refusal (HTTP 429) whose reasons are the scheduler plane's.

Admission runs three gates, cheapest first:

1. **token bucket** — a per-tenant rate and burst cap (reason
   ``rate-limit``), refilled from the injected clock, so virtual-time
   simulations and tests are exact;
2. **global bound** — total queued requests ≥ ``max_queue`` sheds with
   ``max-pending``;
3. **fair share** — with ≥ 2 active tenants, a tenant already holding
   ``max(1, max_queue // active)`` queued slots sheds with ``fair-share``,
   so one flooding tenant cannot starve the rest.

Dequeue is class-aware: ``latency`` tenants' queues drain strictly before
``best-effort`` ones, round-robin across tenants within a class.

Park/resume treats a tenant as a durable *session*: :meth:`FrontDoor.park`
freezes the queued payloads and the delivered-sequence watermark into a
JSON manifest and :meth:`FrontDoor.resume` replays it into any front door.
The watermark makes delivery exactly-once: a request is in the manifest or
already counted delivered, never both.

With ``slo=`` (an :class:`~kubeshare_tpu_torch.obs.slo.SloEvaluator`) a
tenant registered with ``slo_spec`` declares its objectives, and the
batcher records each completion against them; sheds, parks and resumes
are flight-recorder notes; the front door's lock is a tracked one
(``"frontdoor"``).
"""

from __future__ import annotations

import base64
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np

from ..obs import flight as obs_flight
from ..obs import prof as obs_prof
from .accounting import ServingAccounting

CLASSES = ("latency", "best-effort")


class Overloaded(RuntimeError):
    """Typed admission refusal (HTTP 429): a bounded queue or a rate
    refused the submit — the port's copy of the JAX scheduler plane's
    ``Overloaded`` (``kubeshare_tpu/scheduler/dispatcher.py``)."""

    def __init__(self, msg: str, reason: str = "max-pending"):
        super().__init__(msg)
        self.reason = reason


class SessionParked(RuntimeError):
    """The tenant session was parked; re-attach and resume to continue."""


class ServeRequest:
    """One admitted request: payload + future the caller waits on."""

    __slots__ = ("tenant", "tpu_class", "rid", "x", "rows", "trace_id",
                 "submitted_at", "value", "error", "completed_at",
                 "_event")

    def __init__(self, tenant: str, tpu_class: str, rid: int,
                 x: np.ndarray, trace_id: str, submitted_at: float):
        self.tenant = tenant
        self.tpu_class = tpu_class
        self.rid = rid
        self.x = x
        self.rows = int(x.shape[0])
        self.trace_id = trace_id
        self.submitted_at = submitted_at
        self.value: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.completed_at: Optional[float] = None
        self._event = threading.Event()

    @property
    def signature(self):
        return (tuple(self.x.shape[1:]), str(self.x.dtype))

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def _complete(self, value: np.ndarray, now: float) -> None:
        self.value = value
        self.completed_at = now
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        self.error = exc
        self._event.set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError("request %s/%d not completed"
                               % (self.tenant, self.rid))
        if self.error is not None:
            raise self.error
        return self.value


class TokenBucket:
    """Explicitly-clocked rate limiter: deterministic under virtual time."""

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._last: Optional[float] = None

    def try_take(self, now: float, n: float = 1.0) -> bool:
        if self._last is None:
            self._last = now
        elif now > self._last:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._last) * self.rate)
            self._last = now
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False


class _Tenant:
    __slots__ = ("name", "tpu_class", "bucket", "queue", "next_rid",
                 "delivered", "token")

    def __init__(self, name: str, tpu_class: str,
                 bucket: Optional[TokenBucket], token: str):
        self.name = name
        self.tpu_class = tpu_class
        self.bucket = bucket
        self.queue: deque = deque()
        self.next_rid = 0      # sequence of the next submitted request
        self.delivered = 0     # watermark: requests completed or failed
        self.token = token     # resume token, rides the park manifest


class FrontDoor:
    """Admission and per-tenant queues feeding a ContinuousBatcher."""

    def __init__(self, max_queue: int = 256,
                 clock: Callable[[], float] = time.monotonic,
                 accounting: Optional[ServingAccounting] = None,
                 slo=None, recorder=None):
        self.max_queue = int(max_queue)
        self.clock = clock
        self.accounting = accounting or ServingAccounting()
        self.slo = slo
        self.recorder = (recorder if recorder is not None
                         else obs_flight.default_recorder())
        # admission, batching and accounting serialize under this tracked
        # lock; the wakeup condition shares it
        self.lock = obs_prof.TrackedLock("frontdoor")
        self.wakeup = threading.Condition(self.lock)
        self._tenants: Dict[str, _Tenant] = {}
        self._rr = {cls: 0 for cls in CLASSES}  # round-robin cursors
        self.admitted_total = 0
        self.shed_total = 0
        self.completed_total = 0
        self.failed_total = 0
        self.batcher = None    # set by ContinuousBatcher

    # -- setup ---------------------------------------------------------------

    def register_tenant(self, tenant: str, tpu_class: str = "best-effort",
                        rate: Optional[float] = None,
                        burst: Optional[float] = None,
                        slo_spec: str = "") -> str:
        """Declare a tenant; returns its serving resume token."""
        if tpu_class not in CLASSES:
            raise ValueError("unknown tpu_class %r" % (tpu_class,))
        with self.lock:
            t = self._tenants.get(tenant)
            if t is None:
                bucket = (TokenBucket(rate, burst if burst is not None
                                      else max(1.0, rate))
                          if rate else None)
                t = _Tenant(tenant, tpu_class, bucket,
                            os.urandom(8).hex())
                self._tenants[tenant] = t
            else:
                t.tpu_class = tpu_class
        if slo_spec and self.slo is not None:
            from ..obs.slo import parse_slo
            self.slo.declare(tenant, parse_slo(slo_spec))
        return t.token

    # -- admission -----------------------------------------------------------

    def _check_admission(self, t: _Tenant, now: float) -> None:
        if t.bucket is not None and not t.bucket.try_take(now):
            self._shed(t, "rate-limit")
        total = sum(len(x.queue) for x in self._tenants.values())
        if total >= self.max_queue:
            self._shed(t, "max-pending")
        active = sum(1 for x in self._tenants.values() if x.queue)
        if not t.queue:
            active += 1
        if active >= 2:
            share = max(1, self.max_queue // active)
            if len(t.queue) >= share:
                self._shed(t, "fair-share")

    def _shed(self, t: _Tenant, reason: str) -> None:
        self.shed_total += 1
        self.accounting.note_shed(t.name, t.tpu_class, reason)
        self.recorder.note("serving", "shed", tenant=t.name,
                           reason=reason)
        raise Overloaded("serving: tenant %s shed (%s)"
                         % (t.name, reason), reason)

    def submit(self, tenant: str, x, trace_id: str = "",
               tpu_class: str = "best-effort",
               now: Optional[float] = None) -> ServeRequest:
        """Admit one request or raise :class:`Overloaded` (HTTP 429)."""
        arr = np.atleast_2d(np.asarray(x))
        if now is None:
            now = self.clock()
        with self.lock:
            t = self._tenants.get(tenant)
            if t is None:
                t = _Tenant(tenant, tpu_class, None, os.urandom(8).hex())
                self._tenants[tenant] = t
            self._check_admission(t, now)
            req = ServeRequest(tenant, t.tpu_class, t.next_rid, arr,
                               trace_id, now)
            t.next_rid += 1
            t.queue.append(req)
            self.admitted_total += 1
            self.accounting.note_admitted(t.name, t.tpu_class, req.rows)
            self.accounting.set_queue_depth(t.name, len(t.queue))
            self.wakeup.notify_all()
        return req

    # -- dequeue -------------------------------------------------------------

    def queued_rows(self) -> int:
        with self.lock:
            return sum(r.rows for t in self._tenants.values()
                       for r in t.queue)

    def oldest_submitted_at(self) -> Optional[float]:
        with self.lock:
            head = self._head_locked()
            return head.submitted_at if head else None

    def _head_locked(self) -> Optional[ServeRequest]:
        """Oldest latency-class head, else oldest best-effort head."""
        for cls in CLASSES:
            best = None
            for t in self._tenants.values():
                if t.tpu_class != cls or not t.queue:
                    continue
                if best is None or t.queue[0].submitted_at < best.submitted_at:
                    best = t.queue[0]
            if best is not None:
                return best
        return None

    def pop_batch(self, max_rows: int) -> List[ServeRequest]:
        """Drain up to ``max_rows`` compatible rows, latency first.

        The head is the oldest latency-class request (else the oldest
        best-effort one); the rest of the batch is filled round-robin
        across tenants of the same dtype and shape signature, the latency
        class exhausted before best-effort is considered."""
        with self.lock:
            head = self._head_locked()
            if head is None:
                return []
            sig = head.signature
            # the head ships unconditionally: it is why the batcher
            # decided to ship at all (max-wait)
            ht = self._tenants[head.tenant]
            ht.queue.popleft()
            self.accounting.set_queue_depth(ht.name, len(ht.queue))
            batch: List[ServeRequest] = [head]
            rows = head.rows
            for cls in CLASSES:
                names = [t.name for t in self._tenants.values()
                         if t.tpu_class == cls]
                if not names:
                    continue
                if head.tenant in names:
                    # fair fill: the rotation continues just past the
                    # head's tenant, which already gave a row
                    start = (names.index(head.tenant) + 1) % len(names)
                else:
                    start = self._rr[cls] % len(names)
                progressed = True
                while progressed and rows < max_rows:
                    progressed = False
                    for i in range(len(names)):
                        t = self._tenants[names[(start + i) % len(names)]]
                        if not t.queue:
                            continue
                        front = t.queue[0]
                        if (front.signature != sig
                                or rows + front.rows > max_rows):
                            continue
                        t.queue.popleft()
                        batch.append(front)
                        rows += front.rows
                        progressed = True
                        self.accounting.set_queue_depth(
                            t.name, len(t.queue))
                self._rr[cls] += 1
            return batch

    def note_delivered(self, req: ServeRequest, failed: bool = False) -> None:
        with self.lock:
            t = self._tenants.get(req.tenant)
            if t is not None:
                t.delivered += 1
            if failed:
                self.failed_total += 1
            else:
                self.completed_total += 1

    # -- park/resume ---------------------------------------------------------

    def park(self, tenant: str) -> dict:
        """Freeze a tenant session into a JSON-serializable manifest.

        Queued requests move into the manifest (their futures raise
        :class:`SessionParked`); the delivered watermark rides along, so
        :meth:`resume` continues the sequence with no replay and no gap.
        Call between batcher steps: a batch executing completes to the
        old futures first."""
        with self.lock:
            t = self._tenants.pop(tenant, None)
            if t is None:
                raise KeyError("unknown tenant %r" % (tenant,))
            pending = list(t.queue)
            t.queue.clear()
            manifest = {
                "tenant": t.name,
                "class": t.tpu_class,
                "token": t.token,
                "next_rid": t.next_rid,
                "delivered": t.delivered,
                "pending": [{
                    "rid": r.rid,
                    "trace": r.trace_id,
                    "dtype": str(r.x.dtype),
                    "shape": list(r.x.shape),
                    "data": base64.b64encode(
                        np.ascontiguousarray(r.x).tobytes()).decode(),
                } for r in pending],
            }
            if t.bucket is not None:
                manifest["rate"] = t.bucket.rate
                manifest["burst"] = t.bucket.burst
            self.accounting.set_queue_depth(t.name, 0)
        for r in pending:
            r._fail(SessionParked(
                "tenant %s parked; resume with its manifest" % tenant))
        self.recorder.note("serving", "park", tenant=tenant,
                           pending=len(pending),
                           watermark=manifest["delivered"])
        return manifest

    def resume(self, manifest: dict,
               now: Optional[float] = None) -> List[ServeRequest]:
        """Replay a parked manifest; returns the re-queued requests."""
        if now is None:
            now = self.clock()
        tenant = manifest["tenant"]
        with self.lock:
            if tenant in self._tenants:
                raise ValueError("tenant %r already active" % (tenant,))
            bucket = (TokenBucket(manifest["rate"], manifest["burst"])
                      if manifest.get("rate") else None)
            t = _Tenant(tenant, manifest.get("class", "best-effort"),
                        bucket, manifest["token"])
            t.next_rid = int(manifest["next_rid"])
            t.delivered = int(manifest["delivered"])
            self._tenants[tenant] = t
            restored = []
            for p in manifest.get("pending", []):
                x = np.frombuffer(
                    base64.b64decode(p["data"]),
                    dtype=np.dtype(p["dtype"])).reshape(p["shape"])
                req = ServeRequest(tenant, t.tpu_class, int(p["rid"]),
                                   x, p.get("trace", ""), now)
                t.queue.append(req)
                restored.append(req)
            self.accounting.set_queue_depth(tenant, len(t.queue))
            self.wakeup.notify_all()
        self.recorder.note("serving", "resume", tenant=tenant,
                           restored=len(restored),
                           watermark=int(manifest["delivered"]))
        return restored

    # -- state ---------------------------------------------------------------

    def state(self) -> dict:
        """Queues, watermarks, totals and the batcher's knobs, joined."""
        snap = self.accounting.snapshot()
        with self.lock:
            tenants = {}
            for t in self._tenants.values():
                rec = dict(snap["tenants"].get(t.name, {}))
                rec.setdefault("class", t.tpu_class)
                rec["queued"] = len(t.queue)
                rec["watermark"] = t.delivered
                tenants[t.name] = rec
            for name, rec in snap["tenants"].items():
                if name not in tenants:          # parked or idle tenants
                    rec = dict(rec)
                    rec.setdefault("queued", 0)
                    tenants[name] = rec
            out = {
                "attached": True,
                "tenants": tenants,
                "totals": {
                    "admitted": self.admitted_total,
                    "shed": self.shed_total,
                    "completed": self.completed_total,
                    "failed": self.failed_total,
                    "queued": sum(len(t.queue)
                                  for t in self._tenants.values()),
                },
                "batches": snap["batches"],
                "mean_batch_rows": snap["mean_batch_rows"],
            }
        if self.batcher is not None:
            out["batcher"] = self.batcher.describe()
        return out
