"""Continuous batcher: many tenants' requests, one shared execution.
Counterpart of ``kubeshare_tpu/serving/batcher.py``.

The batcher asks the front door for a batch and ships it as a single
``execute`` on one servable — typically a fractional proxy session
(inference under sharing pays for itself only when requests coalesce).
Two knobs bound the tradeoff:

- ``max_batch`` — rows per shared execution (capped by the servable's
  compiled batch size; shorter batches are zero-padded);
- ``max_wait_s`` — a lone request still ships within this bound, so tail
  latency is queue wait + max wait + execute, never "until the batch
  happens to fill".

``step(now)`` is explicitly clocked and synchronous — the simulation
drives it in virtual time, tests with a manual clock, and
:meth:`ContinuousBatcher.serve_loop` wraps it in a wall-clock pump thread
for live serving. Each shipped batch is a ``serve-batch`` span under its
head request's trace id; each completion is an SLO ``serve`` latency and
``serve-availability`` sample when the front door has an evaluator; a
failed batch is a flight-recorder note.

One divergence from the JAX batcher, so that critpath can split a served
row: each traced request's wait in the front door is a ``queue-wait``
span, and a :class:`ProxyServable` runs each batch under the batch's own
trace id (its head request's, else a new one), so the proxy's grant and
execute spans of that batch join it and no other.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..obs import flight as obs_flight
from ..obs import trace as obs_trace

from .frontdoor import FrontDoor, ServeRequest


class LocalServable:
    """In-process servable: a torch function ``fn(x[batch, ...]) ->
    y[batch, ...]``, given the batch as a host tensor; its result comes
    back as numpy from wherever ``fn`` put it."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor],
                 batch_size: int = 8):
        self.fn = fn
        self.batch_size = int(batch_size)

    def execute(self, x: np.ndarray) -> np.ndarray:
        y = self.fn(torch.from_numpy(np.asarray(x)))
        return y.detach().cpu().numpy()

    def close(self) -> None:
        pass


class ProxyServable:
    """The tinymlp model served through a fractional proxy session.

    The parameters are staged once as device buffers (``put_tree``), and
    ``tinymlp.apply`` is traced and compiled on the proxy once
    (:meth:`~kubeshare_tpu_torch.isolation.client.ProxyClient.compile`,
    the exported-program path); every batch is then one ``execute`` at
    ``tinymlp.BATCH_SIZE`` × ``FEATURES`` — so serving rides the whole
    isolation stack (token grants, memory charges, resume tokens). The
    :class:`ContinuousBatcher` pads a short batch up to ``batch_size``.

    The servable owns its client's trace id: each :meth:`execute` sets it
    to the batch's trace id, so the batch's put, execute and get carry it
    over the wire and the proxy's spans of the batch join that trace."""

    def __init__(self, client, seed: int = 0):
        from ..models import tinymlp
        self.client = client
        self.batch_size = tinymlp.BATCH_SIZE
        self.features = tinymlp.FEATURES
        #: the host copy of the parameters served (numpy), for checks
        self.params = tinymlp.init(seed)
        self._params = client.put_tree(self.params)
        example_x = np.zeros((self.batch_size, self.features),
                             dtype=np.float32)
        self._exe = client.compile(tinymlp.apply, self._params, example_x)

    def execute(self, x: np.ndarray, trace_id: str = "") -> np.ndarray:
        # a trace on every batch: a request without one would leave the
        # proxy's connection on the previous batch's trace
        self.client.trace_id = trace_id or obs_trace.new_trace_id()
        out = self._exe(self._params, np.asarray(x, dtype=np.float32))
        y = np.asarray(self.client.get(out))
        self.client.free(out)    # outputs are charged device buffers
        return y

    def close(self) -> None:
        self.client.close()


class ContinuousBatcher:
    """Pulls compatible requests from a FrontDoor into shared executes."""

    def __init__(self, frontdoor: FrontDoor, servable,
                 max_batch: Optional[int] = None,
                 max_wait_s: float = 0.005,
                 clock: Optional[Callable[[], float]] = None,
                 recorder=None):
        self.frontdoor = frontdoor
        self.servable = servable
        cap = getattr(servable, "batch_size", max_batch or 8)
        self.max_batch = min(int(max_batch), cap) if max_batch else cap
        self.max_wait_s = float(max_wait_s)
        self.clock = clock or frontdoor.clock
        self.recorder = (recorder if recorder is not None
                         else obs_flight.default_recorder())
        self.executions = 0
        self.rows_served = 0
        frontdoor.batcher = self

    # -- stepping ------------------------------------------------------------

    def ready(self, now: Optional[float] = None) -> bool:
        """Ship now? — the batch is full, or the oldest request aged out."""
        if now is None:
            now = self.clock()
        if self.frontdoor.queued_rows() >= self.max_batch:
            return True
        oldest = self.frontdoor.oldest_submitted_at()
        # the expression of next_deadline(): `now - oldest >= wait`
        # disagrees with it under float rounding, and a virtual-time
        # driver waking exactly at the deadline would spin forever
        return (oldest is not None
                and now >= oldest + self.max_wait_s)

    def next_deadline(self) -> Optional[float]:
        """When the oldest queued request's max wait expires."""
        oldest = self.frontdoor.oldest_submitted_at()
        if oldest is None:
            return None
        return oldest + self.max_wait_s

    def step(self, now: Optional[float] = None,
             force: bool = False) -> int:
        """Ship one batch if due; returns the requests completed."""
        if now is None:
            now = self.clock()
        if not force and not self.ready(now):
            return 0
        batch = self.frontdoor.pop_batch(self.max_batch)
        if not batch:
            return 0
        return self._execute(batch, now)

    def flush(self, now: Optional[float] = None) -> int:
        """Drain everything queued, ignoring max wait (shutdown)."""
        done = 0
        while True:
            n = self.step(now, force=True)
            if not n:
                return done
            done += n

    # -- execution -----------------------------------------------------------

    def _execute(self, batch: List[ServeRequest], now: float) -> int:
        fd = self.frontdoor
        rows = sum(r.rows for r in batch)
        x = np.concatenate([r.x for r in batch], axis=0)
        pad = self.servable.batch_size - x.shape[0]
        if pad > 0:
            x = np.concatenate(
                [x, np.zeros((pad,) + x.shape[1:], dtype=x.dtype)], axis=0)
        trace_id = batch[0].trace_id or obs_trace.new_trace_id()
        tracer = obs_trace.get_tracer()
        shipped = tracer.now_ms()
        for r in batch:
            if r.trace_id:
                tracer.record("queue-wait", r.trace_id,
                              shipped - max(0.0, now - r.submitted_at) * 1e3,
                              shipped, tenant=r.tenant)
        try:
            with tracer.span("serve-batch", trace_id, rows=rows,
                             requests=len(batch),
                             tenants=len({r.tenant for r in batch})):
                if isinstance(self.servable, ProxyServable):
                    y = self.servable.execute(x, trace_id=trace_id)
                else:
                    y = self.servable.execute(x)
        except Exception as exc:
            # no admitted request is ever dropped silently: a failed
            # execution fails every rider loudly and is accounted
            for r in batch:
                r._fail(exc)
                fd.note_delivered(r, failed=True)
                fd.accounting.note_failed(r.tenant, r.tpu_class)
            self.recorder.note("serving", "batch-failed",
                               requests=len(batch), error=repr(exc))
            return len(batch)
        self.executions += 1
        self.rows_served += rows
        fd.accounting.note_batch(rows)
        off = 0
        for r in batch:
            out = np.asarray(y[off:off + r.rows])
            off += r.rows
            r._complete(out, now)
            fd.note_delivered(r)
            latency = max(0.0, now - r.submitted_at)
            fd.accounting.note_completed(
                r.tenant, r.tpu_class, latency, r.rows,
                int(r.x.nbytes), int(out.nbytes), trace_id=r.trace_id)
            if fd.slo is not None:
                fd.slo.record(r.tenant, "serve", value_s=latency,
                              now=now, trace_id=r.trace_id)
                fd.slo.record(r.tenant, "serve-availability", ok=True,
                              now=now, trace_id=r.trace_id)
        return len(batch)

    # -- live pump -----------------------------------------------------------

    def serve_loop(self, stop: threading.Event,
                   idle_wait_s: float = 0.001,
                   drain_on_stop: bool = True) -> None:
        """Wall-clock pump: run it in a thread for live serving. On
        ``stop`` it drains by default — every request already admitted
        ships (ignoring max wait) before the pump exits, so a shutdown
        never strands a rider's future."""
        fd = self.frontdoor
        while not stop.is_set():
            if self.step():
                continue
            with fd.wakeup:  # wakeup wraps fd.lock: inspect inline
                queued = any(t.queue for t in fd._tenants.values())
                if not queued:
                    fd.wakeup.wait(timeout=0.05)
                    continue
            deadline = self.next_deadline()
            delay = idle_wait_s
            if deadline is not None:
                delay = min(max(deadline - time.monotonic(), 0.0),
                            0.05) or idle_wait_s
            stop.wait(delay)
        if drain_on_stop:
            self.flush()

    def describe(self) -> dict:
        return {
            "max_batch": self.max_batch,
            "max_wait_s": self.max_wait_s,
            "executions": self.executions,
            "rows_served": self.rows_served,
        }
