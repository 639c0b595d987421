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
for live serving. The JAX batcher's span tracer and flight recorder are
not ported.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

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
    :class:`ContinuousBatcher` pads a short batch up to ``batch_size``."""

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

    def execute(self, x: np.ndarray) -> np.ndarray:
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
                 clock: Optional[Callable[[], float]] = None):
        self.frontdoor = frontdoor
        self.servable = servable
        cap = getattr(servable, "batch_size", max_batch or 8)
        self.max_batch = min(int(max_batch), cap) if max_batch else cap
        self.max_wait_s = float(max_wait_s)
        self.clock = clock or frontdoor.clock
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
        try:
            y = self.servable.execute(x)
        except Exception as exc:
            # no admitted request is ever dropped silently: a failed
            # execution fails every rider loudly and is accounted
            for r in batch:
                r._fail(exc)
                fd.note_delivered(r, failed=True)
                fd.accounting.note_failed(r.tenant, r.tpu_class)
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
