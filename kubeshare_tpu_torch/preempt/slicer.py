"""Program-boundary slicing: a preempted hold yields *between* executes,
never in the middle of one — counterpart of
``kubeshare_tpu/preempt/slicer.py``.

The chip proxy brackets every execute with ``execute_begin`` /
``execute_end``. :meth:`BoundarySlicer.should_yield` answers True only
when the session is not inside an execute, so a chain of bursts under one
token slices at program boundaries. The yield itself is the proxy's
``renew`` — an atomic release and re-request that keeps stride shares —
so the wire is unchanged for a peer that never negotiated ``"preempt"``.

``stats()["mid_execute_yields"]`` counts yields recorded while an execute
was in flight: zero by construction, which the card smoke checks.
"""

from __future__ import annotations

import threading


class BoundarySlicer:
    """Per-process yield bookkeeping over a scheduler that may offer
    ``preempted(name) -> bool`` (absent: slicing off)."""

    def __init__(self, scheduler=None):
        self.scheduler = scheduler
        self._lock = threading.Lock()
        self._in_execute: dict[str, int] = {}
        self._stats = {"checks": 0, "yields": 0, "mid_execute_yields": 0}

    # -- execute brackets ----------------------------------------------------

    def execute_begin(self, name: str) -> None:
        with self._lock:
            self._in_execute[name] = self._in_execute.get(name, 0) + 1

    def execute_end(self, name: str) -> None:
        with self._lock:
            n = self._in_execute.get(name, 0) - 1
            if n > 0:
                self._in_execute[name] = n
            else:
                self._in_execute.pop(name, None)

    # -- the boundary check --------------------------------------------------

    def should_yield(self, name: str) -> bool:
        """True when ``name`` is marked preempted AND no execute of it is
        in flight — the only moment a slice is allowed."""
        preempted = getattr(self.scheduler, "preempted", None)
        if preempted is None:
            return False
        with self._lock:
            self._stats["checks"] += 1
            if self._in_execute.get(name, 0) > 0:
                return False
        try:
            return bool(preempted(name))
        except (KeyError, RuntimeError):
            return False    # the client or the scheduler is gone

    def note_yield(self, name: str) -> None:
        """Record that the proxy yielded ``name``'s token. A yield while an
        execute is in flight breaks the contract and is counted."""
        with self._lock:
            self._stats["yields"] += 1
            if self._in_execute.get(name, 0) > 0:
                self._stats["mid_execute_yields"] += 1

    def stats(self) -> dict:
        with self._lock:
            return dict(self._stats)
