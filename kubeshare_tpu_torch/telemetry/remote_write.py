"""Remote-write: push per-process metric snapshots to the registry TSDB.

The port's copy of ``kubeshare_tpu/telemetry/remote_write.py``.

The reference's fleet view is a Prometheus *pull* loop with a 5-10 s
staleness window in the decision path (``pkg/scheduler/gpu.go:22-53``).
Our decision path already pushes (capacity/requirement records); this
module extends the push model to **observability**: every process that
renders exposition — scheduler service, ChipProxy, serving front door,
launcherd/collector — periodically ships its metric snapshot to the
telemetry registry (``POST /push``) tagged with ``instance``/``job``
labels, where a bounded :class:`~kubeshare_tpu_torch.obs.tsdb.TimeSeriesStore`
retains it and ``GET /query`` aggregates across the fleet. ``topcli
--fleet`` is one query against the registry, not N scrapes.

The wire payload is the compact ``MetricsRegistry.collect()`` snapshot
(tuples, not exposition text) so a 1k-series push parses in C-speed
JSON on the registry side — the bench gate holds ingest under 1 ms per
push. An exposition-text fallback exists for processes that only have
a rendered page in hand.

Pushes are fire-and-forget: a dead registry costs one logged warning
per period and never blocks or kills the instrumented process.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ..obs import metrics as obs_metrics
from ..utils.logger import get_logger

log = get_logger("remote_write")

DEFAULT_PUSH_PERIOD_S = 5.0

_PUSHES = obs_metrics.default_registry().counter(
    "kubeshare_remote_write_pushes_total",
    "Remote-write push attempts by status (ok / error).",
    labels=("status",))
_PUSH_SECONDS = obs_metrics.default_registry().histogram(
    "kubeshare_remote_write_push_seconds",
    "Client-side cost of one remote-write push (collect + HTTP).")


class RemoteWriter:
    """Periodic snapshot pusher for one process.

    ``client`` is a :class:`~kubeshare_tpu_torch.telemetry.registry.
    RegistryClient` (or anything with ``push_metrics``); ``collect``
    defaults to the process-wide obs registry snapshot, and services
    with extra hand-rendered families (scheduler gauges, capacity) can
    pass their own callable returning either a collect()-shaped dict or
    exposition text.
    """

    def __init__(self, client, instance: str, job: str,
                 period_s: float = DEFAULT_PUSH_PERIOD_S,
                 collect: Optional[Callable[[], object]] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.client = client
        self.instance = instance
        self.job = job
        self.period_s = float(period_s)
        self._collect = collect or obs_metrics.collect_default
        self._clock = clock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.pushes_ok = 0
        self.pushes_failed = 0

    def push_once(self, now: Optional[float] = None) -> bool:
        """Collect + push one snapshot; returns success. Failures are
        logged and counted, never raised — observability must not take
        down the process it observes."""
        t0 = time.monotonic()
        try:
            payload = self._collect()
            if isinstance(payload, str):
                self.client.push_metrics(self.instance, self.job,
                                         exposition=payload, now=now)
            else:
                self.client.push_metrics(self.instance, self.job,
                                         snapshot=payload, now=now)
        except Exception as e:
            self.pushes_failed += 1
            _PUSHES.inc("error")
            log.warning("remote-write push from %s/%s failed: %s",
                        self.job, self.instance, e)
            return False
        self.pushes_ok += 1
        _PUSHES.inc("ok")
        _PUSH_SECONDS.observe(value=time.monotonic() - t0)
        return True

    def run_forever(self) -> None:
        # push immediately on start (so a fresh instance is queryable
        # within one RTT, not one period), then once per period
        first = True
        while not self._stop.wait(0.0 if first else self.period_s):
            first = False
            self.push_once()

    def start(self) -> "RemoteWriter":
        self._thread = threading.Thread(
            target=self.run_forever, daemon=True,
            name=f"remote-write-{self.job}-{self.instance}")
        self._thread.start()
        return self

    def stop(self, mark_stale: bool = True) -> None:
        """Stop pushing; by default tell the registry to retire this
        instance's series immediately (clean shutdown should not leave
        a ``stale_after_s`` ghost in fleet queries)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if mark_stale:
            try:
                self.client.mark_stale(self.instance)
            except Exception:
                pass


def default_instance(port: Optional[int] = None) -> str:
    """``node[:port]`` — unique per process on a node when a port is
    known, matching the Prometheus ``instance`` label convention."""
    from ..utils import default_node_name
    name = default_node_name()
    return f"{name}:{port}" if port else name
