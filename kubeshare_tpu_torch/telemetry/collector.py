"""Per-node capacity collector.

The port's copy of ``kubeshare_tpu/telemetry/collector.py``. Discovery is
the port's (CUDA devices, or a fake fleet): with no card it fails, and the
node is published unhealthy with no devices — never with the CPU as one.

Parity with ``kubeshare-collector`` (``pkg/collector/collector.go:30-61``,
``cmd/kubeshare-collector/main.go``): enumerate local chips and publish
``tpu_capacity`` with the chip data in labels (node, chip_id, model,
memory, index — plus the TPU additions: ICI ``coords`` and ``slice_id``).
Two outputs:

- push to the :mod:`.registry` bus (the decision path — fresh reads);
- an optional standalone ``/metrics`` HTTP endpoint on port 9004 for
  Prometheus observability (``deploy/collector.yaml`` parity).

Unlike the reference — which parks forever when NVML init fails
(``cmd/kubeshare-collector/main.go:42-49``) — discovery failures here are
retried each period and reported as ``healthy: false`` so the scheduler
can exclude the node instead of never hearing about it.
"""

from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .. import constants as C
from ..obs.metrics import render_default, render_help_type
from ..topology.discovery import discover_chips
from ..utils.logger import get_logger
from .heartbeat import Heartbeater
from .registry import RegistryClient, render_metric

log = get_logger("collector")

COLLECTOR_PORT = 9004  # deploy/collector.yaml parity
DEFAULT_PERIOD_S = 5.0


class CapacityCollector:
    """Discovers local chips and pushes them to the registry."""

    def __init__(self, registry: RegistryClient, node: str | None = None,
                 backend: str = "auto", period_s: float = DEFAULT_PERIOD_S,
                 lease_ttl_s: float = C.LEASE_TTL_S):
        from ..utils import default_node_name

        self.registry = registry
        self.node = node or default_node_name()
        self.backend = backend
        self.period_s = period_s
        # liveness rides with the collector: capacity says WHAT the node
        # offers, the lease says it is still THERE (doc/health.md keeps
        # the two axes independent). 0 disables the heartbeat.
        self.heartbeat = (Heartbeater(registry, self.node,
                                      ttl_s=lease_ttl_s)
                          if lease_ttl_s > 0 else None)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.last_chips: list = []

    def collect_once(self) -> bool:
        """One discovery + push; returns health. Registry errors are
        logged, not raised — the next period retries (an unreachable
        registry must not kill the loop and leave the node's entry
        permanently stale)."""
        if self.heartbeat is not None:
            self.heartbeat.beat_once()
        try:
            chips = discover_chips(self.backend, host=self.node)
        except Exception as e:
            log.error("chip discovery failed: %s", e)
            try:
                self.registry.put_capacity(self.node, [], healthy=False)
            except Exception as push_err:
                log.error("capacity push failed: %s", push_err)
            return False
        self.last_chips = chips
        try:
            self.registry.put_capacity(
                self.node, [c.to_labels() for c in chips], healthy=True)
        except Exception as e:
            log.error("capacity push failed: %s", e)
            return False
        return True

    def run_forever(self) -> None:
        first = not self.last_chips   # collect immediately on cold start,
        while not self._stop.wait(0.0 if first else self.period_s):
            first = False             # ...then strictly once per period —
            self.collect_once()       # even while discovery keeps failing

    def start(self) -> "CapacityCollector":
        self._thread = threading.Thread(target=self.run_forever, daemon=True,
                                        name=f"collector-{self.node}")
        self._thread.start()
        if self.heartbeat is not None:
            # the lease beats on its own cadence (TTL/3), faster than the
            # 5 s capacity period — liveness detection must not wait for
            # a full discovery pass
            self.heartbeat.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self.heartbeat is not None:
            self.heartbeat.stop()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        try:
            self.registry.drop_capacity(self.node)
            self.registry.drop_lease(self.node)
        except Exception:
            pass


def serve_metrics(get_chips, node: str, host: str = "0.0.0.0",
                  port: int = COLLECTOR_PORT) -> ThreadingHTTPServer:
    """Standalone Prometheus endpoint (``/kubeshare-collector`` parity —
    the reference serves its collector on port 9004)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            log.debug("http: " + fmt, *args)

        def do_GET(self):
            if self.path not in ("/metrics", "/kubeshare-collector"):
                self.send_response(404)
                self.end_headers()
                return
            now = time.time()
            lines = render_help_type(
                "tpu_capacity", "gauge",
                "Schedulable chip inventory; chip identity in labels, "
                "value is the publish timestamp.")
            for chip in get_chips():
                lines.append(render_metric("tpu_capacity", chip.to_labels(),
                                           now))
            body = ("\n".join(lines) + "\n" + render_default()).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    server = ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="collector-metrics").start()
    return server


def main(argv=None) -> None:
    """``python -m kubeshare_tpu_torch.telemetry.collector
    --registry-port N [--backend cuda]`` — publish this node's capacity
    and lease until SIGTERM or SIGINT, then drop both. Prints ``READY``
    after the first publish."""
    import argparse

    from ..utils import default_node_name, ready_until_signal

    parser = argparse.ArgumentParser(
        prog="kubeshare_tpu_torch.telemetry.collector")
    parser.add_argument("--registry-host", default="127.0.0.1")
    parser.add_argument("--registry-port", type=int, required=True)
    parser.add_argument("--node", default=default_node_name())
    parser.add_argument("--backend", default="auto")
    parser.add_argument("--period", type=float, default=DEFAULT_PERIOD_S)
    parser.add_argument("--metrics-port", type=int, default=0,
                        help="also serve /metrics on this port (0 = off)")
    args = parser.parse_args(argv)

    collector = CapacityCollector(
        RegistryClient(args.registry_host, args.registry_port),
        node=args.node, backend=args.backend, period_s=args.period)
    collector.collect_once()
    collector.start()
    server = None
    if args.metrics_port:
        server = serve_metrics(lambda: collector.last_chips, args.node,
                               port=args.metrics_port)
    try:
        ready_until_signal("READY")
    finally:
        if server is not None:
            server.shutdown()
        collector.stop()


if __name__ == "__main__":
    main()
