"""The per-node config daemon.

The port's copy of ``kubeshare_tpu/nodeagent/configd.py``.

Parity with ``kubeshare-config`` (``pkg/config/config.go``,
``query.go:22-138``): the reference watches pods, queries the 5-s-stale
``gpu_requirement`` metric from Prometheus filtered by its own node, and
rewrites per-GPU files. Here the requirement records come from the
telemetry registry with fresh reads (SURVEY §7.0.3), and files are only
rewritten when their content actually changed — the launcher's watch sees
real transitions, not rewrite noise.

Shared workloads only (limit ≤ 1): whole-chip pods own their chips and
never pass through the token runtime (``config.go:100-124`` filters the
same way).
"""

from __future__ import annotations

import threading

from .. import constants as C
from ..telemetry.registry import RegistryClient, TelemetryRegistry
from ..utils.logger import get_logger
from .files import ClientEntry, write_chip_clients

log = get_logger("configd")

DEFAULT_PERIOD_S = 1.0


def records_to_entries(records: dict[str, dict]) -> dict[str, list[ClientEntry]]:
    """requirement records → per-chip client lists (convertData parity,
    ``query.go:43-68``)."""
    by_chip: dict[str, list[ClientEntry]] = {}
    for key, rec in records.items():
        try:
            limit = float(rec.get("limit", 0))
            request = float(rec.get("request", 0))
            memory = int(rec.get("memory", 0))
            port = int(rec.get("port", 0))
        except (TypeError, ValueError):
            log.warning("malformed requirement record for %s: %r", key, rec)
            continue
        if limit > 1.0:
            continue  # whole-chip pods bypass the sharing runtime
        chip_ids = [c for c in rec.get("chip_id", "").split(",") if c]
        for chip_id in chip_ids:
            by_chip.setdefault(chip_id, []).append(
                ClientEntry(key, request, limit, memory, port))
    for entries in by_chip.values():
        entries.sort(key=lambda e: e.name)
    return by_chip


class ConfigDaemon:
    """Registry → per-chip files, continuously."""

    def __init__(self, registry: RegistryClient | TelemetryRegistry,
                 node: str, chip_ids: list[str],
                 base_dir: str = C.SCHEDULER_DIR,
                 period_s: float = DEFAULT_PERIOD_S):
        self.registry = registry
        self.node = node
        self.chip_ids = list(chip_ids)
        self.base_dir = base_dir
        self.period_s = period_s
        self._last: dict[str, list[ClientEntry]] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def sync_once(self) -> list[str]:
        """One registry read + rewrite pass; returns chips whose files
        changed."""
        try:
            records = self.registry.pods(node=self.node)
        except Exception as e:
            log.error("registry read failed: %s", e)
            return []
        by_chip = records_to_entries(records)
        changed = []
        # every known chip gets a file — zero-filled when empty
        # (query.go:115-138 cleanup parity)
        for chip_id in self.chip_ids:
            entries = by_chip.get(chip_id, [])
            if self._last.get(chip_id) == entries:
                continue
            write_chip_clients(chip_id, entries, self.base_dir)
            self._last[chip_id] = entries
            changed.append(chip_id)
            log.info("chip %s: %d client(s)", chip_id, len(entries))
        return changed

    def run_forever(self) -> None:
        while not self._stop.wait(self.period_s):
            self.sync_once()

    def start(self) -> "ConfigDaemon":
        self.sync_once()
        self._thread = threading.Thread(target=self.run_forever, daemon=True,
                                        name=f"configd-{self.node}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


def main(argv=None) -> None:
    """``python -m kubeshare_tpu_torch.nodeagent.configd --registry-port N
    [--base-dir D] [--backend cuda]`` — mirror this node's requirement
    records into its devices' client files until SIGTERM or SIGINT.
    Prints ``READY`` after the first pass."""
    import argparse

    from ..topology.discovery import discover_chips
    from ..utils import default_node_name, ready_until_signal

    parser = argparse.ArgumentParser(
        prog="kubeshare_tpu_torch.nodeagent.configd")
    parser.add_argument("--registry-host", default="127.0.0.1")
    parser.add_argument("--registry-port", type=int, required=True)
    parser.add_argument("--node", default=default_node_name())
    parser.add_argument("--base-dir", default=C.SCHEDULER_DIR)
    parser.add_argument("--backend", default="auto")
    parser.add_argument("--period", type=float, default=DEFAULT_PERIOD_S)
    args = parser.parse_args(argv)

    chips = discover_chips(args.backend, host=args.node)
    daemon = ConfigDaemon(
        RegistryClient(args.registry_host, args.registry_port),
        node=args.node, chip_ids=[c.chip_id for c in chips],
        base_dir=args.base_dir, period_s=args.period)
    daemon.start()
    try:
        ready_until_signal("READY")
    finally:
        daemon.stop()


if __name__ == "__main__":
    main()
