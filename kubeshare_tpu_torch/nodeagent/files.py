"""Per-device client-list files — the node-local control channel.

Copy of ``kubeshare_tpu/nodeagent/files.py`` (the same bytes on disk, so
either package's launcher reads the other's files). Parity with
``pkg/config/query.go:43-105``: two file families per device under the
scheduler dir — ``config/<id>`` (the clients and their shares) and
``podmanagerport/<id>`` (their manager ports) — JSON-encoded and written
atomically (tmp + rename), so a half-written file is never observed.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass

from .. import constants as C


@dataclass(frozen=True)
class ClientEntry:
    """One sharing workload on a device (query.go:56-68 row parity)."""

    name: str          # "<namespace>/<pod>"
    request: float
    limit: float
    memory: int
    port: int = 0

    def to_json(self) -> dict:
        return {"name": self.name, "request": self.request,
                "limit": self.limit, "memory": self.memory,
                "port": self.port}

    @staticmethod
    def from_json(obj: dict) -> "ClientEntry":
        return ClientEntry(obj["name"], float(obj["request"]),
                           float(obj["limit"]), int(obj["memory"]),
                           int(obj.get("port", 0)))


def _atomic_write(path: str, data: str) -> None:
    directory = os.path.dirname(path)
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp-")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _safe_chip_filename(chip_id: str) -> str:
    return chip_id.replace("/", "_")


def write_chip_clients(chip_id: str, clients: list[ClientEntry],
                       base_dir: str = C.SCHEDULER_DIR) -> tuple[str, str]:
    """Write both file families for one device; returns their paths. An
    empty client list still writes files — the launcher needs the
    transition to know it must kill managers."""
    name = _safe_chip_filename(chip_id)
    config_path = os.path.join(base_dir, "config", name)
    port_path = os.path.join(base_dir, "podmanagerport", name)
    _atomic_write(config_path, json.dumps({
        "chip_id": chip_id,
        "clients": [c.to_json() for c in clients],
    }, indent=0))
    _atomic_write(port_path, json.dumps({
        "chip_id": chip_id,
        "ports": {c.name: c.port for c in clients if c.port},
    }, indent=0))
    return config_path, port_path


def read_chip_clients(chip_id: str,
                      base_dir: str = C.SCHEDULER_DIR) -> list[ClientEntry]:
    path = os.path.join(base_dir, "config", _safe_chip_filename(chip_id))
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError):
        return []
    return [ClientEntry.from_json(obj) for obj in payload.get("clients", [])]


def list_chip_files(base_dir: str = C.SCHEDULER_DIR) -> list[str]:
    directory = os.path.join(base_dir, "config")
    try:
        return sorted(f for f in os.listdir(directory)
                      if not f.startswith("."))
    except OSError:
        return []
