#!/usr/bin/env python
"""Standalone isolation backend of the PyTorch port: no Kubernetes, no
registry.

Counterpart of ``tools/launch_backend.py`` (the reference's
``launch-backend.py``, its Gemini stack's integration harness): it writes
the per-device client files of a hand-written config and lets the port's
:class:`~kubeshare_tpu_torch.nodeagent.launcherd.LauncherDaemon` bring up
each device's proxy and the pod managers, as on a node.

Config (JSON)::

    {"chips": ["GPU-0"],
     "clients": [{"name": "ns/a", "chip": "GPU-0",
                  "request": 0.5, "limit": 1.0, "memory": 0,
                  "port": 50151}]}

Run: ``python tools/launch_backend_torch.py --config cfg.json [--device
cpu] [--port-start N]``. It prints one JSON line (``base_dir``,
``exec_ports``, ``token_ports``, ``manager_ports``), then the proxies' and
managers' ``READY <port>`` lines as they come up, and stops them all on
SIGTERM or SIGINT. Point workloads at a client's manager port (gate mode:
``KUBESHARE_TPU_POD_MANAGER_PORT`` with the port's ``_shim`` on
``PYTHONPATH``) or at a device's execution port (``ProxyClient``). The
proxies run on the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kubeshare_tpu_torch import constants as C  # noqa: E402
from kubeshare_tpu_torch.nodeagent.files import (ClientEntry,  # noqa: E402
                                                 write_chip_clients)
from kubeshare_tpu_torch.nodeagent.launcherd import (  # noqa: E402
    TOKEN_PORT_OFFSET, LauncherDaemon, default_pmgr_cmd, default_proxy_cmd)
from kubeshare_tpu_torch.utils import ready_until_signal  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="launch_backend_torch")
    parser.add_argument("--config", required=True)
    parser.add_argument("--base-dir", default="")
    parser.add_argument("--device", default="",
                        help="the proxies' torch device (default: the "
                             "card; cpu for a run with none)")
    parser.add_argument("--port-start", type=int, default=C.SCHD_PORT_START,
                        help="device i's proxy serves on this port + i, "
                             f"its token scheduler {TOKEN_PORT_OFFSET} "
                             "above (default: the node's)")
    args = parser.parse_args(argv)

    with open(args.config) as f:
        cfg = json.load(f)
    base_dir = args.base_dir or tempfile.mkdtemp(prefix="kubeshare-backend-")
    chips = list(cfg.get("chips", []))

    by_chip: dict[str, list[ClientEntry]] = {chip: [] for chip in chips}
    for client in cfg.get("clients", []):
        entry = ClientEntry(client["name"], float(client.get("request", 0)),
                            float(client.get("limit", 1.0)),
                            int(client.get("memory", 0)),
                            int(client.get("port", 0)))
        by_chip.setdefault(client.get("chip", chips[0] if chips else ""),
                           []).append(entry)
    for chip, entries in by_chip.items():
        write_chip_clients(chip, entries, base_dir)

    def proxy_cmd(chip_id, index, exec_port, token_port):
        cmd, env = default_proxy_cmd(chip_id, index, exec_port, token_port)
        if args.device:
            cmd += ["--device", args.device]
        return cmd, env

    daemon = LauncherDaemon(list(by_chip), base_dir=base_dir,
                            proxy_cmd=proxy_cmd, pmgr_cmd=default_pmgr_cmd,
                            port_start=args.port_start)
    daemon.start()
    try:
        ready_until_signal(json.dumps({
            "base_dir": base_dir,
            "exec_ports": daemon.exec_ports,
            "token_ports": {c: daemon.token_port(c) for c in by_chip},
            "manager_ports": {e.name: e.port for entries in by_chip.values()
                              for e in entries if e.port},
        }))
    finally:
        daemon.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
