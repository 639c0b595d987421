"""Init helper: record the control-plane address for workload containers.

The port's copy of ``kubeshare_tpu/nodeagent/queryip.py``.

Parity with ``kubeshare-query-ip`` (``cmd/kubeshare-query-ip/main.go:22-34``):
the reference's init container writes its own pod IP to
``/kubeshare/library/schedulerIP.txt`` so the LD_PRELOAD hook can find the
scheduler. Here the file carries ``<ip> <port>`` of the telemetry
registry / scheduler endpoint.
"""

from __future__ import annotations

import os

from .. import constants as C


def write_scheduler_ip(ip: str, port: int = 0,
                       path: str = C.SCHEDULER_IP_FILE) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    content = f"{ip} {port}\n" if port else f"{ip}\n"
    with open(path, "w") as f:
        f.write(content)
    return path


def read_scheduler_ip(path: str = C.SCHEDULER_IP_FILE) -> tuple[str, int]:
    with open(path) as f:
        parts = f.read().split()
    if not parts:
        raise ValueError(f"{path} is empty")
    return parts[0], int(parts[1]) if len(parts) > 1 else 0


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(
        prog="kubeshare_tpu_torch.nodeagent.queryip")
    parser.add_argument("--ip", default=os.environ.get(
        C.ENV_SCHEDULER_IP, "127.0.0.1"))
    parser.add_argument("--port", type=int, default=int(os.environ.get(
        "KUBESHARE_TPU_SCHEDULER_PORT", "0")))
    parser.add_argument("--path", default=C.SCHEDULER_IP_FILE)
    args = parser.parse_args(argv)
    path = write_scheduler_ip(args.ip, args.port, args.path)
    print(path, flush=True)


if __name__ == "__main__":
    main()
