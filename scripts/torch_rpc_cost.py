#!/usr/bin/env python3
"""Host microseconds of the port's proxy round trips, for comparing two
trees of the port on one machine.

    python3 scripts/torch_rpc_cost.py [--root DIR] [--n 2000] [--trace]

Imports ``kubeshare_tpu_torch`` from ``--root`` (default: this checkout),
starts an in-process ``ChipProxy`` on the card with a ``TokenScheduler``
(the smoke's 1 s window, 5h's 10 ms idle release) and times, on one
lockstep client, a ``usage`` round trip (no token, no device), one
``ProxyServable`` batch back to back with the last (tinymlp at 8 x 32: an
upload, an execute under the token still held, a get and a free), and
one batch 15 ms after the last, once the proxy has returned the token
(the execute acquires it anew, as 5h's batches 20 ms apart do). With
``--trace`` a tracer is installed that keeps the spans, and the usage
calls carry a trace id (a batch of this tree carries its own, as in 5h).
Prints the card's name and power limit, then one JSON line: the median
and the 10th and 90th percentiles of each, in microseconds. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pcts(us: list) -> dict:
    s = sorted(us)
    return {q: round(s[min(len(s) - 1, int(p * len(s)))], 3)
            for q, p in (("p10", 0.1), ("p50", 0.5), ("p90", 0.9))}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="torch_rpc_cost.py")
    parser.add_argument("--root", default=ROOT,
                        help="the checkout whose package is timed")
    parser.add_argument("--n", type=int, default=2000)
    parser.add_argument("--trace", action="store_true")
    args = parser.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_rpc_cost: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from kubeshare_tpu_torch.isolation.client import ProxyClient
    from kubeshare_tpu_torch.isolation.proxy import ChipProxy
    from kubeshare_tpu_torch.isolation.tokensched import TokenScheduler
    from kubeshare_tpu_torch.models import tinymlp
    from kubeshare_tpu_torch.serving import ProxyServable

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip().splitlines()
    print(f"card: {card[0] if card else 'unknown'}", flush=True)
    if args.trace:
        from kubeshare_tpu_torch.obs.trace import Tracer, install_tracer
        install_tracer(Tracer(capacity=500_000))
    proxy = ChipProxy(device=torch.device("cuda", 0),
                      scheduler=TokenScheduler(1000.0, 300.0, 10.0),
                      idle_release_ms=10.0)
    proxy.serve()
    client = ProxyClient("127.0.0.1", proxy.port, "rpc/cost", 1.0, 1.0,
                         tpu_class="latency", reconnect=None)
    if args.trace:
        client.trace_id = "rpc-cost"
    try:
        servable = ProxyServable(client, seed=7)
        x = np.random.default_rng(7).standard_normal(
            (tinymlp.BATCH_SIZE, tinymlp.FEATURES)).astype(np.float32)
        out = {"root": os.path.abspath(args.root), "n": args.n,
               "trace": args.trace}
        batch = lambda: servable.execute(x)    # noqa: E731
        for name, call, gap_s, n in (
                ("usage", client.usage, 0.0, args.n),
                ("batch", batch, 0.0, args.n),
                ("batch_after_idle", batch, 0.015, args.n // 4)):
            for _ in range(50):          # warm-up
                call()
            us = []
            for _ in range(n):
                if gap_s:
                    time.sleep(gap_s)
                t0 = time.perf_counter()
                call()
                us.append((time.perf_counter() - t0) * 1e6)
            out[name + "_us"] = _pcts(us)
        print(json.dumps(out), flush=True)
    finally:
        client.close()
        proxy.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
