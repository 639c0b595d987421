#!/usr/bin/env python
"""Fleet telemetry smoke of the PyTorch port: remote-write → one query →
critical path (the counterpart of ``scripts/fleet_smoke.py``).

Self-validating end-to-end pass over the port's fleet plane
(``doc/observability.md``), run by ``make obs-check-torch``:

1. serve a real telemetry registry (HTTP, loopback);
2. two ChipProxy-shaped pushers and one scheduler-shaped pusher
   remote-write their metric snapshots via :class:`RemoteWriter`
   (the exact client the services embed);
3. **one** ``GET /query`` per aggregation — rate, per-instance rate,
   histogram p99, gauge sum — must see all three instances' data
   fused registry-side (the ``topcli --fleet`` contract: one query,
   not N scrapes);
4. a clean shutdown marks one proxy stale; fleet queries must drop it
   immediately;
5. the sim's deterministic virtual-time traces assemble into a
   critical-path report spanning >= 3 processes at >= 95% coverage.

Exit status is non-zero on any broken promise.

Usage::

    python scripts/torch_fleet_smoke.py [--out DIR]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from kubeshare_tpu_torch.obs import critpath  # noqa: E402
from kubeshare_tpu_torch.sim.simulator import simulate_critpath  # noqa: E402
from kubeshare_tpu_torch.telemetry import TelemetryRegistry  # noqa: E402
from kubeshare_tpu_torch.telemetry.registry import RegistryClient  # noqa: E402
from kubeshare_tpu_torch.telemetry.remote_write import RemoteWriter  # noqa: E402


def _die(msg: str) -> None:
    print(f"TORCH FLEET SMOKE FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def _proxy_collect(events: float):
    """A ChipProxy-shaped snapshot: RPC latency histogram + counters."""
    les = (("0.01", 0.6), ("0.1", 0.9), ("+Inf", 1.0))
    def collect():
        samples = []
        for le, frac in les:
            samples.append(("kubeshare_proxy_rpc_latency_seconds_bucket",
                            {"le": le}, events * frac))
        samples.append(("kubeshare_proxy_rpc_latency_seconds_sum", {},
                        events * 0.02))
        samples.append(("kubeshare_proxy_rpc_latency_seconds_count", {},
                        events))
        return {"families":
                {"kubeshare_proxy_rpc_latency_seconds": "histogram"},
                "samples": samples}
    return collect


def _sched_collect():
    return {"families": {"kubeshare_scheduler_pending_pods": "gauge"},
            "samples": [("kubeshare_scheduler_pending_pods", {}, 3.0)]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="torch_fleet_smoke")
    parser.add_argument("--out", default=None,
                        help="directory for span exports (default: tmp)")
    args = parser.parse_args(argv)

    registry = TelemetryRegistry()
    srv = registry.serve()
    port = srv.server_address[1]
    client = RegistryClient("127.0.0.1", port)
    try:
        # -- remote-write from three process-shaped pushers ------------
        import time
        t = time.time()
        writers = {
            "proxy-0": RemoteWriter(client, "proxy-0", "chipproxy",
                                    collect=_proxy_collect(0.0)),
            "proxy-1": RemoteWriter(client, "proxy-1", "chipproxy",
                                    collect=_proxy_collect(0.0)),
            "sched-0": RemoteWriter(client, "sched-0", "scheduler",
                                    collect=_sched_collect),
        }
        for w in writers.values():
            if not w.push_once(now=t - 10.0):
                _die(f"first push from {w.instance} failed")
        writers["proxy-0"]._collect = _proxy_collect(100.0)
        writers["proxy-1"]._collect = _proxy_collect(20.0)
        for w in writers.values():
            if not w.push_once(now=t):
                _die(f"second push from {w.instance} failed")

        # -- fleet queries: each ONE GET /query, fused registry-side ---
        res = client.query("kubeshare_proxy_rpc_latency_seconds_count",
                           agg="rate", window_s=60.0)
        rate = res["groups"][0]["value"]
        if abs(rate - 120.0 / 60.0) > 1e-6:
            _die(f"fleet rpc rate {rate} != 2.0/s (120 events / 60 s)")
        if res["series_matched"] != 2:
            _die(f"rate matched {res['series_matched']} series, want 2")

        res = client.query("kubeshare_proxy_rpc_latency_seconds_count",
                           agg="rate", window_s=60.0, by=("instance",))
        per = {g["labels"]["instance"]: round(g["value"] * 60.0)
               for g in res["groups"]}
        if per != {"proxy-0": 100, "proxy-1": 20}:
            _die(f"per-instance increases {per}")

        res = client.query("kubeshare_proxy_rpc_latency_seconds",
                           agg="quantile", q=0.99, window_s=60.0)
        p99 = res["groups"][0]["value"]
        if p99 is None or not (0.0 < p99 <= 0.1):
            _die(f"fleet p99 {p99} outside (0, 0.1]")

        res = client.query("kubeshare_scheduler_pending_pods", agg="sum",
                           window_s=60.0)
        if res["groups"][0]["value"] != 3.0:
            _die("scheduler gauge did not reach the fleet view")

        insts = client.instances()["instances"]
        if {i["instance"] for i in insts} != {"proxy-0", "proxy-1",
                                              "sched-0"}:
            _die(f"instances {insts}")

        # -- clean shutdown retires the instance immediately -----------
        writers["proxy-1"].stop()            # mark_stale on the way out
        res = client.query("kubeshare_proxy_rpc_latency_seconds_count",
                           agg="rate", window_s=60.0, by=("instance",))
        left = {g["labels"]["instance"] for g in res["groups"]}
        if left != {"proxy-0"}:
            _die(f"stale proxy-1 still answering queries: {left}")
        print(f"fleet ok: 3 instances pushed, rate 2.00/s, p99 "
              f"{p99 * 1e3:.1f}ms, proxy-1 retired on stop")
    finally:
        srv.shutdown()
        srv.server_close()

    # -- critical path over the sim's virtual-time traces --------------
    out_dir = args.out or tempfile.mkdtemp(prefix="torch-fleet-smoke-")
    spans_dir = str(Path(out_dir) / "spans")
    sim = simulate_critpath(10, seed=0, spans_dir=spans_dir)
    rep = sim["report"]
    if rep["traces"] != 10:
        _die(f"critpath assembled {rep['traces']} traces, want 10")
    if len(rep["sources"]) < 3:
        _die(f"critpath sources {rep['sources']}, want >= 3 processes")
    if rep["coverage_min"] < 0.95:
        _die(f"critpath coverage_min {rep['coverage_min']} < 0.95")
    # the exported per-process files reassemble to the same answer
    files = sorted(str(p) for p in Path(spans_dir).glob("*.jsonl"))
    rep2 = critpath.report(critpath.assemble(critpath.load_spans(files)))
    if rep2 != rep:
        _die("re-assembly from exported span files diverged")
    print(f"critpath ok: {rep['traces']} traces over "
          f"{len(rep['sources'])} sources, coverage min "
          f"{rep['coverage_min'] * 100:.1f}%, wall p99 "
          f"{rep['wall_p99_ms']:.1f}ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
