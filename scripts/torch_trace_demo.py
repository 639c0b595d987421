#!/usr/bin/env python
"""Observability smoke of the PyTorch port: 3 simulated pods through the
whole plane (the counterpart of ``scripts/trace_demo.py``).

Runs a small workload — three pods submitted to a real engine +
dispatcher, each then gated through a real TCP token scheduler — with
the tracer installed, and self-validates everything the observability
plane promises (``doc/observability.md``):

- every pod's spans share one trace ID and cover submit → queue-wait →
  filter → reserve → bind → token-grant;
- the JSONL export parses line-by-line and the Chrome trace-event JSON
  loads (open ``trace.json`` in https://ui.perfetto.dev to see the
  three pods as parallel tracks);
- the Prometheus exposition passes the strict lint (HELP/TYPE on every
  family) and carries at least 5 ``kubeshare_*`` self-metric families.

Exit status is non-zero on any malformed output — ``make
obs-check-torch`` runs this after the port's unit lane.

Usage::

    python scripts/torch_trace_demo.py [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from kubeshare_tpu_torch import constants as C  # noqa: E402
from kubeshare_tpu_torch.isolation import tokensched  # noqa: E402
from kubeshare_tpu_torch.isolation.client import ExecutionGate  # noqa: E402
from kubeshare_tpu_torch.isolation.tokensched import TokenScheduler  # noqa: E402
from kubeshare_tpu_torch.obs import metrics as obs_metrics  # noqa: E402
from kubeshare_tpu_torch.obs.trace import Tracer, install_tracer  # noqa: E402
from kubeshare_tpu_torch.scheduler import SchedulerEngine  # noqa: E402
from kubeshare_tpu_torch.scheduler.dispatcher import Dispatcher  # noqa: E402
from kubeshare_tpu_torch.telemetry import TelemetryRegistry  # noqa: E402
from kubeshare_tpu_torch.topology.discovery import FakeTopology  # noqa: E402

REQUIRED_SPANS = {"submit", "queue-wait", "filter", "reserve", "bind",
                  "token-grant"}
MIN_FAMILIES = 5


def fail(msg: str) -> None:
    print(f"torch_trace_demo: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def run_workload(tracer: Tracer) -> dict[str, str]:
    """3 pods: submit → bind → token gate. Returns {pod_key: trace_id}."""
    engine = SchedulerEngine()
    by_host: dict = {}
    for chip in FakeTopology(hosts=1, mesh=(2, 2)).chips():
        by_host.setdefault(chip.host, []).append(chip)
    for host, chips in by_host.items():
        engine.add_node(host, chips)
    dispatcher = Dispatcher(engine, TelemetryRegistry())

    keys = []
    for i in range(3):
        keys.append(dispatcher.submit(
            "demo", f"pod-{i}",
            {C.POD_TPU_REQUEST: "0.5", C.POD_TPU_LIMIT: "1.0"}))
    dispatcher.step()
    for key in keys:
        out = dispatcher.outcome(key)
        if out is None or out.status != "bound":
            fail(f"{key} did not bind: {out}")

    sched = TokenScheduler(window_ms=1000.0, base_quota_ms=100.0,
                           min_quota_ms=10.0, chip="chip0")
    server = tokensched.serve(sched)
    try:
        for key in keys:
            trace_id = engine.pod_status[key].trace_id
            gate = ExecutionGate.connect(
                "127.0.0.1", server.server_address[1], key,
                request=0.5, limit=1.0, trace_id=trace_id)
            gate()          # acquire: the server records the grant span
            gate.close()
    finally:
        server.shutdown()
    return {key: engine.pod_status[key].trace_id for key in keys}


def check_traces(tracer: Tracer, traces: dict[str, str],
                 out_dir: Path) -> None:
    for key, trace_id in traces.items():
        if not trace_id:
            fail(f"{key} has no trace ID")
        names = {s.name for s in tracer.spans(trace_id)}
        if not REQUIRED_SPANS <= names:
            fail(f"{key} missing spans {REQUIRED_SPANS - names}")

    jsonl = out_dir / "trace.jsonl"
    n = tracer.export_jsonl(jsonl)
    if n < 3 * len(REQUIRED_SPANS):
        fail(f"JSONL export has {n} spans, expected >= "
             f"{3 * len(REQUIRED_SPANS)}")
    for lineno, line in enumerate(jsonl.read_text().splitlines(), 1):
        row = json.loads(line)
        for field in ("name", "trace_id", "span_id", "start_ms", "end_ms"):
            if row.get(field) in (None, ""):
                fail(f"trace.jsonl line {lineno} missing {field}")

    chrome = tracer.chrome_trace()
    chrome_path = out_dir / "trace.json"
    chrome_path.write_text(json.dumps(chrome, indent=1))
    loaded = json.loads(chrome_path.read_text())
    events = loaded.get("traceEvents", [])
    xs = [e for e in events if e.get("ph") == "X"]
    pids = {e["pid"] for e in xs}
    if len(pids) != len(traces):
        fail(f"expected {len(traces)} pid tracks, got {len(pids)}")
    for e in xs:
        if e.get("dur", -1) < 0 or e.get("ts", -1) < 0:
            fail(f"negative ts/dur in chrome event {e.get('name')}")
    print(f"torch_trace_demo: {n} spans over {len(traces)} traces -> "
          f"{jsonl} and {chrome_path}")


def check_exposition(out_dir: Path) -> None:
    text = obs_metrics.render_default()
    (out_dir / "metrics.prom").write_text(text)
    errors = obs_metrics.lint_exposition(text)
    if errors:
        fail("exposition lint: " + "; ".join(errors))
    families = [name for name, fam
                in obs_metrics.parse_exposition(text).items()
                if name.startswith("kubeshare_") and fam["samples"]]
    if len(families) < MIN_FAMILIES:
        fail(f"only {len(families)} populated kubeshare_* families "
             f"({families}), expected >= {MIN_FAMILIES}")
    print(f"torch_trace_demo: exposition clean, {len(families)} populated "
          f"self-metric families -> {out_dir / 'metrics.prom'}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", default=None,
                        help="output directory for the trace + exposition "
                             "(default: a new temporary one)")
    args = parser.parse_args(argv)
    out_dir = Path(args.out or tempfile.mkdtemp(prefix="torch-trace-demo-"))
    out_dir.mkdir(parents=True, exist_ok=True)

    tracer = install_tracer(Tracer())
    traces = run_workload(tracer)
    check_traces(tracer, traces, out_dir)
    check_exposition(out_dir)
    print("torch_trace_demo: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
