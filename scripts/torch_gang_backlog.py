#!/usr/bin/env python3
"""Unschedulable gang pairs left pending in the scheduler service.

    python3 scripts/torch_gang_backlog.py [--give-up-s 30] [--max-s 300]
                                          [--out r.json]

Runs on the host alone; needs no card. It starts the port's registry and
scheduler service (``--health``) as processes, as phase 5i of
``chip_smoke.py`` does, publishes 5i's 63 fake 8-device nodes, and sends
5i's seeded background (2,000 submissions) over HTTP twice, each time on
fresh daemons:

- ``delete``: as 5i does, a gang pair the fleet cannot hold is deleted
  at once;
- ``keep``: such a pair is left pending, as a user leaves an
  unschedulable pod.

Both modes delete an unbound single pod at once and withdraw about one
bound pod in three, as 5i does. Every 100 submissions it prints the
pairs left pending, the ``POST /schedule`` round trip's p50 and p99, and
the ``find_preemption`` runs of the service's engine since the window
before (from its ``/metrics``). A mode gives up at the first round trip
that fails or takes longer than ``--give-up-s``, or once it has sent for
``--max-s``. Prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WINDOW = 100


def _find_preemption_runs(cs, svc_url: str) -> int:
    buckets = cs._phase_histograms(cs._http_metrics(svc_url)).get(
        "find_preemption", {})
    return int(max(buckets.values(), default=0))


def stream(cs, svc_url: str, keep: bool, give_up_s: float,
           max_s: float) -> dict:
    """5i's background stream (``chip_smoke._background_stream``'s
    mix and seed), with unholdable pairs deleted or kept."""
    from kubeshare_tpu_torch.scheduler.bridge import ServiceClient

    client = ServiceClient(svc_url, timeout=give_up_s)
    rng = random.Random(cs.PLACE_SEED)
    windows, rtt, bound = [], [], []
    pending_pairs = 0
    runs_before = _find_preemption_runs(cs, svc_url)
    t_window, w_start = time.perf_counter(), 0
    deadline = t_window + max_s
    gave_up = ""
    i = 0
    while i < cs.PLACE_BACKGROUND_PODS:
        if time.perf_counter() > deadline:
            gave_up = f"{max_s} s of sending, after submission {len(rtt)}"
            break
        sets = cs._background_labels(rng, i)[:cs.PLACE_BACKGROUND_PODS - i]
        names = ([f"bg-{i}"] if len(sets) == 1
                 else [f"bg-{i}-{j}" for j in range(len(sets))])
        i += len(sets)
        codes = []
        for name, labels in zip(names, sets):
            t0 = time.perf_counter()
            try:
                code, body = client.schedule("bg", name, labels)
            except OSError as e:
                code, body = 0, str(e)
            took = time.perf_counter() - t0
            rtt.append(took)
            if code not in (200, 202) or took > give_up_s:
                gave_up = (f"submission {len(rtt)} ({name}): code {code} "
                           f"after {took:.3f} s: {body}")
                break
            codes.append(code)
        if gave_up:
            break
        unbound = [n for n, c in zip(names, codes) if c != 200]
        if len(names) > 1 and unbound:
            reasons = [client.status("bg", n)[1].get("reason", "")
                       for n in names]
            if not all(not r or "min_available" in r for r in reasons):
                if keep:
                    pending_pairs += 1
                else:
                    for name in names:
                        client.delete("bg", name)
        elif unbound:
            client.delete("bg", names[0])
        else:
            bound.extend(names)
        if bound and rng.random() < 0.3:
            client.delete("bg", bound.pop(rng.randrange(len(bound))))
        if len(rtt) - w_start >= WINDOW:
            runs_before = _close_window(cs, svc_url, windows, rtt, w_start,
                                        pending_pairs, runs_before,
                                        t_window, keep)
            t_window, w_start = time.perf_counter(), len(rtt)
    if len(rtt) > w_start:
        _close_window(cs, svc_url, windows, rtt, w_start, pending_pairs,
                      runs_before, t_window, keep)
    if gave_up:
        cs.log(f"{'keep' if keep else 'delete'}: gave up at {gave_up}")
    return {"mode": "keep" if keep else "delete", "submitted": len(rtt),
            "pending_pairs": pending_pairs, "gave_up": gave_up,
            "windows": windows}


def _close_window(cs, svc_url, windows, rtt, w_start, pending_pairs,
                  runs_before, t0, keep) -> int:
    """Append the numbers of the round trips since ``w_start``; returns
    the service's ``find_preemption`` runs so far."""
    lat = sorted(x * 1e6 for x in rtt[w_start:])
    try:
        runs = _find_preemption_runs(cs, svc_url) - runs_before
    except OSError:
        runs = None
    windows.append({"submissions": len(rtt), "round_trips": len(lat),
                    "pending_pairs": pending_pairs,
                    "rtt_us_p50": cs._pct(lat, 0.5),
                    "rtt_us_p99": cs._pct(lat, 0.99),
                    "seconds": time.perf_counter() - t0,
                    "find_preemption_runs": runs})
    cs.log(f"{'keep' if keep else 'delete'}: {windows[-1]}")
    return runs_before + (runs or 0)


def run_mode(cs, keep: bool, give_up_s: float, max_s: float) -> dict:
    from kubeshare_tpu_torch.telemetry.registry import RegistryClient

    base = tempfile.mkdtemp(prefix="gang-backlog-")
    daemons = {}
    try:
        daemons["registry"] = cs._start_daemon(
            ROOT, base, "registry", ["kubeshare_tpu_torch.telemetry.registry",
                                     "--host", "127.0.0.1", "--port", "0"])
        port = int(cs._wait_ready(daemons["registry"][1],
                                  "the registry").split()[1])
        cs._fake_capacity(RegistryClient("127.0.0.1", port))
        daemons["service"] = cs._start_daemon(
            ROOT, base, "service", ["kubeshare_tpu_torch.scheduler.service",
                                    "--registry-port", str(port), "--host",
                                    "127.0.0.1", "--port", "0", "--health"])
        svc_port = cs._wait_ready(daemons["service"][1],
                                  "the service").split()[1]
        return stream(cs, f"http://127.0.0.1:{svc_port}", keep, give_up_s,
                      max_s)
    finally:
        for proc, _ in daemons.values():
            proc.kill()
            proc.wait()
        shutil.rmtree(base, ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="torch_gang_backlog.py")
    parser.add_argument("--give-up-s", type=float, default=30.0,
                        help="a round trip longer than this ends a mode")
    parser.add_argument("--max-s", type=float, default=300.0,
                        help="a mode ends after sending this long")
    parser.add_argument("--out", default="",
                        help="also write the result here (JSON)")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    result = {"modes": [run_mode(cs, keep, args.give_up_s, args.max_s)
                        for keep in (False, True)]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
