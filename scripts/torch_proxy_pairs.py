#!/usr/bin/env python3
"""Repeated proxy-mode pairs on one card: how the token splits between two
proxy-attached tenant processes, and how often the proxy hands a holding
tenant's token back between its steps.

    python3 scripts/torch_proxy_pairs.py [--rounds 2] [--pair even|uneven]
        [--idle-release-ms 10,50] [--out result.json]

Needs one CUDA card and runs from anywhere in a checkout. It builds the
kernels, then drives ``chip_smoke.py``'s phase 5f pair: a ``ChipProxy``
on the card in this process (token scheduler window 1 s) and tenants
that are ``chip_smoke.py --tenant --compiled`` processes attached by the
port's shim, training the full-width transformer. Each round runs the
pair once for each value of the proxy's ``idle_release_ms`` (the order
of the values turns round by round), on a fresh proxy, and reads it as
phase 5f does (``proxy_pair_reading``); whether it passes phase 5f's
check is reported, not enforced.

Besides that reading, for each tenant: its executions that acquired the
token anew, renewed a spent quota, or ran on the token it held; the
tokens the watchdog returned for it (idle releases); and the gaps
between the end of one of its executions and the start of the next while
it held the token (median, 90th percentile, and how many exceeded the
idle release). Prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _recording_proxy(cs, dev, idle_ms: float, records: dict):
    """A phase-5f proxy whose token gate and scheduler note, per session,
    how each execution got the token and the idle releases."""
    from kubeshare_tpu_torch.constants import BASE_QUOTA_MS, MIN_QUOTA_MS
    from kubeshare_tpu_torch.isolation import proxy as proxy_mod
    from kubeshare_tpu_torch.isolation.tokensched import TokenScheduler

    mu = threading.Lock()

    def rec(name: str) -> dict:
        return records.setdefault(name, {"acquired": 0, "renewed": 0,
                                         "held": 0, "idle_releases": 0,
                                         "gaps_ms": []})

    class RecordingProxy(proxy_mod.ChipProxy):
        def _gated(self, sess, fn, timing):
            with mu, sess.lock:
                r = rec(sess.name)
                if not sess.holding:
                    r["acquired"] += 1
                else:
                    r["gaps_ms"].append(proxy_mod._now_ms()
                                        - sess.last_end_ms)
                    r["renewed" if sess.used_ms >= sess.quota_ms
                      else "held"] += 1
            return super()._gated(sess, fn, timing)

    sched = TokenScheduler(cs.WINDOW_MS, BASE_QUOTA_MS, MIN_QUOTA_MS)
    release = sched.release

    def counted_release(name: str, used_ms: float) -> None:
        with mu:
            rec(name)["idle_releases"] += 1
        release(name, used_ms)

    sched.release = counted_release       # the proxy's watchdog calls it
    return RecordingProxy(device=dev, scheduler=sched,
                          idle_release_ms=idle_ms)


def _gap_summary(gaps: list, idle_ms: float) -> dict:
    gaps = sorted(gaps)
    if not gaps:
        return {"gaps": 0}
    return {"gaps": len(gaps), "gap_p50_ms": gaps[len(gaps) // 2],
            "gap_p90_ms": gaps[int(len(gaps) * 0.9)],
            "gaps_over_idle_release": sum(g >= idle_ms for g in gaps)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="torch_proxy_pairs.py")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--pair", choices=("even", "uneven"),
                        default="uneven",
                        help="the pair of chip_smoke.py's phase 5f to run")
    parser.add_argument("--idle-release-ms", default="10,50",
                        help="the proxy's idle release values to run, "
                             "comma-separated")
    parser.add_argument("--out", default="",
                        help="also write the result here (JSON)")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_proxy_pairs: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    card = cs.card_line()
    cs.log(f"card: {card}")
    with ThreadPoolExecutor(len(cs.KERNELS)) as pool:
        list(pool.map(cs._timed_build, cs.KERNELS))
    dev = torch.device("cuda", 0)
    idles = [float(x) for x in args.idle_release_ms.split(",")]
    entries = cs.PROXY_PAIRS[args.pair]
    runs = []
    t0 = time.perf_counter()
    for i in range(args.rounds):
        for idle_ms in (idles if i % 2 == 0 else idles[::-1]):
            records: dict = {}
            proxy = _recording_proxy(cs, dev, idle_ms, records)
            proxy.serve()
            base = tempfile.mkdtemp(prefix="kubeshare-proxy-pairs-")
            try:
                pair = cs._run_proxy_tenants(ROOT, proxy, entries,
                                             cs.PROXY_PAIR_S, base)
            finally:
                proxy.close()
                shutil.rmtree(base, ignore_errors=True)
            reading = cs.proxy_pair_reading(pair, entries, float("nan"))
            del reading["aggregate_over_lone"]
            a = next(iter(reading["requests"]))
            wanted = reading["share_wanted"]
            share = reading["lifetime_charged_share_a"]
            tenants = {}
            for name, r in pair.items():
                got = records.get(name, {})
                tenants[name] = {
                    **{k: got.get(k, 0) for k in
                       ("acquired", "renewed", "held", "idle_releases")},
                    **_gap_summary(got.get("gaps_ms", []), idle_ms),
                    "steps": len(r["ends"]),
                    "exec_ms_per_step": (r["proxy"]["exec_ms_total"]
                                         / r["proxy"]["exec_count"])}
            run = {"round": i, "idle_release_ms": idle_ms,
                   "reading": reading, "tenants": tenants,
                   "passes_5f_check": abs(share - wanted)
                   <= cs.GATE_SHARE_SLACK * wanted}
            runs.append(run)
            cs.log(f"round {i}, idle release {idle_ms:g} ms: {a} charged "
                   f"{share:.4f} of the token over its life (wanted "
                   f"{wanted}), {reading['share_a']:.4f} of the window's "
                   f"steps; " + "; ".join(
                       f"{n} {json.dumps(t)}" for n, t in tenants.items()))
    result = {"card": card, "pair": args.pair, "runs": runs,
              "seconds": time.perf_counter() - t0}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    cs.log(f"card: {card}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
