#!/usr/bin/env python3
"""Repeated gate pairs on one card: how a pair of gated tenant processes
runs against one gated tenant alone, and how much that spreads in a call.

    python3 scripts/torch_gate_pairs.py [--rounds 4] [--pair even|uneven]
        [--out result.json]

Needs one CUDA card and runs from anywhere in a checkout. It builds the
kernels, then drives ``chip_smoke.py``'s node path (phase 5e): a
``LauncherDaemon`` with the per-device proxy and one pod manager per
client entry, tenants that are ``chip_smoke.py --tenant`` processes
attached by the port's shim, training the full-width transformer. Each
round runs one gated tenant alone (request 1.0, limit 1.0) and one of
phase 5e's pairs (even: requests 0.5 and 0.5; uneven: 0.25 and 0.75;
limit 1.0 each), the lone tenant first in even rounds and the pair first
in odd ones. Each run is checked as phase 5e checks it.

For each round it reports the pair's aggregate steps/s over the lone
tenant's, and each run's gate totals per step (ms charged, renews, ms
draining the device, ms waiting for the token). Prints one JSON object as
its last line: the rounds, and the ratio's mean, least and greatest.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="torch_gate_pairs.py")
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--pair", choices=("even", "uneven"), default="even",
                        help="the pair of chip_smoke.py's phase 5e to run")
    parser.add_argument("--out", default="",
                        help="also write the result here (JSON)")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_gate_pairs: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from kubeshare_tpu_torch.models import transformer
    from kubeshare_tpu_torch.ops import fused_adam as fa

    card = cs.card_line()
    cs.log(f"card: {card}")
    # the tenants' first launches must not race two builds of one library
    with ThreadPoolExecutor(len(cs.KERNELS)) as pool:
        list(pool.map(cs._timed_build, cs.KERNELS))
    adam_per_step = fa.tree_launches(transformer.init(0))
    layers = transformer.LAYERS
    entries = cs.GATE_PAIRS[args.pair]
    node = cs._Node(ROOT)
    rounds, records = [], {}
    t0 = time.perf_counter()
    try:
        cs.log(f"gate: proxy {node.start()}")
        for i in range(args.rounds):
            got = {}
            for what in (("solo", "pair") if i % 2 == 0 else
                         ("pair", "solo")):
                if what == "solo":
                    port = node.clients([("smoke/solo", 1.0)])["smoke/solo"]
                    rec = node.run([("smoke/solo", 0, port, 1.0)],
                                   cs.GATE_SOLO_S, True)["smoke/solo"]
                    cs._check_tenant("solo", rec, True, adam_per_step, layers)
                    got["solo_steps_per_sec"] = cs._solo_rate(rec)
                    got["solo_gate_per_step"] = cs._solo_gate_per_step(rec)
                else:
                    ports = node.clients([(n, req) for n, _, req in entries])
                    pair = node.run([(n, seed, ports[n], req)
                                     for n, seed, req in entries],
                                    cs.GATE_PAIR_S, True)
                    for name, rec in pair.items():
                        cs._check_tenant(name, rec, True, adam_per_step,
                                         layers)
                    got["pair"] = cs.pair_reading(pair, entries)
                    cs.log(f"pair: {json.dumps(got['pair'])}")
                    cs.check_pair(args.pair, got["pair"])
                    records[f"round {i}"] = pair
            got["order"] = "solo first" if i % 2 == 0 else "pair first"
            got["pair_over_solo"] = (got["pair"]["aggregate_steps_per_sec"]
                                     / got["solo_steps_per_sec"])
            rounds.append(got)
            pair = got["pair"]
            cs.log(f"round {i} ({got['order']}, {args.pair} pair): solo "
                   f"{got['solo_steps_per_sec']:.3f} steps/s, pair "
                   f"{pair['aggregate_steps_per_sec']:.3f} (share "
                   f"{pair['share_a']:.4f} of steps, "
                   f"{pair['gate_held_share_a']:.4f} of held time, "
                   f"{pair['lifetime_held_share_a']:.4f} over its life, "
                   f"mean run "
                   f"{pair['mean_run_steps']:.2f}), pair/solo "
                   f"{got['pair_over_solo']:.4f}; solo per step "
                   f"{cs._fmt_gate(got['solo_gate_per_step'])}; pair per "
                   f"step " + "; ".join(
                       f"{n} {cs._fmt_gate(g)}"
                       for n, g in pair["gate_per_step"].items()))
    finally:
        node.stop()
    ratios = [r["pair_over_solo"] for r in rounds]
    result = {"card": card, "rounds": rounds,
              "pair_over_solo": {"mean": sum(ratios) / len(ratios),
                                 "min": min(ratios), "max": max(ratios)},
              "seconds": time.perf_counter() - t0}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            # the pairs' tenant records too: step ends and gate totals
            json.dump(dict(result, records=records), f)
    cs.log(f"card: {card}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
