#!/usr/bin/env python3
"""Phase 5h of ``chip_smoke.py`` alone, repeated: latency-class serving
beside a best-effort trainer, on the card.

    python3 scripts/torch_serve_runs.py [--rounds 3] [--out results.json]
        [--variants=all,-cond,-ledger,-tracer,-slo,-all]

Each round runs ``chip_smoke.py``'s 5g-loop (the one-call reference of
the trainer's losses) and then its 5h (exclusive, preempt_off and
preempt_on runs, with every check of the smoke) once for each variant,
the variants in turn: ``all`` with every obs hook on, as the smoke runs
it, ``-X`` with hook X of ``chip_smoke.SERVE_HOOKS`` off (``-all``: every
one off; a run with a hook off skips the obs reading; write the list
after ``=`` when it starts with ``-``). It prints 5h's lines:
achieved requests/s, latency p50/p99 by class, the serving session's
grant wait, the trainer's steps/s and bursts, the policy's and the
slicer's counts, and each run's observability line (ledger seconds by
tenant and state, blame edges, SLO alerts, flight dumps, critpath's split
of the latency row at p99). Prints the card's name and power limit
first. Needs a
CUDA card; a failed check ends the script as it ends the smoke.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="torch_serve_runs.py")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--out", default="",
                        help="also write every round's numbers here (JSON)")
    parser.add_argument("--variants", default="all",
                        help="comma-separated: all, -all, or -HOOK")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_serve_runs: no CUDA device; this script runs on the "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    variants = {}
    for v in args.variants.split(","):
        if v == "all":
            variants[v] = ()
        elif v == "-all":
            variants[v] = cs.SERVE_HOOKS
        elif v.startswith("-") and v[1:] in cs.SERVE_HOOKS:
            variants[v] = (v[1:],)
        else:
            parser.error(f"unknown variant {v!r}")
    from kubeshare_tpu_torch.models import transformer
    from kubeshare_tpu_torch.ops import fused_adam as fa

    # full fp32 where numbers are compared, as the smoke sets it
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"card: {cs.card_line()}", flush=True)
    per_step = cs._launches_per_step(fa.tree_launches(transformer.init(0)),
                                     transformer.LAYERS)
    rounds = []
    for i in range(args.rounds):
        t0 = time.perf_counter()
        loop = cs._loop_phase(dev, per_step)
        print(f"round {i + 1}: 5g-loop {loop['steps_per_sec']:.3f} steps/s "
              f"in bursts {loop['bursts']}", flush=True)
        for v, off in variants.items():
            h = cs.serve_phase(dev, per_step, loop["one_call_losses"],
                               off=off)
            print(f"round {i + 1} variant {v}: 5h set-up "
                  f"{h['setup_s']:.2f} s; {time.perf_counter() - t0:.1f} s; "
                  f"hook us a lone cycle {h['hook_us']}", flush=True)
            for r in h["runs"].values():
                print(cs._fmt_serve_run(r), flush=True)
                if r["obs"] is not None:
                    print(cs._fmt_serve_obs(r), flush=True)
            rounds.append({"round": i + 1, "variant": v, "runs": h["runs"],
                           "hook_us": h["hook_us"]})
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": cs.card_line(), "rounds": rounds}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
