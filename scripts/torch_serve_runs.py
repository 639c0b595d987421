#!/usr/bin/env python3
"""Phase 5h of ``chip_smoke.py`` alone, repeated: latency-class serving
beside a best-effort trainer, on the card.

    python3 scripts/torch_serve_runs.py [--rounds 3] [--out results.json]

Each round runs ``chip_smoke.py``'s 5g-loop (the one-call reference of
the trainer's losses) and then its 5h (exclusive, preempt_off and
preempt_on runs, with every check of the smoke), and prints 5h's lines:
achieved requests/s, latency p50/p99 by class, the serving session's
grant wait, the trainer's steps/s and bursts, the policy's and the
slicer's counts. Prints the card's name and power limit first. Needs a
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
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_serve_runs: no CUDA device; this script runs on the "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
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
        h = cs.serve_phase(dev, per_step, loop["one_call_losses"])
        print(f"round {i + 1}: 5g-loop {loop['steps_per_sec']:.3f} steps/s "
              f"in bursts {loop['bursts']}; 5h set-up {h['setup_s']:.2f} s; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for r in h["runs"].values():
            print(cs._fmt_serve_run(r), flush=True)
        rounds.append(h["runs"])
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": cs.card_line(), "rounds": rounds}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
