#!/usr/bin/env python3
"""Phase 5k of ``chip_smoke.py`` on one card, alone.

    python3 scripts/torch_gang_runs.py [--out result.json]

Needs one CUDA card and runs from anywhere in a checkout. It builds the
kernels, then runs ``chip_smoke.gang_local`` (``flash_attention_lse``
with nonzero cotangents for O and the lse against the plain versions,
and the one-process run), then ``chip_smoke.gang_phase``, whose five
gangs start together: four two-rank gangs of the LM's CLI on the one
card (dp = 2; sp = 2 with ring-flash and with Ulysses-flash; tp = 2),
each held to one process's loss, its replicated leaves equal on both ranks and its flash launches
counted by rank; and a one-rank NCCL gang with a checkpoint, SIGKILLed
after a save and resumed. Every check is the smoke's. Prints one JSON
object as its last line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="torch_gang_runs.py")
    parser.add_argument("--out", default="",
                        help="also write the result here (JSON)")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_gang_runs: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from kubeshare_tpu_torch.models import transformer
    from kubeshare_tpu_torch.ops import fused_adam as fa

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    cs.log(f"card: {card}")
    with ThreadPoolExecutor(len(cs.KERNELS)) as pool:
        list(pool.map(cs._timed_build, cs.KERNELS))
    local = cs.gang_local(torch.device("cuda", 0), np.random.default_rng(0))
    gang = cs.gang_phase(ROOT, local, fa.tree_launches(transformer.init(0)),
                         transformer.LAYERS)
    result = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "gang": gang}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
