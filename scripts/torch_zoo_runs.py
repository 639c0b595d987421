#!/usr/bin/env python3
"""Phase 5j of ``chip_smoke.py`` on one card, alone.

    python3 scripts/torch_zoo_runs.py [--out result.json]

Needs one CUDA card and runs from anywhere in a checkout. It builds the
kernels, then runs ``chip_smoke.zoo_phase``: for each model of the JAX
package's zoo at full width (cifar10, ResNet-18, the ResNet-50-class
depth, VGG-16, the LSTM LM and the mixture-of-experts LM with flash
attention) one train step on the card against the CPU, the fused-Adam
kernel against its plain version over the model's whole tree, an
exclusive run through ``run_training`` and a profiled one (wall and
device ms a step, idle share, kernels a step); then the resumable
sweep, cifar10's CLI as a gate-mode tenant SIGKILLed after its first
promoted save and started again. Every check is the smoke's. Prints
one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="torch_zoo_runs.py")
    parser.add_argument("--out", default="",
                        help="also write the result here (JSON)")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_zoo_runs: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    cs.log(f"card: {card}")
    with ThreadPoolExecutor(len(cs.KERNELS)) as pool:
        list(pool.map(cs._timed_build, cs.KERNELS))
    zoo = cs.zoo_phase(ROOT, torch.device("cuda", 0),
                       np.random.default_rng(0))
    result = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "zoo": zoo}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
