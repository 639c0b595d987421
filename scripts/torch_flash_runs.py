#!/usr/bin/env python3
"""The flash-attention kernel phases of ``chip_smoke.py`` on one card,
alone.

    python3 scripts/torch_flash_runs.py [--no-timing] [--out result.json]

Needs one CUDA card and runs from anywhere in a checkout. It builds the
kernels (one ``nvcc`` per source, all started together) and prints each
flash kernel function's registers and spill bytes from the ``-Xptxas -v``
report and its tensor-core instructions from the SASS (HMMA for mma.sync,
HGMMA for wgmma; ``chip_smoke.check_flash_sass`` holds each function to
its kind, and the wgmma passes and the prologue to 0 spill bytes); then
runs the smoke's checks of the flash kernels against their plain versions at
every instance width the kernels are built for (8 to 256) and at head dims
between them (``chip_smoke.flash_check``, ``flash_autograd_check``,
``lse_cotangent_check``) and, unless ``--no-timing``, times the three
passes (and, from head dim 33, the backward's prologue) beside their plain
versions, SDPA and their bounds at the LM's shape (8, 256, 8, 32), at
(8, 256, 8, d) for d = 8, 16, 64, 80, 96, 128 and 256
(``chip_smoke.WIDE_SHAPES``, ``OTHER_SHAPES``) and at long context
(``LONG_SHAPE``, ``LONG_WIDE_SHAPE``). Every check is the smoke's. Prints
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
    parser = argparse.ArgumentParser(prog="torch_flash_runs.py")
    parser.add_argument("--no-timing", action="store_true",
                        help="build and check only")
    parser.add_argument("--out", default="",
                        help="also write the result here (JSON)")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_flash_runs: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    cs.log(f"card: {card}")
    result: dict = {"card": card, "torch": torch.__version__,
                    "cuda": torch.version.cuda}
    with ThreadPoolExecutor(len(cs.KERNELS)) as pool:
        builds = dict(zip(cs.KERNELS, pool.map(cs._timed_build, cs.KERNELS)))
    result["build_s"] = {k: secs for k, (secs, _) in builds.items()}
    cs.log("build s: " + ", ".join(f"{k} {v:.1f}"
                                   for k, v in result["build_s"].items()))
    result["ptxas"] = cs.ptxas_summary("\n".join(
        builds[n][1] for n in cs.FLASH_LIBRARIES))
    cs.log_ptxas(result["ptxas"])
    mma = result["sass_mma"] = cs.sass_mma_counts(cs.FLASH_LIBRARIES)
    cs.log("sass: HMMA / HGMMA instructions by kernel: " + ", ".join(
        f"{k} {n['HMMA']} / {n['HGMMA']}" for k, n in sorted(mma.items())))
    cs.check_flash_sass(mma, result["ptxas"])

    rng = np.random.default_rng(0)
    result["max_abs_err"] = cs.flash_check(dev, rng)
    result["autograd_max_abs_err"] = cs.flash_autograd_check(dev, rng)
    result["lse_max_abs_err"] = cs.lse_cotangent_check(dev, rng)
    if not args.no_timing:
        result["main"] = cs.flash_timing(dev, rng, cs.FLASH_SHAPE, 50,
                                         plain=True)
        for name in ("fwd", "dq", "dkv"):
            r = result["main"][name]
            cs.log(f"flash {name} at {cs.FLASH_SHAPE} bf16 causal: kernel "
                   f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, sdpa "
                   f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
                   f"({r['bound_by']})")
        result["long"] = cs.flash_timing(dev, rng, cs.LONG_SHAPE, 5,
                                         plain=False)
        result["wide"] = cs.flash_wide_timing(dev, rng)
    cs.log(f"card: {card}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
