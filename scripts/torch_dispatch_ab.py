#!/usr/bin/env python3
"""What reaching the kernels through their ``torch.library`` custom ops
costs the host, held against a checkout where the wrappers launch them
directly, on one card in one call.

    python3 scripts/torch_dispatch_ab.py --other DIR [--label parent]
        [--rounds 4] [--out result.json]

Needs one CUDA card. ``DIR`` is the root of another checkout of the
repo (for example the parent commit, unpacked with ``git archive``);
this script's own checkout is the other side, ``change``. Each
measurement is a fresh process that imports ``kubeshare_tpu_torch`` from
one root and reads, on the card:

- ``adam_host_ms``: the host time of one fused-Adam step over the
  full-width LM's parameter tree (46 fp32 leaves), 200 calls back to
  back, three times;
- ``eager_steps_per_sec``: the LM (batch 8, seq 256, vocab 4096, dim
  256, 8 heads, 4 layers, bf16, flash attention, fused Adam) trained
  alone through ``common.run_training`` for 100 steps, a host read of the
  loss each step (what ``chip_smoke.py`` phase 5c reads), twice.

Both roots' kernels are built first; then the sides run in the order
other, change, change, other, ... (``--rounds`` pairs), so the host's
drift falls on both. Prints one JSON object as its last line: every
run, and each side's median.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure(root: str) -> dict:
    """One side's numbers, in this process (see the module docstring)."""
    import numpy as np
    import torch

    sys.path.insert(0, root)
    import kubeshare_tpu_torch
    from kubeshare_tpu_torch.models import common, transformer
    from kubeshare_tpu_torch.ops import build
    from kubeshare_tpu_torch.ops import fused_adam as fa
    from kubeshare_tpu_torch.utils.tree import tree_leaves

    assert os.path.realpath(kubeshare_tpu_torch.__file__).startswith(
        os.path.realpath(root) + os.sep), kubeshare_tpu_torch.__file__
    for name in ("fused_adam", "flash_attention"):
        build.load(name)
    dev = torch.device("cuda", 0)

    rng = np.random.default_rng(0)
    leaves = [np.asarray(a) for a in tree_leaves(transformer.init(0))]
    mk = lambda f: [torch.from_numpy(f(a)).to(dev) for a in leaves]
    ps = mk(lambda a: a.copy())
    gs = mk(lambda a: (rng.standard_normal(a.shape) * 1e-2).astype(
        np.float32))
    ms = mk(np.zeros_like)
    vs = mk(np.zeros_like)
    count = torch.tensor(1.0, device=dev)

    def adam():
        fa.adam_update_tree(ps, gs, ms, vs, count, lr=1e-3, b1=0.9,
                            b2=0.999, eps=1e-8)

    adam_ms = []
    for _ in range(3):
        for _ in range(5):
            adam()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(200):
            adam()
        adam_ms.append((time.perf_counter() - t0) * 1e3 / 200)
        torch.cuda.synchronize(dev)
    del ps, gs, ms, vs

    rates = [common.run_training(transformer.init,
                                 transformer.flash_loss_fn,
                                 transformer.batch_fn, steps=100,
                                 device=dev).steps_per_sec
             for _ in range(2)]
    return {"root": root, "adam_host_ms": adam_ms,
            "eager_steps_per_sec": rates}


def _child(args: list[str]) -> dict:
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           *args], capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{args} exited {proc.returncode}: "
                           f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="torch_dispatch_ab.py")
    parser.add_argument("--other", help="root of the other checkout")
    parser.add_argument("--label", default="parent",
                        help="the other checkout's name in the output")
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--out", default="")
    parser.add_argument("--measure", default="", help=argparse.SUPPRESS)
    parser.add_argument("--build", default="", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_dispatch_ab: needs a CUDA card", file=sys.stderr)
        return 2
    if args.measure:
        print(json.dumps(measure(os.path.abspath(args.measure))))
        return 0
    if args.build:
        sys.path.insert(0, os.path.abspath(args.build))
        from kubeshare_tpu_torch.ops import build

        for name in ("fused_adam", "flash_attention"):
            build.build(name)
        print(json.dumps({"built": args.build}))
        return 0
    if not args.other:
        parser.error("--other is required")

    roots = {args.label: os.path.abspath(args.other), "change": HERE}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    for root in roots.values():
        _child(["--build", root])
    order = []
    for r in range(args.rounds):
        pair = [args.label, "change"]
        order += pair if r % 2 == 0 else pair[::-1]
    runs = []
    for label in order:
        run = _child(["--measure", roots[label]])
        run["label"] = label
        runs.append(run)
        print(json.dumps(run), flush=True)
    sides = {}
    for label in roots:
        mine = [r for r in runs if r["label"] == label]
        sides[label] = {
            "adam_host_ms_median": statistics.median(
                x for r in mine for x in r["adam_host_ms"]),
            "eager_steps_per_sec_median": statistics.median(
                x for r in mine for x in r["eager_steps_per_sec"])}
    result = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "order": order, "runs": runs,
              "sides": sides}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
