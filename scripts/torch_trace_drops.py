#!/usr/bin/env python
"""How often a profiled run's trace misses a kernel that ran, and in which
step: the reading behind ``run_training``'s warm profiler step.

Each round trains each model for ``--steps`` profiled steps through
``common.run_training(profile_dir=...)``, once per variant:

- ``cold``: the profiler as it was before it had a schedule: it starts
  recording at the first timed step;
- ``warm``: ``common._profiler`` as it is: the first profiled step is the
  profiler's warm-up and the trace holds the others.

The trace's kernels are cut into steps at each fused-Adam launch (one a
step for these models), and each step's flash launches are held to the
model's layers; the launch counters of ``ops.flash_attention`` and
``ops.fused_adam`` say what really ran. One line a run with a short
trace, then one JSON line of totals by variant: runs, runs short of an
event, and the missing events by kernel and by step.

    python3 scripts/torch_trace_drops.py [--rounds 20] [--steps 5]
        [--models moe_lm,lm_hd64,lm_hd16] [--variants cold,warm]

Needs the card; imports no JAX.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import tempfile
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

TAGS = {"fused_adam": "adam_multi_tensor_kernel", "flash_fwd": "flash_fwd_",
        "flash_dq": "flash_dq_", "flash_dkv": "flash_dkv_"}


def _cold_profiler(profile_dir, device, steps):
    """The profiler with no schedule: recording from the first step."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   on_trace_ready=tensorboard_trace_handler(profile_dir))


def _steps_of(trace_path: str) -> list:
    """The trace's kernels by step: a new step after each Adam launch.
    Returns one Counter of TAGS a step."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted((e["ts"], e["name"]) for e in events
                     if e.get("cat") == "kernel")
    steps, cur = [], Counter()
    for _, name in kernels:
        for k, tag in TAGS.items():
            if tag in name:
                cur[k] += 1
        if TAGS["fused_adam"] in name:
            steps.append(cur)
            cur = Counter()
    if sum(cur.values()):
        steps.append(cur)
    return steps


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="torch_trace_drops.py")
    parser.add_argument("--rounds", type=int, default=20)
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--models", default="moe_lm,lm_hd64,lm_hd16")
    parser.add_argument("--variants", default="cold,warm")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_trace_drops: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from kubeshare_tpu_torch.models import common
    from kubeshare_tpu_torch.ops import flash_attention as fl
    from kubeshare_tpu_torch.ops import fused_adam as fa

    dev = torch.device("cuda")
    warm_profiler = common._profiler
    variants = args.variants.split(",")
    totals = {v: {"runs": 0, "short_runs": 0, "missing_by_kernel": Counter(),
                  "missing_by_step": Counter()} for v in variants}
    root = tempfile.mkdtemp(prefix="kubeshare-trace-drops-")
    try:
        for rnd in range(args.rounds):
            for label in args.models.split(","):
                mod, init_fn, loss_fn = chip_smoke._zoo_model(label)
                layers = init_fn.keywords.get("layers", mod.LAYERS)
                for variant in variants:
                    common._profiler = (_cold_profiler if variant == "cold"
                                        else warm_profiler)
                    d = os.path.join(root, f"{variant}-{label}-{rnd}")
                    fl.reset_launches()
                    fa.reset_launches()
                    common.run_training(init_fn, loss_fn, mod.batch_fn,
                                        steps=args.steps, device=dev,
                                        profile_dir=d)
                    ran = {k: fl.launches[k.partition("_")[2]]
                           for k in TAGS if k != "fused_adam"}
                    ran["fused_adam"] = fa.launches
                    (path,) = glob.glob(os.path.join(d, "*.pt.trace.json"))
                    steps = _steps_of(path)
                    want = {"fused_adam": 1, "flash_fwd": layers,
                            "flash_dq": layers, "flash_dkv": layers}
                    missing = {(i, k): want[k] - s[k]
                               for i, s in enumerate(steps) for k in want
                               if s[k] != want[k]}
                    t = totals[variant]
                    t["runs"] += 1
                    if missing:
                        t["short_runs"] += 1
                        for (i, k), n in missing.items():
                            t["missing_by_kernel"][k] += n
                            t["missing_by_step"][i] += n
                        print(f"{variant} {label} round {rnd}: traced steps "
                              f"{len(steps)}, missing (step, kernel): "
                              f"{ {f'{i},{k}': n for (i, k), n in missing.items()} }; "
                              f"launched {ran}", flush=True)
                    shutil.rmtree(d, ignore_errors=True)
    finally:
        common._profiler = warm_profiler
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"card": chip_smoke.card_line(), "steps": args.steps,
                      "rounds": args.rounds, "models": args.models,
                      "totals": {v: {k: (dict(x) if isinstance(x, Counter)
                                         else x) for k, x in t.items()}
                                 for v, t in totals.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
