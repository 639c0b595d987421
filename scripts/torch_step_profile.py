#!/usr/bin/env python3
"""Where a train step of the PyTorch/CUDA port spends its time.

    python3 scripts/torch_step_profile.py [--model NAME] [--steps 100]
        [--out result.json] [--trace trace.json]

Needs one CUDA card. Runs one of the port's models (``NAME`` any of
``models.MODEL_NAMES``; default ``mnist``) at full width with the
fused-Adam kernel, two ways, as the main path does. Each model takes its
own widths and bf16 activations; ``transformer`` (batch 8, seq 256,
vocab 4096, dim 256, 8 heads, 4 layers) runs with the flash-attention
kernels as the attention body.

The two ways:

- ``per_step``: one step, then a host read of the loss (the exclusive
  loop of ``run_training``);
- ``burst``: ``--steps`` steps back to back, one host read at the end
  (what one token-gated proxy burst runs).

For each it reports the wall time per step without the profiler, and
under ``torch.profiler`` the device time per step (the sum of kernel
times), the device's idle share of the wall time (unprofiled and
profiled), each hand-written kernel's time, launches, share of device
time and the names of the functions that ran, and the top kernels by
device time. Then it counts the aten ops one step dispatches — what the
gate-mode attach's meter hooks, once each — and times the per-step loop
under a dispatch mode that only counts them. Prints one JSON object as its
last line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


#: the port's kernels and a substring of their CUDA function names (each
#: flash pass names all of its kernels: flash_<pass>_mma_kernel for bf16
#: inputs at head dims 8 and 32, flash_<pass>_wgmma_kernel for bf16 at 64
#: and 128, where the backward runs its prologue flash_prep_kernel first,
#: flash_<pass>_kernel for fp32)
KERNEL_TAGS = {"fused_adam": "adam_multi_tensor_kernel",
               "flash_fwd": "flash_fwd_", "flash_dq": "flash_dq_",
               "flash_dkv": "flash_dkv_", "flash_prep": "flash_prep_"}


def _self_device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(evt, name, None)
        if value is not None:
            return float(value)
    return 0.0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="torch_step_profile.py")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from kubeshare_tpu_torch.models import MODEL_NAMES

    parser.add_argument("--model", choices=MODEL_NAMES, default="mnist")
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--out", default="")
    parser.add_argument("--trace", default="",
                        help="write the burst's chrome trace here")
    args = parser.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_step_profile: needs a CUDA card", file=sys.stderr)
        return 2
    from kubeshare_tpu_torch.models import common, get_model
    from kubeshare_tpu_torch.ops import build
    from kubeshare_tpu_torch.ops.fused_adam import fused_adam

    model = get_model(args.model)
    loss_fn = (model.flash_loss_fn if args.model == "transformer"
               else model.loss_fn)
    build.load("fused_adam")
    if args.model == "transformer":
        build.load("flash_attention")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]

    params = common.to_device(model.init(0), dev)
    batch = common.to_device(model.batch_fn(1), dev)
    opt = fused_adam(1e-3)
    state = opt.init(params)
    step = common.make_train_step(loss_fn, opt)

    def per_step():
        nonlocal params, state
        for _ in range(args.steps):
            params, state, loss = step(params, state, batch)
            float(loss)

    def burst():
        nonlocal params, state
        for _ in range(args.steps):
            params, state, loss = step(params, state, batch)
        float(loss)
        torch.cuda.synchronize(dev)

    result = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "model": args.model,
              "steps": args.steps}
    for name, fn in (("per_step", per_step), ("burst", burst)):
        fn()                                  # warm up
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            prof_wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
        # device-side rows only (kernels, copies, memsets): CPU-op rows
        # carry the same device time again, attributed to their launcher
        rows = [(e.key, _self_device_us(e) / 1e3 / args.steps, e.count)
                for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")]
        rows = [r for r in rows if r[1] > 0]
        device_ms = sum(r[1] for r in rows)
        # the port's own kernels, by the names of their CUDA functions
        ours = {name: sum(r[1] for r in rows if tag in r[0])
                for name, tag in KERNEL_TAGS.items()}
        ours_calls = {name: sum(r[2] for r in rows if tag in r[0])
                      / args.steps for name, tag in KERNEL_TAGS.items()}
        # which function of each ran: the bf16 step must show only the
        # tensor-core flash kernels
        ours_functions = {name: sorted({r[0] for r in rows if tag in r[0]})
                          for name, tag in KERNEL_TAGS.items()}
        rows.sort(key=lambda r: -r[1])
        result[name] = {
            "wall_ms_per_step": wall_ms,
            "profiled_wall_ms_per_step": prof_wall_ms,
            "device_ms_per_step": device_ms,
            # against the wall time without the profiler (which slows the
            # host, not the kernels), and against the profiled wall time
            "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
            "device_idle_share_profiled": max(
                0.0, 1.0 - device_ms / prof_wall_ms),
            "kernel_ms_per_step": ours,
            "kernel_launches_per_step": ours_calls,
            "kernel_functions": ours_functions,
            "kernel_share_of_device": {
                k: (ms / device_ms if device_ms else None)
                for k, ms in ours.items()},
            "kernels_per_step": sum(r[2] for r in rows) / args.steps,
            "top": [{"name": k[:90], "ms_per_step": ms,
                     "calls_per_step": c / args.steps}
                    for k, ms, c in rows[:12]],
        }
        if name == "burst" and args.trace:
            prof.export_chrome_trace(args.trace)
        print(f"{name}: {json.dumps(result[name])}", flush=True)

    # what gate-mode attach hooks: the aten ops one step dispatches (the
    # attach's meter runs once per op, backward's included), and the wall
    # time of a step under a dispatch mode that only counts them
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountOps(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += 1
            return func(*args, **(kwargs or {}))

    with CountOps() as counter:
        per_step()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        per_step()
        torch.cuda.synchronize(dev)
        counted_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    result["dispatch_mode"] = {
        "aten_ops_per_step": counter.ops / (2 * args.steps),
        "per_step_wall_ms": counted_ms}
    print(f"dispatch_mode: {json.dumps(result['dispatch_mode'])}",
          flush=True)

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(f"card: {card}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
