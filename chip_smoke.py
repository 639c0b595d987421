#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``kubeshare_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out results.json]

Runs from the root of a checkout and needs one CUDA card. Phases, each
failing the run (non-zero exit, no result line) when it fails:

1. the card's name and power limit (``nvidia-smi``), torch/CUDA versions;
2. the build of every hand-written kernel from ``kubeshare_tpu_torch/csrc``;
3. each kernel held against its plain PyTorch version on the card, at the
   shapes the main path gives it, then timed beside its plain version,
   one PyTorch library call computing the same function, and its bound;
4. a small-input check of the whole train step: card against CPU;
5. the main path, with every kernel's launch count set to 0 first:
   a. exclusive — mnist at full width (batch 128, bf16 activations)
      trains alone through ``run_training``, then as a fused loop;
   b. co-located — a ``ChipProxy`` with a ``TokenScheduler`` on the card,
      two threaded ``ProxyClient``s at request 0.5 / limit 1.0 each train
      mnist through ``compile_loop`` + ``chain``;
6. the outputs of the main path: finite, of the expected shapes.

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import threading
import time
import traceback

# TPU-side Adam kernel this port replaces (file:line of its Pallas body)
ADAM_REPLACES = "kubeshare_tpu/ops/fused_adam.py:49"
ADAM_SOURCE = "kubeshare_tpu_torch/csrc/fused_adam.cu"
# Published H100 SXM peaks (data sheet, dense): HBM3 bytes/s and fp32
# FLOP/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# Adam per fp32 parameter: read p, g, m, v and write p, m, v
ADAM_BYTES_PER_PARAM = 7 * 4
# m_new 3, v_new 4, m_hat 1, v_hat 1, sqrt 1, +eps 1, lr* 1, / 1, p- 1
ADAM_OPS_PER_PARAM = 14
# kernel vs plain version on the card: both IEEE fp32, same operation order
KERNEL_ATOL = 1e-6
KERNEL_RTOL = 1e-6

WINDOW_MS = 1000.0           # shortened accounting window for the smoke
COLOCATED_SETTLE_S = 1.0
COLOCATED_MEASURE_S = 4.0    # four windows measured
CHUNK = 100


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, flush) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, CUDA events
    around each call, with the L2 cache flushed before each (outside the
    events): in a train step the optimizer finds its state cold."""
    import torch

    for _ in range(5):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def adam_check(dev, rng) -> float:
    """Kernel against plain version at every mnist leaf shape, a ragged
    length, a large one and an unaligned view. Returns max abs error."""
    import numpy as np
    import torch

    from kubeshare_tpu_torch.models import mnist
    from kubeshare_tpu_torch.ops import fused_adam as fa
    from kubeshare_tpu_torch.utils.tree import tree_leaves

    shapes = [np.shape(a) for a in tree_leaves(mnist.init(0))]
    shapes += [(37,), (1 << 20,)]
    cases = [(s, 0) for s in shapes] + [((1000,), 1)]   # 4-byte offset
    worst = 0.0
    for shape, offset in cases:
        n = int(np.prod(shape))
        host = [rng.standard_normal(n + offset).astype(np.float32)
                for _ in range(4)]
        host[3] = np.abs(host[3])
        base = [torch.from_numpy(h).to(dev) for h in host]
        step = torch.tensor(3.0, device=dev)
        views = lambda: [b.clone()[offset:].view(shape) for b in base]
        kp, kg, km, kv = views()
        fa.adam_update(kp, kg, km, kv, step, lr=1e-2)
        rp, rg, rm, rv = views()
        fa.adam_update_reference(rp, rg, rm, rv, step, lr=1e-2)
        torch.cuda.synchronize()
        for got, want in ((kp, rp), (km, rm), (kv, rv)):
            err = (got - want).abs()
            bad = err > KERNEL_ATOL + KERNEL_RTOL * want.abs()
            check(not bool(bad.any()),
                  f"fused_adam disagrees with its plain version at "
                  f"{shape} (offset {offset}): max abs err "
                  f"{float(err.max())}")
            worst = max(worst, float(err.max()))
        log(f"  fused_adam {shape}{' +4B offset' if offset else ''}: "
            f"ok, max abs err {float((kp - rp).abs().max()):.3e}")
    return worst


def adam_timing(dev, rng) -> dict:
    """Kernel, plain version and torch._fused_adam_ over the whole mnist
    tree (one optimizer step), plus the bound of that work."""
    import numpy as np
    import torch

    from kubeshare_tpu_torch.models import mnist
    from kubeshare_tpu_torch.ops import fused_adam as fa
    from kubeshare_tpu_torch.utils.tree import tree_leaves

    leaves = [np.asarray(a) for a in tree_leaves(mnist.init(0))]
    n = sum(a.size for a in leaves)
    mk = lambda f: [torch.from_numpy(f(a)).to(dev) for a in leaves]
    ps = mk(lambda a: a.copy())
    gs = mk(lambda a: (rng.standard_normal(a.shape) * 1e-2).astype(np.float32))
    ms = mk(lambda a: np.zeros_like(a))
    vs = mk(lambda a: np.zeros_like(a))
    count = torch.tensor(1.0, device=dev)
    hyper = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)

    def kernel():
        for p, g, m, v in zip(ps, gs, ms, vs):
            fa.adam_update(p, g, m, v, count, **hyper)

    def plain():
        for p, g, m, v in zip(ps, gs, ms, vs):
            fa.adam_update_reference(p, g, m, v, count, **hyper)

    maxs = [torch.zeros_like(v) for v in vs]
    steps = [torch.tensor(1.0, device=dev) for _ in ps]

    def library():
        torch._fused_adam_(ps, gs, ms, vs, maxs, steps, lr=hyper["lr"],
                           beta1=hyper["b1"], beta2=hyper["b2"],
                           weight_decay=0.0, eps=hyper["eps"],
                           amsgrad=False, maximize=False)

    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    runs = {"kernel": [], "plain": [], "library": []}
    for name in ("plain", "kernel", "library", "library", "kernel", "plain"):
        fn = {"kernel": kernel, "plain": plain, "library": library}[name]
        runs[name].append(cuda_time_ms(fn, 100, flush))
    byte_ms = (n * ADAM_BYTES_PER_PARAM + 4) / PEAK_BYTES_PER_S * 1e3
    op_ms = n * ADAM_OPS_PER_PARAM / PEAK_FP32_FLOPS * 1e3
    return {"params": int(n), "leaves": len(leaves),
            "ms": min(runs["kernel"]), "plain_ms": min(runs["plain"]),
            "library_ms": min(runs["library"]),
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "runs_ms": runs}


def step_check(dev) -> dict:
    """One mnist train step (batch 8, fp32 activations) on the card
    against the same step on the CPU (plain versions): the kernel inside
    the real step. Adam's first step is ~ -lr*sign(g), so a parameter
    whose |g| is near eps may flip sign between the two devices' sums:
    such elements are held to 2*lr, the rest to 1e-5."""
    import numpy as np
    import torch

    from kubeshare_tpu_torch.models import common, mnist
    from kubeshare_tpu_torch.ops.fused_adam import fused_adam
    from kubeshare_tpu_torch.utils.tree import tree_leaves

    lr = 1e-3
    params = mnist.init(7)
    x, y = mnist.batch_fn(8)
    batch = (x[:8], y[:8])
    saved = mnist.DTYPE
    mnist.DTYPE = torch.float32
    try:
        out = {}
        for where in ("cpu", dev):
            p = common.to_device(params, where)
            b = common.to_device(batch, where)
            _, grads = common.value_and_grad(mnist.loss_fn, p, b)
            opt = fused_adam(lr)
            step = common.make_train_step(mnist.loss_fn, opt)
            p, _, loss = step(p, opt.init(p), b)
            out[str(where)] = (float(loss),
                               [t.cpu().numpy() for t in tree_leaves(p)],
                               [t.cpu().numpy() for t in tree_leaves(grads)])
    finally:
        mnist.DTYPE = saved
    (lc, pc, gc), (lg, pg, gg) = out["cpu"], out[str(dev)]
    check(abs(lc - lg) <= 1e-5 * max(1.0, abs(lc)),
          f"train-step loss cuda {lg} vs cpu {lc}")
    worst = 0.0
    for a, b, g in zip(pc, pg, gc):
        d = np.abs(a - b)
        check(d.max() <= 2 * lr + 1e-6, f"param moved {d.max()} apart")
        firm = np.abs(g) > 1e-4
        if firm.any():
            check(d[firm].max() <= 1e-5,
                  f"param with |g|>1e-4 off by {d[firm].max()}")
            worst = max(worst, float(d[firm].max()))
    grad_err = max(float(np.abs(a - b).max()) for a, b in zip(gc, gg))
    check(grad_err <= 1e-5, f"grads cuda vs cpu off by {grad_err}")
    return {"loss_cpu": lc, "loss_cuda": lg, "grad_max_abs_err": grad_err,
            "param_max_abs_err_firm": worst}


def exclusive(dev) -> dict:
    """mnist alone on the card: the per-step loop of run_training, then a
    fused loop (CHUNK steps between barriers, as a proxy burst runs)."""
    from kubeshare_tpu_torch.models import common, mnist
    from kubeshare_tpu_torch.ops.fused_adam import fused_adam
    from kubeshare_tpu_torch.utils.device import synchronize

    res = common.run_training(mnist.init, mnist.loss_fn, mnist.batch_fn,
                              steps=300, device=dev)
    check(math.isfinite(res.final_loss) and math.isfinite(res.first_loss),
          f"exclusive loss not finite: {res}")
    check(res.final_loss < res.first_loss,
          f"exclusive loss did not fall: {res.first_loss} -> "
          f"{res.final_loss}")

    params = common.to_device(mnist.init(0), dev)
    batch = common.to_device(mnist.batch_fn(1), dev)
    opt = fused_adam(1e-3)
    state = opt.init(params)
    step = common.make_train_step(mnist.loss_fn, opt)
    for _ in range(CHUNK):
        params, state, loss = step(params, state, batch)
    float(loss)
    fused_steps = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 3.0:
        for _ in range(CHUNK):
            params, state, loss = step(params, state, batch)
        float(loss)
        synchronize(dev)
        fused_steps += CHUNK
    fused_sps = fused_steps / (time.perf_counter() - t0)
    return {"plain_steps_per_sec": res.steps_per_sec,
            "plain_steps": res.steps, "warmup_steps": 2,
            "first_loss": res.first_loss, "final_loss": res.final_loss,
            "fused_steps_per_sec": fused_sps,
            "fused_steps": fused_steps + CHUNK}


def colocated(dev) -> dict:
    """Two mnist trainers at request 0.5 through the port's proxy."""
    import numpy as np

    from kubeshare_tpu_torch.constants import BASE_QUOTA_MS, MIN_QUOTA_MS
    from kubeshare_tpu_torch.isolation import programs
    from kubeshare_tpu_torch.isolation.client import ProxyClient
    from kubeshare_tpu_torch.isolation.proxy import ChipProxy
    from kubeshare_tpu_torch.isolation.tokensched import TokenScheduler
    from kubeshare_tpu_torch.models import mnist
    from kubeshare_tpu_torch.utils.tree import tree_leaves

    spec = {"program": "train_step", "model": "mnist",
            "optimizer": {"name": "fused_adam", "lr": 1e-3, "b1": 0.9,
                          "b2": 0.999, "eps": 1e-8}}
    proxy = ChipProxy(device=dev, scheduler=TokenScheduler(
        WINDOW_MS, BASE_QUOTA_MS, MIN_QUOTA_MS))
    proxy.serve()
    barrier = threading.Barrier(2, timeout=300)
    # set once both clients have read their counters: until then each
    # keeps chaining, so neither window has a tail run alone
    measured: list = []
    all_measured = threading.Event()
    results: dict = {}
    errors: dict = {}

    def trainer(name: str, seed: int) -> None:
        try:
            # host-side staging only: the proxy alone touches the card
            with ProxyClient("127.0.0.1", proxy.port, name, 0.5, 1.0) as c:
                carry = c.put_tree(programs.initial_carry(spec, seed))
                batch = c.put_tree(tuple(mnist.batch_fn(seed + 1)))
                loop = c.compile_loop(spec, carry, *batch)
                for _ in range(3):      # seed the burst cost model
                    carry, loss = loop(CHUNK, carry, *batch)
                    c.free(loss)
                barrier.wait()
                t_settle = time.perf_counter() + COLOCATED_SETTLE_S
                while time.perf_counter() < t_settle:
                    carry, loss = loop.chain(CHUNK, carry, *batch)
                    c.free(loss)
                barrier.wait()          # both windows open together
                used0 = c.usage()["exec_ms_total"]
                steps = 0
                start = time.perf_counter()
                while time.perf_counter() - start < COLOCATED_MEASURE_S:
                    carry, loss = loop.chain(CHUNK * 8, carry, *batch)
                    steps += loop.last_n
                    last_loss = c.get(loss)
                    c.free(loss)
                elapsed = time.perf_counter() - start
                usage = c.usage()
                measured.append(name)
                if len(measured) == 2:
                    all_measured.set()
                while not all_measured.is_set():
                    carry, loss = loop.chain(CHUNK, carry, *batch)
                    c.free(loss)
                final = c.get_tree(carry)
                results[name] = {
                    "steps": steps, "elapsed_s": elapsed,
                    "steps_per_sec": steps / elapsed,
                    "exec_ms": usage["exec_ms_total"] - used0,
                    "exec_count": usage["exec_count"],
                    "last_burst": loop.last_burst,
                    "final_loss": float(last_loss),
                    "carry": final}
        except BaseException:
            errors[name] = traceback.format_exc()
            barrier.abort()
            all_measured.set()

    threads = [threading.Thread(target=trainer, args=(n, s), name=n)
               for n, s in (("client-a", 10), ("client-b", 20))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            check(not t.is_alive(), f"{t.name} did not finish")
    finally:
        proxy.close()
    check(not errors, f"co-located clients failed: {errors}")
    (cost,) = proxy._costs.values()
    a, b = results["client-a"], results["client-b"]
    # outputs of the main path: finite, of the expected shapes
    expect = [np.shape(x) for x in
              tree_leaves(programs.initial_carry(spec, 0))]
    for name, r in results.items():
        leaves = tree_leaves(r.pop("carry"))
        check([np.shape(x) for x in leaves] == expect,
              f"{name}: carry shapes changed")
        check(all(np.isfinite(x).all() for x in leaves),
              f"{name}: carry not finite")
        check(math.isfinite(r["final_loss"]), f"{name}: loss not finite")
        check(r["steps"] > 0, f"{name} made no progress")
    # device time per second of each client's own window: the windows
    # open together but close one chain call apart
    rate_a = a["exec_ms"] / 1000.0 / a["elapsed_s"]
    rate_b = b["exec_ms"] / 1000.0 / b["elapsed_s"]
    share_a = rate_a / (rate_a + rate_b) if rate_a + rate_b else 0.0
    check(0.3 <= share_a <= 0.7,
          f"device-time share of client-a {share_a} outside [0.3, 0.7]")
    return {"clients": {"client-a": a, "client-b": b},
            "aggregate_steps_per_sec": a["steps_per_sec"]
            + b["steps_per_sec"],
            "share_a": share_a,
            "device_busy_share": rate_a + rate_b,
            "share_error_pct": abs(share_a - 0.5) / 0.5 * 100.0,
            "steady_state_burst": [a["last_burst"], b["last_burst"]],
            "cost_model_ms": {"step": cost.step_ms,
                              "loop_step": cost.loop_step_ms},
            "window_ms": WINDOW_MS}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="chip_smoke.py")
    parser.add_argument("--out", default="",
                        help="also write every phase's numbers here (JSON)")
    args = parser.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from kubeshare_tpu_torch.ops import build
        from kubeshare_tpu_torch.ops import fused_adam as fa
    except ImportError as e:
        print(f"chip_smoke: the kubeshare_tpu_torch package is missing "
              f"({e}); run from the root of a checkout", file=sys.stderr)
        return 2
    import numpy as np

    # full fp32 on the card wherever numbers are compared: cuDNN convs
    # default to TF32 (about three decimal digits)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}")
    out: dict = {"card": card}

    t0 = time.perf_counter()
    text = build.build("fused_adam")
    out["build_s"] = time.perf_counter() - t0
    log(f"build: fused_adam {out['build_s']:.1f} s")
    for line in text.strip().splitlines():
        log(f"  [fused_adam] {line}")

    rng = np.random.default_rng(0)
    log("kernel check (kernel vs plain, atol "
        f"{KERNEL_ATOL}, rtol {KERNEL_RTOL}):")
    max_err = adam_check(dev, rng)
    adam = adam_timing(dev, rng)
    log(f"fused_adam over the mnist tree ({adam['params']} params, "
        f"{adam['leaves']} launches): kernel {adam['ms']:.4f} ms, plain "
        f"{adam['plain_ms']:.4f} ms, torch._fused_adam_ "
        f"{adam['library_ms']:.4f} ms, bound {adam['bound_ms']:.4f} ms "
        f"({adam['bound_by']})")
    out["fused_adam"] = dict(adam, max_abs_err=max_err)
    out["step_check"] = step_check(dev)
    log(f"train step card vs cpu: {out['step_check']}")

    # --- main path: counts from 0 -------------------------------------
    fa.reset_launches()
    excl = exclusive(dev)
    excl_launches = fa.launches
    want = 8 * (excl["plain_steps"] + excl["warmup_steps"]
                + excl["fused_steps"])
    check(excl_launches == want,
          f"exclusive phase: {excl_launches} Adam launches, expected {want}")
    log(f"exclusive: {json.dumps(excl)}; adam launches {excl_launches}")
    col = colocated(dev)
    total_launches = fa.launches
    col_launches = total_launches - excl_launches
    measured = sum(c["steps"] for c in col["clients"].values())
    check(col_launches >= 8 * measured,
          f"co-located phase: {col_launches} Adam launches for "
          f"{measured} measured steps")
    exclusive_sps = max(excl["plain_steps_per_sec"],
                        excl["fused_steps_per_sec"])
    col["ratio_to_exclusive"] = (col["aggregate_steps_per_sec"]
                                 / exclusive_sps)
    col["adam_launches"] = col_launches
    log(f"co-located: {json.dumps(col)}")
    out.update(exclusive=excl, colocated=col,
               launches={"fused_adam": total_launches},
               seconds=time.perf_counter() - t_start)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)

    log(f"card: {card}")
    print(json.dumps({"kernels": [{
        "name": "fused_adam", "route": "cuda", "source": ADAM_SOURCE,
        "replaces": ADAM_REPLACES, "launches": total_launches,
        "max_abs_err": max_err, "ms": adam["ms"],
        "plain_ms": adam["plain_ms"], "bound_ms": adam["bound_ms"],
        "bound_by": adam["bound_by"], "library_ms": adam["library_ms"]}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
