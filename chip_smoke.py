#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``kubeshare_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out results.json]

Runs from the root of a checkout and needs one CUDA card. Phases, each
failing the run (non-zero exit, no result line) when it fails:

1. the card's name and power limit (``nvidia-smi``), torch/CUDA versions;
2. the build of every hand-written kernel from ``kubeshare_tpu_torch/csrc``,
   one ``nvcc`` per source, all started together, and the tensor-core
   instructions (HMMA) of the bf16 flash forward counted in its SASS;
3. each kernel held against its plain PyTorch version on the card, at the
   shapes the main path gives it (fused Adam also over the whole mnist
   and transformer trees in one multi-tensor launch; flash attention also
   through autograd in bf16, where its forward's lse feeds the backward
   kernels), then timed beside its plain version, one PyTorch library
   call computing the same function, and its bound (plus flash attention
   at seq 8192, off the main path);
4. small-input checks of whole train steps, card against CPU: mnist, and
   the transformer with flash attention;
5. the main paths, each with every kernel's launch count set to 0 just
   before it and read just after:
   a. mnist exclusive — full width (batch 128, bf16 activations), alone
      through ``run_training``, then as a fused loop;
   b. mnist co-located — a ``ChipProxy`` with a ``TokenScheduler`` on the
      card, two threaded ``ProxyClient``s at request 0.5 / limit 1.0 each
      train mnist through ``compile_loop`` + ``chain``;
   c. transformer exclusive — the LM at full width (batch 8, seq 256,
      vocab 4096, dim 256, 8 heads, 4 layers, bf16) with flash attention,
      alone, then as a fused loop;
   d. transformer co-located — as b, with ``"attention": "flash"``;
6. the outputs of the main paths: finite, of the expected shapes.

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from functools import partial

# TPU-side kernels this port replaces (file:line of each Pallas body)
ADAM_REPLACES = "kubeshare_tpu/ops/fused_adam.py:49"
ADAM_SOURCE = "kubeshare_tpu_torch/csrc/fused_adam.cu"
FLASH_REPLACES = {"fwd": "kubeshare_tpu/ops/flash_attention.py:80",
                  "dq": "kubeshare_tpu/ops/flash_attention.py:223",
                  "dkv": "kubeshare_tpu/ops/flash_attention.py:256"}
FLASH_SOURCE = "kubeshare_tpu_torch/csrc/flash_attention.cu"
KERNELS = ("fused_adam", "flash_attention")
# Published H100 SXM peaks (data sheet, dense): HBM3 bytes/s, fp32 FLOP/s
# outside the tensor cores, bf16 FLOP/s of the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
# Adam per fp32 parameter: read p, g, m, v and write p, m, v
ADAM_BYTES_PER_PARAM = 7 * 4
# m_new 3, v_new 4, m_hat 1, v_hat 1, sqrt 1, +eps 1, lr* 1, / 1, p- 1
ADAM_OPS_PER_PARAM = 14
# kernel vs plain version on the card: both IEEE fp32, same operation order
KERNEL_ATOL = 1e-6
KERNEL_RTOL = 1e-6
# flash attention on the transformer's main path: (batch, seq, heads, head
# dim), bf16, causal; and one long-context shape off the main path
FLASH_SHAPE = (8, 256, 8, 32)
LONG_SHAPE = (1, 8192, 8, 32)
# operations per visible (q, k) pair and head-dim element: the forward's
# two products (S = QK^T, PV), dQ's three (S, dP = dO V^T, dS K) and
# dK/dV's four (S, P^T dO, dP, dS^T Q), two operations (multiply, add) each
FLASH_OPS_PER_PAIR_DIM = {"fwd": 4, "dq": 6, "dkv": 8}

WINDOW_MS = 1000.0           # shortened accounting window for the smoke
COLOCATED_SETTLE_S = 1.0
CHUNK = 100
# windows measured: four for mnist; eight for the transformer, whose
# bursts (~16 steps of ~14 ms) are a quarter window each
COLOCATED_MEASURE_S = {"mnist": 4.0, "transformer": 8.0}
# steps asked of one measured chain call (each ~1-2 s while shared)
CHAIN_STEPS = {"mnist": CHUNK * 8, "transformer": 32}
LM_SPEC = {"program": "train_step", "model": "transformer",
           "attention": "flash",
           "optimizer": {"name": "fused_adam", "lr": 1e-3, "b1": 0.9,
                         "b2": 0.999, "eps": 1e-8}}


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


_cycles_per_ms = None


def _sleep_ms(ms: float) -> None:
    """Keep the card busy for about ``ms``: ``torch.cuda._sleep`` spins a
    number of clock cycles, calibrated once against CUDA events."""
    global _cycles_per_ms
    import torch

    if _cycles_per_ms is None:
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        torch.cuda._sleep(10_000_000)
        e.record()
        e.synchronize()
        _cycles_per_ms = 10_000_000 / s.elapsed_time(e)
    torch.cuda._sleep(int(ms * _cycles_per_ms))


def cuda_time_ms(fn, iters: int, flush) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls: CUDA events
    around each call, with the L2 cache flushed before each (outside the
    events): in a train step the optimizer finds its state cold. The card
    first sleeps while the host queues every call, so the events time the
    card's work, not gaps where it waits for the host."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once_ms = (time.perf_counter() - t0) * 1e3
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    _sleep_ms(min(2 * iters * (once_ms + 0.1), 5000.0))
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def host_time_ms(fn, iters: int) -> float:
    """Host time of one ``fn()`` call: ``iters`` calls back to back, no
    synchronization among them. Where the card is the slower of the two,
    this reads the card's rate instead."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return host_ms


def _check_adam_close(label: str, pairs) -> float:
    """Kernel results against plain ones, element by element at
    KERNEL_ATOL/RTOL. Returns the max abs error."""
    worst = 0.0
    for got, want in pairs:
        err = (got - want).abs()
        bad = err > KERNEL_ATOL + KERNEL_RTOL * want.abs()
        check(not bool(bad.any()),
              f"fused_adam disagrees with its plain version at {label}: "
              f"max abs err {float(err.max())}")
        worst = max(worst, float(err.max()))
    return worst


def adam_check(dev, rng) -> float:
    """Kernel against plain version at every leaf shape of both main paths
    (mnist and the full-width transformer), a ragged length, a large one
    and an unaligned view, each a one-leaf table; then the whole mnist and
    transformer trees in one multi-tensor launch each, their first leaf an
    unaligned view. Returns max abs error."""
    import numpy as np
    import torch

    from kubeshare_tpu_torch.models import mnist, transformer
    from kubeshare_tpu_torch.ops import fused_adam as fa
    from kubeshare_tpu_torch.utils.tree import tree_leaves

    trees = {"mnist": tree_leaves(mnist.init(0)),
             "transformer": tree_leaves(transformer.init(0))}
    shapes = list(dict.fromkeys(np.shape(a) for leaves in trees.values()
                                for a in leaves))
    shapes += [(37,), (1 << 20,)]
    cases = [(s, 0) for s in shapes] + [((1000,), 1)]   # 4-byte offset
    step = torch.tensor(3.0, device=dev)
    worst = 0.0
    for shape, offset in cases:
        n = int(np.prod(shape))
        host = [rng.standard_normal(n + offset).astype(np.float32)
                for _ in range(4)]
        host[3] = np.abs(host[3])
        base = [torch.from_numpy(h).to(dev) for h in host]
        views = lambda: [b.clone()[offset:].view(shape) for b in base]
        kp, kg, km, kv = views()
        fa.adam_update(kp, kg, km, kv, step, lr=1e-2)
        rp, rg, rm, rv = views()
        fa.adam_update_reference(rp, rg, rm, rv, step, lr=1e-2)
        torch.cuda.synchronize()
        label = f"{shape} (offset {offset})"
        worst = max(worst, _check_adam_close(
            label, ((kp, rp), (km, rm), (kv, rv))))
        log(f"  fused_adam {shape}{' +4B offset' if offset else ''}: "
            f"ok, max abs err {float((kp - rp).abs().max()):.3e}")
    for model, leaves in trees.items():
        shapes = [np.shape(a) for a in leaves]
        host = [[rng.standard_normal(int(np.prod(s)) + (j == 0)).astype(
            np.float32) for j, s in enumerate(shapes)] for _ in range(4)]
        host[3] = [np.abs(a) for a in host[3]]
        base = [[torch.from_numpy(a).to(dev) for a in h] for h in host]
        # leaf 0 starts 4 bytes into its storage: the scalar path
        tree = lambda: [[b.clone()[(j == 0):].view(s)
                         for j, (b, s) in enumerate(zip(bs, shapes))]
                        for bs in base]
        kern, plain = tree(), tree()
        check(kern[0][0].data_ptr() % 16 != 0, "leaf 0 is aligned")
        before = fa.launches
        fa.adam_update_tree(*kern, step, lr=1e-2)
        launched = fa.launches - before
        for p, g, m, v in zip(*plain):
            fa.adam_update_reference(p, g, m, v, step, lr=1e-2)
        torch.cuda.synchronize()
        check(launched == fa.tree_launches(leaves) == 1,
              f"fused_adam over the {model} tree: {launched} launches")
        err = _check_adam_close(f"the {model} tree", [
            (k, r) for i in (0, 2, 3) for k, r in zip(kern[i], plain[i])])
        worst = max(worst, err)
        log(f"  fused_adam {model} tree ({len(leaves)} leaves, leaf 0 "
            f"+4B offset) in {launched} launch: ok, max abs err {err:.3e}")
    return worst


def adam_timing(dev, rng, init_fn) -> dict:
    """Kernel (one multi-tensor launch), plain version (leaf by leaf) and
    torch._fused_adam_ over the whole tree of ``init_fn`` (one optimizer
    step), plus the bound of that work."""
    import numpy as np
    import torch

    from kubeshare_tpu_torch.ops import fused_adam as fa
    from kubeshare_tpu_torch.utils.tree import tree_leaves

    leaves = [np.asarray(a) for a in tree_leaves(init_fn(0))]
    n = sum(a.size for a in leaves)
    mk = lambda f: [torch.from_numpy(f(a)).to(dev) for a in leaves]
    ps = mk(lambda a: a.copy())
    gs = mk(lambda a: (rng.standard_normal(a.shape) * 1e-2).astype(np.float32))
    ms = mk(lambda a: np.zeros_like(a))
    vs = mk(lambda a: np.zeros_like(a))
    count = torch.tensor(1.0, device=dev)
    hyper = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)

    def kernel():
        fa.adam_update_tree(ps, gs, ms, vs, count, **hyper)

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
            "launches": fa.tree_launches(leaves),
            "ms": min(runs["kernel"]), "plain_ms": min(runs["plain"]),
            "library_ms": min(runs["library"]),
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "host_ms": {"kernel": host_time_ms(kernel, 200),
                        "library": host_time_ms(library, 200)},
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


def exclusive(dev, init_fn, loss_fn, batch_fn, steps: int,
              fused_s: float) -> dict:
    """One model alone on the card: the per-step loop of run_training, then
    a fused loop (CHUNK steps between barriers, as a proxy burst runs)."""
    from kubeshare_tpu_torch.models import common
    from kubeshare_tpu_torch.ops.fused_adam import fused_adam
    from kubeshare_tpu_torch.utils.device import synchronize

    res = common.run_training(init_fn, loss_fn, batch_fn, steps=steps,
                              device=dev)
    check(math.isfinite(res.final_loss) and math.isfinite(res.first_loss),
          f"exclusive loss not finite: {res}")
    check(res.final_loss < res.first_loss,
          f"exclusive loss did not fall: {res.first_loss} -> "
          f"{res.final_loss}")

    params = common.to_device(init_fn(0), dev)
    batch = common.to_device(batch_fn(1), dev)
    opt = fused_adam(1e-3)
    state = opt.init(params)
    step = common.make_train_step(loss_fn, opt)
    for _ in range(CHUNK):
        params, state, loss = step(params, state, batch)
    float(loss)
    fused_steps = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < fused_s:
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


def colocated(dev, spec: dict, batch_fn, chain_steps: int,
              measure_s: float) -> dict:
    """Two trainers of ``spec`` at request 0.5 through the port's proxy,
    measured for ``measure_s`` seconds; each measured chain call asks for
    ``chain_steps`` steps."""
    import numpy as np

    from kubeshare_tpu_torch.constants import BASE_QUOTA_MS, MIN_QUOTA_MS
    from kubeshare_tpu_torch.isolation import programs
    from kubeshare_tpu_torch.isolation.client import ProxyClient
    from kubeshare_tpu_torch.isolation.proxy import ChipProxy
    from kubeshare_tpu_torch.isolation.tokensched import TokenScheduler
    from kubeshare_tpu_torch.utils.tree import tree_leaves

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
                batch = c.put_tree(tuple(batch_fn(seed + 1)))
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
                while time.perf_counter() - start < measure_s:
                    carry, loss = loop.chain(chain_steps, carry, *batch)
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


def _flash_inputs(dev, rng, b, s, h, hk, d, dtype, layout="dense"):
    """q (b, s, h, d), k and v (b, s, hk, d) in ``dtype``, dO fp32. With
    layout ``fused``, q, k and v are strided views of one (b, s, (h + 2 hk)
    d) tensor, sliced as ``mha_apply`` slices the fused qkv product;
    ``unaligned`` adds one element to that tensor's rows, so no row starts
    16-byte aligned."""
    import torch

    randn = lambda *shape: torch.from_numpy(rng.standard_normal(
        shape).astype("float32")).to(dev)
    dout = randn(b, s, h, d)
    if layout == "dense":
        make = lambda heads: randn(b, s, heads, d).to(dtype)
        return make(h), make(hk), make(hk), dout
    pad = 1 if layout == "unaligned" else 0
    qkv = randn(b, s, (h + 2 * hk) * d + pad).to(dtype)
    q = qkv[..., :h * d].reshape(b, s, h, d)
    k = qkv[..., h * d:(h + hk) * d].reshape(b, s, hk, d)
    v = qkv[..., (h + hk) * d:(h + 2 * hk) * d].reshape(b, s, hk, d)
    return q, k, v, dout


def _check_flash_close(kernel: str, label: str, name: str, got,
                       want) -> tuple[float, float]:
    """``got`` against ``want`` at KERNEL_TOL for got's dtype; returns the
    max abs and rel errors."""
    import torch

    from kubeshare_tpu_torch.ops import flash_attention as fl

    atol, rtol = fl.KERNEL_TOL[got.dtype]
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"flash {kernel} {label}: {name} is {got.dtype} "
          f"{tuple(got.shape)}, plain {want.dtype} {tuple(want.shape)}")
    got, want = got.float(), want.float()
    err = (got - want).abs()
    abs_err = float(err.max())
    rel_err = float((err / want.abs().clamp_min(atol)).max())
    check(bool(torch.isfinite(got).all())
          and bool((err <= atol + rtol * want.abs()).all()),
          f"flash {kernel} disagrees with its plain version ({label}, "
          f"{name}): max abs err {abs_err}, rel {rel_err}, tolerance atol "
          f"{atol} rtol {rtol}")
    return abs_err, rel_err


def flash_check(dev, rng) -> dict:
    """Each flash kernel against its plain version on the same inputs: the
    main path's shape, dense and as the main path gives it (strided views
    of the fused qkv product, rows 16-byte aligned or not), GQA, a window,
    non-causal, fp32 inputs, head dim 8 (the small preset), ragged
    lengths, and the forward at seq 2048 (many k tiles, heaviest q tiles
    launched first). The backward passes take the plain forward's lse and
    D, so each kernel is held alone. Returns each kernel's worst max abs
    error."""
    import torch

    from kubeshare_tpu_torch.ops import flash_attention as fl

    b, s, h, d = FLASH_SHAPE
    bf16, f32 = torch.bfloat16, torch.float32
    # (label, (b, s, h, d), kv heads, dtype, causal, window, layout,
    #  backward too)
    cases = [("main path", FLASH_SHAPE, h, bf16, True, None, "dense", True),
             ("main path (strided)", FLASH_SHAPE, h, bf16, True, None,
              "fused", True),
             ("strided, rows not 16-byte aligned", FLASH_SHAPE, h, bf16,
              True, None, "unaligned", True),
             ("gqa hk=2", FLASH_SHAPE, 2, bf16, True, None, "dense", True),
             ("gqa hk=2 (strided)", FLASH_SHAPE, 2, bf16, True, None,
              "fused", True),
             ("window 100", FLASH_SHAPE, h, bf16, True, 100, "dense", True),
             ("non-causal", FLASH_SHAPE, h, bf16, False, None, "dense",
              True),
             ("fp32 inputs", FLASH_SHAPE, h, f32, True, None, "dense", True),
             ("head dim 8 (small preset, strided)", (2, 128, 4, 8), 2, bf16,
              True, None, "fused", True),
             ("head dim 8, ragged s=48, window 7", (2, 48, 4, 8), 1, bf16,
              True, 7, "dense", True),
             ("head dim 8, ragged s=80, non-causal", (1, 80, 2, 8), 2, bf16,
              False, None, "dense", True),
             ("ragged s=80", (2, 80, 8, 32), 8, bf16, True, None, "dense",
              True),
             ("ragged s=200, window 70", (1, 200, 4, 32), 4, bf16, True, 70,
              "dense", True),
             ("seq 2048", (1, 2048, 8, 32), 8, bf16, True, None, "dense",
              False)]
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for label, shape, hk, dtype, causal, window, layout, bwd in cases:
        b, s, h, d = shape
        scale = 1.0 / math.sqrt(d)
        q, k, v, dout = _flash_inputs(dev, rng, b, s, h, hk, d, dtype,
                                      layout)
        check((layout == "dense") == q.is_contiguous(),
              f"flash {label}: q is {'' if q.is_contiguous() else 'not '}"
              "contiguous")
        o, lse = fl.flash_fwd(q, k, v, causal, window, scale)
        ro, rlse = fl.flash_fwd_reference(q, k, v, causal, window, scale)
        pairs = [("fwd", "O", o, ro), ("fwd", "lse", lse, rlse)]
        if bwd:
            dcap = (dout * ro).sum(-1).transpose(1, 2)
            args = (q, k, v, dout, rlse, dcap, causal, window, scale)
            dk, dv = fl.flash_dkv(*args)
            rdk, rdv = fl.flash_dkv_reference(*args)
            pairs += [("dq", "dQ", fl.flash_dq(*args),
                       fl.flash_dq_reference(*args)),
                      ("dkv", "dK", dk, rdk), ("dkv", "dV", dv, rdv)]
        torch.cuda.synchronize()
        parts = []
        for kernel, name, got, want in pairs:
            abs_err, rel_err = _check_flash_close(kernel, label, name, got,
                                                  want)
            worst[kernel] = max(worst[kernel], abs_err)
            parts.append(f"{name} {abs_err:.2e}/{rel_err:.2e}")
        log(f"  flash {label} ({dtype}, {shape}, hk={hk}): ok, max abs/rel "
            "err " + ", ".join(parts))
    return worst


def flash_autograd_check(dev, rng) -> dict:
    """``flash_attention`` through autograd on bf16 q/k/v, strided views
    of one fused tensor at the main path's shape: the kernel forward's lse
    and O feed the two backward kernels. Held against the plain versions
    on the same inputs: O to the fp32 tolerance, dQ, dK and dV to the bf16
    one. Returns the max abs error of each."""
    import torch

    from kubeshare_tpu_torch.ops import flash_attention as fl

    b, s, h, d = FLASH_SHAPE
    scale = 1.0 / math.sqrt(d)
    fused = torch.from_numpy(rng.standard_normal((b, s, 3 * h * d)).astype(
        "float32")).to(dev, torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(
        "float32")).to(dev)
    views = lambda x: [x[..., i * h * d:(i + 1) * h * d].reshape(b, s, h, d)
                       for i in range(3)]
    f = fused.clone().requires_grad_(True)
    o = fl.flash_attention(*views(f))
    (o * w).sum().backward()
    q, k, v = views(fused)
    ro, rlse = fl.flash_fwd_reference(q, k, v, True, None, scale)
    dcap = (w * ro).sum(-1).transpose(1, 2)
    args = (q, k, v, w, rlse, dcap, True, None, scale)
    rdk, rdv = fl.flash_dkv_reference(*args)
    torch.cuda.synchronize()
    label = "bf16 autograd (strided)"
    errs = {}
    for name, got, want in (("O", o.detach(), ro),
                            *zip(("dQ", "dK", "dV"), views(f.grad),
                                 (fl.flash_dq_reference(*args), rdk, rdv))):
        errs[name] = _check_flash_close("autograd", label, name, got,
                                        want)[0]
    log(f"  flash {label} {FLASH_SHAPE}: ok, max abs err "
        + ", ".join(f"{n} {e:.2e}" for n, e in errs.items()))
    return errs


def _visible_pairs(s: int, causal: bool, window) -> int:
    """(q, k) pairs a causal (windowed) row set sees: the work this run's
    mask leaves, not the s*s the kernels could do."""
    if not causal:
        return s * s
    import numpy as np

    seen = np.arange(1, s + 1)
    return int(np.minimum(seen, window).sum() if window else seen.sum())


def flash_bounds(shape, in_bytes: int, causal=True, window=None) -> dict:
    """Least time of each pass: each input read once and each output
    written once over the memory rate, against the visible pairs'
    operations over the inputs' peak (bf16 tensor cores or fp32)."""
    b, s, h, d = shape
    pairs = b * h * _visible_pairs(s, causal, window)
    q = b * s * h * d * in_bytes
    kv = 2 * q                       # k and v, hk = h on the main path
    o32 = b * s * h * d * 4          # O, or dO, in fp32
    row = b * h * s * 4              # lse or D
    moved = {"fwd": q + kv + o32 + row,
             "dq": q + kv + o32 + 2 * row + q,
             "dkv": q + kv + o32 + 2 * row + kv}
    peak = PEAK_BF16_FLOPS if in_bytes == 2 else PEAK_FP32_FLOPS
    out = {}
    for name, nbytes in moved.items():
        byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        op_ms = FLASH_OPS_PER_PAIR_DIM[name] * d * pairs / peak * 1e3
        out[name] = {"bound_ms": max(byte_ms, op_ms),
                     "bound_by": "bytes" if byte_ms >= op_ms
                     else "operations",
                     "bytes": nbytes, "visible_pairs": pairs}
    return out


def flash_timing(dev, rng, shape, iters: int, plain: bool) -> dict:
    """The three kernels at ``shape`` (bf16, causal) beside their plain
    versions (when ``plain``) and ``scaled_dot_product_attention`` with
    ``is_causal=True``: its forward against ours, its backward (dQ, dK and
    dV in one call) against each of ours, and forward+backward."""
    import torch
    import torch.nn.functional as F

    from kubeshare_tpu_torch.ops import flash_attention as fl

    b, s, h, d = shape
    q, k, v, dout = _flash_inputs(dev, rng, b, s, h, h, d, torch.bfloat16)
    scale = 1.0 / math.sqrt(d)
    o, lse = fl.flash_fwd(q, k, v, True, None, scale)
    dcap = (dout * o).sum(-1).transpose(1, 2).contiguous()
    bwd = (q, k, v, dout, lse, dcap, True, None, scale)
    fns = {"fwd": (partial(fl.flash_fwd, q, k, v, True, None, scale),
                   partial(fl.flash_fwd_reference, q, k, v, True, None,
                           scale)),
           "dq": (partial(fl.flash_dq, *bwd),
                  partial(fl.flash_dq_reference, *bwd)),
           "dkv": (partial(fl.flash_dkv, *bwd),
                   partial(fl.flash_dkv_reference, *bwd))}
    # the library's own (b, h, s, d) layout, made once outside the timing
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    gt = dout.transpose(1, 2).contiguous().to(torch.bfloat16)
    sdpa = partial(F.scaled_dot_product_attention, qt, kt, vt,
                   is_causal=True)
    out = sdpa()

    def lib_fwd():
        with torch.no_grad():
            return sdpa()

    lib = {"fwd": lib_fwd,
           "bwd": lambda: torch.autograd.grad(out, (qt, kt, vt), gt,
                                              retain_graph=True),
           "fwd_bwd": lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), gt)}
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    res: dict = {}
    for name, (kernel, ref) in fns.items():
        runs = {"kernel": [], "plain": []}
        order = ("plain", "kernel", "kernel", "plain") if plain else \
            ("kernel", "kernel")
        for which in order:
            fn = kernel if which == "kernel" else ref
            runs[which].append(cuda_time_ms(fn, iters, flush))
        res[name] = {"ms": min(runs["kernel"]),
                     "plain_ms": min(runs["plain"]) if plain else None,
                     "host_ms": host_time_ms(kernel, 4 * iters),
                     "runs_ms": runs}
    lib_ms = {name: min(cuda_time_ms(fn, iters, flush) for _ in range(2))
              for name, fn in lib.items()}
    res["library_host_ms"] = {name: host_time_ms(fn, 4 * iters)
                              for name, fn in lib.items()}
    bounds = flash_bounds(shape, 2)
    for name in fns:
        res[name].update(bounds[name])
        res[name]["library_ms"] = lib_ms["fwd" if name == "fwd" else "bwd"]
    res["library_ms"] = lib_ms
    res["kernel_fwd_bwd_ms"] = sum(res[n]["ms"] for n in fns)
    return res


def transformer_step_check(dev) -> dict:
    """One small transformer train step with flash attention (fp32
    activations, head dim 32 as at full width) on the card (kernels)
    against the CPU (plain versions): loss to 1e-5 relative, grads to
    1e-4 (the flash gradient bar), params as in step_check."""
    import numpy as np
    import torch

    from kubeshare_tpu_torch.models import common, transformer
    from kubeshare_tpu_torch.ops.fused_adam import fused_adam
    from kubeshare_tpu_torch.utils.tree import tree_leaves

    lr = 1e-3
    params = transformer.init(7, seq_len=64, vocab=128, dim=256, layers=2)
    batch = common.synthetic_token_batch(8, 2, 64, 128)
    saved = transformer.DTYPE
    transformer.DTYPE = torch.float32
    try:
        out = {}
        for where in ("cpu", dev):
            p = common.to_device(params, where)
            b = common.to_device(batch, where)
            _, grads = common.value_and_grad(transformer.flash_loss_fn, p, b)
            opt = fused_adam(lr)
            step = common.make_train_step(transformer.flash_loss_fn, opt)
            p, _, loss = step(p, opt.init(p), b)
            out[str(where)] = (float(loss),
                               [t.cpu().numpy() for t in tree_leaves(p)],
                               [t.cpu().numpy() for t in tree_leaves(grads)])
    finally:
        transformer.DTYPE = saved
    (lc, pc, gc), (lg, pg, gg) = out["cpu"], out[str(dev)]
    check(abs(lc - lg) <= 1e-5 * max(1.0, abs(lc)),
          f"transformer step loss cuda {lg} vs cpu {lc}")
    grad_err = max(float(np.abs(a - b).max()) for a, b in zip(gc, gg))
    check(grad_err <= 1e-4, f"transformer grads cuda vs cpu off by "
          f"{grad_err}")
    worst = 0.0
    for a, b, g in zip(pc, pg, gc):
        d = np.abs(a - b)
        check(d.max() <= 2 * lr + 1e-6, f"param moved {d.max()} apart")
        firm = np.abs(g) > 1e-4
        if firm.any():
            check(d[firm].max() <= 1e-6,
                  f"param with |g|>1e-4 off by {d[firm].max()}")
            worst = max(worst, float(d[firm].max()))
    return {"loss_cpu": lc, "loss_cuda": lg, "grad_max_abs_err": grad_err,
            "param_max_abs_err_firm": worst}


def _timed_build(name: str) -> tuple[float, str]:
    from kubeshare_tpu_torch.ops import build

    t0 = time.perf_counter()
    text = build.build(name)
    return time.perf_counter() - t0, text


def _kernel_name(mangled: str) -> str:
    """``_ZN<ns><name>I<template args>E...`` -> ``<name>I<template args>E``
    (the kernels live in one anonymous namespace)."""
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    rest = mangled[m.end() + int(m.group(1)):]
    m = re.match(r"(\d+)", rest)
    if not m:
        return mangled
    name = rest[m.end():m.end() + int(m.group(1))]
    args = re.match(r"I\w*?EE", rest[m.end() + len(name):])
    return name + (args.group(0)[:-1] if args else "")


def sass_mma_counts(name: str) -> dict:
    """Tensor-core instructions (HMMA) in each kernel function of the
    built library ``name``, read from its SASS with the toolkit's
    cuobjdump."""
    from kubeshare_tpu_torch.ops import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run(
        [tool, "-sass", os.path.join(build.BUILD_DIR, f"lib{name}.so")],
        capture_output=True, text=True, check=True, timeout=120).stdout
    counts: dict = {}
    fn = None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = _kernel_name(line.split("Function :")[1].strip())
            counts[fn] = 0
        elif fn is not None and "HMMA" in line:
            counts[fn] += 1
    return counts


def _counts() -> dict:
    from kubeshare_tpu_torch.ops import flash_attention as fl
    from kubeshare_tpu_torch.ops import fused_adam as fa

    return {"fused_adam": fa.launches,
            **{f"flash_{k}": n for k, n in fl.launches.items()}}


def _reset_counts() -> None:
    from kubeshare_tpu_torch.ops import flash_attention as fl
    from kubeshare_tpu_torch.ops import fused_adam as fa

    fa.reset_launches()
    fl.reset_launches()


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
        from kubeshare_tpu_torch.models import mnist, transformer
        from kubeshare_tpu_torch.ops import flash_attention as fl
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

    # one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        jobs = {name: pool.submit(_timed_build, name) for name in KERNELS}
        builds = {name: job.result() for name, job in jobs.items()}
    out["build_s"] = {name: secs for name, (secs, _) in builds.items()}
    out["build_wall_s"] = time.perf_counter() - t0
    for name, (secs, text) in builds.items():
        log(f"build: {name} {secs:.1f} s")
        for line in text.strip().splitlines():
            log(f"  [{name}] {line}")
    log(f"build: all kernels {out['build_wall_s']:.1f} s wall")
    mma = sass_mma_counts("flash_attention")
    fwd_mma = {k: n for k, n in mma.items() if "flash_fwd_mma_kernel" in k}
    check(len(fwd_mma) == 2 * len(fl.HEAD_DIMS) and all(fwd_mma.values()),
          f"the bf16 flash forward has no tensor-core instructions: {mma}")
    out["sass_hmma"] = mma
    log("sass: HMMA instructions by kernel: " + ", ".join(
        f"{k} {n}" for k, n in sorted(mma.items())))

    rng = np.random.default_rng(0)
    log("kernel check (kernel vs plain, atol "
        f"{KERNEL_ATOL}, rtol {KERNEL_RTOL}):")
    max_err = adam_check(dev, rng)
    adam_by_tree = {}
    for model, mod in (("transformer", transformer), ("mnist", mnist)):
        r = adam_by_tree[model] = adam_timing(dev, rng, mod.init)
        log(f"fused_adam over the {model} tree ({r['params']} params, "
            f"{r['leaves']} leaves, {r['launches']} launch): kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"torch._fused_adam_ {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}); host ms a call: "
            f"kernel {r['host_ms']['kernel']:.4f}, torch._fused_adam_ "
            f"{r['host_ms']['library']:.4f}")
    adam = adam_by_tree["mnist"]
    out["fused_adam"] = dict(adam, max_abs_err=max_err,
                             transformer_tree=adam_by_tree["transformer"])

    tol = {str(k): v for k, v in fl.KERNEL_TOL.items()}
    log(f"flash kernel check (kernel vs plain, (atol, rtol) by output "
        f"dtype {tol}):")
    flash_err = flash_check(dev, rng)
    out["flash_autograd_max_abs_err"] = flash_autograd_check(dev, rng)
    flash = flash_timing(dev, rng, FLASH_SHAPE, 50, plain=True)
    for name in ("fwd", "dq", "dkv"):
        r = flash[name]
        lib = "fwd" if name == "fwd" else "bwd"
        log(f"flash {name} at {FLASH_SHAPE} bf16 causal: kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, sdpa "
            f"{'forward' if name == 'fwd' else 'backward'} "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}); host ms a call: kernel {r['host_ms']:.4f}, "
            f"sdpa {flash['library_host_ms'][lib]:.4f}")
    log(f"flash fwd+dq+dkv {flash['kernel_fwd_bwd_ms']:.4f} ms, sdpa "
        f"forward+backward {flash['library_ms']['fwd_bwd']:.4f} ms")
    out["flash"] = dict(flash, max_abs_err=flash_err)
    long = flash_timing(dev, rng, LONG_SHAPE, 5, plain=False)
    log(f"flash at {LONG_SHAPE} bf16 causal (off the main path, "
        f"informational): kernel fwd {long['fwd']['ms']:.3f} / dq "
        f"{long['dq']['ms']:.3f} / dkv {long['dkv']['ms']:.3f} ms, bound "
        f"{long['fwd']['bound_ms']:.4f} / {long['dq']['bound_ms']:.4f} / "
        f"{long['dkv']['bound_ms']:.4f} ms ({long['fwd']['bound_by']}); "
        f"sdpa forward {long['library_ms']['fwd']:.3f}, backward "
        f"{long['library_ms']['bwd']:.3f}, forward+backward "
        f"{long['library_ms']['fwd_bwd']:.3f} ms")
    out["flash_long_context"] = long

    out["step_check"] = step_check(dev)
    log(f"train step card vs cpu: {out['step_check']}")
    out["transformer_step_check"] = transformer_step_check(dev)
    log(f"transformer train step card vs cpu: "
        f"{out['transformer_step_check']}")

    # --- main paths: counts from 0 before each, read after each ---------
    phases: dict = {}
    # fused Adam launches one optimizer step makes over each model's tree
    adam_launches = {"mnist": fa.tree_launches(mnist.init(0)),
                     "transformer": fa.tree_launches(transformer.init(0))}
    for model, mod, loss_fn, steps, fused_s in (
            ("mnist", mnist, mnist.loss_fn, 300, 3.0),
            ("transformer", transformer, transformer.flash_loss_fn, 100,
             2.0)):
        _reset_counts()
        excl = exclusive(dev, mod.init, loss_fn, mod.batch_fn, steps,
                         fused_s)
        got = _counts()
        ran = excl["plain_steps"] + excl["warmup_steps"] + excl["fused_steps"]
        want = {"fused_adam": adam_launches[model] * ran}
        if model == "transformer":
            want.update({f"flash_{k}": transformer.LAYERS * ran
                         for k in ("fwd", "dq", "dkv")})
        for kernel, n in want.items():
            check(got[kernel] == n,
                  f"{model} exclusive: {got[kernel]} {kernel} launches, "
                  f"expected {n}")
        excl["launches"] = got
        log(f"{model} exclusive: {json.dumps(excl)}")

        spec = LM_SPEC if model == "transformer" else {
            "program": "train_step", "model": "mnist",
            "optimizer": LM_SPEC["optimizer"]}
        _reset_counts()
        col = colocated(dev, spec, mod.batch_fn, CHAIN_STEPS[model],
                        COLOCATED_MEASURE_S[model])
        got = _counts()
        measured = sum(c["steps"] for c in col["clients"].values())
        per_step = {"fused_adam": adam_launches[model],
                    **{k: transformer.LAYERS for k in want
                       if k.startswith("flash_")}}
        for kernel in want:
            check(got[kernel] >= per_step[kernel] * measured,
                  f"{model} co-located: {got[kernel]} {kernel} launches "
                  f"for {measured} measured steps")
        exclusive_sps = max(excl["plain_steps_per_sec"],
                            excl["fused_steps_per_sec"])
        col["ratio_to_exclusive"] = (col["aggregate_steps_per_sec"]
                                     / exclusive_sps)
        col["launches"] = got
        log(f"{model} co-located: {json.dumps(col)}")
        phases[model] = {"exclusive": excl, "colocated": col}

    launches = {k: sum(p[m]["launches"][k] for p in phases.values()
                       for m in ("exclusive", "colocated"))
                for k in _counts()}
    out.update(phases=phases, launches=launches,
               seconds=time.perf_counter() - t_start)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)

    kernels = [{
        "name": "fused_adam", "route": "cuda", "source": ADAM_SOURCE,
        "replaces": ADAM_REPLACES, "launches": launches["fused_adam"],
        "max_abs_err": max_err, "ms": adam["ms"],
        "plain_ms": adam["plain_ms"], "bound_ms": adam["bound_ms"],
        "bound_by": adam["bound_by"], "library_ms": adam["library_ms"]}]
    for name in ("fwd", "dq", "dkv"):
        r = flash[name]
        kernels.append({
            "name": f"flash_attention_{name}", "route": "cuda",
            "source": FLASH_SOURCE, "replaces": FLASH_REPLACES[name],
            "launches": launches[f"flash_{name}"],
            "max_abs_err": flash_err[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    log(f"seconds: {out['seconds']:.1f}")
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
