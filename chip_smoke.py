#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``kubeshare_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out results.json]

Runs from the root of a checkout and needs one CUDA card. Phases, each
failing the run (non-zero exit, no result line) when it fails:

1. the card's name and power limit (``nvidia-smi``), torch/CUDA versions;
2. the build of every hand-written kernel from ``kubeshare_tpu_torch/csrc``,
   one ``nvcc`` per source, all started together, and the tensor-core
   instructions (HMMA) of the bf16 flash kernels (forward, dQ, dK/dV)
   counted in their SASS;
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
   e. the gate pairs — the reference's isolation model: unmodified tenant
      *processes* share the card by time slices. A ``LauncherDaemon``
      spawns the per-device proxy (serving its token scheduler, window
      1 s) and one pod manager per entry of the device's client file; each
      tenant is this script's ``--tenant`` mode, attached only through the
      port's ``sitecustomize`` shim with a pod's env. It trains the
      full-width transformer with flash attention. In turn: one tenant
      alone ungated (``KUBESHARE_TPU_ATTACH=off``), alone gated at request
      1.0, two side by side at request 0.5, alone gated, two at requests
      0.25 and 0.75, alone gated, alone ungated. Each pair's first tenant
      must hold its requested share of the token over its life (and of
      the steps, in the even pair), the pair's steps must come in runs of
      one tenant, and the two tenants' charges must not sum past the
      time they were held in;
   f. the proxy-mode pair — the reference's default attach: a
      ``ChipProxy`` on the card in this process (token scheduler window
      1 s), and tenant processes (``--tenant --compiled``) attached only
      by the shim from a pod's env with the proxy's port. Each has no
      CUDA device of its own; it wraps the full-width LM train step in
      ``torch.compile``, which the attach exports and runs on the proxy,
      and reads the loss every step. One tenant alone at request 1.0,
      then two at 0.5 / 0.5, then two at 0.25 / 0.75. Every step must
      run on the proxy with exactly 4 launches of each flash pass and 1
      of fused Adam, the lone tenant's first losses must match the eager
      step in this process, and each pair's first tenant must be charged
      its requested share of the token over its life (and of the common
      window, in the even pair). The tenants ride the pipelined,
      resumable wire; each one's forwarding ms a step and its gaps
      between executions (median, 90th percentile) are printed;
   g. the proxy survives and streams — 5g-loop: ``compile_loop(fn,
      carry, *consts)`` over the full-width LM step in this process, run
      one call at a time, in bursts and in chains of bursts: every
      call's loss must equal the one-call run's at that step, bit for
      bit. 5g-crash and 5g-migrate: one proxy-mode tenant process
      trains on a proxy with a session journal; the proxy crashes and a
      new one starts from the journal on the same port, later the
      session moves live to a second proxy; the tenant is told of
      neither, and its losses must equal the undisturbed one-call run's
      bit for bit. Prints the looped rate and bursts, the journal's
      bytes, journaled and unjournaled steps/s, the seconds from the
      crash to the first step after resume, the requests replayed, and
      the migration's seconds and bytes;
   h. latency-class serving beside a best-effort trainer on one proxy,
      with and without preemption, each run's ledger, blame, SLO alerts
      and critpath read;
   i. a pod from a Kubernetes object to the card — the port's registry,
      collector (``--backend cuda``), configd, scheduler service (with
      its health watch), pod-event bridge and admission webhook as
      processes, and a fake kube-apiserver here. The service syncs its
      fleet from the registry (the card's node beside 63 fake 8-device
      nodes, 505 devices) and takes 2,000 seeded background pods for the
      fake nodes over HTTP; then two labels-only LM pods at 0.5 pass the
      webhook, are created on the apiserver, and the bridge has them
      bound to the card and writes back their annotations and Binding;
      configd writes the device's client file, 5e's launcher starts
      their pod managers on the annotated ports, and the tenants start
      with the env a kubelet builds from their pod objects and train
      side by side, gated. A third 0.5 pod and one asking more memory
      than the card has stay pending; deleting one pod on the apiserver
      stops its manager and the third binds without being resubmitted;
      a SIGKILL of the collector, the node's only lease, has the health
      watch declare the node dead and evict its pods, whose managers
      stop. Prints the round trips of ``POST /schedule`` and the
      engine's phases in the service (host numbers), the seconds from a
      pod's creation to its manager's READY, from a delete to the stop,
      from the kill to the node's death and from the death to the
      managers' stop, and the tenants' rates and share;
   j. the zoo — the JAX package's other workload models at full width
      (``ZOO``: cifar10, ResNet-18, the ResNet-50-class depth, VGG-16,
      the LSTM LM, the mixture-of-experts LM with flash attention): for
      each, one fp32 train step on the card against the CPU, the Adam
      kernel against its plain version over the whole tree (2 launches a
      step for ResNet-18, 3 for the ResNet-50 class), an exclusive run
      through ``run_training`` (steps/s, wall ms a step) and a profiled
      one through its ``profile_dir`` (device ms, idle share, kernels a
      step); then the resumable sweep: cifar10's CLI with
      ``--checkpoint --checkpoint-every`` as a gate-mode tenant of 5e's
      node path, run once uninterrupted, once SIGKILLed after its first
      promoted save and started again, which must restore the saved
      step, skip the warm-up, end at ``--steps`` with the uninterrupted
      run's Adam count and end on its final loss;
6. the outputs of the main paths: finite, of the expected shapes.

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --tenant out.json [--compiled] [--seconds S]
        [--steps N] [--seed N]

is the tenant of phases 5e, 5f, 5g and 5i (``--compiled``: its train step
wrapped in ``torch.compile``; ``--steps``: exactly N steps): it holds no
isolation code, trains, and writes its per-step end times, losses and
kernel launch counts to ``out.json``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import random
import shutil
import signal
import socket
import sys
import tempfile
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
# the bf16 flash kernels, which must run on the tensor cores
FLASH_MMA_KERNELS = ("flash_fwd_mma_kernel", "flash_dq_mma_kernel",
                     "flash_dkv_mma_kernel")
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
# the gate pair (phase 5e): a tenant's untimed first steps, and how long
# each run trains after them — alone (ungated, then gated) and as a pair
TENANT_WARMUP_STEPS = 5
GATE_SOLO_S = 10.0
GATE_PAIR_S = 20.0
# the common window of the pair must be at least this long to be read
GATE_MIN_WINDOW_S = 8.0
# the two pairs, (pod name, seed, request) each: even, and uneven, where
# only a gate that serialises the tenants by request gives the first one
# less than half (identical tenants split a card evenly with no gate)
GATE_PAIRS = {"even": (("smoke/tenant-a", 10, 0.5),
                       ("smoke/tenant-b", 20, 0.5)),
              "uneven": (("smoke/tenant-c", 30, 0.25),
                         ("smoke/tenant-d", 40, 0.75))}
# a pair's first tenant gets its requested share of the token within this
# fraction of it: [0.3, 0.7] for 0.5, [0.15, 0.35] for 0.25
GATE_SHARE_SLACK = 0.4
# one token's slice (a 300 ms quota) holds many steps of one tenant, so
# the pair's step ends come in runs of one tenant at least this long on
# average; two tenants running at once alternate, runs of about 1
GATE_MIN_MEAN_RUN = 3.0
# the gate's totals a tenant records after each step (ExecutionGate.stats)
GATE_TOTALS = ("charged_ms", "renews", "drain_ms", "waited_ms")
# the proxy-mode pairs (phase 5f): how long the lone tenant and each pair
# train after their warm-up steps, the pairs' (pod name, seed, request)
# each — even, and uneven, as in 5e — and the lone tenant's first losses
# held against the eager step
PROXY_SOLO_S = 10.0
PROXY_PAIR_S = 20.0
PROXY_PAIRS = {"even": (("smoke/proxy-a", 10, 0.5),
                        ("smoke/proxy-b", 20, 0.5)),
               "uneven": (("smoke/proxy-c", 30, 0.25),
                          ("smoke/proxy-d", 40, 0.75))}
PROXY_SOLO = ("smoke/proxy-solo", 0, 1.0)
PROXY_FIRST_LOSSES = 3
# phase 5g: the tenant that rides out a proxy crash and a live migration
# (pod name, seed), its steps in all, the steps it runs on the journaled
# proxy before the crash and on the restarted one before the move, and
# the looped steps of 5g-loop
RESUME_TENANT = ("smoke/resume", 0)
RESUME_STEPS = 72
CRASH_AT = 24
MIGRATE_AT = 24
LOOP_STEPS = 64
# phase 5h: latency-class serving beside a best-effort trainer. Four
# sender threads (two tenants of each class) submit one row each at a
# fixed aggregate rate, as the JAX serving bench's steady phase; each run
# lasts SERVE_RUN_S. The trainer chains SERVE_CHAIN steps a call (several
# bursts of up to window/4 each) from 5g's start, so every chain's loss is
# 5g-loop's one-call loss at that step.
SERVE_RATE = 200.0
SERVE_RUN_S = 4.0
SERVE_TENANTS = (("smoke/lat-0", "latency"), ("smoke/lat-1", "latency"),
                 ("smoke/be-0", "best-effort"), ("smoke/be-1", "best-effort"))
# the scheduler's clients, in namespaces of their own: the ledger and the
# blame graph name a client by its namespace ("serve", "train")
SERVE_SESSION = ("serve/smoke", 0.5)      # the ProxyServable's client
TRAIN_SESSION = ("train/smoke", 0.5)
SERVE_MAX_BATCH = 8
SERVE_MAX_WAIT_S = 0.004                  # the JAX serving bench's
SERVE_SEED = 7
SERVE_CHAIN = 64
# the JAX proxy's idle release: the serving session's token goes back
# between its batches (the port's 50 ms default is for a proxy-attached
# trainer's gaps between steps, phase 5f)
SERVE_IDLE_RELEASE_MS = 10.0
PREEMPT_GRACE_MS = 5.0
PREEMPT_MIN_HOLD_MS = 2.0
SERVE_ATOL = 1e-5
# 5h's observability: each serving tenant's SLOs, and the serving
# session's token grant wait (recorded by the scheduler under its
# namespace), on burn-rate windows cut to a run's 4 s, evaluated every
# SLO_EVERY_S; a session's ledger granted-active seconds must cover this
# share of its execution ms (the interval closes after the barrier)
SERVE_SLO = {"latency": "serve-p99<=20ms,serve-availability>=99",
             "best-effort": "serve-p99<=500ms,serve-availability>=99"}
GRANT_SLO = "grant-wait-p99<=20ms"
SLO_WINDOWS = {"fast_window_s": 2.0, "slow_window_s": 4.0,
               "burn_threshold": 2.0, "min_samples": 3}
SLO_EVERY_S = 0.25
LEDGER_COVERS_EXEC = 0.95
# acquire / execute / release cycles of a lone client timed with each of
# the scheduler's obs hooks on alone: the hooks' host cost a grant
HOOK_CYCLES = 2000
#: the obs hooks a 5h run can leave off (``serve_phase(off=...)``, used
#: by scripts/torch_serve_runs.py to time them apart; the smoke leaves
#: none off): the scheduler's TrackedCondition (a plain Condition in its
#: place), its ledger and blame graph, the tracer (the null tracer in its
#: place, whose spans still reach the process flight recorder), and the
#: SLO records (no evaluator on the front door or for the grant waits)
SERVE_HOOKS = ("cond", "ledger", "tracer", "slo")
# phase 5i: the placement path. The fleet beside the real node: fake
# 8-device nodes whose collectors would publish PLACE_FAKE_MODEL devices
# of 80 GiB (63 x 8 + the card = 505 devices), filled by a seeded stream
# of background pods pinned to that model; none of them is launched.
PLACE_FAKE_NODES = 63
PLACE_FAKE_DEVICES = 8
PLACE_FAKE_MODEL = "H100-fake-80GB"
PLACE_FAKE_MEMORY = 80 * 1024**3
PLACE_BACKGROUND_PODS = 2000
PLACE_SEED = 11
# the tenant pods, pinned to the card's model: two at 0.5 side by side
# (name, seed), then a third that fits only once one of them is deleted
PLACE_TENANTS = (("smoke/place-a", 10), ("smoke/place-b", 11))
PLACE_THIRD = "smoke/place-c"
PLACE_REQUEST = 0.5
PLACE_MEM = 20 * 1024**3
# each tenant trains this long past warm-up: their common window passes
# 5e's GATE_MIN_WINDOW_S (8 s) with the start-up offset between them
PLACE_PAIR_S = 10.0
# the control plane's replicas: two services in the leader:scheduler
# election, each on cell-routed shards, over one registry and its
# follower; the node's launcher and proxy push their metrics there
PLACE_SERVICES = ("svc-a", "svc-b")
PLACE_SHARDS = 4
PLACE_HA_TTL_S = 5.0
PLACE_REPL_POLL_S = 0.2
PLACE_PUSH_S = 1.0
# phase 5j: the zoo. The JAX package's workload models at full width,
# each through run_training: (label, model module, init keywords, loss)
ZOO = (("cifar10", "cifar10", {}, "loss_fn"),
       ("resnet18", "resnet", {}, "loss_fn"),
       ("resnet50", "resnet", {"blocks_per_stage": (3, 4, 6, 3)},
        "loss_fn"),
       ("vgg16", "vgg", {}, "loss_fn"),
       ("lstm", "lstm", {}, "loss_fn"),
       ("moe_lm", "transformer", {"n_experts": 4}, "flash_loss_fn"))
# timed steps of the exclusive run, and of the profiled one
ZOO_STEPS = 30
ZOO_PROFILE_STEPS = 5
# the card-vs-CPU step: the first rows of the model's batch, fp32
# activations; loss to 1e-5 relative, grads to ZOO_GRAD_RTOL times the
# model's own largest |g| on the CPU (the worst reading, ResNet-50's,
# is 4.0e-5 of it; the LSTM's largest |g| is 0.0155, cifar10's 5.3),
# every param to 2*lr and those with |g| above ZOO_FIRM_G (both devices
# agree on sign(g)) to ZOO_FIRM_ATOL
ZOO_CHECK_ROWS = 2
ZOO_GRAD_RTOL = 1e-4
ZOO_FIRM_G = 1e-3
ZOO_FIRM_ATOL = 1e-5
# calls a timing of Adam over the ResNet-50-class tree averages (its plain
# version takes ~43 ms a call)
ZOO_ADAM_ITERS = 20
# the resumable sweep (examples/families/opportunistic/resumable-sweep.yaml)
# as a gate-mode tenant: cifar10's CLI, SIGKILLed after its first promoted
# save and started again, against an uninterrupted run of the same seed
# (ungated, beside the killed run). Every earlier reading of the two ended
# equal bit for bit (final loss 3.662071e-05 in both, params 0.0 apart),
# so the bounds only leave room for a conv backward that sums in another
# order from run to run: the final loss to SWEEP_LOSS_RTOL of it, the
# params to SWEEP_PARAM_ATOL (a tenth of one Adam step's lr, so one step
# too many or too few fails) and both params' loss on a batch neither
# trained on to SWEEP_HELD_RTOL
SWEEP_POD = ("smoke/sweep", 1.0)
SWEEP_STEPS = 120
SWEEP_EVERY = 20
SWEEP_LOSS_RTOL = 1e-2
SWEEP_PARAM_ATOL = 1e-4
SWEEP_HELD_RTOL = 1e-3


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
        launched, err = adam_tree_check(dev, rng, model, leaves)
        check(launched == 1,
              f"fused_adam over the {model} tree: {launched} launches")
        worst = max(worst, err)
    return worst


def adam_tree_check(dev, rng, model: str, leaves) -> tuple[int, float]:
    """Kernel against plain version over a whole tree of ``leaves``' shapes
    (random p, g, m and v >= 0), leaf 0 an unaligned view: one optimizer
    step, which launches once per ``TABLE_LEAVES`` leaves. Returns the
    launches it made (checked against ``tree_launches``) and the max abs
    error."""
    import numpy as np
    import torch

    from kubeshare_tpu_torch.ops import fused_adam as fa

    step = torch.tensor(3.0, device=dev)
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
    check(launched == fa.tree_launches(leaves),
          f"fused_adam over the {model} tree: {launched} launches, "
          f"expected {fa.tree_launches(leaves)}")
    err = _check_adam_close(f"the {model} tree", [
        (k, r) for i in (0, 2, 3) for k, r in zip(kern[i], plain[i])])
    log(f"  fused_adam {model} tree ({len(leaves)} leaves, leaf 0 "
        f"+4B offset) in {launched} launch{'es' if launched > 1 else ''}: "
        f"ok, max abs err {err:.3e}")
    return launched, err


def adam_timing(dev, rng, init_fn, iters: int = 100) -> dict:
    """Kernel (one multi-tensor launch a TABLE_LEAVES leaves), plain
    version (leaf by leaf) and torch._fused_adam_ over the whole tree of
    ``init_fn`` (one optimizer step), each the mean of ``iters`` calls,
    plus the bound of that work."""
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
        runs[name].append(cuda_time_ms(fn, iters, flush))
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


def card_vs_cpu_step(dev, label: str, mod, params, batch, loss_fn,
                     grad_atol: float, firm_g: float,
                     firm_atol: float, grad_rtol: float = 0.0) -> dict:
    """One train step of ``loss_fn`` (``mod``'s activations in fp32) on
    the card (the kernels, cuDNN, cuBLAS) against the same step on the CPU
    (plain versions), from the same params and batch: the loss to 1e-5
    relative, grads to ``grad_atol`` plus ``grad_rtol`` times the largest
    |g| on the CPU. Adam's first step is ~ -lr*sign(g),
    so a parameter whose |g| is near eps may flip sign between the two
    devices' sums: every param is held to 2*lr, those with |g| above
    ``firm_g`` to ``firm_atol``."""
    import numpy as np
    import torch

    from kubeshare_tpu_torch.models import common
    from kubeshare_tpu_torch.ops.fused_adam import fused_adam
    from kubeshare_tpu_torch.utils.tree import tree_leaves

    lr = 1e-3
    saved = mod.DTYPE
    mod.DTYPE = torch.float32
    try:
        out = {}
        for where in ("cpu", dev):
            p = common.to_device(params, where)
            b = common.to_device(batch, where)
            loss, grads = common.value_and_grad(loss_fn, p, b)
            opt = fused_adam(lr)
            p, _ = opt.update(grads, opt.init(p), p)   # the step's body
            out[str(where)] = (float(loss),
                               [t.cpu().numpy() for t in tree_leaves(p)],
                               [t.cpu().numpy() for t in tree_leaves(grads)])
    finally:
        mod.DTYPE = saved
    (lc, pc, gc), (lg, pg, gg) = out["cpu"], out[str(dev)]
    check(abs(lc - lg) <= 1e-5 * max(1.0, abs(lc)),
          f"{label} train-step loss cuda {lg} vs cpu {lc}")
    worst = 0.0
    for a, b, g in zip(pc, pg, gc):
        d = np.abs(a - b)
        check(d.max() <= 2 * lr + 1e-6,
              f"{label}: param moved {d.max()} apart")
        firm = np.abs(g) > firm_g
        if firm.any():
            check(d[firm].max() <= firm_atol,
                  f"{label}: param with |g|>{firm_g} off by "
                  f"{d[firm].max()}")
            worst = max(worst, float(d[firm].max()))
    grad_err = max(float(np.abs(a - b).max()) for a, b in zip(gc, gg))
    grad_max = max(float(np.abs(g).max()) for g in gc)
    grad_bound = grad_atol + grad_rtol * grad_max
    check(grad_err <= grad_bound,
          f"{label}: grads cuda vs cpu off by {grad_err} > {grad_bound}")
    return {"loss_cpu": lc, "loss_cuda": lg, "grad_max_abs_err": grad_err,
            "grad_max_abs": grad_max, "grad_bound": grad_bound,
            "param_max_abs_err_firm": worst}


def step_check(dev) -> dict:
    """One mnist train step (batch 8, fp32 activations) on the card
    against the CPU: the kernel inside the real step; grads and the
    params with |g| > 1e-4 to 1e-5."""
    from kubeshare_tpu_torch.models import mnist

    x, y = mnist.batch_fn(8)
    return card_vs_cpu_step(dev, "mnist", mnist, mnist.init(7),
                            (x[:8], y[:8]), mnist.loss_fn, 1e-5, 1e-4, 1e-5)


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
    against the CPU (plain versions): grads to 1e-4 (the flash gradient
    bar), the params with |g| > 1e-4 to 1e-6."""
    from kubeshare_tpu_torch.models import common, transformer

    return card_vs_cpu_step(
        dev, "transformer", transformer,
        transformer.init(7, seq_len=64, vocab=128, dim=256, layers=2),
        common.synthetic_token_batch(8, 2, 64, 128),
        transformer.flash_loss_fn, 1e-4, 1e-4, 1e-6)


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


# --- phase 5e: the gate pair ---------------------------------------------------

def tenant(out_path: str, seconds: float, seed: int, compiled: bool,
           steps: int = 0) -> int:
    """The tenant process of the gate and proxy pairs: an unmodified
    training loop, metered only if the shim attached it. The full-width
    transformer with flash attention on ``cuda`` if this process has a
    card (under proxy attach it has none: on ``cpu``, its compiled step
    running on the proxy), the loss read every step; after
    TENANT_WARMUP_STEPS steps it trains ``seconds`` more (or, with
    ``steps``, exactly that many steps in all). After each step it also
    reads the gate's totals (``attach.gate_stats``), if gated.
    ``compiled`` wraps the step in ``torch.compile``."""
    import torch

    from kubeshare_tpu_torch import attach
    from kubeshare_tpu_torch.models import common, transformer
    from kubeshare_tpu_torch.ops.fused_adam import fused_adam

    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    params = common.to_device(transformer.init(seed), dev)
    batch = common.to_device(transformer.batch_fn(seed + 1), dev)
    opt = fused_adam(1e-3)
    state = opt.init(params)
    step = common.make_train_step(transformer.flash_loss_fn, opt)
    if compiled:
        step = torch.compile(step)
    _reset_counts()
    ends, losses, gate = [], [], []
    started = time.monotonic()
    stop_at = None
    first_proxy = None
    while (len(ends) < steps if steps
           else stop_at is None or ends[-1] < stop_at):
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))          # host read: the step is done
        ends.append(time.monotonic())
        if first_proxy is None:
            first_proxy = attach.proxy_usage()
        totals = attach.gate_stats()
        gate.append([totals[k] for k in GATE_TOTALS] if totals else None)
        if len(ends) == TENANT_WARMUP_STEPS:
            stop_at = ends[-1] + seconds
    with open(out_path, "w") as f:
        json.dump({"attach": attach.active_mode(), "ends": ends,
                   "started": started,
                   "losses": losses, "gate": gate, "launches": _counts(),
                   "device": (torch.cuda.get_device_name(0)
                              if dev.type == "cuda" else "cpu"),
                   "cuda_initialized": torch.cuda.is_initialized(),
                   "proxy": attach.proxy_usage(),
                   "first_proxy": first_proxy,
                   "visible": os.environ.get("CUDA_VISIBLE_DEVICES", "")}, f)
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_ready(log_path: str, what: str, timeout: float = 120.0) -> str:
    """The first ``READY`` line a spawned process wrote to its log."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(log_path):
            with open(log_path) as f:
                for line in f:
                    if line.startswith("READY"):
                        return line.strip()
        time.sleep(0.1)
    fail(f"{what} never printed READY: {_tail(log_path)}")


def _tail(path: str, n: int = 3000) -> str:
    try:
        with open(path) as f:
            return f.read()[-n:]
    except OSError:
        return "(no log)"


class _Node:
    """One device's node path, as a node runs it: the launcher, its proxy
    and pod managers, and the tenant processes, every process logging to
    a file of its own under a temporary scheduler dir."""

    def __init__(self, root: str):
        from kubeshare_tpu_torch.nodeagent import launcherd
        from kubeshare_tpu_torch.topology.discovery import discover_chips

        self.root = root
        self.chip = discover_chips("cuda")[0]
        self.base = tempfile.mkdtemp(prefix="kubeshare-gate-")
        self.token_port = _free_port()
        self.managers: dict = {}          # pod name -> manager command
        #: more arguments of the proxy's command (5i's remote write)
        self.proxy_args: list = []
        node = self

        def proxy_cmd(chip_id, index, _exec_port, _token_port):
            cmd, env = launcherd.default_proxy_cmd(
                chip_id, index, _free_port(), node.token_port)
            env["PYTHONPATH"] = root
            # the shortened accounting window of the co-located phases
            return cmd + ["-w", str(WINDOW_MS), *node.proxy_args], env

        def pmgr_cmd(name, port, request, limit, _token_port):
            cmd, env = launcherd.default_pmgr_cmd(name, port, request, limit,
                                                  node.token_port)
            env["PYTHONPATH"] = root
            node.managers[name] = os.path.basename(cmd[-1])
            return cmd, env

        class Launcher(launcherd.LauncherDaemon):
            def _spawn(self, cmd, env):
                label = env.get("KUBESHARE_TPU_POD_NAME", "") or "proxy"
                with open(node.log(label), "a") as out:
                    return subprocess.Popen(cmd, env=env, cwd=root,
                                            stdout=out,
                                            stderr=subprocess.STDOUT,
                                            start_new_session=True)

        self.launcher = Launcher([self.chip.chip_id], base_dir=self.base,
                                 poll_s=0.1, proxy_cmd=proxy_cmd,
                                 pmgr_cmd=pmgr_cmd)

    def log(self, label: str) -> str:
        return os.path.join(self.base, label.replace("/", "_") + ".log")

    def start(self) -> str:
        self.launcher.start()
        return _wait_ready(self.log("proxy"), "the proxy")

    def clients(self, entries) -> dict:
        """Write the device's client file (``(name, request)`` each, limit
        1.0) and wait until each entry's manager serves; returns the
        managers' ports."""
        from kubeshare_tpu_torch.nodeagent.files import (ClientEntry,
                                                         write_chip_clients)

        ports = {name: _free_port() for name, _ in entries}
        for name, _ in entries:           # a manager of an earlier file
            if os.path.exists(self.log(name)):
                os.remove(self.log(name))
        write_chip_clients(self.chip.chip_id, [
            ClientEntry(name, request, 1.0, 0, ports[name])
            for name, request in entries], self.base)
        for name, _ in entries:
            _wait_ready(self.log(name), f"the pod manager of {name}")
        return ports

    def tenant_env(self, name: str, port: int, request: float, gated: bool,
                   pod_env: dict | None = None) -> dict:
        """A tenant process's env: this one's without any pod variable, the
        port's shim first on the path, and a pod's env (``pod_env``, a
        binding's, when given; else one for the manager on ``port``)."""
        from kubeshare_tpu_torch import constants as C

        shim = os.path.join(self.root, "kubeshare_tpu_torch", "_shim")
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("KUBESHARE_TPU_")
               and k != C.ENV_VISIBLE_CHIPS}
        env["PYTHONPATH"] = os.pathsep.join([shim, self.root])
        if pod_env is not None:
            env.update(pod_env)
        else:
            env.update({C.ENV_POD_MANAGER_PORT: str(port),
                        C.ENV_POD_NAME: name,
                        C.ENV_TPU_REQUEST: str(request),
                        C.ENV_TPU_LIMIT: "1.0",
                        C.ENV_VISIBLE_CHIPS: self.chip.chip_id})
        if not gated:
            env[C.ENV_ATTACH_MODE] = "off"
        return env

    def run(self, tenants, seconds: float, gated: bool,
            pod_envs: dict | None = None) -> dict:
        """Run the tenants ``(name, seed, manager port, request)`` side by
        side, each a process with only a pod's env (``pod_envs[name]``, a
        binding's env, when given; else one built here); while they run,
        sample each gated one's charged ms from the token scheduler's
        ``usage`` op. Returns each tenant's record and its samples."""
        from kubeshare_tpu_torch.isolation import protocol

        procs, outs, usage = {}, {}, {}
        try:
            for name, seed, port, request in tenants:
                env = self.tenant_env(
                    name, port, request, gated,
                    pod_envs[name] if pod_envs is not None else None)
                outs[name] = os.path.join(
                    self.base, name.replace("/", "_") + ".json")
                with open(self.log(name + "-tenant"), "w") as log_file:
                    procs[name] = subprocess.Popen(
                        [sys.executable, os.path.abspath(__file__),
                         "--tenant", outs[name], "--seconds", str(seconds),
                         "--seed", str(seed)],
                        env=env, cwd=self.root, stdout=log_file,
                        stderr=subprocess.STDOUT)
            conns = {}
            if gated:
                for name, *_ in tenants:
                    conns[name] = protocol.Connection("127.0.0.1",
                                                      self.token_port)
                    conns[name].call({"op": "attach", "name": name})
                    usage[name] = []
            deadline = time.monotonic() + seconds + 300
            while (any(p.poll() is None for p in procs.values())
                   and time.monotonic() < deadline):
                for name, conn in conns.items():
                    reply, _ = conn.call({"op": "usage"})
                    usage[name].append((time.monotonic(), reply["used_ms"]))
                time.sleep(0.25)
            for conn in conns.values():
                conn.close()
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                p.wait()
        records = {}
        for name, p in procs.items():
            check(p.returncode == 0,
                  f"tenant {name} exited {p.returncode}: "
                  f"{_tail(self.log(name + '-tenant'))}")
            with open(outs[name]) as f:
                records[name] = json.load(f)
            records[name]["usage"] = usage.get(name, [])
        return records

    def stop(self) -> None:
        self.launcher.stop()
        shutil.rmtree(self.base, ignore_errors=True)


def _check_losses(name: str, losses: list) -> None:
    check(all(math.isfinite(x) for x in losses),
          f"tenant {name}: loss not finite")
    check(losses[-1] < losses[0],
          f"tenant {name}: loss did not fall: {losses[0]} -> {losses[-1]}")


def _launches_per_step(adam_per_step: int, layers: int) -> dict:
    return {"fused_adam": adam_per_step,
            **{f"flash_{k}": layers for k in ("fwd", "dq", "dkv")}}


def _check_tenant(name: str, rec: dict, gated: bool, adam_per_step: int,
                  layers: int) -> int:
    """A tenant's own record: attached as asked, finite falling loss,
    every step through the four kernels. Returns its step count."""
    steps = len(rec["ends"])
    check(rec["attach"] == ("gate" if gated else ""),
          f"tenant {name}: attach mode {rec['attach']!r}")
    _check_losses(name, rec["losses"])
    want = {k: n * steps for k, n in
            _launches_per_step(adam_per_step, layers).items()}
    check(rec["launches"] == want,
          f"tenant {name}: launches {rec['launches']}, expected {want}")
    return steps


def _charged_ms(rec: dict, start: float, end: float) -> float:
    """The scheduler's own charge of a tenant: each ``usage`` sample is
    its used ms in the last window (WINDOW_MS); their mean over the
    samples taken a full window after ``start`` and before ``end``."""
    import numpy as np

    samples = [u for t, u in rec["usage"]
               if start + WINDOW_MS / 1000.0 <= t <= end]
    return float(np.mean(samples)) if samples else float("nan")


def _solo_rate(rec: dict) -> float:
    ends = rec["ends"][TENANT_WARMUP_STEPS - 1:]
    return (len(ends) - 1) / (ends[-1] - ends[0])


def _gate_per_step(rec: dict, i0: int, i1: int) -> dict:
    """The gate's totals per step from step ``i0``'s end to step ``i1``'s
    (the ms charged is the held time: wall time between gate calls)."""
    return {k: (rec["gate"][i1][j] - rec["gate"][i0][j]) / (i1 - i0)
            for j, k in enumerate(GATE_TOTALS)}


def _solo_gate_per_step(rec: dict) -> dict:
    return _gate_per_step(rec, TENANT_WARMUP_STEPS - 1, len(rec["ends"]) - 1)


def _mean_run(pair: dict, start: float, end: float) -> float:
    """The mean number of consecutive steps of one tenant among the pair's
    step ends in (start, end]."""
    ends = sorted((t, n) for n, r in pair.items() for t in r["ends"]
                  if start < t <= end)
    runs = 1 + sum(1 for (_, x), (_, y) in zip(ends, ends[1:]) if x != y)
    return len(ends) / runs


def pair_reading(pair: dict, entries) -> dict:
    """One pair's numbers over its common window: both past warm-up,
    until the first one stops (checked by :func:`check_pair`)."""
    start = max(r["ends"][TENANT_WARMUP_STEPS - 1] for r in pair.values())
    end = min(r["ends"][-1] for r in pair.values())
    window_s = end - start
    check(window_s >= GATE_MIN_WINDOW_S,
          f"the gate pair overlapped only {window_s:.2f} s")
    steps = {n: sum(1 for t in r["ends"] if start < t <= end)
             for n, r in pair.items()}
    rates = {n: k / window_s for n, k in steps.items()}
    (a, _, req_a), (b, _, req_b) = entries
    # both tenants run the same step, so the device time each got in the
    # window is in proportion to its steps
    share_a = steps[a] / (steps[a] + steps[b])
    wanted = req_a / (req_a + req_b)
    charged = {n: _charged_ms(r, start, end) for n, r in pair.items()}
    # each tenant's gate totals from its last step end at or before
    # ``start`` to its last at or before ``end``
    span = {n: (sum(1 for t in r["ends"] if t <= start) - 1,
                sum(1 for t in r["ends"] if t <= end) - 1)
            for n, r in pair.items()}
    per_step = {n: _gate_per_step(pair[n], i0, i1)
                for n, (i0, i1) in span.items()}
    held = {n: per_step[n]["charged_ms"] * (i1 - i0)
            for n, (i0, i1) in span.items()}
    union_ms = 1000.0 * (
        max(pair[n]["ends"][i1] for n, (_, i1) in span.items())
        - min(pair[n]["ends"][i0] for n, (i0, _) in span.items()))
    # the token each tenant held over its life up to the window's end:
    # the stride scheduler evens the ms held over request out from
    # registration on, start-up included (a tenant's first step holds the
    # token through its CUDA start-up, seconds, which the lower request
    # then pays back by waiting inside the common window)
    life = {n: pair[n]["gate"][i1][GATE_TOTALS.index("charged_ms")]
            for n, (_, i1) in span.items()}
    return {
        "requests": {a: req_a, b: req_b},
        "window_s": window_s,
        "steps_in_window": steps,
        "steps_per_sec": rates,
        "aggregate_steps_per_sec": sum(rates.values()),
        "share_a": share_a,
        "share_wanted": wanted,
        "share_error_pct": abs(share_a - wanted) / wanted * 100.0,
        "charged_ms_per_window": charged,
        "charged_share_a": charged[a] / (charged[a] + charged[b]),
        "mean_run_steps": _mean_run(pair, start, end),
        "gate_per_step": per_step,
        "gate_held_share_a": held[a] / (held[a] + held[b]),
        "lifetime_held_share_a": life[a] / (life[a] + life[b]),
        "first_step_held_ms": {n: r["gate"][0][GATE_TOTALS.index(
            "charged_ms")] for n, r in pair.items()},
        "gate_held_over_span": sum(held.values()) / union_ms,
    }


def check_pair(kind: str, reading: dict) -> None:
    """What one token allows: the first tenant's share of the token held
    over its life, and in an even pair also its share of the common
    window's steps, within GATE_SHARE_SLACK of its requested share; the
    step ends in runs of one tenant (GATE_MIN_MEAN_RUN); the tenants'
    held time, by their gates and by the scheduler's ``usage`` op, no
    more than the time it was held in."""
    a = next(iter(reading["requests"]))
    wanted = reading["share_wanted"]
    share = reading["lifetime_held_share_a"]
    check(abs(share - wanted) <= GATE_SHARE_SLACK * wanted,
          f"gate pair {kind}: {a} held {share} of the token, not within "
          f"{GATE_SHARE_SLACK:.0%} of its request's {wanted}")
    if wanted == 0.5:
        # identical start-ups cancel: the window's steps split as the
        # token does (an uneven pair's lower request is still paying its
        # start-up back in the window, see pair_reading)
        share = reading["share_a"]
        check(abs(share - wanted) <= GATE_SHARE_SLACK * wanted,
              f"gate pair {kind}: device-time share of {a} {share} not "
              f"within {GATE_SHARE_SLACK:.0%} of its request's {wanted}")
    charged = reading["charged_ms_per_window"]
    check(math.isfinite(reading["charged_share_a"]),
          f"gate pair {kind}: no charge sampled in the common window")
    check(sum(charged.values()) <= WINDOW_MS,
          f"gate pair {kind}: charged {charged} ms per {WINDOW_MS} ms "
          f"window: the tenants held the token at once")
    check(reading["mean_run_steps"] >= GATE_MIN_MEAN_RUN,
          f"gate pair {kind}: the tenants' steps alternate (mean run "
          f"{reading['mean_run_steps']:.2f} steps): they ran at once")
    check(reading["gate_held_over_span"] <= 1.0,
          f"gate pair {kind}: the gates held "
          f"{reading['gate_held_over_span']:.4f} of the time: the tenants "
          f"held the token at once")


def gate_phase(root: str, adam_per_step: int, layers: int) -> dict:
    """Phase 5e (see the module docstring): returns the solo rates, each
    pair's reading and the records' launch counts."""
    import numpy as np
    import torch

    torch.cuda.empty_cache()
    node = _Node(root)
    records, pairs = {}, {}
    # the gated runs in order, (pair kind, None) or ("gated", steps/s), to
    # set each pair beside the gated exclusive runs around it
    gated_order = []
    try:
        ready = node.start()
        log(f"gate: proxy {ready}; device {node.chip.chip_id}")
        solo = {"ungated": [], "gated": []}

        def run_solo(label: str) -> None:
            gated = label == "gated"
            ports = ({} if not gated
                     else node.clients([("smoke/solo", 1.0)]))
            rec = node.run([("smoke/solo", 0, ports.get("smoke/solo", 0),
                             1.0)], GATE_SOLO_S, gated)["smoke/solo"]
            _check_tenant(f"solo ({label})", rec, gated, adam_per_step,
                          layers)
            solo[label].append(_solo_rate(rec))
            records[f"solo-{label}-{len(solo[label])}"] = rec
            if gated:
                gated_order.append((label, solo[label][-1]))

        def run_pair(kind: str) -> None:
            entries = GATE_PAIRS[kind]
            ports = node.clients([(n, req) for n, _, req in entries])
            pair = node.run([(n, seed, ports[n], req)
                             for n, seed, req in entries], GATE_PAIR_S, True)
            for name, rec in pair.items():
                _check_tenant(name, rec, True, adam_per_step, layers)
                records[name] = rec
            pairs[kind] = pair_reading(pair, entries)
            log(f"gate pair {kind}: {json.dumps(pairs[kind])}")
            check_pair(kind, pairs[kind])
            gated_order.append((kind, None))

        # the pairs between gated exclusive runs, the whole bracketed by
        # ungated ones: the host's drift shows in each pair of them
        for step in ("ungated", "gated", "even", "gated", "uneven", "gated",
                     "ungated"):
            (run_solo if step in solo else run_pair)(step)
        managers = dict(node.managers)
    finally:
        node.stop()
    ungated = float(np.mean(solo["ungated"]))
    for i, (kind, _) in enumerate(gated_order):
        if kind in pairs:
            # the gated exclusive runs just before and after the pair
            beside = (gated_order[i - 1][1] + gated_order[i + 1][1]) / 2
            reading = pairs[kind]
            reading["aggregate_over_ungated"] = (
                reading["aggregate_steps_per_sec"] / ungated)
            reading["aggregate_over_gated_beside"] = (
                reading["aggregate_steps_per_sec"] / beside)
    solo_gated = [r for n, r in records.items() if n.startswith("solo-gated")]
    return {
        "managers": managers,
        "solo_steps_per_sec": solo,
        "gated_over_ungated": float(np.mean(solo["gated"])) / ungated,
        # the gated exclusive runs' own charge per window, and their
        # gates' totals per step
        "solo_charged_ms_per_window": [
            _charged_ms(r, r["ends"][TENANT_WARMUP_STEPS - 1], r["ends"][-1])
            for r in solo_gated],
        "solo_gate_per_step": [_solo_gate_per_step(r) for r in solo_gated],
        "pairs": pairs,
        "window_ms": WINDOW_MS,
        "visible_devices": {n: r["visible"] for n, r in records.items()},
        "launches": {k: sum(r["launches"][k] for r in records.values())
                     for k in _counts()},
        "steps": {n: len(r["ends"]) for n, r in records.items()},
    }


def log_pair(kind: str, reading: dict) -> None:
    (a, req_a), (b, req_b) = reading["requests"].items()
    log(f"gate pair {kind} ({a} {req_a}, {b} {req_b}): steps/s over the "
        f"common window ({reading['window_s']:.2f} s): " + ", ".join(
            f"{n} {r:.3f}" for n, r in reading["steps_per_sec"].items()))
    log(f"gate pair {kind}: aggregate / ungated exclusive ratio "
        f"{reading['aggregate_over_ungated']:.4f} (/ the gated exclusive "
        f"runs beside it {reading['aggregate_over_gated_beside']:.4f})")
    log(f"gate pair {kind}: device-time share of {a} "
        f"{reading['share_a']:.4f} (wanted {reading['share_wanted']:.2f}, "
        f"steps {reading['steps_in_window']}); charged ms per "
        f"{WINDOW_MS:.0f} ms window by the scheduler's usage op "
        + ", ".join(f"{n} {c:.1f}" for n, c in
                    reading["charged_ms_per_window"].items())
        + f" (share {reading['charged_share_a']:.4f})")
    log(f"gate pair {kind}: share error {reading['share_error_pct']:.2f}%; "
        f"mean run {reading['mean_run_steps']:.2f} steps; the gates held "
        f"{reading['gate_held_over_span']:.4f} of the time, "
        f"{reading['gate_held_share_a']:.4f} of it for {a}; {a} held "
        f"{reading['lifetime_held_share_a']:.4f} of the token over its life; "
        f"first step held ms " + ", ".join(
            f"{n} {v:.1f}" for n, v in reading["first_step_held_ms"].items())
        + "; per step " + "; ".join(f"{n} {_fmt_gate(g)}" for n, g in
                    reading["gate_per_step"].items()))


def _fmt_gate(per_step: dict) -> str:
    return ", ".join(f"{k} {v:.3f}" for k, v in per_step.items())


# --- phase 5f: the proxy-mode pair ---------------------------------------------

def _run_proxy_tenants(root: str, proxy, tenants, seconds: float,
                       base: str) -> dict:
    """Run the tenants ``(name, seed, request)`` side by side, each a
    process attached by the shim from a pod's env with the port of
    ``proxy`` (in this process); while they run, sample each one's
    charged ms in the last window from the token scheduler (``usage``)
    and the ms it has been charged since it registered: its session's
    execution ms, the ``used_ms`` the proxy hands the scheduler
    (``held``). Returns each tenant's record and its samples."""
    from kubeshare_tpu_torch import constants as C

    shim = os.path.join(root, "kubeshare_tpu_torch", "_shim")
    procs, outs, logs, usage, held = {}, {}, {}, {}, {}
    try:
        for name, seed, request in tenants:
            env = {k: v for k, v in os.environ.items()
                   if not k.startswith("KUBESHARE_TPU_")
                   and k not in (C.ENV_VISIBLE_CHIPS, "CUDA_VISIBLE_DEVICES")}
            env.update({"PYTHONPATH": os.pathsep.join([shim, root]),
                        C.ENV_CHIP_PROXY_PORT: str(proxy.port),
                        C.ENV_POD_NAME: name,
                        C.ENV_TPU_REQUEST: str(request),
                        C.ENV_TPU_LIMIT: "1.0"})
            stem = os.path.join(base, name.replace("/", "_"))
            outs[name], logs[name] = stem + ".json", stem + ".log"
            usage[name], held[name] = [], []
            with open(logs[name], "w") as log_file:
                procs[name] = subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--tenant",
                     outs[name], "--compiled", "--seconds", str(seconds),
                     "--seed", str(seed)],
                    env=env, cwd=root, stdout=log_file,
                    stderr=subprocess.STDOUT)
        deadline = time.monotonic() + seconds + 300
        while (any(p.poll() is None for p in procs.values())
               and time.monotonic() < deadline):
            for name in procs:
                now = time.monotonic()
                try:
                    usage[name].append(
                        (now, proxy.scheduler.window_usage(name)))
                    held[name].append(
                        (now, proxy._sessions[name].exec_ms_total))
                except KeyError:
                    pass              # not registered yet, or gone
            time.sleep(0.25)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
    records = {}
    for name, p in procs.items():
        check(p.returncode == 0,
              f"proxy tenant {name} exited {p.returncode}: "
              f"{_tail(logs[name])}")
        with open(outs[name]) as f:
            records[name] = json.load(f)
        records[name]["usage"] = usage[name]
        records[name]["held"] = held[name]
    return records


def _check_proxy_tenant(name: str, rec: dict) -> int:
    """A proxy tenant's own record: attached in proxy mode with no CUDA
    of its own, every step run on the proxy, finite falling loss."""
    steps = len(rec["ends"])
    check(rec["attach"] == "proxy",
          f"proxy tenant {name}: attach mode {rec['attach']!r}")
    check(rec["visible"] == "" and not rec["cuda_initialized"]
          and rec["device"] == "cpu",
          f"proxy tenant {name} had a CUDA device: visible "
          f"{rec['visible']!r}, initialized {rec['cuda_initialized']}")
    check(rec["proxy"]["exec_count"] >= steps,
          f"proxy tenant {name}: {rec['proxy']['exec_count']} executions "
          f"on the proxy for {steps} steps")
    _check_losses(name, rec["losses"])
    return steps


def proxy_pair_reading(pair: dict, entries, lone_rate: float) -> dict:
    """One proxy pair's numbers over its common window (both past
    warm-up, until the first one stops), and the ms each was charged over
    its life up to the window's end (checked by
    :func:`check_proxy_pair`)."""
    (a, _, req_a), (b, _, req_b) = entries
    start = max(r["ends"][TENANT_WARMUP_STEPS - 1] for r in pair.values())
    end = min(r["ends"][-1] for r in pair.values())
    window_s = end - start
    check(window_s >= GATE_MIN_WINDOW_S,
          f"the proxy pair overlapped only {window_s:.2f} s")
    in_window = {n: sum(1 for t in r["ends"] if start < t <= end)
                 for n, r in pair.items()}
    rates = {n: k / window_s for n, k in in_window.items()}
    charged = {n: _charged_ms(r, start, end) for n, r in pair.items()}
    # the stride scheduler evens the ms charged over request out from
    # registration on, so a tenant that ran alone first is paid back by
    # the other inside the window: over their lives the token splits by
    # request (as 5e's gate pairs)
    life = {n: max((h for t, h in r["held"] if t <= end), default=0.0)
            for n, r in pair.items()}
    wanted = req_a / (req_a + req_b)
    share_a = in_window[a] / (in_window[a] + in_window[b])
    return {"requests": {a: req_a, b: req_b}, "window_s": window_s,
            "steps_in_window": in_window, "steps_per_sec": rates,
            "aggregate_steps_per_sec": sum(rates.values()),
            "aggregate_over_lone": sum(rates.values()) / lone_rate,
            "share_a": share_a, "share_wanted": wanted,
            "share_error_pct": abs(share_a - wanted) / wanted * 100.0,
            "charged_ms_per_window": charged,
            "charged_share_a": charged[a] / (charged[a] + charged[b]),
            "lifetime_charged_ms": life,
            "lifetime_charged_share_a": life[a] / (life[a] + life[b])}


def check_proxy_pair(kind: str, reading: dict) -> None:
    """The first tenant's share of the token charged over its life, and
    in an even pair also of the window's charge, within GATE_SHARE_SLACK
    of its requested share."""
    a = next(iter(reading["requests"]))
    wanted = reading["share_wanted"]
    shares = {"over its life": reading["lifetime_charged_share_a"]}
    if wanted == 0.5:
        shares["in the common window"] = reading["charged_share_a"]
    for where, share in shares.items():
        check(abs(share - wanted) <= GATE_SHARE_SLACK * wanted,
              f"proxy pair {kind}: {a} was charged {share} of the token "
              f"{where}, not within {GATE_SHARE_SLACK:.0%} of its "
              f"request's {wanted}")


def _gap_proxy(dev, sched, **kw):
    """A ``ChipProxy`` that notes each session's gaps between executions:
    from one's end to the next one's arrival at the token gate — the
    tenant's own time between steps (forwarding and its Python), which
    the idle release must outlast."""
    from kubeshare_tpu_torch.isolation import proxy as proxy_mod

    class GapProxy(proxy_mod.ChipProxy):
        def _gated(self, sess, fn, timing):
            if sess.last_end_ms > 0.0:
                self.gaps_ms.setdefault(sess.name, []).append(
                    proxy_mod._now_ms() - sess.last_end_ms)
            return super()._gated(sess, fn, timing)

    proxy = GapProxy(device=dev, scheduler=sched, **kw)
    proxy.gaps_ms = {}
    return proxy


def _gaps(gaps: list) -> dict:
    import numpy as np

    if not gaps:
        return {"gaps": 0}
    return {"gaps": len(gaps), "gap_p50_ms": float(np.median(gaps)),
            "gap_p90_ms": float(np.percentile(gaps, 90))}


def proxy_phase(root: str, dev, adam_per_step: int, layers: int) -> dict:
    """Phase 5f (see the module docstring): the lone tenant's rate, each
    pair's reading, the first losses against the eager step, the launch
    counts of the whole phase and the compile's record."""
    import torch

    from kubeshare_tpu_torch.constants import BASE_QUOTA_MS, MIN_QUOTA_MS
    from kubeshare_tpu_torch.isolation.tokensched import TokenScheduler
    from kubeshare_tpu_torch.models import common, transformer
    from kubeshare_tpu_torch.ops.fused_adam import fused_adam

    from kubeshare_tpu_torch.isolation import exported
    from kubeshare_tpu_torch.utils.tree import tree_leaves

    # the eager step in this process, from the lone tenant's seed
    seed = PROXY_SOLO[1]
    params = common.to_device(transformer.init(seed), dev)
    batch = common.to_device(transformer.batch_fn(seed + 1), dev)
    opt = fused_adam(1e-3)
    state = opt.init(params)
    step = common.make_train_step(transformer.flash_loss_fn, opt)
    eager = [float(step(params, state, batch)[2])
             for _ in range(PROXY_FIRST_LOSSES)]
    # the exported step itself against the eager one, in this process:
    # per-step wall ms (host read of the loss each step), in turns
    program = exported.load_program(exported.export_program(
        step, (params, state, batch), dev)[0], dev)
    leaves = tree_leaves((params, state, batch))
    runs = {"eager": lambda: float(step(params, state, batch)[2]),
            "exported": lambda: float(program(*leaves)[-1])}
    step_ms = {k: [] for k in runs}
    for _ in range(2):
        for name, fn in runs.items():
            fn()
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            step_ms[name].append((time.perf_counter() - t0) * 50.0)
    del params, state, batch, leaves, program
    torch.cuda.empty_cache()

    sched = TokenScheduler(WINDOW_MS, BASE_QUOTA_MS, MIN_QUOTA_MS)
    proxy = _gap_proxy(dev, sched)
    proxy.serve()
    base = tempfile.mkdtemp(prefix="kubeshare-proxy-")
    _reset_counts()
    try:
        solo = _run_proxy_tenants(root, proxy, [PROXY_SOLO], PROXY_SOLO_S,
                                  base)
        pairs = {kind: _run_proxy_tenants(root, proxy, entries,
                                          PROXY_PAIR_S, base)
                 for kind, entries in PROXY_PAIRS.items()}
        launches = _counts()
        sessions_left = list(proxy._sessions)
    finally:
        proxy.close()
        shutil.rmtree(base, ignore_errors=True)
    check(not sessions_left, f"proxy sessions left behind: {sessions_left}")
    records = {**solo, **{n: r for pair in pairs.values()
                          for n, r in pair.items()}}
    steps = {n: _check_proxy_tenant(n, r) for n, r in records.items()}
    want = {k: n * sum(steps.values()) for k, n in
            _launches_per_step(adam_per_step, layers).items()}
    check(launches == want,
          f"proxy phase: launches {launches}, expected {want} for "
          f"{sum(steps.values())} steps")
    lone = solo[PROXY_SOLO[0]]
    first = lone["losses"][:PROXY_FIRST_LOSSES]
    for got, ref in zip(first, eager):
        check(abs(got - ref) <= 1e-5 * max(1.0, abs(ref)),
              f"proxy tenant's loss {got} vs the eager step's {ref}")
    lone_rate = _solo_rate(lone)
    readings = {}
    for kind, pair in pairs.items():
        readings[kind] = proxy_pair_reading(pair, PROXY_PAIRS[kind],
                                            lone_rate)
        log(f"proxy pair {kind}: {json.dumps(readings[kind])}")
        check_proxy_pair(kind, readings[kind])
    per_step = {n: {"wall_ms": 1000.0 * (r["ends"][-1] - r["ends"][0])
                               / (len(r["ends"]) - 1),
                    "proxy_exec_ms": (r["proxy"]["exec_ms_total"]
                                      - r["first_proxy"]["exec_ms_total"])
                    / (r["proxy"]["exec_count"]
                       - r["first_proxy"]["exec_count"]),
                    "first_exec_ms": r["first_proxy"]["exec_ms_total"],
                    "features": r["proxy"]["transport"]["features"],
                    **_gaps(proxy.gaps_ms.get(n, [])[TENANT_WARMUP_STEPS:])}
                for n, r in records.items()}
    for v in per_step.values():
        v["forwarding_ms"] = v["wall_ms"] - v["proxy_exec_ms"]
        check(v["features"] == ["preempt", "resume", "seq"],
              f"proxy tenant negotiated {v['features']}, not preempt + "
              f"resume + seq")
    return {
        "in_process_step_ms": step_ms,
        "per_step": per_step,
        "eager_first_losses": eager,
        "lone_first_losses": first,
        "lone_steps_per_sec": lone_rate,
        "pairs": readings,
        "compile": {n: r["proxy"]["last_compile"]
                    for n, r in records.items()},
        "first_step_s": {n: r["ends"][0] - r["started"]
                         for n, r in records.items()},
        "steps": steps,
        "launches": launches,
        "window_ms": WINDOW_MS,
    }


# --- phase 5g: the proxy survives and streams ---------------------------------

def _lm_loop():
    """The full-width LM train step as a loop function, and its start:
    ``(lm_loop, params, state, batch)`` made from RESUME_TENANT's seed —
    5g-loop's one-call run is the reference of 5g and of 5h."""
    from kubeshare_tpu_torch.models import common, transformer
    from kubeshare_tpu_torch.ops.fused_adam import fused_adam

    opt = fused_adam(1e-3)
    step = common.make_train_step(transformer.flash_loss_fn, opt)

    def lm_loop(carry, tokens, targets):
        params, state, loss = step(*carry, (tokens, targets))
        return (params, state), loss

    seed = RESUME_TENANT[1]
    params = transformer.init(seed)
    state = opt.init(common.to_device(params, "cpu"))
    return lm_loop, params, state, tuple(transformer.batch_fn(seed + 1))


def _loop_phase(dev, per_step: dict) -> dict:
    """5g-loop: ``compile_loop(fn, carry, *consts)`` over the full-width
    LM step, in this process, on a proxy of its own. The same start run
    one call at a time (RESUME_STEPS steps: also the reference of the
    tenant's run) and in bursts, then chains of bursts (LOOP_STEPS); each
    call's last loss must equal the one-call run's at that step, bit for
    bit, and the kernels launch exactly per_step a step."""
    from kubeshare_tpu_torch.constants import BASE_QUOTA_MS, MIN_QUOTA_MS
    from kubeshare_tpu_torch.isolation.client import ProxyClient
    from kubeshare_tpu_torch.isolation.proxy import ChipProxy
    from kubeshare_tpu_torch.isolation.tokensched import TokenScheduler

    lm_loop, params, state, batch = _lm_loop()
    proxy = ChipProxy(device=dev, scheduler=TokenScheduler(
        WINDOW_MS, BASE_QUOTA_MS, MIN_QUOTA_MS))
    proxy.serve()
    c = ProxyClient("127.0.0.1", proxy.port, "smoke/loop", 1.0, 1.0)
    try:
        consts = c.put_tree(batch)
        carry = c.put_tree((params, state))
        t0 = time.perf_counter()
        loop = c.compile_loop(lm_loop, carry, *consts)
        compile_s = time.perf_counter() - t0
        _reset_counts()
        one = []
        for _ in range(RESUME_STEPS):
            carry, loss = loop(1, carry, *consts)
            one.append(float(c.get(loss)))
        c.free(carry)
        carry = c.put_tree((params, state))
        sess = proxy._sessions["smoke/loop"]
        ms0, steps, bursts, chained = sess.exec_ms_total, 0, [], []
        t0 = time.perf_counter()
        while steps < LOOP_STEPS:
            # single bursts for the first half (a loss at each burst's
            # end), then server-side chains of bursts
            run = loop if steps < LOOP_STEPS // 2 else loop.chain
            carry, loss = run(LOOP_STEPS - steps, carry, *consts)
            steps += loop.last_n
            bursts.append(loop.last_burst)
            chained.append((steps, float(c.get(loss))))
        loop_s = time.perf_counter() - t0
        launches = _counts()
        exec_ms = sess.exec_ms_total - ms0
    finally:
        c.close()
        proxy.close()
    want = {k: n * (RESUME_STEPS + steps) for k, n in per_step.items()}
    check(launches == want, f"5g-loop: launches {launches}, expected {want}")
    for n, got in chained:
        check(got == one[n - 1],
              f"5g-loop: the looped step's loss after {n} steps {got} is "
              f"not the one-call step's {one[n - 1]}")
    check(all(math.isfinite(x) for x in one) and one[-1] < one[0],
          f"5g-loop: losses {one[0]} -> {one[-1]}")
    return {"one_call_losses": one, "chained": chained, "bursts": bursts,
            "steps": steps, "steps_per_sec": steps / loop_s,
            "proxy_exec_ms_per_step": exec_ms / steps,
            "compile_s": compile_s, "launches": launches}


def _wait_for(cond, what: str, timeout: float = 300.0,
              phase: str = "5g") -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < deadline, f"{phase}: timed out waiting "
                                           f"for {what}")
        time.sleep(0.005)


def _steps_per_sec(ends: list) -> float:
    return (len(ends) - 1) / (ends[-1] - ends[0])


def resume_phase(root: str, dev, per_step: dict, reference: list) -> dict:
    """5g-crash and 5g-migrate, one proxy-mode tenant process (5f's, with
    RESUME_STEPS steps): it trains on proxy 1 with a journal until
    CRASH_AT steps ran, the proxy crashes and a new one starts from the
    journal on the same port; after MIGRATE_AT more steps the session
    moves live to proxy 2 (no journal). The tenant is told of neither.
    Its losses must equal ``reference`` (the one-call run of 5g-loop,
    same seed) bit for bit, and the kernels launch exactly per_step an
    execution."""
    from kubeshare_tpu_torch import constants as C
    from kubeshare_tpu_torch.constants import BASE_QUOTA_MS, MIN_QUOTA_MS
    from kubeshare_tpu_torch.isolation.proxy import ChipProxy
    from kubeshare_tpu_torch.isolation.tokensched import TokenScheduler
    from kubeshare_tpu_torch.obs.flight import default_recorder
    from kubeshare_tpu_torch.obs.metrics import default_registry
    from kubeshare_tpu_torch.resilience.migrate import migrate_session

    resumes = default_registry().get("kubeshare_proxy_session_resumes_total")
    resumes0, wall0 = resumes.value(), time.time()

    name, seed = RESUME_TENANT
    base = tempfile.mkdtemp(prefix="kubeshare-resume-")
    jdir = os.path.join(base, "journal")

    def new_proxy(port=0, journal=True):
        p = ChipProxy(device=dev, scheduler=TokenScheduler(
            WINDOW_MS, BASE_QUOTA_MS, MIN_QUOTA_MS),
            journal_dir=jdir if journal else None)
        p.serve(port=port)
        return p

    out_path, log_path = (os.path.join(base, "tenant." + x)
                          for x in ("json", "log"))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KUBESHARE_TPU_")
           and k not in (C.ENV_VISIBLE_CHIPS, "CUDA_VISIBLE_DEVICES")}
    proxies: list = []
    proc = None
    res: dict = {}
    try:
        p1 = new_proxy()
        proxies.append(p1)
        env.update({"PYTHONPATH": os.pathsep.join(
            [os.path.join(root, "kubeshare_tpu_torch", "_shim"), root]),
                    C.ENV_CHIP_PROXY_PORT: str(p1.port),
                    C.ENV_POD_NAME: name, C.ENV_TPU_REQUEST: "1.0",
                    C.ENV_TPU_LIMIT: "1.0"})
        _reset_counts()
        with open(log_path, "w") as log_file:
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--tenant",
                 out_path, "--compiled", "--steps", str(RESUME_STEPS),
                 "--seed", str(seed)],
                env=env, cwd=root, stdout=log_file, stderr=subprocess.STDOUT)

        def executed(p, n):
            def cond():
                check(proc.poll() is None,
                      f"5g tenant exited early: {_tail(log_path)}")
                sess = p._sessions.get(name)
                return sess is not None and sess.exec_count >= n
            return cond

        _wait_for(executed(p1, CRASH_AT), "the journaled steps")
        sessions = [p1._sessions[name]]
        res["journal_bytes_on_disk"] = p1.journal.size()
        res["journal_bytes_written"] = p1.journal.bytes_written
        res["journaled_steps"] = p1._sessions[name].exec_count
        port = p1.port
        t_crash = time.monotonic()
        p1.crash(wait=True)
        p1b = new_proxy(port=port)
        proxies.append(p1b)
        res["restore_s"] = time.monotonic() - t_crash
        check(p1b.restored == [name], f"5g: restored {p1b.restored}")
        _wait_for(executed(p1b, MIGRATE_AT), "the steps after the crash")
        sessions.append(p1b._sessions[name])
        p2 = new_proxy(journal=False)
        proxies.append(p2)
        t_move = time.monotonic()
        moved = migrate_session(("127.0.0.1", p1b.port),
                                ("127.0.0.1", p2.port),
                                sessions[-1].resume_token)
        sessions.append(p2._sessions[name])
        res.update(migrate_s=moved["duration_s"], migrate_bytes=moved["bytes"])
        rc = proc.wait(timeout=600)
        check(rc == 0, f"5g tenant exited {rc}: {_tail(log_path)}")
        launches = _counts()
        # each proxy's executions of the session: the crashed one's as the
        # crash left it, the others' until the move and the tenant's exit
        execs = [sess.exec_count for sess in sessions]
        res["replays_served"] = sum(p.replays_served for p in proxies)
        with open(out_path) as f:
            rec = json.load(f)
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        for p in proxies:
            p.close()
        shutil.rmtree(base, ignore_errors=True)
    n_exec = sum(execs)
    check(rec["attach"] == "proxy" and rec["visible"] == ""
          and not rec["cuda_initialized"],
          f"5g tenant: attach {rec['attach']!r}, visible {rec['visible']!r}")
    losses = rec["losses"]
    check(len(losses) == RESUME_STEPS, f"5g: {len(losses)} steps")
    for i, (got, want) in enumerate(zip(losses, reference)):
        check(got == want, f"5g: the tenant's loss at step {i + 1}, "
                           f"{got}, is not the uncrashed, unmoved run's "
                           f"{want}")
    check(n_exec - 2 <= RESUME_STEPS <= n_exec,
          f"5g: {n_exec} executions for {RESUME_STEPS} steps")
    want = {k: n * n_exec for k, n in per_step.items()}
    check(launches == want, f"5g: launches {launches}, expected {want} "
                            f"for {n_exec} executions")
    ends = rec["ends"]
    after_crash = [t for t in ends if t > t_crash]
    after_move = [t for t in ends if t > t_move]
    journaled = [t for t in ends if t <= t_crash][TENANT_WARMUP_STEPS:]
    res.update({
        "executions": execs, "launches": launches,
        "transport": rec["proxy"]["transport"],
        "resume_s": after_crash[0] - t_crash,
        "move_to_first_step_s": after_move[0] - t_move,
        "journaled_steps_per_sec": _steps_per_sec(journaled),
        "unjournaled_steps_per_sec": _steps_per_sec(after_move[2:]),
        "journal_bytes_per_step": res["journal_bytes_written"]
        / res["journaled_steps"],
        "first_losses": losses[:3]})
    # the proxies' resume counter and the flight ring saw what the tenant
    # saw: a resume after the crash and one after the move, and a detach
    # when the move took the session from its connection. A proxy also
    # counts a resume whose reply the tenant never read: a dial that
    # waited in the backlog through the journal's recovery past the
    # tenant's dial timeout is handled after the tenant dialed again
    seen = rec["proxy"]["transport"]["resumes"]
    counted = resumes.value() - resumes0
    notes: dict = {}
    for e in default_recorder().ring():
        if (e["kind"] == "note" and e["t"] >= wall0
                and e["attrs"].get("client") == name):
            notes[e["event"]] = notes.get(e["event"], 0) + 1
    check(seen >= 1 and counted >= seen,
          f"5g: the resume counter rose by {counted}, the tenant resumed "
          f"{seen} times")
    check(notes.get("session-resumed", 0) == counted
          and notes.get("session-detached", 0) >= 1,
          f"5g: flight notes {notes} for {counted} resumes counted")
    res["obs"] = {"resumes_counted": counted, "resumes_seen": seen,
                  "notes": notes}
    return res


# --- phase 5h: latency-class serving preempts a best-effort trainer ------------

def _pct(values: list, q: float) -> float:
    """Nearest-rank percentile, as the JAX package's preemption bench."""
    if not values:
        return float("nan")
    s = sorted(values)
    return s[min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))]


def _serve_run(mode: str, ctx: dict) -> dict:
    """One 5h run: the four senders against the front door for
    SERVE_RUN_S, the trainer chaining beside them unless ``mode`` is
    ``exclusive``, the preemption policy attached only in
    ``preempt_on``. Kernel counts are set to 0 just before and read just
    after. The front door judges every row against its tenant's SLOs and
    the scheduler the serving session's grant waits (a fresh evaluator
    and flight recorder a run); each sender stamps a trace id on its
    requests; the ledger and the blame graph, which live across the
    runs, are read over this run's own span."""
    from kubeshare_tpu_torch.models import tinymlp
    from kubeshare_tpu_torch.obs import slo as obs_slo
    from kubeshare_tpu_torch.obs.flight import FlightRecorder
    from kubeshare_tpu_torch.obs.metrics import MetricsRegistry
    from kubeshare_tpu_torch.obs.trace import (add_span_sink, new_trace_id,
                                               remove_span_sink)
    from kubeshare_tpu_torch.preempt import PreemptionPolicy
    from kubeshare_tpu_torch.serving import (ContinuousBatcher, FrontDoor,
                                             Overloaded, ServingAccounting)

    import numpy as np

    sched, proxy, servable = ctx["sched"], ctx["proxy"], ctx["servable"]
    trainer, loop, consts = ctx["trainer"], ctx["loop"], ctx["consts"]
    tracer = ctx["tracer"]
    policy = (PreemptionPolicy(PREEMPT_GRACE_MS, PREEMPT_MIN_HOLD_MS)
              if mode == "preempt_on" else None)
    sched.preempt = policy
    slo = obs_slo.SloEvaluator(**SLO_WINDOWS)
    if "slo" not in ctx["off"]:
        slo.declare(SERVE_SESSION[0].partition("/")[0], GRANT_SLO)
    rec = FlightRecorder(dump_dir=os.path.join(ctx["tmp"], mode))

    def on_alert(event):
        rec.alert(event.to_dict())
        if event.state == "firing":
            rec.trigger("slo-alert", tenant=event.tenant,
                        objective=event.objective)

    slo.add_listener(on_alert)
    slo_on = "slo" not in ctx["off"]
    fd = FrontDoor(max_queue=256,
                   accounting=ServingAccounting(MetricsRegistry()),
                   slo=slo if slo_on else None, recorder=rec)
    for tenant, cls in SERVE_TENANTS:
        fd.register_tenant(tenant, tpu_class=cls, slo_spec=SERVE_SLO[cls])
    batcher = ContinuousBatcher(fd, servable, max_batch=SERVE_MAX_BATCH,
                                max_wait_s=SERVE_MAX_WAIT_S, recorder=rec)
    train_sess = proxy._sessions[TRAIN_SESSION[0]]
    slicer0, yields0 = proxy.slicer.stats(), train_sess.preempt_yields
    exec0 = {n: proxy._sessions[n].exec_ms_total
             for n in (SERVE_SESSION[0], TRAIN_SESSION[0])}
    blame = ctx["blame"]
    edges0 = ({(e["victim"], e["blamed"], e["chip"]): e
               for e in blame.edges()} if blame else {})
    victims0 = blame.victims() if blame else {}
    tracer.clear()
    ctx["grant_waits"].clear()
    errors: list = []
    served: dict = {cls: [] for _, cls in SERVE_TENANTS}   # (ms, x, y)
    shed = [0]
    train = {"losses": [], "bursts": [], "steps": 0, "sliced_chains": 0}
    stop_train = threading.Event()
    stop_pump = threading.Event()
    stop_slo = threading.Event()

    def guarded(fn, *args):
        try:
            fn(*args)
        except Exception as e:          # reported from the main thread
            errors.append(f"{fn.__name__}: {type(e).__name__}: {e}\n"
                          + traceback.format_exc())

    def send(tenant, cls, seed, end):
        rng = np.random.default_rng(seed)
        period = len(SERVE_TENANTS) / SERVE_RATE
        deadline = time.monotonic()
        while deadline < end:
            now = time.monotonic()
            if now < deadline:
                time.sleep(deadline - now)
            deadline += period
            x = rng.standard_normal((1, tinymlp.FEATURES)).astype(np.float32)
            tid = new_trace_id()
            t0, s0 = time.perf_counter(), tracer.now_ms()
            try:
                req = fd.submit(tenant, x, trace_id=tid, tpu_class=cls)
            except Overloaded:
                shed[0] += 1
                continue
            y = req.result(timeout=120.0)
            tracer.record("request", tid, s0, tracer.now_ms(),
                          tenant=tenant)
            served[cls].append(((time.perf_counter() - t0) * 1e3, x, y,
                                tid))

    def evaluate_slo():
        while not stop_slo.wait(SLO_EVERY_S):
            slo.evaluate()

    def chain_trainer():
        while not stop_train.is_set():
            carry = trainer.put_tree(ctx["start"])
            steps = 0
            while steps < SERVE_CHAIN and not stop_train.is_set():
                sliced0 = train_sess.preempt_yields
                carry, loss = loop.chain(SERVE_CHAIN - steps, carry, *consts)
                steps += loop.last_n
                train["steps"] += loop.last_n
                train["bursts"].append(loop.last_burst)
                train["sliced_chains"] += train_sess.preempt_yields > sliced0
                train["losses"].append((steps, float(trainer.get(loss))))
                trainer.free(loss)
            trainer.free(carry)

    default_slo = obs_slo.default_evaluator()
    obs_slo.set_default_evaluator(slo)      # the scheduler's grant waits
    add_span_sink(rec.on_span)
    evaluator = threading.Thread(target=guarded, args=(evaluate_slo,))
    evaluator.start()
    span0 = time.monotonic()                # the ledger's clock
    _reset_counts()
    t0 = time.perf_counter()
    pump = threading.Thread(target=guarded, args=(batcher.serve_loop,
                                                  stop_pump))
    pump.start()
    trainer_t = None
    if mode != "exclusive":
        trainer_t = threading.Thread(target=guarded, args=(chain_trainer,))
        trainer_t.start()
    end = time.monotonic() + SERVE_RUN_S
    senders = [threading.Thread(target=guarded,
                                args=(send, tenant, cls, SERVE_SEED + i,
                                      end))
               for i, (tenant, cls) in enumerate(SERVE_TENANTS)]
    for t in senders:
        t.start()
    for t in senders:
        t.join(timeout=300.0)
    drive_s = time.perf_counter() - t0
    stop_train.set()
    if trainer_t is not None:
        trainer_t.join(timeout=300.0)
    train_s = time.perf_counter() - t0
    stop_pump.set()
    pump.join(timeout=60.0)
    launches = _counts()
    span1 = time.monotonic()
    stop_slo.set()
    evaluator.join(timeout=60.0)
    remove_span_sink(rec.on_span)
    obs_slo.set_default_evaluator(default_slo)
    sched.preempt = None
    alive = [t for t in senders + [pump, trainer_t, evaluator]
             if t is not None and t.is_alive()]
    check(not alive, f"5h {mode}: {len(alive)} threads did not finish")
    check(not errors, f"5h {mode}: " + "\n".join(errors))
    slicer = {k: v - slicer0[k] for k, v in proxy.slicer.stats().items()}
    rows = [r for recs in served.values() for r in recs]
    state = fd.state()["totals"]
    check(state["admitted"] == state["completed"] == len(rows)
          and state["failed"] == 0,
          f"5h {mode}: admitted {state['admitted']}, completed "
          f"{state['completed']}, failed {state['failed']}, answered "
          f"{len(rows)}")
    waits = [w * 1e3 for w in ctx["grant_waits"]]
    out = {
        "mode": mode, "seconds": drive_s, "shed": shed[0],
        "completed": len(rows), "rate": len(rows) / drive_s,
        "latency_ms": {cls: {"p50": _pct([r[0] for r in recs], 0.50),
                             "p99": _pct([r[0] for r in recs], 0.99),
                             "n": len(recs)}
                       for cls, recs in served.items()},
        "grant_wait_ms": {"p50": _pct(waits, 0.50),
                          "p99": _pct(waits, 0.99), "n": len(waits)},
        "batches": batcher.executions,
        "mean_batch_rows": batcher.rows_served / max(1, batcher.executions),
        "trainer": {"steps": train["steps"],
                    "steps_per_sec": train["steps"] / train_s
                    if train["steps"] else 0.0,
                    "bursts": train["bursts"],
                    "chains": len(train["losses"]),
                    "sliced_chains": train["sliced_chains"],
                    "yields": train_sess.preempt_yields - yields0},
        "slicer": slicer, "launches": launches,
        "policy": policy.snapshot()["stats"] if policy else None,
        "core": sched.accounting()["core"],
        "cost_ms": dict(vars(ctx["loop_cost"])),
    }
    out["obs"] = None
    if not ctx["off"]:
        slo.evaluate()
        rec.trigger("run-end", mode=mode)
        out["obs"] = _serve_obs(mode, ctx, (span0, span1), exec0, edges0,
                                victims0, slo, rec,
                                [r[3] for r in served["latency"]])
    return out, rows, train["losses"]


def _blame_delta(edges0: dict, edges1: list) -> list:
    """The blame edges a run added: each edge less its value before."""
    out = []
    for e in edges1:
        b = edges0.get((e["victim"], e["blamed"], e["chip"]))
        d = {k: e[k] - (b[k] if b else 0) for k in ("wait_s", "preempted_s",
                                                   "count")}
        if d["count"] <= 0:
            continue
        kind = ("migration" if e["kind"] == "migration" else "preempted"
                if d["preempted_s"] > 0.0 else "hold")
        out.append(dict(d, victim=e["victim"], blamed=e["blamed"],
                        kind=kind))
    return sorted(out, key=lambda d: -d["wait_s"])


def _serve_obs(mode: str, ctx: dict, span: tuple, exec0: dict,
               edges0: dict, victims0: dict, slo, rec,
               latency_tids: list) -> dict:
    """5h's observability reading of one run, checked: the chip-time
    ledger over the run's span (sound, and covering each session's
    execution ms), the blame edges the run added, the SLO alerts, the
    flight dumps and critpath's split of the latency-class row at p99."""
    from kubeshare_tpu_torch.obs import critpath
    from kubeshare_tpu_torch.obs.flight import parse_dump_jsonl

    ledger, blame, proxy = ctx["ledger"], ctx["blame"], ctx["proxy"]
    chip = ctx["sched"].chip
    problems = ledger.check()
    check(not problems, f"5h {mode}: the ledger is not sound: {problems}")
    by_state: dict = {}
    preempted: dict = {}
    for row in ledger.account(chip, *span):
        key = f"{row['tenant'] or '-'}:{row['state']}"
        by_state[key] = by_state.get(key, 0.0) + row["overlap_s"]
        if row["preempted"]:
            preempted[row["tenant"]] = (preempted.get(row["tenant"], 0.0)
                                        + row["overlap_s"])
    active_vs_exec = {}
    for name in (SERVE_SESSION[0], TRAIN_SESSION[0]):
        tenant = name.partition("/")[0]
        active = by_state.get(f"{tenant}:granted-active", 0.0)
        exec_s = (proxy._sessions[name].exec_ms_total - exec0[name]) / 1e3
        active_vs_exec[name] = [active, exec_s]
        check(active >= LEDGER_COVERS_EXEC * exec_s,
              f"5h {mode}: {name}'s ledger granted-active {active:.4f} s "
              f"is under {LEDGER_COVERS_EXEC} x its execution "
              f"{exec_s:.4f} s: the interval closes before the barrier")
    server = SERVE_SESSION[0].partition("/")[0]
    trainer = TRAIN_SESSION[0].partition("/")[0]
    edges = [e for e in _blame_delta(edges0, blame.edges())
             if e["victim"] == server]
    blamed = sum(e["wait_s"] for e in edges)
    waits = sum(ctx["grant_waits"])
    vic0 = victims0.get(server, {})
    vic1 = blame.victims().get(server, {})
    waited = vic1.get("waited_s", 0.0) - vic0.get("waited_s", 0.0)
    check(blamed <= waits + 1e-6,
          f"5h {mode}: blame names {blamed:.6f} s of the server's waits, "
          f"more than the {waits:.6f} s it waited")
    on_trainer = [e for e in edges if e["blamed"] == trainer]
    if mode == "exclusive":
        check(not on_trainer,
              f"5h exclusive: the server's waits blame the trainer: "
              f"{on_trainer}")
    if mode == "preempt_on":
        check(any(e["kind"] == "preempted" for e in on_trainer),
              f"5h preempt_on: no preempted edge names the trainer: "
              f"{edges}")
    dumps = rec.dumps()
    last = dumps[-1]
    with open(last["path"]) as f:
        back = parse_dump_jsonl(f.read())
    check(back["reason"] == last["reason"] and back["seq"] == last["seq"]
          and back["entries"] == json.loads(json.dumps(last["entries"])),
          f"5h {mode}: the last flight dump does not read back")
    path = os.path.join(ctx["tmp"], f"spans-{mode}.jsonl")
    ctx["tracer"].export_jsonl(path)
    rows = [r for r in critpath.load_spans([path])
            if r["name"] != "serve-batch"]
    # a batch's put, execute and get carry its head request's trace: the
    # head rows have the proxy's spans (serve-batch envelops them all)
    heads = {r["trace_id"] for r in rows if r["name"] == "execute"}
    wanted = heads & set(latency_tids)
    traces = [t for t in critpath.assemble(rows)
              if t["trace_id"] in wanted]
    crit = {"rows": len(traces)}
    if traces:
        by_wall = sorted(traces, key=lambda t: t["wall_ms"])
        p99 = by_wall[min(len(by_wall) - 1,
                          max(0, math.ceil(0.99 * len(by_wall)) - 1))]
        rep = critpath.report(traces)
        crit.update(p99={k: p99[k] for k in ("wall_ms", "segments",
                                             "coverage", "residual_ms")},
                    coverage_mean=rep["coverage_mean"],
                    segments_p50={k: v["p50_ms"]
                                  for k, v in rep["segments"].items()},
                    wall_p50_ms=rep["wall_p50_ms"])
        check(sum(p99["segments"].values()) <= p99["wall_ms"] * 1.01,
              f"5h {mode}: critpath counts past the row's wall: {p99}")
    return {
        "ledger_s": by_state, "preempted_s": preempted,
        "ledger_check": problems, "active_vs_exec_s": active_vs_exec,
        "blame": edges, "blame_total_s": blamed, "grant_waits_s": waits,
        "blame_waited_s": waited,
        "slo_alerts": [e.to_dict() for e in slo.events()],
        "slo_firing": ["%s:%s" % f for f in slo.firing()],
        "flight_dumps": len(dumps),
        "last_dump": {"reason": back["reason"],
                      "entries": len(back["entries"])},
        "critpath": crit,
    }


def serve_phase(dev, per_step: dict, reference: list,
                off: tuple = ()) -> dict:
    """5h: a ``FrontDoor`` and a ``ContinuousBatcher`` over a
    ``ProxyServable`` (tinymlp at 8 x 32, its client registered
    ``latency``) serve four tenants on a ``ChipProxy`` whose native-core
    scheduler also holds a best-effort trainer — the full-width LM
    looped (5g-loop's program, chains of SERVE_CHAIN steps). Runs in
    turn: the server alone, the trainer beside it with no policy, then
    with a ``PreemptionPolicy``. Every run: every admitted request
    answered with the plain ``tinymlp.apply``'s rows, no yield in the
    middle of an execute, launches exactly the trainer's steps' (the
    served program launches no kernel), the trainer's losses 5g-loop's
    one-call losses bit for bit; preempt_on preempts and yields,
    preempt_off does neither; the core is native. ``off`` names hooks of
    SERVE_HOOKS to leave off; a run with any off skips the obs reading."""
    import numpy as np
    import torch

    from kubeshare_tpu_torch.constants import BASE_QUOTA_MS, MIN_QUOTA_MS
    from kubeshare_tpu_torch.isolation.client import ProxyClient
    from kubeshare_tpu_torch.isolation.proxy import ChipProxy
    from kubeshare_tpu_torch.isolation.tokensched import TokenScheduler
    from kubeshare_tpu_torch.models import common, tinymlp
    from kubeshare_tpu_torch.obs.blame import BlameGraph
    from kubeshare_tpu_torch.obs.ledger import ChipTimeLedger
    from kubeshare_tpu_torch.obs.trace import (Tracer, get_tracer,
                                               install_tracer,
                                               uninstall_tracer)
    from kubeshare_tpu_torch.serving import ProxyServable
    from kubeshare_tpu_torch.topology.discovery import device_chip_id

    check(set(off) <= set(SERVE_HOOKS), f"5h: unknown hooks {off}")
    hook_us = _hook_cost_us()
    ledger = None if "ledger" in off else ChipTimeLedger()
    blame = None if "ledger" in off else BlameGraph(ledger)
    sched = TokenScheduler(WINDOW_MS, BASE_QUOTA_MS, MIN_QUOTA_MS,
                           chip=device_chip_id(dev), ledger=ledger,
                           blame=blame)
    if "cond" in off:
        sched._cond = threading.Condition()
    tracer = (get_tracer() if "tracer" in off
              else install_tracer(Tracer(capacity=500_000)))
    tmp = tempfile.mkdtemp(prefix="kubeshare-serve-")
    waits: list = []
    acquire, renew = sched.acquire, sched.renew

    def timed(fn):
        # the serving session's grant waits, read per run
        def call(name, *args, **kw):
            t0 = time.perf_counter()
            quota = fn(name, *args, **kw)
            if name == SERVE_SESSION[0]:
                waits.append(time.perf_counter() - t0)
            return quota
        return call

    sched.acquire, sched.renew = timed(acquire), timed(renew)
    proxy = ChipProxy(device=dev, scheduler=sched,
                      idle_release_ms=SERVE_IDLE_RELEASE_MS)
    proxy.serve()
    server = ProxyClient("127.0.0.1", proxy.port, SERVE_SESSION[0],
                         SERVE_SESSION[1], 1.0, tpu_class="latency")
    trainer = ProxyClient("127.0.0.1", proxy.port, TRAIN_SESSION[0],
                          TRAIN_SESSION[1], 1.0)
    runs: dict = {}
    try:
        t0 = time.perf_counter()
        servable = ProxyServable(server, seed=SERVE_SEED)
        lm_loop, params, state, batch = _lm_loop()
        consts = trainer.put_tree(batch)
        carry = trainer.put_tree((params, state))
        loop = trainer.compile_loop(lm_loop, carry, *consts)
        trainer.free(carry)
        setup_s = time.perf_counter() - t0
        # the trainer's burst cost model, read after each run: its
        # per-step ms sets the burst (window / 4 over it, bucketed)
        loop_cost = proxy._sessions[TRAIN_SESSION[0]].executables[
            loop._exec_id].cost
        ctx = {"sched": sched, "proxy": proxy, "servable": servable,
               "trainer": trainer, "loop": loop, "consts": consts,
               "start": (params, state), "grant_waits": waits,
               "ledger": ledger, "blame": blame, "tracer": tracer,
               "tmp": tmp, "off": tuple(off), "loop_cost": loop_cost}
        plain = common.to_device(servable.params, dev)
        for mode in ("exclusive", "preempt_off", "preempt_on"):
            out, rows, losses = _serve_run(mode, ctx)
            x = torch.from_numpy(np.concatenate([r[1] for r in rows]))
            y = np.concatenate([r[2] for r in rows])
            want = tinymlp.apply(plain, x.to(dev)).cpu().numpy()
            out["max_abs_err"] = float(np.max(np.abs(y - want)))
            check(y.shape == want.shape and np.isfinite(y).all()
                  and out["max_abs_err"] <= SERVE_ATOL,
                  f"5h {mode}: served rows differ from the plain "
                  f"tinymlp.apply by {out['max_abs_err']} (atol "
                  f"{SERVE_ATOL})")
            check(out["slicer"]["mid_execute_yields"] == 0,
                  f"5h {mode}: yields in the middle of an execute: "
                  f"{out['slicer']}")
            steps = out["trainer"]["steps"]
            want_launches = {k: n * steps for k, n in per_step.items()}
            check(out["launches"] == want_launches,
                  f"5h {mode}: launches {out['launches']}, expected "
                  f"{want_launches} for {steps} trainer steps")
            for n, got in losses:
                check(got == reference[n - 1],
                      f"5h {mode}: the trainer's loss after {n} steps {got} "
                      f"is not the undisturbed loop's {reference[n - 1]}")
            check(out["core"] == "native", f"5h {mode}: core {out['core']}")
            if mode == "exclusive":
                check(steps == 0, f"5h exclusive: the trainer ran {steps}")
            else:
                check(steps > 0 and losses,
                      f"5h {mode}: the trainer made no step")
            if mode == "preempt_on":
                # a marked hold yields at a boundary the slicer finds, at
                # a spent quota's renew or by the idle release: the
                # policy counts each; the slicer only the first kind
                pol = out["policy"]
                check(pol["preemptions"] >= 1 and pol["yields"] >= 1,
                      f"5h preempt_on: preemptions {pol['preemptions']}, "
                      f"yields {pol['yields']}, slicer {out['slicer']}")
            else:
                check(out["slicer"]["yields"] == 0
                      and out["trainer"]["yields"] == 0,
                      f"5h {mode}: yields without a policy: "
                      f"{out['slicer']}")
            out["checked_losses"] = len(losses)
            runs[mode] = out
    finally:
        trainer.close()
        server.close()
        proxy.close()
        uninstall_tracer()
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in per_step}
    return {"runs": runs, "setup_s": setup_s, "launches": launches,
            "compile": trainer.last_compile, "hook_us": hook_us}


def _hook_cost_us() -> dict:
    """Microseconds of host time an acquire / execute begin, end /
    release cycle of a lone client takes: ``plain`` with a plain
    Condition in place of the scheduler's TrackedCondition and no other
    hook, ``cond`` with the TrackedCondition, then that with each of the
    ledger and blame graph, a tracer (and a trace id on the acquire) and
    a declared grant-wait SLO, and ``all`` with every one. The
    grant-wait, hold and utilisation families and the flight deltas run
    in every kind. The least of two turns."""
    from kubeshare_tpu_torch.constants import BASE_QUOTA_MS, MIN_QUOTA_MS
    from kubeshare_tpu_torch.isolation.tokensched import TokenScheduler
    from kubeshare_tpu_torch.obs import slo as obs_slo
    from kubeshare_tpu_torch.obs.blame import BlameGraph
    from kubeshare_tpu_torch.obs.ledger import ChipTimeLedger
    from kubeshare_tpu_torch.obs.trace import (Tracer, install_tracer,
                                               uninstall_tracer)

    kinds = {"plain": (), "cond": ("cond",),
             "ledger": ("cond", "ledger"), "tracer": ("cond", "tracer"),
             "slo": ("cond", "slo"), "all": ("cond",) + SERVE_HOOKS[1:]}
    out = {}
    default_slo = obs_slo.default_evaluator()
    try:
        for kind in list(kinds) * 2:
            on = kinds[kind]
            ledger = ChipTimeLedger() if "ledger" in on else None
            sched = TokenScheduler(
                WINDOW_MS, BASE_QUOTA_MS, MIN_QUOTA_MS, chip="hook-cost",
                ledger=ledger, blame=BlameGraph(ledger) if ledger else None)
            if "cond" not in on:
                sched._cond = threading.Condition()
            tid = "hook-cost" if "tracer" in on else ""
            if tid:
                install_tracer(Tracer())
            slo = obs_slo.SloEvaluator(**SLO_WINDOWS)
            if "slo" in on:
                slo.declare("hook", GRANT_SLO)
            obs_slo.set_default_evaluator(slo)
            sched.add_client("hook/cost", 0.5, 1.0)
            t0 = time.perf_counter()
            for _ in range(HOOK_CYCLES):
                sched.acquire("hook/cost", trace_id=tid)
                sched.execute_begin()
                sched.execute_end()
                sched.release("hook/cost", 0.001)
            us = (time.perf_counter() - t0) / HOOK_CYCLES * 1e6
            out[kind] = min(out.get(kind, us), us)
            sched.close()
            uninstall_tracer()
    finally:
        obs_slo.set_default_evaluator(default_slo)
    return out


def _fmt_serve_obs(r: dict) -> str:
    """5h's observability line of one run: one JSON object."""
    return f"5h {r['mode']} obs: " + json.dumps(r["obs"], sort_keys=True)


def _fmt_serve_run(r: dict) -> str:
    lat = "; ".join(f"{cls} p50 {v['p50']:.3f} p99 {v['p99']:.3f} ms "
                    f"({v['n']})" for cls, v in r["latency_ms"].items())
    tr = r["trainer"]
    line = (f"5h {r['mode']}: {r['rate']:.1f} requests/s achieved "
            f"({r['completed']} in {r['seconds']:.2f} s, shed {r['shed']}, "
            f"{r['batches']} batches of {r['mean_batch_rows']:.2f} rows); "
            f"latency {lat}; the serving session's grant wait p50 "
            f"{r['grant_wait_ms']['p50']:.3f} p99 "
            f"{r['grant_wait_ms']['p99']:.3f} ms "
            f"({r['grant_wait_ms']['n']}); trainer {tr['steps']} steps, "
            f"{tr['steps_per_sec']:.3f} steps/s, {tr['chains']} chains "
            f"({tr['sliced_chains']} sliced), bursts {tr['bursts']}; slicer "
            f"{r['slicer']}; core {r['core']}; max abs err "
            f"{r['max_abs_err']:.3g}; launches {r['launches']}; the "
            f"trainer's cost model after the run: step "
            f"{r['cost_ms']['step_ms']:.3f} ms, in-burst step "
            f"{r['cost_ms']['loop_step_ms']:.3f} ms")
    if r["policy"] is not None:
        p = r["policy"]
        line += (f"; policy: preemptions {p['preemptions']}, yields "
                 f"{p['yields']}, reclaimed {p['reclaimed_ms']} ms, boost "
                 f"grants {p['boost_grants']}, credits repaid "
                 f"{p['credits_repaid']}")
    return line


# --- phase 5i: a pod from its labels to the card -------------------------------

class FakeKubeApi:
    """Just enough kube-apiserver for the pod-event bridge, in a thread:
    pod create, list and get, a watch stream that stays open and streams
    each event as it happens (from the resourceVersion asked for),
    merge-patch of annotations, the ``Binding`` subresource, and DELETE
    with a uid precondition (409 on a mismatch, 404 when gone). Every
    write is logged in ``writes``; each DELETE's body in ``deletes``."""

    #: a watch stream's life, then the bridge relists: kube-apiserver's
    #: default --min-request-timeout. A relist reconciles the service's
    #: pods against the listed ones, so it must not fall inside 5i, whose
    #: background pods reach the service without a pod object.
    WATCH_S = 1800.0

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.pods: dict = {}                  # "ns/name" -> pod object
        self.events: list = []                # (rv, type, object)
        self.writes: list = []                # (kind, key, body)
        self.deletes: list = []               # (key, body)
        self.rv = 0
        self.cond = threading.Condition()
        api = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.0"

            def log_message(self, *args):
                pass

            def _reply(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self):
                n = int(self.headers.get("Content-Length", "0") or 0)
                return json.loads(self.rfile.read(n) or b"{}") if n else {}

            def _key(self):
                parts = self.path.split("?")[0].strip("/").split("/")
                # api v1 namespaces NS pods NAME [binding]
                return (f"{parts[3]}/{parts[5]}" if len(parts) >= 6
                        else "", parts)

            def do_GET(self):
                from urllib.parse import parse_qs, urlparse

                url = urlparse(self.path)
                q = parse_qs(url.query)
                if url.path != "/api/v1/pods":
                    key, _ = self._key()
                    with api.cond:
                        pod = api.pods.get(key)
                    return self._reply(200, pod) if pod else self._reply(
                        404, {"kind": "Status", "code": 404})
                sel = q.get("fieldSelector", [""])[0].partition("=")[2]
                if not q.get("watch"):
                    with api.cond:
                        items = [p for p in api.pods.values()
                                 if p["spec"].get("schedulerName") == sel]
                        rv = str(api.rv)
                    return self._reply(200, {"items": items, "metadata": {
                        "resourceVersion": rv}})
                self.send_response(200)
                self.end_headers()
                seen = int(q.get("resourceVersion", ["0"])[0] or 0)
                end = time.monotonic() + api.WATCH_S
                while time.monotonic() < end:
                    with api.cond:
                        api.cond.wait_for(
                            lambda: api.events and api.events[-1][0] > seen,
                            timeout=max(0.0, end - time.monotonic()))
                        fresh = [e for e in api.events if e[0] > seen]
                    for rv, etype, obj in fresh:
                        seen = rv
                        if obj["spec"].get("schedulerName") != sel:
                            continue
                        line = json.dumps({"type": etype, "object": obj})
                        try:
                            self.wfile.write(line.encode() + b"\n")
                            self.wfile.flush()
                        except OSError:
                            return

            def do_POST(self):
                key, parts = self._key()
                body = self._body()
                if parts[-1] == "pods":           # create
                    meta = body["metadata"]
                    meta.setdefault("namespace", parts[3])
                    key = f"{meta['namespace']}/{meta['name']}"
                    with api.cond:
                        if key in api.pods:
                            return self._reply(409, {"code": 409})
                        meta["uid"] = f"uid-{key}-{api.rv + 1}"
                        body.setdefault("spec", {})
                        api.pods[key] = body
                        api._emit("ADDED", key)
                    api.writes.append(("create", key, body))
                    return self._reply(201, body)
                with api.cond:                    # binding
                    pod = api.pods.get(key)
                    if pod is None:
                        return self._reply(404, {"code": 404})
                    uid = body["metadata"].get("uid", "")
                    if uid and uid != pod["metadata"]["uid"]:
                        return self._reply(409, {"code": 409})
                    pod["spec"]["nodeName"] = body["target"]["name"]
                    api._emit("MODIFIED", key)
                api.writes.append(("bind", key, body))
                self._reply(201, {"kind": "Status", "status": "Success"})

            def do_PATCH(self):
                key, _ = self._key()
                body = self._body()
                with api.cond:
                    pod = api.pods.get(key)
                    if pod is None:
                        return self._reply(404, {"code": 404})
                    pod["metadata"].setdefault("annotations", {}).update(
                        body.get("metadata", {}).get("annotations", {}))
                    api._emit("MODIFIED", key)
                api.writes.append(("patch", key, body))
                self._reply(200, pod)

            def do_DELETE(self):
                key, _ = self._key()
                body = self._body()
                api.deletes.append((key, body))
                want = (body.get("preconditions") or {}).get("uid", "")
                with api.cond:
                    pod = api.pods.get(key)
                    if pod is None:
                        return self._reply(404, {"code": 404})
                    if want and want != pod["metadata"]["uid"]:
                        return self._reply(409, {"code": 409})
                    api._emit("DELETED", key)
                    del api.pods[key]
                api.writes.append(("delete", key, body))
                self._reply(200, {"kind": "Status", "status": "Success"})

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def _emit(self, etype: str, key: str) -> None:
        """Log an event of ``key``'s current object (caller holds cond)."""
        self.rv += 1
        pod = self.pods[key]
        pod["metadata"]["resourceVersion"] = str(self.rv)
        self.events.append((self.rv, etype, json.loads(json.dumps(pod))))
        self.cond.notify_all()

    def request(self, method: str, path: str, body=None):
        """One call to this server as a client would make it: (code,
        body)."""
        return _http_json(method, self.url + path, body)

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()


def _start_daemon(root: str, base: str, label: str, args: list):
    """One daemon of the placement path as a process of its own (``python
    -m``), its output in a log under ``base``; returns (process, log)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KUBESHARE_TPU_")}
    env["PYTHONPATH"] = root
    log_path = os.path.join(base, label + ".log")
    with open(log_path, "w") as out:
        proc = subprocess.Popen([sys.executable, "-m", *args], env=env,
                                cwd=root, stdout=out,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
    return proc, log_path


def _stop_daemon(proc, label: str, log_path: str) -> None:
    """SIGTERM, then a clean exit within 20 s (each daemon of the path
    stops on its first signal, READY or not)."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=20)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail(f"5i: the {label} did not stop on SIGTERM: {_tail(log_path)}")
    check(rc == 0, f"5i: the {label} exited {rc}: {_tail(log_path)}")


def _fake_capacity(rc) -> int:
    """The capacity PLACE_FAKE_NODES collectors would publish, each node
    PLACE_FAKE_DEVICES devices of PLACE_FAKE_MODEL; returns the count."""
    from kubeshare_tpu_torch.topology.chip import ChipInfo, make_chip_id

    n = 0
    for i in range(PLACE_FAKE_NODES):
        host = f"fake-node-{i}"
        chips = [ChipInfo(chip_id=make_chip_id(PLACE_FAKE_MODEL, host, d),
                          index=d, host=host, model=PLACE_FAKE_MODEL,
                          memory=PLACE_FAKE_MEMORY)
                 for d in range(PLACE_FAKE_DEVICES)]
        rc.put_capacity(host, [c.to_labels() for c in chips], healthy=True)
        n += len(chips)
    return n


def _background_labels(rng, i: int) -> list:
    """Background submission ``i`` in a battery-like mix, pinned to the
    fake model: a list of label sets, two for a gang pair."""
    from kubeshare_tpu_torch import constants as C

    pin = {C.POD_TPU_MODEL: PLACE_FAKE_MODEL}
    kind = rng.randrange(8)
    if kind == 0:       # half share (pod01)
        return [dict(pin, **{C.POD_TPU_REQUEST: "0.5",
                             C.POD_TPU_LIMIT: "1.0"})]
    if kind == 1:       # small share (pod04)
        return [dict(pin, **{C.POD_TPU_REQUEST: "0.25",
                             C.POD_TPU_LIMIT: "0.5"})]
    if kind == 2:       # memory and priority (pod05)
        return [dict(pin, **{C.POD_TPU_REQUEST: "0.5",
                             C.POD_TPU_LIMIT: "1.0",
                             C.POD_TPU_MEMORY: str(16 * 1024**3),
                             C.POD_PRIORITY: "50"})]
    if kind == 3:       # whole device (pod03)
        return [dict(pin, **{C.POD_TPU_REQUEST: "1", C.POD_TPU_LIMIT: "1"})]
    if kind == 4:       # two devices (pod06)
        return [dict(pin, **{C.POD_TPU_REQUEST: "2", C.POD_TPU_LIMIT: "2"})]
    if kind == 5:       # opportunistic (pod15)
        return [dict(pin, **{C.POD_TPU_REQUEST: "0.3",
                             C.POD_TPU_LIMIT: "1.0",
                             C.POD_PRIORITY: "0"})]
    if kind == 6:       # guarantee share
        return [dict(pin, **{C.POD_TPU_REQUEST: "0.2",
                             C.POD_TPU_LIMIT: "1.0",
                             C.POD_PRIORITY: "10"})]
    gang = {C.POD_TPU_REQUEST: "1.0", C.POD_TPU_LIMIT: "1.0",   # pod02
            C.POD_GROUP_NAME: f"pair-{i}",
            C.POD_GROUP_HEADCOUNT: "2", C.POD_GROUP_THRESHOLD: "1",
            C.POD_PRIORITY: "10"}
    return [dict(pin, **gang), dict(pin, **gang)]


def _http_json(method: str, url: str, body=None, timeout: float = 10.0):
    """One JSON request: ``(code, body)``, HTTP errors included."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method)
    req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw, code = r.read(), r.status
    except urllib.error.HTTPError as e:
        raw, code = e.read(), e.code
    try:
        return code, json.loads(raw)
    except ValueError:
        return code, raw.decode()


def _http_metrics(base_url: str) -> str:
    import urllib.request

    with urllib.request.urlopen(base_url + "/metrics", timeout=10) as r:
        return r.read().decode()


def _poll(cond, what: str, timeout: float, period: float = 0.05):
    """Wait for ``cond()`` to return a true value, which is returned;
    fails 5i past ``timeout``."""
    deadline = time.monotonic() + timeout
    while True:
        got = cond()
        if got:
            return got
        check(time.monotonic() < deadline, f"5i: timed out waiting for {what}")
        time.sleep(period)


def _phase_histograms(metrics_text: str) -> dict:
    """``{phase: {le: cumulative count}}`` of the service's
    ``kubeshare_sched_phase_latency_seconds``."""
    from kubeshare_tpu_torch.obs.metrics import parse_exposition

    fam = parse_exposition(metrics_text).get(
        "kubeshare_sched_phase_latency_seconds", {"samples": []})
    out: dict = {}
    for name, labels, value in fam["samples"]:
        if name.endswith("_bucket"):
            le = float(labels["le"])
            out.setdefault(labels["phase"], {})[le] = value
    return out


def _phase_quantiles(before: dict, after: dict) -> dict:
    """p50 / p99 µs of each engine phase over the cycles between two
    scrapes (interpolated in the histogram's buckets, as PromQL's
    ``histogram_quantile``), with the cycle count."""
    from kubeshare_tpu_torch.obs.metrics import quantile_from_buckets

    out = {}
    for phase, buckets in sorted(after.items()):
        les = sorted(buckets)
        cum = [buckets[le] - before.get(phase, {}).get(le, 0.0)
               for le in les]
        if not cum or cum[-1] <= 0:
            continue
        finite = [le for le in les if math.isfinite(le)]
        out[phase] = {
            "count": int(cum[-1]),
            "p50_us": quantile_from_buckets(finite, cum, 0.5) * 1e6,
            "p99_us": quantile_from_buckets(finite, cum, 0.99) * 1e6}
    return out


def _background_stream(client) -> dict:
    """PLACE_BACKGROUND_PODS seeded submissions on the fake nodes, each a
    ``POST /schedule`` to the service process (``ServiceClient``); the
    service publishes each binding itself. An unbound single pod is
    deleted at once, a bound one withdrawn after about one submission in
    three. A gang pair whose first member waits only for its sibling is
    left to the dispatcher's retry, which binds both once the second is
    parked at the Permit barrier; it is deleted at the end if still
    unbound. A pair the fleet cannot hold is left pending, as a user
    leaves an unschedulable pod: the dispatcher's retries search for
    preemptions only where something was released since. Times each HTTP
    round trip."""
    rng = random.Random(PLACE_SEED)
    rtt, bound, gangs = [], [], []
    refused = pending_pairs = 0
    i = 0
    while i < PLACE_BACKGROUND_PODS:
        sets = _background_labels(rng, i)[:PLACE_BACKGROUND_PODS - i]
        # a gang's members carry its rank ordinals, as a StatefulSet's do
        names = ([f"bg-{i}"] if len(sets) == 1
                 else [f"bg-{i}-{j}" for j in range(len(sets))])
        i += len(sets)
        codes = []
        for name, labels in zip(names, sets):
            t0 = time.perf_counter()
            code, body = client.schedule("bg", name, labels)
            rtt.append(time.perf_counter() - t0)
            check(code in (200, 202), f"5i: POST /schedule of bg/{name} "
                                      f"answered {code}: {body}")
            codes.append(code)
        if len(names) > 1 and codes != [200] * len(names):
            # a pair one member short of its barrier binds at the next
            # retry; one the fleet cannot hold stays pending
            reasons = [client.status("bg", n)[1].get("reason", "")
                       for n in names]
            if all(not r or "min_available" in r for r in reasons):
                gangs.append(names)
            else:
                pending_pairs += 1
        else:
            for name, code in zip(names, codes):
                if code == 200:
                    bound.append(name)
                else:
                    refused += 1
                    client.delete("bg", name)
        if bound and rng.random() < 0.3:
            name = bound.pop(rng.randrange(len(bound)))
            client.delete("bg", name)
    deadline = time.monotonic() + 10.0
    gangs_bound = 0
    for names in gangs:
        while True:
            states = [client.status("bg", n)[1].get("status")
                      for n in names]
            if (all(s == "bound" for s in states)
                    or time.monotonic() > deadline
                    or not any(s in ("parked", "pending") for s in states)):
                break
            time.sleep(0.05)
        if all(s == "bound" for s in states):
            gangs_bound += 1
            bound.extend(names)
            continue
        for n in names:
            client.delete("bg", n)
        refused += len(names)
    lat_us = sorted(x * 1e6 for x in rtt)
    return {"submitted": len(rtt), "refused": refused,
            "pending_pairs": pending_pairs,
            "bound_at_end": len(bound), "gangs_bound_late": gangs_bound,
            "rtt_us_p50": _pct(lat_us, 0.5),
            "rtt_us_p99": _pct(lat_us, 0.99),
            "pods_per_sec": len(rtt) / sum(rtt)}


def _admit(webhook_port: int, obj: dict) -> dict:
    """What the apiserver does with a pod CREATE: the mutating webhook's
    ``AdmissionReview`` round trip, its JSON patch applied."""
    import base64

    from kubeshare_tpu_torch.scheduler.webhook import apply_json_patch

    code, review = _http_json("POST", f"http://127.0.0.1:{webhook_port}"
                              "/mutate", {
                                  "apiVersion": "admission.k8s.io/v1",
                                  "kind": "AdmissionReview",
                                  "request": {"uid": obj["metadata"]["name"],
                                              "kind": {"kind": "Pod"},
                                              "object": obj}})
    resp = review.get("response", {}) if code == 200 else {}
    check(resp.get("allowed") is True and resp.get("patch"),
          f"5i: the webhook answered {code}: {review}")
    return apply_json_patch(obj, json.loads(base64.b64decode(resp["patch"])))


def _labels_only_pod(name: str, labels: dict) -> dict:
    ns, _, pod_name = name.partition("/")
    return {"metadata": {"namespace": ns, "name": pod_name,
                         "labels": dict(labels)},
            "spec": {"containers": [{"name": "lm",
                                     "image": "kubeshare-tpu-torch"}]}}


def _same_registry(lead, follow) -> bool:
    """Whether a follower registry holds the leader's capacity, pods and
    leases (a lease's epoch, holder and TTL: the follower stamps its own
    times)."""
    def leases(rc):
        return {k: {f: v for f, v in lease.items()
                    if f not in ("ts", "age_s")}
                for k, lease in rc.leases()["leases"].items()}
    return (follow.capacity() == lead.capacity()
            and follow.pods() == lead.pods()
            and leases(follow) == leases(lead))


def place_phase(root: str, adam_per_step: int, layers: int) -> dict:
    """Phase 5i: a pod from a Kubernetes object to a tenant on the card,
    through a leader failover. The port's registry and a follower of it,
    collector (``--backend cuda``), configd, two scheduler services
    (``svc-a``, ``svc-b``: four cell-routed shards, health watch, a
    ``leader:scheduler`` election), pod-event bridge (over both services)
    and admission webhook run as processes, a fake kube-apiserver here.
    The launcher and its proxy remote-write their metrics to the
    registry. The fleet is the real node and PLACE_FAKE_NODES fake ones;
    the background pods go to the leader over HTTP; the LM pods are
    labels-only objects that pass the webhook and are created on the
    apiserver, and the bridge, the leader, configd and 5e's launcher do
    the rest. Then the leader is SIGKILLed: the standby takes over and
    places what follows. The tenants start with the env a kubelet builds
    from their pod objects. Last, the doctor checks the stack, and the
    follower is promoted once the leader registry stops."""
    import torch

    from kubeshare_tpu_torch import constants as C
    from kubeshare_tpu_torch.nodeagent.files import read_chip_clients
    from kubeshare_tpu_torch.scheduler.bridge import ServiceClient
    from kubeshare_tpu_torch.scheduler.webhook import resolve_downward_env
    from kubeshare_tpu_torch.telemetry.registry import RegistryClient
    from kubeshare_tpu_torch.telemetry.remote_write import RemoteWriter

    torch.cuda.empty_cache()
    t_phase = time.monotonic()
    node = _Node(root)
    chip = node.chip
    daemons: dict = {}
    api = writer = None
    out: dict = {"chip_id": chip.chip_id, "model": chip.model,
                 "stages_s": {}}

    def lap(stage):
        """Close a stage of 5i: its wall seconds since the last one."""
        done = sum(out["stages_s"].values())
        out["stages_s"][stage] = time.monotonic() - t_phase - done

    def start(label, args):
        daemons[label] = _start_daemon(root, node.base, label, args)

    def ready(label):
        return _wait_ready(daemons[label][1], f"the {label}")

    try:
        start("registry", ["kubeshare_tpu_torch.telemetry.registry",
                           "--host", "127.0.0.1", "--port", "0"])
        reg_port = int(ready("registry").split()[1])
        start("follower", ["kubeshare_tpu_torch.telemetry.registry",
                           "--host", "127.0.0.1", "--port", "0",
                           "--follower-of", f"127.0.0.1:{reg_port}",
                           "--replication-poll", str(PLACE_REPL_POLL_S)])
        follow_port = int(ready("follower").split()[1])
        registry_args = ["--registry-host", "127.0.0.1", "--registry-port",
                         str(reg_port)]
        node_args = [*registry_args, "--node", chip.host, "--backend",
                     "cuda"]
        start("collector", ["kubeshare_tpu_torch.telemetry.collector",
                            *node_args])
        start("configd", ["kubeshare_tpu_torch.nodeagent.configd",
                          *node_args, "--base-dir", node.base, "--period",
                          "0.1"])
        start("webhook", ["kubeshare_tpu_torch.scheduler.webhook",
                          "--port", "0"])
        for label in ("collector", "configd"):
            ready(label)
        rc = RegistryClient("127.0.0.1", reg_port)
        real = rc.capacity().get(chip.host, {})
        check(real.get("healthy") is True
              and [c["chip_id"] for c in real.get("chips", [])]
              == [chip.chip_id],
              f"5i: the collector published {real}, not {chip.chip_id}")
        check(chip.host in rc.leases()["leases"],
              "5i: the collector published no lease")
        fake = _fake_capacity(rc)
        urls = {}
        for holder in PLACE_SERVICES:
            start(holder, ["kubeshare_tpu_torch.scheduler.service",
                           *registry_args, "--host", "127.0.0.1", "--port",
                           "0", "--health", "--shards", str(PLACE_SHARDS),
                           "--shard-route", "cell", "--ha-ttl",
                           str(PLACE_HA_TTL_S), "--ha-holder", holder])
            urls[holder] = f"http://127.0.0.1:{ready(holder).split()[1]}"
            if holder == PLACE_SERVICES[0]:
                # the first leads, unfrozen, before the second contests
                _poll(lambda: (lambda st: st.get("role") == "leader"
                               and st.get("frozen") is False)(
                    ServiceClient(urls[holder]).ha()),
                    f"{holder}'s election", 30)
        lead_url, standby_url = (urls[h] for h in PLACE_SERVICES)
        api = FakeKubeApi()
        start("bridge", ["kubeshare_tpu_torch.scheduler.bridge",
                         "--service", f"{lead_url},{standby_url}",
                         "--kube-api", api.url])
        hook_port = int(ready("webhook").split()[1])
        ready("bridge")
        node.proxy_args = ["--remote-write", f"127.0.0.1:{reg_port}",
                           "--instance", f"proxy-{chip.host}",
                           "--push-period", str(PLACE_PUSH_S)]
        proxy_ready = node.start()
        # the launcher runs in this process: its remote write, as the
        # launcher's CLI starts it with --registry-host
        writer = RemoteWriter(rc, chip.host, "launcherd",
                              period_s=PLACE_PUSH_S).start()
        log(f"5i: registry on {reg_port}, its follower on {follow_port}, "
            f"services {lead_url} and {standby_url} ({PLACE_SHARDS} shards "
            f"each), webhook on {hook_port}, apiserver {api.url}; "
            f"collector, configd and bridge READY; launcher proxy "
            f"{proxy_ready}")
        client = ServiceClient(lead_url)
        standby = ServiceClient(standby_url)

        has = {h: _poll(lambda c=c: (lambda st: st if st.get("epoch")
                                     else None)(c.ha()), f"{h}'s /ha", 30)
               for h, c in zip(PLACE_SERVICES, (client, standby))}
        check([h["role"] for h in has.values()] == ["leader", "standby"]
              and all(h["epoch"] == 1 for h in has.values())
              and has[PLACE_SERVICES[0]]["frozen"] is False
              and has[PLACE_SERVICES[1]]["frozen"] is True,
              f"5i: GET /ha before the failover: {has}")
        out["ha_before"] = has
        instances = _poll(lambda: (lambda i: i if {
            chip.host, f"proxy-{chip.host}"} <= set(i) else None)({
                x["instance"]: x for x in rc.instances()["instances"]}),
            "the node's instances in /instances", 30)
        check(instances[chip.host]["job"] == "launcherd"
              and instances[f"proxy-{chip.host}"]["job"] == "chipproxy",
              f"5i: GET /instances: {instances}")
        log(f"5i: one leader, {PLACE_SERVICES[0]} at epoch 1, "
            f"{PLACE_SERVICES[1]} a frozen standby; /instances lists "
            f"{chip.host} (launcherd) and proxy-{chip.host} (chipproxy)")
        lap("start-up")

        def state():
            code, body = client.state()
            check(code == 200, f"5i: GET /state answered {code}")
            return body

        def invariants(when):
            inv = client.invariants()
            check(inv.get("ok") is True and inv.get("violations") == [],
                  f"5i: GET /invariants {when}: {inv}")
            return inv

        st = state()
        out["fleet"] = {"nodes": len(st["nodes"]),
                        "devices": len(st["leaves"])}
        check(len(st["leaves"]) == fake + 1,
              f"5i: the service sees {len(st['leaves'])} devices")
        from kubeshare_tpu_torch.scheduler.shard import ShardPlan
        plan = ShardPlan({n: [None] * PLACE_FAKE_DEVICES
                          if n != chip.host else [None]
                          for n in st["nodes"]}, PLACE_SHARDS)
        out["card_shard"] = plan.shard_of(chip.host)

        scrape0 = _phase_histograms(_http_metrics(lead_url))
        bg = out["background"] = _background_stream(client)
        bg["engine_phases"] = _phase_quantiles(
            scrape0, _phase_histograms(_http_metrics(lead_url)))
        out["invariants_after_background"] = invariants("after the "
                                                        "background")
        card = state()["leaves"][chip.chip_id]
        check(card["available"] == 1.0,
              f"5i: a background pod landed on the card: {card}")
        kinds = client.decisions().get("kinds", {})
        bg["cross_shard"] = {k: kinds.get(k, 0)
                             for k in ("gang-cross-shard", "shard-spill")}
        log(f"5i: service over {out['fleet']['nodes']} nodes, "
            f"{out['fleet']['devices']} devices, the card's node in shard "
            f"{out['card_shard']} of {PLACE_SHARDS}: {bg['submitted']} "
            f"background POST /schedule ({bg['refused']} unbound and "
            f"deleted, {bg['pending_pairs']} pairs the fleet cannot hold "
            f"left pending, {bg['gangs_bound_late']} gang pairs bound "
            f"after their Permit wait, {bg['bound_at_end']} bound at the "
            f"end; cross-shard: {bg['cross_shard']}): "
            f"round trip p50 {bg['rtt_us_p50']:.1f} us, p99 "
            f"{bg['rtt_us_p99']:.1f} us, {bg['pods_per_sec']:.1f} pods/s; "
            "engine phases in the service (p50 / p99 us, cycles): " + ", ".join(
                f"{p} {q['p50_us']:.1f} / {q['p99_us']:.1f} ({q['count']})"
                for p, q in bg["engine_phases"].items())
            + " (host numbers)")
        lap("background")

        # the follower registry holds what the leader holds
        frc = RegistryClient("127.0.0.1", follow_port)
        t0 = time.monotonic()
        _poll(lambda: _same_registry(rc, frc), "the follower to catch up",
              30, 0.02)
        repl = frc.replication()
        out["follower"] = {"catch_up_s": time.monotonic() - t0,
                           "lag_s": repl.get("lag_s"),
                           "cursor": repl.get("cursor"),
                           "head": repl.get("head"),
                           "rebases": repl.get("rebases"),
                           "pods": len(frc.pods())}
        check(repl.get("in_sync") is True and repl.get("role") == "follower",
              f"5i: the follower's /replication: {repl}")
        log(f"5i: the follower holds the leader's capacity, "
            f"{out['follower']['pods']} pod records and leases "
            f"{out['follower']['catch_up_s']:.3f} s after the background "
            f"(replication lag {repl.get('lag_s')} s at poll "
            f"{PLACE_REPL_POLL_S} s, cursor {repl.get('cursor')} of "
            f"{repl.get('head')})")
        lap("follower")

        labels = {C.POD_TPU_REQUEST: str(PLACE_REQUEST),
                  C.POD_TPU_LIMIT: "1.0", C.POD_TPU_MEMORY: str(PLACE_MEM),
                  C.POD_TPU_MODEL: chip.model}

        def create(name, pod_labels):
            """Admit a labels-only pod and create it on the apiserver;
            returns the creation's monotonic time."""
            admitted = _admit(hook_port, _labels_only_pod(name, pod_labels))
            check(admitted["spec"].get("schedulerName")
                  == C.SCHEDULER_NAME,
                  f"5i: the webhook left {name} to another scheduler")
            ns = name.partition("/")[0]
            t0 = time.monotonic()
            code, body = api.request("POST", f"/api/v1/namespaces/{ns}/pods",
                                     admitted)
            check(code == 201, f"5i: creating {name} answered {code}")
            return t0

        def bound_pod(name):
            pod = api.pods.get(name, {})
            return pod if pod.get("spec", {}).get("nodeName") else None

        def check_bound(name):
            pod = _poll(lambda: bound_pod(name), f"{name}'s binding", 30)
            ann = pod["metadata"].get("annotations", {})
            binds = [b for k, key, b in api.writes
                     if k == "bind" and key == name]
            check(pod["spec"]["nodeName"] == chip.host
                  and ann.get(C.POD_TPU_CHIP_ID) == chip.chip_id
                  and ann.get(C.POD_CELL_ID)
                  and binds and binds[-1]["target"]["name"] == chip.host,
                  f"5i: {name} was bound as {pod}, Binding {binds}")
            return pod, int(ann[C.POD_MANAGER_PORT])

        t_create, pods, ports = {}, {}, {}
        for name, _ in PLACE_TENANTS:
            t_create[name] = create(name, labels)
        ready_s = {}
        for name, _ in PLACE_TENANTS:
            pods[name], ports[name] = check_bound(name)
            line = _wait_ready(node.log(name), f"the pod manager of {name}")
            ready_s[name] = time.monotonic() - t_create[name]
            check(line == f"READY {ports[name]}",
                  f"5i: {name}'s manager says {line!r}, annotated port "
                  f"{ports[name]}")
        out["create_to_ready_s"] = ready_s
        check(len(set(ports.values())) == 2, f"5i: manager ports {ports}")
        entries = read_chip_clients(chip.chip_id, node.base)
        check(sorted((e.name, e.port, e.request) for e in entries)
              == sorted((n, p, PLACE_REQUEST) for n, p in ports.items()),
              f"5i: configd's file lists {entries}")
        log(f"5i: webhook + apiserver + bridge bound "
            f"{', '.join(f'{n} port {p}' for n, p in ports.items())} to "
            f"{chip.chip_id}; create to the manager's READY "
            + ", ".join(f"{n} {s:.3f} s" for n, s in ready_s.items()))

        envs = {}
        for name, pod in pods.items():
            envs[name] = resolve_downward_env(pod, pod["spec"]["containers"][0])
            check(envs[name].get(C.ENV_POD_MANAGER_PORT) == str(ports[name])
                  and envs[name].get(C.ENV_VISIBLE_CHIPS) == chip.chip_id
                  and envs[name].get(C.ENV_TPU_MEMORY) == str(PLACE_MEM),
                  f"5i: {name}'s env from its pod object is {envs[name]}")
        out["tenant_env"] = envs
        pair = node.run([(n, seed, ports[n], PLACE_REQUEST)
                         for n, seed in PLACE_TENANTS], PLACE_PAIR_S, True,
                        pod_envs=envs)
        for name, rec in pair.items():
            _check_tenant(name, rec, True, adam_per_step, layers)
        out["visible_devices"] = {n: r["visible"] for n, r in pair.items()}
        entries_ = [(n, seed, PLACE_REQUEST) for n, seed in PLACE_TENANTS]
        reading = out["pair"] = pair_reading(pair, entries_)
        check_pair("5i", reading)
        out["launches"] = {k: sum(r["launches"][k] for r in pair.values())
                           for k in _counts()}
        log(f"5i: tenants' steps/s over the common window "
            f"({reading['window_s']:.2f} s): " + ", ".join(
                f"{n} {r:.3f}" for n, r in
                reading["steps_per_sec"].items())
            + f"; {PLACE_TENANTS[0][0]} held "
            f"{reading['lifetime_held_share_a']:.4f} of the token over its "
            f"life, {reading['share_a']:.4f} of the window's steps")

        # the proxy's grant waits reached the registry's fleet store
        grant = _poll(lambda: rc.query(
            "kubeshare_token_grant_wait_seconds", agg="quantile", q=0.99,
            window_s=60.0,
            matchers={"instance": f"proxy-{chip.host}"}).get("groups"),
            "the proxy's grant waits in GET /query", 30, 0.2)
        out["grant_wait_query"] = grant
        log(f"5i: GET /query kubeshare_token_grant_wait_seconds p99 over "
            f"proxy-{chip.host}'s remote-written series: {grant}")
        lap("tenants")

        # the leader dies: the standby takes over at the next epoch
        lead_proc, _ = daemons.pop(PLACE_SERVICES[0])
        t_kill = time.monotonic()
        lead_proc.kill()
        lead_proc.wait()
        # the takeover is done when the new leader has unfrozen
        ha_after = _poll(lambda: (lambda st: st if st.get("role") == "leader"
                                  and st.get("frozen") is False
                                  else None)(standby.ha()),
                         f"{PLACE_SERVICES[1]}'s takeover", 60, 0.05)
        out["failover_s"] = time.monotonic() - t_kill
        check(ha_after["epoch"] == 2 and ha_after["frozen"] is False
              and ha_after["takeovers"] == 1,
              f"5i: GET /ha after the failover: {ha_after}")
        out["ha_after"] = ha_after
        client = standby
        inv_b = invariants("after the failover")
        for name, _ in PLACE_TENANTS:
            ns, _, pod_name = name.partition("/")
            st_ = client.status(ns, pod_name)[1]
            check(st_.get("status") == "bound" and st_.get("node")
                  == chip.host, f"5i: {name} on {PLACE_SERVICES[1]} after "
                                f"the failover: {st_}")
        check(rc.leader("scheduler")["holder"] == PLACE_SERVICES[1],
              f"5i: the lease after the failover: "
              f"{rc.leader('scheduler')}")
        log(f"5i: SIGKILL of {PLACE_SERVICES[0]} to {PLACE_SERVICES[1]} "
            f"holding leader:scheduler at epoch 2, unfrozen: "
            f"{out['failover_s']:.3f} s (lease TTL {PLACE_HA_TTL_S} s, "
            f"election every {PLACE_HA_TTL_S / 3:.2f} s); /invariants ok "
            f"with {inv_b.get('bound')} bound, both LM pods among them")
        lap("failover")

        # a third 0.5 pod and one over the card's memory stay pending
        t_third = create(PLACE_THIRD, labels)
        create("smoke/too-big", dict(
            labels, **{C.POD_TPU_MEMORY: str(chip.memory + 1)}))
        refusals = {}
        for name in (PLACE_THIRD, "smoke/too-big"):
            ns, _, pod_name = name.partition("/")
            st_ = _poll(lambda: (lambda s: s if s.get("status") == "pending"
                                 and s.get("reason") else None)(
                client.status(ns, pod_name)[1]), f"{name}'s refusal", 30)
            refusals[name] = st_["reason"]
        out["third_refused"] = refusals[PLACE_THIRD]
        out["too_big_refused"] = refusals["smoke/too-big"]
        time.sleep(1.5)             # past a retry: still nothing bound
        check(bound_pod(PLACE_THIRD) is None
              and bound_pod("smoke/too-big") is None,
              "5i: a pod past the card's share or memory was bound")
        api.request("DELETE", "/api/v1/namespaces/smoke/pods/too-big")

        gone, kept = (n for n, _ in PLACE_TENANTS)
        proc = node.launcher._managers[(chip.chip_id, gone)][1]
        t0 = time.monotonic()
        ns, _, pod_name = gone.partition("/")
        code, _ = api.request("DELETE",
                              f"/api/v1/namespaces/{ns}/pods/{pod_name}")
        check(code == 200, f"5i: deleting {gone} answered {code}")
        _poll(lambda: proc.poll() is not None and (
            chip.chip_id, gone) not in node.launcher._managers,
            f"the stop of {gone}'s manager", 30)
        out["delete_to_stop_s"] = time.monotonic() - t0
        pods[PLACE_THIRD], ports[PLACE_THIRD] = check_bound(PLACE_THIRD)
        line = _wait_ready(node.log(PLACE_THIRD),
                           f"the pod manager of {PLACE_THIRD}")
        out["delete_to_third_ready_s"] = time.monotonic() - t0
        check(line == f"READY {ports[PLACE_THIRD]}",
              f"5i: {PLACE_THIRD}'s manager says {line!r}")
        creates = [k for k, key, _ in api.writes
                   if k == "create" and key == PLACE_THIRD]
        check(len(creates) == 1, f"5i: {PLACE_THIRD} was created "
                                 f"{len(creates)} times")
        invariants("after the delete")
        log(f"5i: a third 0.5 pod stayed pending ({out['third_refused']!r}) "
            f"and one of {chip.memory + 1} bytes too "
            f"({out['too_big_refused']!r}); deleting {gone} on the "
            f"apiserver stopped its manager in "
            f"{out['delete_to_stop_s']:.3f} s, and the third pod, never "
            f"resubmitted, bound by the dispatcher's retry and the "
            f"bridge's poll: its manager READY on port "
            f"{ports[PLACE_THIRD]} {out['delete_to_third_ready_s']:.3f} s "
            f"after the delete ({t0 - t_third:.1f} s after its creation)")
        lap("refusals, delete, third")

        # the node's only lease beater dies: SIGKILL, so nothing withdraws
        managers = [node.launcher._managers[(chip.chip_id, n)][1]
                    for n in (kept, PLACE_THIRD)]
        collector, _ = daemons.pop("collector")
        t_kill = time.monotonic()
        collector.kill()
        collector.wait()
        seen: dict = {}

        def health_state():
            h = client.health()
            st_ = h["nodes"].get(chip.host, {}).get("state")
            if st_ and st_ not in seen:
                seen[st_] = time.monotonic() - t_kill
            return h if st_ == "dead" else None

        health = _poll(health_state, f"{chip.host} declared dead", 90, 0.2)
        t_dead = t_kill + seen["dead"]
        check("suspect" in seen and seen["suspect"] < seen["dead"],
              f"5i: {chip.host} went {seen} after the collector's kill")
        _poll(lambda: read_chip_clients(chip.chip_id, node.base) == [],
              "configd's empty file", 30)
        _poll(lambda: all(p.poll() is not None for p in managers),
              "the evicted pods' managers to stop", 30)
        out["kill_to_suspect_s"] = seen["suspect"]
        out["kill_to_dead_s"] = seen["dead"]
        out["dead_to_stop_s"] = time.monotonic() - t_dead
        for name in (kept, PLACE_THIRD):
            ns, _, pod_name = name.partition("/")
            st_ = client.status(ns, pod_name)[1]
            check(st_.get("status") == "pending"
                  and st_.get("evicted_from") == chip.host,
                  f"5i: {name} after the node's death: {st_}")
        check(health["evicted_total"] >= 2
              and chip.host in health["quarantined"],
              f"5i: GET /health after the death: {health}")
        check(not any(k.startswith("smoke/") for k in rc.pods()),
              "5i: the evicted pods' records were not withdrawn")
        out["health"] = health
        invariants("after the node's death")
        log(f"5i: SIGKILL of the collector (the node's lease) to "
            f"{chip.host} suspect {out['kill_to_suspect_s']:.3f} s, dead "
            f"{out['kill_to_dead_s']:.3f} s; {health['evicted_total']} pods "
            f"evicted and requeued, records withdrawn, configd's file "
            f"empty and both managers stopped "
            f"{out['dead_to_stop_s']:.3f} s after the death")

        # a fresh collector beats the node again; its SIGTERM withdraws
        # the capacity and the lease (the quarantine keeps pods off)
        start("collector", ["kubeshare_tpu_torch.telemetry.collector",
                            *node_args])
        ready("collector")
        lease = rc.leases()["leases"].get(chip.host, {})
        check(rc.capacity().get(chip.host, {}).get("healthy") is True
              and lease.get("age_s", 1e9) < lease.get("ttl_s", 0),
              f"5i: the fresh collector published no live lease: {lease}")
        proc_d, log_d = daemons.pop("collector")
        _stop_daemon(proc_d, "collector", log_d)
        check(chip.host not in rc.capacity()
              and chip.host not in rc.leases()["leases"],
              "5i: the stopped collector left its capacity or lease")
        log("5i: a fresh collector's SIGTERM: rc 0, the node's capacity "
            "and lease withdrawn")
        lap("node death, fresh collector")

        # the doctor, chip check on, over the registry and the new leader
        out["doctor"] = _doctor(root, node.base, f"127.0.0.1:{reg_port}",
                                standby_url.partition("://")[2])
        log(f"5i: the doctor exited 0 in {out['doctor']['seconds']:.2f} s: "
            + "; ".join(out["doctor"]["lines"]))
        lap("doctor")

        writer.stop()
        writer = None
        lead_pods = rc.pods()
        for label in ("bridge", "webhook", PLACE_SERVICES[1], "configd",
                      "registry"):
            proc_d, log_d = daemons.pop(label)
            _stop_daemon(proc_d, label, log_d)
        # the leader registry is gone: SIGHUP promotes its follower
        follower, follow_log = daemons["follower"]
        follower.send_signal(signal.SIGHUP)
        t_hup = time.monotonic()

        def promoted():
            try:
                frc.put_lease("promoted-probe", 1)
            except Exception:
                return None
            return frc.leases()["leases"].get("promoted-probe")

        _poll(promoted, "a write to the promoted follower", 30, 0.05)
        out["promote_s"] = time.monotonic() - t_hup
        check(frc.replication().get("role") != "follower"
              and frc.pods() == lead_pods,
              f"5i: the promoted follower: {frc.replication()}, "
              f"{len(frc.pods())} pod records, the leader's last "
              f"{len(lead_pods)}")
        daemons.pop("follower")
        _stop_daemon(follower, "follower", follow_log)
        log(f"5i: the leader registry stopped; SIGHUP promoted its "
            f"follower, which took a write {out['promote_s']:.3f} s later "
            f"and holds the leader's {len(lead_pods)} pod records")
        lap("stop, promote")
        out["wall_s"] = time.monotonic() - t_phase
        log(f"5i: {out['wall_s']:.1f} s in all; by stage: " + ", ".join(
            f"{k} {v:.1f}" for k, v in out["stages_s"].items()))
    finally:
        if writer is not None:
            writer.stop()
        for proc, _ in daemons.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        if api is not None:
            api.close()
        node.stop()
    return out


def _doctor(root: str, base: str, registry: str, scheduler: str) -> dict:
    """``python -m kubeshare_tpu_torch.doctor`` with its chip check on, as
    an operator runs it on the node; fails 5i unless it exits 0."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KUBESHARE_TPU_")}
    env["PYTHONPATH"] = root
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "kubeshare_tpu_torch.doctor", "--registry",
         registry, "--scheduler", scheduler, "--base-dir", base],
        capture_output=True, text=True, timeout=240, env=env, cwd=root)
    lines = [line for line in proc.stdout.splitlines() if line.strip()]
    check(proc.returncode == 0,
          f"5i: the doctor exited {proc.returncode}: "
          + "; ".join(line for line in lines if " fail " in line)
          + f" {proc.stderr[-2000:]}")
    check(any(line.split()[:2] == ["chip", "ok"] for line in lines)
          and any(line.split()[:2] == ["ha", "ok"] for line in lines),
          f"5i: the doctor's chip or ha check: {lines}")
    return {"seconds": time.monotonic() - t0, "lines": lines}


# --- phase 5j: the zoo -----------------------------------------------------------

def _zoo_model(label: str):
    """``(module, init_fn, loss_fn)`` of one of ZOO's models."""
    from kubeshare_tpu_torch.models import get_model

    _, name, kw, loss = next(z for z in ZOO if z[0] == label)
    mod = get_model(name)
    return mod, partial(mod.init, **kw), getattr(mod, loss)


def zoo_step_check(dev, label: str) -> dict:
    """One train step of the full-width model on ZOO_CHECK_ROWS rows with
    fp32 activations, on the card against the CPU from the same params,
    held as ZOO says."""
    mod, init_fn, loss_fn = _zoo_model(label)
    batch = tuple(a[:ZOO_CHECK_ROWS] for a in mod.batch_fn(8))
    return card_vs_cpu_step(dev, f"5j {label}", mod, init_fn(7), batch,
                            loss_fn, 0.0, ZOO_FIRM_G, ZOO_FIRM_ATOL,
                            grad_rtol=ZOO_GRAD_RTOL)


def _trace_summary(trace_dir: str, steps: int) -> dict:
    """Device ms a step (kernels, copies and memsets), kernels a step and
    the port's kernels' launches a step, from the chrome trace that
    ``run_training``'s profiler wrote into ``trace_dir``."""
    import glob

    (path,) = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    tags = {"fused_adam": "adam_multi_tensor_kernel",
            "flash_fwd": "flash_fwd_", "flash_dq": "flash_dq_",
            "flash_dkv": "flash_dkv_"}
    return {"device_ms": sum(e.get("dur", 0.0) for e in device) / 1e3
            / steps,
            "kernels": len(kernels) / steps,
            "ours": {k: sum(tag in n for n in kernels) / steps
                     for k, tag in tags.items()},
            "trace_bytes": os.path.getsize(path)}


def zoo_run(dev, label: str, trace_dir: str) -> dict:
    """The model alone on the card through ``run_training``: ZOO_STEPS
    timed steps (steps/s, wall ms a step), then ZOO_PROFILE_STEPS under
    its profiler (device ms, idle share and kernels a step)."""
    from kubeshare_tpu_torch.models import common

    mod, init_fn, loss_fn = _zoo_model(label)
    res = common.run_training(init_fn, loss_fn, mod.batch_fn,
                              steps=ZOO_STEPS, device=dev)
    check(math.isfinite(res.final_loss) and res.final_loss < res.first_loss,
          f"5j {label}: loss {res.first_loss} -> {res.final_loss}")
    prof = common.run_training(init_fn, loss_fn, mod.batch_fn,
                               steps=ZOO_PROFILE_STEPS, device=dev,
                               profile_dir=trace_dir)
    check(math.isfinite(prof.final_loss), f"5j {label}: profiled loss")
    trace = _trace_summary(trace_dir, ZOO_PROFILE_STEPS)
    wall_ms = 1e3 / res.steps_per_sec
    return {"steps_per_sec": res.steps_per_sec, "wall_ms": wall_ms,
            "first_loss": res.first_loss, "final_loss": res.final_loss,
            "device_ms": trace["device_ms"],
            "device_idle_share": max(0.0, 1.0 - trace["device_ms"] / wall_ms),
            "kernels_per_step": trace["kernels"],
            "ours_per_step": trace["ours"],
            "trace_bytes": trace["trace_bytes"],
            "steps_run": ZOO_STEPS + ZOO_PROFILE_STEPS + 2 * res.warmup_steps}


def _final_loss(text: str) -> float:
    return float(text.rsplit("final loss", 1)[1].split()[0])


def sweep_phase(root: str) -> dict:
    """5j-cli, the resumable sweep pod: cifar10's CLI at full width with
    ``--checkpoint DIR --checkpoint-every SWEEP_EVERY``, a gate-mode
    tenant of 5e's node path (launcher, proxy, pod manager; attached only
    by the shim). It is SIGKILLed once its first save is promoted, then
    started again with the same arguments, while an uninterrupted run of
    the same seed goes beside it (ungated). It must restore the saved
    step, skip the warm-up, run the SWEEP_STEPS - saved steps left, end
    at SWEEP_STEPS with the uninterrupted run's Adam count, and end on
    its final loss (and its params on their held-out loss)."""
    import numpy as np
    import torch

    from kubeshare_tpu_torch.isolation import protocol
    from kubeshare_tpu_torch.models import checkpoint as ck
    from kubeshare_tpu_torch.models import cifar10, common
    from kubeshare_tpu_torch.ops.fused_adam import fused_adam
    from kubeshare_tpu_torch.utils.tree import tree_leaves

    name, request = SWEEP_POD
    node = _Node(root)
    out: dict = {"stages_s": {}}
    t_phase = time.monotonic()

    def lap(stage):
        out["stages_s"][stage] = (time.monotonic() - t_phase
                                  - sum(out["stages_s"].values()))

    def launch(label: str, ckpt: str, gated: bool = True):
        ports = node.clients([(name, request)]) if gated else {name: 0}
        cmd = [sys.executable, "-m", "kubeshare_tpu_torch.models.cifar10",
               "--steps", str(SWEEP_STEPS), "--checkpoint", ckpt,
               "--checkpoint-every", str(SWEEP_EVERY)]
        with open(node.log(f"sweep-{label}"), "w") as log_file:
            return subprocess.Popen(
                cmd, env=node.tenant_env(name, ports[name], request, gated),
                cwd=root, stdout=log_file, stderr=subprocess.STDOUT)

    def finish(label: str, proc) -> str:
        rc = proc.wait(timeout=600)
        text = _tail(node.log(f"sweep-{label}"), 20000)
        check(rc == 0, f"5j-cli {label} run exited {rc}: {text[-3000:]}")
        return text

    ck_root = tempfile.mkdtemp(prefix="kubeshare-sweep-")
    full_ck = os.path.join(ck_root, "full")
    kill_ck = os.path.join(ck_root, "killed")
    like = common.to_device(cifar10.init(0), "cpu")
    like = (like, fused_adam().init(like))
    full = proc = None
    try:
        node.start()
        lap("start")
        full = launch("full", full_ck, gated=False)
        proc = launch("killed", kill_ck)
        deadline = time.monotonic() + 300
        while not os.path.isdir(kill_ck):
            check(proc.poll() is None and time.monotonic() < deadline,
                  f"5j-cli: no promoted save: "
                  f"{_tail(node.log('sweep-killed'))}")
            time.sleep(0.01)
        conn = protocol.Connection("127.0.0.1", node.token_port)
        conn.call({"op": "attach", "name": name})
        charged = conn.call({"op": "usage"})[0]["used_ms"]
        conn.close()
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
        check(charged > 0, f"5j-cli: the tenant was not gated ({charged})")
        _, _, saved = ck.load_checkpoint(kill_ck, *like)
        check(0 < saved < SWEEP_STEPS and saved % SWEEP_EVERY == 0,
              f"5j-cli: the killed run saved step {saved}")
        full_text = finish("full", full)
        lap("killed and uninterrupted")
        proc = launch("resumed", kill_ck)
        text = finish("resumed", proc)
        lap("resumed")
        managers = dict(node.managers)
        p, s, at = ck.load_checkpoint(kill_ck, *like)
        fp, fs, fat = ck.load_checkpoint(full_ck, *like)
    finally:
        for run in (full, proc):
            if run is not None and run.poll() is None:
                run.kill()
                run.wait()
        node.stop()
        shutil.rmtree(ck_root, ignore_errors=True)
    check(f"cifar10: resumed at step {saved} from {kill_ck}, 0 warm-up "
          f"steps" in text, f"5j-cli: no resume from {saved}: {text}")
    check(f"cifar10: {SWEEP_STEPS - saved} steps in" in text,
          f"5j-cli: not {SWEEP_STEPS - saved} timed steps: {text}")
    check(f"cifar10: {SWEEP_STEPS} steps in" in full_text,
          f"5j-cli: the uninterrupted run: {full_text}")
    check(at == fat == SWEEP_STEPS, f"5j-cli: final steps {at}, {fat}")
    # the warm-up steps update too: a resume that ran them again would
    # end with a larger count
    count, full_count = float(s["count"]), float(fs["count"])
    check(count == full_count == SWEEP_STEPS + 2,
          f"5j-cli: Adam counts {count}, {full_count}")
    loss, full_loss = _final_loss(text), _final_loss(full_text)
    check(abs(loss - full_loss) <= SWEEP_LOSS_RTOL * abs(full_loss),
          f"5j-cli: final loss {loss} against uninterrupted {full_loss}")
    param_err = max(float(np.abs((a - b).numpy()).max())
                    for a, b in zip(tree_leaves(p), tree_leaves(fp)))
    check(param_err <= SWEEP_PARAM_ATOL,
          f"5j-cli: final params {param_err} apart from the uninterrupted "
          f"run's")
    # both final params on a batch neither trained on (fp32, on the CPU)
    held_out = common.to_device(cifar10.batch_fn(2), "cpu")
    saved_dtype = cifar10.DTYPE
    cifar10.DTYPE = torch.float32
    try:
        held = [float(cifar10.loss_fn(params, held_out)) for params in (p, fp)]
    finally:
        cifar10.DTYPE = saved_dtype
    check(abs(held[0] - held[1]) <= SWEEP_HELD_RTOL * abs(held[1]),
          f"5j-cli: held-out loss {held[0]} against uninterrupted "
          f"{held[1]}")
    out.update(saved_step=saved, resumed_steps=SWEEP_STEPS - saved,
               final_loss=loss, uninterrupted_final_loss=full_loss,
               held_out_loss=held[0], uninterrupted_held_out_loss=held[1],
               adam_count=count, param_max_abs_diff=param_err,
               charged_ms_at_kill=charged, manager=managers.get(name),
               seconds=time.monotonic() - t_phase)
    return out


def zoo_phase(root: str, dev, rng) -> dict:
    """Phase 5j: each ZOO model's card-vs-CPU step, its whole tree through
    the Adam kernel against the plain version, its exclusive and profiled
    runs (launch counts reset before each model and read after), then
    the resumable sweep through a node. Returns every reading, the
    launches of the in-process runs and the seconds by stage."""
    import torch

    from kubeshare_tpu_torch.ops import fused_adam as fa
    from kubeshare_tpu_torch.utils.tree import tree_leaves

    t0 = time.monotonic()
    out: dict = {"models": {}, "stages_s": {},
                 "launches": {k: 0 for k in _counts()}}
    trace_root = tempfile.mkdtemp(prefix="kubeshare-zoo-")
    try:
        for label, name, _, _ in ZOO:
            t_model = time.monotonic()
            mod, init_fn, _ = _zoo_model(label)
            leaves = tree_leaves(init_fn(0))
            rec = {"leaves": len(leaves),
                   "params": int(sum(a.size for a in leaves)),
                   "adam_per_step": fa.tree_launches(leaves)}
            rec["step_check"] = zoo_step_check(dev, label)
            _, rec["adam_max_abs_err"] = adam_tree_check(dev, rng, label,
                                                         leaves)
            torch.cuda.empty_cache()
            _reset_counts()
            rec.update(zoo_run(dev, label, os.path.join(trace_root, label)))
            got = _counts()
            ran = rec["steps_run"]
            want = {"fused_adam": rec["adam_per_step"] * ran}
            if name == "transformer":
                want.update({f"flash_{k}": mod.LAYERS * ran
                             for k in ("fwd", "dq", "dkv")})
            for kernel in out["launches"]:
                check(got[kernel] == want.get(kernel, 0),
                      f"5j {label}: {got[kernel]} {kernel} launches, "
                      f"expected {want.get(kernel, 0)}")
                out["launches"][kernel] += got[kernel]
            per_step = {k: n // ran for k, n in want.items()}
            check(all(abs(rec["ours_per_step"][k] - n) < 1e-9
                      for k, n in per_step.items()),
                  f"5j {label}: the trace's launches a step "
                  f"{rec['ours_per_step']}, expected {per_step}")
            rec["launches"] = got
            out["models"][label] = rec
            out["stages_s"][label] = time.monotonic() - t_model
            log(f"5j {label}: {json.dumps(rec)}")
        # the multi-table launch timed: 140 leaves, three launches
        t_adam = time.monotonic()
        out["adam_resnet50"] = adam_timing(
            dev, rng, _zoo_model("resnet50")[1], ZOO_ADAM_ITERS)
        out["stages_s"]["adam_resnet50"] = time.monotonic() - t_adam
    finally:
        shutil.rmtree(trace_root, ignore_errors=True)
    out["sweep"] = sweep_phase(root)
    out["stages_s"]["sweep"] = out["sweep"]["seconds"]
    out["seconds"] = time.monotonic() - t0
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="chip_smoke.py")
    parser.add_argument("--out", default="",
                        help="also write every phase's numbers here (JSON)")
    parser.add_argument("--tenant", default="",
                        help="run as a tenant of the gate pair, writing its "
                             "record here (JSON)")
    parser.add_argument("--compiled", action="store_true",
                        help="as a tenant, wrap the train step in "
                             "torch.compile (the proxy pair's tenants)")
    parser.add_argument("--seconds", type=float, default=GATE_SOLO_S)
    parser.add_argument("--steps", type=int, default=0,
                        help="as a tenant, train exactly this many steps")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    if args.tenant and args.compiled:
        # a proxy-mode tenant has no CUDA device of its own: the attach
        # hid them all, and its compiled step runs on the proxy
        return tenant(args.tenant, args.seconds, args.seed, True,
                      args.steps)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from kubeshare_tpu_torch.models import mnist, transformer
        from kubeshare_tpu_torch.ops import flash_attention as fl
        from kubeshare_tpu_torch.ops import fused_adam as fa
    except ImportError as e:
        print(f"chip_smoke: the kubeshare_tpu_torch package is missing "
              f"({e}); run from the root of a checkout", file=sys.stderr)
        return 2
    if args.tenant:
        return tenant(args.tenant, args.seconds, args.seed, False)
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
    for name in FLASH_MMA_KERNELS:
        # one function per head dim and cp.async or plain loads
        found = {k: n for k, n in mma.items() if k.startswith(name + "I")}
        check(len(found) == 2 * len(fl.HEAD_DIMS) and all(found.values()),
              f"{name} lacks tensor-core instructions: {mma}")
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
    log(f"flash dq+dkv {flash['dq']['ms'] + flash['dkv']['ms']:.4f} ms, "
        f"sdpa backward {flash['library_ms']['bwd']:.4f} ms")
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
        f"{long['library_ms']['fwd_bwd']:.3f} ms; dq+dkv "
        f"{long['dq']['ms'] + long['dkv']['ms']:.3f} ms")
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

    # the gate pair: tenant processes, each counting its own launches
    gate = gate_phase(root, adam_launches["transformer"], transformer.LAYERS)
    log(f"gate: pod managers {gate['managers']}, tenants' visible devices "
        f"{gate['visible_devices']}, steps {gate['steps']}")
    log("gate: exclusive steps/s in order: ungated "
        + ", ".join(f"{r:.3f}" for r in gate["solo_steps_per_sec"]["ungated"])
        + "; gated " + ", ".join(
            f"{r:.3f}" for r in gate["solo_steps_per_sec"]["gated"])
        + f"; gated/ungated exclusive ratio {gate['gated_over_ungated']:.4f}")
    log("gate: the gated exclusive runs were charged " + ", ".join(
        f"{c:.1f}" for c in gate["solo_charged_ms_per_window"])
        + f" ms per {WINDOW_MS:.0f} ms window; per step " + "; ".join(
            _fmt_gate(g) for g in gate["solo_gate_per_step"]))
    for kind, reading in gate["pairs"].items():
        log_pair(kind, reading)
    log(f"gate launches: {gate['launches']}")
    phases["gate"] = gate
    for k in launches:
        launches[k] += gate["launches"][k]

    # the proxy-mode pair: tenant processes with no CUDA device, their
    # compiled steps run on a proxy in this process, counted here
    prox = proxy_phase(root, dev, adam_launches["transformer"],
                       transformer.LAYERS)
    excl_rate = phases["transformer"]["exclusive"]["plain_steps_per_sec"]
    prox["lone_over_exclusive"] = prox["lone_steps_per_sec"] / excl_rate
    log(f"proxy: lone tenant {prox['lone_steps_per_sec']:.3f} steps/s, "
        f"/ 5c exclusive eager {excl_rate:.3f} = "
        f"{prox['lone_over_exclusive']:.4f}")
    for kind, pr in prox["pairs"].items():
        (a, req_a), (b, req_b) = pr["requests"].items()
        log(f"proxy pair {kind} ({a} {req_a}, {b} {req_b}): steps/s over "
            f"the common window ({pr['window_s']:.2f} s): " + ", ".join(
                f"{n} {r:.3f}" for n, r in pr["steps_per_sec"].items())
            + f"; aggregate / lone {pr['aggregate_over_lone']:.4f}; "
            f"share a {pr['share_a']:.4f} (wanted {pr['share_wanted']:.2f}, "
            f"error {pr['share_error_pct']:.2f}%); charged ms per "
            f"{WINDOW_MS:.0f} ms window " + ", ".join(
                f"{n} {c:.1f}" for n, c in
                pr["charged_ms_per_window"].items())
            + f" (share {pr['charged_share_a']:.4f}); {a} charged "
            f"{pr['lifetime_charged_share_a']:.4f} of the token over its "
            f"life")
    log("proxy compile (blob bytes, trace+export s, compile round trip "
        "incl. the proxy's load s): " + "; ".join(
            f"{n} {c['blob_nbytes']} B, {c['export_s']:.2f} s, "
            f"{c['compile_s']:.2f} s" for n, c in prox["compile"].items())
        + "; first step s (process start to its end): " + ", ".join(
            f"{n} {v:.2f}" for n, v in prox["first_step_s"].items()))
    log("proxy: in this process, wall ms a step (loss read each step), "
        "eager vs the exported step: " + "; ".join(
            f"{k} " + ", ".join(f"{v:.3f}" for v in vs)
            for k, vs in prox["in_process_step_ms"].items())
        + "; tenants on the pipelined wire, wall ms a step / the proxy's "
        "execution ms a step (device lock to barrier) / forwarding ms / "
        "first execution ms / gaps between steps p50, p90 ms (the "
        "lockstep wire: 5.7-12.2 ms of forwarding on one H100): "
        + "; ".join(
            f"{n} {v['wall_ms']:.3f} / {v['proxy_exec_ms']:.3f} / "
            f"{v['forwarding_ms']:.3f} / {v['first_exec_ms']:.1f} / "
            f"{v.get('gap_p50_ms', float('nan')):.3f}, "
            f"{v.get('gap_p90_ms', float('nan')):.3f}"
            for n, v in prox["per_step"].items()))
    log(f"proxy first losses {prox['lone_first_losses']} vs eager "
        f"{prox['eager_first_losses']}; steps {prox['steps']}; launches "
        f"{prox['launches']}")
    phases["proxy"] = prox
    for k in launches:
        launches[k] += prox["launches"][k]

    # the proxy survives and streams: the looped step, then a tenant
    # through a proxy crash and a live migration, counted here
    per_step = _launches_per_step(adam_launches["transformer"],
                                  transformer.LAYERS)
    g_loop = _loop_phase(dev, per_step)
    log(f"5g-loop: compile_loop over the exported LM step: "
        f"{g_loop['steps']} chained steps in bursts {g_loop['bursts']}, "
        f"{g_loop['steps_per_sec']:.3f} steps/s, the proxy's execution "
        f"{g_loop['proxy_exec_ms_per_step']:.3f} ms a step; every burst's "
        f"loss equals the one-call step's ({len(g_loop['chained'])} "
        f"checked, {RESUME_STEPS} one-call steps); compile "
        f"{g_loop['compile_s']:.2f} s; launches {g_loop['launches']}")
    g_res = resume_phase(root, dev, per_step, g_loop["one_call_losses"])
    log(f"5g-crash: {g_res['journaled_steps']} journaled steps at "
        f"{g_res['journaled_steps_per_sec']:.3f} steps/s "
        f"({g_res['journal_bytes_per_step']:.0f} journal bytes a step, "
        f"{g_res['journal_bytes_on_disk']} on disk), crash to the first "
        f"step after resume {g_res['resume_s']:.3f} s (restore "
        f"{g_res['restore_s']:.3f} s); tenant resumes "
        f"{g_res['transport']['resumes']}, requests replayed "
        f"{g_res['transport']['replayed']}, answered from the reply cache "
        f"{g_res['replays_served']}; the proxies' resume counter rose by "
        f"{g_res['obs']['resumes_counted']}, flight notes "
        f"{g_res['obs']['notes']}")
    log(f"5g-migrate: {g_res['migrate_bytes']} bytes moved in "
        f"{g_res['migrate_s']:.3f} s, move to the first step after it "
        f"{g_res['move_to_first_step_s']:.3f} s; unjournaled "
        f"{g_res['unjournaled_steps_per_sec']:.3f} steps/s; executions "
        f"per proxy {g_res['executions']} for {RESUME_STEPS} steps; "
        f"{RESUME_STEPS} losses equal the uncrashed, unmoved run's; "
        f"launches {g_res['launches']}")
    phases["resilience"] = {"loop": g_loop, "resume": g_res}
    for k in launches:
        launches[k] += g_loop["launches"][k] + g_res["launches"][k]

    # latency-class serving beside a best-effort trainer, counted here
    h = serve_phase(dev, per_step, g_loop["one_call_losses"])
    log(f"5h: serving {SERVE_RATE:.0f} requests/s offered by "
        f"{len(SERVE_TENANTS)} senders (2 latency, 2 best-effort), "
        f"ContinuousBatcher(max_batch={SERVE_MAX_BATCH}, max_wait "
        f"{SERVE_MAX_WAIT_S * 1e3:.0f} ms) over a ProxyServable (tinymlp "
        f"8 x 32, latency); trainer: the full-width LM in chains of "
        f"{SERVE_CHAIN} steps (best-effort); policy grace "
        f"{PREEMPT_GRACE_MS} ms, min hold {PREEMPT_MIN_HOLD_MS} ms; set-up "
        f"{h['setup_s']:.2f} s")
    for r in h["runs"].values():
        log(_fmt_serve_run(r))
        log(_fmt_serve_obs(r))
    log("5h: the scheduler's hooks, host us an acquire / execute / "
        "release cycle of a lone client: " + ", ".join(
            f"{k} {v:.2f}" for k, v in h["hook_us"].items()))
    phases["serving"] = h
    for k in launches:
        launches[k] += h["launches"][k]

    # a pod from its labels to the card: the placement path's daemons as
    # processes, the engine here; the tenants count their own launches
    place = place_phase(root, adam_launches["transformer"],
                        transformer.LAYERS)
    log(f"5i: launches {place['launches']}; visible devices "
        f"{place['visible_devices']}; refusals: third pod "
        f"{place['third_refused']!r}; too big {place['too_big_refused']!r}")
    phases["placement"] = place
    for k in launches:
        launches[k] += place["launches"][k]

    # the zoo: the JAX package's other workload models at full width, in
    # this process, then the resumable sweep's CLI through a node
    zoo = zoo_phase(root, dev, rng)
    for label, rec in zoo["models"].items():
        log(f"5j {label} ({rec['leaves']} leaves, {rec['params']} params, "
            f"{rec['adam_per_step']} Adam launch(es) a step): card vs cpu "
            f"step: loss {rec['step_check']['loss_cuda']:.6f} / "
            f"{rec['step_check']['loss_cpu']:.6f}, grads max abs err "
            f"{rec['step_check']['grad_max_abs_err']:.3e} (largest |g| "
            f"{rec['step_check']['grad_max_abs']:.3g}, bound "
            f"{rec['step_check']['grad_bound']:.3e}), firm params "
            f"{rec['step_check']['param_max_abs_err_firm']:.3e}; Adam "
            f"kernel vs plain {rec['adam_max_abs_err']:.3e}; exclusive "
            f"{rec['steps_per_sec']:.3f} steps/s, wall "
            f"{rec['wall_ms']:.3f} ms a step, device "
            f"{rec['device_ms']:.3f} ms, idle "
            f"{100 * rec['device_idle_share']:.1f}%, "
            f"{rec['kernels_per_step']:.1f} kernels a step; loss "
            f"{rec['first_loss']:.4f} -> {rec['final_loss']:.4f}; launches "
            f"{rec['launches']}")
    r = zoo["adam_resnet50"]
    log(f"5j fused_adam over the resnet50 tree ({r['params']} params, "
        f"{r['leaves']} leaves, {r['launches']} launches): kernel "
        f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
        f"torch._fused_adam_ {r['library_ms']:.4f} ms, bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    sw = zoo["sweep"]
    log(f"5j-cli: cifar10 --steps {SWEEP_STEPS} --checkpoint-every "
        f"{SWEEP_EVERY} as gate-mode tenant {SWEEP_POD[0]}: SIGKILLed "
        f"after the promoted save of step {sw['saved_step']} (charged "
        f"{sw['charged_ms_at_kill']:.1f} ms by then), resumed there with "
        f"no warm-up for {sw['resumed_steps']} steps, Adam count "
        f"{sw['adam_count']:.0f}; final loss {sw['final_loss']!r} "
        f"against the uninterrupted run's "
        f"{sw['uninterrupted_final_loss']!r}; on a held-out batch "
        f"{sw['held_out_loss']!r} against {sw['uninterrupted_held_out_loss']!r}; "
        f"final params max abs diff {sw['param_max_abs_diff']:.3e}; "
        f"stages s " + ", ".join(
            f"{k} {v:.1f}" for k, v in sw["stages_s"].items()))
    log(f"5j: {zoo['seconds']:.1f} s in all; by stage s " + ", ".join(
        f"{k} {v:.1f}" for k, v in zoo["stages_s"].items())
        + f"; launches {zoo['launches']}")
    phases["zoo"] = zoo
    for k in launches:
        launches[k] += zoo["launches"][k]
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
