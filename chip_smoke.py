#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``kubeshare_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out results.json]

Runs from the root of a checkout and needs one CUDA card. Phases, each
failing the run (non-zero exit, no result line) when it fails:

1. the card's name and power limit (``nvidia-smi``), torch/CUDA versions;
2. the build of every hand-written kernel from ``kubeshare_tpu_torch/csrc``,
   one ``nvcc`` per source (four), all started together, and the
   tensor-core instructions of the bf16 flash kernels (forward, dQ, dK/dV;
   HMMA at the instances 8, 16 and 32, HGMMA at 64, 128 and 256) counted
   in their SASS;
3. each kernel held against its plain PyTorch version on the card, at the
   shapes the main path gives it (fused Adam also over the whole mnist
   and transformer trees in one multi-tensor launch; flash attention also
   through autograd in bf16, where its forward's lse feeds the backward
   kernels, at every instance width it is built for, 8, 16, 32, 64, 128
   and 256, and at head dims it pads to an instance, 20, 80, 96 and 200),
   then timed beside its plain version, one PyTorch library call
   computing the same function, and its bound (flash attention also at
   head dims 8, 16, 64, 80, 96, 128 and 256 and at seq 8192, off the LM's
   main path); each flash kernel function's registers and spill bytes
   from the ``-Xptxas -v`` report;
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
      1.0, two side by side at request 0.5, two at requests 0.25 and
      0.75, alone ungated. Every run's tenants start
      together ahead of the runs (``--go``: imports, the attach and the
      CUDA context, then a wait), one client file holding every gated
      one, and each run trains once all are ready and the run before it
      is done. A gated tenant's warm-up ends once its gate has been
      granted the token again after its first step (the stride scheduler
      has then taken back the start-up's charge, or the other tenant
      reached its window cap), and a pair's tenants train 20 s past the
      later warm-up of the two. Each pair's first tenant
      must hold its requested share of the token in the pair's common
      window (and over its life and of the steps, in the even pair), the
      pair's steps must come in runs of one tenant, and the two tenants'
      charges must not sum past the time they were held in;
   f. the proxy-mode pair — the reference's default attach: a
      ``ChipProxy`` on the card in this process (token scheduler window
      1 s), and tenant processes (``--tenant --compiled``) attached only
      by the shim from a pod's env with the proxy's port. Each has no
      CUDA device of its own; it wraps the full-width LM train step in
      ``torch.compile``, which the attach exports and runs on the proxy,
      and reads the loss every step. One tenant alone at request 1.0,
      then two at 0.5 / 0.5, then two at 0.25 / 0.75. The five start
      ahead of the runs (``--go``): each exports, compiles and runs its
      first step, then waits; the even pair first, beside 5e's node
      start-up and before any other tenant, so that no other compile on
      the proxy meets its first executions; the other three beside 5e's
      tenants. Every step must
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
      the LSTM LM, the mixture-of-experts LM with flash attention, and the
      dense LM at ``dim`` 512, 1024, 128 and 640, 8 heads of 64, 128, 16
      and 80, and at ``dim`` 2048, Gemma-2B's 8 heads of 256, 2 layers):
      for
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
      run's Adam count and end on its final loss; and 5j-lm, the LM at
      head dim 128 with 2 kv heads, RoPE and a 128-wide window (the
      module's env knobs, read at import), in a process of its own
      (``--lm-member``): its card-vs-CPU step and its exclusive and
      profiled runs, launches checked as each zoo model's;
   k. gangs — first ``flash_attention_lse`` forward and backward at a
      ring shard's shape in bf16, causal and not, with a random nonzero
      cotangent for O and the lse, against the plain versions; then two
      gang members on the one card (the gang env of
      ``gang-jax-distributed.yaml``, joined by the shim as whole-device
      members: gloo, since they share the device), each the LM's CLI
      (this script's ``--gang-member`` mode runs the CLI module as
      ``__main__`` and records its result and launch counts), over four
      meshes: dp = 2; sp = 2 with ring-flash; sp = 2 with Ulysses-flash;
      tp = 2. Each run's global loss must match one process's, the
      replicated leaves must be equal on both ranks, and the flash
      launches a rank makes must be those its ring steps call for; then a
      one-rank gang (NCCL) with ``--checkpoint``, SIGKILLed after a save
      and started again, must resume at the saved step through the
      sharded checkpoint;
   l. the autopilot's quota, the rightsizer and the elastic plane —
      5l-quota: a
      ``ChipProxy`` on the card with the native token scheduler (window
      1 s) and an ``ElasticQuota`` on it; two threaded ``ProxyClient``s
      train the full-width flash LM through ``compile_loop`` + ``chain``,
      a lender (request 0.5, limit 1.0) briefly and then idle, a borrower
      (0.25 / 0.25) all along. The quota must lend 0.75 of the lender's
      measured headroom (0.375), raise the borrower's window share clearly
      past its limit while lent, and revoke the credit inside the
      lender's next demand, before its grant; every step launches the
      LM's kernels exactly. 5l-rightsize, right after on the same proxy
      and clients: the lender turns idle, holding each grant mostly
      idle, and the borrower trains against a step-time objective it
      misses at its cap; over a ``Dispatcher`` that books both on the
      card, one ``Rightsizer.cycle()`` must grow the borrower and shrink
      the lender through the card's scheduler (bookings equal to the
      effective shares read back from the core, the borrower's window
      share past its old limit), a failed batch must roll back on both,
      the journal hold both batches. 5l-elastic: four gang ranks on the
      one card
      (the gang env and the shim, gloo), each this script's
      ``--elastic-member``, hold an ``ElasticTrainer`` of the flash LM on
      ranks [0, 1]; rank 0's ``ElasticOrchestrator`` (over a dispatcher
      with the sim's gang) resizes it to 4 ranks before step 5 and to 1
      before step 9. Every loss must match the unresized run's, the
      final params too within a stated bound, each restate move the hand
      count of leaves and bytes, the journal recover onto the 1-chip
      mesh, every rank in the mesh launch the kernels once a layer a step
      and none outside it, and a checkpoint restate from 4 ranks onto one
      give the saved state bit for bit. 5i's services run with the
      autopilot, rightsize and elastic planes attached, and 5i reads the
      fragmentation, dry-run plans of the autopilot and the rightsizer,
      the doctor's checks of all three, and replays the leader's decision
      trace (its first background pods) through ``replay_trace`` and
      ``topcli --replay-diff``. 5i starts each daemon from its container's
      argv in ``deploy/torch/*.yaml`` (``PLACE_MANIFESTS``): only the
      host-local values of ``_place_argv`` are substituted and 5i's own
      flags appended;
   m. the standalone backend — ``tools/launch_backend_torch.py`` from a
      config of the card and one client brings up a proxy on the card
      and a pod manager; mnist's CLI, unmodified, attached in gate mode by
      its env alone, trains 40 profiled steps: it must exit 0 below its
      first loss with one Adam launch a step of its trace, charged by the
      token scheduler, and the tool must stop every process on SIGTERM.
   The paths run in this order but for five: 5j's sweep, 5j-lm, 5k's
   gangs, 5l-elastic and 5m run last and side by side, all started together
   after 5l-quota (each checks correctness, in processes that count their
   own launches, and their start-ups, not the card, take their time); 5k's
   part in this process, the lse cotangent and the one-process run, runs
   before 5l-quota, and 5k's five gangs start together;
6. the outputs of the main paths: finite, of the expected shapes.

The second-to-last line is the kernels' JSON record (each flash pass also
by instance width, ``instances``); the last line is
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --tenant out.json [--compiled] [--seconds S]
        [--steps N] [--seed N] [--peers a.json,b.json] [--go FILE]

is the tenant of phases 5e, 5f, 5g and 5i (``--compiled``: its train step
wrapped in ``torch.compile``; ``--steps``: exactly N steps; ``--peers``:
the other tenants' records, whose warm-up it waits for; ``--go``: ready
itself, write ``out.json.ready`` and wait for FILE before training on):
it holds no isolation code, trains, and writes its per-step end times,
losses and kernel launch counts to ``out.json``.

    python3 chip_smoke.py --gang-member out.json -- <CLI arguments>

is a gang member of phase 5k: the transformer's CLI with those arguments,
run as ``python -m kubeshare_tpu_torch.models.transformer`` runs it, then
its result (loss, steps, the runner's backend, a digest of each local
parameter shard) and kernel launch counts written to ``out.json``.

    python3 chip_smoke.py --elastic-member out.json

is a rank of phase 5l's elastic gang (joined by the shim from the gang
env): it writes its losses, resizes, launches by step and, on rank 0, the
orchestrator's outcomes and the checks' readings to ``out.json``.

    python3 chip_smoke.py --lm-member out.json

is phase 5j-lm's process (started with the attention knobs in its env):
it writes the LM's card-vs-CPU step, runs and launch counts to
``out.json``.
"""

from __future__ import annotations

import argparse
import atexit
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
# the bf16 backward's prologue from head dim 33 (the instances 64, 128
# and 256) replaces no TPU kernel: it computes D where the JAX backward
# leaves it to XLA (this line), and splits dO for the two passes
FLASH_PREP_SOURCE = "kubeshare_tpu_torch/csrc/flash_backward_wide.cuh"
FLASH_PREP_REPLACES = "kubeshare_tpu/ops/flash_attention.py:318"
# the bf16 flash kernels, which must run on the tensor cores: on mma.sync
# (HMMA in the SASS) the three passes at the instances 8, 16 and 32; on
# wgmma (HGMMA) the three at 64, 128 and 256, with no spill; each a
# function with cp.async or TMA and one with plain loads, by instance
FLASH_MMA_KERNELS = {"flash_fwd_mma_kernel": (8, 16, 32),
                     "flash_dq_mma_kernel": (8, 16, 32),
                     "flash_dkv_mma_kernel": (8, 16, 32)}
FLASH_WGMMA_KERNELS = {"flash_fwd_wgmma_kernel": (64, 128, 256),
                       "flash_dq_wgmma_kernel": (64, 128, 256),
                       "flash_dkv_wgmma_kernel": (64, 128, 256)}
# the libraries built from csrc, one nvcc each (flash attention's wgmma
# instances 64 and 128 a library of their own, 256 another: the three
# build in parallel)
KERNELS = ("fused_adam", "flash_attention", "flash_attention_wide",
           "flash_attention_256")
FLASH_LIBRARIES = ("flash_attention", "flash_attention_wide",
                   "flash_attention_256")
# the bf16 forward of the wgmma instances (64, 128, 256); their dQ, dK/dV
# and prologue are FLASH_PREP_SOURCE's, the mma.sync instances' passes
# FLASH_SOURCE's
FLASH_FWD_WIDE_SOURCE = "kubeshare_tpu_torch/csrc/flash_forward_wide.cuh"
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
# the head dims of the LM at init(dim=512) and init(dim=1024) (8 heads):
# GPT-2's and Llama's, timed at the main path's batch and length, and 128
# at long context
WIDE_HEAD_DIMS = (64, 128)
WIDE_SHAPES = tuple((8, 256, 8, d) for d in WIDE_HEAD_DIMS)
LONG_WIDE_SHAPE = (1, 8192, 8, 128)
# the other instances and padded head dims, timed at the same batch and
# length: 8 (the small preset) and 16 (dim 128), 80 (Phi-2's) and 96
# (Phi-3-mini's) on the instance 128, and 256 (Gemma's)
OTHER_SHAPES = tuple((8, 256, 8, d) for d in (8, 16, 80, 96, 256))
# flash_check's widths besides 32's cases: the instances 16, 64, 128 and
# 256 at every case of the wide dims, and head dims the kernels pad to an
# instance (20 on 32, 80 and 96 on 128, 200 on 256)
CHECK_INSTANCES = (16, 64, 128, 256)
CHECK_PADDED = (20, 80, 96, 200)
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
# each run trains after them — alone (ungated, then gated) and as a pair.
# A gated tenant's warm-up also lasts until its gate is granted the token
# again after its first step: that step holds the token through CUDA
# start-up (seconds), which the stride scheduler charges at 1/request and
# takes back from the lower request before it grants it again (unless the
# other tenant reaches its window cap first). Read from the fifth step,
# the uneven pair's window opened with 0.56-4.26 s of the other tenant's
# holding still owed, and its first tenant held 0.12 of the token in the
# window's first half, 0.26 in its second (PERF.md §6)
TENANT_WARMUP_STEPS = 5
# how long past its own warm-up a tenant waits for its peers' (--peers)
TENANT_MEET_WAIT_S = 60.0
# how long a tenant started ahead of its run (--go) waits for the run
TENANT_GO_WAIT_S = 900.0
GATE_SOLO_S = 3.0
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
PROXY_SOLO_S = 3.0
PROXY_PAIR_S = 14.0
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
CRASH_AT = 8
MIGRATE_AT = 8
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
# each tenant trains this long past both tenants' warm-up, so that their
# common window passes 5e's GATE_MIN_WINDOW_S (8 s) whatever the start-up
# offset between them (a first step's token hold varies by seconds)
PLACE_PAIR_S = 10.0
# the control plane's replicas: two services in the leader:scheduler
# election, each on cell-routed shards, over one registry and its
# follower; the node's launcher and proxy push their metrics there
PLACE_SERVICES = ("svc-a", "svc-b")
PLACE_SHARDS = 4
PLACE_HA_TTL_S = 5.0
PLACE_REPL_POLL_S = 0.2
PLACE_PUSH_S = 1.0
# the leader's decision trace is fetched once this many background pods
# are in (its ring of 8,192 entries holds them with the fleet entry that
# opens it; the whole background overruns it) and replayed at this tick
PLACE_REPLAY_PODS = 500
PLACE_REPLAY_TICK_S = 0.002
PLACE_REPLAY_DRAIN_S = 1.0
# 5i starts each daemon as its manifest runs it: the container's argv in
# deploy/torch/ (label: manifest, container, flags, appended). Of the
# argv, only the flags named here change: each to this host's value (a
# cluster's Service name to 127.0.0.1, a listening port to 0, the OS's
# pick, where the daemon's READY line names the port it took, else to a
# free one ({port}), a path under the daemon's temp dir ({dir})), or,
# None, left out with its value: the webhook's TLS pair is the cluster's
# Secret, and 5i's admission requests are plain HTTP. Then 5i's own flags are
# appended: what one replica of each in a cluster does not need (a
# follower, two sharded services in an election with every control
# plane, a node name, the launcher's directory, a fast configd).
PLACE_MANIFEST_DIR = os.path.join("deploy", "torch")
_PLACE_REGISTRY = {"--registry-host": "127.0.0.1",
                   "--registry-port": "{registry_port}"}
_PLACE_SERVICE = ("scheduler.yaml", "scheduler",
                  {**_PLACE_REGISTRY, "--port": "0"},
                  ["--host", "127.0.0.1", "--health",
                   "--shards", str(PLACE_SHARDS), "--shard-route", "cell",
                   "--ha-ttl", str(PLACE_HA_TTL_S), "--ha-holder", "{label}",
                   "--autopilot", "--autopilot-journal", "{dir}/ap.jsonl",
                   "--elastic", "--elastic-journal", "{dir}/el.jsonl",
                   "--rightsize", "--rightsize-journal", "{dir}/rz.jsonl",
                   "--elastic-grow"])
PLACE_MANIFESTS = {
    "registry": ("registry.yaml", "registry",
                 {"--port": "0", "--journal": "{dir}/registry.jsonl"},
                 ["--host", "127.0.0.1"]),
    "follower": ("registry.yaml", "registry",
                 {"--port": "0", "--journal": "{dir}/registry.jsonl"},
                 ["--host", "127.0.0.1",
                  "--follower-of", "127.0.0.1:{registry_port}",
                  "--replication-poll", str(PLACE_REPL_POLL_S)]),
    "collector": ("collector.yaml", "collector",
                  {**_PLACE_REGISTRY, "--metrics-port": "{port}"},
                  ["--node", "{node}"]),
    "configd": ("node-daemon.yaml", "configd", dict(_PLACE_REGISTRY),
                ["--node", "{node}", "--base-dir", "{scheduler_dir}",
                 "--period", "0.1"]),
    "webhook": ("webhook.yaml", "webhook",
                {"--port": "0", "--cert": None, "--key": None}, []),
    **{holder: _PLACE_SERVICE for holder in PLACE_SERVICES},
    "bridge": ("scheduler.yaml", "bridge", {"--service": "{services}"},
               ["--kube-api", "{api}"]),
}
# phase 5j: the zoo. The JAX package's workload models at full width,
# each through run_training: (label, model module, init keywords, loss)
ZOO = (("cifar10", "cifar10", {}, "loss_fn"),
       ("resnet18", "resnet", {}, "loss_fn"),
       ("resnet50", "resnet", {"blocks_per_stage": (3, 4, 6, 3)},
        "loss_fn"),
       ("vgg16", "vgg", {}, "loss_fn"),
       ("lstm", "lstm", {}, "loss_fn"),
       ("moe_lm", "transformer", {"n_experts": 4}, "flash_loss_fn"),
       # the dense LM at GPT-2's head dim (8 x 64) and at Llama's (8 x 128,
       # ~59 M params): the flash kernels' wide instances on the main path
       ("lm_hd64", "transformer", {"dim": 512}, "flash_loss_fn"),
       ("lm_hd128", "transformer", {"dim": 1024}, "flash_loss_fn"),
       # at head dim 16 (dim 128), Phi-2's 80 (dim 640, on the instance
       # 128) and Gemma-2B's 256 (its hidden 2048, 8 heads; 2 of its 18
       # layers, vocab 4,096, seq 256)
       ("lm_hd16", "transformer", {"dim": 128}, "flash_loss_fn"),
       ("lm_hd80", "transformer", {"dim": 640}, "flash_loss_fn"),
       ("lm_hd256", "transformer", {"dim": 2048, "layers": 2},
        "flash_loss_fn"))
# 5j-lm: the LM at head dim 128 with Mistral's attention knobs (a group of
# 4 q heads a kv head, RoPE, a sliding window), read at import, so in a
# process of its own (``--lm-member``) started with LM_MEMBER_ENV
LM_MEMBER = ("lm_hd128_gqa_rope_window", "transformer", {"dim": 1024},
             "flash_loss_fn")
LM_MEMBER_ENV = {"KUBESHARE_TPU_TRANSFORMER_KV_HEADS": "2",
                 "KUBESHARE_TPU_TRANSFORMER_ROPE": "1",
                 "KUBESHARE_TPU_TRANSFORMER_WINDOW": "128"}
# timed steps of the exclusive run, and of the profiled one (the
# profiler's warm-up, then TRACE_UNREAD traced steps, which the summary
# does not read, then four read)
ZOO_STEPS = 30
ZOO_PROFILE_STEPS = 7
# the traced steps a summary leaves out: the first may lack any kernel
# that ran, its last Adam launch too, and the second's last Adam launch
# is where the steps read begin
TRACE_UNREAD = 2
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
# phase 5k: gangs. Two ranks of the LM's CLI on the one card (the gang env
# of examples/families/distribute/gang-jax-distributed.yaml), over four
# meshes: (label, KUBESHARE_TPU_MESH, KUBESHARE_TPU_SP_ATTN)
GANG_MESHES = (("a-dp2", "", ""),
               ("b-ring-flash", "dp=1,sp=2,tp=1", "ring_flash"),
               ("c-ulysses-flash", "dp=1,sp=2,tp=1", "ulysses_flash"),
               ("d-tp2", "dp=1,sp=1,tp=2", ""))
GANG_STEPS = 10
GANG_WARMUP = 2                 # run_training's untimed steps
# a gang's final loss against one process's, relative: bf16 keeps 8
# significant bits and the gang sums in another order (per-rank halves,
# the ring's merge, the all-reduce). On the H100 the four meshes read
# 1.2e-4 to 4.9e-4 after 10 + 2 steps; this is 4x the worst of them
GANG_LOSS_RTOL = 2e-3
# flash forward launches a rank makes per layer per step, by mesh: ring-
# flash on sp = 2 launches the diagonal on rank 0, past + diagonal on
# rank 1; Ulysses-flash one full-sequence launch; the dense CLI none
GANG_FLASH_PER_LAYER = {"a-dp2": (0, 0), "b-ring-flash": (1, 2),
                        "c-ulysses-flash": (1, 1), "d-tp2": (0, 0)}
# the one-rank NCCL gang with a checkpoint: steps, save period
GANG_CKPT_STEPS = 40
GANG_CKPT_EVERY = 10
# the lse cotangent on the card: a ring shard's shape, bf16, at the LM's
# head dim and at Llama's
LSE_SHAPE = (8, 128, 8, 32)
LSE_WIDE_SHAPE = (8, 128, 8, 128)
# phase 5l-quota: idle-share lending on the card's token scheduler (window
# WINDOW_MS). (name, request, limit) of the lender and the borrower, each
# its own tenant (namespace): 5l-rightsize resizes them by tenant
QUOTA_LENDER = ("lender/lm", 0.5, 1.0)
QUOTA_BORROWER = ("borrower/lm", 0.25, 0.25)
QUOTA_CHAIN = 8               # steps a chain call asks for
QUOTA_WARM_S = 1.0            # the lender trains this long, then idles
QUOTA_IDLE_S = 1.5            # then this long before the first reading
QUOTA_READ_S = 2.0            # each reading: before, lent, after
QUOTA_SETTLE_S = 1.0          # a window, before the lent and after readings
QUOTA_STEP_EVERY_S = 0.25     # the quota's step cadence while it lends
QUOTA_SAMPLE_S = 0.1          # window-usage samples within a reading
QUOTA_GRANT_WAIT_S = 10.0     # longest wait for the borrower at its cap
# the borrower's window share while lent must pass both this (its limit
# is 0.25, its effective limit while lent 0.625) and this many times its
# share before lending (a burst can overrun a grant, so a share read at
# the limit sits a little above it), and fall again once revoked
QUOTA_LENT_MIN = 0.35
QUOTA_LENT_OVER = 1.3
# phase 5l-rightsize, in 5l-quota's process right after its readings, on its
# proxy, scheduler and clients: the lender turns idle (one step, then
# RZ_THINK_S of think time, over the proxy's 50 ms idle release, so each
# grant is mostly held idle) and the borrower keeps training against a
# step-time objective it misses at its 0.25 cap. RightsizeConfig's
# defaults but one cut: its observation window, 600 s, is RZ_WINDOW_S,
# the "before" reading (a ledger window of 600 s would judge a tenant
# only after 60 s of grants)
RZ_WINDOW_S = 4.0
RZ_THINK_S = 0.15
# the borrower's chain call once 5l-rightsize starts: short bursts, so its
# window share follows its limit (chains of QUOTA_CHAIN steps overran the
# 0.25 limit up to 1.14x on a host whose device step read 26.9 ms, and
# reached 0.90x of 0.35 after the grow, run 16f) and its objective gets
# more samples
RZ_CHAIN = 2
RZ_SETTLE_S = 1.0             # before each reading
RZ_READ_S = 4.0               # the reading after the resize
# the borrower's objective: step time (wall seconds a step of a chain
# call, the token wait included) at p90, its bound the device step time
# the proxy measures for it over the "before" reading divided by this:
# the step time it would see with this share of the card
RZ_SLO_SHARE = 0.3
# the windows read against a tenant's effective limit: a burst can overrun
# a grant (5l-quota's borrower read up to 1.08x its limit in PR 15)
RZ_SHARE_OVER = 1.3
# the grown borrower's window share after the resize must pass its old
# limit (0.25) and this many times its share before: a core that kept the
# old share would hold it at the limit (chains of RZ_CHAIN steps read
# 0.2235-0.2360 before the resize, 0.3026-0.3236 after, 1.35-1.43x)
RZ_SHARE_GROWN = 1.2
# phase 5l-elastic: a gang of ELASTIC_WORLD ranks on the one card, the LM
# with flash attention resized 2 -> 4 -> 1 ranks before the steps of
# ELASTIC_PLAN (step index -> devices), ELASTIC_STEPS in all, against an
# unresized run on ranks [0, 1]
ELASTIC_WORLD = 4
ELASTIC_STEPS = 12
ELASTIC_PLAN = {4: 4, 8: 1}
ELASTIC_SEED = 5
ELASTIC_LR = 1e-3
ELASTIC_GANG = "sim/trainer"
# the resized run's final params against the unresized run's: the mean
# abs difference over every weight. The runs differ in rounding only (the
# meshes sum in another order), so a few weights with near-zero Adam
# moments part by up to ~ELASTIC_LR while the mean stays near 8e-7 on an
# H100; a restate that loses optimizer state moves every weight's update
# by a fraction of ELASTIC_LR: 9.6e-4 with Adam's count restarted, 2.0e-3
# with its moments zeroed (PERF.md)
ELASTIC_PARAM_MEAN_ATOL = 1e-5
# phase 5m: the standalone backend (BACKEND_TOOL, the reference's
# launch-backend harness): a proxy on the card and one pod manager from a
# hand-written config, then mnist's CLI, unmodified, attached in gate mode
# by env alone for BACKEND_STEPS profiled steps
BACKEND_TOOL = "tools/launch_backend_torch.py"
BACKEND_POD = ("smoke/backend", 0.5)
BACKEND_STEPS = 40


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
    d) tensor, sliced as ``mha_apply`` slices the fused qkv product, and dO
    a view of a (b, s, h d) one; ``unaligned`` adds one element to each of
    those tensors' rows, so no row starts 16-byte aligned."""
    import torch

    randn = lambda *shape: torch.from_numpy(rng.standard_normal(
        shape).astype("float32")).to(dev)
    if layout == "dense":
        dout = randn(b, s, h, d)
        make = lambda heads: randn(b, s, heads, d).to(dtype)
        return make(h), make(hk), make(hk), dout
    pad = 1 if layout == "unaligned" else 0
    # dO strided too (the 8/32 passes read it with its strides; at the
    # wide head dims the prologue does, and the passes read its parts)
    dout = randn(b, s, h * d + pad)[..., :h * d].reshape(b, s, h, d)
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
    launched first); the same at the instances 16, 64, 128 and 256, and
    forward and backward at seq 2048 with head dim 128, GQA and a window;
    256 with one kv head (Gemma-2B's); the padded head dims 20, 80, 96 and
    200 dense, strided (aligned and not), fp32, and ragged with GQA and a
    window. The backward passes take the plain forward's lse and D, so
    each kernel is held alone. Returns each kernel's worst max abs error,
    over every case, by head dim (``by_head_dim``) and by the instance it
    ran on (``by_instance``)."""
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
    # the instances 16, 64 (GPT-2's), 128 (Llama's) and 256 (Gemma's), as
    # the LM at init(dim=128 / 512 / 1024 / 2048) gives them: every case
    # above but head dim 8's
    for d_wide in CHECK_INSTANCES:
        shape = (8, 256, 8, d_wide)
        cases += [
            (f"head dim {d_wide}", shape, 8, bf16, True, None, "dense",
             True),
            (f"head dim {d_wide} (strided)", shape, 8, bf16, True, None,
             "fused", True),
            (f"head dim {d_wide}, strided, rows not 16-byte aligned", shape,
             8, bf16, True, None, "unaligned", True),
            (f"head dim {d_wide}, gqa hk=2", shape, 2, bf16, True, None,
             "dense", True),
            (f"head dim {d_wide}, window 100", shape, 8, bf16, True, 100,
             "dense", True),
            (f"head dim {d_wide}, non-causal", shape, 8, bf16, False, None,
             "dense", True),
            (f"head dim {d_wide}, fp32 inputs", shape, 8, f32, True, None,
             "dense", True),
            (f"head dim {d_wide}, ragged s=80", (2, 80, 8, d_wide), 8, bf16,
             True, None, "dense", True),
            (f"head dim {d_wide}, ragged s=200, window 70",
             (1, 200, 4, d_wide), 4, bf16, True, 70, "dense", True)]
    cases.append(("head dim 128, seq 2048, gqa hk=2, window 1024",
                  (1, 2048, 8, 128), 2, bf16, True, 1024, "dense", True))
    # Gemma-2B's attention: 8 q heads of 256 on one kv head
    cases.append(("head dim 256, gqa hk=1", (8, 256, 8, 256), 1, bf16, True,
                  None, "dense", True))
    # head dims between the instances, read and written at their true width
    # (rows of 20 are not 16-byte aligned: plain loads, also "fused")
    for d_pad in CHECK_PADDED:
        shape = (8, 256, 8, d_pad)
        cases += [
            (f"head dim {d_pad}", shape, 8, bf16, True, None, "dense", True),
            (f"head dim {d_pad} (strided)", shape, 8, bf16, True, None,
             "fused", True),
            (f"head dim {d_pad}, strided, rows not 16-byte aligned", shape,
             8, bf16, True, None, "unaligned", True),
            (f"head dim {d_pad}, fp32 inputs", shape, 8, f32, True, None,
             "dense", True),
            (f"head dim {d_pad}, ragged s=200, gqa hk=2, window 70",
             (1, 200, 4, d_pad), 2, bf16, True, 70, "dense", True)]
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0, "prep": 0.0}
    by_dim: dict = {}
    by_instance: dict = {}
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
            extra = ()
            if fl._takes_split(q):
                # the prologue: dO's parts and flags exactly, D in fp32;
                # the passes read those parts
                split, lo_live, dc = fl.flash_prep(dout, ro, None)
                rsplit, rlive, rdc = fl.flash_prep_reference(dout, ro)
                check(torch.equal(split, rsplit)
                      and torch.equal(lo_live, rlive),
                      f"flash prep ({label}): dO's parts or their flags "
                      "differ from the plain version's")
                pairs.append(("prep", "D", dc, rdc))
                extra = (split, lo_live)
            dk, dv = fl.flash_dkv(*args, *extra)
            rdk, rdv = fl.flash_dkv_reference(*args)
            pairs += [("dq", "dQ", fl.flash_dq(*args, *extra),
                       fl.flash_dq_reference(*args)),
                      ("dkv", "dK", dk, rdk), ("dkv", "dV", dv, rdv)]
        torch.cuda.synchronize()
        parts = []
        inst = fl.instance_head_dim(d)
        for kernel, name, got, want in pairs:
            abs_err, rel_err = _check_flash_close(kernel, label, name, got,
                                                  want)
            worst[kernel] = max(worst[kernel], abs_err)
            for table, key in ((by_dim, d), (by_instance, inst)):
                row = table.setdefault(key, {})
                row[kernel] = max(row.get(kernel, 0.0), abs_err)
            parts.append(f"{name} {abs_err:.2e}/{rel_err:.2e}")
        log(f"  flash {label} ({dtype}, {shape}, hk={hk}, instance {inst}): "
            "ok, max abs/rel err " + ", ".join(parts))
    return dict(worst, by_head_dim=by_dim, by_instance=by_instance)


def flash_autograd_check(dev, rng) -> dict:
    """``flash_attention`` through autograd on bf16 q/k/v, strided views
    of one fused tensor at the main path's shape and at the wide head dims'
    (WIDE_SHAPES, Phi-2's 80 and Gemma's 256, where the backward's prologue
    feeds the passes; dO there the gradient of a bf16 cast, as the LM gives
    it): the kernel forward's
    lse and O feed the backward kernels. Held against the plain versions on
    the same inputs: O to the fp32 tolerance, dQ, dK and dV to the bf16
    one. Returns the max abs error of each, worst over the shapes."""
    import torch

    from kubeshare_tpu_torch.ops import flash_attention as fl

    errs: dict = {}
    for shape in (FLASH_SHAPE,) + WIDE_SHAPES + ((8, 256, 8, 80),
                                                 (8, 256, 8, 256)):
        b, s, h, d = shape
        scale = 1.0 / math.sqrt(d)
        fused = torch.from_numpy(rng.standard_normal(
            (b, s, 3 * h * d)).astype("float32")).to(dev, torch.bfloat16)
        w = torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(
            "float32")).to(dev)
        if shape != FLASH_SHAPE:
            w = w.to(torch.bfloat16).float()
        views = lambda x: [x[..., i * h * d:(i + 1) * h * d].reshape(
            b, s, h, d) for i in range(3)]
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
        here = {}
        for name, got, want in (("O", o.detach(), ro),
                                *zip(("dQ", "dK", "dV"), views(f.grad),
                                     (fl.flash_dq_reference(*args), rdk,
                                      rdv))):
            here[name] = _check_flash_close("autograd", label, name, got,
                                            want)[0]
            errs[name] = max(errs.get(name, 0.0), here[name])
        log(f"  flash {label} {shape}: ok, max abs err "
            + ", ".join(f"{n} {e:.2e}" for n, e in here.items()))
    return errs


def _visible_pairs(s: int, causal: bool, window) -> int:
    """(q, k) pairs a causal (windowed) row set sees: the work this run's
    mask leaves, not the s*s the kernels could do."""
    if not causal:
        return s * s
    import numpy as np

    seen = np.arange(1, s + 1)
    return int(np.minimum(seen, window).sum() if window else seen.sum())


def flash_bounds(shape, in_bytes: int, causal=True, window=None,
                 lo_rows=None) -> dict:
    """Least time of each pass: each input read once and each output
    written once over the memory rate, against the visible pairs'
    operations over the inputs' peak (bf16 tensor cores or fp32). dQ and
    dK/dV read dO in fp32, but on the wide bf16 route (``lo_rows`` given)
    they read its bf16 hi part and its lo part only in the ``lo_rows`` q
    rows (over every b*h row) of the tiles the prologue flagged: the fp32
    read is the prologue's. "prep" is that prologue: dO and O in fp32
    read, dO's two bf16 parts and D written (its few operations a value
    weigh nothing beside its bytes)."""
    b, s, h, d = shape
    pairs = b * h * _visible_pairs(s, causal, window)
    q = b * s * h * d * in_bytes
    kv = 2 * q                       # k and v, hk = h on the main path
    o32 = b * s * h * d * 4          # O, or dO, in fp32
    row = b * h * s * 4              # lse or D
    do = o32 if lo_rows is None else (b * s * h + lo_rows) * d * 2
    moved = {"fwd": q + kv + o32 + row,
             "dq": q + kv + do + 2 * row + q,
             "dkv": q + kv + do + 2 * row + kv,
             "prep": 2 * o32 + b * s * h * d * 2 * 2 + row}
    peak = PEAK_BF16_FLOPS if in_bytes == 2 else PEAK_FP32_FLOPS
    out = {}
    for name, nbytes in moved.items():
        byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        op_ms = FLASH_OPS_PER_PAIR_DIM.get(name, 0) * d * pairs / peak * 1e3
        out[name] = {"bound_ms": max(byte_ms, op_ms),
                     "bound_by": "bytes" if byte_ms >= op_ms
                     else "operations",
                     "bytes": nbytes, "visible_pairs": pairs}
    return out


def flash_timing(dev, rng, shape, iters: int, plain: bool) -> dict:
    """The three kernels at ``shape`` (bf16, causal) beside their plain
    versions (when ``plain``) and ``scaled_dot_product_attention`` with
    ``is_causal=True``: its forward against ours, its backward (dQ, dK and
    dV in one call) against each of ours, and forward+backward. dO is the
    gradient of a bf16 cast, as the LM gives it. At head dims 64 and 128
    the backward's prologue runs once first and the two passes take its
    dO parts (its own time under "prep"); the whole backward, prologue or
    D included, under "bwd_ms"."""
    import torch
    import torch.nn.functional as F

    from kubeshare_tpu_torch.ops import flash_attention as fl

    b, s, h, d = shape
    q, k, v, dout = _flash_inputs(dev, rng, b, s, h, h, d, torch.bfloat16)
    dout = dout.to(torch.bfloat16).float()
    scale = 1.0 / math.sqrt(d)
    o, lse = fl.flash_fwd(q, k, v, True, None, scale)
    fns = {"fwd": (partial(fl.flash_fwd, q, k, v, True, None, scale),
                   partial(fl.flash_fwd_reference, q, k, v, True, None,
                           scale))}
    if fl._takes_split(q):
        split, lo_live, dcap = fl.flash_prep(dout, o, None)
        extra = (split, lo_live)
        fns["prep"] = (partial(fl.flash_prep, dout, o, None),
                       partial(fl.flash_prep_reference, dout, o, None))
        # the q rows of the flagged tiles, whose lo part the passes read
        tile = fl.PREP_TILE
        rows = (s - tile * torch.arange(lo_live.shape[1],
                                        device=dev)).clamp(max=tile)
        lo_rows = int((lo_live.bool() * rows).sum())
    else:
        dcap = (dout * o).sum(-1).transpose(1, 2).contiguous()
        extra, lo_rows = (), None
    bwd = (q, k, v, dout, lse, dcap, True, None, scale)
    fns["dq"] = (partial(fl.flash_dq, *bwd, *extra),
                 partial(fl.flash_dq_reference, *bwd))
    fns["dkv"] = (partial(fl.flash_dkv, *bwd, *extra),
                  partial(fl.flash_dkv_reference, *bwd))

    def whole_bwd():
        """What the autograd backward launches: the prologue (or torch's
        D) and the two passes."""
        if extra:
            sp, live, dc = fl.flash_prep(dout, o, None)
            tail = (sp, live)
        else:
            dc, tail = (dout * o).sum(-1).transpose(1, 2).contiguous(), ()
        a = (q, k, v, dout, lse, dc, True, None, scale, *tail)
        fl.flash_dq(*a)
        fl.flash_dkv(*a)

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
    res["bwd_ms"] = min(cuda_time_ms(whole_bwd, iters, flush)
                        for _ in range(2))
    lib_ms = {name: min(cuda_time_ms(fn, iters, flush) for _ in range(2))
              for name, fn in lib.items()}
    res["library_host_ms"] = {name: host_time_ms(fn, 4 * iters)
                              for name, fn in lib.items()}
    bounds = flash_bounds(shape, 2, lo_rows=lo_rows)
    for name in fns:
        res[name].update(bounds[name])
        res[name]["library_ms"] = (None if name == "prep" else
                                   lib_ms["fwd" if name == "fwd" else "bwd"])
        res[name]["bound_share"] = res[name]["bound_ms"] / res[name]["ms"]
    res["library_ms"] = lib_ms
    res["kernel_fwd_bwd_ms"] = sum(res[n]["ms"] for n in fns)
    # SDPA's backward computes its own D: the whole backward is the fair
    # comparison, the two passes alone stand beside it
    res["bwd_over_sdpa"] = res["bwd_ms"] / lib_ms["bwd"]
    res["passes_over_sdpa"] = ((res["dq"]["ms"] + res["dkv"]["ms"])
                               / lib_ms["bwd"])
    return res


def flash_wide_timing(dev, rng) -> dict:
    """:func:`flash_timing` at the head dims besides 32: WIDE_SHAPES and
    OTHER_SHAPES, beside the plain versions at the instance widths (a
    padded head dim's bounds count its true width), LONG_WIDE_SHAPE
    without them; each pass logged with its bound, its share of it and
    SDPA's time, and dQ + dK/dV against SDPA's backward. Keyed by
    shape."""
    from kubeshare_tpu_torch.ops import flash_attention as fl

    res = {}
    for shape in WIDE_SHAPES + OTHER_SHAPES + (LONG_WIDE_SHAPE,):
        wide_long = shape == LONG_WIDE_SHAPE
        # the plain versions beside the instances only (80 and 96 run on
        # 128's kernels; their plain versions cost the smoke seconds)
        r = res[str(shape)] = flash_timing(
            dev, rng, shape, 5 if wide_long else 50,
            plain=not wide_long and shape[-1] in fl.INSTANCES)
        for name in ("fwd", "prep", "dq", "dkv"):
            if name not in r:      # no prologue below the instance 64
                continue
            x = r[name]
            plain = ("" if x["plain_ms"] is None
                     else f", plain {x['plain_ms']:.4f} ms")
            lib = ("" if x["library_ms"] is None else
                   f", sdpa {'forward' if name == 'fwd' else 'backward'} "
                   f"{x['library_ms']:.4f} ms")
            log(f"flash {name} at {shape} bf16 causal: kernel "
                f"{x['ms']:.4f} ms{plain}{lib}, bound {x['bound_ms']:.5f} ms "
                f"({x['bound_by']}), {100 * x['bound_share']:.1f}% of it; "
                f"host ms a call {x['host_ms']:.4f}")
        log(f"flash backward at {shape}, the prologue (or torch's D) "
            f"included "
            f"{r['bwd_ms']:.4f} ms = {r['bwd_over_sdpa']:.3f}x sdpa "
            f"backward {r['library_ms']['bwd']:.4f} ms; dq+dkv alone "
            f"{r['dq']['ms'] + r['dkv']['ms']:.4f} ms = "
            f"{r['passes_over_sdpa']:.3f}x; fwd+prep+dq+dkv "
            f"{r['kernel_fwd_bwd_ms']:.4f} ms, sdpa forward+backward "
            f"{r['library_ms']['fwd_bwd']:.4f} ms; sdpa host ms a call "
            f"forward {r['library_host_ms']['fwd']:.4f}, backward "
            f"{r['library_host_ms']['bwd']:.4f}")
    return res


def instance_rows(name: str, flash: dict, wide: dict, err: dict,
                  launches: dict) -> list:
    """The kernels line's rows of one flash pass by instance width: each
    instance's source, its launches on the main paths this process and
    5j-lm's counted by instance (``launches``, "pass/instance"; the tenant,
    gang and elastic processes run the LM at 32 and count by pass only),
    its max abs error in :func:`flash_check` and its times at (8, 256, 8,
    instance) from :func:`flash_timing` (``flash`` at 32, ``wide``
    elsewhere)."""
    from kubeshare_tpu_torch.ops import flash_attention as fl

    rows = []
    for inst in fl.WIDE_HEAD_DIMS if name == "prep" else fl.INSTANCES:
        r = flash if inst == 32 else wide[str((8, 256, 8, inst))]
        r = r[name]
        source = (FLASH_SOURCE if inst < 64 else
                  FLASH_FWD_WIDE_SOURCE if name == "fwd" else
                  FLASH_PREP_SOURCE)
        rows.append({
            "head_dim": inst, "route": "cuda", "source": source,
            "launches": launches.get(f"{name}/{inst}", 0),
            "max_abs_err": err["by_instance"][inst][name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    return rows


def log_ptxas(report: dict) -> None:
    """One line per kernel function of a ptxas report (ptxas_summary)."""
    for fn, r in sorted(report.items()):
        log(f"ptxas: {fn}: {r.get('registers', '?')} registers, "
            f"{r.get('stack', '?')} B stack, {r.get('spill_stores', '?')} B "
            f"spill stores, {r.get('spill_loads', '?')} B spill loads")


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


def ptxas_summary(text: str) -> dict:
    """Each kernel function's registers and spill bytes, from the ``nvcc
    -Xptxas -v`` report of a build: ``{kernel: {"registers", "stack",
    "spill_stores", "spill_loads"}}``."""
    out: dict = {}
    fn = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = _kernel_name(m.group(1))
            out[fn] = {}
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = _kernel_name(m.group(1))
            fn = name if name in out else None
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[fn].update(stack=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m.group(1))
    return out


def sass_mma_counts(names) -> dict:
    """Tensor-core instructions in each kernel function of the built
    libraries ``names``, read from their SASS with the toolkit's
    cuobjdump: ``{function: {"HMMA": n, "HGMMA": m}}`` (mma.sync and
    wgmma)."""
    from kubeshare_tpu_torch.ops import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = "".join(subprocess.run(
        [tool, "-sass", os.path.join(build.BUILD_DIR, f"lib{name}.so")],
        capture_output=True, text=True, check=True, timeout=120).stdout
        for name in names)
    counts: dict = {}
    fn = None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = _kernel_name(line.split("Function :")[1].strip())
            counts[fn] = {"HMMA": 0, "HGMMA": 0}
        elif fn is not None:
            for op in ("HMMA", "HGMMA"):
                counts[fn][op] += op in line
    return counts


def check_flash_sass(mma: dict, ptxas: dict) -> None:
    """Each bf16 flash kernel on the tensor cores it was written for:
    HMMA in every FLASH_MMA_KERNELS function, HGMMA and 0 spill bytes in
    every FLASH_WGMMA_KERNELS one and in the backward's prologue; a
    function for each head dim and load route (two each)."""
    for table, op in ((FLASH_MMA_KERNELS, "HMMA"),
                      (FLASH_WGMMA_KERNELS, "HGMMA")):
        for name, dims in table.items():
            found = {k: n[op] for k, n in mma.items()
                     if k.startswith(name + "I")}
            check(len(found) == 2 * len(dims) and all(found.values()),
                  f"{name} lacks {op} instructions or functions: {found}")
    for fn, r in ptxas.items():
        if fn.startswith(tuple(FLASH_WGMMA_KERNELS) + ("flash_prep_kernel",)):
            check(r.get("spill_stores") == 0 and r.get("spill_loads") == 0,
                  f"{fn} spills: {r}")


# flash launches by "pass/instance" on the main paths this process drove:
# each read of the counts (_counts), which follows a main path's run, adds
# the launches since the last read or reset; a reset, which comes before a
# main path, drops those since the last read (a check's)
INSTANCE_LAUNCHES: dict = {}
_instance_seen: dict = {}


def _counts() -> dict:
    from kubeshare_tpu_torch.ops import flash_attention as fl
    from kubeshare_tpu_torch.ops import fused_adam as fa

    for (name, inst), n in list(fl.instance_launches.items()):
        key = f"{name}/{inst}"
        new = n - _instance_seen.get(key, 0)
        if new:
            INSTANCE_LAUNCHES[key] = INSTANCE_LAUNCHES.get(key, 0) + new
        _instance_seen[key] = n
    return {"fused_adam": fa.launches,
            **{f"flash_{k}": n for k, n in fl.launches.items()}}


def _reset_counts() -> None:
    from kubeshare_tpu_torch.ops import flash_attention as fl
    from kubeshare_tpu_torch.ops import fused_adam as fa

    fa.reset_launches()
    fl.reset_launches()
    _instance_seen.clear()


# --- phase 5e: the gate pair ---------------------------------------------------

def _wait_go(out_path: str, go: str) -> None:
    """Say this tenant is ready (``<out_path>.ready``) and wait for the
    run's ``go`` file."""
    with open(out_path + ".ready.tmp", "w") as f:
        f.write(repr(time.monotonic()))
    os.replace(out_path + ".ready.tmp", out_path + ".ready")
    deadline = time.monotonic() + TENANT_GO_WAIT_S
    while not os.path.exists(go):
        check(time.monotonic() < deadline,
              f"tenant {out_path}: no go ({go}) in {TENANT_GO_WAIT_S} s")
        time.sleep(0.02)


def tenant(out_path: str, seconds: float, seed: int, compiled: bool,
           steps: int = 0, peers: tuple = (), go: str = "") -> int:
    """The tenant process of the gate and proxy pairs: an unmodified
    training loop, metered only if the shim attached it. The full-width
    transformer with flash attention on ``cuda`` if this process has a
    card (under proxy attach it has none: on ``cpu``, its compiled step
    running on the proxy), the loss read every step; after its warm-up
    (TENANT_WARMUP_STEPS steps, and, if gated, until its gate has been
    granted the token again after the first step: the record's ``warm``
    is the warm-up's last step) it trains ``seconds`` more (or, with
    ``steps``, exactly that many steps in all). With ``peers``, the other
    tenants' record paths, it writes its warm-up end beside its own record
    (``<out_path>.warm``) and trains ``seconds`` past the latest warm-up
    end among them all, so that the run's common window is ``seconds``
    long whatever their start-up offset (it stops waiting
    TENANT_MEET_WAIT_S past its own). After each step it also reads the
    gate's totals (``attach.gate_stats``), if gated. ``compiled`` wraps
    the step in ``torch.compile``. With ``go`` the process is started
    ahead of its run: it readies itself (imports, the attach, the CUDA
    context; a compiled tenant also its first step, the export and
    compile) and waits for the file ``go`` before it trains on."""
    import torch

    from kubeshare_tpu_torch import attach
    from kubeshare_tpu_torch.models import common, transformer
    from kubeshare_tpu_torch.ops.fused_adam import fused_adam

    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    if go and not compiled:
        if dev.type == "cuda":
            torch.cuda.init()
        _wait_go(out_path, go)
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
    warm = None
    first_proxy = None
    waiting = [p + ".warm" for p in peers]
    renews = GATE_TOTALS.index("renews")
    while (len(ends) < steps if steps
           else stop_at is None or ends[-1] < stop_at or waiting):
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))          # host read: the step is done
        ends.append(time.monotonic())
        if first_proxy is None:
            first_proxy = attach.proxy_usage()
            if go and compiled:
                _wait_go(out_path, go)
        totals = attach.gate_stats()
        gate.append([totals[k] for k in GATE_TOTALS] if totals else None)
        if warm is None and len(ends) >= TENANT_WARMUP_STEPS and (
                gate[-1] is None or gate[-1][renews] > gate[0][renews]):
            warm = len(ends) - 1
            stop_at = ends[-1] + seconds
            if peers:
                with open(out_path + ".warm.tmp", "w") as f:
                    f.write(repr(ends[-1]))
                os.replace(out_path + ".warm.tmp", out_path + ".warm")
        if stop_at is not None and waiting:
            for path in [p for p in waiting if os.path.exists(p)]:
                with open(path) as f:
                    stop_at = max(stop_at, float(f.read()) + seconds)
                waiting.remove(path)
            if ends[-1] > ends[warm] + TENANT_MEET_WAIT_S:
                waiting = []
    with open(out_path + ".tmp", "w") as f:
        json.dump({"attach": attach.active_mode(), "ends": ends,
                   "started": started,
                   "warm": TENANT_WARMUP_STEPS - 1 if warm is None else warm,
                   # the first step end after the go file: 1 when the
                   # first step ran before the wait (compiled, with go)
                   "go_index": int(bool(go and compiled)),
                   "losses": losses, "gate": gate, "launches": _counts(),
                   "device": (torch.cuda.get_device_name(0)
                              if dev.type == "cuda" else "cpu"),
                   "cuda_initialized": torch.cuda.is_initialized(),
                   "proxy": attach.proxy_usage(),
                   "first_proxy": first_proxy,
                   "visible": os.environ.get("CUDA_VISIBLE_DEVICES", "")}, f)
    # whole or absent: a run may go on once every record is there
    os.replace(out_path + ".tmp", out_path)
    return 0


# every port _free_port has handed out in this process: the OS offers a
# port again as soon as the probe socket closes, so two picks in a row
# could name one port for two servers
_ports_given: set = set()
_ports_lock = threading.Lock()


def _free_port() -> int:
    """A port free on this host and never handed out by this process."""
    while True:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        with _ports_lock:
            if port not in _ports_given:
                _ports_given.add(port)
                return port


def _free_port_pair() -> int:
    """A free port whose ``TOKEN_PORT_OFFSET`` above is free too (a
    proxy's execution and token ports, as a launcher numbers them),
    neither handed out before by :func:`_free_port`."""
    from kubeshare_tpu_torch.nodeagent.launcherd import (
        TOKEN_PORT_OFFSET as offset)

    while True:
        port = _free_port()
        with _ports_lock:
            if port + offset >= 65536 or port + offset in _ports_given:
                continue
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port + offset))
            except OSError:
                continue
        with _ports_lock:
            _ports_given.add(port + offset)
        return port


def _wait_ready(log_path: str, what: str, timeout: float = 120.0,
                proc=None, want: str = "") -> str:
    """The first ``READY`` line a spawned process wrote to its log (the
    line ``want``, when given, of a log several processes write); fails
    at once if ``proc`` (that process, when given) ends first."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(log_path):
            with open(log_path) as f:
                for line in f:
                    if line.startswith("READY") and (
                            not want or line.strip() == want):
                        return line.strip()
        if proc is not None and proc.poll() is not None:
            fail(f"{what} exited {proc.returncode} before "
                 f"{want or 'READY'}: {_tail(log_path)}")
        time.sleep(0.1)
    fail(f"{what} never printed {want or 'READY'}: {_tail(log_path)}")


def _tail(path: str, n: int = 3000) -> str:
    try:
        with open(path) as f:
            return f.read()[-n:]
    except OSError:
        return "(no log)"


def _tenant_env(root: str, chip_id: str, name: str, port: int,
                request: float, gated: bool,
                pod_env: dict | None = None) -> dict:
    """A tenant process's env: this one's without any pod variable, the
    port's shim first on the path, and a pod's env (``pod_env``, a
    binding's, when given; else one for the manager on ``port``)."""
    from kubeshare_tpu_torch import constants as C

    shim = os.path.join(root, "kubeshare_tpu_torch", "_shim")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KUBESHARE_TPU_")
           and k != C.ENV_VISIBLE_CHIPS}
    env["PYTHONPATH"] = os.pathsep.join([shim, root])
    if pod_env is not None:
        env.update(pod_env)
    else:
        env.update({C.ENV_POD_MANAGER_PORT: str(port),
                    C.ENV_POD_NAME: name,
                    C.ENV_TPU_REQUEST: str(request),
                    C.ENV_TPU_LIMIT: "1.0",
                    C.ENV_VISIBLE_CHIPS: chip_id})
    if not gated:
        env[C.ENV_ATTACH_MODE] = "off"
    return env


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
        self._runs: list = []             # every spawned run (stop kills)
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
        """A tenant process's env (:func:`_tenant_env`) on this node."""
        return _tenant_env(self.root, self.chip.chip_id, name, port, request,
                           gated, pod_env)

    def run(self, tenants, seconds: float, gated: bool,
            pod_envs: dict | None = None, meet: bool = False) -> dict:
        """Run the tenants ``(name, seed, manager port, request)`` side by
        side, each a process with only a pod's env (``pod_envs[name]``, a
        binding's env, when given; else one built here); with ``meet``,
        each trains ``seconds`` past the last one's warm-up; while they run,
        sample each gated one's charged ms from the token scheduler's
        ``usage`` op. Returns each tenant's record and its samples."""
        return self.collect(self.spawn(tenants, seconds, gated, pod_envs,
                                       meet))

    def spawn(self, tenants, seconds: float, gated: bool,
              pod_envs: dict | None = None, meet: bool = False,
              go: str = "") -> dict:
        """Start the tenants of :meth:`run` and return the run for
        :meth:`collect`. With ``go`` (a file path) each is started ahead
        of its run: it readies itself, writes ``<record>.ready`` and waits
        until :meth:`collect` writes ``go``."""
        procs = {}
        outs = {name: os.path.join(self.base, name.replace("/", "_") + ".json")
                for name, *_ in tenants}
        run = {"procs": procs, "outs": outs, "seconds": seconds,
               "gated": gated, "go": go,
               "logs": {name: self.log(name + "-tenant")
                        for name, *_ in tenants}}
        self._runs.append(run)
        for name, seed, port, request in tenants:
            env = self.tenant_env(
                name, port, request, gated,
                pod_envs[name] if pod_envs is not None else None)
            peers = [o for n, o in outs.items() if meet and n != name]
            with open(self.log(name + "-tenant"), "w") as log_file:
                procs[name] = subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--tenant", outs[name], "--seconds", str(seconds),
                     "--seed", str(seed)]
                    + (["--peers", ",".join(peers)] if peers else [])
                    + (["--go", go] if go else []),
                    env=env, cwd=self.root, stdout=log_file,
                    stderr=subprocess.STDOUT)
        return run

    def collect(self, run, reap: bool = True) -> dict:
        """Let a spawned run train (its go file), sample each gated
        tenant's charged ms from the token scheduler's ``usage`` op while
        it does, and return each tenant's record and its samples. With
        ``reap`` False it returns once every record is written, and the
        processes, still exiting, are checked by :meth:`reap`."""
        from kubeshare_tpu_torch.isolation import protocol

        procs, outs, usage = run["procs"], run["outs"], {}
        try:
            conns = {}
            if run["gated"]:
                for name in procs:
                    conns[name] = protocol.Connection("127.0.0.1",
                                                      self.token_port)
                    conns[name].call({"op": "attach", "name": name})
                    usage[name] = []
            if run["go"]:
                with open(run["go"], "w") as f:
                    f.write("go")
            deadline = time.monotonic() + run["seconds"] + 300
            while (any(p.poll() is None and (reap or not os.path.exists(
                    outs[n])) for n, p in procs.items())
                   and time.monotonic() < deadline):
                for name, conn in conns.items():
                    reply, _ = conn.call({"op": "usage"})
                    usage[name].append((time.monotonic(), reply["used_ms"]))
                time.sleep(0.25)
            for conn in conns.values():
                conn.close()
        finally:
            if reap or any(not os.path.exists(o) for o in outs.values()):
                _reap_run(run)
        records = {}
        for name, p in procs.items():
            check(os.path.exists(outs[name]),
                  f"tenant {name} wrote no record: "
                  f"{_tail(run['logs'][name])}")
            with open(outs[name]) as f:
                records[name] = json.load(f)
            records[name]["usage"] = usage.get(name, [])
        return records

    def stop(self) -> None:
        for run in self._runs:            # runs spawned and not collected
            _kill_run(run)
        self.launcher.stop()
        shutil.rmtree(self.base, ignore_errors=True)


def _wait_ready_runs(runs, timeout: float = 300.0) -> float:
    """Wait until every tenant of ``runs`` (started with a go file) is
    ready (``<record>.ready``); returns the seconds waited."""
    t0 = time.monotonic()
    for run in runs:
        for name, out in run["outs"].items():
            while not os.path.exists(out + ".ready"):
                p = run["procs"][name]
                check(p.poll() is None,
                      f"tenant {name} exited {p.returncode} before its "
                      f"run: {_tail(run['logs'][name])}")
                check(time.monotonic() < t0 + timeout,
                      f"tenant {name} not ready in {timeout} s")
                time.sleep(0.05)
    return time.monotonic() - t0


def _kill_run(run: dict) -> None:
    for p in run["procs"].values():
        if p.poll() is None:
            p.kill()
        p.wait()


def _reap_run(run: dict, timeout: float = 60.0) -> None:
    """Wait for a run's tenants to exit (killing those still up after
    ``timeout``), each of which must exit 0."""
    deadline = time.monotonic() + timeout
    for p in run["procs"].values():
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
    _kill_run(run)
    for name, p in run["procs"].items():
        check(p.returncode == 0,
              f"tenant {name} exited {p.returncode}: "
              f"{_tail(run['logs'][name])}")


def _check_losses(name: str, losses: list) -> None:
    check(all(math.isfinite(x) for x in losses),
          f"tenant {name}: loss not finite")
    check(losses[-1] < losses[0],
          f"tenant {name}: loss did not fall: {losses[0]} -> {losses[-1]}")


def _launches_per_step(adam_per_step: int, layers: int) -> dict:
    """A step of the LM at its full width (head dim 32): no prologue."""
    return {"fused_adam": adam_per_step, "flash_prep": 0,
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


def _warm(rec: dict) -> int:
    """The index of a tenant's last warm-up step (see :func:`tenant`)."""
    return rec.get("warm", TENANT_WARMUP_STEPS - 1)


def _solo_rate(rec: dict) -> float:
    ends = rec["ends"][_warm(rec):]
    return (len(ends) - 1) / (ends[-1] - ends[0])


def _gate_per_step(rec: dict, i0: int, i1: int) -> dict:
    """The gate's totals per step from step ``i0``'s end to step ``i1``'s
    (the ms charged is the held time: wall time between gate calls)."""
    return {k: (rec["gate"][i1][j] - rec["gate"][i0][j]) / (i1 - i0)
            for j, k in enumerate(GATE_TOTALS)}


def _solo_gate_per_step(rec: dict) -> dict:
    return _gate_per_step(rec, _warm(rec), len(rec["ends"]) - 1)


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
    start = max(r["ends"][_warm(r)] for r in pair.values())
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
    # the token each tenant held over its life up to the window's end,
    # start-up included: a tenant's first step holds the token through
    # its CUDA start-up (seconds, and varying: PERF.md §6), which the
    # stride scheduler charges at 1/request. Between two requests of one
    # size the other tenant takes that debt back within the window; when
    # the lower request (0.25) owes it, the higher one (limit 1.0)
    # reaches its window cap every ~1 s and the lower one is granted a
    # whole quota each time, so the debt stays (see check_pair)
    life = {n: pair[n]["gate"][i1][GATE_TOTALS.index("charged_ms")]
            for n, (_, i1) in span.items()}
    return {
        "requests": {a: req_a, b: req_b},
        "warm_up_steps": {n: _warm(r) + 1 for n, r in pair.items()},
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
    in the common window, and in an even pair also its share of the
    token held over its life and of the window's steps, within
    GATE_SHARE_SLACK of its requested share; the step ends in runs of
    one tenant (GATE_MIN_MEAN_RUN); the tenants' held time, by their
    gates and by the scheduler's ``usage`` op, no more than the time it
    was held in.

    An uneven pair's share over the life is read, not held to the
    request: its lower request keeps the debt of its own start-up (see
    pair_reading), so that share follows the length of its first step
    while its share in the window stays near the request (PERF.md §6;
    ``scripts/torch_gate_startup.py`` measures both)."""
    a = next(iter(reading["requests"]))
    wanted = reading["share_wanted"]
    shares = {"of the token in the window": reading["gate_held_share_a"]}
    if wanted == 0.5:
        # identical start-ups cancel: the debt is taken back within the
        # window, and the window's steps split as the token does
        shares["of the token over its life"] = reading[
            "lifetime_held_share_a"]
        shares["of the window's steps"] = reading["share_a"]
    for where, share in shares.items():
        check(abs(share - wanted) <= GATE_SHARE_SLACK * wanted,
              f"gate pair {kind}: {a} held {share} {where}, not within "
              f"{GATE_SHARE_SLACK:.0%} of its request's {wanted}")
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


def gate_phase(root: str, adam_per_step: int, layers: int,
               start_first=None, start_others=None) -> dict:
    """Phase 5e (see the module docstring): returns the solo rates, each
    pair's reading and the records' launch counts. ``start_first()`` and
    ``start_others()``, if given, start another phase's tenants and
    return their runs: the first beside the node's start-up, ready before
    5e's tenants start; the others once 5e's are started. The first run
    goes when all of them are ready too, so their start-ups overlap 5e's
    and no run of 5e is read beside one."""
    import numpy as np
    import torch

    torch.cuda.empty_cache()
    node = _Node(root)
    records, pairs = {}, {}
    # the gated runs in order, (pair kind, None) or ("gated", steps/s), to
    # set each pair beside the gated exclusive runs around it
    gated_order = []
    # the pairs after a gated exclusive run, the whole bracketed by
    # ungated ones: the host's drift shows in the pair of them (the gated
    # runs that stood between the two pairs and after them were cut for
    # the smoke's length)
    plan = ("ungated", "gated", "even", "uneven", "ungated")
    try:
        first = start_first() if start_first is not None else []
        ready = node.start()
        log(f"gate: proxy {ready}; device {node.chip.chip_id}")
        solo = {"ungated": [], "gated": []}
        # every run's tenants start at once, ahead of their runs (one
        # client file for every gated tenant: an idle client takes no
        # grant), and each run goes once every tenant is ready and the
        # run before it is done: their start-ups overlap, not the runs
        runs = []
        for i, step in enumerate(plan):
            if step in solo:
                n = sum(1 for x in plan[:i + 1] if x == step)
                runs.append((step, [(f"smoke/solo-{step}-{n}", 0, 1.0)]))
            else:
                runs.append((step, [(n, seed, req)
                                    for n, seed, req in GATE_PAIRS[step]]))
        ports = node.clients([(n, req) for step, tenants in runs
                              if step != "ungated" for n, _, req in tenants])
        if first:
            log(f"gate: {sum(len(r['procs']) for r in first)} tenants of "
                f"the next phase ready (first steps run) "
                f"{_wait_ready_runs(first):.1f} s after the node's start")
        spawned = [node.spawn([(n, seed, ports.get(n, 0), req)
                               for n, seed, req in tenants],
                              GATE_SOLO_S if step in solo else GATE_PAIR_S,
                              step != "ungated", meet=step not in solo,
                              go=os.path.join(node.base, f"go-{i}"))
                   for i, (step, tenants) in enumerate(runs)]
        others = start_others() if start_others is not None else []
        log(f"gate: {sum(len(t) for _, t in runs)} tenants (and "
            f"{sum(len(r['procs']) for r in others)} of the next phase) "
            f"ready in {_wait_ready_runs(spawned + others):.1f} s")
        run_s = []
        for (step, tenants), run in zip(runs, spawned):
            t_run = time.monotonic()
            # the next run goes once these records are written; the
            # processes exit meanwhile and are reaped after the last run
            got = node.collect(run, reap=False)
            run_s.append((step, time.monotonic() - t_run))
            if step in solo:
                gated = step == "gated"
                (name, _, _), = tenants
                rec = got[name]
                _check_tenant(f"solo ({step})", rec, gated, adam_per_step,
                              layers)
                solo[step].append(_solo_rate(rec))
                records[f"solo-{step}-{len(solo[step])}"] = rec
                if gated:
                    gated_order.append((step, solo[step][-1]))
                continue
            for name, rec in got.items():
                _check_tenant(name, rec, True, adam_per_step, layers)
                records[name] = rec
            pairs[step] = pair_reading(got, GATE_PAIRS[step])
            log(f"gate pair {step}: {json.dumps(pairs[step])}")
            check_pair(step, pairs[step])
            gated_order.append((step, None))
        for run in spawned:
            _reap_run(run)
        log("gate: seconds by run (go to the last record): " + ", ".join(
            f"{step} {secs:.1f}" for step, secs in run_s))
        managers = dict(node.managers)
    finally:
        node.stop()
    ungated = float(np.mean(solo["ungated"]))
    for i, (kind, _) in enumerate(gated_order):
        if kind in pairs:
            # the nearest gated exclusive runs before and after the pair
            near = [next((r for k, r in side if k == "gated"), None)
                    for side in (gated_order[i - 1::-1],
                                 gated_order[i + 1:])]
            near = [r for r in near if r is not None]
            beside = sum(near) / len(near)
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
            _charged_ms(r, r["ends"][_warm(r)], r["ends"][-1])
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

def _start_proxy_tenants(root: str, proxy, tenants, seconds: float,
                         base: str, go: str) -> dict:
    """Start the tenants ``(name, seed, request)`` of one run, each a
    process attached by the shim from a pod's env with the port of
    ``proxy`` (in this process), ahead of the run: each exports and
    compiles its step on the proxy, runs its first step, writes
    ``<record>.ready`` and waits for the file ``go``. Returns the run for
    :func:`_finish_proxy_tenants`."""
    from kubeshare_tpu_torch import constants as C

    shim = os.path.join(root, "kubeshare_tpu_torch", "_shim")
    run = {"procs": {}, "outs": {}, "logs": {}, "seconds": seconds,
           "go": go}
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
        run["outs"][name], run["logs"][name] = stem + ".json", stem + ".log"
        with open(run["logs"][name], "w") as log_file:
            run["procs"][name] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--tenant",
                 run["outs"][name], "--compiled", "--seconds", str(seconds),
                 "--seed", str(seed), "--go", go],
                env=env, cwd=root, stdout=log_file,
                stderr=subprocess.STDOUT)
    return run


def _finish_proxy_tenants(run: dict, proxy, reap: bool = True) -> dict:
    """Let a started run train (its go file) side by side; while it does,
    sample each tenant's charged ms in the last window from the token
    scheduler (``usage``) and the ms it has been charged since it
    registered: its session's execution ms, the ``used_ms`` the proxy
    hands the scheduler (``held``). Returns each tenant's record and its
    samples; with ``reap`` False once every record is written, the
    processes left to :func:`_reap_run`."""
    procs, usage, held = run["procs"], {}, {}
    try:
        for name in procs:
            usage[name], held[name] = [], []
        with open(run["go"], "w") as f:
            f.write("go")
        deadline = time.monotonic() + run["seconds"] + 300
        while (any(p.poll() is None and (reap or not os.path.exists(
                run["outs"][n])) for n, p in procs.items())
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
        if reap or any(not os.path.exists(o) for o in run["outs"].values()):
            _reap_run(run)
    records = {}
    for name in procs:
        check(os.path.exists(run["outs"][name]),
              f"proxy tenant {name} wrote no record: "
              f"{_tail(run['logs'][name])}")
        with open(run["outs"][name]) as f:
            records[name] = json.load(f)
        records[name]["usage"] = usage[name]
        records[name]["held"] = held[name]
    return records


def _run_proxy_tenants(root: str, proxy, tenants, seconds: float,
                       base: str) -> dict:
    """One run's tenants started and run at once: :func:`_start_proxy_tenants`
    with its go file written right away, then
    :func:`_finish_proxy_tenants`."""
    go = os.path.join(base, "go-" + tenants[0][0].replace("/", "_"))
    return _finish_proxy_tenants(
        _start_proxy_tenants(root, proxy, tenants, seconds, base, go), proxy)


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


def proxy_prepare(root: str, dev) -> dict:
    """Phase 5f's part in this process before its tenants (see the module
    docstring): the eager step's first losses and the exported step's
    wall ms, then the proxy serving on the card with the phase's launch
    counts set to 0. Returns the phase's state for :func:`proxy_start`
    and :func:`proxy_finish`; :func:`proxy_close` ends it."""
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
    _reset_counts()
    plan = [("solo", [PROXY_SOLO], PROXY_SOLO_S)] + [
        (kind, list(entries), PROXY_PAIR_S)
        for kind, entries in PROXY_PAIRS.items()]
    base = tempfile.mkdtemp(prefix="kubeshare-proxy-")
    return {"root": root, "proxy": proxy, "base": base, "plan": plan,
            "go": {kind: os.path.join(base, f"go-{kind}")
                   for kind, _, _ in plan},
            "started": {}, "eager": eager, "step_ms": step_ms}


def proxy_start(ctx: dict, kinds) -> list:
    """Start the tenants of 5f's runs ``kinds`` ahead of the runs: each
    exports, compiles and runs its first step on the proxy, then waits for
    its run's go. Returns the runs started. The even pair starts first and
    alone (:func:`gate_phase` waits for it to be ready before it starts
    another tenant): a first execution that meets other tenants' compiles
    on the proxy is charged their load (2.2 s once when all five started
    together), and a pair's stride repays such a debt inside its common
    window, where the even pair is held to its share; the solo and the
    uneven pair are held over their lives."""
    runs = []
    for kind, entries, seconds in ctx["plan"]:
        if kind in kinds:
            ctx["started"][kind] = _start_proxy_tenants(
                ctx["root"], ctx["proxy"], entries, seconds, ctx["base"],
                ctx["go"][kind])
            runs.append(ctx["started"][kind])
    return runs


def proxy_close(ctx: dict) -> None:
    """End 5f (once): its tenants killed if still up, the proxy closed."""
    if ctx.get("closed"):
        return
    ctx["closed"] = True
    for run in ctx["started"].values():
        _kill_run(run)
    ctx["proxy"].close()
    shutil.rmtree(ctx["base"], ignore_errors=True)


def proxy_finish(ctx: dict, adam_per_step: int, layers: int) -> dict:
    """Phase 5f's runs once its tenants are ready (:func:`proxy_start`):
    the lone tenant's rate, each pair's reading, the first losses against
    the eager step, the launch counts of the whole phase and the compile's
    record."""
    proxy, plan, started = ctx["proxy"], ctx["plan"], ctx["started"]
    eager, step_ms = ctx["eager"], ctx["step_ms"]
    run_s = []
    try:
        _wait_ready_runs(list(started.values()))
        done = {}
        for kind, _, _ in plan:
            t_run = time.monotonic()
            done[kind] = _finish_proxy_tenants(started[kind], proxy,
                                               reap=False)
            run_s.append((kind, time.monotonic() - t_run))
        for run in started.values():
            _reap_run(run)
        solo = done.pop("solo")
        pairs = done
        launches = _counts()
        sessions_left = list(proxy._sessions)
    finally:
        proxy_close(ctx)
    log("proxy: seconds by run (go to the last record): " + ", ".join(
        f"{kind} {secs:.1f}" for kind, secs in run_s))
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
    # wall ms a step from the first step end after the run's go
    per_step = {n: {"wall_ms": 1000.0 * (r["ends"][-1]
                                         - r["ends"][r["go_index"]])
                               / (len(r["ends"]) - 1 - r["go_index"]),
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


def manifest_commands(path: str) -> dict:
    """Each container's ``command:`` in a manifest of ``deploy/torch/``,
    by container name. Read without PyYAML, which the card's machine
    lacks: a container starts at its ``- name:`` line, and its command is
    one JSON list (the manifests write it so)."""
    commands, name, parts = {}, None, None
    with open(path) as f:
        for line in f:
            text = line.strip()
            if parts is not None:
                parts.append(text)
            elif text.startswith("- name:"):
                name = text.split(":", 1)[1].strip()
                continue
            elif text.startswith("command:"):
                parts = [text.split(":", 1)[1].strip()]
            else:
                continue
            if text.endswith("]"):
                commands[name] = json.loads(" ".join(parts))
                parts = None
    return commands


def place_argv(root: str, base: str, label: str, **values) -> list:
    """The ``python -m`` arguments of 5i's daemon ``label``: its
    container's argv in ``PLACE_MANIFESTS``' manifest with that table's
    host values (``{port}`` a free port, for the collector's metrics,
    which it does not report; ``{dir}`` a directory of the
    daemon's own under ``base``, the rest from ``values``) and 5i's flags
    appended. Fails if the manifest's command is not ``python -m`` of
    the port or lacks a flag the table changes."""
    manifest, container, flags, extra = PLACE_MANIFESTS[label]
    path = os.path.join(root, PLACE_MANIFEST_DIR, manifest)
    argv = manifest_commands(path).get(container, [])
    check(argv[:2] == ["python", "-m"] and len(argv) > 2
          and argv[2].startswith("kubeshare_tpu_torch."),
          f"5i: {manifest}'s {container} runs {argv}")
    values = dict(values, label=label, dir=os.path.join(base, label))
    os.makedirs(values["dir"], exist_ok=True)
    args = argv[2:]
    for flag, value in flags.items():
        check(flag in args[:-1],
              f"5i: {manifest}'s {container} has no {flag}: {argv}")
        i = args.index(flag)
        if value is None:
            del args[i:i + 2]
        else:
            args[i + 1] = value.format(port=_free_port(), **values)
    return args + [x.format(**values) for x in extra]


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


def _background_stream(client, at=None) -> dict:
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
    round trip. ``at`` is ``(n, fn)``: ``fn()`` runs once the first n
    pods are in."""
    rng = random.Random(PLACE_SEED)
    rtt, bound, gangs = [], [], []
    refused = pending_pairs = 0
    i = 0
    while i < PLACE_BACKGROUND_PODS:
        if at is not None and i >= at[0]:
            at[1]()
            at = None
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


def _replay_phase(trace: str, base: str) -> dict:
    """The leader's decision trace (``GET /decisions/trace``) through the
    port's replay plane: rebased to its fleet entry's instant (the
    service's clock is the host's monotonic one, the replay's starts at
    0), given a short drain, replayed through a sharded build like the
    leader's, then ``topcli --replay-diff --shard-equiv --json`` on the
    two traces, in this process."""
    import contextlib
    import io

    from kubeshare_tpu_torch import topcli
    from kubeshare_tpu_torch.obs.decisions import (parse_trace_jsonl,
                                                   trace_jsonl)
    from kubeshare_tpu_torch.replay import replay_trace

    parsed = parse_trace_jsonl(trace)
    header, entries = parsed["header"], parsed["entries"]
    check(header.get("dropped") == 0 and entries
          and entries[0]["kind"] == "fleet" and entries[0]["nodes"],
          f"5i: the decision trace lost its head: {header}")
    t0 = entries[0]["t"]
    for e in entries:
        e["t"] = round(e["t"] - t0, 6)
    header = dict(header, meta=dict(header.get("meta") or {},
                                    drain_s=PLACE_REPLAY_DRAIN_S))
    recorded = "\n".join(json.dumps(x, sort_keys=True)
                         for x in [header, *entries]) + "\n"
    inputs = [e for e in entries
              if e["kind"] in ("submit", "delete", "node-health")]
    t1 = time.perf_counter()
    rep = replay_trace(recorded, tick_s=PLACE_REPLAY_TICK_S,
                       config={"shards": PLACE_SHARDS,
                               "shard_route": "cell"})
    replay_s = time.perf_counter() - t1
    paths = [os.path.join(base, f"decisions-{k}.jsonl")
             for k in ("recorded", "replayed")]
    for path, text in zip(paths, (recorded, trace_jsonl(rep))):
        with open(path, "w") as f:
            f.write(text)
    buf = io.StringIO()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = topcli.main(["--replay-diff", paths[0], "--against", paths[1],
                          "--shard-equiv", "--json"])
    diff_s = time.perf_counter() - t1
    diff = json.loads(buf.getvalue())
    check(rc in (0, 1) and rc == (0 if diff["identical"] else 1)
          and diff["pods"]["recorded"] > 0,
          f"5i: topcli --replay-diff exited {rc}: {buf.getvalue()[:2000]}")
    counts = {k: len(diff[k]) for k in ("moved", "denied", "delayed",
                                        "missing", "extra")}
    counts.update(identical=diff["identical"], pods=diff["pods"],
                  rng_divergence=diff["rng_divergence"])
    extra = _replay_extras(entries, rep.entries(), diff["extra"])
    check(extra["pending_at_cut"] == counts["extra"],
          f"5i: a pod extra in the replay was not pending when the trace "
          f"was taken: {json.dumps(extra)}")
    return {"entries": len(entries), "inputs": len(inputs),
            "span_s": max((e["t"] for e in inputs), default=0.0),
            "replay_s": replay_s, "diff_s": diff_s, "rc": rc,
            "counts": counts, "extra": extra}


def _replay_extras(recorded: list, replayed: list, extra: list) -> dict:
    """What the recording says of each pod the replay settled and the
    recording did not: pending at the cut (submitted, and no outcome or
    delete after its last submit), gang members among them, how long
    before the cut they were submitted, and whether the replay bound
    them after the cut (in its drain) or before it."""
    from kubeshare_tpu_torch import constants as C

    # the last pod decision: the dispatcher's clock (a ``leadership``
    # entry carries the lease's wall clock)
    cut = max(e["t"] for e in recorded if "pod" in e)
    extra = set(extra)
    submit: dict = {}       # pod -> its last submit, None once settled
    for e in recorded:
        if e.get("pod") not in extra:
            continue
        if e["kind"] == "submit":
            submit[e["pod"]] = e
        elif e["kind"] in ("outcome", "delete"):
            submit[e["pod"]] = None
    pending = sorted(p for p, e in submit.items() if e is not None)
    bound_t = {e["pod"]: e["t"] for e in replayed
               if e.get("kind") == "outcome" and e.get("status") == "bound"
               and e.get("pod") in extra}
    ages = [cut - submit[p]["t"] for p in pending]
    return {"pending_at_cut": len(pending),
            "gang_members": sum(1 for p in pending
                                if submit[p].get("labels", {}).get(
                                    C.POD_GROUP_NAME)),
            "submitted_s_before_cut": [round(min(ages, default=0.0), 6),
                                       round(max(ages, default=0.0), 6)],
            "bound_after_cut": sum(1 for p in pending
                                   if bound_t.get(p, -1.0) > cut),
            "bound_before_cut": sum(1 for p in pending
                                    if 0.0 <= bound_t.get(p, -1.0) <= cut)}


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


def _replaced_by_dispatcher(pod: str, where: tuple, entries: list,
                            span: tuple):
    """The leader's last decision on ``pod`` in its decision trace, if it
    is the dispatcher placing the pod on ``where``'s node (a bind,
    ``outcome``, of a retried gang member, or its gang booked across
    shards, ``gang-cross-shard``) and the pod's bind there was resolved
    within ``span`` (monotonic seconds, the service's clock too; a
    ``gang-cross-shard`` entry carries its protocol's start, its members'
    ``outcome`` entries the commit). None otherwise: a plane's ``move`` or
    ``resize``, an older bind, or none."""
    mine = [e for e in entries
            if e.get("pod") == pod or pod in e.get("members", {})]
    if not mine:
        return None
    last = mine[-1]
    if last.get("kind") == "outcome":
        node = last.get("node") if last.get("status") == "bound" else None
    elif last.get("kind") == "gang-cross-shard":
        node = last["members"][pod]
    else:
        return None
    bound = [e for e in mine if e.get("kind") == "outcome"
             and e.get("status") == "bound" and e.get("node") == node]
    return (last if node == where[0] and bound
            and span[0] <= bound[-1]["t"] <= span[1] else None)


def dry_run_changes(plan: dict, before: dict, after: dict, entries: list,
                    span: tuple) -> tuple:
    """What a plane's dry run (``POST /<plane>/plan``) may not have done:
    of the pods placed at both reads, before and after it (within
    ``span``, monotonic seconds), those whose node, devices or request
    changed, split into those the live dispatcher placed meanwhile (a
    pending gang member, which ``GET /state`` may list with a node
    before its bind, bound at a retry or booked across shards with its
    pair), as the leader's decision trace ``entries`` shows
    (:func:`_replaced_by_dispatcher`), and the rest. A pod the plan names
    is never the dispatcher's. Returns ``(replaced, wrong)``, a row a pod
    with its decision."""
    named = json.dumps(plan)
    replaced, wrong = [], []
    for pod in sorted(k for k in before.keys() & after.keys()
                      if before[k] != after[k]):
        decision = (None if json.dumps(pod) in named
                    else _replaced_by_dispatcher(pod, after[pod], entries,
                                                 span))
        row = {"pod": pod, "before": before[pod], "after": after[pod],
               "decision": decision}
        (replaced if decision is not None else wrong).append(row)
    return replaced, wrong


def _check_dry_run(what: str, url: str, plan: dict, before: dict,
                   after: dict, span: tuple) -> list:
    """Fail 5i on a change :func:`dry_run_changes` does not put on the
    dispatcher, read against the leader's decision trace at ``url``;
    returns the pods the dispatcher re-placed."""
    import urllib.request

    from kubeshare_tpu_torch.obs.decisions import parse_trace_jsonl

    if all(before[k] == after[k] for k in before.keys() & after.keys()):
        return []
    with urllib.request.urlopen(f"{url}/decisions/trace", timeout=60) as r:
        entries = parse_trace_jsonl(r.read().decode())["entries"]
    replaced, wrong = dry_run_changes(plan, before, after, entries, span)
    pods = {json.dumps(w["pod"]) for w in wrong}
    check(not wrong, f"5i: {what} moved or resized pods: {wrong[:5]}; the "
                     f"trace's entries on them: " + json.dumps(
                         [e for e in entries
                          if any(p in json.dumps(e) for p in pods)][-20:]))
    return replaced


def place_phase(root: str, adam_per_step: int, layers: int) -> dict:
    """Phase 5i: a pod from a Kubernetes object to a tenant on the card,
    through a leader failover. The port's registry and a follower of it,
    collector (``--backend cuda``), configd, two scheduler services
    (``svc-a``, ``svc-b``: four cell-routed shards, health watch, a
    ``leader:scheduler`` election), pod-event bridge (over both services)
    and admission webhook run as processes, each from its container's
    argv in ``deploy/torch/`` (:func:`place_argv`), a fake kube-apiserver
    here. The launcher and its proxy remote-write their metrics to the
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

    values = {"node": chip.host, "scheduler_dir": node.base}

    def start(label):
        """Start PLACE_MANIFESTS' daemon ``label`` from its manifest."""
        daemons[label] = _start_daemon(root, node.base, label, place_argv(
            root, node.base, label, **values))

    def ready(label):
        proc, log_path = daemons[label]
        return _wait_ready(log_path, f"the {label}", proc=proc)

    try:
        start("registry")
        reg_port = values["registry_port"] = int(ready("registry").split()[1])
        # the daemons that need only the registry start together
        for label in ("follower", "collector", "configd", "webhook"):
            start(label)
        follow_port = int(ready("follower").split()[1])
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
            start(holder)
            urls[holder] = f"http://127.0.0.1:{ready(holder).split()[1]}"
            if holder == PLACE_SERVICES[0]:
                # the first leads, unfrozen, before the second contests
                _poll(lambda: (lambda st: st.get("role") == "leader"
                               and st.get("frozen") is False)(
                    ServiceClient(urls[holder]).ha()),
                    f"{holder}'s election", 30)
        lead_url, standby_url = (urls[h] for h in PLACE_SERVICES)
        api = FakeKubeApi()
        values.update(services=f"{lead_url},{standby_url}", api=api.url)
        start("bridge")
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
        traces = []

        def fetch_trace():
            import urllib.request

            with urllib.request.urlopen(f"{lead_url}/decisions/trace",
                                        timeout=60) as r:
                traces.append(r.read().decode())

        bg = out["background"] = _background_stream(
            client, at=(PLACE_REPLAY_PODS, fetch_trace))
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

        # the autopilot and elastic planes, attached: the fragmentation
        # of the whole fleet, a dry-run plan that touches nothing, and
        # the elastic plane's view of the background's gangs
        ap = client.autopilot()
        leaves = sum(n["leaves"] for n in ap.get("per_node", {}).values())
        check(ap.get("attached") is True and ap.get("enabled") is True
              and leaves == out["fleet"]["devices"]
              and 0.0 <= ap.get("fragmentation", -1.0) <= 1.0,
              f"5i: GET /autopilot: {json.dumps(ap)[:2000]}")
        # a placed pod's node, chips and request; the live dispatcher may
        # bind or re-book a pending pair between two reads, so a dry run
        # is held to the pods placed in both (_check_dry_run)
        def placed():
            return {k: (v["node"], v["chips"], v["request"])
                    for k, v in state()["pods"].items() if v["node"]}

        t_read = time.monotonic()
        pods0 = placed()
        t0 = time.perf_counter()
        code, body = client._call("POST", "/autopilot/plan", {})
        plan_ms = (time.perf_counter() - t0) * 1e3
        check(code == 200 and "plan" in body,
              f"5i: POST /autopilot/plan answered {code}: {body}")
        plan = body["plan"]
        replaced = _check_dry_run("the autopilot's dry-run plan", lead_url,
                                  plan, pods0, placed(),
                                  (t_read, time.monotonic()))
        check(client.autopilot().get("applied_total") == 0,
              "5i: the autopilot's dry run applied a plan")
        el = client.elastic()
        check(el.get("attached") is True and el.get("enabled") is True
              and el.get("resizes_total") == 0,
              f"5i: GET /elastic: {json.dumps(el)[:2000]}")
        code, rz = client._call("GET", "/rightsize")
        check(code == 200 and rz.get("attached") is True
              and rz.get("enabled") is True
              and rz["config"]["elastic_grow"] is True,
              f"5i: GET /rightsize answered {code}: {json.dumps(rz)[:2000]}")
        t_read = time.monotonic()
        pods2 = placed()
        t0 = time.perf_counter()
        code, body = client._call("POST", "/rightsize/plan", {})
        rz_plan_ms = (time.perf_counter() - t0) * 1e3
        check(code == 200 and "plan" in body,
              f"5i: POST /rightsize/plan answered {code}: {body}")
        rz_plan = body["plan"]
        pods3 = placed()
        bound_between = len(pods3.keys() - pods2.keys())
        gone_between = len(pods2.keys() - pods3.keys())
        replaced += _check_dry_run("the rightsizer's dry-run plan", lead_url,
                                   rz_plan, pods2, pods3,
                                   (t_read, time.monotonic()))
        check(client._call("GET", "/rightsize")[1]["applied_total"] == 0,
              "5i: the rightsizer's dry run applied a plan")
        out["planes"] = {
            "fragmentation": ap["fragmentation"],
            "stranded_free": ap["stranded_free"],
            "total_free": ap["total_free"], "devices": leaves,
            "largest_placeable_gang": ap["largest_placeable_gang"],
            "plan_ms": plan_ms, "plan_moves": len(plan["moves"]),
            "plan_skipped": len(plan["skipped"]),
            "plan_after": plan["fragmentation_after"],
            "plan_reason": plan.get("reason", ""),
            "elastic_gangs": len(el["gangs"]),
            "elastic_config": el["config"],
            "rightsize_plan_ms": rz_plan_ms,
            "rightsize_plan_bound_between": bound_between,
            "rightsize_plan_gone_between": gone_between,
            "replaced_between": replaced,
            "rightsize_plan": {k: rz_plan.get(k) for k in (
                "resizes", "moves", "skipped", "chip_equivalents",
                "elastic")}}
        log(f"5i: GET /autopilot over {leaves} devices: fragmentation "
            f"{ap['fragmentation']} ({ap['stranded_free']:.2f} of "
            f"{ap['total_free']:.2f} free stranded), largest placeable "
            f"gang {ap['largest_placeable_gang']}; POST /autopilot/plan "
            f"round trip {plan_ms:.1f} ms: {len(plan['moves'])} moves "
            f"(fragmentation -> {plan['fragmentation_after']}, "
            f"{len(plan['skipped'])} skipped; "
            f"{plan.get('reason', 'improving')}), nothing moved; GET "
            f"/elastic: {len(el['gangs'])} gangs, {el['resizes_total']} "
            f"resizes; POST /rightsize/plan round trip {rz_plan_ms:.1f} ms: "
            f"{len(rz_plan['resizes'])} resizes, {len(rz_plan['moves'])} "
            f"moves, {len(rz_plan.get('elastic', []))} elastic grows, "
            f"chip-equivalents {rz_plan['chip_equivalents']}, nothing "
            f"moved, resized or applied ({bound_between} pods bound and "
            f"{gone_between} gone meanwhile; re-placed by the dispatcher "
            f"during the dry runs, each with its decision: "
            f"{json.dumps(replaced)}) (host numbers)")
        lap("planes")

        out["replay"] = _replay_phase(traces[0], node.base)
        rp = out["replay"]
        log(f"5i: the leader's decision trace after the first "
            f"{PLACE_REPLAY_PODS} background pods ({rp['entries']} "
            f"entries, {rp['inputs']} inputs, {rp['span_s']:.2f} s of the "
            f"service's clock) replayed through replay_trace on "
            f"{PLACE_SHARDS} cell-routed shards at a {PLACE_REPLAY_TICK_S} "
            f"s tick in {rp['replay_s']:.2f} s; topcli --replay-diff "
            f"--shard-equiv exited {rp['rc']} in {rp['diff_s']:.2f} s: "
            f"{rp['counts']}; the extra pods in the recording: "
            f"{json.dumps(rp['extra'])} (host numbers)")
        lap("replay")

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
                        pod_envs=envs, meet=True)
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
        start("collector")
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
    for name in ("chip", "ha", "autopilot", "rightsize", "elastic"):
        check(any(line.split()[:2] == [name, "ok"] for line in lines),
              f"5i: the doctor's {name} check: {lines}")
    return {"seconds": time.monotonic() - t0, "lines": lines}


# --- phase 5j: the zoo -----------------------------------------------------------

def _zoo_model(label: str):
    """``(module, init_fn, loss_fn)`` of one of ZOO's models."""
    from kubeshare_tpu_torch.models import get_model

    _, name, kw, loss = next(z for z in ZOO + (LM_MEMBER,)
                             if z[0] == label)
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


def _trace_summary(trace_dir: str, traced: int, adam_per_step: int) -> dict:
    """Device ms a step (kernels, copies and memsets), kernels a step and
    the port's kernels' launches a step, from the chrome trace that
    ``run_training``'s profiler wrote into ``trace_dir``. The trace holds
    ``traced`` steps, its ``ProfilerStep#N`` spans (the first profiled
    step is the profiler's warm-up, not traced), and the summary reads
    all but the first ``TRACE_UNREAD`` of them: the first traced step
    may lack a kernel that ran (``scripts/torch_trace_drops.py``). The
    steps are cut on the card's own clock, not against the host's spans
    (whose offset to the kernels' times once moved a step's forward into
    the step before): a step ends with its ``adam_per_step`` Adam
    launches, so the steps read are the device events after the last
    ``(traced - TRACE_UNREAD) * adam_per_step`` Adam launches'
    predecessor, the last of the second traced step."""
    import glob

    (path,) = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sum(e.get("cat") == "user_annotation"
                and e.get("name", "").startswith("ProfilerStep#")
                for e in events)
    check(spans == traced, f"the trace in {trace_dir} holds {spans} "
                           f"steps, expected {traced}")
    tags = {"fused_adam": "adam_multi_tensor_kernel",
            "flash_fwd": "flash_fwd_", "flash_dq": "flash_dq_",
            "flash_dkv": "flash_dkv_", "flash_prep": "flash_prep_"}
    steps = traced - TRACE_UNREAD
    adams = sorted(e["ts"] for e in events if e.get("cat") == "kernel"
                   and tags["fused_adam"] in e["name"])
    check(len(adams) > steps * adam_per_step,
          f"the trace in {trace_dir} holds {len(adams)} Adam launches for "
          f"{traced} steps of {adam_per_step}")
    cut = adams[-steps * adam_per_step - 1]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and e["ts"] > cut]
    kernels = [e["name"] for e in device if e.get("cat") == "kernel"]
    return {"device_ms": sum(e.get("dur", 0.0) for e in device) / 1e3
            / steps,
            "kernels": len(kernels) / steps,
            "ours": {k: sum(tag in n for n in kernels) / steps
                     for k, tag in tags.items()},
            "trace_bytes": os.path.getsize(path), "steps": steps}


def zoo_run(dev, label: str, trace_dir: str, adam_per_step: int) -> dict:
    """The model alone on the card through ``run_training``: ZOO_STEPS
    timed steps (steps/s, wall ms a step), then ZOO_PROFILE_STEPS under
    its profiler (device ms, idle share and kernels a step over the steps
    :func:`_trace_summary` reads; ``adam_per_step`` Adam launches end a
    step)."""
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
    trace = _trace_summary(trace_dir, ZOO_PROFILE_STEPS - 1, adam_per_step)
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
        lap("killed")
        # started again at once, the uninterrupted run still beside it
        proc = launch("resumed", kill_ck)
        full_text = finish("full", full)
        text = finish("resumed", proc)
        lap("resumed and uninterrupted")
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


def _check_zoo_launches(label: str, rec: dict) -> None:
    """A zoo run's launches (``rec["launches"]``, counted over its
    exclusive and profiled runs) and those its trace shows a step: every
    step one Adam launch a table, and the LM's one of each flash pass a
    layer (the entry's own ``layers``)."""
    from kubeshare_tpu_torch.ops import flash_attention as fl

    mod, init_fn, _ = _zoo_model(label)
    got, ran = rec["launches"], rec["steps_run"]
    want = {"fused_adam": rec["adam_per_step"] * ran}
    if mod.__name__.endswith(".transformer"):
        kw = init_fn.keywords
        layers = kw.get("layers", mod.LAYERS)
        # the backward's prologue on the instances 64, 128 and 256 (bf16
        # runs)
        wide = (fl.instance_head_dim(kw.get("dim", mod.DIM) // mod.HEADS)
                in fl.WIDE_HEAD_DIMS)
        want.update({f"flash_{k}": layers * ran
                     for k in ("fwd", "dq", "dkv") + ("prep",) * wide})
    for kernel in got:
        check(got[kernel] == want.get(kernel, 0),
              f"5j {label}: {got[kernel]} {kernel} launches, expected "
              f"{want.get(kernel, 0)}")
    per_step = {k: n // ran for k, n in want.items()}
    check(all(abs(rec["ours_per_step"][k] - n) < 1e-9
              for k, n in per_step.items()),
          f"5j {label}: the trace's launches a step "
          f"{rec['ours_per_step']}, expected {per_step}")


def lm_member(out_path: str) -> int:
    """The process of 5j-lm: the LM at head dim 128 with the attention
    knobs of LM_MEMBER_ENV, which the transformer module read at import.
    The knobs must have taken (2 kv heads in the qkv product, RoPE, the
    window); then, as each zoo model, one fp32 train step on the card
    against the CPU and an exclusive and a profiled run through
    ``run_training`` with its launches counted. Writes its record to
    ``out_path``."""
    import torch

    from kubeshare_tpu_torch.models import transformer
    from kubeshare_tpu_torch.ops import fused_adam as fa
    from kubeshare_tpu_torch.utils.tree import tree_leaves

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    label = LM_MEMBER[0]
    knobs = {"kv_heads": transformer.KV_HEADS,
             "rope": transformer.USE_ROPE, "window": transformer.WINDOW}
    check(knobs == {"kv_heads": 2, "rope": True, "window": 128},
          f"5j-lm: the transformer read the knobs as {knobs}")
    _, init_fn, _ = _zoo_model(label)
    params = init_fn(0)
    dim, hd = LM_MEMBER[2]["dim"], LM_MEMBER[2]["dim"] // transformer.HEADS
    qkv = params["blocks"][0]["attn"]["qkv"].shape
    check(qkv == (dim, dim + 2 * 2 * hd),
          f"5j-lm: qkv {qkv}, expected {(dim, dim + 4 * hd)}")
    leaves = tree_leaves(params)
    rec = {"knobs": knobs, "head_dim": hd, "leaves": len(leaves),
           "params": int(sum(a.size for a in leaves)),
           "adam_per_step": fa.tree_launches(leaves),
           "step_check": zoo_step_check(dev, label)}
    del params, leaves
    torch.cuda.empty_cache()
    trace_dir = tempfile.mkdtemp(prefix="kubeshare-lm-member-")
    try:
        _reset_counts()
        rec.update(zoo_run(dev, label, trace_dir, rec["adam_per_step"]))
        rec["launches"] = _counts()
        rec["instance_launches"] = dict(INSTANCE_LAUNCHES)
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    with open(out_path, "w") as f:
        json.dump(rec, f)
    return 0


def lm_member_phase(root: str) -> dict:
    """5j-lm: ``chip_smoke.py --lm-member`` in a process of its own with
    LM_MEMBER_ENV; its record's launches checked here as 5j checks each
    model's."""
    t0 = time.monotonic()
    base = tempfile.mkdtemp(prefix="kubeshare-lm-member-")
    out = os.path.join(base, "lm-member.json")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KUBESHARE_TPU_")}
    env.update(PYTHONPATH=root, **LM_MEMBER_ENV)
    log_path = os.path.join(base, "lm-member.log")
    try:
        with open(log_path, "w") as log_file:
            proc = subprocess.Popen(
                [sys.executable, os.path.join(root, "chip_smoke.py"),
                 "--lm-member", out], env=env, cwd=root, stdout=log_file,
                stderr=subprocess.STDOUT)
            try:
                rc = proc.wait(timeout=600)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                fail(f"5j-lm: no end in 600 s: {_tail(log_path)}")
        check(rc == 0 and os.path.exists(out),
              f"5j-lm exited {rc}: {_tail(log_path)}")
        with open(out) as f:
            rec = json.load(f)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    _check_zoo_launches(LM_MEMBER[0], rec)
    rec["seconds"] = time.monotonic() - t0
    return rec


def zoo_phase(dev, rng) -> dict:
    """Phase 5j: each ZOO model's card-vs-CPU step, its whole tree through
    the Adam kernel against the plain version, its exclusive and profiled
    runs (launch counts reset before each model and read after). The
    resumable sweep through a node (:func:`sweep_phase`) runs later,
    beside 5k. Returns every reading, the launches of the in-process runs
    and the seconds by stage."""
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
            rec.update(zoo_run(dev, label, os.path.join(trace_root, label),
                               rec["adam_per_step"]))
            rec["launches"] = got = _counts()
            _check_zoo_launches(label, rec)
            for kernel in out["launches"]:
                out["launches"][kernel] += got[kernel]
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
    out["seconds"] = time.monotonic() - t0
    return out


# --- phase 5k: gangs -------------------------------------------------------------

def lse_cotangent_check(dev, rng) -> dict:
    """``flash_attention_lse`` through autograd at LSE_SHAPE and
    LSE_WIDE_SHAPE (head dim 128) in bf16, causal and not, with a random
    nonzero cotangent for both O and the lse (what ring attention's merge
    feeds back): O, the lse, dQ, dK and dV against the plain versions at
    KERNEL_TOL. Returns each one's max abs error, worst over both masks
    and shapes."""
    import torch

    from kubeshare_tpu_torch.ops import flash_attention as fl

    randn = lambda *shape: torch.from_numpy(rng.standard_normal(
        shape).astype("float32")).to(dev)
    worst: dict = {}
    for (b, s, h, d), causal in ((x, c) for x in (LSE_SHAPE, LSE_WIDE_SHAPE)
                                 for c in (True, False)):
        scale = 1.0 / math.sqrt(d)
        q, k, v = (randn(b, s, h, d).to(torch.bfloat16) for _ in range(3))
        g, g_lse = randn(b, s, h, d), randn(b, s, h)
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o, lse = fl.flash_attention_lse(*leaves, causal=causal)
        ((o * g).sum() + (lse * g_lse).sum()).backward()
        ro, rlse = fl.flash_fwd_reference(q, k, v, causal, None, scale)
        dcap = ((g * ro).sum(-1) - g_lse).transpose(1, 2)
        args = (q, k, v, g, rlse, dcap, causal, None, scale)
        rdk, rdv = fl.flash_dkv_reference(*args)
        torch.cuda.synchronize()
        label = (f"lse cotangent, head dim {d}, "
                 f"{'causal' if causal else 'non-causal'}")
        for name, got, want in (
                ("O", o.detach(), ro), ("lse", lse.detach(),
                                        rlse.transpose(1, 2)),
                ("dQ", leaves[0].grad, fl.flash_dq_reference(*args)),
                ("dK", leaves[1].grad, rdk), ("dV", leaves[2].grad, rdv)):
            err = _check_flash_close("lse", label, name, got, want)[0]
            worst[name] = max(worst.get(name, 0.0), err)
    log(f"  flash_attention_lse {LSE_SHAPE} and {LSE_WIDE_SHAPE} bf16, "
        "cotangents for O and lse: ok, max abs err " + ", ".join(
            f"{n} {e:.2e}" for n, e in worst.items()))
    return worst


def gang_member(out_path: str, cli_args: list) -> int:
    """A gang member of 5k: the transformer's CLI run as ``python -m``
    runs it (the shim already joined the gang at start-up), its
    ``TrainResult`` and the params of its last sharded step kept, then
    the record written to ``out_path``."""
    import hashlib
    import runpy

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from kubeshare_tpu_torch.models import common
    from kubeshare_tpu_torch.parallel import mesh as pmesh
    from kubeshare_tpu_torch.parallel import runner
    from kubeshare_tpu_torch.utils.tree import tree_leaves

    kept = {}
    real_training = common.run_training
    real_step = pmesh.make_sharded_train_step

    def run_training(*args, **kwargs):
        kept["result"] = real_training(*args, **kwargs)
        return kept["result"]

    def make_sharded_train_step(*args, **kwargs):
        step = real_step(*args, **kwargs)

        def kept_step(params, opt_state, batch):
            out = step(params, opt_state, batch)
            kept["params"] = out[0]
            return out
        return kept_step

    common.run_training = run_training
    pmesh.make_sharded_train_step = make_sharded_train_step
    _reset_counts()
    sys.argv = ["kubeshare_tpu_torch.models.transformer", *cli_args]
    t0 = time.perf_counter()
    runpy.run_module("kubeshare_tpu_torch.models.transformer",
                     run_name="__main__", alter_sys=True)
    wall = time.perf_counter() - t0
    res = kept["result"]
    leaves = []
    for x in tree_leaves(kept["params"]):
        local = x.to_local() if isinstance(x, DTensor) else x
        # whole on this rank: a Shard over an axis of size 1 splits nothing
        replicated = tuple(local.shape) == tuple(x.shape)
        data = local.detach().float().cpu().contiguous().numpy().tobytes()
        leaves.append({"replicated": replicated,
                       "digest": hashlib.sha256(data).hexdigest()})
    rec = {"rank": dist.get_rank() if dist.is_initialized() else 0,
           "world": dist.get_world_size() if dist.is_initialized() else 1,
           "backend": runner.backend(), "reason": runner.backend_reason(),
           "final_loss": res.final_loss, "first_loss": res.first_loss,
           "steps": res.steps, "start_step": res.start_step,
           "warmup_steps": res.warmup_steps, "seconds": res.seconds,
           "steps_per_sec": res.steps_per_sec, "wall_s": wall,
           "launches": _counts(), "leaves": leaves}
    with open(out_path, "w") as f:
        json.dump(rec, f)
    return 0


def _gang_env(root: str, port: int, rank: int, world: int,
              extra: dict) -> dict:
    """A whole-device gang member's env, as the gang manifest gives it:
    coordinator, world size and rank, the shim first on the path."""
    from kubeshare_tpu_torch import constants as C

    shim = os.path.join(root, "kubeshare_tpu_torch", "_shim")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KUBESHARE_TPU_")
           and k != C.ENV_VISIBLE_CHIPS}
    env.update({"PYTHONPATH": os.pathsep.join([shim, root]),
                C.ENV_COORDINATOR: f"127.0.0.1:{port}",
                C.ENV_NUM_PROCESSES: str(world),
                C.ENV_PROCESS_ID: str(rank),
                C.ENV_GROUP_NAME: "smoke-gang",
                C.ENV_RENDEZVOUS_TIMEOUT_S: "120", **extra})
    return env


def _gang_run(root: str, base: str, label: str, world: int, extra: dict,
              cli_args: list, kill_when=None, mode: str = "--gang-member",
              phase: str = "5k") -> list:
    """``world`` gang members of the LM's CLI (``mode`` ``--elastic-member``:
    5l's elastic ranks), side by side; their records (and stderr) once all
    exit. ``kill_when()`` True: SIGKILL them then."""
    from kubeshare_tpu_torch.utils.virtualcpu import free_port

    port = free_port()
    procs = []
    for rank in range(world):
        out = os.path.join(base, f"{label}-{rank}.json")
        errf = open(os.path.join(base, f"{label}-{rank}.log"), "w")
        args = [mode, out, "--", *cli_args] if cli_args else [mode, out]
        procs.append((subprocess.Popen(
            [sys.executable, os.path.join(root, "chip_smoke.py"), *args],
            env=_gang_env(root, port, rank, world, extra), cwd=root,
            stdout=errf, stderr=subprocess.STDOUT), out, errf))
    killed = False
    try:
        deadline = time.monotonic() + 300
        while any(p.poll() is None for p, _, _ in procs):
            check(time.monotonic() < deadline,
                  f"{phase} {label}: no end in 300 s")
            if kill_when is not None and not killed and kill_when():
                for p, _, _ in procs:
                    p.send_signal(signal.SIGKILL)
                killed = True
            time.sleep(0.01)
    finally:
        for p, _, errf in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            errf.close()
    recs = []
    for rank, (p, out, _) in enumerate(procs):
        text = _tail(os.path.join(base, f"{label}-{rank}.log"), 20000)
        if killed:
            recs.append({"log": text, "rc": p.returncode})
            continue
        check(p.returncode == 0 and os.path.exists(out),
              f"{phase} {label} rank {rank} exited {p.returncode}: "
              f"{text[-3000:]}")
        with open(out) as f:
            recs.append(dict(json.load(f), log=text))
    return recs


def gang_local(dev, rng) -> dict:
    """5k's part in this process: the lse cotangent on the card, then the
    one-process run every gang is held to (the CLI's defaults; launch
    counts reset before it and read after)."""
    from kubeshare_tpu_torch.models import common, transformer

    t0 = time.monotonic()
    _reset_counts()
    out: dict = {"lse_max_abs_err": lse_cotangent_check(dev, rng)}
    t1 = time.monotonic()
    _reset_counts()
    one = common.run_training(transformer.init, transformer.loss_fn,
                              transformer.batch_fn, GANG_STEPS, device=dev)
    out["launches"] = _counts()
    out["one_process"] = {"final_loss": one.final_loss,
                          "steps_per_sec": one.steps_per_sec}
    out["stages_s"] = {"lse cotangent": t1 - t0,
                       "one process": time.monotonic() - t1}
    return out


def gang_phase(root: str, local: dict, adam_per_step: int,
               layers: int) -> dict:
    """Phase 5k's gangs, after :func:`gang_local`: four two-rank LM gangs
    through the CLI, each held to the one-process run, and a one-rank
    NCCL gang's checkpoint resume, all five started together (each is a
    correctness check; their start-ups dominate). Returns every reading,
    the launches of the ranks and of the one-process run, and each
    stage's own wall seconds."""
    from kubeshare_tpu_torch.models import checkpoint as ck
    from kubeshare_tpu_torch.models import common, transformer
    from kubeshare_tpu_torch.ops.fused_adam import fused_adam

    t_phase = time.monotonic()
    out: dict = dict(local, runs={}, stages_s=dict(local["stages_s"]),
                     launches=dict(local["launches"]))
    one_loss = local["one_process"]["final_loss"]

    def add(counts):
        for k in out["launches"]:
            out["launches"][k] += counts[k]

    base = tempfile.mkdtemp(prefix="kubeshare-gang-")
    ckpt = os.path.join(base, "ckpt")
    cli = ["--steps", str(GANG_CKPT_STEPS), "--checkpoint", ckpt,
           "--checkpoint-every", str(GANG_CKPT_EVERY)]
    like = common.to_device(transformer.init(0), "cpu")
    ran = GANG_STEPS + GANG_WARMUP

    def mesh_run(label: str, mesh: str, attn: str):
        t0 = time.monotonic()
        extra = {}
        if mesh:
            extra["KUBESHARE_TPU_MESH"] = mesh
        if attn:
            extra["KUBESHARE_TPU_SP_ATTN"] = attn
        recs = _gang_run(root, base, label, 2, extra,
                         ["--steps", str(GANG_STEPS)])
        return recs, time.monotonic() - t0

    def nccl_run():
        # one rank on its own device: NCCL, with a checkpoint
        t0 = time.monotonic()
        _gang_run(root, base, "nccl-killed", 1, {}, cli,
                  kill_when=lambda: os.path.isdir(ckpt))
        _, _, saved = ck.load_checkpoint(ckpt, like, fused_adam().init(like))
        check(0 < saved < GANG_CKPT_STEPS and saved % GANG_CKPT_EVERY == 0,
              f"5k nccl: the killed run saved step {saved}")
        rec, = _gang_run(root, base, "nccl-resumed", 1, {}, cli)
        return saved, rec, time.monotonic() - t0

    try:
        with ThreadPoolExecutor(len(GANG_MESHES) + 1) as pool:
            runs = {label: pool.submit(mesh_run, label, mesh, attn)
                    for label, mesh, attn in GANG_MESHES}
            nccl = pool.submit(nccl_run)
            for label, mesh, attn in GANG_MESHES:
                recs, secs = runs[label].result()
                for rec in recs:
                    rank = rec["rank"]
                    check(rec["backend"] == "gloo"
                          and "share device" in rec["reason"]
                          and "backend gloo: ranks [0, 1] share device"
                          in rec["log"],
                          f"5k {label} rank {rank}: backend "
                          f"{rec['backend']} ({rec['reason']})")
                    check(abs(rec["final_loss"] - one_loss)
                          <= GANG_LOSS_RTOL * abs(one_loss),
                          f"5k {label} rank {rank}: final loss "
                          f"{rec['final_loss']} against one process's "
                          f"{one_loss}")
                    want = {"fused_adam": adam_per_step * ran,
                            "flash_prep": 0}
                    per = GANG_FLASH_PER_LAYER[label][rank] * layers * ran
                    want.update({f"flash_{k}": per
                                 for k in ("fwd", "dq", "dkv")})
                    check(rec["launches"] == want,
                          f"5k {label} rank {rank}: launches "
                          f"{rec['launches']}, expected {want}")
                    add(rec["launches"])
                check(recs[0]["final_loss"] == recs[1]["final_loss"],
                      f"5k {label}: the ranks report losses "
                      f"{recs[0]['final_loss']} and {recs[1]['final_loss']}")
                same = [a["digest"] == b["digest"]
                        for a, b in zip(recs[0]["leaves"], recs[1]["leaves"])
                        if a["replicated"]]
                check(same and all(same), f"5k {label}: replicated leaves "
                      f"differ between the ranks ({same.count(False)} of "
                      f"{len(same)})")
                out["runs"][label] = {
                    "mesh": mesh or "default", "sp_attn": attn or None,
                    "final_loss": [r["final_loss"] for r in recs],
                    "loss_rel_err": abs(recs[0]["final_loss"] - one_loss)
                    / abs(one_loss),
                    "steps_per_sec": [r["steps_per_sec"] for r in recs],
                    "wall_s": [r["wall_s"] for r in recs],
                    "replicated_leaves": len(same),
                    "launches": [r["launches"] for r in recs]}
                out["stages_s"][label] = secs
                log(f"5k {label}: {json.dumps(out['runs'][label])}")
            saved, rec, secs = nccl.result()
        check(rec["backend"] == "nccl",
              f"5k nccl: backend {rec['backend']} ({rec['reason']})")
        check(rec["start_step"] == saved and rec["warmup_steps"] == 0
              and rec["steps"] == GANG_CKPT_STEPS - saved
              and f"resumed at step {saved} from {ckpt}" in rec["log"],
              f"5k nccl: resumed at {rec['start_step']} for "
              f"{rec['steps']} steps, saved {saved}: {rec['log'][-2000:]}")
        _, state, at = ck.load_checkpoint(ckpt, like, fused_adam().init(like))
        check(at == GANG_CKPT_STEPS
              and float(state["count"]) == GANG_CKPT_STEPS + GANG_WARMUP,
              f"5k nccl: the final checkpoint is at step {at}, Adam count "
              f"{float(state['count'])}")
        add(rec["launches"])
        out["nccl_checkpoint"] = {
            "backend": rec["backend"], "reason": rec["reason"],
            "saved_step": saved, "resumed_steps": rec["steps"],
            "final_loss": rec["final_loss"],
            "steps_per_sec": rec["steps_per_sec"]}
        out["stages_s"]["nccl checkpoint"] = secs
        log(f"5k nccl: {json.dumps(out['nccl_checkpoint'])}")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    out["seconds"] = (time.monotonic() - t_phase
                      + sum(local["stages_s"].values()))
    return out


# --- phase 5l: the autopilot's quota and the elastic plane ----------------------

def _quota_reading(sched, proxy, steps: dict, seconds: float) -> dict:
    """The borrower's and the lender's window share (scheduler's
    ``window_usage``, sampled), the borrower's device share (the proxy's
    execution ms) and steps/s, over ``seconds``."""
    names = (QUOTA_LENDER[0], QUOTA_BORROWER[0])
    b = QUOTA_BORROWER[0]
    sess = proxy._sessions[b]
    shares = {n: [] for n in names}
    t0, ms0, n0 = time.monotonic(), sess.exec_ms_total, steps[b]
    while time.monotonic() - t0 < seconds:
        for n in names:
            shares[n].append(sched.window_usage(n) / WINDOW_MS)
        time.sleep(QUOTA_SAMPLE_S)
    span = time.monotonic() - t0
    return {"window_share": {n: sum(v) / len(v) for n, v in shares.items()},
            "borrower_exec_share": (sess.exec_ms_total - ms0)
            / (span * 1000.0),
            "borrower_steps_per_sec": (steps[b] - n0) / span,
            "seconds": span}


def quota_phase(dev, adam_per_step: int, layers: int) -> dict:
    """5l-quota: a ``ChipProxy`` on the card with the native-core token
    scheduler (window WINDOW_MS) and an ``ElasticQuota`` attached to it;
    two threaded ``ProxyClient``s train the full-width flash LM through
    ``compile_loop`` + ``chain``: the lender (request 0.5, limit 1.0)
    briefly, then idles; the borrower (0.25 / 0.25) all along. Read: the
    borrower's share before lending, the grant (0.75 of the lender's
    measured headroom), its share while lent (the quota stepping on a
    cadence), the revocation inside the lender's first demand when it
    trains again, and its share after. Launches: exactly the LM step's
    per step of either client.

    Then 5l-rightsize on the same proxy, scheduler and clients
    (:func:`_rightsize_run`): both clients pause between chain calls
    while 5l-quota's counts are read and the counts go to 0, the quota
    is detached, and they go on as 5l-rightsize's tenants; its counts
    are read once both have stopped."""
    import numpy as np

    from kubeshare_tpu_torch.autopilot import ElasticQuota
    from kubeshare_tpu_torch.autopilot import elastic as quota_mod
    from kubeshare_tpu_torch.constants import BASE_QUOTA_MS, MIN_QUOTA_MS
    from kubeshare_tpu_torch.isolation import programs
    from kubeshare_tpu_torch.isolation.client import ProxyClient
    from kubeshare_tpu_torch.isolation.proxy import ChipProxy
    from kubeshare_tpu_torch.isolation.tokensched import TokenScheduler
    from kubeshare_tpu_torch.models import transformer
    from kubeshare_tpu_torch.obs.blame import BlameGraph
    from kubeshare_tpu_torch.obs.ledger import ChipTimeLedger
    from kubeshare_tpu_torch.topology.discovery import (FakeTopology,
                                                        discover_chips)
    from kubeshare_tpu_torch.utils.tree import tree_leaves

    t_phase = time.monotonic()
    lender, borrower = QUOTA_LENDER[0], QUOTA_BORROWER[0]
    # the card as 5l-rightsize's engine books it; the scheduler feeds a
    # chip-time ledger and a blame graph under its id from the start
    chip = (discover_chips("cuda") if dev.type == "cuda"
            else FakeTopology(hosts=1, mesh=(1,)).chips())[0]
    ledger = ChipTimeLedger()
    sched = TokenScheduler(WINDOW_MS, BASE_QUOTA_MS, MIN_QUOTA_MS,
                           chip=chip.chip_id, ledger=ledger,
                           blame=BlameGraph(ledger))
    proxy = ChipProxy(device=dev, scheduler=sched)
    proxy.serve()
    quota = ElasticQuota().attach("card", sched)
    revokes0 = quota_mod._REVOKES.value("lender-demand")
    # the counts go to 0 once both clients have compiled
    ready = threading.Barrier(3, timeout=300, action=_reset_counts)
    # 5l-quota ends and 5l-rightsize starts at this barrier's two waits
    handover = threading.Barrier(3, timeout=300)
    a_idle, a_resume, stop, hand, idle = (threading.Event()
                                          for _ in range(5))
    steps = {lender: 0, borrower: 0}
    losses: dict = {lender: [], borrower: []}
    # per chain call: (its end, monotonic s; wall s a step; steps)
    walls: dict = {lender: [], borrower: []}
    errors: dict = {}

    def client(name: str, request: float, limit: float, seed: int) -> None:
        try:
            with ProxyClient("127.0.0.1", proxy.port, name, request,
                             limit) as c:
                carry = c.put_tree(programs.initial_carry(LM_SPEC, seed))
                batch = c.put_tree(tuple(transformer.batch_fn(seed + 1)))
                loop = c.compile_loop(LM_SPEC, carry, *batch)
                ready.wait()

                def chain(n=QUOTA_CHAIN):
                    nonlocal carry
                    t0 = time.monotonic()
                    carry, loss = loop.chain(n, carry, *batch)
                    steps[name] += loop.last_n
                    losses[name].append(float(c.get(loss)))
                    c.free(loss)
                    t1 = time.monotonic()
                    walls[name].append((t1, (t1 - t0) / loop.last_n,
                                        loop.last_n))

                if name == lender:
                    t_end = time.monotonic() + QUOTA_WARM_S
                    while time.monotonic() < t_end:
                        chain()
                    a_idle.set()
                    check(a_resume.wait(300), "5l-quota: no resume")
                paused = False
                while not stop.is_set():
                    if hand.is_set() and not paused:
                        paused = True
                        handover.wait()     # 5l-quota's counts are read
                        handover.wait()     # 5l-rightsize starts
                    if name == lender and idle.is_set():
                        chain(1)
                        time.sleep(RZ_THINK_S)
                    else:
                        chain(RZ_CHAIN if paused else QUOTA_CHAIN)
                leaves = tree_leaves(c.get_tree(carry))
                check(all(np.isfinite(x).all() for x in leaves),
                      f"5l-quota {name}: carry not finite")
        except BaseException:
            errors[name] = traceback.format_exc()
            ready.abort()
            handover.abort()
            a_idle.set()

    threads = [threading.Thread(target=client, args=(n, rq, lm, seed),
                                name=n)
               for (n, rq, lm), seed in ((QUOTA_LENDER, 30),
                                         (QUOTA_BORROWER, 40))]
    cadence_stop = threading.Event()
    steps_seen: list = []

    def cadence() -> None:
        while not cadence_stop.wait(QUOTA_STEP_EVERY_S):
            steps_seen.append(quota.step()["card"])

    out: dict = {}
    cad = threading.Thread(target=cadence, name="quota-cadence")
    try:
        for t in threads:
            t.start()
        ready.wait()
        check(a_idle.wait(300) and not errors,
              f"5l-quota: the clients failed: {errors}")
        time.sleep(QUOTA_IDLE_S)
        out["before"] = _quota_reading(sched, proxy, steps, QUOTA_READ_S)
        # the grant: the lender's window usage read under the lock the
        # step takes, so both see one window; taken while the borrower
        # waits at its cap (it does most of the time), since a borrower
        # mid-burst shows neither a wait nor the hold in progress
        t0 = time.monotonic()
        while True:
            with sched._cond:
                if (borrower in sched.waiting()
                        or time.monotonic() - t0 > QUOTA_GRANT_WAIT_S):
                    used = sched.window_usage(lender) / WINDOW_MS
                    grant = quota.step()["card"]
                    break
            time.sleep(0.001)
        headroom = QUOTA_LENDER[1] - used
        out["grant"] = dict(grant, lender_usage=used, headroom=headroom,
                            effective=sched.effective(borrower),
                            base=sched.shares(),
                            waited_s=time.monotonic() - t0)
        cad.start()
        time.sleep(QUOTA_SETTLE_S)
        out["lent"] = _quota_reading(sched, proxy, steps, QUOTA_READ_S)
        cadence_stop.set()
        cad.join()
        out["revocations_while_lent"] = quota.revocations
        # the lender's demand returns: B must be at base inside the hook
        hook = sched.on_demand
        at_hook: list = []

        def watch(name):
            hook(name)
            if name == lender and not at_hook:
                at_hook.append((name, sched.effective(borrower),
                                name in sched._held_since))

        sched.on_demand = watch
        a_resume.set()
        _wait_for(lambda: at_hook, "5l-quota: the lender's demand", 60)
        time.sleep(QUOTA_SETTLE_S)
        out["after"] = _quota_reading(sched, proxy, steps, QUOTA_READ_S)
        # both clients pause between chain calls: 5l-quota's launches and
        # steps end here, 5l-rightsize's start from 0
        hand.set()
        handover.wait()
        launches = _counts()
        quota_steps = dict(steps)
        _reset_counts()
        # the quota lends nothing now (checked below); detached, it no
        # longer sees the scheduler's demand
        sched.on_demand = None
        idle.set()
        handover.wait()
        out["rightsize"] = _rightsize_run(
            dev, chip, sched, proxy, steps, walls, ledger)
        stop.set()
        for t in threads:
            t.join(timeout=300)
            check(not t.is_alive(), f"5l-quota: {t.name} did not finish")
        rz_launches = _counts()
    finally:
        stop.set()
        a_resume.set()
        hand.set()
        handover.abort()
        cadence_stop.set()
        proxy.close()
    check(not errors, f"5l-quota: the clients failed: {errors}")
    snap = quota.snapshot()
    base = out["grant"]["base"]
    eff = out["grant"]["effective"]
    lent = grant["lent"]
    check(grant["lenders"] == [lender] and grant["borrowers"] == [borrower]
          and abs(lent - quota.lend_frac * headroom) <= 1e-6
          and abs(lent - 0.375) <= 0.02,
          f"5l-quota: the grant {out['grant']}, wanted "
          f"{quota.lend_frac} x headroom {headroom}")
    check(base == {lender: QUOTA_LENDER[1:], borrower: QUOTA_BORROWER[1:]}
          and abs(eff[0] - (QUOTA_BORROWER[1] + lent)) <= 1e-9
          and abs(eff[1] - (QUOTA_BORROWER[2] + lent)) <= 1e-9,
          f"5l-quota: effective {eff}, base {base}, lent {lent}")
    check(out["revocations_while_lent"] == 0
          and all(s["lent"] == lent for s in steps_seen),
          f"5l-quota: the credit moved while lent: {steps_seen}")
    share = {k: out[k]["window_share"][borrower]
             for k in ("before", "lent", "after")}
    check(share["lent"] > max(QUOTA_LENT_MIN,
                              QUOTA_LENT_OVER * share["before"])
          and share["after"] < share["lent"],
          f"5l-quota: the borrower's window share before / lent / after "
          f"{share}: not clearly above {QUOTA_LENT_MIN} and "
          f"{QUOTA_LENT_OVER}x the share before while lent")
    check(at_hook == [(lender, QUOTA_BORROWER[1:], False)],
          f"5l-quota: inside the lender's first demand: {at_hook}")
    revoked = quota_mod._REVOKES.value("lender-demand") - revokes0
    check(quota.revocations == 1 and revoked == 1
          and snap["chips"]["card"] == {},
          f"5l-quota: revocations {quota.revocations} ({revoked} "
          f"lender-demand), credits {snap['chips']}")
    per_step = _launches_per_step(adam_per_step, layers)
    n = quota_steps[lender] + quota_steps[borrower]
    want = {k: v * n for k, v in per_step.items()}
    check(launches == want,
          f"5l-quota: launches {launches}, expected {want} for {n} steps")
    rz = out["rightsize"]
    rz_steps = {k: steps[k] - quota_steps[k] for k in steps}
    n = sum(rz_steps.values())
    want = {k: v * n for k, v in per_step.items()}
    check(rz_launches == want,
          f"5l-rightsize: launches {rz_launches}, expected {want} for "
          f"{n} steps")
    rz.update(steps=rz_steps, launches=rz_launches)
    for name, ls in losses.items():
        check(ls and all(math.isfinite(x) for x in ls),
              f"5l-quota {name}: losses {ls[:3]}")
    out.update(share=share, reclaimed_ms=snap["reclaimed_ms"],
               revocations=quota.revocations, at_hook=at_hook,
               steps=quota_steps, launches=launches,
               cadence_steps=len(steps_seen),
               seconds=time.monotonic() - t_phase - rz["seconds"])
    return out


def _rightsize_run(dev, chip, sched, proxy, steps: dict, walls: dict,
                   ledger) -> dict:
    """5l-rightsize, on 5l-quota's proxy, native-core scheduler and
    clients, the lender now idle (one step, then RZ_THINK_S): a
    ``Dispatcher`` over an engine holding the card as one chip books
    both tenants at their requests; a ``Rightsizer`` actuates that chip
    through the card's scheduler. Over the "before" reading (its
    observation window) the scheduler's ledger shows the lender's grants
    mostly idle, and the borrower's chain calls are its step-time SLO's
    samples, the bound set from its own device step time read over the
    same window. One ``cycle()`` must grow the borrower and shrink the
    lender; the engine's bookings must then equal the effective shares
    read back from the native core, and the scheduler's record of what
    it pushed there, and the borrower's window share must rise past its
    old limit. A second apply whose last member cannot fit rolls the
    first back, on the engine and in the core. The journal holds both
    batches."""
    from kubeshare_tpu_torch import constants as C
    from kubeshare_tpu_torch.obs.slo import SloEvaluator
    from kubeshare_tpu_torch.rightsize import (RightsizeConfig, Rightsizer,
                                               default_tenant,
                                               tenant_demand)
    from kubeshare_tpu_torch.scheduler import SchedulerEngine
    from kubeshare_tpu_torch.scheduler.dispatcher import Dispatcher

    t_phase = time.monotonic()
    lender, borrower = QUOTA_LENDER[0], QUOTA_BORROWER[0]
    grower = default_tenant(borrower)
    eng = SchedulerEngine()
    eng.add_node(chip.host, [chip])
    disp = Dispatcher(eng)
    for name, request, limit in (QUOTA_LENDER, QUOTA_BORROWER):
        ns, _, pod = name.partition("/")
        disp.submit(ns, pod, {C.POD_TPU_REQUEST: str(request),
                              C.POD_TPU_LIMIT: str(limit)})
    disp.step()

    def booked() -> dict:
        with disp.lock:
            return {k: p.bookings[0][1] for k, p in eng.pod_status.items()
                    if p.bookings and p.bookings[0][0] == chip.chip_id}

    check(booked() == {lender: QUOTA_LENDER[1], borrower: QUOTA_BORROWER[1]},
          f"5l-rightsize: the engine booked {booked()}")
    slo = SloEvaluator(clock=time.monotonic)
    journal = os.path.join(tempfile.mkdtemp(prefix="smoke-rz-"),
                           "rightsize.jsonl")
    cfg = RightsizeConfig(window_s=RZ_WINDOW_S)
    rz = Rightsizer(disp, slo=slo, ledger=ledger,
                    schedulers={chip.chip_id: sched}, cfg=cfg,
                    journal_path=journal)
    out: dict = {"chip": chip.chip_id, "config_cut": {
        "window_s": RZ_WINDOW_S}}
    time.sleep(RZ_SETTLE_S)
    t0 = time.monotonic()
    out["before"] = _quota_reading(sched, proxy, steps, RZ_WINDOW_S)
    now = time.monotonic()
    r = out["before"]
    exec_ms = r["borrower_exec_share"] * 1000.0 / max(
        r["borrower_steps_per_sec"], 1e-9)
    bound_ms = exec_ms / RZ_SLO_SHARE
    objective = f"step-time-p90<={bound_ms:.3f}ms"
    slo.declare(grower, objective)
    samples = [(t, wall) for t, wall, _n in list(walls[borrower])
               if t0 <= t <= now]
    for t, wall in samples:
        slo.record(grower, "step-time", value_s=wall, now=t)
    slo.evaluate(now)
    demand = tenant_demand(ledger, now - RZ_WINDOW_S, now, now)
    out["slo"] = {"objective": objective, "device_ms_a_step": exec_ms,
                  "samples": len(samples),
                  "bad": sum(1 for _t, w in samples
                             if w * 1e3 > bound_ms),
                  "state": slo.state(now)["tenants"].get(grower)}
    out["demand"] = demand
    cyc = rz.cycle(now=now)
    resizes = {r["pod"]: r for r in cyc["resizes"]}
    out["cycle"] = {k: cyc[k] for k in ("resizes", "moves", "skipped",
                                        "applied", "failed",
                                        "rolled_back")}
    out["tenants"] = cyc["tenants"]
    check({(k, r["direction"]) for k, r in resizes.items()}
          == {(borrower, "grow"), (lender, "shrink")}
          and resizes[borrower]["reason"] in ("burn-rate", "slo-firing")
          and resizes[lender]["reason"] == "sustained-idle"
          and not cyc["moves"] and not cyc["failed"]
          and len(cyc["applied"]) == 2,
          f"5l-rightsize: the cycle {json.dumps(out['cycle'])}, SLO "
          f"{json.dumps(out['slo'])}, demand {json.dumps(demand)}")
    after = booked()
    # the share the native core enforces, read back from it, and the
    # scheduler's record of what it pushed there
    eff = {k: sched.core.effective(k) for k in (lender, borrower)}
    pushed = {k: sched.effective(k) for k in (lender, borrower)}
    out["booked"], out["effective"], out["pushed"] = after, eff, pushed
    for k, rec in resizes.items():
        check(abs(after[k] - rec["to"]) <= 1e-9
              and abs(eff[k][0] - after[k]) <= 1e-9
              and abs(eff[k][1] - max(rec["to"], rec["from"])) <= 1e-9
              and eff[k] == pushed[k],
              f"5l-rightsize: {k} booked {after[k]}, the core's effective "
              f"{eff[k]}, pushed {pushed[k]}, resized {rec['from']} -> "
              f"{rec['to']}")
    check(sched.shares() == {lender: QUOTA_LENDER[1:],
                             borrower: QUOTA_BORROWER[1:]},
          f"5l-rightsize: base shares moved: {sched.shares()}")
    time.sleep(RZ_SETTLE_S)
    out["after"] = _quota_reading(sched, proxy, steps, RZ_READ_S)
    share = {k: out[k]["window_share"][borrower]
             for k in ("before", "after")}
    check(share["before"] <= RZ_SHARE_OVER * QUOTA_BORROWER[2]
          and share["after"] <= RZ_SHARE_OVER * eff[borrower][1],
          f"5l-rightsize: the borrower's window share {share} over its "
          f"limit {QUOTA_BORROWER[2]} then {eff[borrower][1]}")
    check(share["after"] > max(QUOTA_BORROWER[2],
                               RZ_SHARE_GROWN * share["before"]),
          f"5l-rightsize: the borrower's window share {share}: not above "
          f"its old limit {QUOTA_BORROWER[2]} and {RZ_SHARE_GROWN}x its "
          f"share before once grown")
    # a batch whose last member cannot fit: the lender's shrink lands on
    # the engine and the card's core, then comes back off both
    x, g = after[lender], after[borrower]
    bad = {"resizes": [
        {"pod": lender, "tenant": default_tenant(lender),
         "chip": chip.chip_id, "from": x, "to": round(x / 2, 6),
         "direction": "shrink", "reason": "smoke", "mode": "rebook",
         "gang": ""},
        {"pod": borrower, "tenant": grower, "chip": chip.chip_id,
         "from": g, "to": 1.0, "direction": "grow", "reason": "smoke",
         "mode": "rebook", "gang": ""}], "moves": []}
    res = rz.apply(bad)
    back = booked()
    eff_back = {k: sched.core.effective(k) for k in (lender, borrower)}
    pushed_back = {k: sched.effective(k) for k in (lender, borrower)}
    out["rollback"] = {"failed": [(f["pod"], f["error"])
                                  for f in res["failed"]],
                       "rolled_back": [f["pod"] for f in res["rolled_back"]],
                       "booked": back, "effective": eff_back}
    check([f["pod"] for f in res["failed"]] == [borrower]
          and [f["pod"] for f in res["rolled_back"]] == [lender]
          and not res["applied"] and back == after
          and abs(eff_back[lender][0] - x) <= 1e-9
          and eff_back[borrower] == eff[borrower]
          and eff_back == pushed_back,
          f"5l-rightsize: the failed batch {json.dumps(out['rollback'])}")
    with open(journal) as f:
        events = [json.loads(line) for line in f]
    shutil.rmtree(os.path.dirname(journal), ignore_errors=True)
    out["journal"] = [(e["event"], e.get("pod", e.get("applied", "")))
                      for e in events]
    check([e["event"] for e in events] == [
        "batch_begin", "resize_done", "resize_done", "batch_end",
        "batch_begin", "resize_done", "resize_rolled_back", "batch_end"]
          and events[3]["applied"] == 2 and events[7]["applied"] == 0
          and {e["pod"] for e in events[1:3]} == {lender, borrower},
          f"5l-rightsize: the journal {out['journal']}")
    check(rz.applied_total == 2 and rz.rolled_back_total == 1,
          f"5l-rightsize: applied {rz.applied_total}, rolled back "
          f"{rz.rolled_back_total}")
    violations = ledger.check()
    check(violations == [], f"5l-rightsize: the ledger: {violations}")
    out.update(share=share, seconds=time.monotonic() - t_phase)
    return out


def _whole_leaves(tree) -> list:
    """Every leaf of a tree laid out on a mesh, whole, as numpy on the
    mesh's ranks (a collective over its axes); None elsewhere."""
    from kubeshare_tpu_torch.elastic.restate import whole_leaf
    from kubeshare_tpu_torch.utils.tree import tree_leaves

    wholes = [whole_leaf(x) for x in tree_leaves(tree)]
    return [None if w is None else w.cpu().numpy().copy() for w in wholes]


def elastic_member(out_path: str) -> int:
    """A gang rank of 5l-elastic (the shim joined the gang at start-up):
    the unresized reference on ranks [0, 1], then an ``ElasticTrainer`` of
    the full-width flash LM on ranks [0, 1] resized 2 -> 4 -> 1 by rank
    0's ``ElasticOrchestrator`` mid-run (the others follow its plans), then
    grown back to 4 ranks and ``restate_via_checkpoint`` onto rank 0.
    Writes its record to ``out_path``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from kubeshare_tpu_torch.elastic import (ElasticConfig,
                                             ElasticOrchestrator,
                                             ElasticTrainer, recover,
                                             restate_via_checkpoint)
    from kubeshare_tpu_torch.elastic.sim import _gang_labels
    from kubeshare_tpu_torch.elastic.trainer import (announce, announcing,
                                                     follow)
    from kubeshare_tpu_torch.models import transformer
    from kubeshare_tpu_torch.ops.fused_adam import fused_adam
    from kubeshare_tpu_torch.parallel import mesh as pmesh
    from kubeshare_tpu_torch.parallel import runner

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    me = dist.get_rank()
    base = os.path.dirname(os.path.abspath(out_path))
    params = transformer.init(ELASTIC_SEED)
    batches = [tuple(transformer.batch_fn(ELASTIC_SEED + 100 + i))
               for i in range(ELASTIC_STEPS)]

    def bank(k):
        return list(range(k))

    def run(tr, boundary=None) -> list:
        recs = []
        for i, b in enumerate(batches):
            if boundary is not None:
                boundary(i)
            c0 = _counts()
            loss = tr.train_step(b)
            torch.cuda.synchronize()
            c1 = _counts()
            recs.append({"devices": tr.num_devices, "in_mesh": tr.in_mesh,
                         "loss": loss,
                         "launches": {k: c1[k] - c0[k] for k in c1}})
        return recs

    t0 = time.perf_counter()
    ref = ElasticTrainer(transformer.flash_loss_fn, fused_adam(ELASTIC_LR),
                         params, devices=bank(2))
    ref_steps = run(ref)
    ref_params = _whole_leaves(ref.params)
    del ref
    ref_s = time.perf_counter() - t0

    tr = ElasticTrainer(transformer.flash_loss_fn, fused_adam(ELASTIC_LR),
                        params, devices=bank(2))
    resize_s: list = []
    outcomes: list = []
    orch = None
    if me == 0:
        from kubeshare_tpu_torch.scheduler.dispatcher import Dispatcher
        from kubeshare_tpu_torch.scheduler.engine import SchedulerEngine
        from kubeshare_tpu_torch.topology.discovery import FakeTopology

        eng = SchedulerEngine()
        by_host: dict = {}
        for chip in FakeTopology(hosts=2, mesh=(2, 2)).chips():
            by_host.setdefault(chip.host, []).append(chip)
        for host, chips in sorted(by_host.items()):
            eng.add_node(host, chips)
        disp = Dispatcher(eng)
        for i in range(ELASTIC_WORLD):
            disp.submit("sim", f"trainer-{i}",
                        _gang_labels(0.25, "trainer", ELASTIC_WORLD))
        disp.step()
        orch = ElasticOrchestrator(
            disp, cfg=ElasticConfig(cooldown_s=0.0),
            journal_path=os.path.join(base, "elastic.jsonl"))
        # the members pack onto one chip; the job starts on two, as the
        # sim's ramp starts it (no restater yet: the trainer is there)
        start = orch.resize(ELASTIC_GANG, 2)
        check(start["outcome"] == "applied",
              f"5l: the gang's start on 2 chips: {start}")
        inner = announcing(tr.restater(bank))

        def restate(plan):
            t = time.perf_counter()
            inner(plan)
            resize_s.append(time.perf_counter() - t)

        orch.register_restater(ELASTIC_GANG, restate)

    def boundary(i):
        if me == 0:
            if i in ELASTIC_PLAN:
                outcomes.append(orch.resize(ELASTIC_GANG, ELASTIC_PLAN[i]))
            announce(None)
        else:
            t = time.perf_counter()
            if follow(tr, bank):
                resize_s.append(time.perf_counter() - t)

    t0 = time.perf_counter()
    el_steps = run(tr, boundary)
    el_s = time.perf_counter() - t0
    final = _whole_leaves(tr.params)
    rec = {"rank": me, "world": dist.get_world_size(),
           "backend": runner.backend(), "reason": runner.backend_reason(),
           "ref_steps": ref_steps, "steps": el_steps, "step": tr.step,
           "resizes": [{"step": r["step"], "chips": r["chips"],
                        "stats": r["stats"]} for r in tr.resizes],
           "resize_s": resize_s, "ref_s": ref_s, "elastic_s": el_s}
    elastic_resizes = len(tr.resizes)
    if me == 0:
        diffs = [np.abs(a - b) for a, b in zip(final, ref_params)]
        rec.update(outcomes=outcomes,
                   recover=recover(os.path.join(base, "elastic.jsonl")),
                   param_max_abs_diff=max(float(d.max()) for d in diffs),
                   param_mean_abs_diff=float(
                       sum(d.sum(dtype=np.float64) for d in diffs)
                       / sum(d.size for d in diffs)))
    # the checkpoint path: the 4-rank state onto rank 0 through DCP
    tr.resize(bank(ELASTIC_WORLD))
    rec["regrow"] = tr.resizes[elastic_resizes]["stats"]
    saved = _whole_leaves((tr.params, tr.opt_state))
    t0 = time.perf_counter()
    p1, s1, step = restate_via_checkpoint(
        os.path.join(base, "ckpt"), tr.params, tr.opt_state,
        pmesh.make_mesh(bank(1)), step=tr.step)
    rec["checkpoint_s"] = time.perf_counter() - t0
    restored = _whole_leaves((p1, s1))
    if me == 0:
        rec["checkpoint"] = {
            "step": step, "leaves": len(saved),
            "bit_equal": all(a.dtype == b.dtype and a.shape == b.shape
                             and a.tobytes() == b.tobytes()
                             for a, b in zip(saved, restored)),
            "bytes": int(sum(a.nbytes for a in saved))}
    rec["launches"] = _counts()
    with open(out_path, "w") as f:
        json.dump(rec, f, default=str)
    return 0


def _elastic_bytes(adam_per_step: int) -> dict:
    """The hand count of one resize's restate: the LM's leaves and their
    bytes, twice more for Adam's mu and nu, and its 4-byte count."""
    import numpy as np

    from kubeshare_tpu_torch.models import transformer
    from kubeshare_tpu_torch.utils.tree import tree_leaves

    leaves = tree_leaves(transformer.init(0))
    nbytes = sum(int(np.asarray(x).nbytes) for x in leaves)
    return {"donated": 0, "resharded": 3 * len(leaves) + 1, "streamed": 0,
            "bytes_donated": 0, "bytes_resharded": 3 * nbytes + 4,
            "bytes_streamed": 0}


def elastic_phase(root: str, adam_per_step: int, layers: int) -> dict:
    """5l-elastic: ELASTIC_WORLD gang ranks on the one card (the gang env
    and the shim, gloo), each this script's ``--elastic-member``; rank 0's
    orchestrator resizes the flash LM 2 -> 4 -> 1 ranks mid-run. Held to
    the unresized run, the hand count of the restate, the journal's
    recovery, the kernels' launches a rank a step, and a bit-exact
    checkpoint restate."""
    t_phase = time.monotonic()
    base = tempfile.mkdtemp(prefix="kubeshare-elastic-")
    try:
        recs = _gang_run(root, base, "elastic", ELASTIC_WORLD, {}, [],
                         mode="--elastic-member", phase="5l")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    per_step = _launches_per_step(adam_per_step, layers)
    none = {k: 0 for k in per_step}
    want_stats = _elastic_bytes(adam_per_step)
    r0 = recs[0]
    # read before any check, so that a failing run still shows them
    log(f"5l-elastic: losses {[x['loss'] for x in r0['steps']]} against "
        f"the unresized run's {[x['loss'] for x in r0['ref_steps']]}; final "
        f"params mean abs diff {r0['param_mean_abs_diff']:.3e}, max "
        f"{r0['param_max_abs_diff']:.3e}")
    for rec in recs:
        rank = rec["rank"]
        check(rec["backend"] == "gloo" and "share device" in rec["reason"],
              f"5l rank {rank}: backend {rec['backend']} ({rec['reason']})")
        check(rec["step"] == ELASTIC_STEPS
              and [(r["step"], r["chips"]) for r in rec["resizes"]]
              == list(ELASTIC_PLAN.items()),
              f"5l rank {rank}: step {rec['step']}, resizes "
              f"{[(r['step'], r['chips']) for r in rec['resizes']]}")
        check(all(r["stats"] == want_stats for r in rec["resizes"])
              and rec["regrow"] == want_stats,
              f"5l rank {rank}: restate stats "
              f"{[r['stats'] for r in rec['resizes']]}, hand count "
              f"{want_stats}")
        for run in ("ref_steps", "steps"):
            for i, st in enumerate(rec[run]):
                want = per_step if st["in_mesh"] else none
                check(st["launches"] == want
                      and st["in_mesh"] == (rank < st["devices"]),
                      f"5l rank {rank} {run}[{i}] on {st['devices']} "
                      f"devices: launches {st['launches']}, expected {want}")
    check([(o["outcome"], o["from_chips"], o["to_chips"])
           for o in r0["outcomes"]]
          == [("applied", 2, 4), ("applied", 4, 1)],
          f"5l: resizes {r0['outcomes']}")
    for i, (a, b) in enumerate(zip(r0["steps"], r0["ref_steps"])):
        check(math.isfinite(a["loss"])
              and abs(a["loss"] - b["loss"])
              <= GANG_LOSS_RTOL * abs(b["loss"]),
              f"5l: step {i} loss {a['loss']} against the unresized "
              f"run's {b['loss']}")
    check(r0["param_mean_abs_diff"] <= ELASTIC_PARAM_MEAN_ATOL,
          f"5l: final params {r0['param_mean_abs_diff']} from the "
          f"unresized run's on average (bound {ELASTIC_PARAM_MEAN_ATOL})")
    rec_ = r0["recover"].get(ELASTIC_GANG, {})
    check(rec_.get("mesh") == "new" and len(rec_.get("chips") or []) == 1,
          f"5l: recover(journal) {r0['recover']}")
    ck = r0["checkpoint"]
    check(ck["bit_equal"] and ck["step"] == ELASTIC_STEPS
          and ck["leaves"] == want_stats["resharded"],
          f"5l: restate_via_checkpoint {ck}")
    launches = {k: sum(r["launches"][k] for r in recs) for k in per_step}
    return {
        "outcomes": [{k: o.get(k) for k in ("from_chips", "to_chips",
                                            "outcome", "pause_s")}
                     for o in r0["outcomes"]],
        "losses": [s["loss"] for s in r0["steps"]],
        "ref_losses": [s["loss"] for s in r0["ref_steps"]],
        "loss_max_rel_err": max(
            abs(a["loss"] - b["loss"]) / abs(b["loss"])
            for a, b in zip(r0["steps"], r0["ref_steps"])),
        "param_max_abs_diff": r0["param_max_abs_diff"],
        "param_mean_abs_diff": r0["param_mean_abs_diff"],
        "stats": want_stats, "recover": rec_, "checkpoint": ck,
        "resize_s": [r["resize_s"] for r in recs],
        "checkpoint_s": [r["checkpoint_s"] for r in recs],
        "ref_s": [r["ref_s"] for r in recs],
        "elastic_s": [r["elastic_s"] for r in recs],
        "launches": launches,
        "launches_by_rank": [r["launches"] for r in recs],
        "seconds": time.monotonic() - t_phase}


# --- phase 5m: the standalone backend ------------------------------------

def backend_phase(root: str) -> dict:
    """Phase 5m: ``tools/launch_backend_torch.py`` from a config of one
    device (the card) and one client, as an operator runs it with no
    cluster: its launcher brings up a proxy on the card and the client's
    pod manager. ``python -m kubeshare_tpu_torch.models.mnist``, unmodified,
    is attached to that manager in gate mode by its env alone and trains
    BACKEND_STEPS steps under its profiler. The tenant must exit 0 below
    its first loss with one Adam launch a step of its trace, the proxy's
    token scheduler must have charged it, and the tool must stop
    everything it started on SIGTERM."""
    import torch

    from kubeshare_tpu_torch.isolation import protocol
    from kubeshare_tpu_torch.models import common, mnist
    from kubeshare_tpu_torch.topology.discovery import discover_chips

    t0 = time.monotonic()
    name, request = BACKEND_POD
    chip = discover_chips("cuda")[0]
    base = tempfile.mkdtemp(prefix="kubeshare-backend-")
    port = _free_port()
    cfg = os.path.join(base, "backend.json")
    with open(cfg, "w") as f:
        json.dump({"chips": [chip.chip_id],
                   "clients": [{"name": name, "chip": chip.chip_id,
                                "request": request, "limit": 1.0,
                                "port": port}]}, f)
    tool_log = os.path.join(base, "tool.log")
    tenant_log = os.path.join(base, "tenant.log")
    trace_dir = os.path.join(base, "trace")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KUBESHARE_TPU_")}
    env["PYTHONPATH"] = root
    out: dict = {"chip_id": chip.chip_id}
    tool = tenant = None
    try:
        with open(tool_log, "w") as log_file:
            tool = subprocess.Popen(
                [sys.executable, os.path.join(root, BACKEND_TOOL),
                 "--config", cfg, "--base-dir", base, "--port-start",
                 str(_free_port_pair())], env=env, cwd=root,
                stdout=log_file, stderr=subprocess.STDOUT,
                start_new_session=True)
        _wait_ready(tool_log, "the backend tool", proc=tool,
                    want=f"READY {port}")
        with open(tool_log) as f:
            info = json.loads(next(x for x in f if x.startswith("{")))
        check(info["manager_ports"] == {name: port}
              and list(info["exec_ports"]) == [chip.chip_id],
              f"5m: the tool printed {info}")
        out["ready_s"] = time.monotonic() - t0
        with open(tenant_log, "w") as log_file:
            tenant = subprocess.Popen(
                [sys.executable, "-m", "kubeshare_tpu_torch.models.mnist",
                 "--steps", str(BACKEND_STEPS), "--profile", trace_dir],
                env=_tenant_env(root, chip.chip_id, name, port, request,
                                True), cwd=root, stdout=log_file,
                stderr=subprocess.STDOUT)
        conn = protocol.Connection("127.0.0.1",
                                   info["token_ports"][chip.chip_id])
        conn.call({"op": "attach", "name": name})
        charged = 0.0
        while tenant.poll() is None and time.monotonic() - t0 < 300:
            charged = max(charged, conn.call({"op": "usage"})[0]["used_ms"])
            time.sleep(0.1)
        conn.close()
        rc = tenant.wait(timeout=60)
        text = _tail(tenant_log, 20000)
        check(rc == 0, f"5m: the tenant exited {rc}: {text[-3000:]}")
        out["tenant_s"] = time.monotonic() - t0 - out["ready_s"]
        params = common.to_device(mnist.init(0), "cuda")
        batch = common.to_device(mnist.batch_fn(1), "cuda")
        with torch.no_grad():
            first = float(mnist.loss_fn(params, batch))
        final = _final_loss(text)
        check(f"mnist: {BACKEND_STEPS} steps in" in text
              and math.isfinite(final) and final < first,
              f"5m: the tenant's loss {first} -> {final}: {text[-3000:]}")
        trace = _trace_summary(trace_dir, BACKEND_STEPS - 1, 1)
        check(trace["ours"]["fused_adam"] == 1.0,
              f"5m: {trace['ours']['fused_adam']} Adam launches a step of "
              f"the trace")
        check(charged > 0, f"5m: the token scheduler charged {name} "
                           f"{charged} ms")
        t_stop = time.monotonic()
        tool.send_signal(signal.SIGTERM)
        rc = tool.wait(timeout=20)
        out["stop_s"] = time.monotonic() - t_stop
        check(rc == 0, f"5m: the tool exited {rc}: {_tail(tool_log)}")
        left = []
        for p in (port, info["exec_ports"][chip.chip_id],
                  info["token_ports"][chip.chip_id]):
            with socket.socket() as s:
                if s.connect_ex(("127.0.0.1", p)) == 0:
                    left.append(p)
        check(not left, f"5m: ports {left} still served after the tool's "
                        f"stop: {_tail(tool_log)}")
        out.update(first_loss=first, final_loss=final, charged_ms=charged,
                   adam_per_traced_step=trace["ours"]["fused_adam"],
                   device_ms=trace["device_ms"],
                   kernels_per_step=trace["kernels"],
                   steps_line=next(x for x in text.splitlines()
                                   if x.startswith("mnist: ")))
    finally:
        for proc in (tenant, tool):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(base, ignore_errors=True)
    out["seconds"] = time.monotonic() - t0
    return out


def side_by_side_phase(root: str, local: dict, adam_per_step: int,
                       layers: int) -> dict:
    """5j-cli (:func:`sweep_phase`), 5j-lm (:func:`lm_member_phase`), 5k's
    gangs (:func:`gang_phase`, after :func:`gang_local`), 5l-elastic
    (:func:`elastic_phase`) and 5m (:func:`backend_phase`), all started
    together: each checks correctness, its processes count their own
    launches, and their start-ups, not the card, take their time. Returns
    the five phases' results and the seconds of the whole."""
    t0 = time.monotonic()
    with ThreadPoolExecutor(4) as pool:
        lm = pool.submit(lm_member_phase, root)
        sweep = pool.submit(sweep_phase, root)
        elastic = pool.submit(elastic_phase, root, adam_per_step, layers)
        backend = pool.submit(backend_phase, root)
        gang = gang_phase(root, local, adam_per_step, layers)
        return {"sweep": sweep.result(), "gang": gang,
                "elastic": elastic.result(), "lm_member": lm.result(),
                "backend": backend.result(),
                "seconds": time.monotonic() - t0}


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
    parser.add_argument("--peers", default="",
                        help="as a tenant, the other tenants' records "
                             "(comma-separated): train --seconds past the "
                             "last one's warm-up")
    parser.add_argument("--go", default="",
                        help="as a tenant, get ready, write <record>.ready "
                             "and wait for this file before training on")
    parser.add_argument("--gang-member", default="",
                        help="run the transformer's CLI with the arguments "
                             "after '--' as a gang member, writing its "
                             "record here (JSON)")
    parser.add_argument("--elastic-member", default="",
                        help="run as a rank of phase 5l's elastic gang, "
                             "writing its record here (JSON)")
    parser.add_argument("--lm-member", default="",
                        help="run phase 5j-lm (the LM at head dim 128 "
                             "with the attention knobs of its env), "
                             "writing its record here (JSON)")
    argv = list(sys.argv[1:] if argv is None else argv)
    member_args = []
    if "--" in argv:
        cut = argv.index("--")
        argv, member_args = argv[:cut], argv[cut + 1:]
    args = parser.parse_args(argv)
    if member_args and not args.gang_member:
        parser.error("arguments after '--' are a gang member's")
    t_start = time.perf_counter()

    import torch

    if args.tenant and args.compiled:
        # a proxy-mode tenant has no CUDA device of its own: the attach
        # hid them all, and its compiled step runs on the proxy
        return tenant(args.tenant, args.seconds, args.seed, True,
                      args.steps, go=args.go)
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
        return tenant(args.tenant, args.seconds, args.seed, False,
                      peers=tuple(filter(None, args.peers.split(","))),
                      go=args.go)
    if args.gang_member:
        return gang_member(args.gang_member, member_args)
    if args.elastic_member:
        return elastic_member(args.elastic_member)
    if args.lm_member:
        return lm_member(args.lm_member)
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
    phase_s: dict = {}
    t_mark = [t_start]

    def mark(name: str) -> None:
        """Close a stretch of the run: its wall seconds since the last."""
        now = time.perf_counter()
        phase_s[name] = now - t_mark[0]
        t_mark[0] = now

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
    out["ptxas"] = ptxas_summary("\n".join(builds[n][1]
                                             for n in FLASH_LIBRARIES))
    log_ptxas(out["ptxas"])
    mma = sass_mma_counts(FLASH_LIBRARIES)
    check_flash_sass(mma, out["ptxas"])
    out["sass_mma"] = mma
    log("sass: HMMA / HGMMA instructions by kernel: " + ", ".join(
        f"{k} {n['HMMA']} / {n['HGMMA']}" for k, n in sorted(mma.items())))

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
        f"with torch's D {flash['bwd_ms']:.4f} ms = "
        f"{flash['bwd_over_sdpa']:.3f}x sdpa backward "
        f"{flash['library_ms']['bwd']:.4f} ms")
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
    out["flash_wide"] = flash_wide_timing(dev, rng)

    out["step_check"] = step_check(dev)
    log(f"train step card vs cpu: {out['step_check']}")
    out["transformer_step_check"] = transformer_step_check(dev)
    log(f"transformer train step card vs cpu: "
        f"{out['transformer_step_check']}")

    mark("start-up, builds, kernel checks")

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
    mark("5a-5d")

    # 5f's part in this process and its proxy first; its even pair's
    # tenants start beside 5e's node and are ready before any other tenant
    # starts; then 5e's tenants and 5f's other three start together, and
    # 5e's runs go once all are ready. However the run ends, 5f's tenants
    # are stopped and its proxy closed
    prox_ctx = proxy_prepare(root, dev)
    atexit.register(proxy_close, prox_ctx)
    # the gate pair: tenant processes, each counting its own launches
    gate = gate_phase(root, adam_launches["transformer"], transformer.LAYERS,
                      start_first=lambda: proxy_start(prox_ctx, ("even",)),
                      start_others=lambda: proxy_start(
                          prox_ctx, ("solo", "uneven")))
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
    mark("5e")

    # the proxy-mode pair: tenant processes with no CUDA device, their
    # compiled steps run on a proxy in this process, counted here
    prox = proxy_finish(prox_ctx, adam_launches["transformer"],
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
    mark("5f")

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
    mark("5g")

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
    mark("5h")

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
    mark("5i")

    # the zoo: the JAX package's other workload models at full width, in
    # this process (the resumable sweep's CLI through a node runs later,
    # beside 5k)
    zoo = zoo_phase(dev, rng)
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
    log(f"5j: {zoo['seconds']:.1f} s in all (5j-cli below); by stage s "
        + ", ".join(f"{k} {v:.1f}" for k, v in zoo["stages_s"].items())
        + f"; launches {zoo['launches']}")
    phases["zoo"] = zoo
    for k in launches:
        launches[k] += zoo["launches"][k]
    mark("5j")

    # 5k's part in this process: the lse cotangent, the one-process run
    gang_here = gang_local(dev, rng)
    mark("5k (in this process)")

    # the autopilot's quota lending on the card's token scheduler, counted
    # here
    quota = quota_phase(dev, adam_launches["transformer"], transformer.LAYERS)
    for k in ("before", "lent", "after"):
        r = quota[k]
        log(f"5l-quota {k}: borrower window share "
            f"{r['window_share'][QUOTA_BORROWER[0]]:.4f} (lender "
            f"{r['window_share'][QUOTA_LENDER[0]]:.4f}), device share "
            f"{r['borrower_exec_share']:.4f}, "
            f"{r['borrower_steps_per_sec']:.3f} steps/s over "
            f"{r['seconds']:.2f} s")
    g = quota["grant"]
    log(f"5l-quota: lent {g['lent']} of the window = {QUOTA_LENDER[0]}'s "
        f"headroom {g['headroom']:.6f} (usage {g['lender_usage']:.6f}) x "
        f"0.75; borrower effective {g['effective']}, base {g['base']}; "
        f"{quota['cadence_steps']} cadence steps held it; inside the "
        f"lender's first demand {quota['at_hook']}; revocations "
        f"{quota['revocations']}, reclaimed {quota['reclaimed_ms']} "
        f"device-ms; steps {quota['steps']}; launches {quota['launches']}; "
        f"{quota['seconds']:.1f} s")
    phases["quota"] = quota
    rzr = phases["rightsize"] = quota.pop("rightsize")
    for k in ("before", "after"):
        r = rzr[k]
        log(f"5l-rightsize {k}: borrower window share "
            f"{r['window_share'][QUOTA_BORROWER[0]]:.4f} (lender "
            f"{r['window_share'][QUOTA_LENDER[0]]:.4f}), device share "
            f"{r['borrower_exec_share']:.4f}, "
            f"{r['borrower_steps_per_sec']:.3f} steps/s over "
            f"{r['seconds']:.2f} s")
    sl = rzr["slo"]
    lend = rzr["demand"].get(QUOTA_LENDER[0].partition("/")[0], {})
    log(f"5l-rightsize: {QUOTA_BORROWER[0]} against {sl['objective']} "
        f"(its device step {sl['device_ms_a_step']:.3f} ms / "
        f"{RZ_SLO_SHARE}): {sl['bad']} of {sl['samples']} chain calls "
        f"over it, {json.dumps(sl['state'])}; {QUOTA_LENDER[0]} granted "
        f"{lend.get('granted_s', 0.0):.3f} s of the {RZ_WINDOW_S} s window, "
        f"idle {lend.get('idle_frac', 0.0):.4f} of it; one cycle: "
        + "; ".join(f"{x['pod']} {x['direction']} {x['from']} -> "
                    f"{x['to']} ({x['reason']})"
                    for x in rzr["cycle"]["resizes"])
        + f"; applied {len(rzr['cycle']['applied'])}, moves "
        f"{len(rzr['cycle']['moves'])}; booked {rzr['booked']} = the "
        f"effective (request, limit) read back from the native core "
        f"{rzr['effective']} = the scheduler's record of what it pushed")
    rb = rzr["rollback"]
    log(f"5l-rightsize: a batch whose last member cannot fit: failed "
        f"{rb['failed']}, rolled back {rb['rolled_back']}; booked "
        f"{rb['booked']}, read back from the core {rb['effective']}; journal "
        f"{rzr['journal']}; steps {rzr['steps']}; launches "
        f"{rzr['launches']}; {rzr['seconds']:.1f} s")
    for k in launches:
        launches[k] += quota["launches"][k] + rzr["launches"][k]
    mark("5l-quota, 5l-rightsize")

    # then the paths of processes that count their own launches and check
    # correctness alone, side by side: the sweep through a node, 5k's
    # gangs, 5l-elastic's ranks
    side = side_by_side_phase(root, gang_here, adam_launches["transformer"],
                              transformer.LAYERS)
    sw = zoo["sweep"] = side["sweep"]
    zoo["stages_s"]["sweep"] = sw["seconds"]
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
    lm = side["lm_member"]
    sc = lm["step_check"]
    log(f"5j-lm {LM_MEMBER[0]} ({lm['knobs']}, head dim {lm['head_dim']}, "
        f"{lm['params']} params, {lm['leaves']} leaves), a process of its "
        f"own: card vs cpu step: loss {sc['loss_cuda']:.6f} / "
        f"{sc['loss_cpu']:.6f}, grads max abs err "
        f"{sc['grad_max_abs_err']:.3e} (bound {sc['grad_bound']:.3e}), firm "
        f"params {sc['param_max_abs_err_firm']:.3e}; exclusive "
        f"{lm['steps_per_sec']:.3f} steps/s (beside 5j-cli, 5k and "
        f"5l-elastic), wall {lm['wall_ms']:.3f} ms a step, device "
        f"{lm['device_ms']:.3f} ms, {lm['kernels_per_step']:.1f} kernels a "
        f"step, ours a step {lm['ours_per_step']}; loss "
        f"{lm['first_loss']:.4f} -> {lm['final_loss']:.4f}; launches "
        f"{lm['launches']}; {lm['seconds']:.1f} s")
    phases["lm_member"] = lm
    for k in launches:
        launches[k] += lm["launches"][k]
    gang = side["gang"]
    for label, r in gang["runs"].items():
        log(f"5k {label} ({r['mesh']}, sp attention {r['sp_attn']}): "
            f"final loss {r['final_loss']} against one process's "
            f"{gang['one_process']['final_loss']!r} (rel err "
            f"{r['loss_rel_err']:.2e}); steps/s by rank "
            + ", ".join(f"{x:.3f}" for x in r["steps_per_sec"])
            + " (one process "
            f"{gang['one_process']['steps_per_sec']:.3f}); wall s by rank "
            + ", ".join(f"{x:.1f}" for x in r["wall_s"])
            + f"; {r['replicated_leaves']} replicated leaves equal on both "
            f"ranks; launches by rank {r['launches']}")
    nc = gang["nccl_checkpoint"]
    log(f"5k nccl: one-rank gang, backend {nc['backend']} ({nc['reason']}); "
        f"SIGKILLed after the save of step {nc['saved_step']}, resumed "
        f"there for {nc['resumed_steps']} steps, final loss "
        f"{nc['final_loss']!r}, {nc['steps_per_sec']:.3f} steps/s")
    log(f"5k: {gang['seconds']:.1f} s in all; by stage s " + ", ".join(
        f"{k} {v:.1f}" for k, v in gang["stages_s"].items())
        + f"; lse cotangent max abs err {gang['lse_max_abs_err']}; "
        f"launches {gang['launches']}")
    phases["gang"] = gang
    for k in launches:
        launches[k] += gang["launches"][k]

    el = side["elastic"]
    log(f"5l-elastic: {ELASTIC_WORLD} gloo ranks on the card, the flash LM "
        f"resized " + ", ".join(
            f"{o['from_chips']} -> {o['to_chips']} {o['outcome']} "
            f"(pause {o['pause_s']:.3f} s)" for o in el["outcomes"])
        + f"; {ELASTIC_STEPS} steps, losses max rel err "
        f"{el['loss_max_rel_err']:.2e} against the unresized run "
        f"({el['losses'][-1]!r} vs {el['ref_losses'][-1]!r}); final params "
        f"mean abs diff {el['param_mean_abs_diff']:.3e} (bound "
        f"{ELASTIC_PARAM_MEAN_ATOL}; max {el['param_max_abs_diff']:.3e}); "
        f"each restate {el['stats']}; recover {el['recover']}; restate "
        f"seconds by rank {el['resize_s']}; checkpoint onto one rank "
        f"{el['checkpoint']} in {el['checkpoint_s'][0]:.2f} s; wall s by "
        f"rank: reference {el['ref_s']}, elastic {el['elastic_s']}; "
        f"launches by rank {el['launches_by_rank']}; "
        f"{el['seconds']:.1f} s")
    phases["elastic"] = el
    for k in launches:
        launches[k] += el["launches"][k]
    bk = phases["backend"] = side["backend"]
    log(f"5m: {BACKEND_TOOL} READY (a proxy on {bk['chip_id']}, manager of "
        f"{BACKEND_POD[0]}) in {bk['ready_s']:.1f} s; mnist's CLI as its "
        f"gate-mode tenant in {bk['tenant_s']:.1f} s: {bk['steps_line']!r}, "
        f"loss {bk['first_loss']:.4f} -> {bk['final_loss']:.4f}, "
        f"{bk['adam_per_traced_step']:.0f} Adam launch a step of its trace, "
        f"device {bk['device_ms']:.3f} ms a step, charged "
        f"{bk['charged_ms']:.1f} ms by the token scheduler; SIGTERM to "
        f"every process gone in {bk['stop_s']:.2f} s; {bk['seconds']:.1f} s "
        f"in all")
    log(f"5j-cli, 5j-lm, 5k, 5l-elastic and 5m side by side: "
        f"{side['seconds']:.1f} s")
    mark("5j-cli, 5j-lm, 5k, 5l-elastic, 5m")
    out.update(phases=phases, launches=launches, phase_s=phase_s,
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
    # each flash pass at the LM's shape, with every instance it has
    # (instance_rows)
    inst_launches = dict(INSTANCE_LAUNCHES)
    for key, n in lm.get("instance_launches", {}).items():
        inst_launches[key] = inst_launches.get(key, 0) + n
    for name in ("fwd", "dq", "dkv"):
        r = flash[name]
        kernels.append({
            "name": f"flash_attention_{name}", "route": "cuda",
            "source": FLASH_SOURCE, "replaces": FLASH_REPLACES[name],
            "launches": launches[f"flash_{name}"],
            "max_abs_err": flash_err[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "instances": instance_rows(name, flash, out["flash_wide"],
                                       flash_err, inst_launches)})
    # the wide backward's prologue, at the LM's shape at dim 1024
    r = out["flash_wide"][str(WIDE_SHAPES[-1])]["prep"]
    kernels.append({
        "name": "flash_attention_prep", "route": "cuda",
        "source": FLASH_PREP_SOURCE, "replaces": FLASH_PREP_REPLACES,
        "launches": launches["flash_prep"],
        "max_abs_err": flash_err["prep"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None,
        "instances": instance_rows("prep", flash, out["flash_wide"],
                                   flash_err, inst_launches)})
    log("seconds by stretch: " + ", ".join(
        f"{k} {v:.1f}" for k, v in phase_s.items()))
    log(f"seconds: {out['seconds']:.1f}")
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
