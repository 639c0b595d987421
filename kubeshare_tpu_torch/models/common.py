"""Shared training machinery for the workload models.

Counterpart of ``kubeshare_tpu/models/common.py``. A model module exposes
``init(seed) -> params`` (a tree of numpy arrays made from the seed),
``loss_fn(params, batch)`` over tensors and ``batch_fn(seed)``; this module
turns them into a train step and a timed loop. The loop takes an optional
``gate`` callable, run before every step: the isolation runtime's
client-side execution gate plugs in there without the model knowing.
It resumes from and saves to a checkpoint (:mod:`.checkpoint`), and
traces its timed steps with ``torch.profiler``. The mesh hooks of the
JAX version come with the port's meshes.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..ops.fused_adam import Optimizer, fused_adam
from .checkpoint import AsyncCheckpointWriter, load_checkpoint, save_checkpoint
from ..utils.device import resolve_device, synchronize
from ..utils.logger import get_logger
from ..utils.tree import tree_flatten, tree_map, tree_unflatten

log = get_logger("models")


@dataclass
class TrainResult:
    steps: int
    seconds: float
    final_loss: float
    #: loss of the first timed step, to show the run is learning
    first_loss: float = float("nan")
    #: the step a checkpoint restored (0: a fresh start)
    start_step: int = 0
    #: untimed steps run before the timed ones (none on a resume)
    warmup_steps: int = 0

    @property
    def steps_per_sec(self) -> float:
        return self.steps / self.seconds if self.seconds > 0 else 0.0


def to_device(tree, device) -> object:
    """Tree of numpy arrays → tree of tensors on ``device``. Always a copy:
    the optimizer updates the result in place, never the caller's arrays."""
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=device),
                    tree)


def value_and_grad(loss_fn: Callable, params, batch):
    """``(loss, grads)`` of ``loss_fn(params, batch)`` with respect to
    every leaf of ``params``; ``params`` itself is left untouched. A leaf
    the loss does not use gets a zero gradient, as under ``jax.grad`` (the
    transformer's position table with RoPE on)."""
    leaves, treedef = tree_flatten(params)
    req = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(treedef, req), batch)
        grads = torch.autograd.grad(loss, req, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), tree_unflatten(treedef, list(grads))


def make_train_step(loss_fn: Callable, optimizer: Optimizer):
    """``loss_fn(params, batch) -> scalar`` →
    ``step(params, opt_state, batch) -> (params, opt_state, loss)``.

    The optimizer updates ``params`` and ``opt_state`` in place (the fused
    Adam kernel writes p, m and v where they lie); the returned trees are
    the same objects."""

    def step(params, opt_state, batch):
        loss, grads = value_and_grad(loss_fn, params, batch)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, loss

    return step


def synthetic_image_batch(seed: int, batch_size: int, hw: int, channels: int,
                          classes: int) -> tuple[np.ndarray, np.ndarray]:
    """One NHWC image batch and its labels, made from ``seed``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch_size, hw, hw, channels)).astype(np.float32)
    y = rng.integers(0, classes, (batch_size,)).astype(np.int64)
    return x, y


def synthetic_token_batch(seed: int, batch_size: int, seq_len: int,
                          vocab: int) -> tuple[np.ndarray, np.ndarray]:
    """One token batch made from ``seed``: int tokens ``(B, S+1)`` split
    into next-token ``(inputs, targets)``, each ``(B, S)``."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (batch_size, seq_len + 1)).astype(
        np.int64)
    return tokens[:, :-1], tokens[:, 1:]


def _profiler(profile_dir: str, device: torch.device):
    """``torch.profiler`` over the host and, on the card, its kernels; the
    trace lands in ``profile_dir`` as ``<host>_<pid>.<time>.pt.trace.json``
    (TensorBoard's profile plugin and Perfetto read it)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(profile_dir))


def run_training(init_fn: Callable, loss_fn: Callable, batch_fn: Callable,
                 steps: int, learning_rate: float = 1e-3, seed: int = 0,
                 warmup: int = 2, gate: Callable | None = None,
                 optimizer: Optimizer | None = None,
                 device=None, checkpoint: str = "",
                 checkpoint_every: int = 0,
                 profile_dir: str = "") -> TrainResult:
    """Train to ``steps`` timed steps on one fixed synthetic batch.

    ``device`` defaults to the CUDA card (``"cpu"`` must be asked for).
    ``warmup`` untimed steps absorb first-call costs; each timed step ends
    in a host read of the loss, which waits for the card to finish the
    step, so steps/sec reflects device time. ``gate()`` (if given) runs
    before every step.

    ``checkpoint`` (a directory path) makes the run resumable: a
    checkpoint there is restored before training, and its step count is
    taken off the steps left to run, with no warm-up (warm-up steps would
    apply updates past the recorded step). State is saved every
    ``checkpoint_every`` timed steps through the async writer, and at the
    end unless the last in-loop save covered that step. A restarted pod
    with the same arguments continues the same trajectory.

    ``profile_dir`` wraps only the timed loop in ``torch.profiler`` and
    writes its trace there."""
    device = resolve_device(device)
    params = to_device(init_fn(seed), device)
    batch = to_device(batch_fn(seed + 1), device)
    optimizer = optimizer or fused_adam(learning_rate)
    opt_state = optimizer.init(params)
    step = make_train_step(loss_fn, optimizer)

    done = 0
    if checkpoint:
        try:
            params, opt_state, done = load_checkpoint(checkpoint, params,
                                                      opt_state)
        except FileNotFoundError:
            pass
        if done:
            warmup = 0

    loss = torch.zeros(())
    for _ in range(warmup):
        params, opt_state, loss = step(params, opt_state, batch)
    float(loss)
    synchronize(device)

    # profile only the timed loop: set-up, warm-up and restore would
    # dwarf the steady steps in the trace
    trace_ctx = (_profiler(profile_dir, device) if profile_dir
                 else contextlib.nullcontext())
    writer_ctx = (AsyncCheckpointWriter() if checkpoint and checkpoint_every
                  else contextlib.nullcontext())
    remaining = max(0, steps - done)
    first = float("nan")
    start = time.perf_counter()
    with trace_ctx, writer_ctx as writer:
        for i in range(1, remaining + 1):
            if gate is not None:
                gate()
            params, opt_state, loss = step(params, opt_state, batch)
            value = float(loss)       # host read: the completion barrier
            if i == 1:
                first = value
            if writer is not None and i % checkpoint_every == 0:
                writer.save(checkpoint, params, opt_state, done + i)
    # leaving the with-block closed the writer: the last in-loop save is
    # written and promoted before elapsed is read
    elapsed = time.perf_counter() - start
    if checkpoint and remaining and not (
            checkpoint_every and remaining % checkpoint_every == 0):
        # remaining == 0 saves nothing: the checkpoint already is this state
        save_checkpoint(checkpoint, params, opt_state, done + remaining)
    return TrainResult(steps=remaining, seconds=elapsed,
                       final_loss=float(loss), first_loss=first,
                       start_step=done, warmup_steps=warmup)


def main_cli(model_name: str, init_fn, loss_fn, batch_fn,
             argv=None) -> TrainResult:
    """Shared ``python -m kubeshare_tpu_torch.models.<name> --steps N``,
    with the JAX CLI's flags; ``--device`` takes ``--platform``'s place."""
    import argparse

    parser = argparse.ArgumentParser(
        prog=f"kubeshare_tpu_torch.models.{model_name}")
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--checkpoint", default="",
                        help="checkpoint dir: resume from it if present, "
                             "save into it while training")
    parser.add_argument("--checkpoint-every", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--profile", default="",
                        help="write a torch.profiler trace of the timed "
                             "loop into this directory (TensorBoard, "
                             "Perfetto)")
    args = parser.parse_args(argv)
    result = run_training(init_fn, loss_fn, batch_fn, args.steps,
                          learning_rate=args.lr, seed=args.seed,
                          device=args.device, checkpoint=args.checkpoint,
                          checkpoint_every=args.checkpoint_every,
                          profile_dir=args.profile)
    if result.start_step:
        print(f"{model_name}: resumed at step {result.start_step} from "
              f"{args.checkpoint}, {result.warmup_steps} warm-up steps")
    print(f"{model_name}: {result.steps} steps in {result.seconds:.2f}s "
          f"= {result.steps_per_sec:.2f} steps/s, final loss "
          f"{result.final_loss:.8g}")
    return result
