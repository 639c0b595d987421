"""Shared training machinery for the workload models.

Counterpart of ``kubeshare_tpu/models/common.py``. A model module exposes
``init(seed) -> params`` (a tree of numpy arrays made from the seed),
``loss_fn(params, batch)`` over tensors and ``batch_fn(seed)``; this module
turns them into a train step and a timed loop. The loop takes an optional
``gate`` callable, run before every step: the isolation runtime's
client-side execution gate plugs in there without the model knowing.
It resumes from and saves to a checkpoint (:mod:`.checkpoint`), and
traces its timed steps with ``torch.profiler``. Over a mesh
(:mod:`~kubeshare_tpu_torch.parallel.mesh`) it trains the sharded step;
a gang member (a process that joined a ``torch.distributed`` group,
:mod:`~kubeshare_tpu_torch.parallel.runner`) trains over the gang's
mesh.
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


def _profiler(profile_dir: str, device: torch.device, steps: int):
    """``torch.profiler`` over ``steps`` steps of the host and, on the
    card, its kernels; the trace lands in ``profile_dir`` as
    ``<host>_<pid>.<time>.pt.trace.json`` (TensorBoard's profile plugin
    and Perfetto read it). The caller calls ``step()`` after each step.
    The first of two or more steps is the profiler's warm-up and is not
    in the trace; each traced step is a ``ProfilerStep#N`` span. The
    first traced step may still lack a kernel that ran (on an H100, 1 of
    75 five-step runs with the warm-up, 1 of 75 without:
    ``scripts/torch_trace_drops.py``), so a reader that must see every
    launch reads from the second traced step on."""
    from torch.profiler import (ProfilerActivity, profile, schedule,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    warmup = 1 if steps > 1 else 0
    return profile(activities=activities,
                   schedule=schedule(wait=0, warmup=warmup,
                                     active=max(1, steps - warmup),
                                     repeat=1),
                   on_trace_ready=tensorboard_trace_handler(profile_dir))


def run_training(init_fn: Callable, loss_fn: Callable, batch_fn: Callable,
                 steps: int, learning_rate: float = 1e-3, seed: int = 0,
                 warmup: int = 2, gate: Callable | None = None,
                 optimizer: Optimizer | None = None,
                 device=None, checkpoint: str = "",
                 checkpoint_every: int = 0,
                 profile_dir: str = "",
                 mesh=None, mesh_hooks: dict | None = None) -> TrainResult:
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
    writes its trace there: every timed step but the first, the
    profiler's warm-up (of one step, the one).

    ``mesh`` (a DeviceMesh over the group's ranks) trains the sharded
    step: params and Adam's state laid out per ``param_sharding``, the
    batch per ``data_sharding``; ``mesh_hooks`` lets a model swap in a
    mesh-aware loss (``"loss"``: ``mesh -> loss_fn or None``) and batch
    layout (``"batch_sharding"``: ``mesh -> placements``), as the
    transformer's sequence parallelism does. A gang member with no mesh
    trains over ``runner.gang_mesh()``, and a gang's checkpoint path must
    pass ``verify_shared_path`` first. The loss reported is the global
    loss."""
    import torch.distributed as dist

    device = resolve_device(device)
    gang = dist.is_available() and dist.is_initialized()
    if mesh is None and gang:
        # a gang member trains over the whole gang
        from ..parallel.runner import gang_mesh
        mesh = gang_mesh(device_type=device.type)
    if checkpoint and gang:
        from .checkpoint import verify_shared_path
        verify_shared_path(checkpoint)
    params = to_device(init_fn(seed), device)
    batch = to_device(batch_fn(seed + 1), device)
    optimizer = optimizer or fused_adam(learning_rate)
    opt_state = optimizer.init(params)
    if mesh is None:
        step = make_train_step(loss_fn, optimizer)
    else:
        from ..parallel.mesh import (data_sharding, make_sharded_train_step,
                                     param_sharding, shard_tree)
        hooks = mesh_hooks or {}
        if "loss" in hooks:
            loss_fn = hooks["loss"](mesh) or loss_fn
        batch_sharding = (hooks.get("batch_sharding") or data_sharding)(mesh)
        step = make_sharded_train_step(loss_fn, optimizer, mesh,
                                       batch_sharding=batch_sharding)
        params = shard_tree(params, param_sharding(mesh, params), mesh)
        # Adam's moments take their leaves' layout; its count replicates
        opt_state = shard_tree(opt_state, param_sharding(mesh, opt_state),
                               mesh)
        batch = shard_tree(batch, batch_sharding, mesh)

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

    remaining = max(0, steps - done)
    # profile only the timed loop: set-up, warm-up and restore would
    # dwarf the steady steps in the trace
    trace_ctx = (_profiler(profile_dir, device, remaining) if profile_dir
                 else contextlib.nullcontext())
    writer_ctx = (AsyncCheckpointWriter() if checkpoint and checkpoint_every
                  else contextlib.nullcontext())
    first = float("nan")
    start = time.perf_counter()
    with trace_ctx as prof, writer_ctx as writer:
        for i in range(1, remaining + 1):
            if gate is not None:
                gate()
            params, opt_state, loss = step(params, opt_state, batch)
            value = float(loss)       # host read: the completion barrier
            if prof is not None:
                prof.step()
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
             argv=None, mesh_hooks: dict | None = None) -> TrainResult:
    """Shared ``python -m kubeshare_tpu_torch.models.<name> --steps N``,
    with the JAX CLI's flags; ``--device`` takes ``--platform``'s place.
    A gang member (the attach shim joined its group from the pod's env)
    trains over the gang's mesh, with the model's ``mesh_hooks``."""
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
                          profile_dir=args.profile, mesh_hooks=mesh_hooks)
    if result.start_step:
        print(f"{model_name}: resumed at step {result.start_step} from "
              f"{args.checkpoint}, {result.warmup_steps} warm-up steps")
    print(f"{model_name}: {result.steps} steps in {result.seconds:.2f}s "
          f"= {result.steps_per_sec:.2f} steps/s, final loss "
          f"{result.final_loss:.8g}")
    return result
