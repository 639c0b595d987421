"""Shared training machinery for the workload models.

Counterpart of ``kubeshare_tpu/models/common.py``. A model module exposes
``init(seed) -> params`` (a tree of numpy arrays made from the seed),
``loss_fn(params, batch)`` over tensors and ``batch_fn(seed)``; this module
turns them into a train step and a timed loop. The loop takes an optional
``gate`` callable, run before every step: the isolation runtime's
client-side execution gate plugs in there without the model knowing.

Checkpointing, mesh hooks and the profiler of the JAX version are not
ported yet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..ops.fused_adam import Optimizer, fused_adam
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


def run_training(init_fn: Callable, loss_fn: Callable, batch_fn: Callable,
                 steps: int, learning_rate: float = 1e-3, seed: int = 0,
                 warmup: int = 2, gate: Callable | None = None,
                 optimizer: Optimizer | None = None,
                 device=None) -> TrainResult:
    """Train for ``steps`` timed steps on one fixed synthetic batch.

    ``device`` defaults to the CUDA card (``"cpu"`` must be asked for).
    ``warmup`` untimed steps absorb first-call costs; each timed step ends
    in a host read of the loss, which waits for the card to finish the
    step, so steps/sec reflects device time. ``gate()`` (if given) runs
    before every step."""
    device = resolve_device(device)
    params = to_device(init_fn(seed), device)
    batch = to_device(batch_fn(seed + 1), device)
    optimizer = optimizer or fused_adam(learning_rate)
    opt_state = optimizer.init(params)
    step = make_train_step(loss_fn, optimizer)

    loss = torch.zeros(())
    for _ in range(warmup):
        params, opt_state, loss = step(params, opt_state, batch)
    float(loss)
    synchronize(device)

    first = float("nan")
    start = time.perf_counter()
    for i in range(steps):
        if gate is not None:
            gate()
        params, opt_state, loss = step(params, opt_state, batch)
        value = float(loss)       # host read: the completion barrier
        if i == 0:
            first = value
    elapsed = time.perf_counter() - start
    return TrainResult(steps=steps, seconds=elapsed,
                       final_loss=float(loss), first_loss=first)


def main_cli(model_name: str, init_fn, loss_fn, batch_fn,
             argv=None) -> TrainResult:
    """Shared ``python -m kubeshare_tpu_torch.models.<name> --steps N``."""
    import argparse

    parser = argparse.ArgumentParser(
        prog=f"kubeshare_tpu_torch.models.{model_name}")
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    result = run_training(init_fn, loss_fn, batch_fn, args.steps,
                          learning_rate=args.lr, seed=args.seed,
                          device=args.device)
    print(f"{model_name}: {result.steps} steps in {result.seconds:.2f}s "
          f"= {result.steps_per_sec:.2f} steps/s, final loss "
          f"{result.final_loss:.4f}")
    return result
