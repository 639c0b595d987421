"""GPipe-style pipeline parallelism over a ``pp`` mesh axis.

Counterpart of ``kubeshare_tpu/parallel/pipeline.py``. A model is S
structurally identical stages whose parameters are STACKED on a leading
axis; sharding that axis over ``pp`` gives each rank one stage.
Microbatches flow round the ring: each tick every rank applies its stage
to its current microbatch and shifts the activation one hop forward
(:func:`~.collectives.ring_shift`). The schedule is JAX's: M + S − 1
ticks, idle ticks computing on zeros, and the last stage's outputs
replicated to every rank by a sum over ``pp`` (:func:`~.collectives.
psum`, whose backward passes the replicated cotangent through).

The body runs on this rank's stage: ``stacked_params`` leaves have a
leading axis of 1, ``xs`` is the whole microbatched input (only the
first stage reads it).
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import Replicate, Shard

from ..utils.tree import tree_map
from .collectives import anchor, psum, ring_shift
from .ringattention import _ring


def stage_sharding(mesh, stacked_params, axis_name: str = "pp"):
    """Layout of stage-stacked parameters: the leading axis over the
    pipeline axis (a tree of placements)."""
    if axis_name not in mesh.mesh_dim_names:
        raise ValueError(f"mesh {tuple(mesh.mesh_dim_names)} has no "
                         f"{axis_name!r} axis")
    stage = tuple(Shard(0) if n == axis_name else Replicate()
                  for n in mesh.mesh_dim_names)
    return tree_map(lambda _: stage, stacked_params)


def pipeline_shard(stage_fn, stacked_params, xs: torch.Tensor,
                   axis_name: str = "pp", *, mesh=None) -> torch.Tensor:
    """This rank's part of the pipeline. ``xs``: (microbatches, mb, ...).
    Returns the LAST stage's outputs, (microbatches, mb, ...), on every
    rank."""
    size, rank, group = _ring(axis_name, mesh)
    params = tree_map(lambda a: a[0], stacked_params)
    m = xs.shape[0]
    first, last = rank == 0, rank == size - 1
    state = torch.zeros_like(xs[0])               # the activation in flight
    outs = []
    ticks = m + size - 1
    for t in range(ticks):
        feed = xs[t] if t < m else torch.zeros_like(xs[0])
        out = stage_fn(params, feed if first else state)
        if first:
            # the first stage reads xs, never what it receives; the
            # received activation still joins the backward's shifts
            out = anchor(out, state)
        if t >= size - 1:
            outs.append(out)
        if t < ticks - 1:
            state, = ring_shift((out,), group) if group is not None \
                else (out,)
    if last:
        buf = torch.stack(outs)
    else:
        # zeros, as JAX's where(last, buf, 0) on the other ranks, in the
        # history of this rank's outputs: its backward still runs, and
        # with it the shifts the other ranks wait on
        buf = anchor(torch.zeros((m, *state.shape), dtype=state.dtype,
                                 device=state.device), *outs)
    return buf if group is None else psum(buf, group)


def make_pipeline(mesh, stage_fn, axis_name: str = "pp"):
    """``fn(stacked_params, xs) -> ys`` over this rank's stage of
    stage-sharded params (:func:`stage_sharding`) and the whole ``xs``;
    ``ys`` is the last stage's output on every rank. Gradients flow (the
    shifts and the sum are differentiable)."""
    if axis_name not in mesh.mesh_dim_names:
        raise ValueError(f"mesh {tuple(mesh.mesh_dim_names)} has no "
                         f"{axis_name!r} axis")

    def fn(stacked_params, xs):
        return pipeline_shard(stage_fn, stacked_params, xs, axis_name,
                              mesh=mesh)

    return fn


def microbatch(x: torch.Tensor, n: int) -> torch.Tensor:
    """(batch, ...) → (n, batch/n, ...)."""
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} not divisible by {n}")
    return x.reshape(n, x.shape[0] // n, *x.shape[1:])
