"""Device-mesh and sharding helpers for multi-device gangs.

Counterpart of ``kubeshare_tpu/parallel/mesh.py``. The JAX package runs
SPMD over a ``jax.sharding.Mesh``: it annotates shardings and lets XLA
insert the collectives. The port runs one process per device, joined in
one ``torch.distributed`` group (:mod:`.runner`), and a mesh is a
:class:`~torch.distributed.device_mesh.DeviceMesh` over the group's
ranks, whose axes each have a process group.

A "sharding" is the tuple of DTensor placements a leaf takes, one per
mesh axis (where JAX has a ``NamedSharding``): ``Shard(d)`` splits tensor
dim ``d`` over that axis, ``Replicate()`` keeps it whole. A tree laid
out so (:func:`shard_tree`, :func:`shard_init`) has DTensor leaves, each
holding this rank's shard; ``torch.distributed.checkpoint`` saves and
reshards them.

The sharded train step (:func:`make_sharded_train_step`) computes what
JAX's computes: XLA's partitioner keeps the single-device semantics on
the global batch, and so does the step. Each rank keeps only its shards,
gathers a sharded leaf where the loss uses it, takes its share of the
global loss (the loss over its part of the batch, divided by the number
of parts), and sums the gradients over every axis that splits the batch.
Statistics over the batch (batchnorm's mean and variance) are summed
over those axes inside the forward, through the step's local view
(:mod:`.collectives`).

``devices`` arguments name RANKS of the group, as a list of ints, where
JAX takes device objects. Outside any process group a mesh describes its
shape only (as a JAX mesh of devices one never runs on), unless it has
one rank.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..utils.tree import tree_flatten, tree_map, tree_unflatten
from .collectives import (LocalView, all_gather, all_reduce_, axis_group,
                          axis_index, axis_size, local_view)

#: where a mesh's tensors live when the caller does not say: the card
DEFAULT_DEVICE_TYPE = "cuda"


def _default_tp(n: int) -> int:
    """Largest power of two ≤ √n that divides n: a square-ish split."""
    tp = 1 << (int(math.isqrt(n)).bit_length() - 1) if n > 1 else 1
    while n % tp:
        tp //= 2
    return tp


def _ranks(devices) -> list[int]:
    """The ranks a mesh spans: ``devices``, or every rank of the group."""
    if devices is not None:
        return [int(d) for d in devices]
    world = dist.get_world_size() if dist.is_initialized() else 1
    return list(range(world))


def new_mesh(ranks, names, device_type: str | None = None) -> DeviceMesh:
    """A DeviceMesh over ``ranks`` (an int array whose shape is the
    mesh's), its axes named ``names``. Under a process group every rank
    must call this alike (each axis gets a group); outside one the mesh
    has no groups."""
    device_type = device_type or DEFAULT_DEVICE_TYPE
    arr = torch.as_tensor(np.asarray(ranks, dtype=np.int64))
    names = tuple(names)
    if dist.is_available() and dist.is_initialized():
        return DeviceMesh(device_type, arr, mesh_dim_names=names)
    return DeviceMesh(device_type, arr, mesh_dim_names=names,
                      _init_backend=False, _rank=0)


def make_mesh(devices=None, dp: int | None = None, tp: int | None = None,
              *, device_type: str | None = None) -> DeviceMesh:
    """A 2-D ``(dp, tp)`` mesh over ``devices`` (ranks; default: all).

    With neither axis given, tp gets the largest power of two ≤ √n and dp
    the rest."""
    ranks = _ranks(devices)
    n = len(ranks)
    for name, axis in (("dp", dp), ("tp", tp)):
        if axis is not None and axis <= 0:
            raise ValueError(f"{name} must be positive, got {axis}")
    if dp is None and tp is None:
        tp = _default_tp(n)
        dp = n // tp
    elif dp is None:
        dp = n // tp
    elif tp is None:
        tp = n // dp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != device count {n}")
    return new_mesh(np.array(ranks).reshape(dp, tp), ("dp", "tp"),
                    device_type)


def _names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def data_sharding(mesh) -> tuple:
    """Batch arrays: the leading axis split over every data axis the mesh
    has (``dcn`` and/or ``dp``, dcn the major), replicated elsewhere."""
    return tuple(Shard(0) if n in ("dcn", "dp") else Replicate()
                 for n in _names(mesh))


def token_sharding(mesh) -> tuple:
    """Token batches (batch, seq): batch over every data axis, the
    sequence over ``sp`` when the mesh has one — the long-context layout
    ring attention consumes."""
    return tuple(Shard(0) if n in ("dcn", "dp")
                 else Shard(1) if n == "sp" else Replicate()
                 for n in _names(mesh))


def replicated(mesh) -> tuple:
    return tuple(Replicate() for _ in _names(mesh))


def param_sharding(mesh, params):
    """Tensor-parallel parameter layout, a tree of placements mirroring
    ``params``: a leaf with ndim ≥ 2 whose last axis tp divides is split
    on that axis over tp (the Megatron-style column split); everything
    else is replicated."""
    tp = axis_size(mesh, "tp")
    names = _names(mesh)

    def shard_leaf(x):
        shape = tuple(getattr(x, "shape", ()))
        if len(shape) >= 2 and shape[-1] % tp == 0 and shape[-1] >= tp:
            return tuple(Shard(len(shape) - 1) if n == "tp" else Replicate()
                         for n in names)
        return replicated(mesh)

    return tree_map(shard_leaf, params)


def mesh_device(mesh) -> torch.device:
    """The device this rank's shards live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_shard(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of the global ``x`` under ``placements``
    (several axes on one dim split it major to minor, as DTensor
    does)."""
    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = mesh.size(i)
            size = x.shape[pl.dim]
            if size % n:
                raise ValueError(f"dim {pl.dim} of size {size} does not "
                                 f"split over {n} ranks of axis "
                                 f"{_names(mesh)[i]!r}")
            x = x.narrow(pl.dim, coord[i] * (size // n), size // n)
    return x.contiguous()


def distribute(x, mesh, placements) -> DTensor:
    """The global ``x`` (a tensor, or an array) as a DTensor holding this
    rank's shard, on the mesh's device; no collective."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    x = x.to(mesh_device(mesh))
    local = local_shard(x, mesh, placements)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=x.shape, stride=x.contiguous().stride())


def shard_tree(tree, shardings, mesh):
    """Every leaf of the global ``tree`` laid out by the matching
    placements of ``shardings`` (a tree of placement tuples, or one tuple
    for every leaf)."""
    leaves, treedef = tree_flatten(tree)
    if isinstance(shardings, tuple) and all(
            not isinstance(s, tuple) for s in shardings):
        places = [shardings] * len(leaves)
    else:
        places = _placement_leaves(shardings)
        if len(places) != len(leaves):
            raise ValueError("tree and shardings differ in structure")
    return tree_unflatten(treedef, [distribute(x, mesh, p)
                                    for x, p in zip(leaves, places)])


def _placement_leaves(shardings) -> list:
    """The placement tuples of a shardings tree, in leaf order (a
    placement tuple is a leaf, not a node)."""
    out: list = []

    def rec(node):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(node[k])
        elif isinstance(node, list) or (
                isinstance(node, tuple) and node
                and isinstance(node[0], (tuple, list, dict))):
            for c in node:
                rec(c)
        else:
            out.append(tuple(node))

    rec(shardings)
    return out


def to_local(x):
    """This rank's shard of a DTensor leaf; anything else as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def gather_plan(x, mesh) -> list[tuple[int, object]]:
    """``(tensor dim, axis group)`` of each split of a DTensor leaf over
    an axis of size > 1, minor axis first: the gathers that rebuild it."""
    if not isinstance(x, DTensor):
        return []
    plan = []
    for i in reversed(range(mesh.ndim)):
        pl = x.placements[i]
        if isinstance(pl, Shard) and mesh.size(i) > 1:
            plan.append((pl.dim, axis_group(mesh, _names(mesh)[i])))
    return plan


def gathered(x: torch.Tensor, plan) -> torch.Tensor:
    """The whole leaf from this rank's shard (differentiable)."""
    for dim, group in plan:
        x = all_gather(x, dim, group)
    return x


def _batch_axes(mesh, batch_sharding) -> tuple[str, ...]:
    """The mesh axes (of size > 1) over which the batch is split."""
    return tuple(n for n, pl in zip(_names(mesh), batch_sharding)
                 if isinstance(pl, Shard) and axis_size(mesh, n) > 1)


def _sum_grads(grads: list, mesh, axes) -> list:
    """The gradients summed over ``axes``: one flat buffer a dtype, one
    all-reduce an axis. Returns the summed leaves (views of the
    buffers)."""
    if not axes:
        return grads
    out = list(grads)
    by_dtype: dict = {}
    for i, g in enumerate(grads):
        by_dtype.setdefault(g.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        for name in axes:
            all_reduce_(flat, axis_group(mesh, name))
        at = 0
        for i in idx:
            n = grads[i].numel()
            out[i] = flat[at:at + n].view(grads[i].shape)
            at += n
    return out


def make_sharded_train_step(loss_fn: Callable, optimizer, mesh,
                            batch_sharding=None):
    """``step(params, opt_state, batch) -> (params, opt_state, loss)``
    over trees laid out on ``mesh`` (DTensor leaves: params and Adam's
    state per :func:`param_sharding`, the batch per ``batch_sharding``,
    default :func:`data_sharding`; pass :func:`token_sharding`'s for
    sequence-split token batches). One step body with the single-device
    path (``models.common.make_train_step``), and its semantics on the
    global batch:

    - a leaf split over an axis is gathered where the loss uses it (the
      ranks of that axis hold the same batch and compute alike);
    - a rank's loss is ``loss_fn`` over its part of the batch divided by
      the number of parts, so the parts' losses sum to the global mean;
      a statistic over the batch inside the model sums over the parts
      (the step's local view);
    - every gradient is summed over the axes that split the batch; then
      fused Adam updates each rank's local shards in place (one
      multi-tensor launch per 64 leaves);
    - the loss returned is the global loss, the same on every rank."""
    from ..models.common import value_and_grad

    if batch_sharding is None:
        batch_sharding = data_sharding(mesh)
    axes = _batch_axes(mesh, batch_sharding)
    parts = math.prod(axis_size(mesh, n) for n in axes)
    seq_axis = next((n for n, pl in zip(_names(mesh), batch_sharding)
                     if isinstance(pl, Shard) and pl.dim == 1
                     and axis_size(mesh, n) > 1), None)

    def step(params, opt_state, batch):
        leaves, treedef = tree_flatten(params)
        plans = [gather_plan(p, mesh) for p in leaves]
        local_params = tree_unflatten(treedef, [to_local(p) for p in leaves])
        local_batch = tree_map(to_local, batch)
        offset = 0
        if seq_axis is not None:
            offset = (axis_index(mesh, seq_axis)
                      * tree_flatten(local_batch)[0][0].shape[1])

        def local_loss(ps, b):
            full = [gathered(x, plan) for x, plan in
                    zip(tree_flatten(ps)[0], plans)]
            loss = loss_fn(tree_unflatten(treedef, full), b)
            return loss / parts if parts > 1 else loss

        with local_view(LocalView(mesh, axes, offset)):
            loss, grads = value_and_grad(local_loss, local_params,
                                         local_batch)
        g_leaves, g_def = tree_flatten(grads)
        grads = tree_unflatten(g_def, _sum_grads(g_leaves, mesh, axes))
        for name in axes:
            all_reduce_(loss, axis_group(mesh, name))
        optimizer.update(grads, tree_map(to_local, opt_state), local_params)
        return params, opt_state, loss

    return step


def shard_init(init_fn: Callable, seed, mesh):
    """Parameters made by ``init_fn(seed)`` and laid out per
    :func:`param_sharding` (every rank makes the whole tree from the seed
    and keeps its shards — fine at these model sizes)."""
    params = init_fn(seed)
    return shard_tree(params, param_sharding(mesh, params), mesh)


def make_carved_mesh(carve: str, devices=None,
                     mesh_shape: str | tuple[int, ...] | None = None, *,
                     device_type: str | None = None) -> DeviceMesh:
    """The gang's 2-D ``(dp, tp)`` mesh from a carved
    ``TPU_VISIBLE_CHIPS`` value (``"chip@x.y,..."``).

    The carve is validated against the planned block first:
    ``mesh_shape`` is the node's mesh (``constants.ENV_MESH_SHAPE``, e.g.
    ``"2x4"``), so wrap-around blocks validate; a non-contiguous carve
    raises :class:`~kubeshare_tpu_torch.gang.carve.CarveError`.

    ``devices`` (ranks; default: all) are laid onto the block in
    row-major coordinate order, one per carved chip (rank ``i`` behind
    entry ``i``), so mesh neighbours are torus neighbours. 1-D carves
    give a ``(1, n)`` mesh; 2-D carves map block rows to dp, columns to
    tp."""
    from ..gang.carve import (CarveError, carve_block, parse_mesh,
                              parse_visible_chips)

    entries = parse_visible_chips(carve)
    mesh = None
    if mesh_shape:
        mesh = parse_mesh(mesh_shape) if isinstance(mesh_shape, str) \
            else tuple(mesh_shape)
    origin, shape = carve_block(entries, mesh=mesh)
    n = len(entries)
    ranks = _ranks(devices)
    if len(ranks) < n:
        raise CarveError(f"carve names {n} chips but only {len(ranks)} "
                         f"devices are visible")
    ranks = ranks[:n]
    if len(shape) == 1:
        dp, tp = 1, shape[0]
    else:
        dp = shape[0]
        tp = n // shape[0]

    def block_pos(c):
        pos = []
        for axis, (v, o) in enumerate(zip(c, origin)):
            d = v - o
            if mesh is not None:
                d %= mesh[axis]
            pos.append(d)
        return tuple(pos)

    order = sorted(range(n), key=lambda i: block_pos(entries[i][1]))
    ranks = [ranks[i] for i in order]
    return new_mesh(np.array(ranks).reshape(dp, tp), ("dp", "tp"),
                    device_type)


def make_hybrid_mesh(device_slices, tp: int | None = None, *,
                     device_type: str | None = None) -> DeviceMesh:
    """A mesh spanning several groups of ranks, axes ``(dcn, dp, tp)``.

    ``device_slices`` is a list of equal-sized lists of ranks (one per
    host or NVLink domain). ``dcn`` crosses the groups, so only the data-
    parallel gradient sum rides the slow links; ``dp`` and ``tp`` stay
    inside a group."""
    sizes = {len(d) for d in device_slices}
    if len(sizes) != 1:
        raise ValueError(f"slices must be equal-sized, got {sorted(sizes)}")
    per = sizes.pop()
    if per == 0:
        raise ValueError("empty slices")
    if tp is None:
        tp = _default_tp(per)
    elif tp <= 0:
        raise ValueError(f"tp must be positive, got {tp}")
    if per % tp:
        raise ValueError(f"tp={tp} does not divide slice size {per}")
    dp = per // tp
    arr = np.array([[int(r) for r in d] for d in device_slices])
    return new_mesh(arr.reshape(len(device_slices), dp, tp),
                    ("dcn", "dp", "tp"), device_type)
