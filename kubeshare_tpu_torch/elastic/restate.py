"""Re-shard live training state onto a resized mesh.

Counterpart of ``kubeshare_tpu/elastic/restate.py``. The flip half of an
elastic resize is pure control plane (bookings and the
``TPU_VISIBLE_CHIPS`` layout); this module is the data plane: while the
gang is drain-paused, every param and optimizer leaf moves from its old
layout to the one :func:`~..parallel.mesh.param_sharding` assigns on the
NEW mesh.

Ranks, not devices. The port's meshes are ``DeviceMesh``es over ranks of
one process group (:mod:`..parallel.mesh`), one process per device, where
JAX lays arrays over devices of one process. So every function here is
collective over the world group: every rank calls it alike, in the same
leaf order. A rank outside a mesh holds a leaf as a DTensor with an empty
local shard — it keeps the leaf's global shape, dtype and placements and
no state.

Each leaf takes the path JAX's classification gives it (the same rank set
or not), so the stats equal JAX's for the same tree and transitions:

* **donate** — the new mesh spans the same ranks: a pure re-layout. On
  an equal mesh it is ``DTensor.redistribute``; otherwise each rank
  rebuilds the leaf from the old mesh's shards and keeps its new slice.
  The old shards are freed when the caller drops the old tree (the
  trainer does so at once).
* **reshard** — the rank sets differ (grow, shrink). DTensor has no
  redistribute across meshes: the old mesh's ranks rebuild the leaf, its
  first rank broadcasts it over the world group, and each rank of the new
  mesh keeps its slice. Correct first; moving only the slices a rank
  lacks is later work.
* **stream** — a host round trip, taken only where laying the leaf onto
  the new mesh raises (JAX's ``except (ValueError, TypeError)``).

:func:`restate_via_checkpoint` is the last-resort path through
``models/checkpoint.py``'s sharded DCP saves, which reshard on load.

Optimizer slots (Adam's ``mu``/``nu``) mirror param shapes, so the same
per-leaf rule lays them out; Adam's scalar ``count`` replicates. Nothing
here touches the step counter or the batch schedule.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..parallel import collectives as coll
from ..parallel.mesh import (_placement_leaves, distribute, gather_plan,
                             gathered, mesh_device, param_sharding)
from ..utils.tree import tree_flatten, tree_unflatten

__all__ = ["restate_tree", "restate_state", "restate_via_checkpoint",
           "place", "place_tree", "whole_leaf"]


def _new_stats() -> dict:
    return {"donated": 0, "resharded": 0, "streamed": 0,
            "bytes_donated": 0, "bytes_resharded": 0,
            "bytes_streamed": 0}


def mesh_ranks(mesh) -> list[int]:
    """The ranks a mesh spans, in its row-major order."""
    return [int(r) for r in mesh.mesh.flatten().tolist()]


def _member(mesh) -> bool:
    return mesh.get_coordinate() is not None


def place(x, mesh, placements) -> DTensor:
    """The global ``x`` (a tensor or an array, whole on this rank) laid
    out on ``mesh``: this rank's shard, or an empty local shard where
    the rank is outside the mesh. No collective."""
    if _member(mesh):
        return distribute(x, mesh, placements)
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    # a 0-d leaf keeps a 0-d placeholder: DTensor takes an empty shape as
    # no shape given and would read the placeholder's (0,)
    empty = torch.empty(() if x.dim() == 0 else 0, dtype=x.dtype,
                        device=mesh_device(mesh))
    return DTensor.from_local(empty, mesh, placements, run_check=False,
                              shape=x.shape, stride=x.contiguous().stride())


def place_tree(tree, mesh, shardings=None):
    """Every leaf of the global ``tree`` laid out per ``shardings`` (a
    tree of placement tuples, or one tuple for every leaf; default
    :func:`param_sharding`) with :func:`place`."""
    if shardings is None:
        shardings = param_sharding(mesh, tree)
    leaves, treedef = tree_flatten(tree)
    if isinstance(shardings, tuple) and all(
            not isinstance(s, tuple) for s in shardings):
        places = [shardings] * len(leaves)
    else:
        places = _placement_leaves(shardings)
    return tree_unflatten(treedef, [place(x, mesh, p)
                                    for x, p in zip(leaves, places)])


def _nbytes(x) -> int:
    """The leaf's global bytes (JAX's ``nbytes`` of a global array)."""
    return int(x.numel() * x.element_size())


def whole_leaf(x: DTensor) -> torch.Tensor | None:
    """The whole leaf on a rank of its mesh, None on a rank outside it.
    Collective over the mesh's axis groups: every member calls it."""
    if not _member(x.device_mesh):
        return None
    with torch.no_grad():
        return gathered(x.to_local().detach(),
                        gather_plan(x, x.device_mesh)).contiguous()


def _broadcast_whole(x, src: int) -> torch.Tensor:
    """The whole leaf on every rank of the world: ``src`` (the first rank
    of the leaf's mesh) sends its bytes, staged through host memory where
    the group is gloo."""
    world = dist.group.WORLD
    # every member takes part in the gather; src sends what it gathered
    whole = whole_leaf(x)
    if dist.get_rank() == src:
        buf = coll._to_wire(coll._as_bytes([whole]), world)
    else:
        device = x.to_local().device
        buf = coll._to_wire(torch.empty(_nbytes(x), dtype=torch.uint8,
                                        device=device), world)
    dist.broadcast(buf, src=src, group=world)
    like = torch.empty(tuple(x.shape), dtype=x.dtype, device="meta")
    return coll._from_bytes(buf, [like], x.to_local().device)[0]


def _relay_leaf(x, placements, new_mesh, new_ranks: frozenset,
                stats: dict):
    nbytes = _nbytes(x)
    if isinstance(x, DTensor):
        old_mesh = x.device_mesh
        old = frozenset(mesh_ranks(old_mesh))
    else:
        old_mesh, old = None, frozenset()
    if old and old == new_ranks:
        # pure re-layout over the same ranks: the old shards free as the
        # caller drops the old tree
        if old_mesh == new_mesh:
            out = x.redistribute(new_mesh, placements)
        else:
            out = place(whole_leaf(x), new_mesh, placements)
        stats["donated"] += 1
        stats["bytes_donated"] += nbytes
        return out
    if old_mesh is None:
        whole = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))           # already whole on every rank
    else:
        whole = _broadcast_whole(x, mesh_ranks(old_mesh)[0])
    try:
        out = place(whole, new_mesh, placements)
        stats["resharded"] += 1
        stats["bytes_resharded"] += nbytes
        return out
    except (ValueError, TypeError):
        host = whole.detach().cpu().numpy()
        stats["streamed"] += 1
        stats["bytes_streamed"] += int(host.nbytes)
        return place(host, new_mesh, placements)


def restate_tree(tree, new_mesh, stats: dict | None = None):
    """Re-lay one tree onto ``new_mesh`` per the
    :func:`~..parallel.mesh.param_sharding` rule. Returns
    ``(tree, stats)``; an empty tree passes through untouched.
    Collective over the world group."""
    stats = _new_stats() if stats is None else stats
    leaves, treedef = tree_flatten(tree)
    if not leaves:
        return tree, stats
    places = _placement_leaves(param_sharding(new_mesh, tree))
    new_ranks = frozenset(mesh_ranks(new_mesh))
    out = [_relay_leaf(x, p, new_mesh, new_ranks, stats)
           for x, p in zip(leaves, places)]
    return tree_unflatten(treedef, out), stats


def restate_state(params, opt_state, new_mesh):
    """Re-shard a full training state — ``(params, opt_state, stats)`` —
    onto ``new_mesh``. The two trees share one stats dict, so the caller
    journals a single donated/resharded/streamed tally."""
    stats = _new_stats()
    params, _ = restate_tree(params, new_mesh, stats)
    opt_state, _ = restate_tree(opt_state, new_mesh, stats)
    return params, opt_state, stats


def _like_on(tree, mesh):
    """Empty leaves of ``tree``'s global shapes and dtypes, laid out on
    ``mesh`` (the structure a checkpoint load fills)."""
    leaves, treedef = tree_flatten(tree)
    device = torch.device("cpu")
    empties = [torch.empty(tuple(x.shape), dtype=x.dtype, device=device)
               for x in leaves]
    return place_tree(tree_unflatten(treedef, empties), mesh)


def restate_via_checkpoint(path: str, params, opt_state, new_mesh,
                           step: int = 0):
    """Fallback serialization path: save the state through
    ``models/checkpoint.py`` (a sharded DCP save in a gang, every rank
    writing its shards) and load it laid out on ``new_mesh`` (DCP
    reshards on load). Slow — a full write and read — but shape-agnostic.
    Returns ``(params, opt_state, step)`` already on the new mesh.
    Collective over the world group."""
    from ..models.checkpoint import load_checkpoint, save_checkpoint

    save_checkpoint(path, params, opt_state, step)
    return load_checkpoint(path, _like_on(params, new_mesh),
                           _like_on(opt_state, new_mesh))
