"""Contiguous ICI sub-mesh selection for multi-chip pods.

The port's copy of ``kubeshare_tpu/scheduler/meshselect.py``. A node whose
devices carry no mesh coordinates — every GPU node from CUDA discovery —
has no mesh here: :func:`node_mesh_shape` gives ``None`` and a
multi-device pod takes the node's top whole-free devices. On an NVSwitch (HGX)
H100 board that flat model is right, since every GPU is one NVLink hop
from every other; a multi-host NVLink domain is not modelled yet.

The reference merely *sums* whole-free cells when filtering a multi-GPU
pod (``pkg/scheduler/filter.go:49-76``) and hands out the top-priority
leaves — an 8-chip workload can land on 8 scattered chips. On TPU that
is not a nitpick but a correctness cliff: XLA collectives ride ICI
*neighbor* links, so a gang must occupy a contiguous sub-mesh (with
torus wraparound, which v4/v5p slices have) or every all-reduce hops
through DCN. This module implements the shape-aware allocation SURVEY
§7.3.4 calls "a genuinely new algorithm":

1. enumerate the factorizations of ``n`` that fit the node's mesh
   (block shapes), most compact first (minimal surface area — the
   communication-minimizing block);
2. slide each shape over every anchor (torus-aware) and take the first
   fully-free placement, preferring blocks near the pod's group;
3. when no exact block exists (fragmentation, non-factoring n), fall
   back to greedy compaction — grow from the best seed by repeatedly
   adding the free chip closest to the chosen set — which still beats
   priority-ordered scattering and never refuses a feasible placement.
"""

from __future__ import annotations

import itertools

from ..topology.cell import Cell
from ..topology.distance import ici_distance


def node_mesh_shape(leaves: list[Cell]) -> tuple[tuple[int, ...],
                                                 tuple[int, ...]] | None:
    """The node's ICI mesh derived from discovery: ``(origin, shape)``
    with shape = max−min+1 per axis (global coords place hosts side by
    side, so a node's sub-mesh need not start at zero) — replaces any
    hand-configured shape. None when the node's leaves don't all carry
    same-rank coordinates."""
    coords = [leaf.coords for leaf in leaves]
    if not coords or any(not c for c in coords):
        return None
    rank = len(coords[0])
    if any(len(c) != rank for c in coords):
        return None
    origin = tuple(min(c[axis] for c in coords) for axis in range(rank))
    shape = tuple(max(c[axis] for c in coords) - origin[axis] + 1
                  for axis in range(rank))
    return origin, shape


def block_shapes(n: int, mesh: tuple[int, ...]) -> list[tuple[int, ...]]:
    """All axis-aligned block shapes with volume ``n`` fitting ``mesh``,
    sorted most-compact first (minimal half-surface = the sum of pairwise
    face areas — the proxy for collective bandwidth)."""
    rank = len(mesh)

    def divisors(v: int, limit: int) -> list[int]:
        return [d for d in range(1, min(v, limit) + 1) if v % d == 0]

    shapes: set[tuple[int, ...]] = set()

    def rec(axis: int, remaining: int, dims: tuple[int, ...]) -> None:
        if axis == rank:
            if remaining == 1:
                shapes.add(dims)
            return
        for d in divisors(remaining, mesh[axis]):
            rec(axis + 1, remaining // d, dims + (d,))

    rec(0, n, ())

    def half_surface(shape: tuple[int, ...]) -> int:
        total = 0
        for axis in range(rank):
            face = 1
            for other in range(rank):
                if other != axis:
                    face *= shape[other]
            total += face
        return total

    return sorted(shapes, key=lambda s: (half_surface(s), s))


def _block_coords(anchor: tuple[int, ...], shape: tuple[int, ...],
                  mesh: tuple[int, ...]) -> list[tuple[int, ...]]:
    """The block's chips, wrapping over the torus per axis."""
    ranges = [[(anchor[axis] + off) % mesh[axis] for off in range(shape[axis])]
              for axis in range(len(mesh))]
    return [tuple(c) for c in itertools.product(*ranges)]


def select_block(free: dict[tuple[int, ...], Cell], n: int,
                 mesh: tuple[int, ...],
                 group_coords: list[tuple[int, ...]] = ()) -> list[Cell] | None:
    """Pick ``n`` free chips forming a contiguous torus block; None when
    no exact block fits. Among equally-compact placements, prefer the one
    closest to the pod's already-placed group members (gang locality)."""
    if n > len(free):
        return None
    for shape in block_shapes(n, mesh):
        best: tuple[float, list[tuple[int, ...]]] | None = None
        for anchor in itertools.product(*[range(s) for s in mesh]):
            coords = _block_coords(anchor, shape, mesh)
            if any(c not in free for c in coords):
                continue
            if not group_coords:
                # deterministic: the lexicographically-first free anchor
                return [free[c] for c in sorted(coords)]
            dist = sum(ici_distance(c, g, mesh)
                       for c in coords for g in group_coords)
            if best is None or dist < best[0]:
                best = (dist, coords)
        if best is not None:
            return [free[c] for c in sorted(best[1])]
    return None


def greedy_compact(free: dict[tuple[int, ...], Cell], n: int,
                   mesh: tuple[int, ...]) -> list[Cell] | None:
    """Fragmentation fallback: grow a compact set from the best seed.
    O(F² · n) over free chips — node-local, so tiny."""
    if n > len(free):
        return None
    coords = list(free)
    best: tuple[float, list[tuple[int, ...]]] | None = None
    for seed in coords:
        chosen = [seed]
        pool = set(coords)
        pool.discard(seed)
        total = 0.0
        while len(chosen) < n:
            nxt = min(pool, key=lambda c: (
                sum(ici_distance(c, ch, mesh) for ch in chosen), c))
            total += sum(ici_distance(nxt, ch, mesh) for ch in chosen)
            chosen.append(nxt)
            pool.discard(nxt)
        if best is None or total < best[0]:
            best = (total, chosen)
    return [free[c] for c in sorted(best[1])]


def select_submesh(leaves: list[Cell], n: int,
                   group_cells: list[Cell] = ()) -> list[Cell] | None:
    """Entry point: ``n`` whole-free leaves forming the tightest
    available ICI sub-mesh. None when the node's leaves carry no usable
    coordinates (caller falls back to priority ordering)."""
    derived = node_mesh_shape(leaves)
    if derived is None:
        return None
    origin, mesh = derived

    def norm(c: tuple[int, ...]) -> tuple[int, ...]:
        return tuple(x - o for x, o in zip(c, origin))

    free = {norm(leaf.coords): leaf
            for leaf in leaves if leaf.available == leaf.leaf_cell_number}
    if len(free) < n:
        return None
    # locality only against SAME-NODE siblings: a cross-node cell's global
    # coords normalized by this node's origin fall outside the mesh, and
    # the torus metric then yields zero/negative distances that invert the
    # preference (cross-node members are DCN-far regardless of position)
    node = leaves[0].node
    group_coords = [norm(c.coords) for c in group_cells
                    if c.coords and len(c.coords) == len(mesh)
                    and c.node == node]
    block = select_block(free, n, mesh, group_coords)
    if block is not None:
        return block
    return greedy_compact(free, n, mesh)
