"""Cross-host shape-aware gang placement.

The port's copy of ``kubeshare_tpu/scheduler/gangplan.py``. A fleet
without coordinates (GPU nodes) plans nothing, and its gangs take the
node-local path.

:mod:`.meshselect` gives one *pod* a contiguous ICI block on one node;
this module gives a *gang* a contiguous block over the multi-host slice
mesh, then carves it into per-member sub-blocks that each fall inside a
single host — the ICI analogue of the reference's multi-node cells
(``deploy/config/kubeshare-config-final.yaml``'s ``2-V100-NODE`` spanning
two hosts) and the second half of SURVEY §7.3.4's "genuinely new
algorithm": per-member node-local blocks plus additive locality scoring
cannot guarantee that the union of member placements tiles a contiguous
multi-host sub-mesh.

The plan is computed once per gang, when its first whole-chip member
first enters PreFilter, and consumed slot-by-slot as members reserve:

1. group the fleet's healthy leaves by tree root (one root = one slice =
   one coordinate space; cross-root placement would put DCN inside the
   gang's mesh);
2. inside each root, find the most compact contiguous torus block of
   ``headcount x per_member`` whole-free chips (same shape enumeration
   as :mod:`.meshselect`);
3. accept a block only if it *tiles*: each host's share of the block
   splits into contiguous ``per_member``-chip sub-blocks (a member pod
   runs on exactly one host);
4. emit slots ordered along the block, so consecutive gang ranks sit on
   ICI neighbours (ring collectives ride neighbour links).

When no candidate block tiles (fragmentation, no coordinates, fractional
members), planning returns None and the engine falls back to the
node-local path — planning narrows placements, never refuses a feasible
gang.
"""

from __future__ import annotations

import itertools

from ..topology.cell import Cell
from .meshselect import _block_coords, block_shapes, node_mesh_shape

#: one planned member placement: (node name, chip ids)
Slot = tuple[str, tuple[str, ...]]


def _roots(leaves: list[Cell]) -> dict[int, list[Cell]]:
    by_root: dict[int, list[Cell]] = {}
    for leaf in leaves:
        cur = leaf
        while cur.parent is not None:
            cur = cur.parent
        by_root.setdefault(id(cur), []).append(leaf)
    return by_root


def _tile_host(coords: set[tuple[int, ...]], k: int,
               mesh: tuple[int, ...]) -> list[list[tuple[int, ...]]] | None:
    """Split *coords* (one host's share of the gang block) into
    contiguous ``k``-blocks; None when it doesn't tile. Recursive
    first-fit anchored at the lexicographically smallest remaining coord
    — exact and fast at node scale (a host has a handful of chips)."""
    if not coords:
        return []
    if len(coords) % k:
        return None
    c0 = min(coords)
    for shape in block_shapes(k, mesh):
        for offsets in itertools.product(*[range(s) for s in shape]):
            anchor = tuple(c - o for c, o in zip(c0, offsets))
            # Non-wrapping only: the fleet bounding box is usually a
            # SUB-slice with no physical wraparound links, so a block
            # that wraps it would pair non-neighbour chips (ADVICE r4).
            if any(a < 0 or a + s > m
                   for a, s, m in zip(anchor, shape, mesh)):
                continue
            block = _block_coords(anchor, shape, mesh)
            if any(c not in coords for c in block):
                continue
            rest = _tile_host(coords - set(block), k, mesh)
            if rest is not None:
                return [sorted(block)] + rest
    return None


def _root_free(root_leaves: list[Cell]):
    """→ ``(free, mesh)``: whole-free healthy leaves keyed by
    origin-normalized coords, plus the root's derived mesh shape; None
    when the root's leaves carry no usable coordinates."""
    derived = node_mesh_shape(root_leaves)
    if derived is None:
        return None
    origin, mesh = derived
    free = {tuple(x - o for x, o in zip(leaf.coords, origin)): leaf
            for leaf in root_leaves
            if leaf.available == leaf.leaf_cell_number and leaf.healthy}
    return free, mesh


def _block_in_root(free: dict, mesh: tuple[int, ...], total: int,
                   per_member: int,
                   shapes: list[tuple[int, ...]] | None = None
                   ) -> tuple[list[Slot], tuple[int, ...], tuple] | None:
    """One contiguous ``total``-chip block inside one root, carved into
    ``per_member`` host-local sub-blocks → ``(slots, block_shape,
    tiling_signature)``. ``shapes`` restricts the candidate block shapes;
    the signature is the sorted tuple of member-tile anchors RELATIVE to
    the block anchor — the cross-slice planner demands identical
    signatures so rank r occupies the same relative position in every
    slice (same shape alone is not enough: host boundaries can tile the
    same shape into different sub-block geometries)."""
    if len(free) < total:
        return None
    for shape in (shapes if shapes is not None
                  else block_shapes(total, mesh)):
        if any(s > m for s, m in zip(shape, mesh)):
            continue
        # Non-wrapping anchors only (ADVICE r4): the derived
        # bounding-box mesh has no physical wrap links unless the
        # block spans the axis's full extent — and a full-extent
        # block is exactly the anchor-0 non-wrapping placement.
        for anchor in itertools.product(
                *[range(m - s + 1) for m, s in zip(mesh, shape)]):
            coords = _block_coords(anchor, shape, mesh)
            if any(c not in free for c in coords):
                continue
            by_host: dict[str, set[tuple[int, ...]]] = {}
            for c in coords:
                by_host.setdefault(free[c].node, set()).add(c)
            if any(len(cs) % per_member for cs in by_host.values()):
                continue
            slots: list[tuple[tuple[int, ...], Slot]] = []
            ok = True
            for node in sorted(by_host):
                tiles = _tile_host(by_host[node], per_member, mesh)
                if tiles is None:
                    ok = False
                    break
                for tile in tiles:
                    # order key is the tile anchor RELATIVE to the block
                    # anchor: two same-shape blocks in different slices
                    # then order their member ranks identically, which
                    # is what aligns dp-ranks across the DCN axis
                    rel = tuple(t - a for t, a in zip(tile[0], anchor))
                    slots.append((rel, (node, tuple(
                        free[c].chip_id for c in tile))))
            if ok:
                # order along the block: consecutive ranks on
                # neighbouring sub-blocks
                ordered = sorted(slots)
                return ([slot for _, slot in ordered], shape,
                        tuple(rel for rel, _ in ordered))
    return None


def plan_gang(leaves: list[Cell], members: int,
              per_member: int) -> list[Slot] | None:
    """A slot per gang member — ``(node, chip_ids)`` with ``per_member``
    contiguous whole-free chips on one host — or None when no such
    placement exists right now.

    Two levels (SURVEY §5's ICI/DCN tiers):

    1. **single slice**: the whole gang as one contiguous torus block in
       one tree root (ICI only — always preferred);
    2. **cross-slice (DCN tier)**: when no root fits the gang, split it
       over the FEWEST slices S (S divides the member count) with one
       contiguous block per slice, all blocks the SAME shape and member
       ranks ordered identically inside each block. Slots are emitted
       slice-major, so rank r lands in slice ``r // (members/S)`` —
       exactly the ``(dcn, dp, tp)`` layout ``parallel.mesh
       .make_hybrid_mesh`` builds: the DCN axis crosses slices, dp/tp
       stay inside ICI. Reference analogue: multi-node cells
       (``deploy/config/kubeshare-config-final.yaml`` ``2-V100-NODE``).
    """
    total = members * per_member
    roots = []
    for root_leaves in _roots(leaves).values():
        rf = _root_free(root_leaves)
        if rf is not None and rf[0]:
            roots.append(rf)
    # deterministic slice order (the _roots dict is keyed by object id):
    # smallest chip id in the root — stable across planner invocations
    roots.sort(key=lambda rf: min(c.chip_id for c in rf[0].values()))

    # level 1: the whole gang inside one slice (no DCN in the gang mesh)
    for free, mesh in roots:
        found = _block_in_root(free, mesh, total, per_member)
        if found is not None:
            return found[0]

    # level 2: S equal slices, one same-shape block each, slice-major
    for S in range(2, len(roots) + 1):
        if members % S:
            continue
        sub_members = members // S
        sub_total = sub_members * per_member
        # candidate shapes must fit SOME root; iterate most-compact first
        # over the union of each root's shape menu
        shape_menu: list[tuple[int, ...]] = []
        for _, mesh in roots:
            for shape in block_shapes(sub_total, mesh):
                if shape not in shape_menu:
                    shape_menu.append(shape)
        for shape in shape_menu:
            picked: list[list[Slot]] = []
            signature = None
            for free, mesh in roots:
                found = _block_in_root(free, mesh, sub_total, per_member,
                                       shapes=[shape])
                if found is None:
                    continue
                if signature is None:
                    signature = found[2]
                elif found[2] != signature:
                    # same shape but a DIFFERENT tiling geometry (host
                    # boundaries cut the block differently): ranks would
                    # not align across the DCN axis — skip this slice
                    continue
                picked.append(found[0])
                if len(picked) == S:
                    break
            if len(picked) == S:
                return [slot for block in picked for slot in block]
    return None


def fleet_leaf_cells(free_list, node_names, model: str = "") -> list[Cell]:
    """Healthy leaves across the whole fleet (the cross-node counterpart
    of :func:`.filtering.node_leaf_cells`)."""
    from .filtering import node_leaf_cells

    leaves: list[Cell] = []
    for node in node_names:
        leaves.extend(node_leaf_cells(free_list, node, model))
    return leaves
