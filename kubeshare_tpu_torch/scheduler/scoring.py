"""Scoring: node ranking + reserve-time cell selection.

The port's copy of ``kubeshare_tpu/scheduler/scoring.py``.

Re-design of ``pkg/scheduler/score.go``. Three node formulas:

- *regular* (no TPU labels): chips are the scarce resource, so chip-less
  nodes score 100 and chip nodes 0 — steering ordinary workloads away.
  (The reference's comment states this intent; its code returns the
  opposite (``score.go:14-21``) — we implement the documented intent.)
- *opportunistic* (priority ≤ 0): pack onto busy, powerful chips —
  per-leaf ``priority + usage·100``, minus the node's free-leaf fraction
  ·100 (defragmentation), averaged (``score.go:42-68``).
- *guarantee* (priority > 0): prefer free, powerful, group-local chips —
  per-leaf ``priority − usage·100 − locality·100``, averaged
  (``score.go:85-112``).

Locality is the TPU upgrade: when both cells carry ICI coordinates the
distance is mesh manhattan distance (``topology.distance.ici_distance``);
otherwise the reference's hierarchical cell-ID distance. DCN hops keep the
reference's +100-per-mismatch weighting.

Reserve-time selection (``calculate*PodCellScore``, score.go:297-442)
ranks the node's leaves with the same biases and picks the first that
fits (shared) or the top whole-free N (multi-chip).
"""

from __future__ import annotations

import math

from ..topology.cell import Cell
from ..topology.distance import cell_id_distance, ici_distance
from .filtering import node_leaf_cells
from .labels import PodRequest

USAGE_WEIGHT = 100.0
LOCALITY_WEIGHT = 100.0
FREE_LEAF_WEIGHT = 100.0


def cell_distance(cell: Cell, other_id: str,
                  other_coords: tuple[int, ...] = (),
                  mesh_shape: tuple[int, ...] | None = None) -> float:
    """ICI mesh distance when both ends have coordinates, else the
    reference's cell-ID distance."""
    if cell.coords and other_coords:
        return ici_distance(cell.coords, other_coords, mesh_shape)
    return cell_id_distance(cell.id, other_id)


def group_locality(cell: Cell, group_cells: list[Cell],
                   mesh_shape: tuple[int, ...] | None = None) -> float:
    """Mean distance from *cell* to the group's already-placed cells."""
    if not group_cells:
        return 0.0
    total = sum(cell_distance(cell, g.id, g.coords, mesh_shape)
                for g in group_cells)
    return total / len(group_cells)


def score_regular_node(has_chips: bool) -> float:
    return 0.0 if has_chips else 100.0


def score_opportunistic_node(leaves: list[Cell],
                             chip_priority: dict[str, int]) -> float:
    if not leaves:
        return 0.0
    score = 0.0
    free_leaves = 0
    for leaf in leaves:
        score += chip_priority.get(leaf.cell_type, leaf.priority)
        if leaf.available == leaf.leaf_cell_number:
            free_leaves += 1
        else:
            score += (1.0 - leaf.available) * USAGE_WEIGHT
    n = len(leaves)
    score -= free_leaves / n * FREE_LEAF_WEIGHT
    return score / n


def score_guarantee_node(leaves: list[Cell], chip_priority: dict[str, int],
                         group_cells: list[Cell],
                         mesh_shape: tuple[int, ...] | None = None) -> float:
    if not leaves:
        return 0.0
    score = 0.0
    for leaf in leaves:
        score += (chip_priority.get(leaf.cell_type, leaf.priority)
                  - (1.0 - leaf.available) * USAGE_WEIGHT)
        if group_cells:
            score -= (group_locality(leaf, group_cells, mesh_shape)
                      * LOCALITY_WEIGHT)
    return score / len(leaves)


def normalize_scores(scores: dict[str, float]) -> dict[str, int]:
    """Map raw node scores into [0, 100] (``NormalizeScore``,
    scheduler.go:443-487): shift negatives to zero, rescale only when the
    range leaves [0, 100]."""
    if not scores:
        return {}
    lo = min(scores.values())
    hi = max(scores.values())
    shifted = {k: v - lo for k, v in scores.items()} if lo < 0 else dict(scores)
    if lo < 0:
        hi -= lo
        lo = 0.0
    if 0 <= lo and hi <= 100:
        return {k: int(v) for k, v in shifted.items()}
    ratio = (hi - lo) or 100.0
    return {k: int(100.0 * (v - lo) / ratio) for k, v in shifted.items()}


def select_cells(free_list, node_name: str, pod: PodRequest,
                 chip_priority: dict[str, int], group_cells: list[Cell],
                 mesh_shape: tuple[int, ...] | None = None) -> list[Cell]:
    """Reserve-time leaf choice (score.go:297-442). Returns [] when the
    node can no longer fit the pod (raced capacity)."""
    if pod.multi_chip and not pod.model:
        # One mesh workload never spans chip generations: try each model's
        # leaves separately, best-priority model first.
        models = sorted(free_list,
                        key=lambda m: -chip_priority.get(m, 0))
        for model in models:
            constrained = PodRequest(**{**pod.__dict__, "model": model})
            chosen = select_cells(free_list, node_name, constrained,
                                  chip_priority, group_cells, mesh_shape)
            if chosen:
                return chosen
        return []
    leaves = node_leaf_cells(free_list, node_name, pod.model)
    if pod.multi_chip:
        # ICI shape-aware allocation (SURVEY §7.3.4): a mesh workload gets
        # a CONTIGUOUS torus block, not the top-priority scatter — XLA
        # collectives ride neighbor links. Mesh shape comes from
        # discovery; cells without coordinates fall through to the
        # priority ordering below.
        from .meshselect import select_submesh

        block = select_submesh(leaves, int(pod.request), group_cells)
        if block is not None:
            return block
    scored: list[tuple[float, Cell]] = []
    for leaf in leaves:
        prio = float(chip_priority.get(leaf.cell_type, leaf.priority))
        if pod.multi_chip:
            if leaf.available != leaf.leaf_cell_number:
                continue
            score = prio
        elif pod.opportunistic:
            score = prio + (1.0 - leaf.available) * USAGE_WEIGHT  # pack
        else:
            score = prio - (1.0 - leaf.available) * USAGE_WEIGHT  # spread
        if group_cells:
            score -= group_locality(leaf, group_cells, mesh_shape) * LOCALITY_WEIGHT
        scored.append((score, leaf))
    scored.sort(key=lambda sc: (-sc[0], sc[1].id))

    chosen: list[Cell] = []
    remaining = pod.request
    for _, leaf in scored:
        if pod.multi_chip:
            chosen.append(leaf)
            remaining -= 1.0
        else:
            # Fit-check against the memory that will actually be booked:
            # an unset tpu_mem defaults to request x full HBM at reserve
            # time (pod.go:419-424), so checking against 0 here would let
            # the defaulted cap overcommit the leaf.
            needed = pod.memory or int(
                math.floor(pod.request * leaf.full_memory))
            if leaf.available >= pod.request and leaf.free_memory >= needed:
                chosen.append(leaf)
                remaining = 0.0
        if remaining <= 0.0:
            return chosen
    return []
