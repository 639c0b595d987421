"""Node filtering: can this node's cells satisfy a workload?

The port's copy of ``kubeshare_tpu/scheduler/filtering.py``.

Re-design of ``pkg/scheduler/filter.go:5-104``. Two resource shapes:

- *shared* (request ≤ 1): one healthy leaf on the node must have
  ``available >= request`` and ``free_memory >= memory``;
- *multi-chip* (integer request > 1): the node-level cells' whole-free
  leaves (``available_whole_cell``) and free HBM must sum to cover the
  request.

The walk prunes subtrees pinned to other nodes (a cell with ``node`` set
to a different host can't contain this node's leaves) and skips unhealthy
cells entirely — unhealthy capacity stays booked but is never offered
(node.go:216-254 semantics).
"""

from __future__ import annotations

import math

from ..topology.cell import LOWEST_LEVEL, Cell, FreeList


def _node_subtree(cell: Cell, node_name: str):
    """Healthy cells of *cell*'s tree that can contain ``node_name``'s
    leaves, in DFS order."""
    if cell.node not in ("", node_name) or not cell.healthy:
        return
    stack = [cell]
    while stack:
        cur = stack.pop()
        yield cur
        if cur.node in ("", node_name):
            stack.extend(c for c in cur.children
                         if c.node in ("", node_name) and c.healthy)


def check_cell_resource(cell: Cell, node_name: str, request: float,
                        memory: int) -> tuple[bool, float, int]:
    """(fits, available, free_memory) for one cell tree
    (``checkCellResource``, filter.go:32-104)."""
    if request > 1.0:
        whole = 0.0
        free_mem = 0
        for cur in _node_subtree(cell, node_name):
            if cur.is_node and cur.node == node_name:
                whole += cur.available_whole_cell
                free_mem += cur.free_memory
                if whole >= request and free_mem >= memory:
                    return True, whole, free_mem
        return False, whole, free_mem
    for cur in _node_subtree(cell, node_name):
        if cur.level == LOWEST_LEVEL and cur.node == node_name:
            # Check the memory that will actually be booked: an unset
            # tpu_mem defaults to request x full HBM at reserve time
            # (pod.go:419-424, select_cells), so checking 0 here would
            # pass a leaf that reserve then rejects — aborting the cycle
            # even though another candidate node fits.
            needed = memory or int(math.floor(request * cur.full_memory))
            if cur.available >= request and cur.free_memory >= needed:
                return True, cur.available, cur.free_memory
    return False, 0.0, 0


def filter_node(free_list: FreeList, node_name: str, model: str,
                request: float, memory: int) -> tuple[bool, float, int]:
    """Search every tree of *model*'s free list (``filterNode``,
    filter.go:5-29). Returns on the first fitting tree."""
    ok = False
    available = 0.0
    free_mem = 0
    for cells in free_list.get(model, {}).values():
        for cell in cells:
            fit, cur_avail, cur_mem = check_cell_resource(
                cell, node_name, request, memory)
            ok = ok or fit
            available += cur_avail
            free_mem += cur_mem
            if ok:
                return ok, available, free_mem
    return ok, available, free_mem


def node_leaf_cells(free_list: FreeList, node_name: str,
                    model: str = "") -> list[Cell]:
    """Healthy leaf cells of *node_name* (all models, or one)
    (``getAllLeafCellbyNode``/``getModelLeafCellbyNode``,
    score.go:231-294)."""
    models = [model] if model else list(free_list)
    leaves: list[Cell] = []
    for m in models:
        for cells in free_list.get(m, {}).values():
            for cell in cells:
                leaves.extend(c for c in _node_subtree(cell, node_name)
                              if c.level == LOWEST_LEVEL
                              and c.node == node_name)
    return leaves
