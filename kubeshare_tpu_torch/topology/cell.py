"""The hierarchical *cell* resource model.

The port's copy of ``kubeshare_tpu/topology/cell.py``.

A cell is a unit of TPU topology: a chip (leaf, level 1), a host, a slice,
or a multi-host super-cell. The scheduler books fractional compute
(``available``) and HBM (``free_memory``) on leaves and propagates both up
the tree so multi-chip gang placement can reason at any level.

Semantics parity with the reference:

- type preprocessing ``buildCellChains``/``addCell`` — ``pkg/scheduler/
  cell.go:46-129`` (level, priority, leaf counts, node/multi-node flags,
  per-model priority table);
- tree construction — ``cell.go:214-286`` (free list keyed by leaf type ×
  level; node cells stamp their node name on single-node subtrees);
- reserve/reclaim walks leaf→root — ``pkg/scheduler/pod.go:479-526``;
- chip binding + health propagation — ``pkg/scheduler/node.go:109-285``
  (first sighting of a node binds chip ids + HBM to its leaf cells in
  discovery order and flips ``state`` to FILLED; later events only flip
  health; unhealthy cells stay booked but are excluded from enumeration).

TPU addition: leaf cells carry ICI ``coords`` so scoring can use mesh
distance (``distance.ici_distance``) instead of ID string distance.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from ..utils.logger import get_logger
from .cellconfig import CellSpec, CellTypeSpec, ConfigError
from .chip import ChipInfo

LOWEST_LEVEL = 1

CELL_FREE = "FREE"
CELL_FILLED = "FILLED"


@dataclass
class CellElement:
    """Preprocessed per-type info (cell.go:34-44)."""

    cell_type: str
    level: int
    priority: int
    child_cell_type: str
    child_cell_number: float
    leaf_cell_type: str
    leaf_cell_number: float
    is_node: bool
    is_multi_nodes: bool


def build_cell_chains(cell_types: dict[str, CellTypeSpec]) -> tuple[dict[str, CellElement], dict[str, int]]:
    """cellTypes → per-type elements + per-model priority table
    (``buildCellChains``/``addCell``/``sortGPUPriority``, cell.go:46-129).
    Returns ``(elements, chip_priority)``.
    """
    elements: dict[str, CellElement] = {}
    chip_priority: dict[str, int] = {}

    def add(cell_type: str, priority: int) -> None:
        if cell_type in elements:
            return
        cts = cell_types.get(cell_type)
        if cts is None:  # leaf (chip model) — not itself in cellTypes
            elements[cell_type] = CellElement(
                cell_type=cell_type, level=LOWEST_LEVEL, priority=priority,
                child_cell_type="", child_cell_number=0.0,
                leaf_cell_type=cell_type, leaf_cell_number=1.0,
                is_node=False, is_multi_nodes=False)
            chip_priority[cell_type] = priority
            return
        add(cts.child_cell_type, cts.child_cell_priority)
        child = elements[cts.child_cell_type]
        elements[cell_type] = CellElement(
            cell_type=cell_type, level=child.level + 1, priority=child.priority,
            child_cell_type=child.cell_type,
            child_cell_number=float(cts.child_cell_number),
            leaf_cell_type=child.leaf_cell_type,
            leaf_cell_number=child.leaf_cell_number * cts.child_cell_number,
            is_node=cts.is_node_level,
            is_multi_nodes=child.is_node or child.is_multi_nodes)

    for cell_type in cell_types:
        add(cell_type, 1)
    return elements, chip_priority


@dataclass
class Cell:
    """One physical cell instance (cell.go:131-183)."""

    cell_type: str
    id: str
    level: int
    higher_than_node: bool
    is_node: bool
    priority: int
    leaf_cell_type: str
    leaf_cell_number: float

    chip_id: str = ""              # ≙ uuid; bound at first node sighting
    coords: tuple[int, ...] = ()   # ICI coords for leaf cells (TPU addition)
    available: float = 0.0
    available_whole_cell: float = 0.0
    free_memory: int = 0
    full_memory: int = 0
    node: str = ""
    healthy: bool = False
    state: str = CELL_FREE
    parent: "Cell | None" = field(default=None, repr=False)
    children: list["Cell"] = field(default_factory=list, repr=False)

    def __post_init__(self):
        self.available = self.leaf_cell_number
        self.available_whole_cell = self.leaf_cell_number

    def walk(self):
        """Iterate the subtree (self included), depth-first."""
        stack = [self]
        while stack:
            cur = stack.pop()
            yield cur
            stack.extend(cur.children)

    def leaves(self):
        for c in self.walk():
            if c.level == LOWEST_LEVEL:
                yield c


# cellFreeList shape: leaf type → level → [root cells] (cell.go:185-229)
FreeList = dict[str, dict[int, list[Cell]]]


class CellConstructor:
    """cells spec + elements → physical trees + free list (cell.go:193-286)."""

    def __init__(self, elements: dict[str, CellElement], cells: list[CellSpec]):
        self.elements = elements
        self.cells = cells

    def build(self) -> FreeList:
        free_list: FreeList = {}
        for spec in self.cells:
            root = self._build_full_tree(spec)
            free_list.setdefault(root.leaf_cell_type, {}).setdefault(root.level, []).append(root)
        return free_list

    def _build_full_tree(self, spec: CellSpec) -> Cell:
        ce = self.elements.get(spec.cell_type)
        if ce is None:
            raise ConfigError(f"cellType {spec.cell_type} not found in cellTypes")
        if not (ce.is_node or ce.is_multi_nodes):
            raise ConfigError(f"top cell must be node-level or above: {spec.cell_type}")
        return self._build_child(spec, spec.cell_type, "")

    def _build_child(self, spec: CellSpec, cell_type: str, current_node: str) -> Cell:
        ce = self.elements[cell_type]
        if ce.is_node:
            # node-level cell: its ID's last segment is the node name
            current_node = spec.cell_id.split("/")[-1]
        cell = Cell(
            cell_type=cell_type, id=spec.cell_id, level=ce.level,
            higher_than_node=ce.is_multi_nodes, is_node=ce.is_node,
            priority=ce.priority, leaf_cell_type=ce.leaf_cell_type,
            leaf_cell_number=ce.leaf_cell_number)
        if not ce.is_multi_nodes:
            cell.node = current_node
        if ce.level == LOWEST_LEVEL:
            return cell
        for child_spec in spec.children:
            child = self._build_child(child_spec, ce.child_cell_type, current_node)
            child.parent = cell
            if not ce.is_multi_nodes:
                child.node = current_node
            cell.children.append(child)
        return cell


def _snap(value: float) -> float:
    """Cancel binary-fraction residue in compute bookings.

    Fractional requests like 0.3 have no exact float representation, so
    a reserve/reclaim cycle leaves ``available`` at 0.9999999999999998 —
    and since ``available_whole_cell`` floors it, every such cycle
    PERMANENTLY erodes whole-cell capacity (a multi-chip pod would never
    fit a chip that is actually free). Requests are validated to ≤ 2
    decimals, so snapping to 1e-9 is far below real precision."""
    rounded = round(value)
    if abs(value - rounded) < 1e-9:
        return float(rounded)
    return round(value, 9)


def reserve_resource(cell: Cell, request: float, memory: int) -> None:
    """Book ``request`` compute + ``memory`` bytes on *cell* and every
    ancestor (pod.go:479-501)."""
    cur: Cell | None = cell
    while cur is not None:
        cur.free_memory -= memory
        cur.available = _snap(cur.available - request)
        cur.available_whole_cell = math.floor(cur.available)
        cur = cur.parent


def reclaim_resource(cell: Cell, request: float, memory: int) -> None:
    """Inverse of :func:`reserve_resource` (pod.go:504-526)."""
    cur: Cell | None = cell
    while cur is not None:
        cur.free_memory += memory
        cur.available = _snap(cur.available + request)
        cur.available_whole_cell = math.floor(cur.available)
        cur = cur.parent


def set_node_status(free_list: FreeList, chips_by_node: dict[str, dict[str, list[ChipInfo]]],
                    leaf_cells: dict[str, Cell], node_name: str, healthy: bool) -> None:
    """Propagate a node's health through every tree.

    Re-design of ``setNodeStatus`` (node.go:109-124). The reference keys the
    bind-vs-health branch on the *root* cell's FREE/FILLED state, so in a
    multi-host cell only the first host ever binds its chips (its lab
    configs dodge this by naming every child the same node). Here binding
    state is tracked per node-level subtree instead: a healthy sighting of a
    still-FREE node cell binds chip ids/HBM/coords to its leaves in
    discovery order (as node.go:127-197 does), any sighting flips the
    subtree's health bits (node.go:216-254), and ancestor health is the OR
    of child health.
    """
    for levels in free_list.values():
        for cells in levels.values():
            for root in cells:
                for cell in root.walk():
                    if cell.is_node and cell.node == node_name:
                        if cell.state == CELL_FREE and healthy:
                            _bind_chips(cell, chips_by_node, leaf_cells, node_name)
                        if cell.state == CELL_FREE:
                            # Nothing bound (no chips discovered for this
                            # node): leave health untouched, matching the
                            # reference's n==0 early return in setCellStatus
                            # (node.go:127-137) — otherwise a healthy-but-
                            # chipless sighting would open phantom leaves
                            # (available=1.0, chip_id="") to the scheduler.
                            continue
                        _set_subtree_health(cell, healthy)
                        _propagate_health_up(cell)


def _bind_chips(node_cell: Cell, chips_by_node: dict[str, dict[str, list[ChipInfo]]],
                leaf_cells: dict[str, Cell], node_name: str) -> None:
    chips = chips_by_node.get(node_name, {}).get(node_cell.leaf_cell_type, [])
    if not chips:
        return
    idx = 0
    unbound = 0
    for leaf in node_cell.leaves():
        if idx >= len(chips):
            # Config promises more leaves than discovery delivered: close the
            # phantom leaves (available=1.0, chip_id="") by booking them out,
            # keeping the booked/free invariant on every ancestor.
            reserve_resource(leaf, leaf.leaf_cell_number, 0)
            unbound += 1
            continue
        chip = chips[idx]
        leaf.chip_id = chip.chip_id
        leaf.coords = chip.coords
        leaf.full_memory = chip.memory
        leaf.free_memory = chip.memory
        idx += 1
        _pass_memory_to_parent(leaf)
        leaf_cells[leaf.chip_id] = leaf
    if unbound:
        get_logger("topology").warning(
            "node %s: config has %d more %s leaves than discovery reported "
            "(%d chips); unbound leaves zeroed out",
            node_name, unbound, node_cell.leaf_cell_type, len(chips))
    elif idx < len(chips):
        get_logger("topology").warning(
            "node %s: discovery reported %d %s chips but config only has %d "
            "leaves; surplus chips unused",
            node_name, len(chips), node_cell.leaf_cell_type, idx)
    for cell in node_cell.walk():
        cell.state = CELL_FILLED
    cur = node_cell.parent
    while cur is not None:
        cur.state = CELL_FILLED
        cur = cur.parent


def _set_subtree_health(node_cell: Cell, healthy: bool) -> None:
    for cell in node_cell.walk():
        cell.healthy = healthy


def _propagate_health_up(node_cell: Cell) -> None:
    cur = node_cell.parent
    while cur is not None:
        cur.healthy = any(c.healthy for c in cur.children)
        cur = cur.parent


def _pass_memory_to_parent(leaf: Cell) -> None:
    """Add a newly-bound leaf's HBM to every ancestor (node.go:257-285)."""
    memory = leaf.full_memory
    parent = leaf.parent
    while parent is not None:
        parent.free_memory += memory
        parent.full_memory += memory
        parent = parent.parent
