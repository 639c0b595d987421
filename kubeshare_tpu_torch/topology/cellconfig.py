"""Cluster topology configuration (``cellTypes`` / ``cells``) — the
port's copy of ``kubeshare_tpu/topology/cellconfig.py``.

Schema parity with ``pkg/scheduler/config.go:15-35`` and the example files
under ``deploy/config/*.yaml``: ``cellTypes`` defines the type hierarchy
(child type/count/priority, node level) and ``cells`` instantiates physical
trees. IDs left empty are inferred breadth-first exactly as the reference
does (``config.go:77-120``): the i-th unnamed cell in a BFS level gets
``<parentID>/<i>`` (1-based across the level), and an unnamed root gets its
1-based position in the ``cells`` list.

:func:`config_from_chips` derives the whole file from discovery — chip <
host < slice — so the hand-written file becomes an optional override
rather than a deployment requirement (the reference's TODO at
``config.go:18``). A GPU node from CUDA discovery has no slice id, so
each host is a cell of its own.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

from .chip import ChipInfo


class ConfigError(ValueError):
    pass


@dataclass
class CellTypeSpec:
    child_cell_type: str
    child_cell_number: int
    child_cell_priority: int = 0
    is_node_level: bool = False


@dataclass
class CellSpec:
    cell_type: str
    cell_id: str = ""
    children: list["CellSpec"] = field(default_factory=list)


@dataclass
class TopologyConfig:
    cell_types: dict[str, CellTypeSpec]
    cells: list[CellSpec]


def _parse_cell_spec(raw: dict) -> CellSpec:
    return CellSpec(
        cell_type=raw.get("cellType", ""),
        cell_id=str(raw.get("cellId", "") or ""),
        children=[_parse_cell_spec(c) for c in raw.get("cellChildren", []) or []],
    )


def parse_config(raw: dict) -> TopologyConfig:
    cell_types = {
        name: CellTypeSpec(
            child_cell_type=spec.get("childCellType", ""),
            child_cell_number=int(spec.get("childCellNumber", 0)),
            child_cell_priority=int(spec.get("childCellPriority", 0)),
            is_node_level=bool(spec.get("isNodeLevel", False)),
        )
        for name, spec in (raw.get("cellTypes") or {}).items()
    }
    cells = [_parse_cell_spec(c) for c in raw.get("cells") or []]
    cfg = TopologyConfig(cell_types=cell_types, cells=cells)
    check_physical_cells(cfg)
    return cfg


def load_config(path: str) -> TopologyConfig:
    """Load + validate, parity with ``initRawConfig`` (config.go:37-57).
    PyYAML is imported here only: the placement path derives its topology
    from discovery (:func:`config_from_chips`) and runs without it."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    return parse_config(raw)


def check_physical_cells(cfg: TopologyConfig) -> None:
    """Validation + BFS ID inference (``checkPhysicalCells``, config.go:59-74)."""
    for idx, cell in enumerate(cfg.cells):
        cts = cfg.cell_types.get(cell.cell_type)
        if cts is None:
            raise ConfigError(f"cells contains unknown cellType: {cell.cell_type}")
        if not 0 <= cts.child_cell_priority <= 100:
            raise ConfigError(
                f"cell priority must be in 0~100, got {cts.child_cell_priority} "
                f"for {cell.cell_type}")
        infer_cell_spec(cell, cfg.cell_types, default_id=idx + 1)


def infer_cell_spec(spec: CellSpec, cell_types: dict[str, CellTypeSpec], default_id: int) -> None:
    """Fill missing IDs/children/types breadth-first (config.go:77-120).

    Numbering is per BFS *level*, not per parent — with two parents of two
    children each the level yields ``p1/1, p1/2, p2/3, p2/4`` — observable
    behavior preserved from the reference.
    """
    parent_ids: deque[str] = deque()
    q: deque[CellSpec] = deque([spec])
    first = True

    while q:
        n = len(q)
        for i in range(1, n + 1):
            current = q.popleft()
            if first:
                if not current.cell_id:
                    current.cell_id = str(default_id)
                first = False
            else:
                previous_id = parent_ids.popleft()
                if not current.cell_id:
                    current.cell_id = f"{previous_id}/{i}"
                else:
                    current.cell_id = f"{previous_id}/{current.cell_id}"

            ct = cell_types.get(current.cell_type)
            if ct is None:
                continue  # leaf type
            if ct.child_cell_number > 0 and not current.children:
                current.children = [CellSpec(cell_type="") for _ in range(ct.child_cell_number)]
            for child in current.children:
                if not child.cell_type:
                    child.cell_type = ct.child_cell_type
                parent_ids.append(current.cell_id)
                q.append(child)


def config_from_chips(chips: list[ChipInfo], slice_name: str = "slice",
                      chip_priority: dict[str, int] | None = None) -> TopologyConfig:
    """Derive the config from discovered chips: chip < host < slice.

    Hosts with the same chip model and count share a ``<n>-<model>-HOST``
    node-level type; when several hosts of one model exist they are grouped
    under a multi-node slice cell (ICI spans hosts inside a TPU slice, so
    the slice — not the host — is the natural top cell). Per-model priority
    defaults to 1 + insertion order by descending HBM, overridable via
    ``chip_priority``.
    """
    if not chips:
        return TopologyConfig(cell_types={}, cells=[])

    by_host: dict[str, list[ChipInfo]] = {}
    for c in chips:
        by_host.setdefault(c.host, []).append(c)

    models: dict[str, int] = {}
    for c in chips:
        models.setdefault(c.model, c.memory)
    ordered = sorted(models, key=lambda m: -models[m])
    priority = {m: (chip_priority or {}).get(m, max(1, 100 - 10 * i))
                for i, m in enumerate(ordered)}

    cell_types: dict[str, CellTypeSpec] = {}
    # Group hosts by (model, chips-per-host, slice identity): hosts are fused
    # into one multi-host cell only when discovery says they share an ICI
    # slice — two independent v5e-16 slices stay two cells.
    hosts_by_shape: dict[tuple[str, int, str], list[str]] = {}
    for host, host_chips in sorted(by_host.items()):
        model = host_chips[0].model
        slice_id = host_chips[0].slice_id
        hosts_by_shape.setdefault((model, len(host_chips), slice_id), []).append(host)

    cells: list[CellSpec] = []
    for (model, n, slice_id), hosts in sorted(hosts_by_shape.items()):
        node_type = f"{n}-{model}-HOST"
        cell_types.setdefault(node_type, CellTypeSpec(
            child_cell_type=model, child_cell_number=n,
            child_cell_priority=priority[model], is_node_level=True))
        if len(hosts) > 1:
            tag = f"-{slice_id}" if slice_id else ""
            slice_type = f"{len(hosts)}x{n}-{model}-{slice_name.upper()}{tag}"
            cell_types[slice_type] = CellTypeSpec(
                child_cell_type=node_type, child_cell_number=len(hosts),
                child_cell_priority=priority[model], is_node_level=False)
            cells.append(CellSpec(
                cell_type=slice_type,
                children=[CellSpec(cell_type=node_type, cell_id=h) for h in hosts]))
        else:
            cells.append(CellSpec(cell_type=node_type, cell_id=hosts[0]))

    cfg = TopologyConfig(cell_types=cell_types, cells=cells)
    check_physical_cells(cfg)
    return cfg
