"""Sub-mesh carving: the scheduler's ``select_submesh`` block rendered
into the ``TPU_VISIBLE_CHIPS`` env contract and parsed back.

Counterpart of ``kubeshare_tpu/gang/carve.py``. Each comma-separated
entry is either the plain ``chip_id`` or the carved ``chip_id@x.y``, the
``@``-suffix being the device's mesh coordinate, dot-joined, normalised
to the node's mesh origin. Consumers that predate carving (the attach's
local-index parse) strip the suffix; carve-aware consumers
(:func:`~kubeshare_tpu_torch.parallel.mesh.make_carved_mesh`) recover the
planned block and lay the gang's mesh onto it. Only a node whose devices
carry mesh coordinates gets the carved form; a GPU node from CUDA
discovery has none, so its bindings always take the plain one.

Because ``select_block`` places blocks on a *torus*, a carve may wrap an
axis (coords ``{0, 3}`` on a 4-wide ring are adjacent). Validating that a
carve is the contiguous block the scheduler planned therefore needs the
node mesh shape, carried separately in ``KUBESHARE_TPU_MESH``
(``constants.ENV_MESH_SHAPE``, e.g. ``"2x4"``).
"""

from __future__ import annotations

from math import prod

__all__ = [
    "CarveError", "carve_env", "parse_visible_chips", "strip_carve",
    "carve_block", "block_coords", "format_mesh", "parse_mesh",
]


class CarveError(ValueError):
    """The carve string is malformed or not a contiguous sub-mesh block."""


def format_mesh(shape) -> str:
    """``(2, 4)`` → ``"2x4"`` (the ``ENV_MESH_SHAPE`` payload)."""
    return "x".join(str(int(d)) for d in shape)


def parse_mesh(text: str) -> tuple[int, ...]:
    """``"2x4"`` → ``(2, 4)``; raises :class:`CarveError` otherwise."""
    try:
        shape = tuple(int(d) for d in text.strip().split("x"))
    except ValueError:
        raise CarveError(f"bad mesh shape {text!r}") from None
    if not shape or any(d <= 0 for d in shape):
        raise CarveError(f"bad mesh shape {text!r}")
    return shape


def carve_env(chip_ids, coords_list) -> str:
    """Render chip ids and their mesh coords into the
    ``TPU_VISIBLE_CHIPS`` value. ``coords_list`` entries may be empty
    (devices without coords fall back to the plain form)."""
    if len(chip_ids) != len(coords_list):
        raise CarveError("chip_ids and coords_list length mismatch")
    parts = []
    for chip, coords in zip(chip_ids, coords_list):
        if "," in chip or "@" in chip:
            raise CarveError(f"chip id {chip!r} not carvable")
        if coords:
            parts.append(chip + "@" + ".".join(str(int(c)) for c in coords))
        else:
            parts.append(chip)
    return ",".join(parts)


def parse_visible_chips(env: str) -> list[tuple[str, tuple[int, ...] | None]]:
    """Parse a ``TPU_VISIBLE_CHIPS`` value into ``[(chip_id,
    coords|None)]``; plain entries parse with ``coords=None``."""
    out: list[tuple[str, tuple[int, ...] | None]] = []
    for entry in env.split(","):
        entry = entry.strip()
        if not entry:
            continue
        chip, sep, suffix = entry.partition("@")
        if not chip:
            raise CarveError(f"bad carve entry {entry!r}")
        if not sep:
            out.append((chip, None))
            continue
        try:
            coords = tuple(int(c) for c in suffix.split("."))
        except ValueError:
            raise CarveError(f"bad carve entry {entry!r}") from None
        out.append((chip, coords))
    return out


def strip_carve(env: str) -> str:
    """Drop every ``@x.y`` suffix: the plain chip list (what carve-unaware
    consumers see)."""
    return ",".join(e.partition("@")[0] for e in env.split(",") if e)


def _axis_interval(vals: list[int], extent_limit: int | None
                   ) -> tuple[int, int]:
    """``(origin, extent)`` of sorted unique ``vals`` as one interval of
    an axis, cyclic when ``extent_limit`` (the torus axis size) is
    given."""
    k = len(vals)
    if extent_limit is None:
        if vals[-1] - vals[0] + 1 != k:
            raise CarveError(f"axis values {vals} not contiguous")
        return vals[0], k
    if vals[0] < 0 or vals[-1] >= extent_limit:
        raise CarveError(f"axis values {vals} outside mesh axis "
                         f"of size {extent_limit}")
    if k == extent_limit:
        return 0, k
    if vals[-1] - vals[0] + 1 == k:          # plain interval, no wrap
        return vals[0], k
    # a wrapped interval iff the complement is one contiguous run
    present = set(vals)
    gaps = [v for v in range(extent_limit) if v not in present]
    if gaps[-1] - gaps[0] + 1 != len(gaps):
        raise CarveError(f"axis values {vals} not a cyclic interval "
                         f"on axis of size {extent_limit}")
    return (gaps[-1] + 1) % extent_limit, k


def carve_block(entries, mesh: tuple[int, ...] | None = None
                ) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Validate that carved ``entries`` (:func:`parse_visible_chips`
    output, or ``(chip, coords)`` pairs) form exactly one axis-aligned
    block and return ``(origin, shape)``. With ``mesh`` the block may
    wrap the torus; without it only plain intervals validate. Raises
    :class:`CarveError` on anything else, notably the greedy-compact
    fallback's scattered picks."""
    coords = []
    for chip, c in entries:
        if c is None:
            raise CarveError(f"chip {chip!r} carries no carve coords")
        coords.append(tuple(c))
    if not coords:
        raise CarveError("empty carve")
    ndim = len(coords[0])
    if any(len(c) != ndim for c in coords):
        raise CarveError("mixed coord dimensionality")
    if mesh is not None and len(mesh) != ndim:
        raise CarveError(f"mesh rank {len(mesh)} != coord rank {ndim}")
    if len(set(coords)) != len(coords):
        raise CarveError("duplicate coords in carve")
    origin, shape = [], []
    for axis in range(ndim):
        vals = sorted({c[axis] for c in coords})
        o, e = _axis_interval(vals, mesh[axis] if mesh else None)
        origin.append(o)
        shape.append(e)
    # per-axis intervals + distinct coords + count == volume: the coord
    # set IS the block (every coord lies inside it and it has no holes)
    if len(coords) != prod(shape):
        raise CarveError(f"{len(coords)} chips do not fill a "
                         f"{'x'.join(map(str, shape))} block")
    return tuple(origin), tuple(shape)


def block_coords(origin: tuple[int, ...], shape: tuple[int, ...],
                 mesh: tuple[int, ...] | None = None
                 ) -> list[tuple[int, ...]]:
    """The block's coords in row-major order (torus wrap when ``mesh`` is
    given): the order ``make_carved_mesh`` lays ranks in."""
    coords = [()]
    for axis, extent in enumerate(shape):
        nxt = []
        for prefix in coords:
            for step in range(extent):
                v = origin[axis] + step
                if mesh is not None:
                    v %= mesh[axis]
                nxt.append(prefix + (v,))
        coords = nxt
    return coords
