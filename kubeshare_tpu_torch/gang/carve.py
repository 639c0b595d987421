"""The carved form of ``TPU_VISIBLE_CHIPS`` — the part of
``kubeshare_tpu/gang/carve.py`` a :class:`~..scheduler.engine.Binding`
renders.

Each comma-separated entry is either the plain ``chip_id`` or the carved
``chip_id@x.y``, the ``@``-suffix being the device's mesh coordinate
normalised to the node's mesh origin. Only a node whose devices carry
mesh coordinates gets the carved form; a GPU node from CUDA discovery
has none, so its bindings always take the plain one. The attach strips
the suffix either way. Parsing and validating a carved block waits for
the gang runtime.
"""

from __future__ import annotations


class CarveError(ValueError):
    """The chip list cannot be rendered in the carved form."""


def format_mesh(shape) -> str:
    """``(2, 4)`` → ``"2x4"`` (the ``ENV_MESH_SHAPE`` payload)."""
    return "x".join(str(int(d)) for d in shape)


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
