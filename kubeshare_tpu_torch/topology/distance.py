"""Locality distance metrics.

The port's copy of ``kubeshare_tpu/topology/distance.py``.

The reference scores locality by an edit-ish distance over hierarchical cell
ID strings (``pkg/scheduler/score.go:164-227``): IDs are ``/``-separated,
compared right-aligned; numeric segments contribute ``|a-b|``, non-numeric
mismatches (node names) contribute 100, and unmatched leading segments
contribute their numeric value (or 100).

On TPU the physical truth is the ICI mesh, so :func:`ici_distance` —
Manhattan distance over chip coordinates with optional torus wraparound — is
the primary metric; :func:`cell_id_distance` is kept for cells without
coordinates (parity + heterogeneous clusters), with identical semantics to
the reference.
"""

from __future__ import annotations

DCN_PENALTY = 100.0  # ≙ the reference's node-mismatch +100 (score.go:180-182)


def _segment_value(seg: str) -> float | None:
    try:
        return float(int(seg))
    except ValueError:
        return None


def cell_id_distance(current_id: str | list[str], other_id: str) -> float:
    """Distance between two hierarchical cell IDs (score.go:164-227)."""
    cur = current_id.split("/") if isinstance(current_id, str) else list(current_id)
    other = other_id.split("/")

    distance = 0.0
    i, j = len(other) - 1, len(cur) - 1
    while i >= 0 and j >= 0:
        a, b = _segment_value(cur[j]), _segment_value(other[i])
        if a is None or b is None:
            if cur[j] != other[i]:
                distance += DCN_PENALTY
        else:
            distance += abs(a - b)
        i -= 1
        j -= 1
    # unmatched leading segments of the longer ID
    for seg in (cur[:j + 1] if j >= 0 else other[:i + 1]):
        v = _segment_value(seg)
        distance += DCN_PENALTY if v is None else v
    return distance


def ici_distance(a: tuple[int, ...], b: tuple[int, ...],
                 mesh_shape: tuple[int, ...] | None = None) -> float:
    """Manhattan distance over ICI mesh coordinates.

    With ``mesh_shape`` given, each axis is treated as a torus (TPU v4/v5p
    slices have wraparound links): per-axis distance is
    ``min(|d|, size - |d|)``. Coordinate tuples of unequal rank are compared
    over their common suffix with a DCN penalty per extra axis.
    """
    if len(a) != len(b):
        common = min(len(a), len(b))
        # Torus wraparound still applies to the common trailing axes.
        # mesh_shape is head-aligned with the longer tuple (same convention
        # as the equal-rank loop below: axis i has size mesh_shape[i],
        # unbounded past the end), so the suffix axes start at `offset`.
        offset = max(len(a), len(b)) - common
        suffix_shape = None
        if mesh_shape is not None:
            suffix_shape = tuple(
                mesh_shape[offset + j] if offset + j < len(mesh_shape) else 0
                for j in range(common))
        return DCN_PENALTY * abs(len(a) - len(b)) + ici_distance(
            a[-common:], b[-common:], suffix_shape)
    total = 0.0
    for axis, (x, y) in enumerate(zip(a, b)):
        d = abs(x - y)
        if mesh_shape is not None and axis < len(mesh_shape) and mesh_shape[axis] > 0:
            d = min(d, mesh_shape[axis] - d)
        total += d
    return total
