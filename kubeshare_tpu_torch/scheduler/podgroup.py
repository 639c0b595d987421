"""Pod groups — the coscheduling unit.

The port's copy of ``kubeshare_tpu/scheduler/podgroup.py``.

Re-design of ``pkg/scheduler/pod_group.go``: a group is named by a pod
label, carries one priority and one ``min_available`` (= headcount ×
threshold, rounded half-up), and is created lazily on first sight. Expired
groups are garbage-collected after a grace period rather than immediately,
so a crash-looping member can rejoin its group's identity.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from .labels import PodRequest


@dataclass
class PodGroup:
    key: str                  # "<namespace>/<group name>"; "" for regular
    name: str
    priority: int
    timestamp: float          # first-seen time (queue-sort tiebreak)
    min_available: int
    headcount: int
    threshold: float
    deletion_ts: float | None = None
    #: cross-host shape-aware placement (gangplan.plan_gang): one
    #: (node, chip_ids) slot per member, None until planned / after
    #: invalidation. plan_taken maps pod key -> consumed slot index;
    #: plan_stale_gen memoizes a failed planning attempt against the
    #: engine's allocation generation (re-plan only after capacity moves).
    plan: list | None = None
    plan_taken: dict = field(default_factory=dict)
    plan_stale_gen: int = -1
    plan_model: str = ""          # chip model the plan was computed over
    plan_checked_gen: int = -1    # intactness scan memo (engine.alloc_gen)


class PodGroupRegistry:
    """get-or-create + GC over :class:`PodGroup` (pod_group.go:40-129)."""

    def __init__(self, expiration_s: float = 600.0, clock=time.monotonic):
        self._groups: dict[str, PodGroup] = {}
        self._expiration_s = expiration_s
        self._clock = clock

    def get_or_create(self, pod: PodRequest,
                      ts: float | None = None) -> PodGroup:
        key = pod.group_key if pod.min_available > 0 else ""
        if key:
            group = self._groups.get(key)
            if group is not None:
                group.deletion_ts = None  # re-activated
                return group
        if ts is None:
            # A groupless pod gets a throwaway group per call, so its
            # timestamp must be the pod's stable first-seen time — a fresh
            # clock() here would make queue_less non-antisymmetric (both
            # orders "earlier").
            ts = pod.timestamp or self._clock()
        group = PodGroup(key=key, name=pod.group_name, priority=pod.priority,
                         timestamp=ts,
                         min_available=pod.min_available,
                         headcount=pod.headcount, threshold=pod.threshold)
        if key:
            self._groups[key] = group
        return group

    def mark_expired(self, key: str) -> None:
        group = self._groups.get(key)
        if group is not None and group.deletion_ts is None:
            group.deletion_ts = self._clock()

    def gc(self) -> list[str]:
        """Drop groups expired longer than the grace period; returns the
        dropped keys."""
        now = self._clock()
        dead = [k for k, g in self._groups.items()
                if g.deletion_ts is not None
                and g.deletion_ts + self._expiration_s < now]
        for k in dead:
            del self._groups[k]
        return dead

    def __len__(self) -> int:
        return len(self._groups)


def queue_less(pod_a: PodRequest, group_a: PodGroup,
               pod_b: PodRequest, group_b: PodGroup) -> bool:
    """Queue-sort predicate (``Less``, scheduler.go:247-267): higher group
    priority first, then earlier group timestamp, then smaller key."""
    if group_a.priority != group_b.priority:
        return group_a.priority > group_b.priority
    if group_a.timestamp != group_b.timestamp:
        return group_a.timestamp < group_b.timestamp
    return (group_a.key or pod_a.key) < (group_b.key or pod_b.key)
