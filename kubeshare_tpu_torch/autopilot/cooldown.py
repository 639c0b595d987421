"""One shared per-pod actuation cooldown rail (doc/autopilot.md).

The port's copy of ``kubeshare_tpu/autopilot/cooldown.py``.

Three controllers can act on the same bound pod: the autopilot moves
it, the rightsizer changes its share, and the elastic plane resizes its
gang's sub-mesh. Before this module each controller consulted the
cooldown map of whichever :class:`~.planner.Planner` it happened to
hold — two controllers built with *separate* default planners held
separate maps, so a pod the rightsizer just resized could be migrated
in the same breath (and vice versa), exactly the churn the cooldown
exists to prevent.

:class:`CooldownLedger` is that map, extracted: one instance is shared
by the planner, the rightsizer, and the elastic orchestrator, so a
move, a share-change, and a sub-mesh resize on one pod all observe one
rail. The planner's ``note_moved``/``cooling`` methods delegate here —
every existing call site keeps working — and controllers that build
their own planner now inject the ledger instead of forking the state.
"""

from __future__ import annotations

import time

__all__ = ["CooldownLedger"]


class CooldownLedger:
    """Per-key "last actuated" timestamps with one cooldown window.

    Keys are pod keys (``ns/name``). Thread-light by design: entries
    are single float slots written under the acting controller's own
    serialization (the dispatcher lock for every current caller), and
    a stale read merely skips one candidate for one cycle — the same
    tolerance the planner's private dict always had.
    """

    def __init__(self, cooldown_s: float = 120.0, clock=time.monotonic):
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._last: dict[str, float] = {}

    def note(self, key: str, now: float | None = None) -> None:
        """Record that *key* was just actuated (moved/resized)."""
        self._last[key] = self._clock() if now is None else now

    def cooling(self, key: str, now: float | None = None) -> bool:
        """True while *key* is inside the cooldown window."""
        since = self._last.get(key)
        if since is None:
            return False
        now = self._clock() if now is None else now
        return (now - since) < self.cooldown_s

    def remaining(self, key: str, now: float | None = None) -> float:
        """Seconds of cooldown left for *key* (0.0 when cold)."""
        since = self._last.get(key)
        if since is None:
            return 0.0
        now = self._clock() if now is None else now
        return max(0.0, self.cooldown_s - (now - since))

    def forget(self, key: str) -> None:
        self._last.pop(key, None)

    def snapshot(self, now: float | None = None) -> dict:
        """Keys still cooling and their remaining seconds (for
        ``/elastic`` and the autopilot snapshot)."""
        now = self._clock() if now is None else now
        cooling = {k: round(self.cooldown_s - (now - t), 3)
                   for k, t in self._last.items()
                   if (now - t) < self.cooldown_s}
        return {"cooldown_s": self.cooldown_s, "cooling": cooling}
