"""Shadow-scheduler replay: record → replay → diff (doc/replay.md).

The port's copy of ``kubeshare_tpu/replay/``.

The record side lives in :mod:`..obs.decisions` (the
:class:`~..obs.decisions.DecisionRecorder` every control-plane hook
feeds); this package is the replay side — a virtual-time harness that
re-drives a recorded trace through a candidate build
(:mod:`.shadow`) and the decision-diff report that judges it
(:mod:`.diff`).
"""

from .diff import (DELAY_TOL_S, decision_diff, phase_totals, render_diff,
                   trigger_on_diff)
from .shadow import (DRAIN_BOUND_S, TICK_S, VirtualClock, build_cluster,
                     drive, record_trace, replay_trace)

__all__ = [
    "DELAY_TOL_S", "DRAIN_BOUND_S", "TICK_S", "VirtualClock",
    "build_cluster", "decision_diff", "drive", "phase_totals",
    "record_trace", "render_diff", "replay_trace", "trigger_on_diff",
]
