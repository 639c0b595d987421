"""Chaos plane: deterministic multi-fault orchestration (doc/chaos.md).

The port's copy of ``kubeshare_tpu/chaos/``.

Jepsen-style nemesis over the seeded fault injectors: scenario
schedules (:mod:`.scenarios`), a cluster-invariant oracle
(:mod:`.invariants`), and the virtual-time runner + MTTR stopwatch
(:mod:`.orchestrator`).  Entry point: ``sim --chaos``.
"""

from .invariants import check_cluster, violation
from .orchestrator import (ChaosRunner, run_matrix, run_scenario,
                           run_suite)
from .scenarios import BUILDERS, ChaosAction, Scenario, all_scenarios, build

__all__ = [
    "BUILDERS", "ChaosAction", "ChaosRunner", "Scenario",
    "all_scenarios", "build", "check_cluster", "run_matrix",
    "run_scenario", "run_suite", "violation",
]
