"""Simulation tooling: trace-driven scheduler replay (test/simulator
parity, virtualized).

The port's copy of ``kubeshare_tpu/sim/``.
"""

from .simulator import SimStats, Simulator, TraceJob, parse_trace

__all__ = ["SimStats", "Simulator", "TraceJob", "parse_trace"]
