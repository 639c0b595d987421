"""Chaos plane of the port — only its oracle so far: :mod:`.invariants`,
the cluster-invariant checks behind the scheduler service's
``GET /invariants`` and the dispatcher's ``invariant_snapshot``. The
JAX package's orchestrator and scenarios are not ported yet.
"""

from .invariants import check_cluster, violation

__all__ = ["check_cluster", "violation"]
