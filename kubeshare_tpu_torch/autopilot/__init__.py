"""Autopilot plane of the port: fragmentation-aware rebalancing and
elastic quota reclamation.

The port's copy of ``kubeshare_tpu/autopilot/``. It reads capacity
through the scheduler engine, executes through the dispatcher's
apply_move, lends idle shares through the isolation plane's token
scheduler, and reports through the obs plane. It imports no torch:
the scheduler service, doctor and topcli load it as control plane.
"""

from .controller import Autopilot
from .cooldown import CooldownLedger
from .elastic import ElasticQuota
from .planner import Planner, fragmentation_score, fragmentation_view
from .rebalancer import Rebalancer

__all__ = ["Autopilot", "CooldownLedger", "ElasticQuota", "Planner",
           "Rebalancer", "fragmentation_score", "fragmentation_view"]
