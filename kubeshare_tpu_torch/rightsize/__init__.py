"""SLO-driven capacity rightsizing (doc/autopilot.md, Rightsizing).

The port's copy of ``kubeshare_tpu/rightsize/``.

Closed loop from measurement to base-share actuation: SLO burn rates
decide who grows, sustained ledger granted-idle fractions decide who
shrinks, blame edges decide which neighbour makes room, and the
trial-booked migration path packs the freed capacity into fewer chips.
"""

from .controller import RightsizeConfig, Rightsizer
from .signals import (blamed_neighbours, burn_state, default_tenant,
                      tenant_demand)
from .sim import simulate_rightsize

__all__ = [
    "RightsizeConfig",
    "Rightsizer",
    "blamed_neighbours",
    "burn_state",
    "default_tenant",
    "tenant_demand",
    "simulate_rightsize",
]
