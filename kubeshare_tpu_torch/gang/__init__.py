"""Gang plane of the port (counterpart of ``kubeshare_tpu/gang/``):

- :mod:`.coordinator` — :class:`~.coordinator.GangTokenCoordinator`,
  two-phase reserve/commit token grants spanning every member device;
- :mod:`.carve` — the ``chip@x.y`` form of a binding's device list
  (``carve_env`` and ``format_mesh`` only).
"""

from .carve import CarveError, carve_env, format_mesh
from .coordinator import GangTokenCoordinator

__all__ = ["CarveError", "GangTokenCoordinator", "carve_env",
           "format_mesh"]
