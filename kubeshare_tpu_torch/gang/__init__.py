"""Gang plane of the port (counterpart of ``kubeshare_tpu/gang/``):

- :mod:`.coordinator` — :class:`~.coordinator.GangTokenCoordinator`,
  two-phase reserve/commit token grants spanning every member device,
  and the elastic plane's uniform effective shares;
- :mod:`.carve` — the ``TPU_VISIBLE_CHIPS`` carve format (``chip@x.y``)
  and block validation against the planned sub-mesh.
"""

from .carve import (CarveError, block_coords, carve_block, carve_env,
                    format_mesh, parse_mesh, parse_visible_chips, strip_carve)
from .coordinator import GangTokenCoordinator

__all__ = [
    "CarveError", "GangTokenCoordinator", "block_coords", "carve_block",
    "carve_env", "format_mesh", "parse_mesh", "parse_visible_chips",
    "strip_carve",
]
