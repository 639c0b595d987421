"""Preemption plane of the port (counterpart of ``kubeshare_tpu/preempt``):

- :mod:`.policy` — the :class:`PreemptionPolicy` the
  :class:`~kubeshare_tpu_torch.isolation.tokensched.TokenScheduler`
  consults under its own lock: a latency-class request waiting behind a
  best-effort holder past ``grace_ms`` marks the holder preempted and is
  granted next regardless of FIFO order; the preempted holder's
  anti-starvation credit re-grants it right after the beneficiary;
- :mod:`.slicer` — program-boundary slicing for the chip proxy: a hold
  marked preempted yields the token *between* executes, never in the
  middle of one.

Gang-atomic preemption goes through the
:class:`~kubeshare_tpu_torch.gang.coordinator.GangTokenCoordinator`, which
consults the same policy.
"""

from .policy import CLASS_PRIORITY, PreemptionPolicy
from .slicer import BoundarySlicer

__all__ = ["CLASS_PRIORITY", "PreemptionPolicy", "BoundarySlicer"]
