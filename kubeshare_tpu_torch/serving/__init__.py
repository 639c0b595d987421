"""Serving plane of the port: continuous-batching inference over a
fractional device (counterpart of ``kubeshare_tpu/serving``).

- :mod:`.frontdoor` — per-tenant queues, token-bucket and fair-share
  admission (typed :class:`Overloaded`, HTTP 429), class-aware dequeue,
  park/resume of tenant sessions;
- :mod:`.batcher` — coalesces compatible requests into one shared execute
  per batch, bounded by ``max_batch`` and ``max_wait_s``;
  :class:`ProxyServable` runs each batch as one execute on a proxy
  session;
- :mod:`.accounting` — tokens, bytes and executions per (tenant, class)
  with exemplar-carrying latency histograms;
- :mod:`.simulate` — deterministic virtual-time replay.
"""

from .accounting import ServingAccounting
from .batcher import ContinuousBatcher, LocalServable, ProxyServable
from .frontdoor import (FrontDoor, Overloaded, ServeRequest, SessionParked,
                        TokenBucket)
from .simulate import simulate_serving

__all__ = [
    "ServingAccounting", "ContinuousBatcher", "LocalServable",
    "ProxyServable", "FrontDoor", "Overloaded", "ServeRequest",
    "SessionParked", "TokenBucket", "simulate_serving",
]
