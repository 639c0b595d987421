"""Control-plane HA (doc/ha.md): replicated registry, epoch-fenced
leadership, warm-standby scheduler takeover.

The port's copy of ``kubeshare_tpu/ha/``.

Three legs, each usable alone:

- :class:`ReplicationFollower` — a follower registry tailing the
  leader's op-stream with a durable cursor; reads carry staleness
  marks, writes are refused with a 307 leader hint.
- :class:`LeadershipManager` — a lease in the registry's own leases
  table (``leader:<domain>``, monotonic epoch + TTL) with the zombie
  refusal discipline heartbeats already use.
- :class:`WarmStandby` — a standby scheduler that keeps its engine
  warm, takes the lease over on expiry, and publishes epoch-fenced
  binds so a deposed dispatcher freezes instead of splitting brain.
"""

from .leadership import LeadershipManager
from .replication import ReplicationFollower
from .standby import WarmStandby

__all__ = ["LeadershipManager", "ReplicationFollower", "WarmStandby"]
