"""Telemetry plane of the port — the counterpart of
``kubeshare_tpu/telemetry/``: the registry bus that capacity, leases and
requirement records go through, the per-node collector and heartbeat, and
the aggregator's bridge from the scheduler engine to the registry. See
:mod:`.registry` (whose CLI also runs a replication follower of another
registry, ``--follower-of``), :mod:`.collector`, :mod:`.heartbeat`,
:mod:`.aggregator` and :mod:`.remote_write`, the push of a process's
exposition into the registry's fleet store, which the scheduler, the
launcher and the proxy run.
"""

from .aggregator import (publish_binding, requirement_record,
                         sync_engine_from_registry, withdraw)
from .collector import CapacityCollector
from .heartbeat import Heartbeater
from .registry import (LEADER_PREFIX, FencedWriteError, NotLeaderError,
                       RegistryClient, TelemetryRegistry)
from .remote_write import RemoteWriter, default_instance

__all__ = [
    "CapacityCollector", "FencedWriteError", "Heartbeater",
    "LEADER_PREFIX", "NotLeaderError", "RegistryClient",
    "RemoteWriter", "TelemetryRegistry", "default_instance",
    "publish_binding", "requirement_record",
    "sync_engine_from_registry", "withdraw",
]
