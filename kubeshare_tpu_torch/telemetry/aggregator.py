"""Requirement records — the cluster workload registry.

The port's copy of ``kubeshare_tpu/telemetry/aggregator.py``.

Parity with ``kubeshare-aggregator`` (``pkg/aggregator/aggregator.go:22-39``,
``pod.go:50-154``): the reference lists Running pods and *digs the
scheduler's own injected env back out of the pod specs* to re-export
requirements as ``gpu_requirement``. Here the scheduler publishes its
:class:`~..scheduler.engine.Binding` directly — same record, no
round-trip through pod-spec archaeology, no scrape staleness.

The record set feeds two consumers, as in the reference:

- the node agent, which writes per-chip client lists for the isolation
  runtime (``pkg/config/query.go:43-105``);
- observability via the registry's ``/metrics``.
"""

from __future__ import annotations

from ..scheduler.engine import Binding
from ..scheduler.labels import PodRequest
from .registry import RegistryClient, TelemetryRegistry


def requirement_record(pod: PodRequest, binding: Binding) -> dict:
    """The ``tpu_requirement`` label set (aggregator.go:22-39 parity)."""
    return {
        "node": binding.node,
        "uid": pod.uid,
        "group_name": pod.group_name,
        "headcount": str(pod.headcount),
        "threshold": str(pod.threshold),
        "priority": str(pod.priority),
        "request": str(pod.request),
        "limit": str(pod.limit),
        "memory": str(binding.memory),
        "model": ",".join(binding.models),
        "cell_id": ",".join(binding.cell_ids),
        "chip_id": ",".join(binding.chip_ids),
        "port": str(binding.port),
    }


def publish_binding(registry: RegistryClient | TelemetryRegistry,
                    pod: PodRequest, binding: Binding,
                    fence: int | None = None) -> None:
    """Publish one requirement record; with ``fence`` set the write
    carries the scheduler's leadership epoch and a deposed leader is
    refused 409 (doc/ha.md). No fence = the exact pre-HA call, so the
    wire stays byte-identical for non-HA deployments."""
    if fence is None:
        registry.put_pod(pod.key, requirement_record(pod, binding))
    else:
        registry.put_pod(pod.key, requirement_record(pod, binding),
                         fence=fence)


def withdraw(registry: RegistryClient | TelemetryRegistry,
             pod_key: str, fence: int | None = None) -> None:
    if fence is None:
        registry.drop_pod(pod_key)
    else:
        registry.drop_pod(pod_key, fence=fence)


def sync_engine_from_registry(engine,
                              registry: RegistryClient | TelemetryRegistry) -> list[str]:
    """Feed the scheduler engine from the capacity bus (the reference's
    ``getGPUByNode`` PromQL query, ``pkg/scheduler/gpu.go:22-53`` — here a
    fresh read). Returns the nodes updated."""
    from ..topology.chip import ChipInfo

    fleet = {}
    for node, entry in registry.capacity().items():
        chips = [ChipInfo.from_labels(labels) for labels in entry["chips"]]
        fleet[node] = (chips, bool(entry.get("healthy", True)))
    engine.set_fleet(fleet)  # one topology rebuild for the whole sync
    return sorted(fleet)
