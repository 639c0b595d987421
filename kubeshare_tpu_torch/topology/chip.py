"""Device inventory record — the fields of
``kubeshare_tpu/topology/chip.py:ChipInfo`` that discovery fills.

The reference's collector exports ``gpu_capacity{node, uuid, model,
memory, index}`` (``pkg/collector/collector.go:30-35``). The JAX package
adds ICI mesh coordinates and a slice id; on a GPU host those stay empty
until the port models NVLink/NVSwitch domains.
"""

from __future__ import annotations

from dataclasses import dataclass, field


def normalize_model(device_kind: str) -> str:
    """Spaces → dashes (``pkg/collector/gpu.go:60``): e.g.
    ``"NVIDIA H100 80GB HBM3"`` → ``"NVIDIA-H100-80GB-HBM3"``."""
    return device_kind.strip().replace(" ", "-")


@dataclass(frozen=True)
class ChipInfo:
    """One device as seen by discovery."""

    chip_id: str                 # stable id "<model>-<host>-<index>" (≙ GPU UUID)
    index: int                   # per-host device index
    host: str                    # node name owning the device
    model: str                   # normalized device name
    memory: int                  # device memory, bytes
    coords: tuple[int, ...] = field(default=())   # mesh coordinates (TPU)
    core_count: int = 1
    slice_id: str = ""

    def to_labels(self) -> dict[str, str]:
        """The telemetry label set, as the JAX package's."""
        return {
            "node": self.host,
            "chip_id": self.chip_id,
            "model": self.model,
            "memory": str(self.memory),
            "index": str(self.index),
            "coords": ",".join(str(c) for c in self.coords),
            "slice_id": self.slice_id,
        }

    @staticmethod
    def from_labels(labels: dict[str, str]) -> "ChipInfo":
        """The inverse of :meth:`to_labels`: the record a registry
        capacity entry holds."""
        coords = (tuple(int(c) for c in labels["coords"].split(","))
                  if labels.get("coords") else ())
        return ChipInfo(
            chip_id=labels["chip_id"],
            index=int(labels["index"]),
            host=labels["node"],
            model=labels["model"],
            memory=int(labels["memory"]),
            coords=coords,
            slice_id=labels.get("slice_id", ""),
        )


def make_chip_id(model: str, host: str, index: int) -> str:
    """``<model>-<host>-<index>``: the trailing field is the per-host
    index the attach's device pin parses. The JAX package prefixes
    ``TPU-`` to a model without it; the port does not (a GPU's model
    names the GPU), so the two agree on every TPU-prefixed model."""
    return f"{model}-{host}-{index}"
