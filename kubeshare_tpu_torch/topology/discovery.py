"""Device discovery — counterpart of ``kubeshare_tpu/topology/discovery.py``.

The reference discovers GPUs through NVML (``pkg/collector/gpu.go:26-107``).
Two backends:

- ``cuda``: one entry per visible CUDA device, from
  ``torch.cuda.get_device_properties`` (there is no pynvml);
- ``fake``: a synthetic fleet for tests and simulation, the JAX package's
  spec grammar (``"<hosts>:<d0>x<d1>[@<model>]"``).

The mesh coordinates stay empty for CUDA devices: the NVLink topology is
not modelled yet.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from ..utils import default_node_name
from .chip import ChipInfo, make_chip_id, normalize_model

DEFAULT_FAKE_HBM = 16 * 1024**3


@dataclass
class FakeTopology:
    """Synthetic fleet: ``hosts`` machines (``tpu-host-<h>``) × a ``mesh``
    of devices each; global coords place hosts side by side along the
    first axis. The JAX package's, without its slice and naming knobs."""

    hosts: int = 1
    mesh: tuple[int, ...] = (2, 2)
    model: str = "TPU-v4"

    def chips(self) -> list[ChipInfo]:
        chips: list[ChipInfo] = []
        per_host = 1
        for d in self.mesh:
            per_host *= d
        for h in range(self.hosts):
            host = f"tpu-host-{h}"
            for i in range(per_host):
                coords = []
                rem = i
                for dim in reversed(self.mesh):
                    coords.append(rem % dim)
                    rem //= dim
                coords.reverse()
                coords[0] += h * self.mesh[0]   # hosts tile along axis 0
                chips.append(ChipInfo(
                    chip_id=make_chip_id(self.model, host, i), index=i,
                    host=host, model=self.model, memory=DEFAULT_FAKE_HBM,
                    coords=tuple(coords)))
        return chips


def _cuda_chips(host: str | None = None) -> list[ChipInfo]:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; discover a fake fleet "
                           "(backend 'fake') to run without a card")
    host = host or default_node_name()
    chips = []
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        model = normalize_model(props.name)
        chips.append(ChipInfo(chip_id=make_chip_id(model, host, i), index=i,
                              host=host, model=model,
                              memory=int(props.total_memory)))
    return chips


def device_chip_id(device) -> str:
    """The id discovery gives ``device`` (a ``torch.device``): a CUDA
    card's ``<model>-<host>-<index>``, any other device its own name. The
    token scheduler, the chip-time ledger and the blame graph key a
    device by it."""
    if device.type != "cuda":
        return str(device)
    import torch

    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    model = normalize_model(torch.cuda.get_device_properties(index).name)
    return make_chip_id(model, default_node_name(), index)


def discover_chips(backend: str = "auto",
                   host: str | None = None) -> list[ChipInfo]:
    """Enumerate local devices. ``backend``: ``"cuda"``, ``"fake"``, or
    ``"auto"`` (``fake`` iff ``$KUBESHARE_TPU_FAKE_TOPOLOGY`` is set)."""
    if backend == "auto":
        backend = ("fake" if os.environ.get("KUBESHARE_TPU_FAKE_TOPOLOGY")
                   else "cuda")
    if backend == "cuda":
        return _cuda_chips(host)
    if backend == "fake":
        chips = parse_fake_spec(
            os.environ.get("KUBESHARE_TPU_FAKE_TOPOLOGY", "1:2x2")).chips()
        if host is not None:
            # a per-node collector reports only its own devices
            return [c for c in chips if c.host == host]
        return chips
    raise ValueError(f"unknown discovery backend: {backend}")


def parse_fake_spec(spec: str) -> FakeTopology:
    """``"<hosts>:<d0>x<d1>[x<d2>][@<model>]"`` → :class:`FakeTopology`."""
    model = "TPU-v4"
    if "@" in spec:
        spec, model = spec.split("@", 1)
    hosts_str, _, mesh_str = spec.partition(":")
    if not mesh_str:
        hosts_str, mesh_str = "1", hosts_str
    mesh = tuple(int(d) for d in mesh_str.split("x"))
    return FakeTopology(hosts=int(hosts_str), mesh=mesh, model=model)
