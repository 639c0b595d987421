"""Device selection for the port's entry points.

Every entry point takes ``device``: ``None`` means the CUDA card, and the
CPU runs only when the caller asks for it (the tests do). With no card,
asking for ``cuda`` raises — nothing carries on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def synchronize(device: torch.device) -> None:
    """Completion barrier: returns once every kernel queued on ``device``
    has finished. torch launches asynchronously, so a host clock read
    without this measures the enqueue, not the work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def launch_on(device: torch.device, launch):
    """``launch(stream)`` with ``device`` current on the calling thread and
    ``stream`` that device's current CUDA stream, as a raw handle (an
    int): a hand-written kernel launches on the thread's current device,
    on the stream torch queues that device's work on. Switches devices
    only when ``device`` is not the current one already."""
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        return launch(torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return launch(torch._C._cuda_getCurrentRawStream(index))
