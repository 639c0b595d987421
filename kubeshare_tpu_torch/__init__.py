"""kubeshare-tpu on PyTorch and CUDA: the port of ``kubeshare_tpu`` to an
NVIDIA H100.

The JAX package beside this one stays the reference. This package mirrors
its module paths (``ops/``, ``models/``, ``isolation/``) so each part has a
counterpart to be held against, and it imports neither JAX nor anything of
the JAX package.

What this package runs today is the north-star path: one mnist trainer
alone on the card, then two trainers at ``tpu_request=0.5`` sharing the
card through the device-owning :class:`~.isolation.proxy.ChipProxy` and the
per-device :class:`~.isolation.tokensched.TokenScheduler`. The optimizer
step of every train step is a hand-written CUDA kernel
(``csrc/fused_adam.cu``), the counterpart of the Pallas kernel in
``kubeshare_tpu/ops/fused_adam.py``. Beside them, the serving plane
(:mod:`.serving`) answers latency-class tenants, whose waits preempt a
best-effort trainer at its next program boundary (:mod:`.preempt`), and
the observability plane (:mod:`.obs`) accounts the device's time to its
tenants, names who held it while a grant waited, judges SLOs and carries
trace ids across the wire. The placement path takes a pod from its
``sharedtpu/*`` labels to a device: the telemetry registry
(:mod:`.telemetry`), the per-node collector and config daemon
(:mod:`.nodeagent`) and the scheduler engine (:mod:`.scheduler`) over the
cell model (:mod:`.topology`).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card they raise rather than fall back to the CPU.
"""

__version__ = "0.1.0"
