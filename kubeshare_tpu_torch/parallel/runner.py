"""Multi-process gang runner: binding env → ``torch.distributed`` → mesh.

Counterpart of ``kubeshare_tpu/parallel/runner.py``. The scheduler
injects each gang member's identity (``KUBESHARE_TPU_NUM_PROCESSES``,
``KUBESHARE_TPU_PROCESS_ID``: dense ranks assigned at Reserve); the
manifest wires ``KUBESHARE_TPU_COORDINATOR`` (``host:port``) to rank 0.
This module turns those into one initialized ``torch.distributed`` group
and a gang-wide :class:`~torch.distributed.device_mesh.DeviceMesh`.

Typical gang workload::

    from kubeshare_tpu_torch.parallel import runner
    runner.distributed_init_from_env()     # no-op off-gang
    mesh = runner.gang_mesh()              # every rank of the gang

**The backend** is decided by one rule, before any collective: the ranks
rendezvous at the coordinator's TCP store and post their device's UUID
there. With every rank on its own CUDA device it is NCCL; where ranks
share a device (NCCL refuses two ranks on one device) or a rank has none
it is gloo, and the port's collectives stage CUDA tensors through host
memory for it (:mod:`.collectives`). :func:`backend` reports the choice
and :func:`backend_reason` why; the join logs both. An NCCL init that
fails raises: there is no fallback to gloo.

**The mesh env.** ``KUBESHARE_TPU_MESH`` has two meanings where it is
read: the engine injects the node's mesh SHAPE (``"2x4"``) beside a carved
``TPU_VISIBLE_CHIPS``, and a manifest may name the gang's AXES
(``"dp=2,sp=2,tp=2"``). The JAX ``gang_mesh`` parses every value as axes
and raises on a shape. Here an axis spec is taken only when every entry
is ``name=int``; a shape (digits joined by ``x``) is not one, and the
mesh is then the default (or the carved one, when the carve names every
rank of the gang).
"""

from __future__ import annotations

import contextlib
import math
import os
import re
import time
from datetime import timedelta

from .. import constants as C
from ..obs import metrics as obs_metrics
from ..obs.trace import get_tracer
from ..utils.logger import get_logger

log = get_logger("runner")

_initialized = False
#: (backend, why) once joined
_backend: tuple[str, str] | None = None

_STEP_LAT = obs_metrics.default_registry().histogram(
    "kubeshare_runner_step_seconds",
    "Wall time of one training/eval step in the gang runner.",
    labels=("phase",))

#: a node mesh shape as the engine injects it, e.g. "2x4"
_MESH_SHAPE = re.compile(r"^\s*\d+(\s*x\s*\d+)*\s*$")


@contextlib.contextmanager
def step_timer(phase: str = "train", trace_id: str = "", step: int = -1):
    """Time one step's wall clock into ``kubeshare_runner_step_seconds``.

    ``phase`` labels the histogram series (train/eval/...), a handful of
    static values. With a ``trace_id`` each step also lands as a ``step``
    span on the pod's timeline, so per-step stalls line up against token
    grant waits."""
    t0 = time.perf_counter()
    ts0 = get_tracer().now_ms()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _STEP_LAT.observe(phase, value=dt)
        if trace_id:
            tracer = get_tracer()
            attrs = {"phase": phase}
            if step >= 0:
                attrs["step"] = step
            tracer.record("step", trace_id, ts0, tracer.now_ms(), **attrs)


def timed_range(n: int, phase: str = "train", trace_id: str = ""):
    """``range(n)`` that times each iteration as one step."""
    for i in range(n):
        with step_timer(phase, trace_id=trace_id, step=i):
            yield i


def backend() -> str:
    """The group's backend (``"nccl"`` or ``"gloo"``), ``""`` off-gang."""
    return _backend[0] if _backend else ""


def backend_reason() -> str:
    """Why :func:`backend` is what it is."""
    return _backend[1] if _backend else ""


def _device_uuid() -> str:
    """This rank's CUDA device UUID, or ``""`` with no CUDA device."""
    import torch

    if not torch.cuda.is_available():
        return ""
    return str(torch.cuda.get_device_properties(
        torch.cuda.current_device()).uuid)


def decide_backend(uuids: list[str]) -> tuple[str, str]:
    """The rule, from every rank's device UUID (``""``: none)."""
    missing = [r for r, u in enumerate(uuids) if not u]
    if missing:
        return "gloo", f"rank(s) {missing} have no CUDA device"
    holders: dict[str, list[int]] = {}
    for r, u in enumerate(uuids):
        holders.setdefault(u, []).append(r)
    shared = {u: rs for u, rs in holders.items() if len(rs) > 1}
    if shared:
        u, rs = next(iter(shared.items()))
        return "gloo", (f"ranks {rs} share device {u}: NCCL refuses two "
                        f"ranks on one device, so CUDA tensors are staged "
                        f"through host memory")
    return "nccl", "every rank holds its own CUDA device"


def distributed_init_from_env(env: dict | None = None) -> bool:
    """Join the gang's ``torch.distributed`` group from the injected env.

    Returns True for a gang member (env present, joined now or before);
    False for a solo process — callers need no branching, ``gang_mesh``
    works either way. ``KUBESHARE_TPU_RENDEZVOUS_TIMEOUT_S`` bounds the
    wait for the others (on expiry this raises and the attach shim exits
    the member, so a restart retries); a malformed value warns and is
    ignored."""
    global _initialized, _backend
    env = os.environ if env is None else env
    coord = env.get(C.ENV_COORDINATOR, "")
    nproc = env.get(C.ENV_NUM_PROCESSES, "")
    rank = env.get(C.ENV_PROCESS_ID, "")
    if not (coord and nproc and rank):
        return False
    if _initialized:
        return True
    import torch.distributed as dist

    kwargs = {}
    timeout_s = env.get(C.ENV_RENDEZVOUS_TIMEOUT_S, "")
    if timeout_s:
        try:
            kwargs["timeout"] = timedelta(seconds=int(float(timeout_s)))
        except ValueError:
            log.warning("ignoring malformed %s=%r",
                        C.ENV_RENDEZVOUS_TIMEOUT_S, timeout_s)
    rank, nproc = int(rank), int(nproc)
    url = coord if "://" in coord else f"tcp://{coord}"
    store, _, _ = next(dist.rendezvous(url, rank=rank, world_size=nproc,
                                       **kwargs))
    store.set(f"kubeshare/device/{rank}", _device_uuid())
    uuids = [store.get(f"kubeshare/device/{r}").decode()
             for r in range(nproc)]
    name, why = decide_backend(uuids)
    dist.init_process_group(name, store=store, rank=rank, world_size=nproc,
                            **kwargs)
    _initialized = True
    _backend = (name, why)
    log.info("joined gang %s as process %s/%s via %s; backend %s: %s",
             env.get(C.ENV_GROUP_NAME, "?"), rank, nproc, coord, name, why)
    return True


def _axis_spec(spec: str) -> list[tuple[str, int]] | None:
    """The axes of a ``KUBESHARE_TPU_MESH`` axis spec, or None for an
    empty value or a node mesh shape; raises on anything else."""
    if not spec.strip() or _MESH_SHAPE.match(spec):
        return None
    axes = []
    for part in spec.split(","):
        name, _, size = part.partition("=")
        try:
            axes.append((name.strip(), int(size)))
        except ValueError:
            raise ValueError(f"bad KUBESHARE_TPU_MESH entry {part!r} "
                             "(want name=int)") from None
    return axes


def gang_mesh(dp: int | None = None, tp: int | None = None,
              hybrid: bool | None = None, *, device_type: str | None = None):
    """A mesh over every rank of the gang (one rank off-gang).

    An axis spec in ``KUBESHARE_TPU_MESH`` (``"dp=2,sp=2,tp=2"``)
    overrides everything: the mesh has exactly those axes, in that order
    — the hook long-context workloads use to get an ``sp`` axis without
    touching code. It must name ``dp`` and ``tp`` (size 1 disables one)
    and cover the gang.

    Otherwise a carve in ``TPU_VISIBLE_CHIPS`` that names every rank
    gives :func:`~.mesh.make_carved_mesh` (validated against the node
    mesh shape, when the variable holds one), and ``hybrid=None``
    auto-selects: a two-tier ``(dcn, dp, tp)`` mesh when the gang spans
    hosts (grouped by host), else a flat ``(dp, tp)`` mesh. ``hybrid=True``
    forces the two-tier layout, grouping by process on one host."""
    import socket

    import numpy as np
    import torch.distributed as dist

    from .mesh import make_carved_mesh, make_hybrid_mesh, make_mesh, new_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = list(range(world))
    spec = os.environ.get(C.ENV_MESH_SHAPE, "")
    axes = _axis_spec(spec)
    if axes is not None:
        if dp is not None or tp is not None or hybrid is not None:
            raise ValueError(
                "gang_mesh received explicit dp/tp/hybrid arguments but "
                f"KUBESHARE_TPU_MESH={spec!r} is set — remove one; the "
                "env override would silently win otherwise")
        names = [n for n, _ in axes]
        for required in ("dp", "tp"):
            if required not in names:
                raise ValueError(
                    f"KUBESHARE_TPU_MESH {spec!r} must name a {required!r} "
                    f"axis (use {required}=1 to disable it)")
        total = math.prod(s for _, s in axes)
        if total != world:
            raise ValueError(
                f"KUBESHARE_TPU_MESH {spec!r} wants {total} devices, gang "
                f"has {world}")
        return new_mesh(np.array(ranks).reshape([s for _, s in axes]),
                        names, device_type)

    carve = os.environ.get(C.ENV_VISIBLE_CHIPS, "")
    if "@" in carve and dp is None and tp is None and not hybrid:
        from ..gang.carve import parse_visible_chips
        if len(parse_visible_chips(carve)) == world:
            return make_carved_mesh(carve, ranks, mesh_shape=spec or None,
                                    device_type=device_type)

    hosts = [socket.gethostname()]
    if world > 1:
        hosts = [None] * world
        dist.all_gather_object(hosts, socket.gethostname())
    groups: dict = {}
    for r, h in enumerate(hosts):
        groups.setdefault(h, []).append(r)
    if hybrid is None:
        hybrid = len(groups) > 1
    if not hybrid:
        return make_mesh(ranks, dp=dp, tp=tp, device_type=device_type)
    if dp is not None:
        raise ValueError(
            "dp is derived per slice on hybrid meshes (slice_size // tp); "
            "pass tp instead")
    if len(groups) <= 1:
        groups = {r: [r] for r in ranks}
    if len(groups) <= 1:
        return make_mesh(ranks, dp=dp, tp=tp, device_type=device_type)
    return make_hybrid_mesh(list(groups.values()), tp=tp,
                            device_type=device_type)
