"""Workload checkpoint and resume, for one process or a gang.

Counterpart of ``kubeshare_tpu/models/checkpoint.py``. The isolation
runtime makes checkpoints load-bearing: a preempted or crash-restarted
shared pod must restart from step N, not step 0, or the opportunistic
tier's restartable filler work is lost.

A checkpoint is the flattened leaves of ``(params, opt_state)`` plus the
step count, written in the ``torch.distributed.checkpoint`` (DCP) format.
One process writes with ``no_dist`` (no process group), which keeps
zero-size leaves as they are. Restore rebuilds the structure, shapes and
dtypes from caller-supplied like-trees, so an optimizer state
round-trips unchanged. Leaves are copied to host first: tensors on any
device, and proxy-mode ``RemoteTensor`` leaves, which are fetched from
the proxy.

In a gang (an initialized ``torch.distributed`` group) every member
writes its shards into ONE directory, which must be shared storage
(:func:`verify_shared_path` checks). DTensor leaves (a sharded step's
trees, :mod:`~kubeshare_tpu_torch.parallel.mesh`) save as their
shards with the global layout, and a load reshards them to the
like-tree's layout; plain leaves are the same on every rank and DCP
writes each once. DCP's collectives and the barriers below run on a
gloo group of their own (:func:`gang_group`), so a write in the async
writer's thread never interleaves with the training's collectives.

Every save is atomic. DCP writes into ``<path>.staging.tmp``; once it
returns with the ``.metadata`` file (which it writes last, after every
member's shards), the directory is committed by a rename to
``<path>.staging`` and then promoted by a rename over ``path`` (in a
gang, rank 0 renames and the others wait for it). Only a committed
directory, one that holds ``.metadata``, is ever loaded:
:func:`load_checkpoint` falls back to a committed staging directory when
``path`` is missing, which covers a crash between the promote's two
renames, and a crash inside a write leaves only a ``.tmp`` directory
that nothing reads. :class:`AsyncCheckpointWriter` overlaps the write
with training: its ``save`` copies the state to host on the calling
thread and a thread of its own writes, commits and promotes the copy.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
import warnings

import numpy as np
import torch

from ..utils.tree import tree_flatten, tree_unflatten

#: how long a rank polls for rank 0's probe of a shared checkpoint path
SHARED_PROBE_WAIT_S = 10.0

_group = None
_group_lock = threading.Lock()


def _in_gang() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def gang_group():
    """The gloo group the gang's checkpoints coordinate on, made at the
    first call (every rank must make that call, at the same point: a
    save, a load, or :func:`verify_shared_path`, all of which the ranks
    run alike on their main threads)."""
    global _group
    import torch.distributed as dist

    with _group_lock:
        if _group is None:
            _group = dist.new_group(backend="gloo")
        return _group


def verify_shared_path(path: str | os.PathLike) -> None:
    """Fail FAST when a gang's checkpoint path is not on shared storage.

    Every member must see the same directory, or the checkpoint misses
    shards (and a later restore can hang when only some ranks find it).
    Rank 0 writes a run-unique token beside the checkpoint directory;
    after a barrier every rank must read that token within
    :data:`SHARED_PROBE_WAIT_S` (a network mount may show a new file
    late). The verdicts are exchanged before anyone raises, so every rank
    exits together: each raises ``SystemExit`` naming the ranks that
    cannot see the probe."""
    import torch.distributed as dist

    if not _in_gang() or dist.get_world_size() <= 1:
        return
    group = gang_group()
    box = [int(np.random.default_rng().integers(1, 2**62))]
    dist.broadcast_object_list(box, src=0, group=group)
    token = box[0]
    path = os.path.abspath(os.fspath(path))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    probe = path + ".shared-probe"
    rank = dist.get_rank()
    if rank == 0:
        with open(probe, "w") as f:
            f.write(str(token))
    dist.barrier(group=group)
    deadline = time.monotonic() + SHARED_PROBE_WAIT_S
    while True:
        try:
            with open(probe) as f:
                seen = int(f.read().strip() or 0)
        except (FileNotFoundError, ValueError):
            seen = -1
        if seen == token or time.monotonic() >= deadline:
            break
        time.sleep(0.25)
    verdicts = [None] * dist.get_world_size()
    dist.all_gather_object(verdicts, seen == token, group=group)
    if rank == 0:
        try:
            os.remove(probe)
        except OSError:
            pass
    if not all(verdicts):
        bad = [i for i, v in enumerate(verdicts) if not v]
        raise SystemExit(
            f"kubeshare-tpu: checkpoint path {path!r} is NOT shared "
            f"storage (process(es) {bad} cannot see rank 0's probe) — a "
            f"gang checkpoint there would be missing shards. Mount a "
            f"shared volume (RWX) or drop --checkpoint.")


def _host_mesh(mesh):
    """A host twin of ``mesh``: the same ranks and axes on the CPU, with
    no process groups of its own (DCP reads only each rank's coordinate
    off it)."""
    from torch.distributed.device_mesh import DeviceMesh

    twin = _host_meshes.get(id(mesh))
    if twin is None or twin[0] is not mesh:
        host = DeviceMesh("cpu", mesh.mesh,
                          mesh_dim_names=tuple(mesh.mesh_dim_names),
                          _init_backend=False)
        twin = _host_meshes[id(mesh)] = (mesh, host)
    return twin[1]


_host_meshes: dict = {}


def _host_leaf(x) -> torch.Tensor:
    """A host copy of one leaf. A DTensor becomes a host DTensor of its
    shard; a tensor on any device is copied off it; anything else (a
    numpy array, a number, a proxy-mode ``RemoteTensor``, whose
    ``__array__`` fetches it from the proxy) is read through numpy."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        local = x.to_local().detach().to(
            "cpu", memory_format=torch.contiguous_format, copy=True)
        return DTensor.from_local(local, _host_mesh(x.device_mesh),
                                  x.placements, run_check=False,
                                  shape=x.shape, stride=x.stride())
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", memory_format=torch.contiguous_format,
                              copy=True)
    return torch.from_numpy(np.array(x))


def _state_dict(params, opt_state, step: int) -> dict:
    """The saved state, on the host: what a write needs, snapshotted off
    the live (and in-place updated) buffers."""
    leaves = tree_flatten((params, opt_state))[0]
    return {"leaves": {str(i): _host_leaf(x) for i, x in enumerate(leaves)},
            "step": int(step)}


def _staging(path: str) -> str:
    return path + ".staging"


def _committed(path: str) -> bool:
    """A directory whose write finished: DCP writes ``.metadata`` last."""
    return os.path.isfile(os.path.join(path, ".metadata"))


def _dcp():
    """``torch.distributed.checkpoint``, whose one-process save and load
    warn that no process group is up: here that is the intent."""
    import torch.distributed.checkpoint as dcp

    warnings.filterwarnings(
        "ignore", category=UserWarning,
        message="torch.distributed is disabled, unavailable or "
                "uninitialized")
    return dcp


def _promote(path: str) -> None:
    """Move the committed staging directory over ``path``. The window with
    no ``path`` is two renames; :func:`load_checkpoint`'s staging fallback
    covers it."""
    old = path + ".old"
    shutil.rmtree(old, ignore_errors=True)
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(_staging(path), path)
    shutil.rmtree(old, ignore_errors=True)


def _commit(path: str) -> None:
    """Commit the finished ``<path>.staging.tmp`` and promote it over
    ``path``."""
    staging = _staging(path)
    tmp = staging + ".tmp"
    if not _committed(tmp):
        raise OSError(f"checkpoint write to {tmp} left no .metadata")
    if _committed(staging):
        # a crash inside an earlier promote: finish it before the commit
        # below replaces that newest state
        _promote(path)
    shutil.rmtree(staging, ignore_errors=True)
    os.rename(tmp, staging)                    # the commit
    _promote(path)


def _write(path: str, state: dict) -> None:
    """Write ``state``, commit it and promote it over ``path``. At every
    point of this a committed copy of the newest finished state is at
    ``path`` or at ``<path>.staging``: a failed or killed write leaves
    both as they were. In a gang every rank writes its shards and rank 0
    commits; every rank returns once the promote is done, and raises
    rank 0's error if it failed."""
    tmp = _staging(path) + ".tmp"
    if not _in_gang():
        shutil.rmtree(tmp, ignore_errors=True)  # an earlier crash's leftover
        _dcp().save(state, checkpoint_id=tmp, no_dist=True)
        _commit(path)
        return
    import torch.distributed as dist

    group = gang_group()
    rank = dist.get_rank()
    if rank == 0:
        shutil.rmtree(tmp, ignore_errors=True)
    dist.barrier(group=group)
    _dcp().save(state, checkpoint_id=tmp, process_group=group)
    error = [None]
    if rank == 0:
        try:
            _commit(path)
        except OSError as e:
            error[0] = f"{type(e).__name__}: {e}"
    dist.broadcast_object_list(error, src=0, group=group)
    if error[0] is not None:
        raise OSError(f"gang checkpoint commit at rank 0 failed: "
                      f"{error[0]}")


def save_checkpoint(path: str | os.PathLike, params, opt_state,
                    step: int) -> None:
    """Atomic full-state save: the state is written and committed beside
    ``path``, then renamed over it (in a gang, by every rank)."""
    _write(os.path.abspath(os.fspath(path)),
           _state_dict(params, opt_state, step))


class AsyncCheckpointWriter:
    """Overlapped checkpointing: ``save()`` returns once the state is
    copied to host; a thread of the writer's own writes, commits and
    promotes the copy while training goes on, so a step stalls for the
    copy, not the write.

    The previous good checkpoint stays whole through every write: a save
    reaches ``path`` only once its write has committed. At most one save
    is in flight. A failed write (DCP raises ``CheckpointException``, a
    ``BaseException``) raises from the next ``save()``, ``wait()`` or
    ``close()``.

    Under a gate-mode attach the host copies run on the caller's thread,
    metered as its other work; the writer's thread touches host memory
    and files only, and the attach meters it as any thread started after
    it."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def _run(self, path: str, state: dict) -> None:
        try:
            _write(path, state)
        except BaseException as e:            # handed to the next call
            self._error = e

    def wait(self) -> None:
        """Finish the write in flight; raise if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def save(self, path: str | os.PathLike, params, opt_state,
             step: int) -> None:
        if _in_gang():
            gang_group()                      # made here, on every rank
        self.wait()                           # bound in-flight saves at 1
        state = _state_dict(params, opt_state, step)
        self._thread = threading.Thread(
            target=self._run,
            args=(os.path.abspath(os.fspath(path)), state),
            name="checkpoint-writer")
        self._thread.start()

    close = wait

    def __enter__(self) -> "AsyncCheckpointWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _template(like) -> torch.Tensor:
    """An empty host tensor of ``like``'s shape and dtype (a tensor, a
    numpy array or a ``RemoteTensor``; its values are not read); for a
    DTensor, an empty host DTensor of its shard and layout."""
    from torch.distributed.tensor import DTensor

    if isinstance(like, DTensor) and like.dim() == 0:
        # a scalar is replicated: read it whole (on a rank outside the
        # mesh DTensor would take its empty shape as none given)
        return torch.empty((), dtype=like.dtype)
    if isinstance(like, DTensor):
        local = torch.empty(tuple(like.to_local().shape), dtype=like.dtype)
        return DTensor.from_local(local, _host_mesh(like.device_mesh),
                                  like.placements, run_check=False,
                                  shape=like.shape, stride=like.stride())
    dtype = like.dtype
    if not isinstance(dtype, torch.dtype):
        dtype = torch.from_numpy(np.empty(0, dtype)).dtype
    return torch.empty(tuple(like.shape), dtype=dtype)


def _restored(t: torch.Tensor, like):
    """A loaded host leaf on its like-leaf's device (a DTensor on its
    mesh)."""
    from torch.distributed.tensor import DTensor

    if isinstance(like, DTensor):
        local = (t.to_local() if isinstance(t, DTensor) else t).to(
            like.to_local().device)
        return DTensor.from_local(local, like.device_mesh, like.placements,
                                  run_check=False, shape=like.shape,
                                  stride=like.stride())
    return t.to(like.device) if isinstance(like, torch.Tensor) else t


def load_checkpoint(path: str | os.PathLike, like_params, like_opt_state):
    """→ ``(params, opt_state, step)``.

    ``like_*`` give the structure, shapes and dtypes to restore into
    (pass a freshly built ``init()`` and ``optimizer.init()`` pair); their
    values are discarded. Each leaf comes back as a tensor on its
    like-leaf's device, or on the CPU where the like-leaf is not a tensor.
    Raises FileNotFoundError when neither ``path`` nor ``<path>.staging``
    holds a committed checkpoint (the caller starts fresh). In a gang
    every rank must call it alike; a DTensor like-leaf comes back laid
    out as it is, whatever the layout it was saved in."""
    path = os.path.abspath(os.fspath(path))
    if not _committed(path):
        # a crash between the promote's renames leaves the newest state
        # only in the staging sibling
        if not _committed(_staging(path)):
            raise FileNotFoundError(path)
        path = _staging(path)
    like_leaves, treedef = tree_flatten((like_params, like_opt_state))
    state = {"leaves": {str(i): _template(x)
                        for i, x in enumerate(like_leaves)},
             "step": 0}
    if _in_gang():
        _dcp().load(state, checkpoint_id=path, process_group=gang_group())
    else:
        _dcp().load(state, checkpoint_id=path, no_dist=True)
    leaves = [_restored(state["leaves"][str(i)], like)
              for i, like in enumerate(like_leaves)]
    params, opt_state = tree_unflatten(treedef, leaves)
    return params, opt_state, int(state["step"])
