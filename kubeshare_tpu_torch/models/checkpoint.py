"""Workload checkpoint and resume, in one process.

Counterpart of the single-process path of
``kubeshare_tpu/models/checkpoint.py``. The isolation runtime makes
checkpoints load-bearing: a preempted or crash-restarted shared pod must
restart from step N, not step 0, or the opportunistic tier's restartable
filler work is lost.

A checkpoint is the flattened leaves of ``(params, opt_state)`` plus the
step count, written in the ``torch.distributed.checkpoint`` format by one
process (``no_dist``: no process group), which keeps zero-size leaves as
they are. Restore rebuilds the structure, shapes and dtypes from
caller-supplied like-trees, so an optimizer state round-trips unchanged.
Leaves are copied to host first: tensors on any device, and proxy-mode
``RemoteTensor`` leaves, which are fetched from the proxy.

Every save is atomic. DCP writes into ``<path>.staging.tmp``; once it
returns with the ``.metadata`` file (which it writes last), the
directory is committed by a rename to ``<path>.staging`` and then
promoted by a rename over ``path``. Only a committed directory, one
that holds ``.metadata``, is ever loaded: :func:`load_checkpoint` falls
back to a committed staging directory when ``path`` is missing, which
covers a crash between the promote's two renames, and a crash inside a
write leaves only a ``.tmp`` directory that nothing reads.
:class:`AsyncCheckpointWriter` overlaps the write with training: its
``save`` copies the state to host on the calling thread and a thread of
its own writes, commits and promotes the copy.

Checkpoints of a gang (an initialized ``torch.distributed`` group of more
than one rank) need sharded saves on storage every member shares; they
raise here until the port's gangs come (ROADMAP queue 1 item 4).
"""

from __future__ import annotations

import os
import shutil
import threading
import warnings

import numpy as np
import torch

from ..utils.tree import tree_flatten, tree_unflatten

#: why a gang's checkpoint is refused
GANG_REFUSAL = ("checkpoints of a gang are not ported yet: sharded saves "
                "on shared storage and verify_shared_path come with the "
                "port's parallel/ and gangs, ROADMAP queue 1 item 4")


def refuse_gang() -> None:
    """Raises under an initialized ``torch.distributed`` group of more
    than one rank."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise RuntimeError(f"--checkpoint with world size "
                           f"{dist.get_world_size()}: {GANG_REFUSAL}")


def _host_leaf(x) -> torch.Tensor:
    """A host copy of one leaf. A tensor on any device is copied off it;
    anything else (a numpy array, a number, a proxy-mode ``RemoteTensor``,
    whose ``__array__`` fetches it from the proxy) is read through
    numpy."""
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


def _write(path: str, state: dict) -> None:
    """Write ``state``, commit it and promote it over ``path``. At every
    point of this a committed copy of the newest finished state is at
    ``path`` or at ``<path>.staging``: a failed or killed write leaves
    both as they were."""
    staging = _staging(path)
    tmp = staging + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)     # an earlier crash's leftover
    _dcp().save(state, checkpoint_id=tmp, no_dist=True)
    if not _committed(tmp):
        raise OSError(f"checkpoint write to {tmp} left no .metadata")
    if _committed(staging):
        # a crash inside an earlier promote: finish it before the commit
        # below replaces that newest state
        _promote(path)
    shutil.rmtree(staging, ignore_errors=True)
    os.rename(tmp, staging)                    # the commit
    _promote(path)


def save_checkpoint(path: str | os.PathLike, params, opt_state,
                    step: int) -> None:
    """Atomic full-state save: the state is written and committed beside
    ``path``, then renamed over it."""
    refuse_gang()
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
        refuse_gang()
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
    numpy array or a ``RemoteTensor``; its values are not read)."""
    dtype = like.dtype
    if not isinstance(dtype, torch.dtype):
        dtype = torch.from_numpy(np.empty(0, dtype)).dtype
    return torch.empty(tuple(like.shape), dtype=dtype)


def load_checkpoint(path: str | os.PathLike, like_params, like_opt_state):
    """→ ``(params, opt_state, step)``.

    ``like_*`` give the structure, shapes and dtypes to restore into
    (pass a freshly built ``init()`` and ``optimizer.init()`` pair); their
    values are discarded. Each leaf comes back as a tensor on its
    like-leaf's device, or on the CPU where the like-leaf is not a tensor.
    Raises FileNotFoundError when neither ``path`` nor ``<path>.staging``
    holds a committed checkpoint (the caller starts fresh)."""
    refuse_gang()
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
    _dcp().load(state, checkpoint_id=path, no_dist=True)
    leaves = [state["leaves"][str(i)] for i in range(len(like_leaves))]
    leaves = [t.to(like.device) if isinstance(like, torch.Tensor) else t
              for t, like in zip(leaves, like_leaves)]
    params, opt_state = tree_unflatten(treedef, leaves)
    return params, opt_state, int(state["step"])
