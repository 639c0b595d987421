"""ElasticTrainer: an SPMD training loop that survives mesh resizes.

Counterpart of ``kubeshare_tpu/elastic/trainer.py``. The workload half of
the elastic plane: owns the live ``(params, opt_state, step)`` and the
current mesh, and exposes :meth:`resize` — called while the gang is
drain-paused — which re-lays the state onto the new ranks
(``elastic/restate.py``) and rebuilds the sharded train step for the new
mesh. Steps are never dropped: the step counter is monotonic across
resizes and the losses equal an unresized run's up to the order of the
sums (``tests/test_torch_elastic.py``).

Ranks, not devices: ``devices`` is a list of RANKS of the process group
(the port's meshes are ``DeviceMesh``es over ranks), and every rank of the
world runs the trainer. A rank outside the current mesh holds no state:
its :meth:`train_step` only counts the step, and it waits at the next
:meth:`resize`, which is collective over the world group.

:meth:`restater` adapts the trainer to the orchestrator's restate
callback::

    orch.register_restater(gang_id, trainer.restater(device_bank))

where ``device_bank(k)`` returns the ranks of a k-chip mesh. The
orchestrator runs in one process, so the other ranks learn its plans over
the world group at each step boundary: the orchestrator's rank wraps the
restater in :func:`announcing` and ends the boundary with
:func:`announce` ``(None)``; every other rank calls :func:`follow` there.
(In a deployment the launcher's re-render of ``TPU_VISIBLE_CHIPS`` tells
the processes.)
"""

from __future__ import annotations

from ..models.common import to_device
from ..parallel.mesh import (data_sharding, make_mesh,
                             make_sharded_train_step)
from ..utils.device import resolve_device
from .restate import place_tree, restate_state

__all__ = ["ElasticTrainer", "announce", "announcing", "follow"]


class ElasticTrainer:
    """One per training job, on every rank. ``devices`` picks the
    initial sub-mesh's ranks (default: every rank of the world);
    ``device_type`` is the meshes' device (default: the card)."""

    def __init__(self, loss_fn, optimizer, init_params, devices=None,
                 device_type: str | None = None):
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        # the card unless the caller asks for the CPU; raises with no card
        self.device_type = resolve_device(device_type).type
        self.mesh = make_mesh(devices, device_type=self.device_type)
        # every rank holds the global values (a host copy: the step
        # updates in place, never the caller's) and keeps its shards
        init_params = to_device(init_params, "cpu")
        opt_state = optimizer.init(init_params)
        self.params = place_tree(init_params, self.mesh)
        self.opt_state = place_tree(opt_state, self.mesh)
        self.step_fn = self._make_step()
        self.step = 0
        self.losses: list[float] = []
        #: [{"step", "chips", "stats"}] — one entry per resize
        self.resizes: list[dict] = []

    def _make_step(self):
        if self.mesh.get_coordinate() is None:
            return None
        return make_sharded_train_step(self.loss_fn, self.optimizer,
                                       self.mesh)

    @property
    def num_devices(self) -> int:
        return self.mesh.mesh.numel()

    @property
    def in_mesh(self) -> bool:
        """Whether this rank holds a shard of the state."""
        return self.step_fn is not None

    def train_step(self, batch) -> float | None:
        """One step on the global ``batch`` (whole on every rank); the
        global loss, or None on a rank outside the mesh."""
        self.step += 1
        if self.step_fn is None:
            return None
        batch = place_tree(batch, self.mesh, data_sharding(self.mesh))
        self.params, self.opt_state, loss = self.step_fn(
            self.params, self.opt_state, batch)
        loss = float(loss)
        self.losses.append(loss)
        return loss

    def resize(self, devices) -> dict:
        """Move the live state onto a mesh over ``devices`` (ranks) — the
        restate step of an elastic resize; collective over the world
        group. The state is the same training state, re-laid; the next
        :meth:`train_step` runs on the new mesh at the same step
        counter."""
        devices = [int(d) for d in devices]
        new_mesh = make_mesh(devices, device_type=self.device_type)
        self.params, self.opt_state, stats = restate_state(
            self.params, self.opt_state, new_mesh)
        self.mesh = new_mesh
        self.step_fn = self._make_step()
        rec = {"step": self.step, "chips": len(devices), "stats": stats}
        self.resizes.append(rec)
        return rec

    def restater(self, device_bank):
        """Adapt to the orchestrator's restate callback: ``device_bank``
        maps a planned chip count to the ranks to use. Raising propagates
        — the orchestrator aborts the resize back to the old mesh."""

        def _restate(plan: dict) -> None:
            self.resize(device_bank(len(plan["to_chips"])))

        return _restate


def announce(plan: dict | None, src: int = 0) -> None:
    """Send a resize plan (or None: the boundary's end) from ``src`` to
    every rank of the world group; every other rank is in :func:`follow`."""
    import torch.distributed as dist

    dist.broadcast_object_list([plan], src=src)


def announcing(restate, src: int = 0):
    """``restate`` (a :meth:`ElasticTrainer.restater`) that first tells
    every other rank the plan, so they resize with it."""

    def _restate(plan: dict) -> None:
        announce(plan, src)
        restate(plan)

    return _restate


def follow(trainer: ElasticTrainer, device_bank, src: int = 0) -> int:
    """At a step boundary on a rank other than ``src``: apply every plan
    ``src`` announces until its None. Returns the resizes applied."""
    import torch.distributed as dist

    n = 0
    while True:
        box = [None]
        dist.broadcast_object_list(box, src=src)
        if box[0] is None:
            return n
        trainer.resize(device_bank(len(box[0]["to_chips"])))
        n += 1
