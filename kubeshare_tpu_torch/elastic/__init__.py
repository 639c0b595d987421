"""Elastic SPMD training plane of the port: live grow/shrink of a running
gang's sub-mesh without restart.

Counterpart of ``kubeshare_tpu/elastic/``. Control plane
(:mod:`.orchestrator`) — the journaled plan→pause→restate→flip→resume
state machine over the dispatcher's bookings; import-light, so the
scheduler service, doctor and topcli load it without torch. Data plane
(:mod:`.restate`, :mod:`.trainer`) — re-sharding live param and optimizer
trees onto the new mesh over ``torch.distributed``; imported lazily.

Distinct from :class:`~..autopilot.elastic.ElasticQuota` (idle *share*
lending within a fixed placement): this plane changes the placement
itself — how many devices a training job runs on.
"""

from .orchestrator import (ElasticConfig, ElasticOrchestrator, recover)

__all__ = ["ElasticConfig", "ElasticOrchestrator", "ElasticTrainer",
           "recover", "restate_state", "restate_tree",
           "restate_via_checkpoint"]


def __getattr__(name):
    # lazy: the data plane imports torch; the control plane must stay
    # loadable in processes that never touch a tensor
    if name in ("restate_state", "restate_tree",
                "restate_via_checkpoint"):
        from . import restate
        return getattr(restate, name)
    if name == "ElasticTrainer":
        from .trainer import ElasticTrainer
        return ElasticTrainer
    raise AttributeError(name)
