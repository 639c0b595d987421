"""The placement engine of the port — the counterpart of
``kubeshare_tpu/scheduler/``: the reference's extension points over the
cell model, run in-process (see :mod:`.engine` for the parity map). The
HTTP service, the Kubernetes bridge and the dispatcher are not ported
yet.
"""

from .engine import Binding, SchedulerEngine, Unschedulable
from .labels import LabelError, PodRequest, parse_pod_labels
from .podgroup import PodGroup, PodGroupRegistry, queue_less

__all__ = [
    "Binding", "SchedulerEngine", "Unschedulable",
    "LabelError", "PodRequest", "parse_pod_labels",
    "PodGroup", "PodGroupRegistry", "queue_less",
]
