"""The placement engine of the port — the counterpart of
``kubeshare_tpu/scheduler/``: the reference's extension points over the
cell model (see :mod:`.engine` for the parity map), the enforcing loop
around it (:mod:`.dispatcher`, :mod:`.healthwatch`), the HTTP service
(:mod:`.service`) and the Kubernetes side: the pod-event bridge
(:mod:`.bridge`) and the admission webhook (:mod:`.webhook`).
"""

from .engine import Binding, SchedulerEngine, Unschedulable
from .labels import LabelError, PodRequest, parse_pod_labels
from .podgroup import PodGroup, PodGroupRegistry, queue_less

__all__ = [
    "Binding", "SchedulerEngine", "Unschedulable",
    "LabelError", "PodRequest", "parse_pod_labels",
    "PodGroup", "PodGroupRegistry", "queue_less",
]
