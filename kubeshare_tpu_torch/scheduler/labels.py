"""Workload label parsing and validation.

The port's copy of ``kubeshare_tpu/scheduler/labels.py``.

Re-design of the reference's ``getPodLabels``/``getPodPrioriy``/
``getPodGroupLabels`` (``pkg/scheduler/pod.go:179-327``,
``pod_group.go:86-117``) over the ``sharedtpu/`` vocabulary
(:mod:`..constants`). The same three outcomes: a workload needs TPU and is
well-formed; it needs TPU but is mis-labelled (rejected with a message); or
it carries no TPU labels at all (a *regular* workload the engine scores but
never books).

Validation rules (reference parity, deviations noted):

- ``priority``: absent → 0 (opportunistic). Integer in [-1, 100]; ≤ 0 is
  opportunistic, 1-100 guarantee.
- ``tpu_limit``: required whenever any TPU label is present; decimal
  number ≥ 0.
- ``tpu_request``: optional (default 0); ``request <= limit``; when
  ``limit > 1`` the pod asks whole chips, so ``limit == request`` AND the
  value must be an integer — the reference documents the integer rule but
  only enforces ``limit == request`` (``pod.go:255-262``); we enforce what
  it documents.
- ``limit == request == 0`` → regular workload.
- ``tpu_mem``: optional integer ≥ 0 (bytes).
- ``tpu_model``: optional free-form chip model.
- group: all three of ``group_name``/``group_headcount``/
  ``group_threshold`` must be present and valid, else the pod is treated
  as groupless (the reference's silent fallback);
  ``min_available = floor(threshold * headcount + 0.5)``.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field

from .. import constants as C

_NUMBER = re.compile(r"^\d+(\.\d+)?$")


class LabelError(ValueError):
    """A TPU workload with malformed labels (reference outcome 2)."""


@dataclass
class PodRequest:
    """Parsed per-pod scheduling state (≙ PodStatus, pod.go:219-231)."""

    namespace: str
    name: str
    uid: str = ""
    node_name: str = ""

    needs_tpu: bool = False
    priority: int = 0
    request: float = 0.0
    limit: float = 0.0
    memory: int = 0
    model: str = ""
    #: scheduling deadline (seconds after submit/requeue); 0 = none —
    #: past it the dispatcher resolves the pod "timed-out" instead of
    #: retrying forever (sharedtpu/deadline, doc/health.md)
    deadline_s: float = 0.0
    #: workload class for SLO attribution / priority isolation
    #: (sharedtpu/class: latency | best-effort; absent = best-effort)
    tpu_class: str = "best-effort"
    #: parsed sharedtpu/slo objectives (list of obs.slo.SloSpec);
    #: declared for the pod's namespace at submit
    slo_specs: list = field(default_factory=list)

    group_name: str = ""
    headcount: int = 0
    group_rank: int = -1          # assigned at reserve, freed at reclaim
    threshold: float = 0.0
    min_available: int = 0

    # assigned at reserve / resync
    cells: list = field(default_factory=list)
    chip_ids: list[str] = field(default_factory=list)
    #: exact amounts booked, as (chip_id, compute, memory_bytes) — reclaim
    #: must mirror what reserve actually booked (a multi-chip pod books the
    #: leaf's *free* memory at bind time, not its full memory)
    bookings: list[tuple[str, float, int]] = field(default_factory=list)
    port: int = 0
    timestamp: float = 0.0        # first-seen time, set by the engine

    # observability: minted at submit, carried through the binding into
    # the isolation layer (obs/trace.py) — excluded from equality so
    # two parses of the same labels still compare equal
    trace_id: str = field(default="", compare=False)
    trace_span: object = field(default=None, compare=False, repr=False)

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    @property
    def multi_chip(self) -> bool:
        return self.request > 1.0

    @property
    def opportunistic(self) -> bool:
        return self.priority <= 0

    @property
    def group_key(self) -> str:
        return f"{self.namespace}/{self.group_name}" if self.group_name else ""


def _parse_priority(labels: dict) -> int:
    raw = labels.get(C.POD_PRIORITY, "")
    if raw == "":
        return 0
    try:
        p = int(raw)
    except ValueError:
        raise LabelError(f"{C.POD_PRIORITY} must be an integer, got {raw!r}")
    if p < -1 or p > 100:
        raise LabelError(f"{C.POD_PRIORITY} out of range [-1, 100]: {p}")
    return p


def _parse_number(labels: dict, key: str,
                  max_decimals: int | None = None,
                  quantize: bool = False) -> float | None:
    raw = labels.get(key)
    if raw is None:
        return None
    if not _NUMBER.fullmatch(str(raw)):
        raise LabelError(f"{key} is not a non-negative number: {raw!r}")
    if max_decimals is not None:
        # Trailing zeros carry no precision ("0.250" == 0.25) — count
        # significant fraction digits only.
        frac = str(raw).partition(".")[2].rstrip("0")
        if len(frac) > max_decimals:
            # Share precision is a centi-chip: the cell bookkeeping snaps
            # float residue at 1e-9 (topology.cell._snap), which is only
            # sound when requests carry bounded precision — and a
            # micro-fraction share is meaningless against a 300 ms
            # scheduling quantum anyway.
            if not quantize:
                raise LabelError(
                    f"{key} supports at most {max_decimals} decimal "
                    f"places: {raw!r}")
            # lenient path (resync of an already-RUNNING pod bound under
            # older rules): clamp rather than reject — losing the replay
            # would silently over-commit the chip the pod still uses
            return round(float(raw), max_decimals)
    return float(raw)


def parse_group_labels(labels: dict) -> tuple[str, int, float, int]:
    """``(name, headcount, threshold, min_available)``; all-zero when the
    pod is groupless or the group labels are malformed (the reference
    logs and degrades rather than rejecting — ``pod_group.go:86-117``)."""
    name = labels.get(C.POD_GROUP_NAME, "")
    if not name:
        return "", 0, 0.0, 0
    try:
        headcount = int(labels.get(C.POD_GROUP_HEADCOUNT, ""))
    except ValueError:
        return "", 0, 0.0, 0
    if headcount < 1:
        return "", 0, 0.0, 0
    try:
        threshold = float(labels.get(C.POD_GROUP_THRESHOLD, ""))
    except ValueError:
        return "", 0, 0.0, 0
    if threshold <= 0:
        return "", 0, 0.0, 0
    min_available = int(math.floor(threshold * headcount + 0.5))
    return name, headcount, threshold, min_available


def parse_pod_labels(namespace: str, name: str, labels: dict,
                     uid: str = "", node_name: str = "",
                     lenient: bool = False) -> PodRequest:
    """labels → :class:`PodRequest`; raises :class:`LabelError` on
    malformed TPU labels (``getPodLabels``, pod.go:207-327).

    ``lenient`` quantizes over-precise shares instead of rejecting —
    ONLY for resyncing already-bound pods (validation rules may have
    tightened since they were admitted; dropping their replay would
    over-commit the capacity they still hold)."""
    pr = PodRequest(namespace=namespace, name=name, uid=uid,
                    node_name=node_name)
    (pr.group_name, pr.headcount, pr.threshold,
     pr.min_available) = parse_group_labels(labels)
    pr.priority = _parse_priority(labels)
    # deadline is orthogonal to the TPU labels: a regular workload can
    # carry one too (the dispatcher is its queue either way)
    pr.deadline_s = _parse_number(labels, C.POD_DEADLINE) or 0.0

    # class + slo are likewise orthogonal: they shape observability and
    # (ROADMAP item 1) isolation tier, not placement
    raw_class = labels.get(C.POD_CLASS, "")
    if raw_class:
        if raw_class not in C.TPU_CLASSES:
            raise LabelError(f"{C.POD_CLASS} must be one of "
                             f"{C.TPU_CLASSES}, got {raw_class!r}")
        pr.tpu_class = raw_class
    raw_slo = labels.get(C.POD_SLO, "")
    if raw_slo:
        from ..obs.slo import SloError, parse_slo
        try:
            pr.slo_specs = parse_slo(raw_slo)
        except SloError as exc:
            raise LabelError(f"{C.POD_SLO}: {exc}")

    has_any = any(k in labels for k in
                  (C.POD_TPU_LIMIT, C.POD_TPU_REQUEST, C.POD_TPU_MEMORY))
    if not has_any:
        return pr  # regular workload

    limit = _parse_number(labels, C.POD_TPU_LIMIT, max_decimals=2,
                          quantize=lenient)
    if limit is None:
        raise LabelError(f"{C.POD_TPU_LIMIT} is required for TPU workloads")

    request = _parse_number(labels, C.POD_TPU_REQUEST, max_decimals=2,
                            quantize=lenient) or 0.0
    if request > limit:
        raise LabelError(f"tpu_request {request} > tpu_limit {limit}")
    if limit > 1.0:
        if limit != request:
            raise LabelError(
                f"whole-chip workloads need tpu_limit == tpu_request "
                f"({limit} != {request})")
        if not float(request).is_integer():
            raise LabelError(
                f"whole-chip tpu_request must be an integer, got {request}")

    if limit == 0.0 and request == 0.0:
        return pr  # regular workload after all

    raw_mem = labels.get(C.POD_TPU_MEMORY)
    memory = 0
    if raw_mem is not None:
        try:
            memory = int(raw_mem)
        except ValueError:
            raise LabelError(f"{C.POD_TPU_MEMORY} must be an integer byte "
                             f"count: {raw_mem!r}")
        if memory < 0:
            raise LabelError(f"{C.POD_TPU_MEMORY} must be >= 0: {memory}")

    pr.needs_tpu = True
    pr.limit = limit
    pr.request = request
    pr.memory = memory
    pr.model = labels.get(C.POD_TPU_MODEL, "")
    return pr
