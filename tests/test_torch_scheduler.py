"""The port's placement core against the JAX package's: label parses,
cell trees, the engine under seeded churn, preemption plans, the port
allocator and the distances, on the same inputs.

Mirrors ``tests/test_scheduler.py``, ``test_engine_fuzz.py``,
``test_topology.py``, ``test_bitmap.py`` and ``test_examples.py``. Both
engines run on one fake clock; trace ids are random and stay out of
every comparison. The JAX side must not dump its default flight recorder
(its retained dumps are what ``tests/test_ha.py`` counts).
"""

import dataclasses
import json
import random
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

from kubeshare_tpu import constants as JC
from kubeshare_tpu.obs import flight as jflight
from kubeshare_tpu.scheduler import engine as jengine
from kubeshare_tpu.scheduler import labels as jlabels
from kubeshare_tpu.topology import cell as jcell
from kubeshare_tpu.topology import cellconfig as jcellconfig
from kubeshare_tpu.topology import distance as jdistance
from kubeshare_tpu.topology.chip import ChipInfo as JChip
from kubeshare_tpu.topology.discovery import FakeTopology as JFake
from kubeshare_tpu.utils import bitmap as jbitmap
from kubeshare_tpu_torch import constants as C
from kubeshare_tpu_torch.scheduler import engine
from kubeshare_tpu_torch.scheduler import labels
from kubeshare_tpu_torch.topology import cell
from kubeshare_tpu_torch.topology import cellconfig
from kubeshare_tpu_torch.topology import distance
from kubeshare_tpu_torch.topology.chip import ChipInfo
from kubeshare_tpu_torch.utils import bitmap

REPO = Path(__file__).resolve().parent.parent
BATTERY = sorted((REPO / "examples" / "battery").glob("*.yaml"))
CONFIGS = sorted((REPO / "deploy" / "config").glob("*.yaml"))
GIB = 1024 ** 3
H100 = "NVIDIA-H100-80GB-HBM3"


@pytest.fixture(autouse=True)
def jax_recorder_quiet(monkeypatch):
    """Fail a test that made the JAX default flight recorder dump."""
    rec = jflight.default_recorder()
    fired = []
    real = rec.trigger
    monkeypatch.setattr(rec, "trigger",
                        lambda reason, **kw: fired.append(reason)
                        or real(reason, **kw))
    yield
    assert fired == []


# --- label parses ------------------------------------------------------------

def pod_view(pod) -> dict:
    """A PodRequest's fields, comparable across the packages."""
    out = {}
    for f in dataclasses.fields(pod):
        if f.name in ("trace_id", "trace_span", "cells"):
            continue
        value = getattr(pod, f.name)
        if f.name == "slo_specs":
            value = [s.to_dict() for s in value]
        out[f.name] = value
    out["cells"] = [c.id for c in pod.cells]
    return out


def parse_both(namespace, name, labels_, **kw):
    """(port outcome, JAX outcome): a pod view or ``("error", text)``."""
    out = []
    for mod in (labels, jlabels):
        try:
            out.append(pod_view(mod.parse_pod_labels(namespace, name,
                                                     labels_, **kw)))
        except mod.LabelError as e:
            out.append(("error", str(e)))
    return out


def pod_docs(path):
    for doc in yaml.safe_load_all(path.read_text()):
        if doc and doc.get("kind") == "Pod":
            yield doc


@pytest.mark.parametrize("path", BATTERY, ids=lambda p: p.name)
def test_battery_labels_parse_as_the_jax_parser_does(path):
    docs = list(pod_docs(path))
    assert docs
    for doc in docs:
        labels_ = {str(k): str(v) for k, v in
                   (doc["metadata"].get("labels") or {}).items()}
        mine, theirs = parse_both("default", doc["metadata"]["name"],
                                  labels_)
        assert mine == theirs


@pytest.mark.parametrize("labels_", [
    {C.POD_TPU_LIMIT: "0.5", C.POD_TPU_REQUEST: "0.25",
     C.POD_SLO: "grant-wait-p99<=50ms,availability>=99.9",
     C.POD_CLASS: "latency", C.POD_DEADLINE: "30"},
    {C.POD_TPU_LIMIT: "1", C.POD_SLO: "nonsense"},
    {C.POD_TPU_LIMIT: "1", C.POD_CLASS: "urgent"},
    {C.POD_TPU_LIMIT: "2", C.POD_TPU_REQUEST: "2", C.POD_GROUP_NAME: "g",
     C.POD_GROUP_HEADCOUNT: "3", C.POD_GROUP_THRESHOLD: "0.5"},
    {C.POD_TPU_LIMIT: "1", C.POD_GROUP_NAME: "g",
     C.POD_GROUP_HEADCOUNT: "x", C.POD_GROUP_THRESHOLD: "0.5"},
    {C.POD_TPU_LIMIT: "1.123"},
    {C.POD_TPU_LIMIT: "1", C.POD_TPU_MEMORY: "1e9"},
    {C.POD_TPU_LIMIT: "1", C.POD_DEADLINE: "-1"},
    {},
], ids=lambda d: ",".join(f"{k.split('/')[-1]}={v}" for k, v in d.items())
    or "none")
def test_label_corners_parse_as_the_jax_parser_does(labels_):
    for lenient in (False, True):
        mine, theirs = parse_both("ns", "p", labels_, lenient=lenient)
        assert mine == theirs


def test_label_vocabulary_is_the_jax_packages():
    """Every name the port shares with the JAX constants has its value,
    and the placement path's names are all there."""
    shared = [n for n in dir(JC) if n.isupper() and hasattr(C, n)]
    assert {n: getattr(C, n) for n in shared} == {
        n: getattr(JC, n) for n in shared}
    for name in ("POD_TPU_REQUEST", "POD_GROUP_RANK", "POD_MANAGER_PORT",
                 "POD_MANAGER_PORT_START", "POD_MANAGER_PORT_RANGE",
                 "ENV_MESH_SHAPE", "ENV_SCHEDULER_IP",
                 "NODE_SHARED_TPU_LABEL", "LEASE_TTL_S", "REGISTRY_PORT",
                 "SCHEDULER_PORT", "HEALTH_QUARANTINE_S"):
        assert name in shared


# --- cell trees --------------------------------------------------------------

def tree_view(c) -> dict:
    return {k: getattr(c, k) for k in (
        "cell_type", "id", "level", "higher_than_node", "is_node",
        "priority", "leaf_cell_type", "leaf_cell_number", "chip_id",
        "coords", "available", "available_whole_cell", "free_memory",
        "full_memory", "node", "healthy", "state")} | {
        "children": [tree_view(k) for k in c.children]}


def free_list_view(free_list) -> dict:
    return {t: {lvl: [tree_view(r) for r in roots]
                for lvl, roots in levels.items()}
            for t, levels in free_list.items()}


def config_view(cfg) -> dict:
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def built(mod_cfg, mod_cell, cfg):
    elements, prio = mod_cell.build_cell_chains(cfg.cell_types)
    free = mod_cell.CellConstructor(elements, cfg.cells).build()
    return ({k: dataclasses.asdict(v) for k, v in elements.items()}, prio,
            free)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_config_files_build_the_jax_cell_trees(path):
    mine = cellconfig.load_config(str(path))
    theirs = jcellconfig.load_config(str(path))
    assert config_view(mine) == config_view(theirs)
    m_el, m_prio, m_free = built(cellconfig, cell, mine)
    t_el, t_prio, t_free = built(jcellconfig, jcell, theirs)
    assert (m_el, m_prio) == (t_el, t_prio)
    assert free_list_view(m_free) == free_list_view(t_free)


def h100_fleet(nodes: int, per_node: int = 8, prefix: str = "gpu-node"):
    """A coordless fleet of H100-like nodes, as CUDA discovery reports
    them: no mesh coords, no slice id."""
    return [JChip(chip_id=f"{H100}-{prefix}-{n}-{i}", index=i,
                  host=f"{prefix}-{n}", model=H100, memory=80 * GIB)
            for n in range(nodes) for i in range(per_node)]


FLEETS = {
    "2x2x2": lambda: JFake(hosts=2, mesh=(2, 2)).chips(),
    "coords": lambda: JFake(hosts=4, mesh=(2, 2), hosts_per_slice=2,
                            model="TPU-v5e", memory=16 * GIB).chips(),
    "h100": lambda: h100_fleet(3),
}
MIXED = lambda: (JFake(hosts=2, mesh=(2, 2)).chips()            # noqa: E731
                 + JFake(hosts=1, mesh=(2, 4), model="TPU-v5e",
                         host_prefix="v5e-host", memory=16 * GIB).chips()
                 + h100_fleet(2))


def port_chips(jchips) -> list:
    return [ChipInfo.from_labels(c.to_labels()) for c in jchips]


@pytest.mark.parametrize("fleet", sorted(FLEETS) + ["mixed"])
def test_config_from_chips_builds_the_jax_cell_trees(fleet):
    jchips = FLEETS[fleet]() if fleet != "mixed" else MIXED()
    chips = port_chips(jchips)
    mine = cellconfig.config_from_chips(chips)
    theirs = jcellconfig.config_from_chips(jchips)
    assert config_view(mine) == config_view(theirs)
    m_el, m_prio, m_free = built(cellconfig, cell, mine)
    t_el, t_prio, t_free = built(jcellconfig, jcell, theirs)
    assert (m_el, m_prio) == (t_el, t_prio)
    by_node, jby_node = {}, {}
    for c, jc in zip(chips, jchips):
        by_node.setdefault(c.host, {}).setdefault(c.model, []).append(c)
        jby_node.setdefault(jc.host, {}).setdefault(jc.model, []).append(jc)
    m_leaves, t_leaves = {}, {}
    for node in sorted(by_node):
        cell.set_node_status(m_free, by_node, m_leaves, node, True)
        jcell.set_node_status(t_free, jby_node, t_leaves, node, True)
    assert sorted(m_leaves) == sorted(t_leaves) == sorted(
        c.chip_id for c in chips)
    assert free_list_view(m_free) == free_list_view(t_free)


def test_a_chip_record_round_trips_through_its_labels():
    for jc in MIXED():
        c = ChipInfo.from_labels(jc.to_labels())
        assert c.to_labels() == jc.to_labels()
        assert dataclasses.asdict(c) == dataclasses.asdict(jc)


# --- the engine under churn --------------------------------------------------

def fleet_dict(jchips, healthy=None, drop=()):
    """``{node: (chips, healthy)}`` for each package's ``set_fleet``."""
    healthy = healthy or {}
    out, jout = {}, {}
    for jc in jchips:
        if jc.host in drop:
            continue
        jout.setdefault(jc.host, ([], healthy.get(jc.host, True)))[0].append(
            jc)
        out.setdefault(jc.host, ([], healthy.get(jc.host, True)))[0].append(
            ChipInfo.from_labels(jc.to_labels()))
    return out, jout


def binding_view(b) -> dict:
    out = dataclasses.asdict(b)
    out["chip_coords"] = [tuple(c) for c in out["chip_coords"]]
    out["env"] = b.env
    out["annotations"] = b.annotations
    return out


def leaf_view(eng) -> dict:
    return {cid: (leaf.available, leaf.free_memory, leaf.healthy, leaf.node,
                  leaf.id)
            for cid, leaf in sorted(eng.leaf_cells.items())}


def state_view(eng) -> dict:
    return {
        "leaves": leaf_view(eng),
        "ports": {n: b.count() for n, b in sorted(eng.ports.items())},
        "nodes": list(eng.nodes),
        "health": dict(sorted(eng.node_health.items())),
        "pods": {k: (p.node_name, p.chip_ids, p.port, p.group_rank,
                     p.bookings, p.memory)
                 for k, p in sorted(eng.pod_status.items())},
        "groups": len(eng.groups),
    }


def random_labels(rng, i, models):
    kind = rng.randrange(9)
    if kind == 0:        # fractional share
        req = rng.choice(["0.2", "0.25", "0.3", "0.5"])
        return {C.POD_TPU_REQUEST: req,
                C.POD_TPU_LIMIT: rng.choice(["1.0", req]),
                C.POD_PRIORITY: str(rng.choice([0, 0, 10, 50]))}
    if kind == 1:        # with memory, or a memory no device has
        return {C.POD_TPU_REQUEST: "0.5", C.POD_TPU_LIMIT: "1.0",
                C.POD_TPU_MEMORY: str(rng.choice([4, 20, 200]) * GIB),
                C.POD_PRIORITY: "20"}
    if kind == 2:        # whole chip
        return {C.POD_TPU_REQUEST: "1", C.POD_TPU_LIMIT: "1",
                C.POD_PRIORITY: str(rng.choice([0, 30]))}
    if kind == 3:        # several chips
        n = rng.choice(["2", "4"])
        return {C.POD_TPU_REQUEST: n, C.POD_TPU_LIMIT: n,
                C.POD_PRIORITY: str(rng.choice([0, 40]))}
    if kind == 4:        # model pin, known or not
        return {C.POD_TPU_REQUEST: "0.5", C.POD_TPU_LIMIT: "0.5",
                C.POD_TPU_MODEL: rng.choice(models + ["no-such-model"])}
    if kind == 5:        # whole-chip gang member (may be planned)
        return {C.POD_TPU_REQUEST: rng.choice(["1", "2"]),
                C.POD_TPU_LIMIT: "1" if rng.random() < 0.5 else "2",
                C.POD_PRIORITY: "10", C.POD_GROUP_NAME: f"g{i % 4}",
                C.POD_GROUP_HEADCOUNT: "2", C.POD_GROUP_THRESHOLD: "1.0"}
    if kind == 6:        # partial fractional gang
        return {C.POD_TPU_REQUEST: "0.3", C.POD_TPU_LIMIT: "1.0",
                C.POD_PRIORITY: "10", C.POD_GROUP_NAME: f"f{i % 3}",
                C.POD_GROUP_HEADCOUNT: "3", C.POD_GROUP_THRESHOLD: "0.67"}
    if kind == 7:        # regular workload or mislabelled
        return rng.choice([{}, {C.POD_TPU_REQUEST: "0.5"},
                           {C.POD_TPU_LIMIT: "0.5",
                            C.POD_TPU_REQUEST: "0.7"}])
    return {C.POD_TPU_REQUEST: "0.5", C.POD_TPU_LIMIT: "1.0",
            C.POD_PRIORITY: "-1"}


def outcome(fn, *args):
    """One engine call: ``("ok", result)`` or ``("error", type, text)``."""
    try:
        return ("ok", fn(*args))
    except (engine.Unschedulable, labels.LabelError,
            jengine.Unschedulable, jlabels.LabelError) as e:
        return ("error", type(e).__name__, str(e))


class Pair:
    """The port's and the JAX engine on one fake clock."""

    def __init__(self, jchips):
        self.now = [0.0]
        self.e = engine.SchedulerEngine(clock=lambda: self.now[0])
        self.j = jengine.SchedulerEngine(clock=lambda: self.now[0])
        self.jchips = jchips
        self.set_fleet()

    def set_fleet(self, **kw):
        mine, theirs = fleet_dict(self.jchips, **kw)
        self.e.set_fleet(mine)
        self.j.set_fleet(theirs)

    def check_same_state(self):
        assert state_view(self.e) == state_view(self.j)

    def filter_and_score(self, key):
        pod, jpod = self.e.pod_status[key], self.j.pod_status[key]
        for node in self.j.nodes:
            fit = self.e.filter(pod, node)
            assert fit == self.j.filter(jpod, node)
            if fit[0]:
                mine, theirs = self.e.score(pod, node), self.j.score(jpod,
                                                                     node)
                assert abs(mine - theirs) <= 1e-12, (node, mine, theirs)

    def submit_schedule(self, ns, name, labels_):
        """Submit and schedule on both sides: True bound, False
        unschedulable (same text), None refused at parse (same text)."""
        mine = outcome(self.e.submit, ns, name, labels_)
        theirs = outcome(self.j.submit, ns, name, labels_)
        assert mine[0] == theirs[0]
        if mine[0] == "error":
            assert mine[1:] == theirs[1:]
            return None
        key = f"{ns}/{name}"
        self.filter_and_score(key)
        pod, jpod = self.e.pod_status[key], self.j.pod_status[key]
        mine = outcome(self.e.schedule, pod)
        theirs = outcome(self.j.schedule, jpod)
        assert mine[0] == theirs[0], (mine, theirs)
        if mine[0] == "error":
            assert mine[1:] == theirs[1:]
            return False
        assert binding_view(mine[1]) == binding_view(theirs[1])
        assert self.e.permit(pod) == self.j.permit(jpod)
        return True


def churn(pair, rng, ops, models):
    for i in range(ops):
        pair.now[0] += 1.0
        r = rng.random()
        keys = sorted(pair.j.pod_status)
        if r < 0.5 or not keys:
            ns = rng.choice(["a", "b"])
            labels_ = random_labels(rng, i, models)
            name = (f"g{i % 4}-{rng.randrange(2)}"
                    if labels_.get(C.POD_GROUP_NAME, "").startswith("g")
                    else f"p-{i}")
            if (pair.submit_schedule(ns, name, labels_) is False
                    and rng.random() < 0.5):
                pair.e.delete_pod(f"{ns}/{name}")
                pair.j.delete_pod(f"{ns}/{name}")
        elif r < 0.68:
            key = rng.choice(keys)
            pair.e.delete_pod(key)
            pair.j.delete_pod(key)
        elif r < 0.76:
            hosts = sorted({c.host for c in pair.jchips})
            choice = rng.random()
            if choice < 0.4:
                pair.set_fleet(drop=(rng.choice(hosts),))
            elif choice < 0.7:
                pair.set_fleet(healthy={rng.choice(hosts): False})
            else:
                pair.set_fleet()
        elif r < 0.84:
            node = rng.choice(sorted({c.host for c in pair.jchips}))
            healthy = rng.random() < 0.6
            pair.e.set_node_health(node, healthy)
            pair.j.set_node_health(node, healthy)
        elif r < 0.92:
            key = rng.choice(keys)
            pod, jpod = pair.e.pod_status[key], pair.j.pod_status[key]
            assert pair.e.find_preemption(pod) == pair.j.find_preemption(jpod)
        elif r < 0.96:
            key = rng.choice(keys)
            pod, jpod = pair.e.pod_status[key], pair.j.pod_status[key]
            assert pair.e.unreserve(pod) == pair.j.unreserve(jpod)
        else:
            # a restart's resync of one bound pod from its pod object
            bound = [k for k in keys if pair.j.pod_status[k].node_name]
            if bound:
                key = rng.choice(bound)
                jpod = pair.j.pod_status[key]
                ann = {JC.POD_TPU_CHIP_ID: ",".join(jpod.chip_ids),
                       JC.POD_TPU_MEMORY: str(jpod.memory),
                       JC.POD_MANAGER_PORT: str(jpod.port)}
                if jpod.group_rank >= 0:
                    ann[JC.POD_GROUP_RANK] = str(jpod.group_rank)
                lbl = labels_of(jpod)
                ns, _, name = key.partition("/")
                node = jpod.node_name
                mine = pair.e.resync_bound(ns, name, lbl, ann, node)
                theirs = pair.j.resync_bound(ns, name, lbl, ann, node)
                assert pod_view(mine) == pod_view(theirs)
        pair.check_same_state()


def labels_of(pod) -> dict:
    """The labels a parsed pod came from (enough to re-parse it)."""
    out = {C.POD_TPU_REQUEST: str(pod.request),
           C.POD_TPU_LIMIT: str(pod.limit),
           C.POD_PRIORITY: str(pod.priority)}
    if pod.model:
        out[C.POD_TPU_MODEL] = pod.model
    if pod.group_name:
        out.update({C.POD_GROUP_NAME: pod.group_name,
                    C.POD_GROUP_HEADCOUNT: str(pod.headcount),
                    C.POD_GROUP_THRESHOLD: str(pod.threshold)})
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_engines_agree_under_seeded_churn(fleet, seed):
    jchips = FLEETS[fleet]()
    pair = Pair(jchips)
    pair.check_same_state()
    models = sorted({c.model for c in jchips})
    churn(pair, random.Random(seed), 300, models)
    # everything deleted: both fleets exactly fresh
    for key in sorted(pair.j.pod_status):
        pair.e.delete_pod(key)
        pair.j.delete_pod(key)
    pair.set_fleet()
    pair.check_same_state()
    for leaf in pair.e.leaf_cells.values():
        assert leaf.available == leaf.leaf_cell_number
        assert leaf.free_memory == leaf.full_memory


@pytest.mark.parametrize("fleet", sorted(FLEETS) + ["mixed"])
def test_preemption_plans_match_the_jax_engine(fleet):
    """Opportunistic filler everywhere, then guarantee pods that only
    fit by eviction: the same victims on the same node, or None."""
    jchips = FLEETS[fleet]() if fleet != "mixed" else MIXED()
    pair = Pair(jchips)
    rng = random.Random(7)
    i = 0
    for _ in range(4 * len(jchips)):
        i += 1
        req = rng.choice(["0.25", "0.5", "1"])
        pair.submit_schedule("fill", f"o-{i}", {
            C.POD_TPU_REQUEST: req, C.POD_TPU_LIMIT: req,
            C.POD_PRIORITY: "0"})
    asks = [("0.5", None), ("1", None), ("2", None), ("4", None),
            ("0.75", None)] + [("1", m) for m in sorted(
                {c.model for c in jchips})]
    for req, model in asks:
        i += 1
        labels_ = {C.POD_TPU_REQUEST: req,
                   C.POD_TPU_LIMIT: req if float(req) > 1 else "1",
                   C.POD_PRIORITY: "50"}
        if model:
            labels_[C.POD_TPU_MODEL] = model
        pair.e.submit("g", f"q-{i}", labels_)
        pair.j.submit("g", f"q-{i}", labels_)
        key = f"g/q-{i}"
        mine = pair.e.find_preemption(pair.e.pod_status[key])
        theirs = pair.j.find_preemption(pair.j.pod_status[key])
        assert mine == theirs
        pair.check_same_state()


def test_h100_pods_bind_on_a_flat_gpu_node():
    """A GPU node has no mesh: a two-device pod takes two devices of one
    node in the plain env form, as the JAX engine gives it."""
    pair = Pair(h100_fleet(1))
    assert pair.e.carve_annotation("gpu-node-0", []) == {}
    labels_ = {C.POD_TPU_REQUEST: "2", C.POD_TPU_LIMIT: "2"}
    assert pair.submit_schedule("ns", "two", labels_)
    pod = pair.e.pod_status["ns/two"]
    assert len(pod.chip_ids) == 2 and pod.port == 0
    assert {pod.chip_ids[0].rsplit("-", 2)[0]} == {f"{H100}-gpu-node"}


# --- bitmap, distances -------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_port_bitmap_allocates_as_the_jax_one(seed):
    rng = random.Random(seed)
    mine, theirs = bitmap.RRBitmap(37), jbitmap.RRBitmap(37)
    for _ in range(400):
        op = rng.random()
        if op < 0.5:
            assert mine.find_next_and_set() == theirs.find_next_and_set()
        else:
            pos = rng.randrange(37)
            (mine.mask if op < 0.6 else mine.unmask)(pos)
            (theirs.mask if op < 0.6 else theirs.unmask)(pos)
        assert mine.count() == theirs.count()
        probe = rng.randrange(37)
        assert mine.is_masked(probe) == theirs.is_masked(probe)
    for bad in (-1, 37):
        with pytest.raises(IndexError):
            mine.mask(bad)
    with pytest.raises(ValueError):
        bitmap.Bitmap(0)


def test_distances_match_the_jax_ones():
    rng = random.Random(3)
    for _ in range(300):
        n_a, n_b = rng.choice([(2, 2), (3, 3), (2, 3), (3, 1)])
        a = tuple(rng.randrange(8) for _ in range(n_a))
        b = tuple(rng.randrange(8) for _ in range(n_b))
        shape = rng.choice([None, (4, 4), (8, 8, 8), (2,)])
        assert distance.ici_distance(a, b, shape) == \
            jdistance.ici_distance(a, b, shape)
    ids = ["1/node-a/3", "1/node-b/3", "2/4", "slice/1/2/3", "x", "7"]
    for x in ids:
        for y in ids:
            assert distance.cell_id_distance(x, y) == \
                jdistance.cell_id_distance(x, y)


# --- no PyYAML ---------------------------------------------------------------

def test_the_placement_path_runs_without_yaml():
    """The card's machine has no PyYAML: the engine, the collector and
    configd import without it, an H100 fleet is scheduled, and only
    ``load_config`` asks for it."""
    code = f"""
import sys
sys.modules["yaml"] = None
from kubeshare_tpu_torch import constants as C
from kubeshare_tpu_torch.nodeagent import configd
from kubeshare_tpu_torch.scheduler import SchedulerEngine
from kubeshare_tpu_torch.telemetry import collector, registry
from kubeshare_tpu_torch.topology import cellconfig
from kubeshare_tpu_torch.topology.chip import ChipInfo
eng = SchedulerEngine(clock=lambda: 0.0)
eng.add_node("gpu-0", [ChipInfo(f"{H100}-gpu-0-{{i}}", i, "gpu-0",
                                "{H100}", {80 * GIB}) for i in range(8)])
b = eng.schedule(eng.submit("ns", "p", {{C.POD_TPU_REQUEST: "0.5",
                                         C.POD_TPU_LIMIT: "1.0"}}))
assert b.chip_ids[0].startswith("{H100}-gpu-0-") and b.port == 50051, b
try:
    cellconfig.load_config("{CONFIGS[0]}")
except ImportError:
    print("load_config needs yaml")
assert not any(m == "torch" or m.startswith(("jax", "kubeshare_tpu."))
               for m in sys.modules), sorted(sys.modules)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["load_config", "needs", "yaml", "ok"]
