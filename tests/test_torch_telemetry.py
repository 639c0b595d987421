"""The port's telemetry plane against the JAX package's: the registry over
HTTP, its journal, its replication stream, the time-series store, the
heartbeat, the collector and the aggregator, on the same inputs.

Mirrors ``tests/test_telemetry.py`` and ``tests/test_tsdb.py``. The
registries run on fake clocks stepped together, so timestamps agree; a
stream id is per process and stays out of the comparisons.
"""

import random
import time
import urllib.request

import pytest

from kubeshare_tpu.obs import flight as jflight
from kubeshare_tpu.obs.tsdb import TimeSeriesStore as JStore
from kubeshare_tpu.scheduler.engine import SchedulerEngine as JEngine
from kubeshare_tpu.telemetry import aggregator as jaggregator
from kubeshare_tpu.telemetry import collector as jcollector
from kubeshare_tpu.telemetry import heartbeat as jheartbeat
from kubeshare_tpu.telemetry import registry as jregistry
from kubeshare_tpu_torch import constants as C
from kubeshare_tpu_torch.obs.metrics import lint_exposition
from kubeshare_tpu_torch.obs.tsdb import TimeSeriesStore
from kubeshare_tpu_torch.scheduler.engine import SchedulerEngine
from kubeshare_tpu_torch.telemetry import aggregator, collector, heartbeat
from kubeshare_tpu_torch.telemetry import registry
from kubeshare_tpu_torch.topology.discovery import parse_fake_spec

GIB = 1024 ** 3


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


class Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def capacity_of(spec: str) -> dict:
    by_host = {}
    for chip in parse_fake_spec(spec).chips():
        by_host.setdefault(chip.host, []).append(chip.to_labels())
    return by_host


def record(node, chip, port=50051):
    return {"node": node, "uid": "", "group_name": "", "headcount": "0",
            "threshold": "0.0", "priority": "0", "request": "0.5",
            "limit": "1.0", "memory": str(8 * GIB), "model": "TPU-v4",
            "cell_id": "1/x/1", "chip_id": chip, "port": str(port)}


REGISTRY_FAMILIES = ("tpu_capacity", "tpu_requirement",
                     "kubeshare_lease_age_seconds")


def own_lines(text: str) -> list:
    return [line for line in text.splitlines()
            if line.split("{")[0].split(" ")[0] in REGISTRY_FAMILIES
            or any(line.startswith(f"# {k} {f} ") for f in REGISTRY_FAMILIES
                   for k in ("HELP", "TYPE"))]


def drive(client, reg, clock, fenced_error) -> dict:
    """One script of registry calls over HTTP; every answer, in order."""
    out = []
    for node, chips in capacity_of("2:2x2").items():
        client.put_capacity(node, chips, healthy=node.endswith("0"))
        clock.t += 1
    client.put_pod("ns/a", record("tpu-host-0", "TPU-v4-tpu-host-0-1"))
    client.put_pod("ns/b", record("tpu-host-1", "TPU-v4-tpu-host-1-0",
                                  50052))
    clock.t += 1
    out.append(client.pods())
    out.append(client.pods(node="tpu-host-1"))
    client.drop_pod("ns/b")
    out.append(client.put_lease("tpu-host-0", 1, ttl_s=5.0))
    out.append(client.put_lease("tpu-host-0", 1, ttl_s=5.0))   # zombie
    out.append(client.put_lease("tpu-host-1", 3, ttl_s=2.0))
    clock.t += 3
    out.append(client.leases())
    out.append(reg.stale_nodes())
    out.append(client.acquire_leader("scheduler", "sched-a", 1, ttl_s=5.0))
    out.append(client.acquire_leader("scheduler", "sched-b", 1, ttl_s=5.0))
    out.append(client.acquire_leader("scheduler", "sched-a", 1, ttl_s=5.0))
    out.append(client.leader("scheduler"))
    out.append(client.leader("nobody"))
    client.put_pod("ns/c", record("tpu-host-0", "TPU-v4-tpu-host-0-2"),
                   fence=1)
    try:
        client.put_pod("ns/d", record("tpu-host-0", "TPU-v4-tpu-host-0-3"),
                       fence=0)
        out.append("accepted")
    except fenced_error as e:
        out.append(("fenced", e.fence, e.current))
    try:
        client.drop_pod("ns/c", fence=0)
        out.append("accepted")
    except fenced_error as e:
        out.append(("fenced", e.fence, e.current))
    client.drop_capacity("tpu-host-1")
    client.drop_lease("tpu-host-1")
    out.append(client.capacity())
    out.append(client.pods())
    rep = client.replicate(0)
    out.append({k: v for k, v in rep.items() if k != "stream"})
    out.append({k: v for k, v in client.replicate(rep["head"] - 2,
                                                  stream=rep["stream"]
                                                  ).items()
                if k != "stream"})
    out.append({k: v for k, v in client.replicate(0, stream="other").items()
                if k != "stream"})
    out.append({k: v for k, v in client.replication().items()
                if k != "stream"})
    out.append(own_lines(client.metrics()))
    return out


def served(mod, clock):
    reg = mod.TelemetryRegistry(clock=clock)
    reg.serve(port=0)
    return reg


def test_registry_over_http_answers_as_the_jax_registry():
    cm, cj = Clock(), Clock()
    mine, theirs = served(registry, cm), served(jregistry, cj)
    try:
        got = drive(registry.RegistryClient("127.0.0.1", mine.port), mine,
                    cm, registry.FencedWriteError)
        want = drive(jregistry.RegistryClient("127.0.0.1", theirs.port),
                     theirs, cj, jregistry.FencedWriteError)
        assert got == want
        assert mine.fence_log == theirs.fence_log
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{mine.port}/metrics", timeout=5).read()
        assert lint_exposition(body.decode()) == []
    finally:
        mine.close()
        theirs.close()


def test_each_client_speaks_to_the_other_registry():
    """The wire is one: the port's client on the JAX registry and the JAX
    client on the port's give the same answers."""
    cm, cj = Clock(), Clock()
    mine, theirs = served(registry, cm), served(jregistry, cj)
    try:
        got = drive(registry.RegistryClient("127.0.0.1", theirs.port),
                    theirs, cj, registry.FencedWriteError)
        want = drive(jregistry.RegistryClient("127.0.0.1", mine.port),
                     mine, cm, jregistry.FencedWriteError)
        assert got == want
    finally:
        mine.close()
        theirs.close()


def state_of(reg) -> dict:
    return {"capacity": reg.capacity(), "pods": reg.pods(),
            "leases": reg.leases(now=0.0),
            "leader": reg.leader("scheduler"),
            "cursor": (reg._repl_cursor, reg._repl_stream)}


def write_history(reg, clock):
    for node, chips in capacity_of("3:2x2").items():
        reg.put_capacity(node, chips)
        clock.t += 1
    for i in range(5):
        reg.put_pod(f"ns/p{i}", record("tpu-host-0",
                                       f"TPU-v4-tpu-host-0-{i % 4}",
                                       50051 + i))
    reg.drop_pod("ns/p3")
    reg.drop_capacity("tpu-host-2")
    reg.put_lease("tpu-host-0", 4, ttl_s=3.0)
    reg.put_lease("tpu-host-1", 2)
    reg.drop_lease("tpu-host-1")
    reg.acquire_leader("scheduler", "sched-a", 7)
    reg.put_pod("ns/fenced", record("tpu-host-1", "TPU-v4-tpu-host-1-0"),
                fence=7)
    # a follower's cursor record, as replication writes it
    reg.apply_replicated([{"op": "put_pod", "key": "ns/r",
                           "record": record("tpu-host-0", "x")}], 41,
                         "leader.1")


@pytest.mark.parametrize("compact_every", [1000, 4])
def test_a_jax_journal_replays_into_the_port_registry(tmp_path,
                                                      compact_every):
    path = tmp_path / "registry.jsonl"
    clock = Clock()
    writer = jregistry.TelemetryRegistry(journal=path, clock=clock,
                                         compact_every=compact_every)
    write_history(writer, clock)
    writer._journal.close()
    mine = registry.TelemetryRegistry(journal=path, clock=lambda: 0.0)
    theirs = jregistry.TelemetryRegistry(journal=path, clock=lambda: 0.0)
    try:
        assert state_of(mine) == state_of(theirs)
        assert state_of(mine)["cursor"] == (41, "leader.1")
        assert "ns/fenced" in mine.pods() and "ns/p3" not in mine.pods()
    finally:
        mine._journal.close()
        theirs._journal.close()


def test_the_port_journal_replays_into_the_jax_registry(tmp_path):
    path = tmp_path / "registry.jsonl"
    clock = Clock()
    writer = registry.TelemetryRegistry(journal=path, clock=clock,
                                        compact_every=5)
    write_history(writer, clock)
    writer._journal.close()
    theirs = jregistry.TelemetryRegistry(journal=path, clock=lambda: 0.0)
    mine = registry.TelemetryRegistry(journal=path, clock=lambda: 0.0)
    try:
        assert state_of(mine) == state_of(theirs)
    finally:
        mine._journal.close()
        theirs._journal.close()


def test_a_jax_replication_stream_applies_to_a_port_follower():
    clock = Clock()
    leader = jregistry.TelemetryRegistry(clock=clock)
    write_history(leader, clock)
    batch = leader.replicate(0)
    results = []
    for mod in (registry, jregistry):
        foll = mod.TelemetryRegistry(clock=lambda: 0.0)
        foll.set_follower("leader:9006")
        with pytest.raises(mod.NotLeaderError):
            foll.put_lease("tpu-host-0", 99)
        applied = foll.apply_replicated(batch["ops"], batch["head"],
                                        batch["stream"], batch["rebase"])
        results.append((applied, state_of(foll),
                        {k: v for k, v in foll.replication_status().items()
                         if k != "stream"}))
        rebase = leader.replicate(0, stream="elsewhere")
        foll.apply_replicated(rebase["ops"], rebase["head"],
                              rebase["stream"], rebase["rebase"])
        foll.promote()
        results.append(state_of(foll))
    assert results[:2] == results[2:]


# --- time-series store -------------------------------------------------------

def exposition(rng, i) -> str:
    lines = ["# TYPE kubeshare_rpc_total counter"]
    for op in ("put", "get"):
        lines.append(f'kubeshare_rpc_total{{op="{op}"}} '
                     f"{float(10 * i + rng.randrange(5))}")
    lines.append("# TYPE kubeshare_pending gauge")
    lines.append(f"kubeshare_pending {float(rng.randrange(9))}")
    lines.append("# TYPE kubeshare_lat_seconds histogram")
    total = 0
    for le in ("0.01", "0.1", "1", "+Inf"):
        total += rng.randrange(4) + i
        lines.append(f'kubeshare_lat_seconds_bucket{{le="{le}"}} '
                     f"{float(total)}")
    lines.append(f"kubeshare_lat_seconds_sum {float(i)}")
    lines.append(f"kubeshare_lat_seconds_count {float(total)}")
    return "\n".join(lines) + "\n"


QUERIES = [
    ("kubeshare_pending", {"agg": "sum"}),
    ("kubeshare_pending", {"agg": "avg", "by": ("instance",)}),
    ("kubeshare_pending", {"agg": "max"}),
    ("kubeshare_pending", {"agg": "min", "window_s": 5.0}),
    ("kubeshare_rpc_total", {"agg": "rate", "by": ("op",)}),
    ("kubeshare_rpc_total", {"agg": "increase",
                             "matchers": {"op": "put"}}),
    ("kubeshare_lat_seconds", {"agg": "quantile", "q": 0.9}),
    ("kubeshare_lat_seconds", {"agg": "quantile", "q": 0.5,
                               "by": ("instance",)}),
]


@pytest.mark.parametrize("seed", [0, 1])
def test_tsdb_queries_match_the_jax_store(seed):
    rng = random.Random(seed)
    kw = dict(raw_capacity=16, tier_resolution_s=5.0, stale_after_s=20.0,
              max_series=40)
    mine, theirs = TimeSeriesStore(**kw), JStore(**kw)
    for i in range(60):
        inst = f"proxy:{rng.randrange(4)}"
        text = exposition(rng, i)
        now = 1000.0 + i * 1.5
        assert (mine.ingest(inst, "chipproxy", exposition=text, now=now)
                == theirs.ingest(inst, "chipproxy", exposition=text,
                                 now=now))
        if i == 40:
            mine.mark_stale("proxy:3")
            theirs.mark_stale("proxy:3")
    now = 1000.0 + 60 * 1.5
    for family, q in QUERIES:
        assert (mine.query(family, now=now, **q)
                == theirs.query(family, now=now, **q)), (family, q)
    assert (mine.range_query("kubeshare_pending", agg="sum", step_s=10.0,
                             span_s=60.0, now=now)
            == theirs.range_query("kubeshare_pending", agg="sum",
                                  step_s=10.0, span_s=60.0, now=now))
    assert mine.instances(now=now) == theirs.instances(now=now)
    assert mine.families() == theirs.families()
    assert mine.stats() == theirs.stats()


def test_a_registry_push_and_query_match_the_jax_registry():
    answers = []
    for mod in (registry, jregistry):
        clock = Clock(2000.0)
        reg = mod.TelemetryRegistry(clock=clock)
        reg.serve(port=0)
        try:
            client = mod.RegistryClient("127.0.0.1", reg.port)
            rng = random.Random(5)
            for i in range(6):
                clock.t += 2
                client.push_metrics(f"p:{i % 2}", "chipproxy",
                                    exposition=exposition(rng, i))
            client.mark_stale("p:1")
            answers.append((client.query("kubeshare_pending", agg="sum"),
                            client.instances()))
        finally:
            reg.close()
    assert answers[0] == answers[1]


# --- heartbeat ---------------------------------------------------------------

def test_heartbeats_take_over_as_the_jax_heartbeater_does():
    runs = []
    for reg_mod, hb_mod in ((registry, heartbeat), (jregistry, jheartbeat)):
        reg = reg_mod.TelemetryRegistry(clock=Clock())
        reg.put_lease("n0", 5)                 # a predecessor's lease
        first = hb_mod.Heartbeater(reg, "n0", ttl_s=3.0)
        steps = [first.beat_once(), first.epoch]
        second = hb_mod.Heartbeater(reg, "n0", ttl_s=3.0)   # a restart
        steps += [second.beat_once(), second.epoch]
        steps += [first.beat_once(), first.epoch]           # the zombie
        steps += [reg.leases(now=100.0)["n0"], first.period_s]
        runs.append(steps)
    assert runs[0] == runs[1]
    assert runs[0][:2] == [True, 7]


def test_a_heartbeater_thread_keeps_the_lease_fresh():
    reg = registry.TelemetryRegistry()
    hb = heartbeat.Heartbeater(reg, "n1", ttl_s=0.3).start()
    try:
        deadline = time.monotonic() + 5.0
        while hb.beats_sent < 3 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert hb.beats_sent >= 3
        assert reg.stale_nodes() == []
    finally:
        hb.stop()


# --- collector ---------------------------------------------------------------

def test_the_fake_collector_publishes_the_jax_capacity(monkeypatch):
    monkeypatch.setenv("KUBESHARE_TPU_FAKE_TOPOLOGY", "2:2x4@TPU-v5e")
    entries = []
    for reg_mod, col_mod in ((registry, collector), (jregistry, jcollector)):
        reg = reg_mod.TelemetryRegistry(clock=Clock())
        col = col_mod.CapacityCollector(reg, node="tpu-host-1",
                                        backend="fake", lease_ttl_s=2.0)
        assert col.collect_once()
        entries.append((reg.capacity(), reg.leases(now=100.0),
                        [c.to_labels() for c in col.last_chips]))
        col.stop()
        entries.append((reg.capacity(), reg.leases()))
    assert entries[0] == entries[2] and entries[1] == entries[3]
    assert entries[1] == ({}, {})
    assert len(entries[0][0]["tpu-host-1"]["chips"]) == 8


@pytest.mark.parametrize("backend", ["cuda", "auto"])
def test_a_failed_discovery_is_published_unhealthy(monkeypatch, backend):
    """No card: the node says it is unhealthy with no devices, as the JAX
    collector does when discovery fails; it never offers the CPU."""
    import torch

    monkeypatch.delenv("KUBESHARE_TPU_FAKE_TOPOLOGY", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reg = registry.TelemetryRegistry()
    col = collector.CapacityCollector(reg, node="gpu-0", backend=backend,
                                      lease_ttl_s=0)
    assert col.collect_once() is False
    entry = reg.capacity()["gpu-0"]
    assert (entry["chips"], entry["healthy"]) == ([], False)
    assert col.last_chips == []


def test_the_collector_serves_its_metrics(monkeypatch):
    monkeypatch.setenv("KUBESHARE_TPU_FAKE_TOPOLOGY", "1:2x2")
    reg = registry.TelemetryRegistry()
    col = collector.CapacityCollector(reg, node="tpu-host-0",
                                      backend="fake", lease_ttl_s=0)
    col.collect_once()
    server = collector.serve_metrics(lambda: col.last_chips, "tpu-host-0",
                                     host="127.0.0.1", port=0)
    try:
        port = server.server_address[1]
        body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                      timeout=5).read().decode()
        assert lint_exposition(body) == []
        assert sum(line.startswith("tpu_capacity{")
                   for line in body.splitlines()) == 4
    finally:
        server.shutdown()
        server.server_close()


# --- aggregator --------------------------------------------------------------

def test_requirement_records_and_engine_sync_match_the_jax_ones():
    reg = registry.TelemetryRegistry(clock=Clock())
    for node, chips in capacity_of("2:2x2").items():
        reg.put_capacity(node, chips, healthy=True)
    mine = SchedulerEngine(clock=lambda: 0.0)
    theirs = JEngine(clock=lambda: 0.0)
    assert (aggregator.sync_engine_from_registry(mine, reg)
            == jaggregator.sync_engine_from_registry(theirs, reg))
    labels = {C.POD_TPU_REQUEST: "0.5", C.POD_TPU_LIMIT: "1.0",
              C.POD_TPU_MEMORY: str(GIB), C.POD_PRIORITY: "10"}
    for name in ("a", "b", "c"):
        pod = mine.submit("ns", name, labels, uid=f"uid-{name}")
        jpod = theirs.submit("ns", name, labels, uid=f"uid-{name}")
        b, jb = mine.schedule(pod), theirs.schedule(jpod)
        rec = aggregator.requirement_record(pod, b)
        assert rec == jaggregator.requirement_record(jpod, jb)
        aggregator.publish_binding(reg, pod, b)
    assert sorted(reg.pods()) == ["ns/a", "ns/b", "ns/c"]
    reg.acquire_leader("scheduler", "s", 3)
    with pytest.raises(registry.FencedWriteError):
        aggregator.withdraw(reg, "ns/a", fence=2)
    aggregator.withdraw(reg, "ns/a", fence=3)
    aggregator.withdraw(reg, "ns/b")
    assert sorted(reg.pods()) == ["ns/c"]
