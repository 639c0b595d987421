"""The port's simulator against the JAX package's: trace parsing and the
synthetic workloads, ``Simulator``'s ``SimStats`` on the same engine
operations, and every mode of the simulator CLI, in process.

Mirrors the simulator cases of ``tests/test_sim_service.py`` and the
CLI modes the other JAX tests drive. The CLI's JSON is compared with
JAX's at seed 3, whole, with two fields left out:

- ``slo.events[].trace_id`` (``--slo``): each pod's trace id is fresh
  entropy, unseeded in both packages;
- ``prof`` (``--prof-report``): the contention profiler's wall-clock
  lock and phase times.

``--critpath`` is held to JAX's report within the span export's
rounding: the port lays the chip proxy's spans out as its proxy records
them (``execute`` holds the token wait), so the same durations sit at
other offsets and round to the microsecond differently.
"""

import dataclasses
import json
import logging
import types

import pytest

from kubeshare_tpu import constants as JC
from kubeshare_tpu.autopilot import rebalancer as jrebalancer
from kubeshare_tpu.obs import flight as jflight
from kubeshare_tpu.scheduler import SchedulerEngine as JEngine
from kubeshare_tpu.scheduler import dispatcher as jdispatcher
from kubeshare_tpu.sim import simulator as jsim
from kubeshare_tpu.topology.discovery import FakeTopology as JFake
from kubeshare_tpu_torch import constants as C
from kubeshare_tpu_torch import sim as sim_pkg
from kubeshare_tpu_torch.autopilot import rebalancer
from kubeshare_tpu_torch.obs import flight
from kubeshare_tpu_torch.scheduler import SchedulerEngine
from kubeshare_tpu_torch.scheduler import dispatcher
from kubeshare_tpu_torch.sim import simulator as sim
from kubeshare_tpu_torch.topology.discovery import FakeTopology

PORT = types.SimpleNamespace(C=C, sim=sim, Engine=SchedulerEngine,
                             Fake=FakeTopology)
JAX = types.SimpleNamespace(C=JC, sim=jsim, Engine=JEngine, Fake=JFake)


@pytest.fixture(autouse=True)
def private_recorders(monkeypatch):
    """The CLI's ``--slo`` and ``--flight-dump`` paths and the autopilot's
    dispatcher write to the default flight recorder: each package's gets
    a private one, so the JAX process-global recorder stays empty."""
    for mods, fl in (((dispatcher, rebalancer), flight),
                     ((jdispatcher, jrebalancer), jflight)):
        rec = fl.FlightRecorder()
        for mod in (*mods, fl):
            monkeypatch.setattr(mod, "default_recorder",
                                lambda rec=rec: rec)
    logging.disable(logging.WARNING)
    yield
    logging.disable(logging.NOTSET)


def make_engine(side, hosts=2, mesh=(2, 2)):
    eng = side.Engine()
    by_host: dict = {}
    for chip in side.Fake(hosts=hosts, mesh=mesh).chips():
        by_host.setdefault(chip.host, []).append(chip)
    for host, chips in by_host.items():
        eng.add_node(host, chips)
    return eng


def stats(s) -> dict:
    return dataclasses.asdict(s)


def test_the_package_exports_the_jax_names():
    assert sim_pkg.__all__ == ["SimStats", "Simulator", "TraceJob",
                               "parse_trace"]


def test_parse_trace_rows():
    text = "# comment\n0\t1\t30\n12\t8\t900\n"
    jobs = sim.parse_trace(text)
    assert jobs == [sim.TraceJob(0, 1, 30), sim.TraceJob(12, 8, 900)]
    assert [dataclasses.astuple(j) for j in jobs] == \
        [dataclasses.astuple(j) for j in jsim.parse_trace(text)]
    with pytest.raises(ValueError):
        sim.parse_trace("1\t2\n")


def test_the_synthetic_workloads_are_the_jax_ones():
    import random

    for seed in (0, 3):
        for fn in ("synthesize_trace", "synthesize_churn"):
            got = getattr(sim, fn)(50, random.Random(seed))
            want = getattr(jsim, fn)(50, random.Random(seed))
            assert [dataclasses.astuple(j) for j in got] == \
                [dataclasses.astuple(j) for j in want]
        rng, jrng = random.Random(seed), random.Random(seed)
        for job in sim.synthesize_trace(40, random.Random(seed)):
            assert sim.synthesize_labels(job, rng) == \
                jsim.synthesize_labels(jsim.TraceJob(*dataclasses.astuple(
                    job)), jrng)
            assert sim.churn_labels(job, rng) == \
                jsim.churn_labels(job, jrng)


def _guarantee_labels(side):
    return iter([
        {side.C.POD_TPU_REQUEST: "1", side.C.POD_TPU_LIMIT: "1"},
        {side.C.POD_TPU_REQUEST: "1", side.C.POD_TPU_LIMIT: "1",
         side.C.POD_PRIORITY: "50"},
    ])


RUNS = {
    # the JAX test's placements: three jobs fit at once
    "places": dict(mesh=(2, 2), jobs=[(0, 1, 100), (1, 1, 100),
                                      (1, 4, 50)]),
    # three whole-chip jobs on one chip serialize
    "queues": dict(hosts=1, mesh=(1,), jobs=[(0, 1, 100), (1, 1, 100),
                                             (1, 1, 100)]),
    # a guarantee job displaces opportunistic filler
    "preempt": dict(hosts=1, mesh=(1,), preempt=True, labels=True,
                    jobs=[(0.0, 1, 1000.0), (10.0, 1, 100.0)]),
    # without preemption the guarantee waits the filler out
    "no-preempt": dict(hosts=1, mesh=(1,), labels=True,
                       jobs=[(0.0, 1, 1000.0), (10.0, 1, 100.0)]),
    # a failed node's jobs are evicted and re-placed after recovery
    "node-failure": dict(hosts=1, mesh=(2,), jobs=[(0.0, 1, 500.0),
                                                    (0.0, 1, 500.0)],
                         failures=[(100.0, "tpu-host-0", 200.0)]),
    # 150 synthetic jobs, a third guarantee, preemption and a failure
    "synthetic": dict(synthetic=150, preempt=True, guarantee=0.3,
                      failures=[(50.0, "tpu-host-1", 100.0)]),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_sim_stats_equal_jax(name):
    import random

    run = RUNS[name]

    def drive(side):
        eng = make_engine(side, hosts=run.get("hosts", 2),
                          mesh=run.get("mesh", (2, 2)))
        if "synthetic" in run:
            jobs = side.sim.synthesize_trace(run["synthetic"],
                                             random.Random(3))
        else:
            jobs = [side.sim.TraceJob(*j) for j in run["jobs"]]
        label_fn = None
        if run.get("labels"):
            order = _guarantee_labels(side)
            label_fn = lambda job, rng: next(order)   # noqa: E731
        elif "guarantee" in run:
            def label_fn(job, rng, f=run["guarantee"]):
                labels = side.sim.synthesize_labels(job, rng)
                if rng.random() < f:
                    labels[side.C.POD_PRIORITY] = "50"
                return labels
        s = side.sim.Simulator(eng, seed=3, preempt=run.get("preempt",
                                                            False),
                               label_fn=label_fn,
                               failures=run.get("failures")).run(jobs)
        fresh = all(leaf.available == leaf.leaf_cell_number
                    for leaf in eng.leaf_cells.values())
        return stats(s), s.to_json(), s.mean_wait_s, fresh, \
            dict(eng.pod_status)
    got = drive(PORT)
    assert got == drive(JAX)
    s, _json, mean_wait, fresh, pods = got
    assert fresh and pods == {}
    if name == "places":
        assert s["placed"] == 3 and s["failed"] == 0
    elif name == "queues":
        assert s["retries"] >= 2 and s["makespan_s"] >= 300
    elif name == "preempt":
        assert s["preemptions"] == 1 and s["restarts"] == 1
        assert s["submitted"] == s["placed"] + s["failed"]
        assert mean_wait == pytest.approx(0.0)
        assert s["chip_seconds"] == pytest.approx(1110.0)
        assert s["makespan_s"] == pytest.approx(1110.0)
    elif name == "no-preempt":
        assert s["preemptions"] == 0
        assert s["makespan_s"] == pytest.approx(1100.0)
    elif name == "node-failure":
        assert s["health_evictions"] == 2 and s["restarts"] == 2
        assert s["makespan_s"] == pytest.approx(800.0)


def test_the_failed_count_matches_the_reference_defect():
    """Matched on purpose: ``Simulator.run`` counts every job still
    pending when the trace drains as failed, a victim already counted
    placed included, so ``submitted == placed + failed`` breaks. Here a
    node fails for good (its recovery is scheduled before the failure)
    and its two evicted jobs never place again: 2 placed, 2 failed, 2
    submitted, in both packages."""
    def drive(side):
        eng = make_engine(side, hosts=1, mesh=(2,))
        jobs = [side.sim.TraceJob(0.0, 1, 500.0),
                side.sim.TraceJob(0.0, 1, 500.0)]
        s = side.sim.Simulator(
            eng, failures=[(100.0, "tpu-host-0", -50.0)]).run(jobs)
        return stats(s), s.to_json()
    got = drive(PORT)
    assert got == drive(JAX)
    s, out = got
    assert s["submitted"] == 2 and s["placed"] == 2 and s["failed"] == 2
    assert s["health_evictions"] == 2 and s["restarts"] == 0
    assert s["submitted"] != s["placed"] + s["failed"]
    assert out["per_node"] == {"tpu-host-0": 2}


def _cli(main, argv, capsys) -> str:
    main(argv)
    return capsys.readouterr().out


def _scrub(doc: dict) -> dict:
    for event in doc.get("slo", {}).get("events", []):
        event.pop("trace_id")
    doc.pop("prof", None)
    return doc


MODES = {
    "trace": ["--trace", "{trace}", "--topology", "1:2x2@TPU-v4"],
    "synthetic": ["--synthetic", "200", "--topology", "4:4x4@TPU-v5e"],
    "synthetic-preempt-fail": [
        "--synthetic", "200", "--topology", "2:2x2@TPU-v4", "--preempt",
        "--guarantee-frac", "0.3", "--fail", "tpu-host-0@50:100"],
    "churn-autopilot": ["--churn", "150", "--topology", "2:2x2@TPU-v4",
                        "--autopilot-every", "30"],
    "slo": ["--synthetic", "200", "--topology", "2:2x2@TPU-v4", "--slo",
            "queue-wait-p99<=500ms,availability>=99", "--slow-tenant",
            "tenant-1@100:2", "--flight-dump", "{dump}"],
    "serve": ["--serve", "200", "--serve-tenants", "3", "--slo",
              "queue-wait-p99<=50ms"],
    "contention": ["--contention", "150"],
    "contention-preempt": ["--contention", "150", "--preempt"],
    "rightsize": ["--rightsize", "--rightsize-horizon", "600"],
    "rightsize-static-sharded": ["--rightsize", "--rightsize-static",
                                 "--rightsize-horizon", "600",
                                 "--shards", "2"],
    "prof-report": ["--synthetic", "50", "--prof-report"],
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_each_cli_mode_prints_the_jax_json(mode, tmp_path, capsys):
    trace = tmp_path / "trace.txt"
    trace.write_text("0\t1\t10\n5\t4\t20\n3\t2\t40\n")
    outs = []
    for label, main in (("port", sim.main), ("jax", jsim.main)):
        argv = [a.format(trace=trace, dump=tmp_path / f"{label}.jsonl")
                for a in MODES[mode]] + ["--seed", "3"]
        outs.append(json.loads(_cli(main, argv, capsys)))
    if mode == "prof-report":
        assert "locks" in outs[0]["prof"]
    assert _scrub(outs[0]) == _scrub(outs[1])
    if mode == "slo":
        dump = (tmp_path / "port.jsonl").read_text().splitlines()
        assert json.loads(dump[0])["reason"] == "sim-run"


def _close(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        tol = 2e-4 if path.rsplit("/", 1)[-1] in (
            "coverage", "coverage_min", "coverage_mean", "share") else 3e-3
        assert got == pytest.approx(want, abs=tol), path
    else:
        assert got == want, path


def test_critpath_attributes_as_jax(tmp_path, capsys):
    """The port's proxy spans hold the token wait inside ``execute``;
    the port's assembler takes it back out, so the report is JAX's to
    the span export's microsecond, and coverage stays above the 0.95
    the generator is built for."""
    outs = []
    for main in (sim.main, jsim.main):
        outs.append(json.loads(_cli(main, ["--critpath", "60", "--seed",
                                           "3"], capsys))["critpath"])
    _close(outs[0], outs[1])
    assert outs[0]["coverage_min"] >= 0.95
    out = sim.simulate_critpath(12, seed=7, spans_dir=str(tmp_path / "a"))
    again = sim.simulate_critpath(12, seed=7, spans_dir=str(tmp_path / "b"))
    assert out == again

    def exported(d, src):
        # span ids are fresh entropy; everything else is seeded
        return [{k: v for k, v in json.loads(line).items()
                 if k != "span_id"}
                for line in (tmp_path / d / f"{src}.jsonl").read_text()
                .splitlines()]
    for src in ("frontdoor", "scheduler", "chipproxy", "client"):
        assert exported("a", src) == exported("b", src)
    rows = exported("a", "chipproxy")
    for tid in {r["trace_id"] for r in rows}:
        ex, = [r for r in rows if r["trace_id"] == tid
               and r["name"] == "execute"]
        grant, = [r for r in rows if r["trace_id"] == tid
                  and r["name"] == "token-grant"]
        assert ex["start_ms"] <= grant["start_ms"] <= grant["end_ms"] \
            <= ex["end_ms"]


def test_the_cli_refuses_what_the_jax_cli_refuses(capsys):
    for argv in ([], ["--synthetic", "5", "--churn", "5"],
                 ["--synthetic", "5", "--shards", "2"],
                 ["--synthetic", "5", "--rightsize-static"],
                 ["--synthetic", "5", "--slow-tenant", "t@1:1"],
                 ["--synthetic", "5", "--fail", "bad"]):
        codes = []
        for main in (sim.main, jsim.main):
            with pytest.raises(SystemExit) as e:
                main(argv)
            err = capsys.readouterr().err
            codes.append((e.value.code, err.splitlines()[-1].split(
                "error: ", 1)[-1]))
        assert codes[0] == codes[1], argv
        assert codes[0][0] == 2
