"""The port's chaos orchestrator against the JAX package's: the seeded
scenario schedules, the virtual-time runner over a real in-process
control plane (engine, dispatcher, registry, HA plane, serving front
door, gang coordinator, the token-share mirror, autopilot, rightsizer
and elastic plane), ``run_suite`` / ``run_matrix`` and ``sim --chaos``.

Mirrors the orchestration cases of ``tests/test_chaos.py`` and the chaos
case of ``tests/test_elastic.py``. Everything runs on the runner's
virtual clock, so reports are compared as JSON, byte for byte: every
scenario's timeline, samples, violations and MTTR.
"""

import json
import logging

import pytest

from kubeshare_tpu import chaos as jchaos
from kubeshare_tpu.autopilot import rebalancer as jrebalancer
from kubeshare_tpu.ha import standby as jstandby
from kubeshare_tpu.obs import flight as jflight
from kubeshare_tpu.scheduler import dispatcher as jdispatcher
from kubeshare_tpu.sim import simulator as jsimulator
from kubeshare_tpu_torch import chaos
from kubeshare_tpu_torch.autopilot import rebalancer
from kubeshare_tpu_torch.chaos.orchestrator import _PartitionedRegistry
from kubeshare_tpu_torch.ha import standby
from kubeshare_tpu_torch.obs import flight
from kubeshare_tpu_torch.scheduler import dispatcher
from kubeshare_tpu_torch.sim import simulator


@pytest.fixture(autouse=True)
def private_recorders(monkeypatch):
    """The runs evict nodes, take over and fail batches, and each of
    those dumps the flight recorder: every module of both packages that
    reads the default recorder gets a private one here, so the JAX
    process-global recorder (which fills at 8 dumps) stays empty."""
    for mods, fl in (((dispatcher, standby, rebalancer), flight),
                     ((jdispatcher, jstandby, jrebalancer), jflight)):
        rec = fl.FlightRecorder()
        for mod in (*mods, fl):
            monkeypatch.setattr(mod, "default_recorder",
                                lambda rec=rec: rec)
    logging.disable(logging.WARNING)
    yield
    logging.disable(logging.NOTSET)


def dumps(report) -> str:
    return json.dumps(report, sort_keys=True)


def test_the_scenarios_are_the_jax_ones():
    assert list(chaos.BUILDERS) == list(jchaos.BUILDERS)
    for seed in (0, 13, 14):
        got = [s.to_dict() for s in chaos.all_scenarios(seed)]
        want = [s.to_dict() for s in jchaos.all_scenarios(seed)]
        assert got == want
        for name in chaos.BUILDERS:
            assert chaos.build(name, seed).description == \
                jchaos.build(name, seed).description
    assert any([a.to_dict() for a in chaos.build(name, 13).actions]
               != [a.to_dict() for a in chaos.build(name, 14).actions]
               for name in chaos.BUILDERS)
    assert len(chaos.all_scenarios(0)) == len(chaos.BUILDERS) == 13
    with pytest.raises(KeyError):
        chaos.build("no-such-scenario", 0)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("shards", [1, 2])
def test_run_suite_equals_jax(seed, shards):
    """Every scenario on one seed, on the single-lock plane and on a
    2-shard cell-route plane: the port's report is JAX's, and green."""
    got = chaos.run_suite(seed=seed, shards=shards)
    assert dumps(got) == dumps(jchaos.run_suite(seed=seed, shards=shards))
    assert got["invariant_violations"] == 0 and got["converged"]
    assert len(got["scenarios"]) == 13
    for scn in got["scenarios"]:
        assert scn["converged"] and scn["violations"] == [], scn["scenario"]
        assert scn["mttr_s"] >= 0.0 and scn["samples"] > 0


def test_the_partitioned_registry_fails_calls_during_the_window():
    runner = chaos.ChaosRunner(seed=1)
    try:
        preg = _PartitionedRegistry(runner)
        preg.put_lease("host-0", 1)              # healthy: delegates
        runner._partition_until = runner.now + 5.0
        with pytest.raises(OSError):
            preg.put_lease("host-0", 2)
        runner.now += 6.0                        # window over: heals
        preg.put_lease("host-0", 3)
    finally:
        runner.close()


def test_run_scenario_is_bit_deterministic():
    first = chaos.run_scenario("proxy-kill-windowed-put", seed=5)
    again = chaos.run_scenario("proxy-kill-windowed-put", seed=5)
    assert dumps(first) == dumps(again)
    assert first["converged"] and first["violations"] == []
    assert first["mttr_s"] >= 0.0
    other = chaos.run_scenario("proxy-kill-windowed-put", seed=6)
    assert dumps(other) != dumps(first)
    assert dumps(other) == dumps(
        jchaos.run_scenario("proxy-kill-windowed-put", seed=6))


@pytest.mark.parametrize("shards", [1, 2])
def test_a_cross_shard_commit_failure_recovers_as_jax(shards):
    """The mid-commit shard failure on a 2-shard plane rolls back
    cleanly; on the single-lock plane the injection is a no-op."""
    got = chaos.run_scenario("cross-shard-gang-commit-fail", seed=3,
                             shards=shards)
    assert dumps(got) == dumps(jchaos.run_scenario(
        "cross-shard-gang-commit-fail", seed=3, shards=shards))
    assert got["converged"] and got["violations"] == []
    assert got["mttr_s"] >= 0.0


@pytest.mark.parametrize("seed", [3, 11, 23])
def test_an_elastic_resize_mid_churn_is_green_as_jax(seed):
    got = chaos.run_scenario("resize-mid-churn", seed=seed)
    assert dumps(got) == dumps(jchaos.run_scenario("resize-mid-churn",
                                                   seed=seed))
    assert got["converged"] and got["violations"] == []
    assert got["mttr_s"] >= 0.0


def test_run_matrix_aggregates_mttr_percentiles_as_jax():
    kw = dict(names=["proxy-kill-windowed-put", "resize-mid-eviction"])
    got = chaos.run_matrix([3, 11], **kw)
    assert got == jchaos.run_matrix([3, 11], **kw)
    assert got["invariant_violations"] == 0 and got["converged"]
    scn = got["scenarios"]["proxy-kill-windowed-put"]
    assert scn["runs"] == 2 and scn["violations"] == 0
    assert 0.0 <= scn["mttr_p50_s"] <= scn["mttr_p99_s"]


def test_sim_chaos_mode_prints_the_jax_report(capsys):
    argv = ["--chaos", "--seed", "4", "--chaos-scenario", "node-crash-flap",
            "--chaos-scenario", "partition-with-standby-takeover"]
    simulator.main(argv)
    out = capsys.readouterr().out
    jsimulator.main(argv)
    assert out == capsys.readouterr().out
    report = json.loads(out)["chaos"]
    assert report["seed"] == 4
    assert report["invariant_violations"] == 0 and report["converged"]
    assert [s["scenario"] for s in report["scenarios"]] == \
        ["node-crash-flap", "partition-with-standby-takeover"]
