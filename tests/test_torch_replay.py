"""The port's replay plane against the JAX package's: record, replay and
diff on the same churn events and fleet, the shard-equivalence diff, and
``topcli --replay-diff``.

Mirrors the replay cases of ``tests/test_decisions.py``,
``tests/test_shard.py`` and ``tests/test_topcli.py``. Both packages run
the same virtual-time drive loop, so their traces are compared byte for
byte: a trace recorded by one replays bit-identical through the other.
"""

import json
import types

import pytest

from kubeshare_tpu import constants as JC
from kubeshare_tpu import replay as jreplay
from kubeshare_tpu import topcli as jtopcli
from kubeshare_tpu.obs import decisions as jdecisions
from kubeshare_tpu.obs import flight as jflight
from kubeshare_tpu.scheduler import SchedulerEngine as JEngine
from kubeshare_tpu.sim import simulator as jsimulator
from kubeshare_tpu.topology.discovery import FakeTopology as JFake
from kubeshare_tpu_torch import constants as C
from kubeshare_tpu_torch import replay, topcli
from kubeshare_tpu_torch.obs import decisions
from kubeshare_tpu_torch.obs import flight
from kubeshare_tpu_torch.scheduler import SchedulerEngine
from kubeshare_tpu_torch.sim import simulator
from kubeshare_tpu_torch.topology.discovery import FakeTopology

PORT = types.SimpleNamespace(C=C, replay=replay, topcli=topcli,
                             decisions=decisions, flight=flight,
                             Engine=SchedulerEngine, sim=simulator,
                             Fake=FakeTopology)
JAX = types.SimpleNamespace(C=JC, replay=jreplay, topcli=jtopcli,
                            decisions=jdecisions, flight=jflight,
                            Engine=JEngine, sim=jsimulator, Fake=JFake)


def fleet(side, hosts=4, mesh=(2, 2)):
    by_host: dict = {}
    for chip in side.Fake(hosts=hosts, mesh=mesh).chips():
        by_host.setdefault(chip.host, []).append(chip.to_labels())
    return by_host


def nudged(side):
    """A candidate build whose scorer prefers the ``-0`` nodes."""
    class Nudged(side.Engine):
        def score(self, pod, node):
            s = super().score(pod, node)
            return s + 50.0 if node.endswith("-0") else s
    return lambda clk: Nudged(clock=clk)


def recorded(side, n=40):
    return side.replay.record_trace(side.sim.churn_events(n, seed=3),
                                    fleet(side), seed=11, tick_s=0.25)


def test_the_churn_events_are_the_jax_ones():
    for n, seed, horizon in ((40, 3, None), (30, 5, 120.0)):
        assert simulator.churn_events(n, seed, horizon) == \
            jsimulator.churn_events(n, seed, horizon)


def test_a_recorded_trace_replays_bit_identical_across_packages():
    """The port records the JAX trace byte for byte, and each package's
    replay of the other's trace reproduces it."""
    text = decisions.trace_jsonl(recorded(PORT))
    jtext = jdecisions.trace_jsonl(recorded(JAX))
    assert text == jtext
    for side, other in ((PORT, jtext), (JAX, text)):
        rep = side.replay.replay_trace(other, tick_s=0.25)
        assert side.decisions.trace_jsonl(rep) == other
    rec = recorded(PORT)
    rep = replay.replay_trace(rec, tick_s=0.25)
    diff = replay.decision_diff(rec.entries(), rep.entries())
    assert diff["bit_identical"] and diff["identical"]
    assert diff["pods"]["recorded"] == 40
    assert "byte for byte" in replay.render_diff(diff)


def test_a_planted_perturbation_diffs_as_jax():
    got = {}
    for label, side in (("port", PORT), ("jax", JAX)):
        rec = recorded(side)
        rep = side.replay.replay_trace(
            side.decisions.trace_jsonl(rec), tick_s=0.25,
            engine_factory=nudged(side))
        diff = side.replay.decision_diff(rec.entries(), rep.entries())
        fr = side.flight.FlightRecorder(clock=lambda: 0.0)
        dump = side.replay.trigger_on_diff(diff, rec.entries(),
                                           rep.entries(), flight=fr)
        got[label] = (diff, side.replay.render_diff(diff),
                      dump["reason"], len(dump["recorded_trace"]),
                      len(dump["replayed_trace"]))
    assert got["port"] == got["jax"]
    diff, text = got["port"][:2]
    assert not diff["bit_identical"] and not diff["identical"]
    m = diff["moved"][0]
    assert m["pod"] in text
    assert f"{m['recorded_node']} -> {m['replayed_node']}" in text
    assert got["port"][2] == "replay-diff"


def test_an_identical_diff_triggers_nothing():
    rec = recorded(PORT, n=10)
    diff = replay.decision_diff(rec.entries(), rec.entries())
    fr = flight.FlightRecorder(clock=lambda: 0.0)
    assert replay.trigger_on_diff(diff, rec.entries(), rec.entries(),
                                  flight=fr) is None


def test_replay_refuses_traces_without_a_fleet_entry():
    for side in (PORT, JAX):
        rec = side.decisions.DecisionRecorder(capacity=8)
        rec.record("submit", 0.0, pod="t/p", labels={}, uid="")
        with pytest.raises(ValueError, match="no fleet entry"):
            side.replay.replay_trace(side.decisions.trace_jsonl(rec))


def _synthetic_traces(side, replay_node_a):
    labels = {side.C.POD_TPU_REQUEST: "0.5", side.C.POD_TPU_LIMIT: "1.0"}
    rec = [
        {"kind": "submit", "pod": "ns/a", "labels": dict(labels),
         "t": 0.0, "seq": 0},
        {"kind": "submit", "pod": "ns/b", "labels": dict(labels),
         "t": 0.0, "seq": 1},
        {"kind": "outcome", "pod": "ns/a", "status": "bound",
         "node": "n1", "t": 0.1, "seq": 2},
        {"kind": "outcome", "pod": "ns/b", "status": "bound",
         "node": "n2", "t": 0.1, "seq": 3},
    ]
    rep = [dict(e) for e in rec]
    rep[2]["node"] = replay_node_a          # pod a placed elsewhere
    rep[3]["node"] = "n1"                   # pod b took n1
    rep[2]["t"] = rep[3]["t"] = 5.0         # ... and much later
    rep[2], rep[3] = rep[3], rep[2]         # ... in swapped entry order
    return rec, rep


@pytest.mark.parametrize("node_a", ["n2", "n3"])
def test_the_shard_equivalence_diff_is_the_jax_one(node_a):
    """A pure swap among spec-identical pods is shard-equivalent (n2);
    a move to a node the class never used is not (n3). Both packages
    give the same strict and equivalence reports."""
    got = {}
    for label, side in (("port", PORT), ("jax", JAX)):
        rec, rep = _synthetic_traces(side, node_a)
        got[label] = [side.replay.decision_diff(rec, rep, **kw)
                      for kw in ({}, {"shard_equivalence": True})]
        got[label].append(side.replay.render_diff(got[label][1]))
    assert got["port"] == got["jax"]
    strict, equiv, text = got["port"]
    assert not strict["identical"] and len(strict["moved"]) == 2
    assert equiv["equivalence"] == "shard"
    if node_a == "n2":
        assert equiv["identical"] and equiv["moved"] == []
        assert "shard-equivalent" in text
    else:
        assert not equiv["identical"]
        assert equiv["moved"][0]["class_recorded"] == {"n1": 1, "n2": 1}
        assert equiv["moved"][0]["class_replayed"] == {"n1": 1, "n3": 1}


def test_a_single_lock_trace_replays_shard_equivalent():
    """The rollout gate: a single-lock trace replayed through a 4-shard
    score-route build re-derives an equivalent schedule, and through one
    shard the identical one; the port's sharded replay diffs as JAX's."""
    got = {}
    for label, side in (("port", PORT), ("jax", JAX)):
        events = []
        for i in range(24):
            events.append({"t": 0.1 * i, "op": "submit",
                           "namespace": f"ns{i % 3}", "name": f"c-{i}",
                           "labels": {side.C.POD_TPU_REQUEST: "0.5",
                                      side.C.POD_TPU_LIMIT: "1.0"}})
        for i in range(0, 12, 2):
            events.append({"t": 1.5 + 0.1 * i, "op": "delete",
                           "key": f"ns{i % 3}/c-{i}"})
        truth = side.replay.record_trace(events, fleet(side), seed=11)
        parse = side.decisions.parse_trace_jsonl
        entries = parse(side.decisions.trace_jsonl(truth))["entries"]
        sharded = side.replay.replay_trace(
            truth, config={"shards": 4, "shard_route": "score"})
        equiv = side.replay.decision_diff(
            entries, parse(side.decisions.trace_jsonl(sharded))["entries"],
            shard_equivalence=True)
        single = side.replay.replay_trace(truth, config={"shards": 1})
        strict = side.replay.decision_diff(
            entries, parse(side.decisions.trace_jsonl(single))["entries"])
        got[label] = (equiv, strict)
    equiv, strict = got["port"]
    assert equiv["identical"], (equiv["moved"], equiv["denied"],
                                equiv["missing"], equiv["extra"])
    assert strict["identical"] and strict["bit_identical"]
    # the sharded drains interleave by thread, so only the verdicts and
    # the schedule's counts are held to JAX's
    for a, b in zip(got["port"], got["jax"]):
        for key in ("identical", "equivalence", "moved", "denied",
                    "missing", "extra", "pods"):
            assert a[key] == b[key], key


def test_replay_diff_renders_a_jax_trace_pair_as_the_jax_topcli(
        tmp_path, capsys):
    """``topcli --replay-diff`` of the port on two traces the JAX package
    recorded and replayed prints what the JAX topcli prints, with its
    exit codes: 1 on a diff, 0 on identical traces, 2 on usage errors."""
    rec = recorded(JAX, n=30)
    rep = jreplay.replay_trace(jdecisions.trace_jsonl(rec), tick_s=0.25,
                               engine_factory=nudged(JAX))
    rec_f, rep_f = tmp_path / "recorded.jsonl", tmp_path / "replayed.jsonl"
    rec_f.write_text(jdecisions.trace_jsonl(rec))
    rep_f.write_text(jdecisions.trace_jsonl(rep))
    for argv, rc in (([str(rec_f), "--against", str(rep_f)], 1),
                     ([str(rec_f), "--against", str(rep_f), "--json"], 1),
                     ([str(rec_f), "--against", str(rec_f)], 0),
                     ([str(rec_f), "--against", str(rep_f),
                       "--shard-equiv"], 1),
                     ([str(rec_f)], 2),
                     ([str(tmp_path / "nope")], 2)):
        outs = []
        for cli in (topcli, jtopcli):
            assert cli.main(["--replay-diff", *argv]) == rc, argv
            cap = capsys.readouterr()
            outs.append((cap.out, cap.err))
        assert outs[0] == outs[1], argv
    assert topcli.main(["--replay-diff", str(rec_f)]) == 2
    assert "--against" in capsys.readouterr().err
