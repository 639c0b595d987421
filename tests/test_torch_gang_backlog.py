"""Pending pods the fleet cannot hold: the port's dispatcher reaches the
JAX dispatcher's decisions with far fewer victim searches.

A guarantee pod that no node can take runs ``engine.find_preemption`` at
every retry, over every node, in both packages' code. The port's
dispatcher leaves out the nodes its last search found hopeless for the
pod while nothing was released there (``Dispatcher._find_preemption``; a
divergence on purpose, in cost only). Both dispatchers run the same
operations on one fake clock; statuses, queues, bookings, records,
evictions, invariants and decision streams are compared exactly after
every operation, and the searches are counted on each side.
"""

import random

import pytest

from kubeshare_tpu_torch import constants as C

from test_torch_dispatcher import (MISS, QUARANTINE, TTL, Twin,  # noqa: F401
                                   decision_stream, gang,
                                   private_recorders, shared)


def count_searches(tw):
    """Wrap both engines' ``find_preemption``: returns ``{"port": [...],
    "jax": [...]}``, one entry per search, each ``(pod key, nodes
    searched, plan)``. On the port side each search also checks that no
    node is searched again for the same pod while its last answer must
    stand: a hopeless node until a release there, any other until a
    booking there changes."""
    calls = {"port": [], "jax": []}
    answered = {}

    def wrap(side, label):
        eng = side.engine
        real = eng.find_preemption

        def find(pod, nodes=None, results=None):
            searched = list(nodes if nodes is not None else eng.nodes)
            if label == "port":
                results = {} if results is None else results
                for node in searched:
                    key = (pod.key, pod.trace_id, pod.timestamp,
                           pod.group_rank, eng.release_epoch, node)
                    assert answered.get(key) != eng.release_gen.get(
                        node, 0), f"{pod.key} searched {node} again"
                plan = real(pod, nodes, results=results)
                for node, got in results.items():
                    key = (pod.key, pod.trace_id, pod.timestamp,
                           pod.group_rank, eng.release_epoch, node)
                    if got == "hopeless":
                        answered[key] = eng.release_gen.get(node, 0)
                    else:
                        answered.pop(key, None)
            else:
                plan = real(pod, nodes)
            calls[label].append((pod.key, searched, plan))
            return plan

        eng.find_preemption = find

    wrap(tw.port, "port")
    wrap(tw.jax, "jax")
    return calls


def whole(priority="10"):
    return shared("1", "1", **{C.POD_PRIORITY: priority})


def pair(name):
    return gang(name, headcount=2, threshold=1.0, request="1", limit="1")


def test_unholdable_pairs_search_once_until_a_release():
    tw = Twin(hosts=2, mesh=(2, 2), health=False)
    fill = [tw.submit("ns", f"fill-{i}", whole()) for i in range(8)]
    tw.step()
    assert all(tw.check()["status"][k]["status"] == "bound" for k in fill)
    calls = count_searches(tw)
    for i in range(3):
        for j in range(2):
            tw.submit("bg", f"pair-{i}-{j}", pair(f"pair-{i}"))
    tw.step()
    tw.advance(20.0)
    v = tw.check()
    pending = sorted(k for k, st in v["status"].items()
                     if st["status"] == "pending")
    assert len(pending) == 6, v["status"]
    # the JAX dispatcher searched every node at every retry ...
    assert len(calls["jax"]) >= 6 * 20
    assert all(len(nodes) == 2 for _, nodes, _ in calls["jax"])
    # ... the port's once per pod, over both nodes
    assert sorted(k for k, _, _ in calls["port"]) == pending
    assert all(len(nodes) == 2 for _, nodes, _ in calls["port"])
    # binding more pods releases nothing: still no search
    tw.submit("ns", "late", whole())
    tw.advance(5.0)
    assert len(calls["port"]) == 7
    # a delete frees a device on one node: one search each, of that node
    node = v["status"][fill[0]]["node"]
    before = len(calls["port"])
    tw.delete(fill[0])
    tw.advance(3.0)
    v = tw.check()
    again = calls["port"][before:]
    assert again and all(nodes == [node] for _, nodes, _ in again)
    assert len({k for k, _, _ in again}) == len(again)
    assert all(plan is None for _, _, plan in calls["port"])


def test_a_release_that_makes_a_plan_finds_the_same_plan():
    """An opportunistic pod lands on the saturated fleet: the pending
    guarantee pod's next search covers that node alone and adopts the
    plan the JAX dispatcher adopts from its full search."""
    tw = Twin(hosts=2, mesh=(2,), health=False)
    for i in range(4):
        tw.submit("ns", f"fill-{i}", whole())
    tw.step()
    calls = count_searches(tw)
    g = tw.submit("ns", "guarantee", whole("50"))
    tw.advance(3.0)
    assert len(calls["port"]) == 1 and len(calls["jax"]) >= 3
    v = tw.check()
    tw.delete("ns/fill-0")
    opp = tw.submit("ns", "opp", shared("0.5", "1",
                                        **{C.POD_PRIORITY: "0"}))
    tw.step()       # the opportunistic pod takes the freed half device
    v = tw.check()
    assert v["status"][opp]["status"] == "bound"
    tw.advance(2.0)
    v = tw.check()
    assert v["evictions"] == [(opp, g, v["status"][opp]["node"])] or \
        v["status"][g]["status"] == "bound"
    assert calls["port"][-1][2] == calls["jax"][-1][2]


def test_a_plans_victim_gang_changing_on_another_node_is_searched_again():
    """The plan on one node evicts an opportunistic gang with a member on
    the other node. That member leaves, then another joins there: the
    plan's node saw no booking change, yet each time its plan is searched
    again and matches the JAX dispatcher's (``engine.group_gen``)."""
    tw = Twin(hosts=2, mesh=(2,), health=False)

    def opp(request):
        return gang("opp", headcount=3, threshold=0.5, priority="0",
                    request=request, limit="1")

    for name, labels in (("f1", whole()),
                         ("h", shared("0.5", "1", **{C.POD_PRIORITY: "10"})),
                         ("f2", whole())):
        tw.submit("ns", name, labels)
        tw.step()
    tw.submit("ns", "x1", opp("1"))
    tw.submit("ns", "x2", opp("0.5"))
    tw.step()
    tw.advance(2.0)
    v = tw.check()
    far = v["status"]["ns/x1"]["node"]
    near = v["status"]["ns/x2"]["node"]
    assert far != near and v["status"]["ns/h"]["node"] == near
    calls = count_searches(tw)
    tw.submit("ns", "g", whole("50"))
    tw.advance(2.0)
    plans = [{"node": far, "victims": ["ns/x1", "ns/x2"]}]
    tw.delete("ns/x2")                  # the gang loses its near member
    tw.advance(2.0)
    plans.append({"node": far, "victims": ["ns/x1"]})
    before = len(calls["port"])
    tw.submit("ns", "x3", opp("0.5"))   # ... and gains one there
    tw.step()
    v = tw.check()
    assert v["status"]["ns/x3"]["node"] == near
    tw.advance(2.0)
    plans.append({"node": far, "victims": ["ns/x1", "ns/x3"]})
    assert any(far in nodes for _, nodes, _ in calls["port"][before:])
    v = tw.check()
    assert v["evictions"] == [(k, "ns/g", far) for k in plans[-1]["victims"]]
    adopted = []
    for _, _, plan in calls["port"]:
        if plan is not None and plan not in adopted:
            adopted.append(plan)
    assert adopted == plans
    assert [p for _, _, p in calls["port"]][-1] == calls["jax"][-1][2]


def test_a_resize_that_frees_a_share_reopens_a_hopeless_node():
    """A node is hopeless for a pending 0.75 pod until a guarantee pod
    there shrinks in place (``resize_request``): then evicting the
    opportunistic pod beside it makes room, and the port's next search
    adopts the JAX dispatcher's plan (``engine.rebook`` releases)."""
    tw = Twin(hosts=1, mesh=(2,), health=False)
    tw.submit("ns", "a", whole())
    tw.step()
    tw.submit("ns", "b", shared("0.5", "1", **{C.POD_PRIORITY: "10"}))
    tw.submit("ns", "o", shared("0.5", "1", **{C.POD_PRIORITY: "0"}))
    tw.step()
    v = tw.check()
    assert all(v["status"][k]["status"] == "bound" for k in ("ns/a", "ns/b",
                                                              "ns/o"))
    calls = count_searches(tw)
    g = tw.submit("ns", "g", shared("0.75", "1", **{C.POD_PRIORITY: "50"}))
    tw.advance(3.0)
    assert tw.check()["evictions"] == []
    assert len(calls["port"]) == 1 and len(calls["jax"]) >= 3
    got = tw.both(lambda s: s.disp.resize_request("ns/b", 0.25))
    assert got["to"] == 0.25
    tw.advance(2.0)
    v = tw.check()
    node = v["status"]["ns/o"]["node"]
    assert v["evictions"] == [("ns/o", g, node)]
    assert calls["port"][-1][2] == calls["jax"][-1][2] == {
        "node": node, "victims": ["ns/o"]}


BACKLOG_MIX = [
    lambda r: shared("0.5", "1.0"),
    lambda r: shared("0.25", "0.5"),
    lambda r: whole(),
    lambda r: shared("2", "2"),
    lambda r: shared("0.3", "1.0", **{C.POD_PRIORITY: "0"}),
    lambda r: shared("1", "1", **{C.POD_PRIORITY: "0"}),
    lambda r: shared("0.2", "1.0", **{C.POD_PRIORITY: "10"}),
]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_a_churn_with_pairs_left_pending_decides_as_jax(seed):
    """5i's kind of traffic on a small fleet: whole-device pairs the
    fleet cannot hold are left pending (namespace ``bg``, never deleted),
    opportunistic and guarantee pods come and go, nodes go silent and
    come back. Every operation gives the same view and decisions on both
    sides; the port searches less."""
    rng = random.Random(seed)
    tw = Twin(hosts=3, mesh=(2, 2))
    nodes = sorted(tw.port.engine.chips_by_node)
    calls = count_searches(tw)
    pairs = 0
    for _ in range(220):
        op = rng.random()
        if op < 0.1:
            for j in range(2):
                tw.submit("bg", f"pair-{pairs}-{j}", pair(f"pair-{pairs}"))
            pairs += 1
        elif op < 0.5:
            tw.submit("ns", f"p{rng.randrange(40)}",
                      rng.choice(BACKLOG_MIX)(rng))
        elif op < 0.62:
            singles = sorted(k for k in tw.keys if k.startswith("ns/"))
            if singles:
                tw.delete(rng.choice(singles))
        elif op < 0.8:
            tw.step()
        elif op < 0.97:
            tw.advance(rng.choice([0.5, 1.0, 2.5, 6.0]))
        else:
            node = rng.choice(nodes)
            tw.silence(node, on=node not in tw.port.silent)
        tw.check()
    for node in nodes:
        tw.silence(node, on=False)
    tw.advance(MISS * TTL + QUARANTINE + 3 * TTL, dt=2.0)
    v = tw.check()
    assert v["invariants"]["ok"]
    assert any(st["status"] == "pending" for k, st in v["status"].items()
               if k.startswith("bg/")), v["status"]
    kinds = {e["kind"] for e in decision_stream(tw.port)}
    assert {"submit", "outcome", "view"} <= kinds
    searched = {label: sum(len(n) for _, n, _ in c)
                for label, c in calls.items()}
    # a search that found a plan runs again at the next retry (any bind
    # may make the plan evaporate); one that proved every node hopeless
    # does not, until a release (count_searches checks that)
    assert len(calls["port"]) <= len(calls["jax"])
    assert searched["port"] < searched["jax"], searched
