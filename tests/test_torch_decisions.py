"""The port's decision recorder against the JAX package's: the same
records, views, draws and primes give the same entries, counts, state,
canonical forms, JSONL traces and fingerprints; the preemption policy's
``decisions`` hook records the same ``token-preempt`` entries behind
both token schedulers; and the port's decision-path modules keep the
explicit-now markers that the JAX lint asks of its own.

Mirrors the recorder and serialization cases of ``tests/test_decisions.py``.
"""

import re
import threading
import time
from pathlib import Path

import pytest

from kubeshare_tpu.isolation import tokensched as jts
from kubeshare_tpu.obs import decisions as jdec
from kubeshare_tpu.preempt import PreemptionPolicy as JaxPolicy
from kubeshare_tpu_torch import constants as C
from kubeshare_tpu_torch.isolation import tokensched
from kubeshare_tpu_torch.obs import decisions as dec
from kubeshare_tpu_torch.preempt import PreemptionPolicy

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def fresh_defaults():
    dec.reset_for_tests()
    jdec.reset_for_tests()
    yield
    dec.reset_for_tests()
    jdec.reset_for_tests()


def both(fn):
    mine, theirs = fn(dec), fn(jdec)
    assert mine == theirs
    return mine


def script(mod, capacity=16, seed=3):
    """A recorder driven through every entry point on a fixed clock."""
    t = [0.0]
    rec = mod.DecisionRecorder(capacity=capacity, clock=lambda: t[0],
                               seed=seed)
    rec.meta["tick_s"] = 0.5
    rec.record("fleet", 0.0, nodes={"n0": [{"chip_id": "c0"}]})
    views = [{"n0": "4.000|up", "n1": "4.000|up"},
             {"n0": "3.000|up", "n1": "4.000|up"},
             {"n0": "3.000|up", "n1": "4.000|up"},
             {"n0": "3.000|up"},
             {"n0": "0.000|down", "n2": "4.000|up"}]
    flags = [rec.record_view(float(i), v) for i, v in enumerate(views)]
    for i in range(12):
        t[0] = 1.0 + i / 7.0
        rec.record("submit", pod=f"ns/p{i}",
                   labels={C.POD_TPU_REQUEST: str(0.1 * (i + 1)),
                           C.POD_TPU_LIMIT: "1.0"}, uid=f"u{i}")
        rec.record("outcome", t[0] + 1e-9, pod=f"ns/p{i}",
                   status="bound" if i % 3 else "pending",
                   reason="" if i % 3 else "no node passed filtering",
                   node="n0" if i % 3 else "")
    draws = [rec.rng_draw("x", 2.0) for _ in range(3)]
    hexes = [rec.rng_draw_hex("trace-id", 2.5) for _ in range(2)]
    return rec, flags, draws, hexes


def test_a_scripted_recorder_gives_the_jax_entries():
    def run(mod):
        rec, flags, draws, hexes = script(mod)
        return {"flags": flags, "draws": draws, "hexes": hexes,
                "entries": rec.entries(), "counts": rec.counts(),
                "dropped": rec.dropped, "state": rec.state(),
                "canonical": [mod.canonical_entry(e)
                              for e in rec.entries()],
                "fingerprint": mod.trace_fingerprint(rec.entries())}

    out = both(run)
    assert out["dropped"] > 0 and out["flags"] == [True, True, False,
                                                   True, True]


def test_the_jsonl_trace_is_byte_identical_and_parses_alike():
    text = both(lambda mod: mod.trace_jsonl(script(mod, capacity=64)[0]))
    parsed = both(lambda mod: mod.parse_trace_jsonl(text))
    assert not parsed["truncated"]
    torn = text[:-30]
    assert both(lambda mod: mod.parse_trace_jsonl(torn))["truncated"]
    lines = text.splitlines()
    lines[2] = lines[2][:10]
    rotten = "\n".join(lines) + "\n"

    def corrupt(mod):
        with pytest.raises(ValueError) as e:
            mod.parse_trace_jsonl(rotten)
        return str(e.value)

    assert "corrupt at line 3" in both(corrupt)


def test_views_rebuild_alike():
    def run(mod):
        rec = script(mod, capacity=64)[0]
        views = mod.reconstruct_views(rec.entries())
        second = [e for e in rec.entries() if e["kind"] == "view"][1]
        return views, mod.apply_view_delta(views[0], second)

    views, applied = both(run)
    assert len(views) == 4 and applied == views[1]


def test_primed_draws_replay_the_recorded_values():
    def run(mod):
        a = script(mod)[0]
        c = mod.DecisionRecorder(seed=999, clock=lambda: 7.0)
        c.prime_draws([e for e in a.entries() if e["kind"] == "rng"])
        return [c.rng_draw("x") for _ in range(4)], c.entries()

    values, entries = both(run)
    assert len(values) == 4


@pytest.mark.parametrize("labels", [
    {}, {C.POD_TPU_REQUEST: "0.5"},
    {C.POD_TPU_LIMIT: "1", C.POD_TPU_REQUEST: "0.5",
     C.POD_GROUP_NAME: "g", C.POD_PRIORITY: 7}])
def test_label_fingerprints_agree(labels):
    assert len(both(lambda mod: mod.fingerprint_labels(labels))) == 12


def test_the_default_recorder_is_process_global_until_reset():
    first = dec.default_decisions()
    assert dec.default_decisions() is first
    first.record("submit", 0.0, pod="a/b", labels={}, uid="")
    dec.reset_for_tests()
    assert dec.default_decisions() is not first
    assert dec.default_decisions().entries() == []
    assert (dec.DEFAULT_CAPACITY, dec.default_decisions().seed) == (
        jdec.DEFAULT_CAPACITY, jdec.default_decisions().seed)


def test_clear_resets_the_ring_alike():
    def run(mod):
        rec = script(mod)[0]
        rec.clear()
        rec.record("delete", 9.0, pod="ns/p0")
        return rec.entries(), rec.counts(), rec.state()

    both(run)


# --- the preemption policy's hook ------------------------------------------

def _token_preempt_records(ts_mod, policy_cls):
    """A latency waiter behind a best-effort holder that never releases:
    the policy marks the holder once, and its recorder says so."""
    rec = (dec if ts_mod is tokensched else jdec).DecisionRecorder()
    pol = policy_cls(grace_ms=20.0, min_hold_ms=0.0)
    pol.decisions = rec
    sched = ts_mod.TokenScheduler(1000.0, 100.0, 10.0, chip="chipA",
                                  preempt=pol)
    sched.add_client("ns/hog", 0.5, 1.0)
    sched.add_client("ns/lat", 0.5, 1.0, tpu_class="latency")
    sched.acquire("ns/hog")
    t = threading.Thread(target=lambda: sched.acquire("ns/lat",
                                                      timeout=10.0))
    t.start()
    deadline = time.monotonic() + 5.0
    while not sched.preempted("ns/hog") and time.monotonic() < deadline:
        time.sleep(0.005)
    sched.release("ns/hog", 5.0)
    t.join(timeout=5.0)
    sched.close()
    return [{k: v for k, v in e.items() if k not in ("t", "seq")}
            for e in rec.entries()]


def test_a_token_preemption_is_recorded_as_the_jax_policy_records_it():
    mine = _token_preempt_records(tokensched, PreemptionPolicy)
    theirs = _token_preempt_records(jts, JaxPolicy)
    assert mine == theirs == [{
        "kind": "token-preempt", "chip": "chipA", "holder": "ns/hog",
        "waiter_class": "latency", "holder_class": "best-effort"}]


def test_a_gang_preemption_note_is_recorded_alike():
    def run(policy_cls, mod):
        pol = policy_cls()
        pol.decisions = mod.DecisionRecorder(clock=lambda: 4.0)
        pol.note_gang_preemption("ns/g", "ns/lat-gang")
        return pol.decisions.entries(), pol.snapshot()["stats"]

    assert run(PreemptionPolicy, dec) == run(JaxPolicy, jdec)


def test_a_policy_without_a_recorder_records_nothing():
    pol = PreemptionPolicy()
    assert pol.decisions is None
    pol.note_preemption("c", "h", "latency", "best-effort")
    pol.note_gang_preemption("g", "b")
    assert pol.snapshot()["stats"]["preemptions"] == 1


# --- the explicit-now lint over the port's decision path -------------------

_AUDITED = [
    "kubeshare_tpu_torch/scheduler/dispatcher.py",
    "kubeshare_tpu_torch/scheduler/engine.py",
    "kubeshare_tpu_torch/scheduler/healthwatch.py",
    "kubeshare_tpu_torch/preempt/policy.py",
]
_FORBIDDEN = re.compile(
    r"time\.time\(\)|time\.perf_counter\(\)|uuid4|new_trace_id\(|"
    r"\brandom\.(random|uniform|choice|randint|shuffle)\(")
_MARKERS = ("# wall-clock: metric-only", "# entropy: recorded")


@pytest.mark.parametrize("rel", _AUDITED)
def test_decision_path_clock_and_entropy_reads_are_marked(rel):
    offenders = [f"{rel}:{i}: {line.strip()}"
                 for i, line in enumerate(
                     (REPO / rel).read_text().splitlines(), 1)
                 if _FORBIDDEN.search(line)
                 and not any(m in line for m in _MARKERS)]
    assert not offenders, "\n".join(offenders)
