"""The port's observability modules against the JAX package's: metrics
and their exposition, spans, the flight recorder, the chip-time ledger,
the blame graph, SLOs, the profiler and critical-path assembly.

Each case feeds the same inputs — a fixed event script on an injected
clock, or one made from a seed with numpy — to the JAX module and to its
copy in ``kubeshare_tpu_torch/obs/`` and requires the same output: exact,
or seconds to 1e-9 where a ledger sums floats.
"""

import json
import sys
import threading

import numpy as np
import pytest

from kubeshare_tpu.obs import blame as jblame
from kubeshare_tpu.obs import critpath as jcritpath
from kubeshare_tpu.obs import flight as jflight
from kubeshare_tpu.obs import ledger as jledger
from kubeshare_tpu.obs import metrics as jmetrics
from kubeshare_tpu.obs import prof as jprof
from kubeshare_tpu.obs import slo as jslo
from kubeshare_tpu.obs import trace as jtrace
from kubeshare_tpu_torch import obs as pobs
from kubeshare_tpu_torch.obs import blame as pblame
from kubeshare_tpu_torch.obs import critpath as pcritpath
from kubeshare_tpu_torch.obs import flight as pflight
from kubeshare_tpu_torch.obs import ledger as pledger
from kubeshare_tpu_torch.obs import metrics as pmetrics
from kubeshare_tpu_torch.obs import prof as pprof
from kubeshare_tpu_torch.obs import slo as pslo
from kubeshare_tpu_torch.obs import trace as ptrace

class Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _approx_tree(a, b, tol=1e-9):
    """Equal structures; floats within ``tol``."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (a, b)
        for k in a:
            _approx_tree(a[k], b[k], tol)
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _approx_tree(x, y, tol)
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= tol, (a, b)
    else:
        assert a == b, (a, b)


def test_the_package_exports_the_jax_names_less_decisions_and_tsdb():
    import kubeshare_tpu.obs as jobs

    assert set(jobs.__all__) - {"TimeSeriesStore"} <= set(pobs.__all__)
    for name in jobs.__all__:
        if name != "TimeSeriesStore":
            assert callable(getattr(pobs, name)) or isinstance(
                getattr(pobs, name), tuple), name


# -- metrics ------------------------------------------------------------------

def _registry_script(mod, seed):
    """Seeded registry operations: counters, gauges, histograms with
    exemplars, label values that need escaping."""
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    c = reg.counter("demo_requests_total", "Requests served.",
                    labels=("op", "tenant"))
    g = reg.gauge("demo_queue_depth", "Queued rows.", labels=("tenant",))
    h = reg.histogram("demo_latency_seconds", "Latency \\ with\nescapes.",
                      labels=("tenant",))
    h2 = reg.histogram("demo_depth", "Replay depth.",
                       buckets=(0.0, 1.0, 2.0, 4.0, 8.0))
    bare = reg.counter("demo_bare_total", "No labels.")
    tenants = ['a', 'b"q', 'c\\d', 'e\nf']
    for i in range(int(rng.integers(20, 60))):
        t = tenants[int(rng.integers(0, len(tenants)))]
        c.inc("op%d" % int(rng.integers(0, 3)), t,
              amount=float(rng.integers(1, 5)))
        g.set(t, value=float(rng.normal()))
        v = float(rng.exponential(0.05))
        h.observe(t, value=v,
                  exemplar=("tr%d" % i) if rng.random() < 0.5 else None)
        h2.observe(value=float(rng.integers(0, 12)))
        bare.inc()
    g.inc(tenants[0], amount=2.5)
    values = [c.value("op0", tenants[0]), g.value(tenants[0]),
              bare.value(), h2.value() if hasattr(h2, "value") else None]
    return reg, values


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_render_parse_and_lint_as_jax(seed):
    jreg, jvals = _registry_script(jmetrics, seed)
    preg, pvals = _registry_script(pmetrics, seed)
    text = preg.render()
    assert text == jreg.render()
    assert pvals == jvals
    assert preg.collect() == jreg.collect()
    assert preg.families() == jreg.families()
    parsed = pmetrics.parse_exposition(text)
    assert parsed == jmetrics.parse_exposition(text)
    assert pmetrics.render_exposition(parsed) == \
        jmetrics.render_exposition(parsed)
    # the round trip holds through the port's parser
    assert pmetrics.parse_exposition(
        pmetrics.render_exposition(parsed)) == parsed
    assert pmetrics.lint_exposition(text) == \
        jmetrics.lint_exposition(text) == []
    q = [0.5, 0.9, 0.99]
    h = preg.get("demo_depth")
    jh = jreg.get("demo_depth")
    (pkey, pval), = h._series.items()
    (jkey, jval), = jh._series.items()
    assert [pmetrics.quantile_from_buckets(h.buckets, pval.counts, x)
            for x in q] == [jmetrics.quantile_from_buckets(
                jh.buckets, jval.counts, x) for x in q]


@pytest.mark.parametrize("text", [
    "# TYPE f counter\nf 1\n",
    "# HELP f h\nf 1\n",
    "this is not { exposition\n",
    "# HELP f h\n# TYPE f counter\n",
    '# HELP f_total c\n# TYPE f_total counter\n'
    'f_total 1 # {trace_id="x"} 0.5\n',
    '# HELP g a gauge\n# TYPE g gauge\ng_bucket{le="1"} 1 # {trace_id="x"} 0.5\n',
    '# HELP h x\n# TYPE h histogram\nh_bucket{le="1"} 1 # {span_id="x"} 1\n',
    'f{a="1",b="2"} NaN\nf{a="1"} +Inf 12345\n',
])
def test_lint_and_parse_agree_on_odd_exposition(text):
    assert pmetrics.lint_exposition(text) == jmetrics.lint_exposition(text)
    try:
        want = jmetrics.parse_exposition(text)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            pmetrics.parse_exposition(text)
        assert str(got.value) == str(exc)
    else:
        got = pmetrics.parse_exposition(text)
        assert json.dumps(got, default=str) == json.dumps(want, default=str)


def test_default_registry_renders_through_the_module_functions():
    fam = pmetrics.default_registry().counter(
        "test_torch_obs_default_total", "A family of this test.")
    fam.inc(amount=3.0)
    assert "test_torch_obs_default_total 3" in pmetrics.render_default()
    names = pmetrics.collect_default()["families"]
    assert names["test_torch_obs_default_total"] == "counter"
    assert pmetrics.lint_exposition(pmetrics.render_default()) == []


# -- trace --------------------------------------------------------------------

def _normalized(rows):
    """Span rows with span/parent ids renamed in order of appearance (the
    ids are random)."""
    names: dict = {"": ""}
    out = []
    for r in rows:
        r = dict(r)
        for key in ("span_id", "parent_id"):
            r[key] = names.setdefault(r[key], "s%d" % len(names))
        out.append(r)
    return out


def _trace_script(mod, clock):
    tr = mod.Tracer(capacity=6)
    tr.now_ms = lambda: clock.t
    clock.t = 1.0
    root = tr.begin("request", "t1", tenant="a")
    clock.t = 2.5
    with tr.span("transport", "t1", parent_id=root.span_id, op="execute"):
        clock.t = 7.25
    tr.record("token-grant", "t1", 2.0, 3.0, client="a/p", chip="c0")
    tr.record("execute", "t2", 4.0, 9.5, proc="chipproxy")
    clock.t = 11.0
    try:
        with tr.span("serve-batch", "t2", rows=3):
            clock.t = 12.0
            raise KeyError("x")
    except KeyError:
        pass
    tr.begin("submit", "t3")          # left open: closed at export
    for i in range(3):               # past capacity: the oldest go
        tr.record("step", "t3", 20.0 + i, 21.0 + i)
    return tr


def test_trace_exports_as_jax(tmp_path):
    jt = _trace_script(jtrace, Clock())
    pt = _trace_script(ptrace, Clock())
    assert len(pt.spans()) == len(jt.spans()) == 6
    pt.export_jsonl(tmp_path / "p.jsonl")
    jt.export_jsonl(tmp_path / "j.jsonl")
    prow = [json.loads(x) for x in open(tmp_path / "p.jsonl")]
    jrow = [json.loads(x) for x in open(tmp_path / "j.jsonl")]
    assert _normalized(prow) == _normalized(jrow)
    pc, jc = pt.chrome_trace(), jt.chrome_trace()
    for c in (pc, jc):
        for e in c["traceEvents"]:
            e.get("args", {}).pop("span_id", None)
            e.get("args", {}).pop("parent_id", None)
    assert pc == jc
    assert [s.to_dict()["name"] for s in pt.spans("t3")] == \
        [s.to_dict()["name"] for s in jt.spans("t3")]


def test_null_tracer_sinks_and_install_as_jax():
    seen = {"p": [], "j": []}
    psink = ptrace.add_span_sink(lambda s: seen["p"].append(s.to_dict()))
    jsink = jtrace.add_span_sink(lambda s: seen["j"].append(s.to_dict()))
    try:
        assert not ptrace.tracing_enabled()
        for mod in (ptrace, jtrace):
            tr = mod.get_tracer()
            sp = tr.begin("execute", "tid-null", x=1)
            tr.finish(sp)
            tr.record("transport", "tid-null", 1.0, 2.0)
        assert _normalized(seen["p"]) == _normalized(seen["j"])
        installed = ptrace.install_tracer()
        assert ptrace.get_tracer() is installed and ptrace.tracing_enabled()
        ptrace.uninstall_tracer()
        assert not ptrace.tracing_enabled()
        assert len(ptrace.new_trace_id()) == len(jtrace.new_trace_id()) == 32
    finally:
        ptrace.remove_span_sink(psink)
        jtrace.remove_span_sink(jsink)


# -- flight -------------------------------------------------------------------

def _flight_script(mod, trace_mod, dump_dir):
    clock = Clock(100.0)
    rec = mod.FlightRecorder(capacity=5, clock=clock, dump_dir=dump_dir,
                             max_dump_files=2)
    rec.note("proxy", "session-detached", client="a", trace_id="t1")
    clock.t = 101.0
    assert rec.sample_deltas("proxy", {"resumes_total": 1.0,
                                       "sessions": 2.0})
    clock.t = 102.0
    assert not rec.sample_deltas("proxy", {"resumes_total": 2.0})
    clock.t = 106.5
    assert rec.sample_deltas("proxy", {"resumes_total": 4.0,
                                       "sessions": 1.0})
    rec.alert({"tenant": "a", "objective": "serve-p99<=5ms",
               "state": "firing"})
    rec.on_span(trace_mod.Span(name="execute", trace_id="t1",
                               span_id="abc", start_ms=1.0, end_ms=2.5,
                               attrs={"proc": "chipproxy"}))
    rec.note("proxy", "session-resumed", client="a", last_rid=3)
    d1 = rec.trigger("slo-alert", tenant="a")
    clock.t = 107.0
    rec.note("serving", "shed", tenant="b", reason="rate-limit")
    rec.trigger("crash", error="X")
    clock.t = 108.0
    d3 = rec.trigger("manual")
    return rec, [d1, d3]


def test_flight_rings_dumps_and_files_as_jax(tmp_path):
    prec, pdumps = _flight_script(pflight, ptrace, str(tmp_path / "p"))
    jrec, jdumps = _flight_script(jflight, jtrace, str(tmp_path / "j"))
    strip = [{k: v for k, v in d.items() if k != "path"}
             for d in pdumps]
    assert strip == [{k: v for k, v in d.items() if k != "path"}
                     for d in jdumps]
    assert prec.ring() == jrec.ring()
    assert prec.state() == jrec.state()
    assert prec.state()["dropped"] == 2
    text = pflight.dump_jsonl(pdumps[0])
    assert text == jflight.dump_jsonl(jdumps[0])
    back = pflight.parse_dump_jsonl(text)
    assert back == jflight.parse_dump_jsonl(text)
    assert back["entries"] == pdumps[0]["entries"]
    # retention: two files on disk, the same names, the same bytes
    pfiles = sorted(p.name for p in (tmp_path / "p").iterdir())
    assert pfiles == sorted(p.name for p in (tmp_path / "j").iterdir())
    assert len(pfiles) == 2
    for name in pfiles:
        assert (tmp_path / "p" / name).read_text() == \
            (tmp_path / "j" / name).read_text()
    with pytest.raises(ValueError) as pe:
        pflight.parse_dump_jsonl(text.split("\n", 1)[1])
    with pytest.raises(ValueError) as je:
        jflight.parse_dump_jsonl(text.split("\n", 1)[1])
    assert str(pe.value) == str(je.value)


def test_default_recorder_sees_spans_and_the_crash_handler_dumps():
    rec = pflight.default_recorder()
    before = len(rec.ring())
    ptrace.get_tracer().record("execute", "tid-crash", 0.0, 1.0)
    assert len(rec.ring()) >= min(before + 1, pflight.DEFAULT_CAPACITY)
    assert rec.ring()[-1]["trace_id"] == "tid-crash"
    prior = sys.excepthook
    own = pflight.FlightRecorder(clock=Clock(5.0))
    seen = []
    pflight._orig_excepthook = lambda *a: seen.append(a[0])
    try:
        pflight.install_crash_handler(own)
        sys.excepthook(RuntimeError, RuntimeError("boom"), None)
    finally:
        sys.excepthook = prior
        pflight._orig_excepthook = None
    assert seen == [RuntimeError]
    (dump,) = own.dumps()
    assert dump["reason"] == "crash"
    assert dump["attrs"] == {"error": "RuntimeError", "detail": "boom"}


# -- ledger -------------------------------------------------------------------

_LEDGER_OPS = ("grant", "release", "execute_begin", "execute_end",
               "mark_preempted", "mark_reserving", "commit", "pause",
               "unpause")


def _ledger_script(seed):
    """A seeded transition script: (op, chip, tenant, class, dt)."""
    rng = np.random.default_rng(seed)
    script = []
    for _ in range(int(rng.integers(60, 160))):
        op = _LEDGER_OPS[int(rng.integers(0, len(_LEDGER_OPS)))]
        chip = "chip-%d" % int(rng.integers(0, 2))
        tenant = "t%d" % int(rng.integers(0, 3))
        cls = ("latency", "best-effort")[int(rng.integers(0, 2))]
        # now and then a clock regression, which the ledger guards
        dt = float(rng.exponential(0.01)) * (-0.3 if rng.random() < 0.05
                                             else 1.0)
        script.append((op, chip, tenant, cls, dt))
    return script


def _run_ledger(mod, script, max_intervals=4096):
    clock = Clock(10.0)
    led = mod.ChipTimeLedger(clock=clock, max_intervals=max_intervals)
    for op, chip, tenant, cls, dt in script:
        clock.t += dt
        if op in ("grant", "mark_reserving"):
            getattr(led, op)(chip, tenant, cls, gang="g" if op ==
                             "mark_reserving" else "")
        else:
            getattr(led, op)(chip)
    clock.t += 0.05
    return led, clock


@pytest.mark.parametrize("seed,max_intervals", [(0, 4096), (1, 4096),
                                                (2, 16), (3, 4096)])
def test_ledger_transitions_account_as_jax(seed, max_intervals):
    script = _ledger_script(seed)
    pled, pclock = _run_ledger(pledger, script, max_intervals)
    jled, _ = _run_ledger(jledger, script, max_intervals)
    _approx_tree(pled.snapshot(), jled.snapshot())
    _approx_tree(pled.conservation(), jled.conservation())
    assert pled.check() == jled.check()
    assert pled.chips() == jled.chips()
    for chip in pled.chips():
        for a, b in ((10.0, 10.2), (10.1, pclock.t), (0.0, 99.0)):
            _approx_tree(pled.account(chip, a, b), jled.account(chip, a, b))
    if max_intervals == 4096:
        assert pled.check() == []


def test_ledger_preempted_tag_starts_at_the_mark():
    led = pledger.ChipTimeLedger(clock=Clock())
    led.grant("c", "flood", "best-effort", now=1.0)
    led.execute_begin("c", now=1.5)
    led.mark_preempted("c", now=2.0)
    led.execute_end("c", now=3.0)
    led.release("c", now=3.5)
    rows = led.account("c", 0.0, 4.0, now=4.0)
    tagged = sum(r["overlap_s"] for r in rows if r["preempted"])
    assert abs(tagged - 1.5) < 1e-12
    assert led.check(now=4.0) == []


# -- blame --------------------------------------------------------------------

def _family_lines(registry, family, label, prefix):
    """One family's sample lines whose ``label`` starts with ``prefix``
    (a test's own series in a process-wide registry)."""
    fam = registry.get(family)
    if fam is None:
        return []
    return [line for line in fam.render()
            if not line.startswith("#")
            and ('%s="%s' % (label, prefix)) in line]


def _blame_script(mod_ledger, mod_blame, seed, prefix):
    rng = np.random.default_rng(seed)
    led = mod_ledger.ChipTimeLedger(clock=Clock())
    graph = mod_blame.BlameGraph(led)
    now = 0.0
    tenants = [prefix + n for n in ("lat", "flood", "other")]
    out = []
    for _ in range(int(rng.integers(20, 50))):
        chip = "c%d" % int(rng.integers(0, 2))
        holder = tenants[int(rng.integers(0, 3))]
        led.grant(chip, holder, "best-effort", now=now)
        led.execute_begin(chip, now=now + 0.001)
        if rng.random() < 0.4:
            led.mark_preempted(chip, now=now + 0.004)
        led.execute_end(chip, now=now + 0.008)
        if rng.random() < 0.2:
            led.release(chip, now=now + 0.009)
            led.pause(chip, now=now + 0.0095)
            led.unpause(chip, now=now + 0.011)
        else:
            led.release(chip, now=now + 0.011)
        now += 0.012
        victim = tenants[int(rng.integers(0, 3))]
        wait = float(rng.uniform(0.0, 0.03))
        out.append(graph.account_wait(
            chip, victim, "latency", wait, now=now,
            trace_id="tr%d" % len(out), granted=bool(rng.random() < 0.8)))
    return graph, out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_blame_edges_and_counters_as_jax(seed):
    prefix = "bl%d-" % seed
    pgraph, pout = _blame_script(pledger, pblame, seed, prefix)
    jgraph, jout = _blame_script(jledger, jblame, seed, prefix)
    _approx_tree(pout, jout)
    assert pgraph.edges() == jgraph.edges()
    assert pgraph.top_blamed() == jgraph.top_blamed()
    assert pgraph.top_blamed(prefix + "lat", n=2) == \
        jgraph.top_blamed(prefix + "lat", n=2)
    _approx_tree(pgraph.victims(), jgraph.victims())
    assert pgraph.state() == jgraph.state()
    kinds = {e["kind"] for e in pgraph.edges()}
    assert {"hold", "preempted", "migration"} <= kinds
    assert _family_lines(pmetrics.default_registry(),
                         "kubeshare_blame_wait_seconds_total", "victim",
                         prefix) == \
        _family_lines(jmetrics.default_registry(),
                      "kubeshare_blame_wait_seconds_total", "victim", prefix)


# -- slo ----------------------------------------------------------------------

@pytest.mark.parametrize("text", [
    "grant-wait-p99<=50ms", "queue-wait-p90<=2s", "availability>=99.9",
    "availability>=99.9%", "grant-wait-p99<=50ms,availability>=99.9",
    "serve-p99.9<=0.5,serve-availability>=95",
    "", ",", "grant-wait-p99<=50ms,", "grant-wait<=50ms",
    "grant-wait-p99>=50ms", "grant-wait-p99<=50%", "grant-wait-p0<=50ms",
    "availability<=99", "availability>=100", "availability>=0",
    "availability>=99ms", "Grant-Wait-p99<=50ms",
    "grant-wait-p99<=50ms,grant-wait-p99<=50ms", "serve-p99<=0ms",
])
def test_parse_slo_as_jax(text):
    try:
        want = [s.to_dict() for s in jslo.parse_slo(text)]
    except jslo.SloError as exc:
        with pytest.raises(pslo.SloError) as got:
            pslo.parse_slo(text)
        assert str(got.value) == str(exc)
        assert isinstance(got.value, ValueError)
        return
    got = pslo.parse_slo(text)
    assert [s.to_dict() for s in got] == want
    assert [s.budget for s in got] == [s.budget
                                       for s in jslo.parse_slo(text)]


def _slo_script(mod, seed):
    rng = np.random.default_rng(seed)
    clock = Clock(1000.0)
    ev = mod.SloEvaluator(fast_window_s=5.0, slow_window_s=30.0,
                          burn_threshold=4.0, min_samples=3, clock=clock)
    seen = []
    ev.add_listener(lambda e: seen.append(e.to_dict()))
    ev.add_listener(lambda e: 1 / 0)        # a broken listener is skipped
    ev.declare("slo-a", "serve-p99<=20ms,serve-availability>=99")
    ev.declare("slo-b", [mod.parse_slo("grant-wait-p90<=5ms")[0]])
    events = []
    for step in range(240):
        clock.t += 0.25
        bad_phase = 60 <= step < 140
        for tenant, ind in (("slo-a", "serve"), ("slo-b", "grant-wait"),
                            ("slo-c", "serve")):
            v = float(rng.exponential(0.03 if bad_phase else 0.004))
            ev.record(tenant, ind, value_s=v, trace_id="tr%d" % step)
        ev.record("slo-a", "serve-availability",
                  ok=bool(rng.random() > (0.2 if bad_phase else 0.0)))
        if step % 4 == 0:
            events += [e.to_dict() for e in ev.evaluate()]
    return ev, events, seen


@pytest.mark.parametrize("seed", [0, 5])
def test_slo_evaluator_alerts_as_jax(seed):
    pev, pevents, pseen = _slo_script(pslo, seed)
    jev, jevents, jseen = _slo_script(jslo, seed)
    assert pevents == jevents and pevents
    assert {e["state"] for e in pevents} == {"firing", "resolved"}
    assert pseen == jseen == pevents
    assert [e.to_dict() for e in pev.events()] == \
        [e.to_dict() for e in jev.events()]
    assert pev.firing() == jev.firing()
    assert pev.tenants() == jev.tenants() == ["slo-a", "slo-b"]
    assert pev.state() == jev.state()
    pev.undeclare("slo-b")
    jev.undeclare("slo-b")
    assert pev.state() == jev.state()


def test_slo_default_evaluator_is_settable():
    mine = pslo.SloEvaluator()
    before = pslo.default_evaluator()
    pslo.set_default_evaluator(mine)
    try:
        assert pslo.default_evaluator() is mine
    finally:
        pslo.set_default_evaluator(before)
    with pytest.raises(ValueError):
        pslo.SloEvaluator(fast_window_s=10.0, slow_window_s=5.0)


# -- prof ---------------------------------------------------------------------

def test_phase_profiler_as_jax():
    out = []
    for mod in (pprof, jprof):
        wall = Clock()
        prof = mod.PhaseProfiler("obs-phase-test", wall=wall)
        for i in range(4):
            sp = prof.span()
            wall.t += 0.5
            sp.lap("admit")
            wall.t += 0.25 * (i + 1)
            sp.lap("bind")
            wall.t += 0.125
            sp.close("publish" if i % 2 else "")
        out.append((prof.state(), prof.coverage()))
    assert out[0] == out[1]
    assert out[0][1] < 1.0


def test_tracked_locks_count_as_jax():
    out = []
    for mod in (pprof, jprof):
        clock = Clock()
        lock = mod.TrackedLock("obs-lock-test-%s" % mod.__name__, clock=clock)
        for i in range(20):
            with lock:
                clock.t += 0.001 * (i + 1)
        rl = mod.TrackedRLock("obs-rlock-test", clock=clock)
        with rl:
            with rl:
                clock.t += 0.5
        cond = mod.TrackedCondition("obs-cond-test", clock=clock)
        with cond:
            clock.t += 0.25
            cond.wait(0.0)
        st = lock.stats()
        st.pop("name")
        st["top_sites"] = [s["held_s"] for s in st["top_sites"]]
        rst = rl.stats()
        cst = cond.tracked.stats()
        out.append((st, rst["acquisitions"], rst["hold_total_s"],
                     cst["acquisitions"], cst["hold_total_s"]))
    assert out[0] == out[1]
    assert out[0][0]["acquisitions"] == 20
    assert out[0][0]["contended"] == 0


class CountingClock(Clock):
    def __init__(self, t=0.0):
        super().__init__(t)
        self.reads = 0

    def __call__(self):
        self.reads += 1
        return self.t


def _contended(mod, name):
    """One contended acquire on a clock that moves only while the
    waiter is parked: its wait is exactly 2 s."""
    clock = CountingClock()
    lock = mod.TrackedLock(name, clock=clock)
    lock.acquire()                # sampled: one clock read
    t = threading.Thread(target=lambda: (lock.acquire(), lock.release()))
    t.start()
    import time as _time
    deadline = _time.monotonic() + 10.0
    while clock.reads < 2 and _time.monotonic() < deadline:
        _time.sleep(0.001)        # the waiter read its start, then blocks
    clock.t = 2.0
    lock.release()
    t.join(10.0)
    st = lock.stats()
    st.pop("top_sites")
    return st, lock


def test_a_contended_tracked_lock_counts_its_wait_as_jax():
    st, lock = _contended(pprof, "obs-contended-test")
    assert st == _contended(jprof, "obs-contended-test")[0]
    assert st["contended"] == 1 and st["acquisitions"] == 2
    assert st["wait_total_s"] == 2.0
    pprof.sync_metrics()
    row = [r for r in pprof.snapshot()["locks"]
           if r["name"] == "obs-contended-test"]
    assert row and row[0]["contended"] == 1
    assert pprof.top_wait_totals(n=1000)["obs-contended-test"] == 2.0
    text = pmetrics.default_registry().render()
    assert ('kubeshare_lock_contended_total{lock="obs-contended-test"} 1'
            in text)
    assert lock.holder() is None


class _Code:
    def __init__(self, name):
        self.co_name = name


class _Frame:
    def __init__(self, names):
        self.f_code = _Code(names[-1])
        self.f_back = _Frame(names[:-1]) if len(names) > 1 else None


def test_stack_sampler_folds_and_exports_as_jax():
    frames = {10**9 + 1: _Frame(["main", "serve", "handle"]),
              10**9 + 2: _Frame(["main", "worker"])}
    out = []
    for mod in (pprof, jprof):
        s = mod.StackSampler(interval_s=0.01)
        for _ in range(3):
            assert s.sample_once(frames) == 2
        s.sample_once({10**9 + 2: _Frame(["main", "idle"])})
        sp = s.speedscope()
        sp.pop("exporter")
        out.append((s.folded(), sp, s.samples))
    assert out[0] == out[1]
    assert pprof.StackSampler().speedscope()["exporter"] == \
        "kubeshare_tpu_torch.obs.prof"


# -- critpath -----------------------------------------------------------------

def _critpath_spans(rng, n, proc="worker"):
    """Spans of ``n`` requests as two processes export them: the client's
    (request root, transport) and the server's (token-grant, execute,
    nested execute, from ``proc``), on separate epochs. A chip proxy's
    execute holds its grant wait; a ``worker``'s does not."""
    client, proxy = [], []
    for i in range(n):
        tid = "cp%03d" % i
        t0 = float(rng.uniform(0, 1000))
        wall = float(rng.uniform(5, 50))
        grant = float(rng.uniform(0, wall / 3))
        execute = float(rng.uniform(0.1, wall / 3))
        client.append({"name": "request", "trace_id": tid, "span_id": "r",
                       "parent_id": "", "start_ms": t0,
                       "end_ms": t0 + wall, "attrs": {}})
        client.append({"name": "transport", "trace_id": tid,
                       "span_id": "x", "parent_id": "r",
                       "start_ms": t0 + 1, "end_ms": t0 + wall - 1,
                       "attrs": {"proc": "client"}})
        p0 = float(rng.uniform(5000, 6000))
        proxy.append({"name": "token-grant", "trace_id": tid,
                      "span_id": "g", "parent_id": "",
                      "start_ms": p0, "end_ms": p0 + grant, "attrs": {}})
        start = p0 if proc == "chipproxy" else p0 + grant
        for j, (s, e) in enumerate(((start, p0 + grant + execute),
                                    (p0 + grant + execute / 4,
                                     p0 + grant + execute / 2))):
            proxy.append({"name": "execute", "trace_id": tid,
                          "span_id": "e%d" % j, "parent_id": "",
                          "start_ms": s, "end_ms": e,
                          "attrs": {"proc": proc}})
    proxy.append({"name": "execute", "trace_id": "noroot",
                  "span_id": "z", "parent_id": "", "start_ms": 0.0,
                  "end_ms": 1.0, "attrs": {}})
    return client, proxy


@pytest.mark.parametrize("seed", [0, 3])
def test_critpath_assembles_as_jax(tmp_path, seed):
    rng = np.random.default_rng(seed)
    client, proxy = _critpath_spans(rng, 12)
    paths = []
    for name, rows in (("client", client), ("proxy", proxy)):
        path = tmp_path / ("%s.jsonl" % name)
        path.write_text("".join(json.dumps(r) + "\n" for r in rows))
        paths.append(str(path))
    # a flight dump as a third source: header, a note, a span
    dump = tmp_path / "flight.jsonl"
    dump.write_text(pflight.dump_jsonl({
        "reason": "manual", "t": 1.0, "seq": 1, "entries": [
            {"kind": "note", "t": 1.0, "subsystem": "proxy",
             "event": "x", "attrs": {}},
            dict(proxy[0], kind="span", t=1.0)]}))
    paths.append(str(dump))
    pspans = pcritpath.load_spans(paths)
    assert pspans == jcritpath.load_spans(paths)
    ptr = pcritpath.assemble(pspans)
    assert ptr == jcritpath.assemble(pspans)
    assert len(ptr) == 12
    assert all(0.0 < t["coverage"] <= 1.0 for t in ptr)
    assert pcritpath.assemble(pspans, trace_id="cp003") == \
        jcritpath.assemble(pspans, trace_id="cp003")
    rep = pcritpath.report(ptr)
    assert rep == jcritpath.report(ptr)
    assert pcritpath.render_report(rep, ptr) == \
        jcritpath.render_report(rep, ptr)
    assert pcritpath.render_report(pcritpath.report([])) == \
        jcritpath.render_report(jcritpath.report([]))
    entries = pflight.parse_dump_jsonl(dump.read_text())["entries"]
    assert pcritpath.spans_from_flight_entries(entries) == \
        jcritpath.spans_from_flight_entries(entries)


def test_critpath_counts_a_proxy_grant_wait_once(tmp_path):
    """Divergence on purpose: a chip proxy's execute span holds its token
    wait, which the JAX module then counts twice (as grant-wait and
    inside execute, the sum past wall time); the port takes it out of
    execute, and the segments partition the wall."""
    client, proxy = _critpath_spans(np.random.default_rng(4), 12,
                                    proc="chipproxy")
    spans = [pcritpath._span_row(r, "client") for r in client]
    spans += [pcritpath._span_row(r, "proxy") for r in proxy]
    port = pcritpath.assemble(spans)
    jax = jcritpath.assemble(spans)
    assert len(port) == len(jax) == 12
    over = 0
    for p, j in zip(port, jax):
        segs, jsegs = p["segments"], j["segments"]
        assert segs["transport"] == jsegs["transport"]
        assert segs["grant-wait"] == jsegs["grant-wait"] > 0.0
        assert segs["execute"] == pytest.approx(
            jsegs["execute"] - jsegs["grant-wait"], abs=2e-3)
        assert sum(segs.values()) <= p["wall_ms"] * 1.01
        over += sum(jsegs.values()) > j["wall_ms"] * 1.01
    assert over > 0


def test_critpath_drops_transport_without_the_proxys_spans():
    rows = [{"name": "request", "trace_id": "t", "start_ms": 0.0,
             "end_ms": 10.0},
            {"name": "transport", "trace_id": "t", "start_ms": 1.0,
             "end_ms": 9.0, "attrs": {"proc": "client"}}]
    spans = [pcritpath._span_row(r, "src") for r in rows]
    (t,) = pcritpath.assemble(spans)
    assert t["segments"]["transport"] == 0.0 and t["coverage"] == 0.0
    assert (t,) == tuple(jcritpath.assemble(spans))
