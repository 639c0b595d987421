"""The port's serving plane against the JAX package's: admission and
shedding, batching bounds, class priority, accounting, park/resume, the
virtual-time simulation, and ``ProxyServable`` on a CPU ``ChipProxy``.

Mirrors ``tests/test_serving.py`` (its chaos, SLO and service-route cases
wait for those planes of the port). Each deterministic case drives the
port's front door and the JAX package's with the same requests on the
same manual clock and requires the same outcome.
"""

import json
import random
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kubeshare_tpu.models import tinymlp as jtiny
from kubeshare_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from kubeshare_tpu.scheduler.dispatcher import Overloaded as JaxOverloaded
from kubeshare_tpu import serving as jserving
from kubeshare_tpu_torch import serving
from kubeshare_tpu_torch.isolation.client import ProxyClient
from kubeshare_tpu_torch.isolation.proxy import ChipProxy
from kubeshare_tpu_torch.isolation.tokensched import TokenScheduler
from kubeshare_tpu_torch.models import tinymlp
from kubeshare_tpu_torch.obs.metrics import (MetricsRegistry,
                                             quantile_from_buckets)
from kubeshare_tpu_torch.serving import (ContinuousBatcher, FrontDoor,
                                         LocalServable, Overloaded,
                                         ProxyServable, ServingAccounting,
                                         SessionParked, TokenBucket,
                                         simulate_serving)

WINDOW, BASE, MIN = 1000.0, 100.0, 10.0


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # the suite runs in parallel workers: keep torch's CPU kernels from
    # taking every core from the timing-sensitive tests of other workers
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


class Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def row(v, features=4):
    return np.full((1, features), float(v), dtype=np.float32)


@pytest.fixture
def clock():
    return Clock()


def make_stack(clock, max_queue=16, batch=8, max_wait=0.01,
               fn=lambda x: x * 2.0, pkg="port"):
    """A front door and batcher of either package on ``clock``."""
    mod = serving if pkg == "port" else jserving
    reg = MetricsRegistry() if pkg == "port" else JaxRegistry()
    fd = mod.FrontDoor(max_queue=max_queue, clock=clock,
                       accounting=mod.ServingAccounting(reg))
    batcher = mod.ContinuousBatcher(fd, mod.LocalServable(fn, batch),
                                    max_wait_s=max_wait, clock=clock)
    return fd, batcher


def both(scenario):
    """``scenario(pkg) -> observations`` on both packages; equal."""
    got = scenario("port")
    assert got == scenario("jax")
    return got


def _shed_reason(fd, *args, **kw):
    try:
        fd.submit(*args, **kw)
        return None
    except (Overloaded, JaxOverloaded) as e:
        return e.reason


# -- admission ----------------------------------------------------------------

def test_token_bucket_is_deterministic_under_explicit_clock():
    def scenario(pkg):
        b = (TokenBucket if pkg == "port" else jserving.TokenBucket)(2.0, 2.0)
        return [b.try_take(t) for t in (0.0, 0.0, 0.0, 0.4, 0.5, 0.5)]

    assert both(scenario) == [True, True, False, False, True, False]


def test_rate_limit_sheds_with_reason_and_accounts():
    def scenario(pkg):
        clock = Clock()
        fd, batcher = make_stack(clock, pkg=pkg)
        fd.register_tenant("t", rate=2.0, burst=2.0)
        out = [_shed_reason(fd, "t", row(i)) for i in (1, 2, 3)]
        out += [fd.shed_total, fd.admitted_total,
                fd.accounting.sheds.value("t", "rate-limit")]
        clock.t += 1.0
        out.append(_shed_reason(fd, "t", row(4)))
        out.append(batcher.flush(clock.t))
        return out

    assert both(scenario) == [None, None, "rate-limit", 1, 2, 1.0, None, 3]


def test_global_queue_bound_sheds_max_pending():
    def scenario(pkg):
        fd, _ = make_stack(Clock(), max_queue=3, pkg=pkg)
        return [_shed_reason(fd, "solo", row(i)) for i in range(4)]

    assert both(scenario) == [None, None, None, "max-pending"]


def test_fair_share_protects_second_tenant():
    def scenario(pkg):
        fd, _ = make_stack(Clock(), max_queue=8, pkg=pkg)
        out = [_shed_reason(fd, "hog", row(i)) for i in range(6)]
        out.append(_shed_reason(fd, "small", row(0)))
        out.append(_shed_reason(fd, "hog", row(9)))
        out.append(_shed_reason(fd, "small", row(1)))
        out.append(fd.accounting.sheds.value("hog", "fair-share"))
        return out

    assert both(scenario) == [None] * 7 + ["fair-share", None, 1.0]


# -- batching bounds ----------------------------------------------------------

def test_lone_request_ships_only_after_max_wait(clock):
    fd, batcher = make_stack(clock, max_wait=0.01)
    req = fd.submit("t", row(21))
    assert batcher.step(clock.t) == 0
    clock.t += 0.009
    assert batcher.step(clock.t) == 0
    clock.t += 0.001
    assert batcher.step(clock.t) == 1
    np.testing.assert_allclose(req.result(0), row(21) * 2.0)
    assert batcher.next_deadline() is None


def test_full_batch_ships_immediately_and_respects_max_batch():
    def scenario(pkg):
        clock = Clock()
        fd, batcher = make_stack(clock, max_queue=32, batch=8, pkg=pkg)
        reqs = [fd.submit("t", row(i)) for i in range(20)]
        out = [batcher.ready(clock.t), batcher.step(clock.t),
               batcher.step(clock.t), batcher.step(clock.t)]
        clock.t += 0.011
        out.append(batcher.step(clock.t))
        out.append([float(r.result(0)[0, 0]) for r in reqs])
        return out

    got = both(scenario)
    assert got[:5] == [True, 8, 8, 0, 4]
    assert got[5] == [2.0 * i for i in range(20)]


def test_batch_groups_only_compatible_signatures(clock):
    fd, batcher = make_stack(clock, batch=8)
    a = fd.submit("t", row(1, features=4))
    b = fd.submit("t", np.ones((1, 6), dtype=np.float32))
    clock.t += 0.02
    assert batcher.step(clock.t) == 1
    assert a.done and not b.done
    assert batcher.step(clock.t) == 1
    assert b.done


def test_failed_execution_fails_riders_loudly_never_drops(clock):
    def boom(x):
        raise RuntimeError("backend gone")

    fd, batcher = make_stack(clock, fn=boom)
    reqs = [fd.submit("t", row(i)) for i in range(3)]
    clock.t += 0.02
    assert batcher.step(clock.t) == 3
    for r in reqs:
        with pytest.raises(RuntimeError, match="backend gone"):
            r.result(0)
    assert fd.failed_total == 3 and fd.completed_total == 0
    assert fd.admitted_total == fd.completed_total + fd.failed_total
    assert fd.accounting.requests.value("t", "best-effort", "failed") == 3


# -- class priority -----------------------------------------------------------

def test_latency_class_jumps_best_effort_queue():
    def scenario(pkg):
        clock = Clock()
        fd, _ = make_stack(clock, max_queue=32, batch=4, pkg=pkg)
        fd.register_tenant("lat", tpu_class="latency")
        for i in range(6):
            fd.submit("be", row(i))
        clock.t += 0.001
        fd.submit("lat", row(99))            # submitted LAST
        return [(r.tenant, r.rid) for r in fd.pop_batch(4)]

    got = both(scenario)
    assert got[0] == ("lat", 0)
    assert [t for t, _ in got].count("be") == 3


def test_pop_batch_order_equals_the_jax_front_door():
    """Seeded mixed traffic over two classes and four tenants, drained in
    batches of varied size: every batch's (tenant, rid) order is the JAX
    front door's."""
    def scenario(pkg):
        rng = random.Random(5)
        clock = Clock()
        fd, _ = make_stack(clock, max_queue=64, pkg=pkg)
        fd.register_tenant("lat-0", tpu_class="latency")
        fd.register_tenant("lat-1", tpu_class="latency")
        batches = []
        for i in range(120):
            clock.t += rng.uniform(0.0, 0.002)
            tenant = rng.choice(["lat-0", "lat-1", "be-0", "be-1"])
            width = rng.choice([4, 4, 4, 6])
            _shed_reason(fd, tenant, row(i, features=width))
            if i % 7 == 6:
                batches.append([(r.tenant, r.rid)
                                for r in fd.pop_batch(rng.choice([1, 3, 8]))])
        while True:
            batch = fd.pop_batch(5)
            if not batch:
                return batches
            batches.append([(r.tenant, r.rid) for r in batch])

    assert len(both(scenario)) > 20


def test_round_robin_across_same_class_tenants(clock):
    fd, _ = make_stack(clock, max_queue=32, batch=4)
    for i in range(4):
        fd.submit("a", row(i))
        clock.t += 1e-4
        fd.submit("b", row(i))
        clock.t += 1e-4
    batch = fd.pop_batch(4)
    assert sorted(r.tenant for r in batch) == ["a", "a", "b", "b"]


# -- accounting ---------------------------------------------------------------

def test_accounting_per_tenant_class_tokens_bytes_and_exemplars():
    def scenario(pkg):
        clock = Clock()
        fd, batcher = make_stack(clock, max_queue=16, fn=lambda x: x,
                                 pkg=pkg)
        fd.register_tenant("lat", tpu_class="latency")
        fd.submit("lat", row(1), trace_id="trace-lat-1")
        fd.submit("be", row(2), trace_id="trace-be-1")
        clock.t += 0.02
        n = batcher.step(clock.t)
        acct = fd.accounting
        return [n, acct.requests.value("lat", "latency", "completed"),
                acct.requests.value("be", "best-effort", "completed"),
                acct.tokens.value("lat", "latency"),
                acct.bytes.value("lat", "latency", "in"),
                acct.bytes.value("lat", "latency", "out"),
                acct.executions.value("lat", "latency"),
                acct.snapshot(), fd.accounting.latency.name]

    got = both(scenario)
    assert got[:7] == [2, 1.0, 1.0, 1.0, row(1).nbytes, row(1).nbytes, 1.0]
    snap = got[7]
    assert snap["tenants"]["lat"]["p99_ms"] > 0
    assert snap["batches"] == 1 and snap["batch_rows"] == 2


def test_exposition_equals_the_jax_renderer():
    """The port's metrics render the JAX module's text, exemplars on the
    latency histogram's bucket lines included."""
    texts = []
    for pkg in ("port", "jax"):
        reg = MetricsRegistry() if pkg == "port" else JaxRegistry()
        mod = serving if pkg == "port" else jserving
        acct = mod.ServingAccounting(reg)
        acct.note_admitted("t", "latency", 1)
        acct.note_shed("u", "best-effort", "fair-share")
        acct.note_completed("t", "latency", 0.0123, 1, 16, 16,
                            trace_id="trace-a")
        acct.note_completed("t", "latency", 0.5, 2, 32, 32)
        acct.note_batch(3)
        acct.set_queue_depth("t", 4)
        texts.append(reg.render())
    assert texts[0] == texts[1]
    assert 'trace_id="trace-a"' in texts[0]
    assert "kubeshare_serving_request_latency_seconds_bucket" in texts[0]
    from kubeshare_tpu.obs.metrics import quantile_from_buckets as jq
    buckets = (0.01, 0.1, 1.0, float("inf"))
    for cums in ([0, 0, 0, 0], [1, 3, 3, 3], [0, 2, 5, 9], [4, 4, 4, 4]):
        for q in (0.0, 0.5, 0.99, 1.0):
            a, b = quantile_from_buckets(buckets, cums, q), jq(buckets,
                                                               cums, q)
            assert a == b or (a != a and b != b)


def test_state_joins_queues_totals_and_knobs(clock):
    fd, batcher = make_stack(clock, max_queue=16)
    fd.register_tenant("lat", tpu_class="latency")
    fd.submit("lat", row(1))
    state = fd.state()
    assert state["attached"] is True
    assert state["tenants"]["lat"]["queued"] == 1
    assert state["totals"] == {"admitted": 1, "shed": 0, "completed": 0,
                               "failed": 0, "queued": 1}
    assert state["batcher"]["max_batch"] == 8
    clock.t += 0.02
    batcher.step(clock.t)
    state = fd.state()
    assert state["totals"]["completed"] == 1
    assert state["tenants"]["lat"]["watermark"] == 1


# -- park/resume --------------------------------------------------------------

def test_park_resume_in_flight_tenant_session():
    def scenario(pkg):
        clock = Clock()
        fd, batcher = make_stack(clock, max_queue=32, pkg=pkg)
        fd.register_tenant("s", tpu_class="latency", rate=100.0, burst=50.0)
        first = [fd.submit("s", row(i)) for i in range(2)]
        clock.t += 0.02
        assert batcher.step(clock.t) == 2
        mid = [fd.submit("s", row(10 + i)) for i in range(3)]
        manifest = fd.park("s")
        for r in mid:
            with pytest.raises((SessionParked, jserving.SessionParked)):
                r.result(0)
        fd2, batcher2 = make_stack(clock, max_queue=32, pkg=pkg)
        restored = fd2.resume(json.loads(json.dumps(manifest)))
        clock.t += 0.02
        n = batcher2.step(clock.t)
        out = [float(r.result(0)[0, 0]) for r in restored]
        state = fd2.state()["tenants"]["s"]
        nxt = fd2.submit("s", row(42))
        assert all(r.done for r in first)
        token = manifest.pop("token")
        assert token and len(token) == 16
        return [manifest, [r.rid for r in restored], n, out,
                fd.completed_total + fd2.completed_total,
                state["watermark"], state["class"], nxt.rid]

    manifest, rids, n, out, completed, mark, cls, nxt = both(scenario)
    assert manifest["class"] == "latency" and manifest["delivered"] == 2
    assert manifest["next_rid"] == 5 and len(manifest["pending"]) == 3
    assert rids == [2, 3, 4] and n == 3
    assert out == [20.0, 22.0, 24.0]
    assert completed == 5 and mark == 5 and cls == "latency" and nxt == 5


def test_resume_refuses_active_tenant_and_park_unknown(clock):
    fd, _ = make_stack(clock)
    fd.register_tenant("t")
    with pytest.raises(KeyError):
        fd.park("ghost")
    m = fd.park("t")
    fd.resume(m)
    with pytest.raises(ValueError, match="already active"):
        fd.resume(m)
    with pytest.raises(ValueError, match="unknown tpu_class"):
        fd.register_tenant("x", tpu_class="gold")


def test_no_admitted_request_dropped_under_seeded_churn():
    def scenario(pkg):
        rng = random.Random(17)
        clock = Clock()
        fd, batcher = make_stack(clock, max_queue=12, batch=4, pkg=pkg)
        fd.register_tenant("lat", tpu_class="latency")
        admitted, sheds = [], []
        parked_manifest, lat_parked = None, False
        for i in range(300):
            clock.t += rng.uniform(0.0005, 0.004)
            tenant = rng.choice(["lat", "be-1", "be-2"])
            if tenant == "lat" and lat_parked:
                continue
            try:
                admitted.append(fd.submit(tenant, row(i)))
            except (Overloaded, JaxOverloaded) as e:
                sheds.append((i, e.reason))
            batcher.step(clock.t)
            if i == 150:
                parked_manifest = fd.park("lat")
                lat_parked = True
            if i == 200:
                admitted.extend(fd.resume(parked_manifest))
                lat_parked = False
        clock.t += 1.0
        batcher.flush(clock.t)
        parked = sum(1 for r in admitted
                     if isinstance(r.error, (SessionParked,
                                             jserving.SessionParked)))
        done = sum(1 for r in admitted if r.done and r.error is None)
        assert done + parked == len(admitted)
        assert fd.completed_total == done
        return [sheds, done, parked, len(admitted)]

    _, done, parked, n = both(scenario)
    assert done > 0 and n == done + parked


# -- virtual-time simulation --------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(n_requests=400, tenants=4, qps=1600.0, seed=9, latency_tenants=0,
         max_batch=8, exec_time_s=0.01, max_queue=16),
    dict(n_requests=800, tenants=4, qps=1600.0, seed=7, latency_tenants=1,
         exec_time_s=0.01, max_queue=24),
    dict(n_requests=300, tenants=3, qps=400.0, seed=3, rate=60.0),
], ids=["saturated", "latency-flood", "rate-limited"])
def test_simulate_serving_returns_the_jax_dict(kw):
    """Same seed, same dict as the JAX package's simulation, exactly."""
    a = simulate_serving(**kw)
    assert a == simulate_serving(**kw)
    assert a == jserving.simulate_serving(**kw)
    assert a["dropped"] == 0 and a["completed"] == a["admitted"]


def test_simulate_serving_sheds_past_saturation_and_keeps_priority():
    sat = simulate_serving(n_requests=400, tenants=4, qps=1600.0, seed=9,
                           latency_tenants=0, max_batch=8,
                           exec_time_s=0.01, max_queue=16)
    assert sat["shed"] > 0 and sat["isolation_error"] < 0.1
    out = simulate_serving(n_requests=800, tenants=4, qps=1600.0, seed=7,
                           latency_tenants=1, exec_time_s=0.01,
                           max_queue=24)
    lat = out["tenants"]["tenant-0"]
    be_p99 = max(rec["p99_ms"] for rec in out["tenants"].values()
                 if rec["class"] == "best-effort")
    assert lat["class"] == "latency"
    assert lat["p99_ms"] < be_p99 / 2 and lat["p99_ms"] <= 50.0


def test_simulate_serving_refuses_an_slo_evaluator():
    with pytest.raises(NotImplementedError, match="SLO"):
        simulate_serving(n_requests=10, slo=object())


# -- ProxyServable on a CPU proxy ---------------------------------------------

@pytest.fixture
def proxy():
    p = ChipProxy(device="cpu", scheduler=TokenScheduler(WINDOW, BASE, MIN))
    p.serve()
    yield p
    p.close()


def _jax_apply(params, x):
    jparams = {k: {n: jnp.asarray(v) for n, v in layer.items()}
               for k, layer in params.items()}
    return np.asarray(jtiny.apply(jparams, jnp.asarray(x)))


def test_proxy_servable_equals_jax_tinymlp_apply(proxy):
    """Each batch is one execute of the exported ``tinymlp.apply`` on the
    proxy at 8 × 32; its rows equal the JAX package's ``apply`` on the same
    parameters and inputs (atol 1e-5)."""
    c = ProxyClient("127.0.0.1", proxy.port, "serve", 0.5, 1.0,
                    tpu_class="latency")
    servable = ProxyServable(c, seed=3)
    assert (servable.batch_size, servable.features) == (8, 32) == \
        (jtiny.BATCH_SIZE, jtiny.FEATURES)
    rng = np.random.default_rng(11)
    for _ in range(3):
        x = rng.standard_normal((8, 32)).astype(np.float32)
        y = servable.execute(x)
        assert y.shape == (8, tinymlp.CLASSES)
        np.testing.assert_allclose(y, _jax_apply(servable.params, x),
                                   atol=1e-5, rtol=0)
    sess = proxy._sessions["serve"]
    assert sess.tpu_class == "latency" and sess.exec_count == 3
    # params only: every output and upload was freed
    assert proxy.hbm_accounting()["serve"]["balanced"]
    assert sess.hbm_used == sum(v.nbytes for layer in servable.params.values()
                                for v in layer.values())
    servable.close()


def test_live_serving_through_the_proxy_matches_jax(proxy):
    """The wall-clock pump over a ProxyServable: four tenants, two
    classes; every admitted request completes with the JAX package's
    rows."""
    c = ProxyClient("127.0.0.1", proxy.port, "serve", 0.5, 1.0,
                    tpu_class="latency")
    servable = ProxyServable(c, seed=0)
    fd = FrontDoor(max_queue=64, accounting=ServingAccounting(
        MetricsRegistry()))
    for i, cls in enumerate(("latency", "latency", "best-effort",
                             "best-effort")):
        fd.register_tenant(f"t{i}", tpu_class=cls)
    batcher = ContinuousBatcher(fd, servable, max_batch=8, max_wait_s=0.004)
    stop = threading.Event()
    pump = threading.Thread(target=batcher.serve_loop, args=(stop,))
    pump.start()
    rng = np.random.default_rng(4)
    reqs = []
    try:
        for k in range(24):
            x = rng.standard_normal((1, 32)).astype(np.float32)
            reqs.append((fd.submit(f"t{k % 4}", x), x))
        for req, x in reqs:
            y = req.result(timeout=60.0)
            np.testing.assert_allclose(y, _jax_apply(servable.params, x),
                                       atol=1e-5, rtol=0)
    finally:
        stop.set()
        pump.join(timeout=30.0)
    assert not pump.is_alive()
    assert fd.completed_total == 24 and fd.failed_total == 0
    assert batcher.executions >= 3
    servable.close()


def test_local_servable_takes_a_torch_function():
    servable = LocalServable(lambda t: torch.relu(t) * 2.0, batch_size=4)
    x = np.array([[-1.0, 2.0]], dtype=np.float32)
    np.testing.assert_array_equal(servable.execute(x), [[0.0, 4.0]])
