"""Proxy-mode attach of the port: an unmodified PyTorch process whose
``torch.compile``'d calls are exported, shipped to the port's
``ChipProxy`` and run there, against the JAX package's train steps.

Mirrors the proxy cases of ``tests/test_attach.py``; also holds the
exported program's own cases (``isolation/exported.py``: what the proxy
refuses, the device rewrite, the shared cost model, charges by storage)
and the four kernels' custom ops on the CPU, where each runs its plain
version.
"""

import builtins
import io
import json
import os
import pickle
import subprocess
import sys
import time
import zipfile
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubeshare_tpu.models import mnist as jmnist
from kubeshare_tpu.models import transformer as jtrans
from kubeshare_tpu.models.common import make_train_step as jax_train_step
from kubeshare_tpu.ops.flash_attention import flash_attention as jax_flash
from kubeshare_tpu.ops.fused_adam import fused_adam as jax_fused_adam
from kubeshare_tpu_torch import attach, convert
from kubeshare_tpu_torch import constants as C
from kubeshare_tpu_torch.isolation import exported
from kubeshare_tpu_torch.isolation.client import ProxyClient, RemoteBuffer
from kubeshare_tpu_torch.isolation.proxy import IDLE_RELEASE_MS, ChipProxy
from kubeshare_tpu_torch.isolation.tokensched import TokenScheduler
from kubeshare_tpu_torch.models import common
from kubeshare_tpu_torch.models import mnist as tmnist
from kubeshare_tpu_torch.models import transformer as ttrans
from kubeshare_tpu_torch.ops import flash_attention as tflash
from kubeshare_tpu_torch.ops import fused_adam as tfa
from kubeshare_tpu_torch.ops.fused_adam import fused_adam
from kubeshare_tpu_torch.utils.tree import (tree_flatten, tree_leaves,
                                            tree_unflatten)

REPO = Path(__file__).resolve().parent.parent
SHIM = REPO / "kubeshare_tpu_torch" / "_shim"
LR = 1e-3
ATTACH_ENV = (C.ENV_CHIP_PROXY_PORT, C.ENV_POD_MANAGER_PORT,
              C.ENV_ATTACH_MODE, C.ENV_VISIBLE_CHIPS, C.ENV_POD_NAME,
              C.ENV_TPU_REQUEST, C.ENV_TPU_LIMIT, C.ENV_TPU_MEMORY)
MNIST_BATCH = 8
SMALL_LM = dict(seq_len=32, vocab=64, dim=64, layers=2)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # the suite runs in parallel workers: keep torch's CPU kernels from
    # taking every core from the timing-sensitive tests of other workers
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _clean_attach(monkeypatch):
    for var in ATTACH_ENV:
        monkeypatch.delenv(var, raising=False)
    # set, then removed: monkeypatch restores the variable as it was
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    yield
    attach.detach()


def _make_proxy() -> ChipProxy:
    p = ChipProxy(device="cpu", scheduler=TokenScheduler(
        window_ms=500, base_quota_ms=30, min_quota_ms=5))
    p.serve()
    return p


@pytest.fixture
def proxy():
    p = _make_proxy()
    yield p
    p.close()


def _fetch(tree):
    """A tree of remote tensors, fetched as host tensors."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [torch.from_numpy(np.asarray(x))
                                    for x in leaves])


def _mnist_batch(seed=4):
    x, y = tmnist.batch_fn(seed)
    return x[:MNIST_BATCH], y[:MNIST_BATCH]


def _jax_mnist_losses(params, batch, steps):
    """Losses of ``steps`` JAX train steps (fused Adam, jitted) from numpy
    ``params`` on one batch, the params after each step and the first
    step's grads."""
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jb = tuple(jnp.asarray(a) for a in batch)
    opt = jax_fused_adam(LR)
    step = jax.jit(jax_train_step(jmnist.loss_fn, opt))
    state, losses, after = opt.init(jp), [], []
    for _ in range(steps):
        jp, state, loss = step(jp, state, jb)
        losses.append(float(loss))
        after.append([np.asarray(p) for p in jax.tree_util.tree_leaves(jp)])
    _, grads = jax.value_and_grad(jmnist.loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, params), jb)
    return losses, after, \
        [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]


def _compiled_train(loss_fn, params, batch, steps, after=None):
    """The tenant's side: an unmodified loop over a ``torch.compile``'d
    train step on host tensors (under proxy attach: on the proxy).
    ``after`` (a list) gets the params fetched after each step: the step
    updates them in place, so a handle shows the latest values."""
    p = common.to_device(params, "cpu")
    opt = fused_adam(LR)
    state = opt.init(p)
    b = common.to_device(batch, "cpu")
    step = torch.compile(common.make_train_step(loss_fn, opt))
    losses = []
    for _ in range(steps):
        p, state, loss = step(p, state, b)
        losses.append(float(loss))
        if after is not None:
            after.append(tree_leaves(convert.params_to_jax(_fetch(p))))
    return p, state, losses


# --- in-process attach -------------------------------------------------------

def test_attach_proxy_routes_an_unmodified_compiled_step(proxy):
    """An unmodified loop over a ``torch.compile``'d mnist step runs every
    step on the proxy; results are handles that stay there and thread into
    the next call; detach restores ``torch.compile`` and the device env."""
    real_compile = torch.compile
    params = tmnist.init(3)
    attach.attach_proxy("127.0.0.1", proxy.port, "workload", 0.5, 1.0)
    assert attach.active_mode() == "proxy"
    assert os.environ["CUDA_VISIBLE_DEVICES"] == ""
    assert attach.real_compile() is real_compile
    p, state, losses = _compiled_train(tmnist.loss_fn, params,
                                       _mnist_batch(), 4)
    assert isinstance(p["fc1"]["w"], attach.RemoteTensor)
    assert p["fc1"]["w"].shape == torch.Size([3136, 256])
    assert p["fc1"]["w"].dtype == torch.float32
    assert float(state["count"]) == 4.0
    assert all(np.isfinite(losses))
    sess = proxy._sessions["workload"]
    assert sess.exec_count == 4              # every step ran ON the proxy
    # one program: the first call's host tensors, the next calls' handles
    assert len(sess.executables) == 1
    assert attach.proxy_usage()["exec_count"] == 4
    assert proxy.hbm_accounting()["workload"]["balanced"]
    attach.detach()
    assert torch.compile is real_compile
    assert "CUDA_VISIBLE_DEVICES" not in os.environ
    deadline = time.monotonic() + 5
    while "workload" in proxy._sessions and time.monotonic() < deadline:
        time.sleep(0.02)
    assert "workload" not in proxy._sessions


def test_proxy_attach_unforwarded_surface_fails_loudly(proxy):
    """CUDA in the tenant, a process group and ``torch.compile`` of a
    module raise an actionable error instead of computing on the client's
    CPU; what is forwarded still works; detach restores the originals."""
    import torch.distributed as dist

    real_lazy_init = torch.cuda._lazy_init
    real_init_pg = dist.init_process_group
    attach.attach_proxy("127.0.0.1", proxy.port, "surface", 0.5, 1.0)
    for fn in (lambda: torch.zeros(2, device="cuda"),
               lambda: torch.ones(2).cuda(),
               lambda: torch.ones(2).to("cuda"),
               lambda: torch.cuda.synchronize(),
               lambda: dist.init_process_group("gloo", rank=0,
                                               world_size=1)):
        with pytest.raises(RuntimeError, match="not supported under proxy"):
            fn()
    with pytest.raises(TypeError, match="not supported under proxy"):
        torch.compile(torch.nn.Linear(2, 2))
    assert not torch.cuda.is_available()
    # the forwarded subset: a compiled function, also as a decorator with
    # arguments, and host tensors
    double = torch.compile(fullgraph=True)(lambda x: x * 2.0)
    np.testing.assert_array_equal(np.asarray(double(torch.ones(3))),
                                  np.full(3, 2.0, np.float32))
    assert float(torch.ones(3).sum()) == 3.0
    attach.detach()
    assert torch.cuda._lazy_init is real_lazy_init
    assert dist.init_process_group is real_init_pg


def test_proxy_attach_caches_non_tensor_arguments_apart(proxy):
    """A non-tensor argument is baked into the trace, so each value gets
    its own program, as ``static_argnums`` do in the JAX package; a call
    under an enclosing trace is inlined."""
    attach.attach_proxy("127.0.0.1", proxy.port, "statics", 0.5, 1.0)
    traced = []

    @torch.compile
    def scale(x, k=2.0):
        traced.append(k)
        return x * k

    x = torch.full((3,), 3.0)
    assert np.asarray(scale(x))[0] == 6.0
    assert np.asarray(scale(x, k=4.0))[0] == 12.0
    assert np.asarray(scale(x, k=4.0))[0] == 12.0
    assert np.asarray(scale(torch.ones(5), k=4.0))[1] == 4.0
    assert traced == [2.0, 4.0, 4.0]        # three keys, three traces
    assert len(scale._cache) == 3

    @torch.compile
    def outer(x):
        return scale(x, k=0.5) + 1.0        # inlined into outer's trace

    assert np.asarray(outer(x))[0] == 2.5
    assert len(scale._cache) == 3
    assert proxy._sessions["statics"].exec_count == 5


def test_remote_tensor_reads_and_frees(proxy):
    attach.attach_proxy("127.0.0.1", proxy.port, "reads", 0.5, 1.0)
    f = torch.compile(lambda x: (x.sum(), x * 2))
    total, doubled = f(torch.arange(6, dtype=torch.float32).reshape(2, 3))
    assert (total.item(), float(total), int(total)) == (15.0, 15.0, 15)
    assert f"{total:.1f}" == "15.0" and bool(total)
    assert doubled.ndim == 2 and doubled.numel() == 6
    assert doubled.size(1) == 3 and doubled.tolist()[1] == [6.0, 8.0, 10.0]
    assert "RemoteTensor(shape=(2, 3)" in repr(doubled)
    sess = proxy._sessions["reads"]
    assert len(sess.buffers) == 2
    del total, doubled
    attach._active.shim.flush_frees()       # what the next call does first
    # the frees go out without waiting for their replies; the proxy runs a
    # session's requests in order, so the next request finds them done
    assert attach.proxy_usage()["hbm_used"] == 0
    assert sess.buffers == {} and sess.hbm_used == 0


# --- against the JAX package and the port's eager step ----------------------

def test_mnist_through_proxy_attach_matches_jax(proxy):
    """Three steps of the bf16 mnist step through proxy attach against the
    JAX package's, from the same params and batch, at the tolerances of
    ``test_mnist_bf16_matches_jax``: each loss to 1e-2 relative, and after
    the first step every param to 2*lr, the firm ones (|g| > 5e-3) to
    1e-6. Three steps of ~lr each: the final params to 3 * 2*lr."""
    params = jax.tree_util.tree_map(
        np.asarray, jmnist.init(jax.random.PRNGKey(3)))
    batch = _mnist_batch()
    jlosses, jafter, jgrads = _jax_mnist_losses(params, batch, 3)
    attach.attach_proxy("127.0.0.1", proxy.port, "parity", 0.5, 1.0)
    tafter = []
    _, _, losses = _compiled_train(tmnist.loss_fn,
                                   convert.params_from_jax(params), batch, 3,
                                   after=tafter)
    for t, j in zip(losses, jlosses):
        assert t == pytest.approx(j, rel=1e-2)
    for a, b, g in zip(jafter[0], tafter[0], jgrads):
        np.testing.assert_allclose(b, a, rtol=0, atol=2 * LR + 1e-6)
        firm = np.abs(g) > 5e-3
        np.testing.assert_allclose(b[firm], a[firm], rtol=0, atol=1e-6)
    for a, b in zip(jafter[-1], tafter[-1]):
        np.testing.assert_allclose(b, a, rtol=0, atol=3 * 2 * LR + 1e-6)
    assert proxy._sessions["parity"].exec_count == 3


def test_transformer_flash_through_proxy_attach_matches_jax(proxy):
    """One bf16 step of the small transformer with flash attention through
    proxy attach against the JAX ``flash_loss_fn`` step (its Pallas
    kernels in interpret mode), at the tolerances of
    ``test_transformer_bf16_matches_jax``: the loss to 1e-3 relative, every
    param to 2*lr, the firm ones (|g| > 1e-2) to 1e-6."""
    params = jax.tree_util.tree_map(
        np.asarray, jtrans.init(jax.random.PRNGKey(1), **SMALL_LM))
    batch = common.synthetic_token_batch(3, 2, SMALL_LM["seq_len"],
                                         SMALL_LM["vocab"])
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jb = tuple(jnp.asarray(a) for a in batch)
    jloss_fn = partial(jtrans.loss_fn, attn_fn=jax_flash)
    opt = jax_fused_adam(LR)
    jnew, _, jloss = jax_train_step(jloss_fn, opt)(jp, opt.init(jp), jb)
    _, jgrads = jax.value_and_grad(jloss_fn)(jp, jb)
    attach.attach_proxy("127.0.0.1", proxy.port, "lm", 0.5, 1.0)
    tafter = []
    _, _, losses = _compiled_train(ttrans.flash_loss_fn,
                                   convert.params_from_jax(params), batch, 1,
                                   after=tafter)
    assert losses[0] == pytest.approx(float(jloss), rel=1e-3)
    for a, b, g in zip(jax.tree_util.tree_leaves(jnew), tafter[0],
                       jax.tree_util.tree_leaves(jgrads)):
        a, g = np.asarray(a), np.asarray(g, np.float32)
        np.testing.assert_allclose(b, a, rtol=0, atol=2 * LR + 1e-6)
        firm = np.abs(g) > 1e-2
        np.testing.assert_allclose(b[firm], a[firm], rtol=0, atol=1e-6)
    # the exported step ran the port's flash ops, forward and backward
    exe = next(iter(proxy._sessions["lm"].executables.values()))
    ops = [str(n.target) for n in exe.program._module.graph.nodes]
    assert [ops.count(f"kubeshare_tpu_torch.{k}.default")
            for k in ("flash_fwd", "flash_dq", "flash_dkv", "fused_adam")] \
        == [2, 2, 2, 1]


@pytest.mark.parametrize("model", ["mnist", "transformer"])
def test_remote_step_equals_the_eager_step_bit_for_bit(proxy, model):
    """The remote step against the port's own eager step on the same
    device: the exported graph is the eager step's own aten ops in the
    eager order, so losses and params are equal bit for bit."""
    if model == "mnist":
        params, batch, loss_fn = tmnist.init(5), _mnist_batch(6), \
            tmnist.loss_fn
    else:
        params = ttrans.init(5, **SMALL_LM)
        batch = common.synthetic_token_batch(6, 2, SMALL_LM["seq_len"],
                                             SMALL_LM["vocab"])
        loss_fn = ttrans.flash_loss_fn
    eager = common.to_device(params, "cpu")
    opt = fused_adam(LR)
    state = opt.init(eager)
    step = common.make_train_step(loss_fn, opt)
    b = common.to_device(batch, "cpu")
    want = []
    for _ in range(3):
        eager, state, loss = step(eager, state, b)
        want.append(float(loss))
    attach.attach_proxy("127.0.0.1", proxy.port, "exact", 0.5, 1.0)
    remote, rstate, losses = _compiled_train(loss_fn, params, batch, 3)
    assert losses == want
    for a, r in zip(tree_leaves((eager, state)), tree_leaves((remote,
                                                              rstate))):
        np.testing.assert_array_equal(np.asarray(r), a.numpy())


# --- tenant processes ----------------------------------------------------------

TENANT = """
import json, sys
import numpy as np
import torch
from kubeshare_tpu_torch.models import common, mnist
from kubeshare_tpu_torch.ops.fused_adam import fused_adam

torch.set_num_threads(2)
data = np.load(sys.argv[1])
names = sorted(k for k in data.files if k.startswith("p/"))
params = {}
for k in names:
    _, layer, leaf = k.split("/")
    params.setdefault(layer, {})[leaf] = data[k]
steps = int(sys.argv[3])
dev = "cuda" if torch.cuda.is_available() else "cpu"
params = common.to_device(params, dev)
batch = common.to_device((data["x"], data["y"]), dev)
opt = fused_adam(1e-3)
state = opt.init(params)
step = torch.compile(common.make_train_step(mnist.loss_fn, opt))
losses = []
for i in range(steps):
    params, state, loss = step(params, state, batch)
    losses.append(float(loss))
    print("step", i, losses[-1], flush=True)
from kubeshare_tpu_torch import attach
with open(sys.argv[2], "w") as f:
    json.dump({"losses": losses, "attach": attach.active_mode(),
               "visible": __import__("os").environ.get(
                   "CUDA_VISIBLE_DEVICES"),
               "usage": attach.proxy_usage()}, f)
"""


def _pod_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ATTACH_ENV}
    env.update(PYTHONPATH=os.pathsep.join([str(SHIM), str(REPO)]),
               OMP_NUM_THREADS="2")
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _tenant_files(tmp_path, params, batch):
    data = {f"p/{layer}/{leaf}": v for layer, d in params.items()
            for leaf, v in d.items()}
    np.savez(tmp_path / "in.npz", x=batch[0], y=batch[1], **data)
    script = tmp_path / "tenant.py"
    script.write_text(TENANT)
    return script


def test_unmodified_tenant_process_trains_through_the_proxy(proxy,
                                                             tmp_path):
    """The zero-touch contract: a tenant process that holds no isolation
    code, attached by the shim from a pod's env alone, trains mnist
    through the proxy — every step runs there, with no CUDA device of its
    own — its losses match the JAX package's step, and its exit leaves no
    session behind."""
    params = jax.tree_util.tree_map(
        np.asarray, jmnist.init(jax.random.PRNGKey(7)))
    batch = _mnist_batch(8)
    jlosses, _, _ = _jax_mnist_losses(params, batch, 3)
    script = _tenant_files(tmp_path, convert.params_from_jax(params), batch)
    env = _pod_env(**{C.ENV_CHIP_PROXY_PORT: proxy.port,
                      C.ENV_POD_NAME: "mnist-pod", C.ENV_TPU_REQUEST: "0.5",
                      C.ENV_TPU_LIMIT: "1.0"})
    proc = subprocess.run([sys.executable, str(script), str(tmp_path /
                                                            "in.npz"),
                           str(tmp_path / "out.json"), "3"],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads((tmp_path / "out.json").read_text())
    assert rec["attach"] == "proxy" and rec["visible"] == ""
    assert rec["usage"]["exec_count"] == 3   # every step ran ON the proxy
    for t, j in zip(rec["losses"], jlosses):
        assert t == pytest.approx(j, rel=1e-2)
    deadline = time.monotonic() + 5
    while "mnist-pod" in proxy._sessions and time.monotonic() < deadline:
        time.sleep(0.05)
    assert "mnist-pod" not in proxy._sessions   # it unregistered on exit


def test_proxy_death_fails_the_tenant_fast(tmp_path):
    """A proxy that dies under a training tenant makes it fail at its next
    call, with an error — never a hang on a dead socket."""
    p = _make_proxy()
    script = _tenant_files(tmp_path, tmnist.init(0), _mnist_batch())
    env = _pod_env(**{C.ENV_CHIP_PROXY_PORT: p.port,
                      C.ENV_POD_NAME: "doomed-pod",
                      C.ENV_ATTACH_MODE: "proxy"})
    proc = subprocess.Popen([sys.executable, str(script),
                             str(tmp_path / "in.npz"),
                             str(tmp_path / "out.json"), "100000"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=env, cwd=str(REPO))
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:    # until it trains remotely
            sess = p._sessions.get("doomed-pod")
            if sess is not None and sess.exec_count >= 2:
                break
            assert proc.poll() is None, proc.stdout.read()[-2000:]
            time.sleep(0.1)
        t0 = time.monotonic()
        p.close()                             # the proxy dies
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode != 0, out[-2000:]
        assert time.monotonic() - t0 < 30
    finally:
        p.close()
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_shim_stops_the_pod_when_the_proxy_is_unreachable():
    """A pod whose env asks for proxy attach dies when no proxy answers,
    with the shim's message — it never runs on its own."""
    proc = subprocess.run(
        [sys.executable, "-c", "print('RAN UNMETERED')"],
        capture_output=True, text=True, timeout=120, cwd=str(REPO),
        env=_pod_env(**{C.ENV_CHIP_PROXY_PORT: "1",
                        C.ENV_POD_NAME: "lost"}))
    assert proc.returncode != 0
    assert "RAN UNMETERED" not in proc.stdout
    assert "refusing to run unmetered" in proc.stderr, proc.stderr[-2000:]


# --- the exported program --------------------------------------------------------

def _saved(fn, *args, device="cpu") -> bytes:
    return exported.export_program(fn, args, device)[0]


def _adam_and_factories(p, g, m, v, count):
    """No autograd: traceable on fake CUDA tensors here too. A factory op
    records the device it was traced on."""
    count.add_(1.0)
    ramp = torch.arange(p.shape[-1], device=p.device, dtype=p.dtype)
    tfa.adam_update(p, g * torch.ones(p.shape, device=p.device) + ramp, m,
                    v, count, lr=0.1)
    return p, m, v, count, (p * 2.0).sum()


def _adam_inputs():
    rng = np.random.default_rng(0)
    p, g = (torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))
            for _ in range(2))
    return p, g, torch.zeros(4, 3), torch.zeros(4, 3), torch.zeros(())


def test_a_graph_traced_for_cuda_runs_on_a_cpu_proxy(monkeypatch):
    """Devices are rewritten on load: a program traced on CUDA (fake)
    tensors — its factory ops record ``cuda`` — runs on the CPU, and
    matches the function run eagerly. (A process without CUDA traces on
    the CPU by itself, ``trace_device``: made to trace on ``cuda`` here.)"""
    assert exported.trace_device("cuda") == torch.device("cpu")
    monkeypatch.setattr(exported, "trace_device", torch.device)
    blob = _saved(_adam_and_factories, *_adam_inputs(), device="cuda")
    model = json.loads(zipfile.ZipFile(io.BytesIO(blob)).read(
        "archive/models/model.json"))
    assert '"type": "cuda"' in json.dumps(model)
    prog = exported.load_program(blob, "cpu")
    devices = {a.type for n in prog._module.graph.nodes
               for a in (*n.args, *n.kwargs.values())
               if isinstance(a, torch.device)}
    assert devices == {"cpu"}
    got = prog(*_adam_inputs())
    want = _adam_and_factories(*_adam_inputs())
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_the_program_key_ignores_where_it_was_traced_from():
    """Node metadata (stack traces, tracer ids) is dropped, so two exports
    of one function have one key; another function has another."""
    a = exported.canonical_archive(_saved(_adam_and_factories,
                                          *_adam_inputs()), "cpu")
    b = exported.canonical_archive(_saved(_adam_and_factories,
                                          *_adam_inputs()), "cpu")
    c = exported.canonical_archive(_saved(lambda x: x + 1.0,
                                          torch.zeros(3)), "cpu")
    assert a == b and a[0] != c[0]


def _rewrite(blob: bytes, edit) -> bytes:
    """``blob`` with its entries passed through ``edit(name, data) ->
    [(name, data), ...]``."""
    src = zipfile.ZipFile(io.BytesIO(blob))
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w") as w:
        for name in src.namelist():
            for n, d in edit(name, src.read(name)):
                w.writestr(n, d)
    return out.getvalue()


@torch.library.custom_op("kst_test_other::twice", mutates_args=())
def _other_namespace(x: torch.Tensor) -> torch.Tensor:
    return x * 2


@_other_namespace.register_fake
def _(x):
    return torch.empty_like(x)


def test_a_program_with_another_op_namespace_is_refused():
    blob = _saved(lambda x: _other_namespace(x) + 1.0, torch.zeros(3))
    with pytest.raises(exported.ProgramRefused,
                       match="kst_test_other.twice.default is not allowed"):
        exported.load_program(blob, "cpu")
    # the same by editing an allowed program's JSON: nothing is loaded
    good = _saved(lambda x: x + 1.0, torch.zeros(3))
    bad = _rewrite(good, lambda n, d: [(n, d.replace(
        b"torch.ops.aten.add.Tensor", b"torch.ops.profiler.x.default")
        if n.endswith("model.json") else d)])
    with pytest.raises(exported.ProgramRefused, match="profiler"):
        exported.load_program(bad, "cpu")
    assert float(exported.load_program(good, "cpu")(torch.zeros(3))[0][0]) \
        == 1.0


def test_an_aten_op_that_reaches_a_file_is_refused(tmp_path, monkeypatch):
    """An allowed program's JSON edited to map a file of the proxy's host
    (``aten.from_file``, shared, so a later in-place op would write it) is
    refused before anything is loaded, and the file is left as it was."""
    victim = tmp_path / "victim.bin"
    victim.write_bytes(np.arange(3, dtype=np.float32).tobytes())

    def from_file(n, d):
        if n.endswith("model.json"):
            model = json.loads(d)
            node = model["graph_module"]["graph"]["nodes"][0]
            node["target"] = "torch.ops.aten.from_file.default"
            node["inputs"] = [
                {"name": "filename", "arg": {"as_string": str(victim)},
                 "kind": 1},
                {"name": "shared", "arg": {"as_bool": True}, "kind": 1},
                {"name": "size", "arg": {"as_int": 3}, "kind": 1},
                {"name": "dtype", "arg": {"as_scalar_type": 7}, "kind": 2}]
            d = json.dumps(model).encode()
        return [(n, d)]

    def no_load(*_a, **_k):
        raise AssertionError("a refused program reached torch.export.load")

    bad = _rewrite(_saved(lambda x: x + 1.0, torch.zeros(3)), from_file)
    monkeypatch.setattr(torch.export, "load", no_load)
    with pytest.raises(exported.ProgramRefused, match="aten.from_file"):
        exported.load_program(bad, "cpu")
    assert victim.read_bytes() == np.arange(3, dtype=np.float32).tobytes()


@pytest.mark.parametrize("name, allowed", [
    ("aten.add.Tensor", True),
    ("aten.div.Tensor_mode", True),          # a string that picks a mode
    ("aten.gelu.default", True),
    ("aten.bernoulli.p", True),              # an optional generator
    ("kubeshare_tpu_torch.fused_adam.default", True),
    ("kubeshare_tpu_torch.flash_dkv.default", True),
    ("aten.from_file.default", False),       # reads or maps a file
    ("aten.save.default", False),            # writes a file
    ("aten.set_.source_Storage", False),     # takes a storage
    ("aten.record_stream.default", False),   # takes a stream
    ("aten._print.default", False),          # prints on the proxy
    ("aten.no_such_op.default", False),
])
def test_aten_ops_are_held_to_their_schema(name, allowed):
    assert exported._op_allowed(f"torch.ops.{name}") is allowed


class _Evil:
    def __reduce__(self):
        return exec, ("import builtins; builtins._KST_PICKLE_RAN = True",)


def test_pickled_code_is_never_loaded():
    """A pickled ``GraphModule`` is refused; so are weights, constants,
    guard code and extra entries. Example inputs — which
    ``torch.export.load`` would unpickle without the safe loader when that
    refuses them — are dropped unread."""
    graph = torch.fx.symbolic_trace(torch.nn.Linear(2, 2))
    buf = io.BytesIO()
    torch.save(graph, buf)
    with pytest.raises(exported.ProgramRefused, match="schema"):
        exported.load_program(buf.getvalue(), "cpu")
    with pytest.raises(exported.ProgramRefused, match="torch.export"):
        exported.load_program(pickle.dumps(_Evil()), "cpu")
    good = _saved(lambda x: x + 1.0, torch.zeros(3))
    planted = _rewrite(good, lambda n, d: [(n, pickle.dumps(_Evil())
                                            if n.endswith("model.pt")
                                            else d)])
    exported.load_program(planted, "cpu")
    assert not hasattr(builtins, "_KST_PICKLE_RAN")
    extra = _rewrite(good, lambda n, d: [(n, d)] + (
        [("archive/data/constants/tensor_0", pickle.dumps(_Evil()))]
        if n.endswith("model.json") else []))
    with pytest.raises(exported.ProgramRefused, match="tensor_0"):
        exported.load_program(extra, "cpu")
    weights = _rewrite(good, lambda n, d: [(n, b'{"config": {"w": {}}}'
                                            if "weights_config" in n
                                            else d)])
    with pytest.raises(exported.ProgramRefused, match="weights"):
        exported.load_program(weights, "cpu")

    def guard(n, d):
        if n.endswith("model.json"):
            model = json.loads(d)
            model["guards_code"] = ["import os"]
            d = json.dumps(model).encode()
        return [(n, d)]

    with pytest.raises(exported.ProgramRefused, match="guard code"):
        exported.load_program(_rewrite(good, guard), "cpu")
    assert not hasattr(builtins, "_KST_PICKLE_RAN")


def test_identical_tenants_share_one_cost_model(proxy):
    clients = [ProxyClient("127.0.0.1", proxy.port, f"twin-{i}", 0.5, 1.0)
               for i in range(3)]
    try:
        fn = lambda x, y: (x @ y).relu()
        exes = [c.compile(fn, torch.zeros(4, 4), torch.zeros(4, 4))
                for c in clients[:2]]
        other = clients[2].compile(lambda x, y: x @ y, torch.zeros(4, 4),
                                   torch.zeros(4, 4))
        costs = [next(iter(proxy._sessions[f"twin-{i}"].executables
                           .values())).cost for i in range(3)]
        assert costs[0] is costs[1] and costs[2] is not costs[0]
        x = torch.eye(4)
        for exe, c in zip(exes, clients):
            out = exe(x, x)
            np.testing.assert_array_equal(c.get(out), np.eye(4))
        assert other is not None
    finally:
        for c in clients:
            c.close()


def test_outputs_that_alias_inputs_are_charged_once(proxy):
    """The in-place Adam step returns its inputs: one storage, one charge
    against the memory cap, however many handles name it; freeing the
    input handles leaves the outputs valid."""
    c = ProxyClient("127.0.0.1", proxy.port, "alias", 0.5, 1.0,
                    memory=1 << 20)
    try:
        args = [c.put(x) for x in _adam_inputs()]
        exe = c.compile(_adam_and_factories, *args)
        state_bytes = 3 * 48 + 4                 # p, m, v and the count
        assert proxy.hbm_accounting()["alias"]["hbm_used"] == \
            state_bytes + 48                     # and g
        p, m, v, count, total = exe(*args)
        sess = proxy._sessions["alias"]
        assert p.handle != args[0].handle
        assert sess.buffers[p.handle] is sess.buffers[args[0].handle]
        acct = proxy.hbm_accounting()["alias"]
        assert acct["balanced"]
        assert acct["hbm_used"] == state_bytes + 48 + 4    # and the total
        c.free(*args)
        assert proxy.hbm_accounting()["alias"]["hbm_used"] == \
            state_bytes + 4
        want = _adam_and_factories(*_adam_inputs())
        np.testing.assert_array_equal(c.get(p), want[0].numpy())
        assert float(c.get(total)) == pytest.approx(float(want[4]))
        c.free(p, m, v, count, total)
        assert proxy.hbm_accounting()["alias"]["hbm_used"] == 0
    finally:
        c.close()


def _donate_sequence(c) -> tuple[list, list]:
    """tests/test_proxy.py's charge-and-donate sequence on a client of
    either package, then a donated upload and a donated put buffer: the
    ``hbm_used`` after each call, the values, and whether each donated
    handle still reads."""
    x = np.ones((8, 8), np.float32)
    bx = c.put(x)
    used = [c.usage()["hbm_used"]]
    exe = c.compile(lambda a: a * 2.0, bx)
    out = exe(bx)
    used.append(c.usage()["hbm_used"])
    out2 = exe(out, donate=True)              # frees `out` after success
    used.append(c.usage()["hbm_used"])
    out3 = exe(x * 3.0, donate=True)          # an upload, donated
    used.append(c.usage()["hbm_used"])
    out4 = exe(bx, donate=True)               # a put buffer, donated
    used.append(c.usage()["hbm_used"])
    gone = []
    for buf in (out, bx):
        try:
            c.get(buf)
            gone.append(False)
        except RuntimeError:
            gone.append(True)
    return used + gone, [c.get(b) for b in (out2, out3, out4)]


def test_donate_frees_as_the_jax_proxy_does(proxy):
    """``RemoteExecutable(..., donate=True)`` on a saved program: the same
    ``hbm_used`` after every call as the JAX proxy's executable, the same
    values, and the donated handles gone on both."""
    from kubeshare_tpu.isolation.client import ProxyClient as JaxClient
    from kubeshare_tpu.isolation.proxy import ChipProxy as JaxProxy
    from kubeshare_tpu.isolation.tokensched import \
        TokenScheduler as JaxScheduler

    jp = JaxProxy(scheduler=JaxScheduler(500.0, 30.0, 5.0))
    jp.serve()
    try:
        with JaxClient("127.0.0.1", jp.port, "c", 0.5, 1.0) as c:
            want = _donate_sequence(c)
    finally:
        jp.close()
    c = ProxyClient("127.0.0.1", proxy.port, "c", 0.5, 1.0)
    try:
        got = _donate_sequence(c)
    finally:
        c.close()
    assert got[0] == want[0]
    assert want[0][-2:] == [True, True]
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)


def test_a_donated_input_an_output_aliases_keeps_its_storage(proxy):
    """The in-place Adam step donated whole: its outputs p, m, v and the
    count are its inputs' storages, so forgetting the donated handles
    drops only g's charge; the outputs stay valid. A failed run donates
    nothing."""
    c = ProxyClient("127.0.0.1", proxy.port, "donor", 0.5, 1.0,
                    memory=1 << 20)
    try:
        args = [c.put(x) for x in _adam_inputs()]
        exe = c.compile(_adam_and_factories, *args)
        state_bytes = 3 * 48 + 4                 # p, m, v and the count
        p, m, v, count, total = exe(*args, donate=True)
        sess = proxy._sessions["donor"]
        assert not set(a.handle for a in args) & set(sess.buffers)
        acct = proxy.hbm_accounting()["donor"]
        assert acct["balanced"]
        assert acct["hbm_used"] == state_bytes + 4      # g freed, total in
        want = _adam_and_factories(*_adam_inputs())
        for got, ref in zip((p, m, v), want[:3]):
            np.testing.assert_array_equal(c.get(got), ref.numpy())
        assert float(c.get(total)) == pytest.approx(float(want[4]))
        # a call that fails (an argument of the wrong shape) donates and
        # frees nothing
        bad = c.put(np.zeros((2, 2), np.float32))
        with pytest.raises(RuntimeError):
            exe(bad, m, v, count, count, donate=True)
        assert proxy.hbm_accounting()["donor"]["hbm_used"] == \
            state_bytes + 4 + 16
        assert {p.handle, m.handle, bad.handle} <= set(sess.buffers)
        c.free(p, m, v, count, total, bad)
        assert proxy.hbm_accounting()["donor"]["hbm_used"] == 0
    finally:
        c.close()


def test_a_failed_run_frees_its_uploads_and_keeps_its_arguments(proxy):
    """A program that fails on the proxy (a matrix that is not positive
    definite, which no trace can see; an index out of range no longer
    fails, it is guarded) refunds its output charge; the host tensors
    uploaded for the call are freed, the handles passed in stay valid."""
    c = ProxyClient("127.0.0.1", proxy.port, "fails", 0.5, 1.0)
    try:
        table = c.put(np.arange(8, dtype=np.float32))
        exe = c.compile(
            lambda t, m: t[1:4] * 2.0 + torch.linalg.cholesky(m)[0, 1],
            table, torch.eye(2))
        ok = exe(table, torch.eye(2))
        np.testing.assert_array_equal(c.get(ok), [2.0, 4.0, 6.0])
        c.free(ok)
        with pytest.raises(RuntimeError, match="execution failed"):
            exe(table, -torch.eye(2))
        sess = proxy._sessions["fails"]
        assert list(sess.buffers) == [table.handle]
        acct = proxy.hbm_accounting()["fails"]
        assert acct["balanced"] and acct["hbm_used"] == 32
        np.testing.assert_array_equal(c.get(table), np.arange(8))
        with pytest.raises(RuntimeError, match="runs once a call"):
            c._conn.call({"op": "execute", "name": "fails",
                          "exec_id": exe._exec_id,
                          "args": [table.handle, table.handle],
                          "repeat": 4})
    finally:
        c.close()


def test_a_lockstep_tenant_keeps_its_token_between_steps(proxy,
                                                        monkeypatch):
    """The watchdog returns a session's token only after IDLE_RELEASE_MS
    without an execution. A proxy-attached tenant's gap between steps
    (uploads, the loss fetch, its Python) stays under it, so the token
    stays with the tenant from step to step and stride order holds; the
    reference's 10 ms returned it whenever such a gap ran long. A tenant
    that stops still gives the token back."""
    assert IDLE_RELEASE_MS == 50.0
    acquires = []
    real = proxy.scheduler.acquire

    def counted(name, *a, **k):
        acquires.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(proxy.scheduler, "acquire", counted)
    c = ProxyClient("127.0.0.1", proxy.port, "steady", 0.5, 1.0)
    try:
        x = c.put(np.arange(4, dtype=np.float32))
        exe = c.compile(lambda t: t + 1.0, x)
        for _ in range(4):
            c.free(exe(x))
            time.sleep(0.005)                 # the tenant's own work
        assert acquires == ["steady"]
        deadline = time.monotonic() + 5
        while (proxy._sessions["steady"].holding
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert not proxy._sessions["steady"].holding
    finally:
        c.close()


@pytest.mark.parametrize("field", [{"repeat": 4}, {"chain_steps": 8},
                                   {"donate": [0]}])
def test_a_saved_program_refuses_the_loop_fields(proxy, field):
    """Repeats and chains are a loop program's; a saved program asked for
    one is refused before it runs, its argument kept. Donation is not
    (the JAX proxy's saved programs take it): the run frees the donated
    argument and its charge."""
    c = ProxyClient("127.0.0.1", proxy.port, "loopish", 0.5, 1.0)
    try:
        x = c.put(np.arange(4, dtype=np.float32))
        exe = c.compile(lambda t: t + 1.0, x)
        req = {k: ([x.handle] if k == "donate" else v)
               for k, v in field.items()}
        if "donate" in req:
            used = c.usage()["hbm_used"]
            reply, _ = c._conn.call({"op": "execute", "name": "loopish",
                                     "exec_id": exe._exec_id,
                                     "args": [x.handle], **req})
            assert x.handle not in proxy._sessions["loopish"].buffers
            assert c.usage()["hbm_used"] == used     # x freed, y charged
            np.testing.assert_array_equal(
                c.get(RemoteBuffer(reply["handles"][0], (4,), "float32")),
                np.arange(1, 5))
            return
        with pytest.raises(RuntimeError, match="keeps its arguments"):
            c._conn.call({"op": "execute", "name": "loopish",
                          "exec_id": exe._exec_id, "args": [x.handle],
                          **req})
        assert proxy._sessions["loopish"].exec_count == 0
        np.testing.assert_array_equal(c.get(exe(x)), np.arange(1, 5))
        np.testing.assert_array_equal(c.get(x), np.arange(4))
    finally:
        c.close()


# --- the custom ops ------------------------------------------------------------

def _flash_inputs(hk=2, dtype=torch.float32):
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((2, 32, 4, 8)).astype(
        np.float32)).to(dtype)
    k, v = (torch.from_numpy(rng.standard_normal((2, 32, hk, 8)).astype(
        np.float32)).to(dtype) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("window", [None, 8])
def test_flash_ops_pass_opcheck_and_equal_their_plain_versions(window):
    q, k, v = _flash_inputs()
    scale = 8 ** -0.5
    torch.library.opcheck(tflash.flash_fwd, (q, k, v, True, window, scale))
    o, lse = tflash.flash_fwd(q, k, v, True, window, scale)
    ro, rlse = tflash.flash_fwd_reference(q, k, v, True, window, scale)
    torch.testing.assert_close(o, ro, rtol=0, atol=0)
    torch.testing.assert_close(lse, rlse, rtol=0, atol=0)
    assert o.is_contiguous()
    rng = np.random.default_rng(2)
    dout = torch.from_numpy(rng.standard_normal(o.shape).astype(np.float32))
    dcap = (dout * o).sum(-1).transpose(1, 2).contiguous()
    bwd = (q, k, v, dout, lse, dcap, True, window, scale)
    torch.library.opcheck(tflash.flash_dq, bwd)
    torch.library.opcheck(tflash.flash_dkv, bwd)
    torch.testing.assert_close(tflash.flash_dq(*bwd),
                               tflash.flash_dq_reference(*bwd), rtol=0,
                               atol=0)
    for a, b in zip(tflash.flash_dkv(*bwd), tflash.flash_dkv_reference(*bwd)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_fused_adam_op_passes_opcheck_and_equals_its_plain_version():
    rng = np.random.default_rng(3)
    shapes = [(3, 4), (5,), (0,)]
    leaf = lambda s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))
    ps, gs, ms = ([leaf(s) for s in shapes] for _ in range(3))
    vs = [leaf(s).abs() for s in shapes]
    step = torch.tensor(3.0)
    torch.library.opcheck(tfa._adam_op, ([p.clone() for p in ps], gs,
                                         [m.clone() for m in ms],
                                         [v.clone() for v in vs], step,
                                         1e-2, 0.9, 0.999, 1e-8))
    got = [x.clone() for x in (*ps, *ms, *vs)]
    n = len(shapes)
    torch.ops.kubeshare_tpu_torch.fused_adam(got[:n], gs, got[n:2 * n],
                                             got[2 * n:], step, 1e-2, 0.9,
                                             0.999, 1e-8)
    for i in range(n):
        want = tfa.adam_update_reference(ps[i].clone(), gs[i],
                                         ms[i].clone(), vs[i].clone(), step,
                                         1e-2)
        for a, b in zip((got[i], got[n + i], got[2 * n + i]), want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_a_meta_leaf_never_reaches_the_fake_silently():
    """The dispatcher sends a call with any meta tensor to the fake
    implementation; a real meta tensor there raises instead of updating
    nothing."""
    x = torch.zeros(4)
    meta = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa._adam_op([x], [x], [x], [meta], torch.tensor(1.0), 1e-3, 0.9,
                     0.999, 1e-8)
    q, k, v = _flash_inputs()
    with pytest.raises(ValueError, match="cuda or cpu"):
        tflash.flash_fwd(q, k.to("meta"), v, True, None, 1.0)
