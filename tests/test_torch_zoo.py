"""The port's model zoo against the JAX package's, on the CPU: the new
layers and loss, and one train step of cifar10, VGG-16 and the LSTM LM
with fused Adam (ResNet-18/50: ``test_torch_resnet.py``, with the
helpers here).

The same parameters (made by the JAX ``init``, carried over by
``kubeshare_tpu_torch.convert``) and the same numpy batch go through
both. Widths are narrowed on both packages' modules (``STAGES``,
``STACKS``, ``VOCAB``, ``EMBED``, ``HIDDEN``), depths are kept, and the
batch is 4 (images 32×32×3, token sequences of 64).

Each model is stepped twice. With fp32 activations (``DTYPE`` patched on
both) sums differ only in order: the loss is held to 5e-6 relative,
grads to 2e-5, and after the Adam step every parameter to 2*lr and those
with |g| > 1e-4 (both sides agree on sign(g)) to 1e-6. In the models'
own bf16 the two frameworks round at different places inside conv,
matmul and the recurrence: logits are held to 0.1, the loss to 3e-3
relative, and each leaf's gradient to twice the sum of the distance bf16
itself puts the JAX gradient from its fp32 value and one bf16 spacing at
the leaf's largest gradient.
"""

import contextlib
import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from kubeshare_tpu.models import cifar10 as jcifar
from kubeshare_tpu.models import lstm as jlstm
from kubeshare_tpu.models import resnet as jresnet
from kubeshare_tpu.models import vgg as jvgg
from kubeshare_tpu.models import MODEL_NAMES as JAX_MODEL_NAMES
from kubeshare_tpu.ops import layers as jlayers
from kubeshare_tpu.ops import losses as jlosses
from kubeshare_tpu.ops.fused_adam import fused_adam as jax_fused_adam
from kubeshare_tpu_torch import convert
from kubeshare_tpu_torch.models import MODEL_NAMES, common, get_model
from kubeshare_tpu_torch.models import cifar10 as tcifar
from kubeshare_tpu_torch.models import lstm as tlstm
from kubeshare_tpu_torch.models import resnet as tresnet
from kubeshare_tpu_torch.models import vgg as tvgg
from kubeshare_tpu_torch.ops import layers as tlayers
from kubeshare_tpu_torch.ops import losses as tlosses
from kubeshare_tpu_torch.ops.fused_adam import fused_adam
from kubeshare_tpu_torch.utils.tree import tree_leaves, tree_map

LR = 1e-3
ROOT = Path(__file__).resolve().parent.parent

#: narrowed widths, set on both packages' modules
NARROW = {
    "cifar10": {"STAGES": (8, 16, 32)},
    "vgg": {"STACKS": ((8, 2), (16, 2), (16, 3), (32, 3), (32, 3))},
    "resnet": {"STAGES": (8, 16, 32, 64)},
    "lstm": {"VOCAB": 64, "EMBED": 16, "HIDDEN": 32},
}
MODULES = {"cifar10": (jcifar, tcifar), "vgg": (jvgg, tvgg),
           "resnet": (jresnet, tresnet), "lstm": (jlstm, tlstm)}
#: (module name, JAX init) of each case
CASES = {"cifar10": ("cifar10", jcifar.init), "vgg16": ("vgg", jvgg.init),
         "resnet18": ("resnet", jresnet.init),
         "resnet50": ("resnet", jresnet.init50), "lstm": ("lstm", jlstm.init)}
#: the cases stepped in this file
STEPPED = ("cifar10", "vgg16", "lstm")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@contextlib.contextmanager
def narrowed(name: str, dtype: str | None = None):
    """Both packages' module ``name`` at the narrowed widths (and, with
    ``dtype``, that activation dtype), put back on exit."""
    mods = MODULES[name]
    values = dict(NARROW[name])
    saved = [{k: getattr(m, k) for k in (*values, "DTYPE")} for m in mods]
    try:
        for m in mods:
            for k, v in values.items():
                setattr(m, k, v)
        if dtype is not None:
            mods[0].DTYPE = getattr(jnp, dtype)
            mods[1].DTYPE = getattr(torch, dtype)
        yield mods
    finally:
        for m, old in zip(mods, saved):
            for k, v in old.items():
                setattr(m, k, v)


def _t(a):
    return torch.from_numpy(np.array(a))


def _batch(name: str):
    if name == "lstm":
        return common.synthetic_token_batch(3, 4, 64, NARROW["lstm"]["VOCAB"])
    return common.synthetic_image_batch(3, 4, 32, 3, 10)


_PARAMS: dict = {}
_RUNS: dict = {}


def _jax_params(case: str) -> dict:
    """The JAX init's parameters of ``case`` at the narrowed widths, as
    numpy (one init per case; its key is JAX's ``rbg`` generator, which
    compiles in a fraction of threefry's time)."""
    if case not in _PARAMS:
        name, jinit = CASES[case]
        with narrowed(name):
            _PARAMS[case] = jax.tree_util.tree_map(
                np.asarray, jinit(jax.random.key(1, impl="rbg")))
    return _PARAMS[case]


def _run(case: str, dtype: str) -> dict:
    """Logits, loss and grads of both packages from the same params and
    batch, and in fp32 the params after one fused-Adam step (cached per
    case and dtype: the JAX compile is the cost)."""
    key = (case, dtype)
    if key in _RUNS:
        return _RUNS[key]
    name = CASES[case][0]
    params = _jax_params(case)
    batch = _batch(name)
    with narrowed(name, dtype) as (jmod, tmod):
        opt = jax_fused_adam(LR)

        @jax.jit
        def step(p, b):
            # the body of the JAX make_train_step, plus the logits
            loss, grads = jax.value_and_grad(jmod.loss_fn)(p, b)
            new = None
            if dtype == "float32":
                updates, _ = opt.update(grads, opt.init(p), p)
                new = optax.apply_updates(p, updates)
            return jmod.apply(p, b[0]), loss, grads, new

        jlog, jloss, jgrads, jnew = step(
            jax.tree_util.tree_map(jnp.asarray, params),
            tuple(jnp.asarray(a) for a in batch))
        tp = common.to_device(convert.params_from_jax(params), "cpu")
        tb = common.to_device(batch, "cpu")
        tlog = tmod.apply(tp, tb[0])
        tloss, tgrads = common.value_and_grad(tmod.loss_fn, tp, tb)
        topt = fused_adam(LR)
        tnew, _ = topt.update(tgrads, topt.init(tp), tp)
    out = {"jax": (np.asarray(jlog, np.float32), float(jloss),
                   [np.asarray(g, np.float32)
                    for g in jax.tree_util.tree_leaves(jgrads)],
                   [np.asarray(p) for p in jax.tree_util.tree_leaves(jnew)]),
           "port": (tlog.float().detach().numpy(), float(tloss),
                    [g.float().numpy() for g in tree_leaves(tgrads)],
                    tree_leaves(convert.params_to_jax(tnew)))}
    _RUNS[key] = out
    return out


# --- layers and loss -----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_avg_pool_matches_jax(dtype):
    x = np.random.default_rng(0).standard_normal((2, 7, 8, 5)).astype(
        np.float32)
    want = jlayers.avg_pool(jnp.asarray(x).astype(getattr(jnp, dtype)))
    got = tlayers.avg_pool(_t(x).to(getattr(torch, dtype)))
    assert tuple(got.shape) == want.shape == (2, 3, 4, 5)
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("size,padding", [(32, "SAME"), (33, "SAME"),
                                          (33, "VALID")])
def test_strided_1x1_conv_matches_jax(size, padding):
    """ResNet's stride-2 1x1 projection, forward and gradients, on 4
    threads at batch 2 (where oneDNN's own strided 1x1 backward corrupts
    the heap: the port slices first)."""
    rng = np.random.default_rng(5)
    params = {"w": rng.standard_normal((1, 1, 8, 16)).astype(np.float32),
              "b": rng.standard_normal(16).astype(np.float32)}
    x = rng.standard_normal((2, size, size, 8)).astype(np.float32)
    w_out = rng.standard_normal((2, (size + 1) // 2, (size + 1) // 2,
                                 16)).astype(np.float32)

    def jloss(p, x):
        y = jlayers.conv2d_apply(p, x, stride=2, padding=padding)
        return jnp.sum(y * w_out), y

    (_, want), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(tree_map(jnp.asarray, params),
                                             jnp.asarray(x))
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        tp = tree_map(lambda a: _t(a).requires_grad_(True), params)
        tx = _t(x).requires_grad_(True)
        got = tlayers.conv2d_apply(tp, tx, stride=2, padding=padding)
        (got * _t(w_out)).sum().backward()
    finally:
        torch.set_num_threads(before)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-5)
    for k in ("w", "b"):
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jgp[k]),
                                   rtol=1e-5, atol=1e-3)


def test_batchnorm_matches_jax_with_the_population_variance():
    rng = np.random.default_rng(1)
    params = tlayers.batchnorm_init(6)
    params = {k: v + rng.standard_normal(6).astype(np.float32)
              for k, v in params.items()}
    # a small batch, where the sample variance would be 25% off
    x = (rng.standard_normal((1, 2, 2, 6)) * 3 + 1).astype(np.float32)
    want = jlayers.batchnorm_apply(tree_map(jnp.asarray, params),
                                   jnp.asarray(x))
    got = tlayers.batchnorm_apply(tree_map(_t, params), _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert tree_map(np.shape, tlayers.batchnorm_init(6)) == \
        jax.tree_util.tree_map(np.shape, jlayers.batchnorm_init(6))


def test_lstm_matches_jax_in_fp32():
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(np.asarray, jlayers.lstm_init(
        jax.random.PRNGKey(0), 12, 16))
    assert tree_map(np.shape, tlayers.lstm_init(rng, 12, 16)) == \
        tree_map(np.shape, params)
    xs = rng.standard_normal((3, 64, 12)).astype(np.float32)
    want = jlayers.lstm_apply(tree_map(jnp.asarray, params), jnp.asarray(xs))
    got = tlayers.lstm_apply(tree_map(_t, params), _t(xs))
    assert tuple(got.shape) == want.shape == (3, 64, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_lstm_matches_jax_in_bf16_over_64_steps():
    """Every operation of the cell in bf16, over the LM's 64 steps: the
    frameworks' matmuls round differently, and the error compounds
    through the recurrence, so hidden states (|h| < 1) are held to 3e-2
    at every step and to 1e-2 on average."""
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(np.asarray, jlayers.lstm_init(
        jax.random.PRNGKey(1), 16, 32))
    xs = rng.standard_normal((4, 64, 16)).astype(np.float32)
    want = np.asarray(jlayers.lstm_apply(tree_map(jnp.asarray, params),
                                         jnp.asarray(xs),
                                         dtype=jnp.bfloat16), np.float32)
    got = tlayers.lstm_apply(tree_map(_t, params), _t(xs),
                             dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    assert err.max() <= 3e-2 and err.mean() <= 1e-2, (err.max(), err.mean())


def test_accuracy_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((32, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 32)
    want = jlosses.accuracy(jnp.asarray(logits), jnp.asarray(labels))
    got = tlosses.accuracy(_t(logits), _t(labels))
    assert got.dtype == torch.float32
    assert float(got) == float(want) > 0


def test_ops_exports_the_jax_packages_names():
    """All but ``flash_attention``: the port's package keeps its kernel
    module under that name (launch counts, tolerances, plain versions)."""
    import types

    import kubeshare_tpu.ops as jops
    import kubeshare_tpu_torch.ops as tops

    assert set(tops.__all__) == set(jops.__all__) - {"flash_attention"}
    assert all(callable(getattr(tops, n)) for n in tops.__all__)
    assert isinstance(tops.flash_attention, types.ModuleType)
    assert callable(tops.flash_attention.flash_attention)


def test_model_names_are_the_jax_packages():
    assert MODEL_NAMES == JAX_MODEL_NAMES
    for name in MODEL_NAMES:
        mod = get_model(name)
        assert callable(mod.init) and callable(mod.loss_fn)


@pytest.mark.parametrize("case", list(CASES))
def test_init_makes_the_jax_layout(case):
    """The port's own init gives the JAX init's tree: keys, leaf order and
    shapes (at full width: no array is made, only shapes compared)."""
    name, jinit = CASES[case]
    tinit = {"resnet50": tresnet.init50}.get(case, get_model(name).init)
    want = jax.eval_shape(jinit, jax.random.PRNGKey(0))
    got = tinit(0)
    assert tree_map(np.shape, got) == jax.tree_util.tree_map(
        lambda s: tuple(s.shape), want)
    assert all(a.dtype == np.float32 for a in tree_leaves(got))


# --- one train step of each model ------------------------------------------------

def check_fp32_step(case: str) -> None:
    (jlog, jl, jg, jp), (tlog, tl, tg, tp) = _run(case, "float32").values()
    np.testing.assert_allclose(tlog, jlog, rtol=0, atol=1e-4)
    assert tl == pytest.approx(jl, rel=5e-6)
    assert len(tg) == len(jg)
    for a, b in zip(jg, tg):
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-5)
    n_firm = 0
    for a, b, g in zip(jp, tp, jg):
        np.testing.assert_allclose(b, a, rtol=0, atol=2 * LR + 1e-6)
        firm = np.abs(g) > 1e-4
        n_firm += int(firm.sum())
        np.testing.assert_allclose(b[firm], a[firm], rtol=0, atol=1e-6)
    assert n_firm > 1000


def check_bf16_step(case: str) -> None:
    name = CASES[case][0]
    assert MODULES[name][1].DTYPE == torch.bfloat16
    (jlog, jl, jg, _), (tlog, tl, tg, _) = _run(case, "bfloat16").values()
    jg32 = _run(case, "float32")["jax"][2]
    np.testing.assert_allclose(tlog, jlog, rtol=0, atol=0.1)
    assert tl == pytest.approx(jl, rel=3e-3)
    for a, b, a32 in zip(jg, tg, jg32):
        noise = np.abs(a - a32).max()
        # bf16's spacing at the leaf's largest gradient: both sides round
        # their bf16 gradients to it
        ulp = 2.0 ** (np.floor(np.log2(np.abs(a).max() + 1e-30)) - 7)
        assert np.abs(b - a).max() <= 2 * (noise + ulp)


@pytest.mark.parametrize("case", STEPPED)
def test_step_fp32_matches_jax(case):
    check_fp32_step(case)


@pytest.mark.parametrize("case", STEPPED)
def test_step_bf16_matches_jax(case):
    check_bf16_step(case)


@pytest.mark.parametrize("name", ["cifar10", "vgg", "resnet", "lstm"])
def test_cli_runs_on_the_cpu_at_narrow_width(name, capsys):
    """``main_cli`` with ``--device cpu --steps 2``, the widths narrowed
    and the batch 4 (the full widths run on the card)."""
    batch_fn = (partial(common.synthetic_token_batch, batch_size=4,
                        seq_len=16, vocab=NARROW["lstm"]["VOCAB"])
                if name == "lstm" else
                partial(common.synthetic_image_batch, batch_size=4, hw=32,
                        channels=3, classes=10))
    with narrowed(name) as (_, tmod):
        res = common.main_cli(name, tmod.init, tmod.loss_fn, batch_fn,
                              argv=["--device", "cpu", "--steps", "2"])
    assert res.steps == 2 and np.isfinite(res.final_loss)
    assert f"{name}: 2 steps in" in capsys.readouterr().out


def test_a_model_module_runs_as_a_cli_on_the_cpu():
    """``python -m kubeshare_tpu_torch.models.<name>`` resolves and runs
    (tinymlp, whose full width a CPU step affords)."""
    out = subprocess.run(
        [sys.executable, "-m", "kubeshare_tpu_torch.models.tinymlp",
         "--device", "cpu", "--steps", "2"], capture_output=True, text=True,
        cwd=ROOT, timeout=120,
        env=dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    assert "tinymlp: 2 steps in" in out.stdout
