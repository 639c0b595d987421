"""Port's layers, loss and models against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through both; parameters
cross with ``kubeshare_tpu_torch.convert``. mnist runs at full width
(conv 1→32→64, fc 3136→256→10) on a batch of 8, once with fp32
activations (both packages' ``DTYPE`` patched) and once in bf16.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubeshare_tpu.models import mnist as jmnist
from kubeshare_tpu.models import tinymlp as jtiny
from kubeshare_tpu.models.common import make_train_step as jax_train_step
from kubeshare_tpu.ops import layers as jlayers
from kubeshare_tpu.ops import losses as jlosses
from kubeshare_tpu.ops.fused_adam import fused_adam as jax_fused_adam
from kubeshare_tpu_torch import convert
from kubeshare_tpu_torch.models import common
from kubeshare_tpu_torch.models import mnist as tmnist
from kubeshare_tpu_torch.models import tinymlp as ttiny
from kubeshare_tpu_torch.ops import layers as tlayers
from kubeshare_tpu_torch.ops import losses as tlosses
from kubeshare_tpu_torch.ops.fused_adam import fused_adam
from kubeshare_tpu_torch.utils.tree import tree_leaves, tree_map

LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # the suite runs in parallel workers: keep torch's CPU kernels from
    # taking every core from the timing-sensitive tests of other workers
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(tree):
    return tree_map(jnp.asarray, tree)


def test_convert_round_trip():
    params = jmnist.init(jax.random.PRNGKey(0))
    port = convert.params_from_jax(params)
    back = convert.params_to_jax(common.to_device(port, "cpu"))
    for a, b, c in zip(tree_leaves(params), tree_leaves(port),
                       tree_leaves(back)):
        assert a.shape == b.shape == c.shape
        np.testing.assert_array_equal(np.asarray(a), b)
        np.testing.assert_array_equal(b, c)
    state = jax_fused_adam(LR).init(params)
    pstate = convert.adam_state_from_jax(state)
    assert pstate["count"].shape == () and pstate["count"].dtype == np.float32
    jstate = convert.adam_state_to_jax(pstate)
    assert [np.shape(x) for x in tree_leaves(jstate)] == \
        [np.shape(x) for x in tree_leaves(state)]
    with pytest.raises(ValueError):
        convert.adam_state_from_jax({"mu": {}, "nu": {}})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_matches_jax(dtype):
    rng = np.random.default_rng(0)
    params = tlayers.dense_init(rng, 24, 16)
    x = rng.standard_normal((5, 24)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jlayers.dense_apply(_j(params), jnp.asarray(x), dtype=jd)
    got = tlayers.dense_apply(tree_map(_t, params), _t(x), dtype=td)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("stride,padding", [(1, "SAME"), (2, "SAME"),
                                            (1, "VALID")])
def test_conv2d_matches_jax(stride, padding):
    rng = np.random.default_rng(1)
    params = tlayers.conv2d_init(rng, 3, 8)
    params["b"] = rng.standard_normal(8).astype(np.float32)
    x = rng.standard_normal((2, 9, 9, 3)).astype(np.float32)
    want = jlayers.conv2d_apply(_j(params), jnp.asarray(x), stride=stride,
                                padding=padding)
    got = tlayers.conv2d_apply(tree_map(_t, params), _t(x), stride=stride,
                               padding=padding)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_max_pool_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 7, 8, 5)).astype(
        np.float32)
    want = jlayers.max_pool(jnp.asarray(x))
    got = tlayers.max_pool(_t(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_jax(dtype):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((6, 10)).astype(np.float32) * 3
    labels = rng.integers(0, 10, 6)
    want = jlosses.softmax_cross_entropy(
        jnp.asarray(logits).astype(getattr(jnp, dtype)), jnp.asarray(labels))
    got = tlosses.softmax_cross_entropy(
        _t(logits).to(getattr(torch, dtype)), _t(labels))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def _train_step_both(jmod, tmod, params, batch):
    """One step of both packages from the same params and batch: returns
    (jax loss, jax grads, jax params after), same for the port, and the
    forward logits of both."""
    jp, jb = _j(params), tuple(jnp.asarray(a) for a in batch)
    jlogits = jmod.apply(jp, jb[0])
    jloss, jgrads = jax.value_and_grad(jmod.loss_fn)(jp, jb)
    opt = jax_fused_adam(LR)
    jnew, _, jloss2 = jax_train_step(jmod.loss_fn, opt)(jp, opt.init(jp), jb)
    # jit and eager JAX sum in different orders
    assert float(jloss2) == pytest.approx(float(jloss), rel=1e-5)

    tp = common.to_device(convert.params_from_jax(params), "cpu")
    tb = common.to_device(batch, "cpu")
    tlogits = tmod.apply(tp, tb[0])
    tloss, tgrads = common.value_and_grad(tmod.loss_fn, tp, tb)
    topt = fused_adam(LR)
    tnew, tstate, tloss2 = common.make_train_step(tmod.loss_fn, topt)(
        tp, topt.init(tp), tb)
    assert float(tloss2) == float(tloss)
    assert float(tstate["count"]) == 1.0
    return ((np.asarray(jlogits, np.float32), float(jloss),
             [np.asarray(g) for g in tree_leaves(jgrads)],
             [np.asarray(p) for p in tree_leaves(jnew)]),
            (tlogits.float().detach().numpy(), float(tloss),
             [g.numpy() for g in tree_leaves(tgrads)],
             tree_leaves(convert.params_to_jax(tnew))))


def _assert_step_close(jax_out, port_out, loss_rel, grad_atol):
    (jlog, jl, jg, jp), (tlog, tl, tg, tp) = jax_out, port_out
    assert tl == pytest.approx(jl, rel=loss_rel)
    for a, b in zip(jg, tg):
        np.testing.assert_allclose(b, a, rtol=0, atol=grad_atol)
    # Adam's first step is ~ -lr*sign(g): a parameter whose |g| is near
    # eps can flip sign between two sums of the same gradient, so every
    # element is held to 2*lr and the well-conditioned ones (|g| > 1e-4)
    # to 1e-6
    for a, b, g in zip(jp, tp, jg):
        np.testing.assert_allclose(b, a, rtol=0, atol=2 * LR + 1e-6)
        firm = np.abs(g) > 1e-4
        np.testing.assert_allclose(b[firm], a[firm], rtol=0, atol=1e-6)


def _mnist_inputs():
    params = jax.tree_util.tree_map(np.asarray,
                                    jmnist.init(jax.random.PRNGKey(3)))
    x, y = tmnist.batch_fn(4)
    return params, (x[:8], y[:8])


def test_mnist_fp32_matches_jax(monkeypatch):
    """fp32 activations: forward, loss and grads tight (sums differ only
    in order), params after one fused-Adam step as stated above."""
    monkeypatch.setattr(jmnist, "DTYPE", jnp.float32)
    monkeypatch.setattr(tmnist, "DTYPE", torch.float32)
    params, batch = _mnist_inputs()
    jax_out, port_out = _train_step_both(jmnist, tmnist, params, batch)
    np.testing.assert_allclose(port_out[0], jax_out[0], rtol=1e-5,
                               atol=1e-5)
    _assert_step_close(jax_out, port_out, loss_rel=1e-6, grad_atol=1e-6)


def test_mnist_bf16_matches_jax():
    """bf16 activations (the model's own DTYPE). The two frameworks round
    to bf16 at different places inside conv and matmul, so logits are
    held to 5e-2, the loss to 1e-2 relative and grads to 5e-3 (their
    scale is ~0.5). After the step every param is held to 2*lr; where
    |g| exceeds that grad tolerance both sides agree on sign(g), so
    Adam's ~ -lr*g/|g| step agrees to 1e-6 there."""
    assert tmnist.DTYPE == torch.bfloat16 and jmnist.DTYPE == jnp.bfloat16
    params, batch = _mnist_inputs()
    jax_out, port_out = _train_step_both(jmnist, tmnist, params, batch)
    np.testing.assert_allclose(port_out[0], jax_out[0], rtol=0, atol=5e-2)
    (_, jl, jg, jp), (_, tl, tg, tp) = jax_out, port_out
    assert tl == pytest.approx(jl, rel=1e-2)
    for a, b in zip(jg, tg):
        np.testing.assert_allclose(b, a, rtol=0, atol=5e-3)
    n_firm = 0
    for a, b, g in zip(jp, tp, jg):
        np.testing.assert_allclose(b, a, rtol=0, atol=2 * LR + 1e-6)
        firm = np.abs(g) > 5e-3
        n_firm += int(firm.sum())
        np.testing.assert_allclose(b[firm], a[firm], rtol=0, atol=1e-6)
    assert n_firm > 1000


def test_tinymlp_matches_jax():
    params = jax.tree_util.tree_map(np.asarray,
                                    jtiny.init(jax.random.PRNGKey(5)))
    batch = ttiny.batch_fn(6)
    jax_out, port_out = _train_step_both(jtiny, ttiny, params, batch)
    np.testing.assert_allclose(port_out[0], jax_out[0], rtol=1e-5,
                               atol=1e-6)
    _assert_step_close(jax_out, port_out, loss_rel=1e-6, grad_atol=1e-6)


def test_port_init_layout_matches_jax():
    """The port's own initializers produce the JAX package's layout."""
    for jmod, tmod in ((jmnist, tmnist), (jtiny, ttiny)):
        want = jax.tree_util.tree_map(np.shape, jmod.init(
            jax.random.PRNGKey(0)))
        got = tree_map(np.shape, tmod.init(0))
        assert got == want


def test_run_training_learns_on_cpu():
    res = common.run_training(ttiny.init, ttiny.loss_fn, ttiny.batch_fn,
                              steps=40, learning_rate=1e-2, device="cpu")
    assert res.steps == 40
    assert np.isfinite(res.final_loss)
    assert res.final_loss < res.first_loss
