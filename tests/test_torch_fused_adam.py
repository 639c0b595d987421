"""Port's fused Adam against the JAX package's.

The plain PyTorch version (what the port runs on CPU tensors) is held to
the JAX kernel in Pallas interpret mode and to its jnp reference at 1e-6,
and to ``optax.adam`` over five chained steps at the repo's own bars
(2e-5 / 2e-6, as in ``tests/test_fused_adam.py``). The CUDA kernel itself
runs only on the card: the ``cuda``-marked tests hold it to the plain
version there (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from kubeshare_tpu.ops import fused_adam as jfa
from kubeshare_tpu_torch import convert
from kubeshare_tpu_torch.ops import fused_adam as tfa
from kubeshare_tpu_torch.utils.tree import tree_leaves, tree_map

SHAPES = [(1024,), (8, 128), (37,), (3, 5, 7)]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    p, g, m, v = (rng.normal(size=shape).astype(np.float32)
                  for _ in range(4))
    return p, g, m, np.abs(v)


def _plain(p, g, m, v, step, **hyper):
    tp, tg, tm, tv = (torch.from_numpy(a.copy()) for a in (p, g, m, v))
    out = tfa.adam_update(tp, tg, tm, tv, step, **hyper)
    return [t.numpy() for t in out]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_kernel_interpreted(shape):
    p, g, m, v = _inputs(shape)
    got = _plain(p, g, m, v, 3, lr=1e-2)
    want = jfa.adam_update(p, g, m, v, step=3, lr=1e-2, interpret=True)
    for a, b in zip(got, want):
        assert a.shape == shape
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_reference(shape):
    p, g, m, v = _inputs(shape, seed=1)
    got = _plain(p, g, m, v, 3, lr=1e-2)
    want = jfa.adam_update_reference(*(jnp.asarray(a) for a in (p, g, m, v)),
                                     step=3, lr=1e-2)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)


def test_update_is_in_place():
    p, g, m, v = (torch.from_numpy(a) for a in _inputs((64,)))
    ptrs = [t.data_ptr() for t in (p, m, v)]
    out = tfa.adam_update(p, g, m, v, torch.tensor(1.0))
    assert [t.data_ptr() for t in out] == ptrs
    assert out[0] is p and out[1] is m and out[2] is v


def test_matches_optax_over_steps():
    """Five chained steps with a device-side step count track optax."""
    rng = np.random.default_rng(1)
    p = rng.normal(size=(256,)).astype(np.float32)
    opt = optax.adam(1e-3, b1=0.9, b2=0.999, eps=1e-8)
    state = opt.init(jnp.asarray(p))
    p_opt = jnp.asarray(p)
    tp = torch.from_numpy(p.copy())
    tm, tv = torch.zeros_like(tp), torch.zeros_like(tp)
    count = torch.zeros((), dtype=torch.float32)
    for _ in range(5):
        g = rng.normal(size=p.shape).astype(np.float32)
        updates, state = opt.update(jnp.asarray(g), state, p_opt)
        p_opt = optax.apply_updates(p_opt, updates)
        count.add_(1.0)
        tfa.adam_update(tp, torch.from_numpy(g), tm, tv, count)
        np.testing.assert_allclose(tp.numpy(), np.asarray(p_opt),
                                   rtol=2e-5, atol=2e-6)


def test_optimizer_matches_jax_fused_adam():
    """The tree/optimizer form against JAX ``fused_adam()`` over three
    steps: params and the whole state {count, mu, nu}."""
    rng = np.random.default_rng(2)
    params = {"w1": rng.normal(size=(16, 32)).astype(np.float32),
              "b": {"x": rng.normal(size=(5,)).astype(np.float32)}}
    jopt = jfa.fused_adam(1e-2)
    jp = tree_map(jnp.asarray, params)
    jstate = jopt.init(jp)
    topt = tfa.fused_adam(1e-2)
    tp = tree_map(lambda a: torch.from_numpy(a.copy()), params)
    tstate = topt.init(tp)
    for _ in range(3):
        grads = tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                         params)
        updates, jstate = jopt.update(tree_map(jnp.asarray, grads), jstate,
                                      jp)
        jp = optax.apply_updates(jp, updates)
        tp, tstate = topt.update(tree_map(torch.from_numpy, grads), tstate,
                                 tp)
    for a, b in zip(tree_leaves(convert.params_to_jax(tp)), tree_leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)
    ts = convert.adam_state_to_jax(tstate)
    js = convert.adam_state_from_jax(jstate)
    assert float(ts["count"]) == float(js["count"]) == 3.0
    for a, b in zip(tree_leaves(ts), tree_leaves(js)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_cpu_tensors_never_launch_the_kernel():
    tfa.reset_launches()
    params = {"w": torch.ones(8, 8), "b": torch.zeros(8)}
    opt = tfa.fused_adam(1e-3)
    state = opt.init(params)
    for _ in range(3):
        opt.update(tree_map(torch.ones_like, params), state, params)
    assert tfa.launches == 0
    assert float(state["count"]) == 3.0


def test_other_devices_raise():
    meta = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.adam_update(meta, meta, meta, meta, 1)
