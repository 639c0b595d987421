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


def _tree(seed):
    rng = np.random.default_rng(seed)
    leaf = lambda *shape: rng.normal(size=shape).astype(np.float32)
    return {"conv": {"w": leaf(3, 3, 1, 4), "b": leaf(4)},
            "fc": [leaf(37), leaf(8, 5)]}


def test_tree_step_matches_per_leaf_and_jax_tree():
    """adam_update_tree on CPU leaves (the plain counterpart of the one
    multi-tensor launch) equals the plain step leaf by leaf, bit for bit,
    and the JAX package's adam_update_tree at 1e-6."""
    p, g, m, v = (_tree(s) for s in (3, 4, 5, 6))
    v = tree_map(np.abs, v)
    torch_tree = lambda t: tree_map(lambda a: torch.from_numpy(a.copy()), t)
    tp, tg, tm, tv = (torch_tree(t) for t in (p, g, m, v))
    out = tfa.adam_update_tree(tp, tg, tm, tv, 2, lr=1e-2)
    assert out[0] is tp and out[1] is tm and out[2] is tv
    lp, lg, lm, lv = (tree_leaves(torch_tree(t)) for t in (p, g, m, v))
    for leaf in zip(lp, lg, lm, lv):
        tfa.adam_update_reference(*leaf, 2, lr=1e-2)
    for got, want in zip(tree_leaves((tp, tm, tv)), lp + lm + lv):
        assert torch.equal(got, want)
    jp, jm, jv = jfa.adam_update_tree(
        *(tree_map(jnp.asarray, t) for t in (p, g, m, v)), step=2, lr=1e-2)
    for got, want in zip(tree_leaves((tp, tm, tv)),
                         tree_leaves((jp, jm, jv))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_leaves,want", [
    (0, 0), (1, 1), (tfa.TABLE_LEAVES, 1), (tfa.TABLE_LEAVES + 1, 2),
    (2 * tfa.TABLE_LEAVES + 3, 3)])
def test_launch_plan_splits_only_past_one_table(n_leaves, want):
    tree = {f"w{i:03d}": np.zeros((i % 3 + 1, 2), np.float32)
            for i in range(n_leaves)}
    tree["empty"] = np.zeros((0, 4), np.float32)   # takes no launch
    assert tfa.tree_launches(tree) == want
    assert tfa.tree_launches(tree_map(torch.from_numpy, tree)) == want


def test_launch_plan_of_the_models():
    """One launch a step for each model the port trains (mnist's 8
    leaves, the transformer's 46)."""
    from kubeshare_tpu_torch.models import mnist, transformer

    assert len(tree_leaves(mnist.init(0))) == 8
    assert tfa.tree_launches(mnist.init(0)) == 1
    lm = transformer.init(0, seq_len=16, vocab=32, dim=32, layers=4)
    assert len(tree_leaves(lm)) == 46
    assert tfa.tree_launches(lm) == 1


def test_tree_refuses_mismatched_trees_and_devices():
    p = {"a": torch.zeros(4), "b": torch.zeros(3)}
    with pytest.raises(ValueError, match="structure"):
        tfa.adam_update_tree(p, {"a": torch.zeros(4)}, p, p, 1)
    meta = {"a": torch.zeros(4), "b": torch.empty(3, device="meta")}
    with pytest.raises(ValueError, match="leaf on meta"):
        tfa.adam_update_tree(meta, meta, meta, meta, 1)


def test_launch_tables_of_a_tree():
    """The host side of the multi-tensor launch, on CPU tensors: the
    table rows (p, g, m, v pointers and the size of each non-empty leaf),
    cut into TABLE_LEAVES-leaf launches and cached by layout."""
    n = tfa.TABLE_LEAVES + 2
    ps, gs, ms, vs = ([torch.zeros(i % 4) for i in range(n)]
                      for _ in range(4))
    ptrs, sizes = tfa._table_rows(ps, gs, ms, vs)
    live = [i for i in range(n) if i % 4]
    assert sizes == [i % 4 for i in live]
    assert ptrs == [x.data_ptr() for i in live
                    for x in (ps[i], gs[i], ms[i], vs[i])]
    tables = tfa._layout_tables(ps, gs, ms, vs)
    assert [t[2] for t in tables] == [len(live)]
    assert [p for t in tables for p in t[0]] == ptrs
    assert tfa._layout_tables(ps, gs, ms, vs) is tables
    # a new gradient at another address: a new layout, checked and built
    gs[1] = torch.ones(1)
    assert tfa._layout_tables(ps, gs, ms, vs) is not tables
    many = [torch.zeros(3) for _ in range(2 * tfa.TABLE_LEAVES + 1)]
    ptrs, sizes = tfa._table_rows(many, many, many, many)
    tables = tfa._ctypes_tables(ptrs, sizes)
    assert [t[2] for t in tables] == [tfa.TABLE_LEAVES] * 2 + [1]
    assert [p for t in tables for p in t[0]] == ptrs
    assert [s for t in tables for s in t[1]] == sizes


def test_a_known_layout_still_refuses_what_changed_in_place():
    ps, gs, ms, vs = ([torch.zeros(4)] for _ in range(4))
    tfa._layout_tables(ps, gs, ms, vs)
    ps[0].requires_grad_(True)
    with pytest.raises(ValueError, match="requires grad"):
        tfa._layout_tables(ps, gs, ms, vs)
    ps[0].requires_grad_(False)
    tfa._layout_tables(ps, gs, ms, vs)
    with pytest.raises(TypeError, match="float32"):
        tfa._layout_tables(ps, [gs[0].view(torch.int32)], ms, vs)


@pytest.mark.parametrize("bad,err", [
    (lambda x: x.double(), TypeError),
    (lambda x: x[:3], ValueError),
    (lambda x: x.reshape(2, 2).t(), ValueError),
    (lambda x: x.clone().requires_grad_(True), ValueError)])
def test_launch_tables_refuse_what_the_kernel_does_not_take(bad, err):
    p = torch.zeros(4)
    with pytest.raises(err):
        tfa._table_rows([p], [p], [bad(p)], [p])
