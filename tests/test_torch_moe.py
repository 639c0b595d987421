"""The port's mixture-of-experts FFN and MoE LM against the JAX
package's, on the CPU.

``moe_apply`` takes the same parameters (the JAX ``moe_init``'s, carried
over by ``convert``) and the same numpy tokens as the JAX function: in
fp32 its output, aux loss and gradients are held to 1e-5; with bf16
tokens and experts (the LM's dtype) the output to twice the JAX output's
own bf16 error (its distance from the fp32 output) plus one bf16 ulp, and
the aux loss to 1e-6. Experts whose bf16 products are exact pin where the
gate rounds: there the port matches JAX bit for bit, and a combine that
keeps the gate in fp32 does not. The cases of the JAX package's own MoE tests run against the
port alone: the per-token reference, the overflow drop, the aux loss
near 1 for uniform routing and near E for a collapsed router, and
invariance to the group size. The MoE LM (2 layers, dim 32, 4 experts,
seq 32, flash attention: the JAX kernel in Pallas interpret mode, the
port's op through its plain versions) takes one fused-Adam step as the
dense LM's parity test does.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from kubeshare_tpu.models import transformer as jtrans
from kubeshare_tpu.ops import moe as jmoe
from kubeshare_tpu.ops.flash_attention import flash_attention as jax_flash
from kubeshare_tpu.ops.fused_adam import fused_adam as jax_fused_adam
from kubeshare_tpu_torch import convert
from kubeshare_tpu_torch.models import common
from kubeshare_tpu_torch.models import transformer as ttrans
from kubeshare_tpu_torch.ops import moe as tmoe
from kubeshare_tpu_torch.ops.flash_attention import flash_attention
from kubeshare_tpu_torch.ops.fused_adam import fused_adam
from kubeshare_tpu_torch.utils.tree import tree_leaves, tree_map

LR = 1e-3
SMALL = dict(seq_len=32, vocab=64, dim=32, layers=2)
E = 4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _key(seed):
    return jax.random.key(seed, impl="rbg")


def _jax_params(dim=8, hidden=16, e=E, seed=0):
    return jax.tree_util.tree_map(np.asarray,
                                  jmoe.moe_init(_key(seed), dim, hidden, e))


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(params, x, **kw):
    """Output and aux of both packages, as numpy (fp32)."""
    jout, jaux = jmoe.moe_apply(tree_map(jnp.asarray, params),
                                jnp.asarray(x), **kw)
    if kw.get("dtype") is not None:
        kw["dtype"] = getattr(torch, jnp.dtype(kw["dtype"]).name)
    tout, taux = tmoe.moe_apply(_t(params), torch.from_numpy(x), **kw)
    return ((np.asarray(jout, np.float32), float(jaux)),
            (tout.float().numpy(), float(taux)))


def test_moe_init_has_the_jax_layout():
    want = jax.eval_shape(partial(jmoe.moe_init, dim=256, hidden=1024,
                                  n_experts=E), jax.random.PRNGKey(0))
    got = tmoe.moe_init(np.random.default_rng(0), 256, 1024, E)
    assert tree_map(np.shape, got) == jax.tree_util.tree_map(
        lambda s: tuple(s.shape), want)


@pytest.mark.parametrize("cf,group_size", [(1.25, 2048), (1.0, 8),
                                           (0.5, 5), (4.0, 2048)])
def test_moe_fp32_matches_jax(cf, group_size):
    """Capacity 1.25 in one group; 1.0 in groups of 8 and 0.5 in groups
    of 4 (the smallest divisor g of 24 with 24/g ≤ 5 is 6), both
    dropping tokens; and 4.0, where none overflow."""
    params = _jax_params()
    x = _x((3, 8, 8))
    (jo, ja), (to, ta) = _both(params, x, capacity_factor=cf,
                               group_size=group_size)
    np.testing.assert_allclose(to, jo, rtol=0, atol=1e-5)
    assert ta == pytest.approx(ja, rel=1e-6)
    if cf < 1.25:
        assert (np.abs(jo).max(-1) == 0).any()      # some tokens dropped


def _bf16_bound(jax_bf16, jax_fp32):
    """Twice the JAX bf16 result's own error (its distance from the fp32
    result) plus bf16's spacing at its largest value: the frameworks round
    their bf16 products at different places."""
    noise = np.abs(jax_bf16 - jax_fp32).max()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(jax_bf16).max() + 1e-30)) - 7)
    return 2 * (noise + ulp)


def test_moe_bf16_matches_jax():
    """The LM's casts: x and the experts in bf16, the router in fp32, the
    combine built in fp32 and rounded to bf16 with the gate in it."""
    params = _jax_params(dim=32, hidden=128)
    x = _x((2, 32, 32))
    (jo, ja), (to, ta) = _both(params, x, dtype=jnp.bfloat16)
    (j32, _), _ = _both(params, x)
    bound = _bf16_bound(jo, j32)
    assert np.abs(to - jo).max() <= bound
    assert bound < 2e-2
    assert ta == pytest.approx(ja, rel=1e-6)


def _fp32_gate_combine(dispatch, gate, expert_out):
    """A combine that keeps the gate in fp32 and rounds only its product."""
    unweighted = torch.einsum("gmec,gecd->gmd", dispatch.to(expert_out.dtype),
                              expert_out)
    return (unweighted.float() * gate[..., None]).to(expert_out.dtype)


def test_moe_bf16_gate_rounds_where_jax_rounds(monkeypatch):
    """Integer tokens (1 or 2), all-ones fc (so h is 8 to 16, where the
    tanh gelu is the identity in fp32 and bf16) and proj in {-1, 0, 1}
    make every expert product exact in bf16: the gate's rounding is the
    only one left. The port matches JAX bit for bit; a combine that keeps
    the gate in fp32 differs from it."""
    rng = np.random.default_rng(2)
    params = _jax_params(dim=8, hidden=16)
    params["fc"] = np.ones_like(params["fc"])
    params["proj"] = rng.integers(-1, 2, params["proj"].shape).astype(
        np.float32)
    x = rng.integers(1, 3, (2, 16, 8)).astype(np.float32)
    kw = dict(dtype=jnp.bfloat16, capacity_factor=4.0)
    (jo, _), (to, _) = _both(params, x, **kw)
    np.testing.assert_array_equal(to, jo)
    monkeypatch.setattr(tmoe, "_combine", _fp32_gate_combine)
    _, (tv, _) = _both(params, x, **kw)
    assert (tv != jo).mean() > 0.05


def test_moe_grads_fp32_match_jax():
    """Gradients of out·w + aux with respect to the router, the experts
    and x: the router's come through the gate probabilities and the aux
    loss only, as under ``jax.grad``."""
    params = _jax_params()
    x = _x((2, 8, 8))
    w = _x((2, 8, 8), seed=5)

    def jloss(p, x):
        out, aux = jmoe.moe_apply(p, x, capacity_factor=1.0)
        return jnp.sum(out * w) + aux

    jg = jax.grad(jloss, argnums=(0, 1))(tree_map(jnp.asarray, params),
                                         jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in _t(params).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = tmoe.moe_apply(tp, tx, capacity_factor=1.0)
    (out * torch.from_numpy(w)).sum().add(aux).backward()
    for k in ("router", "fc", "proj"):
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[0][k]),
                                   rtol=0, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[1]), rtol=0,
                               atol=1e-5)
    assert float(tp["router"].grad.abs().max()) > 0


def test_argmax_ties_take_the_first_expert_in_both():
    """A zero router gives every token equal probabilities: both route
    all of them to expert 0, which keeps the first ``cap``."""
    params = _jax_params()
    params["router"] = np.zeros_like(params["router"])
    x = _x((2, 8, 8))
    (jo, ja), (to, ta) = _both(params, x, capacity_factor=2.0)
    np.testing.assert_allclose(to, jo, rtol=0, atol=1e-6)
    assert ta == pytest.approx(ja) == pytest.approx(1.0)
    kept = np.abs(to.reshape(16, 8)).max(-1) > 0
    assert kept.tolist() == [True] * 8 + [False] * 8      # cap = 8


# --- the JAX package's MoE cases, against the port -------------------------------

def test_moe_matches_per_token_reference():
    """With nothing overflowing, the einsum dispatch equals the obvious
    per-token computation (numpy, fp32)."""
    params = tmoe.moe_init(np.random.default_rng(0), 8, 16, E)
    x = _x((2, 6, 8))
    out, aux = tmoe.moe_apply(_t(params), torch.from_numpy(x),
                              capacity_factor=4.0)
    tokens = x.reshape(-1, 8)
    logits = tokens @ params["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    ref = np.zeros_like(tokens)
    for i, t in enumerate(tokens):
        e = int(np.argmax(probs[i]))
        h = t @ params["fc"][e]
        h = 0.5 * h * (1 + np.tanh(np.sqrt(2 / np.pi)
                                   * (h + 0.044715 * h ** 3)))
        ref[i] = probs[i, e] * (h @ params["proj"][e])
    np.testing.assert_allclose(out.numpy().reshape(-1, 8), ref, atol=1e-4,
                               rtol=1e-4)
    assert np.isfinite(float(aux))


def test_moe_drops_overflow_tokens():
    """Every token on expert 0 with capacity 1: exactly the first one gets
    output, the rest are zero (the residual path carries them)."""
    params = tmoe.moe_init(np.random.default_rng(0), 8, 16, 2)
    params["router"] = np.zeros_like(params["router"])
    params["router"][0, 0] = 100.0
    x = np.ones((1, 6, 8), np.float32)
    # capacity = int(cf * n / e): cf = 0.34, n = 6, e = 2 -> 1
    out, _ = tmoe.moe_apply(_t(params), torch.from_numpy(x),
                            capacity_factor=0.34)
    flat = out.numpy().reshape(6, 8)
    assert [i for i in range(6) if np.abs(flat[i]).max() > 1e-9] == [0]


def test_moe_aux_loss_uniform_routing_near_one():
    params = tmoe.moe_init(np.random.default_rng(3), 16, 32, E)
    _, aux = tmoe.moe_apply(_t(params), torch.from_numpy(_x((8, 32, 16),
                                                            seed=4)),
                            capacity_factor=2.0)
    assert 0.8 < float(aux) < 2.0, float(aux)


def test_moe_aux_loss_collapsed_router_scores_e():
    """Computed from the assignment before the drop: full collapse scores
    about E, not about the capacity factor."""
    params = tmoe.moe_init(np.random.default_rng(0), 8, 16, E)
    params["router"] = np.zeros_like(params["router"])
    params["router"][0, 0] = 100.0
    _, aux = tmoe.moe_apply(_t(params),
                            torch.ones((2, 16, 8)), capacity_factor=1.0)
    assert float(aux) > 0.9 * E, float(aux)


def test_moe_group_size_invariant_with_ample_capacity():
    params = _t(tmoe.moe_init(np.random.default_rng(5), 8, 16, 2))
    x = torch.from_numpy(_x((4, 8, 8), seed=6))
    ref, aux_ref = tmoe.moe_apply(params, x, capacity_factor=4.0,
                                  group_size=4096)
    out, aux = tmoe.moe_apply(params, x, capacity_factor=4.0, group_size=8)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5,
                               rtol=1e-5)
    assert float(aux) == pytest.approx(float(aux_ref), rel=1e-5)


# --- the MoE LM ---------------------------------------------------------------------

def test_moe_lm_init_has_the_jax_layout():
    want = jax.eval_shape(partial(jtrans.init, n_experts=E),
                          jax.random.PRNGKey(0))
    got = ttrans.init(0, n_experts=E)
    assert tree_map(np.shape, got) == jax.tree_util.tree_map(
        lambda s: tuple(s.shape), want)
    block = got["blocks"][0]
    assert "moe" in block and "fc" not in block and "proj" not in block
    assert len(tree_leaves(got)) == 42


def _lm_step_both(port=True):
    """Logits, aux, loss, grads and params after one fused-Adam step of
    both packages' MoE LM with flash attention (the JAX package's alone
    unless ``port``)."""
    params = jax.tree_util.tree_map(
        np.asarray, jtrans.init(_key(1), n_experts=E, **SMALL))
    batch = common.synthetic_token_batch(3, 2, SMALL["seq_len"],
                                         SMALL["vocab"])
    jattn = partial(jax_flash, block_q=16, block_k=16)
    jloss_fn = partial(jtrans.loss_fn, attn_fn=jattn)
    opt = jax_fused_adam(LR)

    @jax.jit
    def step(p, b):
        logits, aux = jtrans.apply(p, b[0], attn_fn=jattn, return_aux=True)
        loss, grads = jax.value_and_grad(jloss_fn)(p, b)
        updates, _ = opt.update(grads, opt.init(p), p)
        return logits, aux, loss, grads, optax.apply_updates(p, updates)

    jlog, jaux, jloss, jgrads, jnew = step(
        jax.tree_util.tree_map(jnp.asarray, params),
        tuple(jnp.asarray(a) for a in batch))
    want = (np.asarray(jlog), float(jaux), float(jloss),
            [np.asarray(g, np.float32)
             for g in jax.tree_util.tree_leaves(jgrads)],
            [np.asarray(p) for p in jax.tree_util.tree_leaves(jnew)])
    if not port:
        return want

    tattn = partial(flash_attention, block_q=16, block_k=16)
    tloss_fn = partial(ttrans.loss_fn, attn_fn=tattn)
    tp = common.to_device(convert.params_from_jax(params), "cpu")
    tb = common.to_device(batch, "cpu")
    tlog, taux = ttrans.apply(tp, tb[0], attn_fn=tattn, return_aux=True)
    tloss, tgrads = common.value_and_grad(tloss_fn, tp, tb)
    # the flash loss is the same function with the kernels as attention
    assert float(ttrans.flash_loss_fn(tp, tb)) == pytest.approx(
        float(tloss), rel=1e-6)
    topt = fused_adam(LR)
    tnew, _ = topt.update(tgrads, topt.init(tp), tp)     # in place
    return (want,
            (tlog.detach().numpy(), float(taux), float(tloss),
             [g.float().numpy() for g in tree_leaves(tgrads)],
             tree_leaves(convert.params_to_jax(tnew))))


def test_moe_lm_fp32_step_matches_jax(monkeypatch):
    """fp32 activations (DTYPE patched on both): logits to 1e-5, aux and
    loss to 1e-6 relative, grads to 1e-5; after the step every param to
    2*lr and those with |g| > 1e-4 to 1e-6."""
    monkeypatch.setattr(jtrans, "DTYPE", jnp.float32)
    monkeypatch.setattr(ttrans, "DTYPE", torch.float32)
    (jlog, jaux, jl, jg, jp), (tlog, taux, tl, tg, tp) = _lm_step_both()
    np.testing.assert_allclose(tlog, jlog, rtol=0, atol=1e-5)
    assert taux == pytest.approx(jaux, rel=1e-6) and taux > 0
    assert tl == pytest.approx(jl, rel=1e-6)
    assert len(tg) == len(jg) == 2 * 9 + 6
    for a, b in zip(jg, tg):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    n_firm = 0
    for a, b, g in zip(jp, tp, jg):
        np.testing.assert_allclose(b, a, rtol=0, atol=2 * LR + 1e-6)
        firm = np.abs(g) > 1e-4
        n_firm += int(firm.sum())
        np.testing.assert_allclose(b[firm], a[firm], rtol=0, atol=1e-6)
    assert n_firm > 1000


def test_moe_lm_bf16_step_matches_jax(monkeypatch):
    """The LM's own bf16: the frameworks round at different places
    (matmuls, gelu, the residual adds), so logits are held to 5e-2, the
    aux loss to 1e-3 and the loss to 1e-3 relative, and each leaf's
    gradient to twice the JAX bf16 gradient's distance from its fp32 one
    plus one bf16 ulp at the leaf's largest gradient."""
    assert ttrans.DTYPE == torch.bfloat16 and jtrans.DTYPE == jnp.bfloat16
    (jlog, jaux, jl, jg, _), (tlog, taux, tl, tg, _) = _lm_step_both()
    monkeypatch.setattr(jtrans, "DTYPE", jnp.float32)
    jg32 = _lm_step_both(port=False)[3]
    np.testing.assert_allclose(tlog, jlog, rtol=0, atol=5e-2)
    assert taux == pytest.approx(jaux, rel=1e-3)
    assert tl == pytest.approx(jl, rel=1e-3)
    assert len(tg) == len(jg) == len(jg32)
    for a, b, a32 in zip(jg, tg, jg32):
        assert np.abs(b - a).max() <= _bf16_bound(a, a32)


def test_the_dense_lms_aux_is_zero_and_its_loss_the_cross_entropy():
    params = common.to_device(ttrans.init(2, **SMALL), "cpu")
    batch = common.to_device(common.synthetic_token_batch(
        4, 2, SMALL["seq_len"], SMALL["vocab"]), "cpu")
    logits, aux = ttrans.apply(params, batch[0], return_aux=True)
    assert aux.dtype == torch.float32 and float(aux) == 0.0
    from kubeshare_tpu_torch.ops import softmax_cross_entropy
    assert float(ttrans.loss_fn(params, batch)) == float(
        softmax_cross_entropy(logits, batch[1]))


def test_moe_lm_trains_on_cpu():
    res = common.run_training(
        partial(ttrans.init, n_experts=E, **SMALL), ttrans.flash_loss_fn,
        partial(common.synthetic_token_batch, batch_size=2, seq_len=32,
                vocab=64),
        steps=6, learning_rate=1e-2, device="cpu")
    assert np.isfinite(res.final_loss) and res.final_loss < res.first_loss
