"""Port's transformer LM against the JAX package's, on the CPU.

The same parameters (made by the JAX ``init``, carried over by
``kubeshare_tpu_torch.convert``) and the same numpy token batch go through
both, at a small size (seq 32, vocab 64, dim 64, 2 layers, batch 2), with
flash attention as the attention body: the JAX kernel in Pallas interpret
mode, the port's op through its plain versions. One full train step with
fused Adam is compared: loss, grads and the params after the step.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubeshare_tpu.models import transformer as jtrans
from kubeshare_tpu.models.common import make_train_step as jax_train_step
from kubeshare_tpu.ops.flash_attention import flash_attention as jax_flash
from kubeshare_tpu.ops.fused_adam import fused_adam as jax_fused_adam
from kubeshare_tpu_torch import convert
from kubeshare_tpu_torch.models import common
from kubeshare_tpu_torch.models import transformer as ttrans
from kubeshare_tpu_torch.ops.flash_attention import flash_attention
from kubeshare_tpu_torch.ops.fused_adam import fused_adam
from kubeshare_tpu_torch.utils.tree import tree_leaves, tree_map

LR = 1e-3
SMALL = dict(seq_len=32, vocab=64, dim=64, layers=2)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_params(seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jtrans.init(jax.random.PRNGKey(seed), **SMALL))


def test_convert_round_trip_transformer():
    """The tree with a list of block dicts crosses both ways with its leaf
    order and shapes unchanged, and so does its fused-Adam state; the
    port's own init makes the same layout."""
    params = _jax_params()
    port = convert.params_from_jax(params)
    assert isinstance(port["blocks"], list) and len(port["blocks"]) == 2
    back = convert.params_to_jax(common.to_device(port, "cpu"))
    jleaves = jax.tree_util.tree_leaves(params)
    assert len(jleaves) == len(tree_leaves(port)) == len(tree_leaves(back))
    for a, b, c in zip(jleaves, tree_leaves(port), tree_leaves(back)):
        assert a.shape == b.shape == c.shape
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)
    state = jax_fused_adam(LR).init(params)
    jstate = convert.adam_state_to_jax(convert.adam_state_from_jax(state))
    assert [np.shape(x) for x in tree_leaves(jstate)] == \
        [np.shape(x) for x in jax.tree_util.tree_leaves(state)]
    assert tree_map(np.shape, ttrans.init(0, **SMALL)) == \
        jax.tree_util.tree_map(np.shape, params)


def _step_both(blocks=16, window=None):
    """Logits, loss, grads and params after one fused-Adam step, of both
    packages, from the same params and batch, with flash attention."""
    params = _jax_params(1)
    batch = common.synthetic_token_batch(3, 2, SMALL["seq_len"],
                                         SMALL["vocab"])
    jattn = partial(jax_flash, block_q=blocks, block_k=blocks,
                    window=window)
    jloss_fn = partial(jtrans.loss_fn, attn_fn=jattn)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jb = tuple(jnp.asarray(a) for a in batch)
    jlogits = jtrans.apply(jp, jb[0], attn_fn=jattn)
    jloss, jgrads = jax.value_and_grad(jloss_fn)(jp, jb)
    opt = jax_fused_adam(LR)
    jnew, _, _ = jax_train_step(jloss_fn, opt)(jp, opt.init(jp), jb)

    tattn = partial(flash_attention, block_q=blocks, block_k=blocks,
                    window=window)
    tloss_fn = partial(ttrans.loss_fn, attn_fn=tattn)
    tp = common.to_device(convert.params_from_jax(params), "cpu")
    tb = common.to_device(batch, "cpu")
    tlogits = ttrans.apply(tp, tb[0], attn_fn=tattn)
    tloss, tgrads = common.value_and_grad(tloss_fn, tp, tb)
    topt = fused_adam(LR)
    tnew, _, _ = common.make_train_step(tloss_fn, topt)(tp, topt.init(tp),
                                                        tb)
    assert tlogits.dtype == torch.float32
    return ((np.asarray(jlogits, np.float32), float(jloss),
             [np.asarray(g, np.float32) for g in
              jax.tree_util.tree_leaves(jgrads)],
             [np.asarray(p) for p in jax.tree_util.tree_leaves(jnew)]),
            (tlogits.detach().numpy(), float(tloss),
             [g.float().numpy() for g in tree_leaves(tgrads)],
             tree_leaves(convert.params_to_jax(tnew))))


def _assert_close(jax_out, port_out, logit_atol, loss_rel, grad_atol,
                  firm_at):
    """Adam's first step is ~ -lr*sign(g): every param is held to 2*lr,
    and those with |g| above ``firm_at`` (where both sides agree on the
    sign) to 1e-6."""
    (jlog, jl, jg, jp), (tlog, tl, tg, tp) = jax_out, port_out
    np.testing.assert_allclose(tlog, jlog, rtol=0, atol=logit_atol)
    assert tl == pytest.approx(jl, rel=loss_rel)
    assert len(tg) == len(jg)
    for a, b in zip(jg, tg):
        np.testing.assert_allclose(b, a, rtol=0, atol=grad_atol)
    n_firm = 0
    for a, b, g in zip(jp, tp, jg):
        np.testing.assert_allclose(b, a, rtol=0, atol=2 * LR + 1e-6)
        firm = np.abs(g) > firm_at
        n_firm += int(firm.sum())
        np.testing.assert_allclose(b[firm], a[firm], rtol=0, atol=1e-6)
    assert n_firm > 1000


def test_transformer_fp32_matches_jax(monkeypatch):
    """fp32 activations (DTYPE patched on both): sums differ only in
    order, so logits are held to 1e-5, the loss to 1e-6 relative and
    grads to 1e-6."""
    monkeypatch.setattr(jtrans, "DTYPE", jnp.float32)
    monkeypatch.setattr(ttrans, "DTYPE", torch.float32)
    _assert_close(*_step_both(), logit_atol=1e-5, loss_rel=1e-6,
                  grad_atol=1e-6, firm_at=1e-4)


def test_transformer_bf16_matches_jax():
    """bf16 activations (the model's own DTYPE). The two frameworks round
    to bf16 at different places (matmul outputs, gelu, the residual adds),
    so logits are held to 5e-2, the loss to 1e-3 relative and grads to
    1e-2 (their largest is ~0.5)."""
    assert ttrans.DTYPE == torch.bfloat16 and jtrans.DTYPE == jnp.bfloat16
    _assert_close(*_step_both(), logit_atol=5e-2, loss_rel=1e-3,
                  grad_atol=1e-2, firm_at=1e-2)


def test_transformer_knobs_fp32_match_jax(monkeypatch):
    """Grouped-query (2 kv heads), RoPE and an 8-wide window, patched on
    both modules; the flash body takes the window as JAX's closure does."""
    for mod, dtype in ((jtrans, jnp.float32), (ttrans, torch.float32)):
        monkeypatch.setattr(mod, "DTYPE", dtype)
        monkeypatch.setattr(mod, "KV_HEADS", 2)
        monkeypatch.setattr(mod, "USE_ROPE", True)
        monkeypatch.setattr(mod, "WINDOW", 8)
    # 8 heads of 8 over dim 64, 2 kv heads: qkv is (64, 64 + 2·2·8)
    assert ttrans.init(0, **SMALL)["blocks"][0]["attn"]["qkv"].shape == \
        (64, 96)
    jax_out, port_out = _step_both(blocks=8, window=8)
    _assert_close(jax_out, port_out, logit_atol=1e-5, loss_rel=1e-6,
                  grad_atol=1e-6, firm_at=1e-4)


@pytest.mark.parametrize("dim", [512, 1024, 640],
                         ids=["head-dim-64", "head-dim-128", "head-dim-80"])
def test_transformer_wide_head_dims_fp32_match_jax(monkeypatch, dim):
    """The LM at ``init(dim=512)`` and ``init(dim=1024)``: 8 heads of 64
    (GPT-2's) and of 128 (Llama's), the widths the flash kernels take on
    the card beside 8 and 32; and at ``init(dim=640)``, 8 heads of 80
    (Phi-2's), which the kernels run on the instance 128; 1 layer, seq 32,
    vocab 64, fp32 activations.
    The JAX params carried over, logits, loss and every grad against the
    JAX LM with its flash kernel (interpret mode), held as the fp32 test
    holds them: sums that differ only in order."""
    sizes = dict(seq_len=32, vocab=64, dim=dim, layers=1)
    monkeypatch.setattr(jtrans, "DTYPE", jnp.float32)
    monkeypatch.setattr(ttrans, "DTYPE", torch.float32)
    params = jax.tree_util.tree_map(np.asarray, jtrans.init(
        jax.random.key(3, impl="rbg"), **sizes))
    assert params["blocks"][0]["attn"]["qkv"].shape == (dim, 3 * dim)
    batch = common.synthetic_token_batch(5, 2, 32, 64)
    jattn = partial(jax_flash, block_q=16, block_k=16)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jb = tuple(jnp.asarray(a) for a in batch)
    jlogits = jtrans.apply(jp, jb[0], attn_fn=jattn)
    jloss, jgrads = jax.value_and_grad(
        partial(jtrans.loss_fn, attn_fn=jattn))(jp, jb)

    tattn = partial(flash_attention, block_q=16, block_k=16)
    tp = common.to_device(convert.params_from_jax(params), "cpu")
    tb = common.to_device(batch, "cpu")
    tlogits = ttrans.apply(tp, tb[0], attn_fn=tattn)
    tloss, tgrads = common.value_and_grad(
        partial(ttrans.loss_fn, attn_fn=tattn), tp, tb)
    np.testing.assert_allclose(tlogits.detach().numpy(),
                               np.asarray(jlogits), rtol=0, atol=1e-5)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-6)
    jg = jax.tree_util.tree_leaves(jgrads)
    tg = tree_leaves(tgrads)
    assert len(tg) == len(jg)
    for a, b in zip(jg, tg):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("window", [None, 8])
def test_dense_and_flash_give_the_same_loss(monkeypatch, window):
    monkeypatch.setattr(ttrans, "DTYPE", torch.float32)
    monkeypatch.setattr(ttrans, "WINDOW", window)
    params = common.to_device(ttrans.init(2, **SMALL), "cpu")
    batch = common.to_device(common.synthetic_token_batch(
        4, 2, SMALL["seq_len"], SMALL["vocab"]), "cpu")
    dense, dgrads = common.value_and_grad(ttrans.loss_fn, params, batch)
    flash, fgrads = common.value_and_grad(ttrans.flash_loss_fn, params,
                                          batch)
    assert float(flash) == pytest.approx(float(dense), rel=1e-6)
    for a, b in zip(tree_leaves(dgrads), tree_leaves(fgrads)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-6)


def test_transformer_trains_on_cpu():
    res = common.run_training(partial(ttrans.init, **SMALL),
                              ttrans.flash_loss_fn,
                              partial(common.synthetic_token_batch,
                                      batch_size=2, seq_len=32, vocab=64),
                              steps=8, learning_rate=1e-2, device="cpu")
    assert np.isfinite(res.final_loss) and res.final_loss < res.first_loss


def test_token_batch_shapes():
    x, y = ttrans.batch_fn(0)
    assert x.shape == y.shape == (ttrans.BATCH_SIZE, ttrans.SEQ_LEN)
    assert x.dtype.kind == "i" and x.max() < ttrans.VOCAB
    np.testing.assert_array_equal(x[:, 1:], y[:, :-1])
