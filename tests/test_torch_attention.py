"""Port's attention ops and flash attention against the JAX package's, on
the CPU.

The same numpy inputs, made from a seed, go through both. The JAX flash
kernel runs as its own tests run it off-TPU (Pallas in interpret mode);
the port's flash op takes its plain versions, as it does for any CPU
tensor. Bars are ``tests/test_flash_attention.py``'s: 1e-5 forward, 1e-4
gradients.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubeshare_tpu.ops import attention as jattn
from kubeshare_tpu.ops import layers as jlayers
from kubeshare_tpu.ops.flash_attention import (
    flash_attention as jflash_attention)
from kubeshare_tpu.ops.flash_attention import (
    flash_attention_lse as jflash_lse)
from kubeshare_tpu_torch.ops import attention as tattn
from kubeshare_tpu_torch.ops import flash_attention as tflash
from kubeshare_tpu_torch.ops import layers as tlayers


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _inputs(b=1, s=32, h=4, hk=4, d=8, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    return q, k, v


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# --- layernorm, rope, dense attention, mha ----------------------------------

def test_layernorm_matches_jax():
    rng = np.random.default_rng(1)
    params = tlayers.layernorm_init(24)
    params["scale"] = rng.standard_normal(24).astype(np.float32)
    params["bias"] = rng.standard_normal(24).astype(np.float32)
    # an offset mean makes the population/unbiased variance gap visible
    x = (rng.standard_normal((3, 5, 24)) * 3 + 2).astype(np.float32)
    want = jlayers.layernorm_apply({k: jnp.asarray(v) for k, v in
                                    params.items()}, jnp.asarray(x))
    got = tlayers.layernorm_apply({k: torch.from_numpy(v) for k, v in
                                   params.items()}, torch.from_numpy(x))
    _close(got, want, 1e-5)
    assert jax.tree_util.tree_map(np.shape, jlayers.layernorm_init(24)) == \
        {k: np.shape(v) for k, v in tlayers.layernorm_init(24).items()}


def test_rope_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 9, 3, 8)).astype(
        np.float32)
    _close(tattn.rope(torch.from_numpy(x)), jattn.rope(jnp.asarray(x)), 1e-5)
    got = tattn.rope(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="even"):
        tattn.rope(torch.zeros(1, 2, 1, 3))


@pytest.mark.parametrize("causal,hk,window", [(True, 4, None),
                                              (False, 4, None),
                                              (True, 2, None),
                                              (True, 4, 5)])
def test_dot_product_attention_matches_jax(causal, hk, window):
    q, k, v = _inputs(b=2, s=12, hk=hk)
    want = jattn.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=causal,
                                       window=window)
    got = tattn.dot_product_attention(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), causal=causal,
                                      window=window)
    assert got.dtype == torch.float32
    _close(got, want, 1e-5)


def test_dot_product_attention_aligns_mask_to_kv_end():
    q, k, v = _inputs(s=12)
    want = jattn.dot_product_attention(*(jnp.asarray(a) for a in
                                         (q[:, -4:], k, v)))
    got = tattn.dot_product_attention(*(torch.from_numpy(a) for a in
                                        (q[:, -4:], k, v)))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("kv_heads,use_rope", [(None, False), (2, True)])
def test_mha_apply_matches_jax(kv_heads, use_rope):
    rng = np.random.default_rng(4)
    params = tattn.mha_init(rng, 32, 4, kv_heads=kv_heads)
    jparams = jattn.mha_init(jax.random.PRNGKey(0), 32, 4, kv_heads=kv_heads)
    assert jax.tree_util.tree_map(np.shape, jparams) == \
        {k: np.shape(v) for k, v in params.items()}
    x = rng.standard_normal((2, 8, 32)).astype(np.float32)
    want = jattn.mha_apply({k: jnp.asarray(v) for k, v in params.items()},
                           jnp.asarray(x), 4, use_rope=use_rope)
    got = tattn.mha_apply({k: torch.from_numpy(v) for k, v in
                           params.items()}, torch.from_numpy(x), 4,
                          use_rope=use_rope)
    _close(got, want, 1e-5)


def test_mha_apply_casts_like_jax():
    """With dtype=bf16 the attention body gets bf16 q, k, v (views of one
    fused product) and its fp32 output is cast back before ``out``."""
    rng = np.random.default_rng(5)
    params = {k: torch.from_numpy(v) for k, v in
              tattn.mha_init(rng, 16, 2).items()}
    seen = {}

    def body(q, k, v):
        seen["dtypes"] = {q.dtype, k.dtype, v.dtype}
        seen["contiguous"] = q.is_contiguous()
        return tattn.dot_product_attention(q, k, v)

    x = torch.from_numpy(rng.standard_normal((1, 4, 16)).astype(np.float32))
    out = tattn.mha_apply(params, x, 2, attn_fn=body, dtype=torch.bfloat16)
    assert seen == {"dtypes": {torch.bfloat16}, "contiguous": False}
    assert out.dtype == torch.bfloat16


# --- flash attention ---------------------------------------------------------

FLASH_CASES = [
    # (causal, window, kv heads, block_q, block_k)
    (True, None, 4, 16, 16),
    (True, None, 2, 8, 16),
    (False, None, 2, 16, 16),
    (False, None, 4, 8, 16),
    (True, 5, 4, 16, 16),
    (True, 5, 2, 8, 16),
]


@pytest.mark.parametrize("causal,window,hk,bq,bk", FLASH_CASES)
def test_flash_matches_jax(causal, window, hk, bq, bk):
    """Forward at 1e-5; q, k, v gradients of a weighted sum at 1e-4,
    through the port's autograd against jax.grad."""
    q, k, v = _inputs(hk=hk, seed=hk + bq)
    w = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    kw = dict(causal=causal, window=window, block_q=bq, block_k=bk)

    def jloss(q, k, v):
        return (jflash_attention(q, k, v, **kw) * w).sum()

    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = jflash_attention(jq, jk, jv, **kw)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)

    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    got = tflash.flash_attention(tq, tk, tv, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    _close(got, want, 1e-5)
    (got * torch.from_numpy(w)).sum().backward()
    for t, g in zip((tq, tk, tv), jgrads):
        assert tuple(t.grad.shape) == g.shape
        _close(t.grad, g, 1e-4)


def test_flash_lse_matches_jax():
    """A loss that uses both outputs: the lse cotangent folds into D."""
    q, k, v = _inputs(hk=2, seed=11)
    w = np.random.default_rng(12).standard_normal(q.shape).astype(np.float32)
    kw = dict(block_q=16, block_k=16)

    def jloss(q, k, v):
        o, lse = jflash_lse(q, k, v, **kw)
        return (o * w).sum() + (jnp.sin(lse)).sum()

    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    jo, jlse = jflash_lse(jq, jk, jv, **kw)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)

    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o, lse = tflash.flash_attention_lse(tq, tk, tv, **kw)
    assert tuple(lse.shape) == (1, 32, 4) and lse.dtype == torch.float32
    _close(o, jo, 1e-5)
    _close(lse, jlse, 1e-5)
    ((o * torch.from_numpy(w)).sum() + torch.sin(lse).sum()).backward()
    for t, g in zip((tq, tk, tv), jgrads):
        _close(t.grad, g, 1e-4)


def test_flash_matches_dense_on_strided_views():
    """q, k, v as slices of one fused product (the transformer's layout)."""
    rng = np.random.default_rng(13)
    fused = torch.from_numpy(rng.standard_normal((2, 32, 4 * 8 + 2 * 2 * 8))
                             .astype(np.float32))
    q = fused[..., :32].reshape(2, 32, 4, 8)
    k = fused[..., 32:48].reshape(2, 32, 2, 8)
    v = fused[..., 48:].reshape(2, 32, 2, 8)
    assert not q.is_contiguous()
    _close(tflash.flash_attention(q, k, v, block_q=16, block_k=16),
           tattn.dot_product_attention(q, k, v), 1e-5)


def test_flash_gradient_dtypes_match_primals():
    q, k, v = (torch.tensor(a).to(torch.bfloat16).requires_grad_(True)
               for a in _inputs(hk=2))
    tflash.flash_attention(q, k, v, block_q=16, block_k=16).sum().backward()
    assert [t.grad.dtype for t in (q, k, v)] == [torch.bfloat16] * 3
    assert tuple(k.grad.shape) == tuple(k.shape)


@pytest.mark.parametrize("case", ["ragged_heads", "ragged_blocks",
                                  "window_no_causal", "window_zero",
                                  "causal_lengths"])
def test_flash_errors_match_jax(case):
    q, k, v = _inputs(s=48)
    kw = dict(block_q=16, block_k=16)
    match = "divisible"
    if case == "ragged_heads":
        k = v = np.zeros((1, 48, 3, 8), np.float32)
    elif case == "ragged_blocks":
        kw = dict(block_q=32, block_k=32)
    elif case == "window_no_causal":
        kw.update(causal=False, window=8)
        match = "causal"
    elif case == "window_zero":
        kw.update(window=0)
        match = ">= 1"
    else:
        k, v = k[:, :32], v[:, :32]
        match = "equal q/kv lengths"
    with pytest.raises(ValueError, match=match):
        jflash_attention(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    with pytest.raises(ValueError, match=match):
        tflash.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               **kw)


def test_flash_launches_nothing_on_cpu():
    tflash.reset_launches()
    q, k, v = (torch.tensor(a, requires_grad=True) for a in _inputs())
    tflash.flash_attention(q, k, v, block_q=16, block_k=16).sum().backward()
    assert tflash.launches == {"fwd": 0, "dq": 0, "dkv": 0}


def test_flash_plain_passes_agree_with_autograd_of_dense():
    """The three plain passes alone (no autograd wiring) against torch's
    own autograd of the dense reference, with GQA and a window."""
    q, k, v = (torch.tensor(a, requires_grad=True) for a in
               _inputs(hk=2, seed=21))
    g = torch.from_numpy(np.random.default_rng(22).standard_normal(
        q.shape).astype(np.float32))
    dense = tattn.dot_product_attention(q, k, v, window=7)
    (dense * g).sum().backward()
    scale = 1.0 / np.sqrt(8)
    with torch.no_grad():
        o, lse = tflash.flash_fwd_reference(q, k, v, True, 7, scale)
        dcap = (g * o).sum(-1).transpose(1, 2)
        dq = tflash.flash_dq_reference(q, k, v, g, lse, dcap, True, 7, scale)
        dk, dv = tflash.flash_dkv_reference(q, k, v, g, lse, dcap, True, 7,
                                            scale)
    _close(o, dense.detach().numpy(), 1e-5)
    for got, t in ((dq, q), (dk, k), (dv, v)):
        _close(got, t.grad.numpy(), 1e-4)
