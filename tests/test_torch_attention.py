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
# the wide head dims the kernels take on the card (GPT-2's 64, Llama's
# 128), each case (causal, window, kv heads, block_q, block_k, head dim)
FLASH_WIDE_CASES = [
    (True, None, 2, 16, 16, 64),
    (True, 5, 2, 8, 16, 64),
    (True, None, 2, 16, 16, 128),
    (False, None, 4, 16, 16, 128),
    (True, 5, 2, 8, 16, 128),
]
# every other instance and head dims between them, as the kernels take
# them on the card: 16 (dim 128), 20 (on the instance 32), Phi-2's 80 and
# Phi-3-mini's 96 (on 128), Gemma's 256
FLASH_OTHER_WIDTH_CASES = [
    (True, None, 2, 16, 16, 16),
    (True, 5, 2, 8, 16, 20),
    (True, None, 2, 16, 16, 80),
    (False, None, 4, 16, 16, 96),
    (True, 5, 1, 8, 16, 256),
]
#: head dims past 8, 32, 64 and 128 that the kernels take on the card
OTHER_WIDTHS = [16, 20, 80, 96, 256]


@pytest.mark.parametrize(
    "causal,window,hk,bq,bk,d",
    [c + (8,) for c in FLASH_CASES] + FLASH_WIDE_CASES
    + FLASH_OTHER_WIDTH_CASES,
    ids=["-".join(map(str, c[:5])) + ("" if c[5] == 8 else f"-d{c[5]}")
         for c in [c + (8,) for c in FLASH_CASES] + FLASH_WIDE_CASES
         + FLASH_OTHER_WIDTH_CASES])
def test_flash_matches_jax(causal, window, hk, bq, bk, d):
    """Forward at 1e-5; q, k, v gradients of a weighted sum at 1e-4,
    through the port's autograd against jax.grad; head dim 8 and the wide
    ones."""
    q, k, v = _inputs(hk=hk, d=d, seed=hk + bq)
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
    _check_flash_lse_against_jax(8)


@pytest.mark.parametrize("d", [64, 128] + OTHER_WIDTHS)
def test_flash_lse_matches_jax_at_wide_head_dims(d):
    """As :func:`test_flash_lse_matches_jax`, at GPT-2's and Llama's head
    dims, and at the other instances and head dims between them."""
    _check_flash_lse_against_jax(d)


def _check_flash_lse_against_jax(d):
    q, k, v = _inputs(hk=2, d=d, seed=11)
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


def test_instance_head_dim_is_the_narrowest_instance_that_holds_d():
    """Every head dim from 1 to 256 runs on the narrowest instance at
    least as wide; the instances are the kernels' widths."""
    assert tflash.INSTANCES == (8, 16, 32, 64, 128, 256)
    assert tflash.MAX_HEAD_DIM == 256
    for d in range(1, 257):
        inst = tflash.instance_head_dim(d)
        assert inst in tflash.INSTANCES and inst >= d
        assert all(i < d for i in tflash.INSTANCES if i < inst)
    assert [tflash.instance_head_dim(d) for d in (16, 20, 80, 96, 200)] == \
        [16, 32, 128, 128, 256]


@pytest.mark.parametrize("d", [257, 512, 0])
def test_head_dims_the_kernels_do_not_take_are_refused(d):
    """Past 256 (and below 1) the instance lookup and the CUDA wrappers'
    check raise a ValueError naming the limit: a refusal, not a fallback.
    The check runs here on CPU tensors, as it does before a launch."""
    with pytest.raises(ValueError, match="1 to 256"):
        tflash.instance_head_dim(d)
    q = torch.zeros((1, 16, 2, d), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="1 to 256"):
        tflash._check_cuda(q, q, q)


@pytest.mark.parametrize("d,wide", [(16, False), (20, False), (33, True),
                                    (80, True), (96, True), (200, True),
                                    (256, True)])
def test_the_prologue_follows_the_wgmma_instances(d, wide):
    """bf16 reads dO through the prologue from head dim 33 (the instances
    64, 128 and 256), padded widths included; fp32 never."""
    q = torch.zeros((1, 16, 2, d), dtype=torch.bfloat16)
    assert tflash._takes_split(q) is wide
    assert tflash._takes_split(q.float()) is False


def test_flash_launches_nothing_on_cpu():
    tflash.reset_launches()
    q, k, v = (torch.tensor(a, requires_grad=True) for a in _inputs())
    tflash.flash_attention(q, k, v, block_q=16, block_k=16).sum().backward()
    assert tflash.launches == {"fwd": 0, "dq": 0, "dkv": 0, "prep": 0}


def test_flash_plain_passes_agree_with_autograd_of_dense():
    """The three plain passes alone (no autograd wiring) against torch's
    own autograd of the dense reference, with GQA and a window."""
    _check_plain_passes_against_dense(8)


@pytest.mark.parametrize("d", [64, 128] + OTHER_WIDTHS)
def test_flash_plain_passes_agree_with_autograd_of_dense_at_wide_head_dims(
        d):
    """As :func:`test_flash_plain_passes_agree_with_autograd_of_dense`, at
    head dims 64 and 128, and at the other instances and head dims between
    them."""
    _check_plain_passes_against_dense(d)


def _check_plain_passes_against_dense(d):
    q, k, v = (torch.tensor(a, requires_grad=True) for a in
               _inputs(hk=2, d=d, seed=21))
    g = torch.from_numpy(np.random.default_rng(22).standard_normal(
        q.shape).astype(np.float32))
    dense = tattn.dot_product_attention(q, k, v, window=7)
    (dense * g).sum().backward()
    scale = 1.0 / np.sqrt(d)
    with torch.no_grad():
        o, lse = tflash.flash_fwd_reference(q, k, v, True, 7, scale)
        dcap = (g * o).sum(-1).transpose(1, 2)
        dq = tflash.flash_dq_reference(q, k, v, g, lse, dcap, True, 7, scale)
        dk, dv = tflash.flash_dkv_reference(q, k, v, g, lse, dcap, True, 7,
                                            scale)
    _close(o, dense.detach().numpy(), 1e-5)
    for got, t in ((dq, q), (dk, k), (dv, v)):
        _close(got, t.grad.numpy(), 1e-4)


def test_flash_backward_builds_d_once(monkeypatch):
    """Both backward passes get one dense fp32 (b, h, s_q) D = rowsum(dO ∘
    O) − g_lse: the same tensor, so neither pass copies it."""
    seen = {}
    for name in ("flash_dq", "flash_dkv"):
        def record(*args, _name=name, _real=getattr(tflash, name)):
            seen[_name] = args
            return _real(*args)
        monkeypatch.setattr(tflash, name, record)
    q, k, v = (torch.tensor(a, requires_grad=True) for a in
               _inputs(hk=2, seed=31))
    w = torch.from_numpy(np.random.default_rng(32).standard_normal(
        q.shape).astype(np.float32))
    o, lse = tflash.flash_attention_lse(q, k, v, block_q=16, block_k=16)
    ((o * w).sum() + torch.sin(lse).sum()).backward()
    dcap = seen["flash_dq"][5]
    assert seen["flash_dkv"][5] is dcap
    assert dcap.is_contiguous() and dcap.dtype == torch.float32
    want = ((w * o.detach()).sum(-1) - torch.cos(lse.detach())).transpose(1, 2)
    torch.testing.assert_close(dcap, want)


# --- the bf16 backward kernels' arithmetic -----------------------------------

def _bf16_parts(x):
    """fp32 x as its bf16 parts hi = bf16(x) and lo = bf16(x − hi), both
    back in fp32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _lo_live_rows(do_lo):
    """(b, h, s_q) bool: does the 64-row q tile of each row hold a
    nonzero dO lo part (the prologue's flags, row by row)?"""
    b, s, h, _ = do_lo.shape
    n = -(-s // tflash.PREP_TILE)
    nz = (do_lo != 0).any(-1).transpose(1, 2).to(torch.int32)
    nz = torch.nn.functional.pad(nz, (0, n * tflash.PREP_TILE - s))
    tiles = nz.reshape(b, h, n, tflash.PREP_TILE).amax(-1)
    return tiles.repeat_interleave(tflash.PREP_TILE, -1)[..., :s].bool()


def _emulated_mma_backward(q, k, v, dout, lse, dcap, causal, window, scale,
                           split_ds=True, wide=False, skip_zero_lo=True):
    """``(dQ, dK, dV)`` with the arithmetic of the bf16 backward kernels
    (``csrc/flash_attention.cu``) in torch: every product takes
    bf16-exact operands and sums in fp32; P, dS and dO go in as two bf16
    parts each (dV drops P_lo·dO_lo); the scale multiplies dQ and dK at the
    end. ``split_ds=False`` rounds dS to bf16 once instead. ``wide``: the
    arithmetic of the wgmma kernels at head dims 64 and 128
    (``csrc/flash_backward_wide.cuh``): dO's lo products (dP's dO_lo·Vᵀ,
    dV's P_hi·dO_lo) come last, and (``skip_zero_lo``) are left out for
    the q rows of a 64-row tile whose lo part is all zero."""
    group = q.shape[2] // k.shape[2]
    sc, qf, kf = tflash._masked_scores(q, k, causal, window, 1.0)
    p = torch.where(sc > tattn.MASK_VALUE / 2,
                    torch.exp(sc * scale - lse[..., None]), 0.0)
    vf = v.float().repeat_interleave(group, dim=2)
    do_hi, do_lo = _bf16_parts(dout.float())
    dp_lo, dp_hi = (torch.einsum("bqhd,bkhd->bhqk", part, vf)
                    for part in (do_lo, do_hi))
    p_hi, p_lo = _bf16_parts(p)
    if not wide:
        dp = sum((dp_lo, dp_hi))
        dv_terms = [(p_lo, do_hi), (p_hi, do_lo), (p_hi, do_hi)]
    else:
        dp = sum((dp_hi, dp_lo))
        dv_terms = [(p_lo, do_hi), (p_hi, do_hi), (p_hi, do_lo)]
        if skip_zero_lo:
            live = _lo_live_rows(do_lo)[..., None]      # (b, h, s_q, 1)
            dp = torch.where(live, dp, sum((dp_hi,)))
            if live.any():
                dv_terms[2] = (torch.where(live, p_hi, 0.0), do_lo)
            else:
                del dv_terms[2]
    ds = p * (dp - dcap[..., None])
    ds_parts = _bf16_parts(ds) if split_ds else (ds.to(torch.bfloat16).float(),)
    dq = scale * sum(torch.einsum("bhqk,bkhd->bqhd", part, kf)
                     for part in ds_parts)
    dk = scale * sum(torch.einsum("bhqk,bqhd->bkhd", part, qf)
                     for part in ds_parts)
    dv = sum(torch.einsum("bhqk,bqhd->bkhd", a, b) for a, b in dv_terms)
    b, s_kv, hk, d = k.shape
    kv_sized = lambda x: x.reshape(b, s_kv, hk, group, d).sum(dim=3).to(
        torch.bfloat16)
    return dq.to(torch.bfloat16), kv_sized(dk), kv_sized(dv)


def _bf16_backward_case(shape, hk, window, seed=0, exact_dout=False):
    """bf16 q, k, v and fp32 dO (not bf16-exact, unless
    ``exact_dout``: then the gradient of a bf16 cast, as on every main
    path) at ``shape``, causal, with the plain forward's lse and D: the
    backward's arguments and its plain (dQ, dK, dV)."""
    b, s, h, d = shape
    rng = np.random.default_rng(seed)
    randn = lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32))
    q = randn(b, s, h, d).to(torch.bfloat16)
    k, v = (randn(b, s, hk, d).to(torch.bfloat16) for _ in range(2))
    dout = randn(b, s, h, d)
    if exact_dout:
        dout = dout.to(torch.bfloat16).float()
    scale = 1.0 / np.sqrt(d)
    o, lse = tflash.flash_fwd_reference(q, k, v, True, window, scale)
    args = (q, k, v, dout, lse, (dout * o).sum(-1).transpose(1, 2), True,
            window, scale)
    return args, (tflash.flash_dq_reference(*args),
                  *tflash.flash_dkv_reference(*args))


def _padded(xs, inst):
    """q, k, v (and dO) as the kernels of the instance ``inst`` hold them:
    the head dim zero-padded to the instance's width (a no-op at an
    instance's own width)."""
    return [torch.nn.functional.pad(x, (0, inst - x.shape[-1])) for x in xs]


def _share_outside_bf16_tol(got, want):
    atol, rtol = tflash.KERNEL_TOL[torch.bfloat16]
    err = (got.float() - want.float()).abs()
    return float((err > atol + rtol * want.float().abs()).float().mean())


@pytest.mark.parametrize(
    "shape,hk,window,exact_dout",
    [((1, 256, 8, 32), 8, None, False), ((1, 256, 8, 32), 2, 100, False),
     ((1, 128, 4, 128), 4, None, False), ((1, 128, 4, 128), 2, 50, False),
     ((1, 128, 4, 64), 4, None, False), ((1, 128, 4, 64), 2, 50, False),
     ((1, 128, 4, 64), 2, 50, True), ((1, 128, 4, 128), 4, None, True),
     ((1, 128, 4, 80), 2, 50, False), ((1, 128, 4, 256), 4, None, False),
     ((1, 128, 4, 256), 1, 50, True)],
    ids=["main-path", "gqa-window", "head-dim-128",
         "head-dim-128-gqa-window", "head-dim-64", "head-dim-64-gqa-window",
         "head-dim-64-gqa-window-bf16-exact-dout",
         "head-dim-128-bf16-exact-dout", "head-dim-80-on-128-gqa-window",
         "head-dim-256", "head-dim-256-mqa-window-bf16-exact-dout"])
def test_mma_backward_arithmetic_holds_bf16_tolerance(shape, hk, window,
                                                      exact_dout):
    """The kernels' split products keep dQ, dK and dV (in bf16) within
    KERNEL_TOL of the fp32 plain versions: one bf16 ulp. From head dim 33
    with the wide kernels' arithmetic: dO's lo products last, and skipped
    for all-zero lo tiles. A head dim between instances runs on the wider
    one's zero-padded columns (80 on 128), the scale from its own."""
    args, want = _bf16_backward_case(shape, hk, window,
                                     exact_dout=exact_dout)
    atol, rtol = tflash.KERNEL_TOL[torch.bfloat16]
    d = shape[-1]
    inst = tflash.instance_head_dim(d)
    wide = inst in tflash.WIDE_HEAD_DIMS
    emulated = _emulated_mma_backward(*_padded(args[:4], inst), *args[4:],
                                      wide=wide)
    for got, ref in zip(emulated, want):
        assert not got[..., d:].any()
        got = got[..., :d]
        assert got.dtype == ref.dtype and got.shape == ref.shape
        torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                                   rtol=rtol)


def test_unsplit_ds_breaks_the_bf16_tolerance():
    """Why dS is split: rounded to bf16 once, it moves a few percent of dQ
    and dK by more than one bf16 ulp at the main shape (the sums over keys
    and queries cancel); dV, which does not use dS, keeps its tolerance."""
    args, want = _bf16_backward_case((1, 256, 8, 32), 8, None)
    got = _emulated_mma_backward(*args, split_ds=False)
    dq, dk, dv = (_share_outside_bf16_tol(g, w) for g, w in zip(got, want))
    assert dq > 0.01 and dk > 0.01 and dv == 0.0


@pytest.mark.parametrize("d", [64, 128])
def test_skipping_zero_lo_products_keeps_the_bits(d):
    """Where dO is exact in bf16 (every main path: the gradient of a bf16
    cast) its lo part is 0, the prologue flags no tile, and leaving out the
    lo products gives dQ, dK and dV bit for bit those of adding them: each
    adds exactly 0."""
    args, _ = _bf16_backward_case((1, 192, 4, d), 2, None, seed=3,
                                  exact_dout=True)
    _, lo_live, _ = tflash.flash_prep_reference(args[3], torch.zeros(
        args[3].shape), None)
    assert lo_live.shape == (4, 3) and int(lo_live.sum()) == 0
    for skipped, full in zip(
            _emulated_mma_backward(*args, wide=True),
            _emulated_mma_backward(*args, wide=True, skip_zero_lo=False)):
        assert torch.equal(skipped, full)


# --- the wide bf16 forward kernel's arithmetic -------------------------------

def _emulated_wide_forward(q, k, v, causal, window, scale, split_p=True,
                           tile=64):
    """``(O, lse)`` with the arithmetic of the wgmma forward at head dims
    64 and 128 (``csrc/flash_forward_wide.cuh``) in torch: S = Q·Kᵀ of
    bf16-exact operands summed in fp32; the online softmax over key tiles
    of ``tile``, the scale folded into the exponent (p = 2^(s·scale2 −
    m·scale2), one fused multiply-add a score), alpha and p 0 below
    MASK/2; O rescaled, then O += P_lo·V and O += P_hi·V, bf16-exact
    products summed in fp32. ``split_p=False`` rounds P to bf16 once
    instead, as FlashAttention-3 does."""
    half = tattn.MASK_VALUE / 2
    scale2 = torch.tensor(scale * 1.4426950408889634, dtype=torch.float32)
    fma = lambda x, y, z: (x.double() * y.double() + z.double()).float()
    sc, _, _ = tflash._masked_scores(q, k, causal, window, 1.0)
    vf = v.float().repeat_interleave(q.shape[2] // v.shape[2], dim=2)
    b, s_q, h, d = q.shape
    m = torch.full((b, h, s_q), tattn.MASK_VALUE)
    l = torch.zeros((b, h, s_q))
    o = torch.zeros((b, h, s_q, d))
    for k0 in range(0, k.shape[1], tile):
        s = sc[..., k0:k0 + tile]
        m_new = torch.maximum(m, s.amax(-1))
        ms = m_new * scale2
        alpha = torch.where(m > half, torch.exp2(fma(m, scale2, -ms)), 0.0)
        p = torch.where(s > half, torch.exp2(fma(s, scale2, -ms[..., None])),
                        0.0)
        m, l = m_new, l * alpha + p.sum(-1)
        o = o * alpha[..., None]
        parts = _bf16_parts(p) if split_p else (p.to(torch.bfloat16).float(),)
        for part in parts[::-1]:                       # lo, then hi
            o = o + torch.einsum("bhqk,bkhd->bhqd", part,
                                 vf[:, k0:k0 + tile])
    den = torch.where(l > 0.0, l, torch.ones_like(l))
    lse = torch.where(m > half, m * scale, tattn.MASK_VALUE) + torch.log(den)
    return (o / den[..., None]).permute(0, 2, 1, 3), lse


def _bf16_forward_case(b, s_q, s_kv, h, hk, d, seed=0):
    rng = np.random.default_rng(seed)
    randn = lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32)).to(torch.bfloat16)
    return randn(b, s_q, h, d), randn(b, s_kv, hk, d), randn(b, s_kv, hk, d)


@pytest.mark.parametrize(
    "b,s_q,s_kv,h,hk,d,causal,window",
    [(2, 256, 256, 8, 2, 64, True, None), (1, 256, 256, 8, 2, 128, True,
                                          None),
     (1, 256, 256, 8, 8, 64, True, 100), (1, 200, 200, 8, 2, 128, True, 70),
     (1, 200, 200, 4, 4, 64, True, None), (1, 160, 200, 8, 2, 128, False,
                                           None),
     (1, 130, 96, 4, 2, 64, False, None),
     (1, 200, 200, 8, 2, 80, True, 70), (2, 128, 128, 4, 4, 96, True, None),
     (1, 256, 256, 4, 1, 256, True, None),
     (1, 130, 96, 4, 2, 256, False, None)],
    ids=["hd64-gqa", "hd128-gqa", "hd64-window", "hd128-ragged-gqa-window",
         "hd64-ragged", "hd128-sq-ne-skv-gqa", "hd64-sq-ne-skv-ragged",
         "hd80-on-128-ragged-gqa-window", "hd96-on-128", "hd256-mqa",
         "hd256-sq-ne-skv-ragged"])
def test_wide_forward_arithmetic_holds_kernel_tolerance(b, s_q, s_kv, h, hk,
                                                        d, causal, window):
    """The wgmma forward's split P keeps O and the lse within KERNEL_TOL
    (fp32) of the plain forward: GQA, windows, ragged lengths and s_q ≠
    s_kv, key tiles of 64; a head dim between instances on the wider one's
    zero-padded columns (80 and 96 on 128), the scale from its own; 256."""
    q, k, v = _bf16_forward_case(b, s_q, s_kv, h, hk, d)
    scale = 1.0 / np.sqrt(d)
    want = tflash.flash_fwd_reference(q, k, v, causal, window, scale)
    o, lse = _emulated_wide_forward(
        *_padded((q, k, v), tflash.instance_head_dim(d)), causal, window,
        scale)
    assert not o[..., d:].any()
    got = (o[..., :d], lse)
    atol, rtol = tflash.KERNEL_TOL[torch.float32]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == torch.float32
        torch.testing.assert_close(g, w, atol=atol, rtol=rtol)


@pytest.mark.parametrize("d", [64, 128])
def test_unsplit_p_breaks_the_forward_tolerance(d):
    """Why the forward splits P: rounded to bf16 once, P moves more than 1%
    of O outside even the bf16 tolerance (O's own is fp32, tighter) at
    (1, 256, 4, d) causal, where the hi/lo split moves none outside the
    fp32 one."""
    q, k, v = _bf16_forward_case(1, 256, 256, 4, 4, d, seed=1)
    scale = 1.0 / np.sqrt(d)
    want, _ = tflash.flash_fwd_reference(q, k, v, True, None, scale)
    unsplit, _ = _emulated_wide_forward(q, k, v, True, None, scale,
                                        split_p=False)
    split, _ = _emulated_wide_forward(q, k, v, True, None, scale)
    atol, rtol = tflash.KERNEL_TOL[torch.float32]
    outside_f32 = float(((split - want).abs()
                         > atol + rtol * want.abs()).float().mean())
    assert _share_outside_bf16_tol(unsplit, want) > 0.01
    assert outside_f32 == 0.0


@pytest.mark.parametrize("with_g_lse", [False, True])
def test_flash_prep_plain_matches_jax_d(with_g_lse):
    """The prologue's plain version against the JAX backward's own D
    (``kubeshare_tpu/ops/flash_attention.py`` ``_flash_bwd``: rowsum(dO ∘
    O) − g_lse over its folded rows) on the same numpy inputs; its hi and
    lo parts against JAX's bf16 casts; its flags against the lo parts,
    tile by tile (s_q = 80: a ragged second tile)."""
    from kubeshare_tpu.ops.flash_attention import _fold

    b, s, h, d = 2, 80, 4, 64
    rng = np.random.default_rng(41)
    dout = rng.standard_normal((b, s, h, d)).astype(np.float32)
    dout[:, :64, 1] = dout[:, :64, 1].astype(jnp.bfloat16).astype(np.float32)
    o = rng.standard_normal((b, s, h, d)).astype(np.float32)
    g_lse = (rng.standard_normal((b, s, h)).astype(np.float32)
             if with_g_lse else None)
    # the JAX backward's D, as its lines compute it
    want = (_fold(jnp.asarray(dout)) * _fold(jnp.asarray(o))).sum(
        -1, keepdims=True)
    if with_g_lse:
        want = want - (jnp.asarray(g_lse).transpose(0, 2, 1)
                       .reshape(b * h, s, 1))
    split, lo_live, dcap = tflash.flash_prep_reference(
        torch.from_numpy(dout), torch.from_numpy(o),
        None if g_lse is None else torch.from_numpy(g_lse))
    assert dcap.shape == (b, h, s) and dcap.is_contiguous()
    _close(dcap.reshape(b * h, s, 1), np.asarray(want), 1e-5)
    jhi = jnp.asarray(dout).astype(jnp.bfloat16)
    jlo = (jnp.asarray(dout) - jhi.astype(jnp.float32)).astype(jnp.bfloat16)
    assert split.shape == (2, b, s, h, d) and split.dtype == torch.bfloat16
    for got, ref in zip(split, (jhi, jlo)):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref.astype(jnp.float32)))
    nz = np.asarray(jlo != 0).any(-1)                    # (b, s, h)
    tiles = [nz[:, :64].any(1), nz[:, 64:].any(1)]       # (b, h) each
    want_live = np.stack(tiles, -1).reshape(b * h, 2).astype(np.int32)
    np.testing.assert_array_equal(lo_live.numpy(), want_live)
    # head 1's first tile is exact in bf16 in both batches: only it is off
    assert want_live[1::h, 0].sum() == 0 and want_live.sum() == 2 * b * h - b


def test_flash_prep_op_passes_opcheck():
    """The prologue as a custom op: schema, fake shapes and the CPU
    implementation agree (torch.library.opcheck)."""
    rng = np.random.default_rng(43)
    dout, o = (torch.from_numpy(rng.standard_normal((1, 70, 2, 128))
                                .astype(np.float32)) for _ in range(2))
    g_lse = torch.from_numpy(rng.standard_normal((1, 70, 2)).astype(
        np.float32))
    for args in ((dout, o, None), (dout, o, g_lse)):
        torch.library.opcheck(tflash.flash_prep, args)
    split, lo_live, dcap = tflash.flash_prep(dout, o, g_lse)
    assert lo_live.shape == (2, 2) and lo_live.dtype == torch.int32


@pytest.mark.parametrize("d", [64, 128, 80, 256])
def test_flash_backward_reads_do_through_the_prologue_at_wide_head_dims(
        monkeypatch, d):
    """bf16 from head dim 33: the backward calls the prologue once
    and hands its D, parts and flags to both passes; the gradients are the
    plain versions' on the same inputs (the CPU passes read dO itself)."""
    seen = {}
    for name in ("flash_prep", "flash_dq", "flash_dkv"):
        def record(*args, _name=name, _real=getattr(tflash, name)):
            seen.setdefault(_name, []).append(args)
            return _real(*args)
        monkeypatch.setattr(tflash, name, record)
    q, k, v = (torch.tensor(a).to(torch.bfloat16).requires_grad_(True)
               for a in _inputs(hk=2, d=d, seed=33))
    w = torch.from_numpy(np.random.default_rng(34).standard_normal(
        q.shape).astype(np.float32))
    o, lse = tflash.flash_attention_lse(q, k, v, block_q=16, block_k=16)
    ((o * w).sum() + torch.sin(lse).sum()).backward()
    (prep,) = seen["flash_prep"]
    split, lo_live, dcap = tflash.flash_prep_reference(*prep)
    for name in ("flash_dq", "flash_dkv"):
        (args,) = seen[name]
        assert torch.equal(args[5], dcap) and torch.equal(args[9], split)
        assert torch.equal(args[10], lo_live)
    scale = 1.0 / np.sqrt(d)
    with torch.no_grad():
        ro, rlse = tflash.flash_fwd_reference(q, k, v, True, None, scale)
        want_dcap = ((w * ro).sum(-1) - torch.cos(rlse.transpose(1, 2))
                     ).transpose(1, 2)
        args = (q, k, v, w, rlse, want_dcap, True, None, scale)
        want = (tflash.flash_dq_reference(*args),
                *tflash.flash_dkv_reference(*args))
    for t, ref in zip((q, k, v), want):
        torch.testing.assert_close(t.grad, ref, atol=0, rtol=0)


@pytest.mark.parametrize("d", [64, 128, 80, 256])
def test_wide_passes_require_the_prologue_parts(d):
    """The CUDA passes' check of dO's parts, run on CPU tensors: bf16 from
    head dim 33 a pass given dO alone, or parts that do not fit,
    raises (no prologue launched on its own); head dim 32 and fp32 take
    none; the prologue's own outputs pass."""
    rng = np.random.default_rng(44)
    b, s, h = 1, 70, 2
    q = torch.zeros((b, s, h, d), dtype=torch.bfloat16)
    dout, o = (torch.from_numpy(rng.standard_normal((b, s, h, d))
                                .astype(np.float32)) for _ in range(2))
    split, lo_live, _ = tflash.flash_prep_reference(dout, o)
    for parts in ((None, None), (split, None), (None, lo_live),
                  (split[:, :, :64].contiguous(), lo_live),
                  (split, lo_live.to(torch.int64)),
                  (split.float(), lo_live)):
        with pytest.raises(ValueError, match="dout_split"):
            tflash._split_pointers(q, dout, *parts)
    pointers, keep = tflash._split_pointers(q, dout, split, lo_live)
    assert pointers[1] - pointers[0] == split.numel() and len(keep) == 2
    for other in (q[..., :32], q.float()):
        assert tflash._split_pointers(other, dout[..., :other.shape[-1]],
                                      None, None) == (tflash._NO_SPLIT, ())
