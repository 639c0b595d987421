"""Multi-head attention as plain functions over parameter dicts, plus the
dense reference attention.

Counterpart of ``kubeshare_tpu/ops/attention.py``, in the same
``(batch, seq, heads, head_dim)`` layout, with its own copies of
``MASK_VALUE`` and ``kv_groups``. Masking uses the finite floor, not
``-inf``, and the softmax runs in fp32 whatever the input dtype. The
attention body is pluggable (``attn_fn``): the transformer passes
:func:`~kubeshare_tpu_torch.ops.flash_attention.flash_attention` there.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Finite mask floor: low enough that exp(floor - m) underflows to 0 for any
# realistic running max m, high enough that (floor - m) never overflows.
MASK_VALUE = -1e30


def kv_groups(heads: int, kv_heads: int) -> int:
    """Query heads per k/v head (grouped-query attention); raises when
    ``kv_heads`` does not divide ``heads``."""
    if heads % kv_heads:
        raise ValueError(f"heads {heads} not divisible by kv_heads "
                         f"{kv_heads}")
    return heads // kv_heads


def expand_kv(k: torch.Tensor, v: torch.Tensor, heads: int):
    """Grouped-query k/v repeated to the full head count (dense paths only;
    the flash kernels map the group in their indexing instead)."""
    hk = k.shape[2]
    if hk == heads:
        return k, v
    g = kv_groups(heads, hk)
    return k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, scale: float | None = None,
                          window: int | None = None) -> torch.Tensor:
    """Dense reference attention: ``q`` (batch, q_len, heads, head_dim),
    ``k``/``v`` (batch, kv_len, kv_heads, head_dim) → (batch, q_len,
    heads, head_dim) in fp32. The causal mask is aligned to the END of the
    kv sequence; ``window`` (with ``causal``) lets query i see keys in
    ``(i - window, i]``."""
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True (the band is "
                             "defined looking back from each query)")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    d = q.shape[-1]
    k, v = expand_kv(k, v, q.shape[2])
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    scores = torch.einsum("bqhd,bkhd->bqhk", q.float(), k.float()) * scale
    if causal:
        nq, nk = scores.shape[1], scores.shape[-1]
        qidx = torch.arange(nq, device=q.device) + (nk - nq)
        kidx = torch.arange(nk, device=q.device)
        mask = qidx[:, None] >= kidx[None, :]
        if window is not None:
            mask &= (qidx[:, None] - kidx[None, :]) < window
        scores = torch.where(mask[None, :, None, :], scores,
                             torch.tensor(MASK_VALUE, dtype=scores.dtype,
                                          device=scores.device))
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bqhk,bkhd->bqhd", weights, v.float())


def rope(x: torch.Tensor, positions: torch.Tensor | None = None,
         base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding over the head dimension of ``x``
    (batch, seq, heads, head_dim): each pair of CONCATENATED halves
    ``(x[i], x[i + d/2])`` rotates by ``pos · base^(-2i/d)``, computed in
    fp32 and cast back to ``x``'s dtype."""
    b, s, h, d = x.shape
    if d % 2:
        raise ValueError(f"rope needs an even head_dim, got {d}")
    if positions is None:
        positions = torch.arange(s, device=x.device)
    freqs = base ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                   device=x.device) / d)
    angles = positions.float()[:, None] * freqs[None, :]
    cos = torch.cos(angles)[None, :, None, :]    # (1, s, 1, d/2)
    sin = torch.sin(angles)[None, :, None, :]
    x1 = x[..., : d // 2].float()
    x2 = x[..., d // 2:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def mha_init(rng: np.random.Generator, dim: int, heads: int,
             kv_heads: int | None = None) -> dict:
    """Fused-QKV attention parameters: ``qkv`` (dim, dim + 2·kv_heads·
    head_dim) and ``out`` (dim, dim), uniform in ±sqrt(1/dim); no biases."""
    if dim % heads:
        raise ValueError(f"dim {dim} not divisible by heads {heads}")
    kv_heads = heads if kv_heads is None else kv_heads
    kv_groups(heads, kv_heads)
    kvd = (dim // heads) * kv_heads
    scale = math.sqrt(1.0 / dim)
    return {"qkv": rng.uniform(-scale, scale,
                               (dim, dim + 2 * kvd)).astype(np.float32),
            "out": rng.uniform(-scale, scale, (dim, dim)).astype(np.float32)}


def mha_apply(params: dict, x: torch.Tensor, heads: int, causal: bool = True,
              attn_fn=None, dtype=None, use_rope: bool = False
              ) -> torch.Tensor:
    """Multi-head self-attention over ``x`` (batch, seq, dim). The kv head
    count is read off the ``qkv`` weight's shape. q, k and v are views of
    the one fused product (not contiguous). The attention body returns
    fp32, which is cast to ``out``'s dtype before the output projection."""
    b, s, dim = x.shape
    hd = dim // heads
    w_qkv, w_out = params["qkv"], params["out"]
    kvd = (w_qkv.shape[-1] - dim) // 2
    kv_heads = kvd // hd
    if dtype is not None:
        x, w_qkv, w_out = x.to(dtype), w_qkv.to(dtype), w_out.to(dtype)
    qkv = x @ w_qkv
    q = qkv[..., :dim].reshape(b, s, heads, hd)
    k = qkv[..., dim:dim + kvd].reshape(b, s, kv_heads, hd)
    v = qkv[..., dim + kvd:].reshape(b, s, kv_heads, hd)
    if use_rope:
        # global positions: inside a sequence-split step this rank's
        # block starts at its offset
        from ..parallel.collectives import seq_offset

        off = seq_offset()
        pos = torch.arange(off, off + s, device=x.device) if off else None
        q, k = rope(q, pos), rope(k, pos)
    if attn_fn is None:
        o = dot_product_attention(q, k, v, causal=causal)
    else:
        o = attn_fn(q, k, v)
    o = o.reshape(b, s, dim).to(w_out.dtype)
    return o @ w_out
