"""Flash attention: three hand-written CUDA kernels, their plain PyTorch
versions, and the autograd wiring.

Counterpart of ``kubeshare_tpu/ops/flash_attention.py``. Its three Pallas
kernels become ``csrc/flash_attention.cu``: the forward (``_kernel``), dQ
(``_bwd_dq_kernel``) and dK/dV (``_bwd_dkv_kernel``); the note at the top
of that file says how the TPU grid translates, what bounds the kernels on
an H100 (bytes) and what the simple design does about it. Two
``torch.autograd.Function``s stand in for the ``custom_vjp``s ``_flash`` and
``_flash_lse``.

Each pass picks by where its tensors lie: CPU tensors take the plain
version (``*_reference``), CUDA tensors launch the kernel or raise. There
is no fallback from one to the other. The forward picks its kernel by
dtype: bf16 inputs (the transformer's main path) run on the tensor cores,
fp32 inputs on the CUDA cores; both are hand-written. The plain backward
recomputes P from the saved lse, as the kernels do.

Layout: (batch, seq, heads, head_dim), as the JAX package. q, k and v may
be strided views (the transformer slices them out of one fused product):
the kernels take each one's strides, with a dense head dim, and the
wrapper makes a tensor dense only when its head dim is not.

The kernels agree with their plain versions to a tolerance, not bit for
bit: ``expf``/``ex2.approx``/``logf`` on the card and torch's
``exp``/``log`` differ in the last bits, and the kernels sum in another order (keys in
tiles of 64, the head dim in order or in the tensor cores) than torch's
matrix products. The bf16 forward takes P.V as two bf16 products, of
bf16(P) and of the rest, so O keeps ~16 bits of P, inside the fp32
tolerance.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from ..utils.device import launch_on
from .attention import MASK_VALUE, kv_groups

BLOCK_Q = 128
BLOCK_K = 128

#: head dims the kernels are built for: 32 at the transformer's full
#: width, 8 in its small preset
HEAD_DIMS = (8, 32)

#: kernel vs plain version on the card, (atol, rtol) by output dtype. fp32
#: outputs (O, lse, fp32 grads) differ by summation order and expf/logf in
#: the last bits. A bf16 output rounds those fp32 values, and a difference
#: in the last bits may flip its rounding to the neighbouring bf16 value:
#: bf16 keeps 8 significant bits, so one ulp is at most 2^-7 of the value
#: (at the bottom of a binade), and rtol 2^-7 allows one such flip.
KERNEL_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-4, 2 ** -7)}

#: kernel launches by pass (plain-version calls on the CPU add nothing)
launches = {"fwd": 0, "dq": 0, "dkv": 0}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for name in launches:
            launches[name] = 0


def _count_launch(name: str) -> None:
    with _launch_lock:
        launches[name] += 1


def _blocks(s_q, s_kv, block_q, block_k, causal, window=None):
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True (the band is "
                             "defined looking back from each query)")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    if causal and s_q != s_kv:
        raise ValueError(f"causal needs equal q/kv lengths, got {s_q}/{s_kv}"
                         " (mask positions are same-origin)")
    bq = min(block_q, s_q)
    bk = min(block_k, s_kv)
    if s_q % bq or s_kv % bk:
        raise ValueError(f"seq q={s_q}/kv={s_kv} must be divisible by "
                         f"blocks {bq}/{bk}")
    return bq, bk


# --- plain versions ----------------------------------------------------------

def _masked_scores(q, k, causal, window, scale):
    """(b, h, s_q, s_kv) fp32 scores of the pre-scaled q against k (expanded
    to q's heads), with the same-origin band set to MASK_VALUE — the plain
    version of ``_score_tile``. Returns the scores, Qs and the expanded
    fp32 k."""
    group = kv_groups(q.shape[2], k.shape[2])
    qs = q.float() * scale
    kf = k.float().repeat_interleave(group, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", qs, kf)
    if causal:
        qpos = torch.arange(q.shape[1], device=q.device)[:, None]
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        mask = qpos >= kpos
        if window is not None:
            mask &= qpos - kpos < window
        sc = torch.where(mask, sc, torch.full_like(sc, MASK_VALUE))
    return sc, qs, kf


def flash_fwd_reference(q, k, v, causal=True, window=None, scale=None):
    """Plain forward: ``(O, lse)``, O fp32 (b, s_q, h, d), lse fp32
    (b, h, s_q). Same guards as the kernel: masked scores contribute 0,
    an empty row gives O = 0 and lse = m + log(1)."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    sc, _, _ = _masked_scores(q, k, causal, window, scale)
    live = sc > MASK_VALUE * 0.5
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(sc - m), torch.zeros_like(sc))
    l = p.sum(dim=-1, keepdim=True)
    den = torch.where(l > 0.0, l, torch.ones_like(l))
    vf = v.float().repeat_interleave(q.shape[2] // v.shape[2], dim=2)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf) / den.permute(0, 2, 1, 3)
    lse = (m + torch.log(den)).squeeze(-1)
    return o, lse


def _p_and_ds(q, k, v, dout, lse, dcap, causal, window, scale):
    """P = exp(S - L) recomputed from the saved lse, and dS = P ∘ (dO·Vᵀ −
    D), both (b, h, s_q, s_kv) fp32, plus Qs and the expanded fp32 k."""
    sc, qs, kf = _masked_scores(q, k, causal, window, scale)
    p = torch.exp(sc - lse[..., None])
    vf = v.float().repeat_interleave(q.shape[2] // v.shape[2], dim=2)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), vf)
    return p, p * (dp - dcap[..., None]), qs, kf


def flash_dq_reference(q, k, v, dout, lse, dcap, causal=True, window=None,
                       scale=None):
    """Plain dQ = scale · dS·K, in q's dtype. ``dout`` is (b, s_q, h, d);
    ``lse`` and ``dcap`` (D) are (b, h, s_q) fp32."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    _, ds, _, kf = _p_and_ds(q, k, v, dout, lse, dcap, causal, window, scale)
    return (scale * torch.einsum("bhqk,bkhd->bqhd", ds, kf)).to(q.dtype)


def flash_dkv_reference(q, k, v, dout, lse, dcap, causal=True, window=None,
                        scale=None):
    """Plain ``(dK, dV)``: dV = Pᵀ·dO and dK = dSᵀ·Qs, summed over each kv
    head's group of q heads, kv-sized, in k's and v's dtypes."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    p, ds, qs, _ = _p_and_ds(q, k, v, dout, lse, dcap, causal, window,
                             scale)
    b, s_kv, hk, d = k.shape
    group = q.shape[2] // hk
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
    dk = dk.reshape(b, s_kv, hk, group, d).sum(dim=3)
    dv = dv.reshape(b, s_kv, hk, group, d).sum(dim=3)
    return dk.to(k.dtype), dv.to(v.dtype)


# --- kernels -----------------------------------------------------------------

_fns = None


def _kernel_fns():
    """The library's three entry points with their C signatures (once)."""
    global _fns
    if _fns is None:
        from .build import load

        lib = load("flash_attention")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [ptr, i32] + [i32] * 8 + [f32, ptr]
        for name, n_ptrs in (("kst_flash_fwd", 5), ("kst_flash_dq", 7),
                             ("kst_flash_dkv", 8)):
            fn = getattr(lib, name)
            fn.restype = i32
            fn.argtypes = [ptr] * n_ptrs + tail
        lib.kst_error_string.restype = ctypes.c_char_p
        lib.kst_error_string.argtypes = [i32]
        _fns = {"fwd": lib.kst_flash_fwd, "dq": lib.kst_flash_dq,
                "dkv": lib.kst_flash_dkv, "error": lib.kst_error_string}
    return _fns


def _dense_head_dim(x: torch.Tensor) -> torch.Tensor:
    """The kernels read any (b, s, h) strides but a dense head dim."""
    return x if x.stride(-1) == 1 else x.contiguous()


def _check_cuda(q, k, v):
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise TypeError(f"q, k and v share one dtype, got {q.dtype} and "
                            f"{name} {x.dtype}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the flash kernels take bfloat16 or float32, got "
                        f"{q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"the flash kernels take head dims {HEAD_DIMS}, "
                         f"got {q.shape[-1]}")
    if k.shape[-1] != q.shape[-1] or v.shape != k.shape:
        raise ValueError(f"k and v must be (b, s_kv, hk, {q.shape[-1]}), "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")


def _launch(name, pointers, tensors, q, k, causal, window, scale):
    """Launch one pass on q's device and current stream; ``tensors`` are
    q, k, v and (for the backward) dO, whose (b, s, h) strides the kernel
    takes."""
    fns = _kernel_fns()
    b, s_q, h, d = q.shape
    s_kv, hk = k.shape[1], k.shape[2]
    strides = [st for x in tensors for st in x.stride()[:3]]
    strides += [0] * (12 - len(strides))
    arr = (ctypes.c_longlong * 12)(*strides)
    rc = launch_on(q.device, lambda stream: fns[name](
        *pointers, arr, int(q.dtype == torch.bfloat16), b, h, hk, s_q, s_kv,
        d, int(causal), int(window or 0), scale, stream))
    if rc != 0:
        raise RuntimeError(f"flash_attention {name} kernel launch failed: "
                           f"{fns['error'](rc).decode()} ({rc})")
    _count_launch(name)


def _device_kind(q) -> str:
    kind = q.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    return kind


def flash_fwd(q, k, v, causal, window, scale):
    """Forward pass: ``(O fp32 (b, s_q, h, d), lse fp32 (b, h, s_q))``.
    On the card bf16 q/k/v launch the tensor-core kernel, fp32 the
    CUDA-core one (``csrc`` picks by the dtype flag ``_launch`` passes)."""
    if _device_kind(q) == "cpu":
        return flash_fwd_reference(q, k, v, causal, window, scale)
    _check_cuda(q, k, v)
    q, k, v = (_dense_head_dim(x) for x in (q, k, v))
    b, s_q, h, d = q.shape
    o = torch.empty((b, s_q, h, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    if o.numel():
        _launch("fwd", (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), lse.data_ptr()),
                (q, k, v), q, k, causal, window, scale)
    return o, lse


def flash_dq(q, k, v, dout, lse, dcap, causal, window, scale):
    """dQ pass, in q's dtype."""
    if _device_kind(q) == "cpu":
        return flash_dq_reference(q, k, v, dout, lse, dcap, causal, window,
                                  scale)
    _check_cuda(q, k, v)
    q, k, v = (_dense_head_dim(x) for x in (q, k, v))
    dout = _dense_head_dim(dout.float())
    lse, dcap = lse.float().contiguous(), dcap.float().contiguous()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dq.numel():
        _launch("dq", (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       dout.data_ptr(), lse.data_ptr(), dcap.data_ptr(),
                       dq.data_ptr()),
                (q, k, v, dout), q, k, causal, window, scale)
    return dq


def flash_dkv(q, k, v, dout, lse, dcap, causal, window, scale):
    """dK/dV pass, kv-sized, in k's and v's dtypes."""
    if _device_kind(q) == "cpu":
        return flash_dkv_reference(q, k, v, dout, lse, dcap, causal, window,
                                   scale)
    _check_cuda(q, k, v)
    q, k, v = (_dense_head_dim(x) for x in (q, k, v))
    dout = _dense_head_dim(dout.float())
    lse, dcap = lse.float().contiguous(), dcap.float().contiguous()
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if dk.numel():
        _launch("dkv", (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        dout.data_ptr(), lse.data_ptr(), dcap.data_ptr(),
                        dk.data_ptr(), dv.data_ptr()),
                (q, k, v, dout), q, k, causal, window, scale)
    return dk, dv


def _check(q, k, v, causal, block_q, block_k, window):
    """The JAX entry's checks, in its order: blocks, then GQA heads.
    Returns the score scale."""
    _blocks(q.shape[1], k.shape[1], block_q, block_k, causal, window)
    kv_groups(q.shape[2], k.shape[2])
    return 1.0 / math.sqrt(q.shape[-1])


def _flash_bwd(ctx, g, g_lse):
    q, k, v, o, lse = ctx.saved_tensors
    causal, window, scale = ctx.cfg
    # D_i = rowsum(dO ∘ O) in plain torch, as the JAX code leaves it to
    # XLA; an lse cotangent folds in as D − g_lse (dS = P ∘ (dP − D + g_lse))
    dcap = (g.float() * o).sum(-1).transpose(1, 2)
    if g_lse is not None:
        dcap = dcap - g_lse.float().transpose(1, 2)
    dq = flash_dq(q, k, v, g, lse, dcap, causal, window, scale)
    dk, dv = flash_dkv(q, k, v, g, lse, dcap, causal, window, scale)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """``_flash``'s custom_vjp: O forward, (dQ, dK, dV) backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k, window):
        scale = _check(q, k, v, causal, block_q, block_k, window)
        o, lse = flash_fwd(q, k, v, causal, window, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (causal, window, scale)
        return o

    @staticmethod
    def backward(ctx, g):
        return (*_flash_bwd(ctx, g, None), None, None, None, None)


class _FlashLse(torch.autograd.Function):
    """``_flash_lse``'s custom_vjp: (O, lse (b, s, h)) forward; both
    cotangents go through the same two backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k, window):
        scale = _check(q, k, v, causal, block_q, block_k, window)
        o, lse = flash_fwd(q, k, v, causal, window, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (causal, window, scale)
        return o, lse.transpose(1, 2)

    @staticmethod
    def backward(ctx, g, g_lse):
        return (*_flash_bwd(ctx, g, g_lse), None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = BLOCK_Q,
                    block_k: int = BLOCK_K,
                    window: int | None = None) -> torch.Tensor:
    """Drop-in for :func:`~kubeshare_tpu_torch.ops.attention.
    dot_product_attention` (same (batch, seq, heads, head_dim) layout, fp32
    output), differentiable in q, k and v; the JAX entry's signature
    without its Pallas-only ``interpret``. ``kv_heads`` may divide
    ``heads`` (grouped-query); ``window`` (with ``causal``) is the
    sliding band ``(i - window, i]``. ``block_q``/``block_k`` are checked
    as the JAX kernel checks them; the CUDA kernels tile on their own."""
    return _Flash.apply(q, k, v, bool(causal), block_q, block_k, window)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, block_q: int = BLOCK_Q,
                        block_k: int = BLOCK_K, window: int | None = None):
    """:func:`flash_attention` that also returns the per-row logsumexp,
    ``lse[b, i, h] = log Σ_j exp(q_i·k_j·scale)`` (fp32, masked keys
    excluded), differentiable in both outputs."""
    return _FlashLse.apply(q, k, v, bool(causal), block_q, block_k, window)
