"""Flash attention: hand-written CUDA kernels for its three passes, their
plain PyTorch versions, and the autograd wiring.

Counterpart of ``kubeshare_tpu/ops/flash_attention.py``. Its three Pallas
kernels become ``csrc/flash_attention.cu``: the forward (``_kernel``), dQ
(``_bwd_dq_kernel``) and dK/dV (``_bwd_dkv_kernel``); the note at the top
of that file says how the TPU grid translates, what bounds the kernels on
an H100 (bytes) and what the designs do about it. In bf16 from head dim
33 (the instances 64, 128 and 256) the passes are Hopper's own (wgmma,
TMA): the forward in ``csrc/flash_forward_wide.cuh``, dQ and dK/dV in
``csrc/flash_backward_wide.cuh``. Two
``torch.autograd.Function``s stand in for the ``custom_vjp``s ``_flash`` and
``_flash_lse``.

Each pass is a ``torch.library`` custom op of the port's namespace
(``kubeshare_tpu_torch::flash_fwd``, ``flash_dq``, ``flash_dkv``), whose
implementation the dispatcher picks by where its tensors lie: CPU tensors
take the plain version (``*_reference``), CUDA tensors launch the kernel
or raise. There is no fallback from one to the other. A fake
implementation of each gives shapes and dtypes only, so a fake-tensor
trace of a train step (``make_fx``, ``torch.export``) records the three
ops, forward and backward, and runs none. Each pass picks its kernel by
dtype: bf16 inputs (the transformer's main path) run on the tensor cores,
fp32 inputs on the CUDA cores; all are hand-written. The plain backward
recomputes P from the saved lse, as the kernels do.

Layout: (batch, seq, heads, head_dim), as the JAX package. q, k and v may
be strided views (the transformer slices them out of one fused product):
the kernels take each one's strides, with a dense head dim, and the
wrapper makes a tensor dense only when its head dim is not.

The kernels agree with their plain versions to a tolerance, not bit for
bit: ``expf``/``ex2.approx``/``logf`` on the card and torch's
``exp``/``log`` differ in the last bits, and the kernels sum in another order (keys in
tiles of 64, the head dim in order or in the tensor cores) than torch's
matrix products. The bf16 kernels take each fp32 operand of a product
(P, dS, dO) as two bf16 parts, bf16(x) and bf16(x − bf16(x)), so it keeps
~16 bits: O stays inside the fp32 tolerance, dQ, dK and dV inside one
bf16 ulp (``csrc`` says which products are split).

The bf16 backward on the instances 64, 128 and 256
(``csrc/flash_backward_wide.cuh``) has a prologue, a fourth op
(``flash_prep``) that replaces the plain torch D = rowsum(dO ∘ O) − g_lse:
in one pass over dO and O it writes D, dO's two bf16 parts and which
64-row q tiles have a nonzero lo part. ``flash_dq`` and ``flash_dkv`` take
the parts and flags as two optional trailing arguments, which their CUDA
implementations require there (a ValueError without them); the plain
versions read dO itself and ignore both.

Head dims: the JAX kernel takes any. The kernels are built for the
instance widths ``INSTANCES`` (8, 16, 32, 64, 128, 256), and a head dim d
runs on the narrowest instance D ≥ d (:func:`instance_head_dim`), with the
true d passed in: the kernels read columns past d as zero and never write
them, so nothing is padded or copied here. A head dim past 256 is
refused on the card (no public model has one).
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from ..utils.device import launch_on
from .attention import MASK_VALUE, kv_groups
from .fused_adam import OP_LIBRARY, OP_NAMESPACE

BLOCK_Q = 128
BLOCK_K = 128

#: the kernel library of each instance width the kernels are built for:
#: 32 at the transformer's full width, 8 in its small preset, 16 at
#: ``init(dim=128)``, 64 (GPT-2's) and 128 (Llama's, Mistral's) at
#: ``init(dim=512)`` and ``init(dim=1024)`` under its 8 heads, 256
#: (Gemma's) at ``init(dim=2048)``; a head dim between two runs on the
#: wider (80, Phi-2's, and 96, Phi-3-mini's, on 128). The mma.sync widths
#: (8, 16, 32), 64 and 128, and 256 are three libraries
#: (``csrc/flash_attention.cu``, ``flash_attention_wide.cu``,
#: ``flash_attention_256.cu``), so that they build in parallel
LIBRARY_OF_HEAD_DIM = {8: "flash_attention", 16: "flash_attention",
                       32: "flash_attention",
                       64: "flash_attention_wide",
                       128: "flash_attention_wide",
                       256: "flash_attention_256"}
INSTANCES = tuple(LIBRARY_OF_HEAD_DIM)
#: the widest head dim the kernels take
MAX_HEAD_DIM = INSTANCES[-1]
#: the instances whose bf16 backward reads dO through the prologue
WIDE_HEAD_DIMS = (64, 128, 256)
#: q rows a prologue flag covers (the kernels' tile)
PREP_TILE = 64

#: kernel vs plain version on the card, (atol, rtol) by output dtype. fp32
#: outputs (O, lse, fp32 grads) differ by summation order and expf/logf in
#: the last bits. A bf16 output rounds those fp32 values, and a difference
#: in the last bits may flip its rounding to the neighbouring bf16 value:
#: bf16 keeps 8 significant bits, so one ulp is at most 2^-7 of the value
#: (at the bottom of a binade), and rtol 2^-7 allows one such flip.
KERNEL_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-4, 2 ** -7)}

#: kernel launches by pass, the prologue's as "prep" (plain-version calls
#: on the CPU add nothing), and the same by (pass, instance width)
launches = {"fwd": 0, "dq": 0, "dkv": 0, "prep": 0}
instance_launches = {(name, inst): 0 for name in launches
                     for inst in INSTANCES}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for name in launches:
            launches[name] = 0
        for key in instance_launches:
            instance_launches[key] = 0


def _count_launch(name: str, inst: int) -> None:
    with _launch_lock:
        launches[name] += 1
        instance_launches[name, inst] += 1


def instance_head_dim(d: int) -> int:
    """The instance width a head dim ``d`` runs on: the narrowest of
    INSTANCES that is at least ``d``. Past MAX_HEAD_DIM a ValueError."""
    for inst in INSTANCES:
        if 1 <= d <= inst:
            return inst
    raise ValueError(f"the flash kernels take head dims 1 to {MAX_HEAD_DIM},"
                     f" got {d}")


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


def flash_prep_reference(dout, o, g_lse=None):
    """Plain prologue of the bf16 backward from head dim 33: ``(split,
    lo_live, dcap)``. ``split`` is dO's bf16 parts, hi = bf16(dO) and lo =
    bf16(dO − hi), as one (2, b, s_q, h, d) tensor; ``lo_live`` int32
    (b·h, ⌈s_q / 64⌉), 1 where a 64-row q tile's lo part holds a nonzero
    value; ``dcap`` D = rowsum(dO ∘ O) − g_lse, dense fp32 (b, h, s_q).
    ``g_lse`` is the lse output's cotangent, (b, s_q, h), or None."""
    dout = dout.float()
    hi = dout.to(torch.bfloat16)
    lo = (dout - hi.float()).to(torch.bfloat16)
    b, s_q, h, _ = dout.shape
    n_qt = -(-s_q // PREP_TILE)
    nz = (lo != 0).any(-1).transpose(1, 2).to(torch.int32)   # (b, h, s_q)
    nz = torch.nn.functional.pad(nz, (0, n_qt * PREP_TILE - s_q))
    lo_live = nz.reshape(b * h, n_qt, PREP_TILE).amax(-1)
    dcap = (dout * o).sum(-1)
    if g_lse is not None:
        dcap = dcap - g_lse.float()
    return (torch.stack((hi, lo)), lo_live.contiguous(),
            dcap.transpose(1, 2).contiguous())


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

_fns: dict = {}


def _kernel_fns(inst: int) -> dict:
    """The entry points, with their C signatures, of the library built
    for the instance width ``inst`` (once a library): the three passes,
    and the wgmma libraries' prologue."""
    name = LIBRARY_OF_HEAD_DIM[inst]
    fns = _fns.get(name)
    if fns is None:
        from .build import load

        lib = load(name)
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [ptr, i32] + [i32] * 8 + [f32, ptr]
        # dq and dkv end with dO's parts and flags (null off the wide bf16
        # route)
        for entry, n_ptrs, extra in (("kst_flash_fwd", 5, 0),
                                     ("kst_flash_dq", 7, 3),
                                     ("kst_flash_dkv", 8, 3)):
            fn = getattr(lib, entry)
            fn.restype = i32
            fn.argtypes = [ptr] * n_ptrs + tail + [ptr] * extra
        lib.kst_error_string.restype = ctypes.c_char_p
        lib.kst_error_string.argtypes = [i32]
        fns = _fns[name] = {"fwd": lib.kst_flash_fwd,
                            "dq": lib.kst_flash_dq,
                            "dkv": lib.kst_flash_dkv,
                            "error": lib.kst_error_string}
        if inst in WIDE_HEAD_DIMS:
            fn = fns["prep"] = lib.kst_flash_prep
            fn.restype = i32
            fn.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
    return fns


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
    instance_head_dim(q.shape[-1])
    if k.shape[-1] != q.shape[-1] or v.shape != k.shape:
        raise ValueError(f"k and v must be (b, s_kv, hk, {q.shape[-1]}), "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")


def _raise_on(fns, name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"flash_attention {name} kernel launch failed: "
                           f"{fns['error'](rc).decode()} ({rc})")


def _launch(name, pointers, tensors, q, k, causal, window, scale,
            split=()):
    """Launch one pass on q's device and current stream; ``tensors`` are
    q, k, v and (for the backward) dO, whose (b, s, h) strides the kernel
    takes; ``split`` the backward's pointers to dO's parts and flags."""
    b, s_q, h, d = q.shape
    inst = instance_head_dim(d)
    fns = _kernel_fns(inst)
    s_kv, hk = k.shape[1], k.shape[2]
    strides = [st for x in tensors for st in x.stride()[:3]]
    strides += [0] * (12 - len(strides))
    arr = (ctypes.c_longlong * 12)(*strides)
    rc = launch_on(q.device, lambda stream: fns[name](
        *pointers, arr, int(q.dtype == torch.bfloat16), b, h, hk, s_q, s_kv,
        d, int(causal), int(window or 0), scale, stream, *split))
    _raise_on(fns, name, rc)
    _count_launch(name, inst)


def _launch_prep(dout, o, g_lse, split, lo_live, dcap) -> None:
    """The prologue on dout's device and current stream; ``g_lse`` may be
    None."""
    b, s_q, h, d = dout.shape
    inst = instance_head_dim(d)
    fns = _kernel_fns(inst)
    arr = (ctypes.c_longlong * 3)(*dout.stride()[:3])
    ptr = lambda x: None if x is None else x.data_ptr()
    rc = launch_on(dout.device, lambda stream: fns["prep"](
        dout.data_ptr(), arr, ptr(o), ptr(g_lse), split[0].data_ptr(),
        split[1].data_ptr(), lo_live.data_ptr(), ptr(dcap), b, h, s_q, d,
        stream))
    _raise_on(fns, "prep", rc)
    _count_launch("prep", inst)


def _on_wgmma(d: int) -> bool:
    """Does head dim d run on a wgmma instance (64, 128, 256: d from 33
    to 256)? False past 256, where only the plain versions run."""
    return d <= MAX_HEAD_DIM and instance_head_dim(d) in WIDE_HEAD_DIMS


def _takes_split(q) -> bool:
    """Does q's backward read dO through the prologue (bf16 on the wgmma
    instances)?"""
    return q.dtype == torch.bfloat16 and _on_wgmma(q.shape[-1])


def _prep_outputs(dout):
    b, s_q, h, _ = dout.shape
    return (dout.new_empty((2, *dout.shape), dtype=torch.bfloat16),
            dout.new_empty((b * h, -(-s_q // PREP_TILE)), dtype=torch.int32),
            dout.new_empty((b, h, s_q), dtype=torch.float32))


_NO_SPLIT = (None, None, None)


def _split_pointers(q, dout, dout_split, lo_live):
    """The dO parts and flags a wide bf16 backward pass reads, as
    ``flash_prep`` left them, checked: ``(pointers, tensors to keep)``;
    empty elsewhere. The pass requires them there."""
    if not _takes_split(q):
        return _NO_SPLIT, ()
    shape = dout.shape
    if (dout_split is None or lo_live is None
            or dout_split.dtype != torch.bfloat16
            or lo_live.dtype != torch.int32
            or dout_split.shape[1:] != shape or dout_split.shape[0] != 2
            or lo_live.numel() != shape[0] * shape[2] * -(-shape[1]
                                                          // PREP_TILE)
            or not (dout_split.is_contiguous() and lo_live.is_contiguous())
            or dout_split.get_device() != q.get_device()
            or lo_live.get_device() != q.get_device()):
        raise ValueError("bf16 at head dims 33 to 256 the pass needs "
                         "dout_split, flash_prep's dense bf16 (2, "
                         f"{', '.join(map(str, shape))}) parts, and "
                         "lo_live, its int32 (b*h, ceil(s_q / 64)) flags, "
                         "on q's device")
    hi = dout_split.data_ptr()
    return ((hi, hi + dout_split.numel(), lo_live.data_ptr()),
            (dout_split, lo_live))


def _device_kind(q) -> str:
    kind = q.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    return kind


def _refuse_meta(*xs) -> None:
    """A fake implementation's guard: a fake tensor reports the device it
    stands for, so a real meta tensor here is an input nothing runs."""
    for x in xs:
        _device_kind(x)


def _flash_fwd_cuda(q, k, v, causal, window, scale):
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


def _backward_inputs(q, k, v, dout, lse, dcap):
    q, k, v = (_dense_head_dim(x) for x in (q, k, v))
    dout = _dense_head_dim(dout.float())
    return q, k, v, dout, lse.float().contiguous(), dcap.float().contiguous()


def _flash_dq_cuda(q, k, v, dout, lse, dcap, causal, window, scale,
                   dout_split=None, lo_live=None):
    _check_cuda(q, k, v)
    q, k, v, dout, lse, dcap = _backward_inputs(q, k, v, dout, lse, dcap)
    split, _keep = _split_pointers(q, dout, dout_split, lo_live)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dq.numel():
        _launch("dq", (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       dout.data_ptr(), lse.data_ptr(), dcap.data_ptr(),
                       dq.data_ptr()),
                (q, k, v, dout), q, k, causal, window, scale, split)
    return dq


def _flash_dkv_cuda(q, k, v, dout, lse, dcap, causal, window, scale,
                    dout_split=None, lo_live=None):
    _check_cuda(q, k, v)
    q, k, v, dout, lse, dcap = _backward_inputs(q, k, v, dout, lse, dcap)
    split, _keep = _split_pointers(q, dout, dout_split, lo_live)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if dk.numel():
        _launch("dkv", (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        dout.data_ptr(), lse.data_ptr(), dcap.data_ptr(),
                        dk.data_ptr(), dv.data_ptr()),
                (q, k, v, dout), q, k, causal, window, scale, split)
    return dk, dv


def _flash_prep_cuda(dout, o, g_lse):
    if not _on_wgmma(dout.shape[-1]):
        raise ValueError(f"the flash prologue takes the head dims of the "
                         f"instances {WIDE_HEAD_DIMS}, 33 to {MAX_HEAD_DIM}, "
                         f"got {dout.shape[-1]}")
    for name, x in (("o", o), ("g_lse", g_lse)):
        if x is not None and x.device != dout.device:
            raise ValueError(f"{name} is on {x.device}, dout on "
                             f"{dout.device}")
    if o.shape != dout.shape:
        raise ValueError(f"o must be {tuple(dout.shape)}, got "
                         f"{tuple(o.shape)}")
    if g_lse is not None and g_lse.shape != dout.shape[:3]:
        raise ValueError(f"g_lse must be {tuple(dout.shape[:3])}, got "
                         f"{tuple(g_lse.shape)}")
    dout = _dense_head_dim(dout.float())
    o = o.float().contiguous()
    if g_lse is not None:
        g_lse = g_lse.float().contiguous()
    split, lo_live, dcap = _prep_outputs(dout)
    if dout.numel():
        _launch_prep(dout, o, g_lse, split, lo_live, dcap)
    return split, lo_live, dcap


# --- the custom ops ------------------------------------------------------------


OP_LIBRARY.define("flash_fwd(Tensor q, Tensor k, Tensor v, bool causal, "
                  "SymInt? window, float scale) -> (Tensor, Tensor)")
OP_LIBRARY.define("flash_dq(Tensor q, Tensor k, Tensor v, Tensor dout, "
                  "Tensor lse, Tensor dcap, bool causal, SymInt? window, "
                  "float scale, Tensor? dout_split=None, "
                  "Tensor? lo_live=None) -> Tensor")
OP_LIBRARY.define("flash_dkv(Tensor q, Tensor k, Tensor v, Tensor dout, "
                  "Tensor lse, Tensor dcap, bool causal, SymInt? window, "
                  "float scale, Tensor? dout_split=None, "
                  "Tensor? lo_live=None) -> (Tensor, Tensor)")
OP_LIBRARY.define("flash_prep(Tensor dout, Tensor o, Tensor? g_lse) -> "
                  "(Tensor, Tensor, Tensor)")


def _flash_fwd_cpu(q, k, v, causal, window, scale):
    """Forward pass: ``(O fp32 (b, s_q, h, d), lse fp32 (b, h, s_q))``.
    On the card bf16 q/k/v launch the tensor-core kernel, fp32 the
    CUDA-core one (``csrc`` picks by the dtype flag ``_launch`` passes; so
    do the two backward passes). The CPU implementation returns its
    outputs dense, as the kernels and the fake implementation make
    them."""
    o, lse = flash_fwd_reference(q, k, v, causal, window, scale)
    return o.contiguous(), lse.contiguous()


def _flash_dq_cpu(q, k, v, dout, lse, dcap, causal, window, scale,
                  dout_split=None, lo_live=None):
    """dQ pass, in q's dtype (the plain version reads dO itself)."""
    return flash_dq_reference(q, k, v, dout, lse, dcap, causal, window,
                              scale).contiguous()


def _flash_dkv_cpu(q, k, v, dout, lse, dcap, causal, window, scale,
                   dout_split=None, lo_live=None):
    """dK/dV pass, kv-sized, in k's and v's dtypes."""
    dk, dv = flash_dkv_reference(q, k, v, dout, lse, dcap, causal, window,
                                 scale)
    return dk.contiguous(), dv.contiguous()


def _flash_prep_cpu(dout, o, g_lse):
    """The backward's prologue: dO's parts, their flags and D."""
    return flash_prep_reference(dout, o, g_lse)


def _flash_fwd_fake(q, k, v, causal, window, scale):
    _refuse_meta(q, k, v)
    b, s_q, h, _ = q.shape
    return (q.new_empty(q.shape, dtype=torch.float32),
            q.new_empty((b, h, s_q), dtype=torch.float32))


def _flash_dq_fake(q, k, v, dout, lse, dcap, causal, window, scale,
                   dout_split=None, lo_live=None):
    _refuse_meta(q, k, v, dout, lse, dcap)
    return q.new_empty(q.shape)


def _flash_dkv_fake(q, k, v, dout, lse, dcap, causal, window, scale,
                    dout_split=None, lo_live=None):
    _refuse_meta(q, k, v, dout, lse, dcap)
    return k.new_empty(k.shape), v.new_empty(v.shape)


def _flash_prep_fake(dout, o, g_lse):
    _refuse_meta(dout, o)
    return _prep_outputs(dout)


for _name, _cpu, _cuda, _fake in (
        ("flash_fwd", _flash_fwd_cpu, _flash_fwd_cuda, _flash_fwd_fake),
        ("flash_dq", _flash_dq_cpu, _flash_dq_cuda, _flash_dq_fake),
        ("flash_dkv", _flash_dkv_cpu, _flash_dkv_cuda, _flash_dkv_fake),
        ("flash_prep", _flash_prep_cpu, _flash_prep_cuda,
         _flash_prep_fake)):
    OP_LIBRARY.impl(_name, _cpu, "CPU")
    OP_LIBRARY.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"{OP_NAMESPACE}::{_name}", _fake,
                                lib=OP_LIBRARY)

flash_fwd = torch.ops.kubeshare_tpu_torch.flash_fwd.default
flash_dq = torch.ops.kubeshare_tpu_torch.flash_dq.default
flash_dkv = torch.ops.kubeshare_tpu_torch.flash_dkv.default
flash_prep = torch.ops.kubeshare_tpu_torch.flash_prep.default


def _check(q, k, v, causal, block_q, block_k, window):
    """The JAX entry's checks, in its order: blocks, then GQA heads.
    Returns the score scale."""
    _device_kind(q)
    _blocks(q.shape[1], k.shape[1], block_q, block_k, causal, window)
    kv_groups(q.shape[2], k.shape[2])
    return 1.0 / math.sqrt(q.shape[-1])


def _flash_bwd(ctx, g, g_lse):
    q, k, v, o, lse = ctx.saved_tensors
    causal, window, scale = ctx.cfg
    if _takes_split(q):
        # the prologue: D, dO's bf16 parts and their flags in one pass
        split, lo_live, dcap = flash_prep(g, o, g_lse)
        bwd = (q, k, v, g, lse, dcap, causal, window, scale, split, lo_live)
        return (flash_dq(*bwd), *flash_dkv(*bwd))
    # D_i = rowsum(dO ∘ O) in plain torch, as the JAX code leaves it to
    # XLA; an lse cotangent folds in as D − g_lse (dS = P ∘ (dP − D +
    # g_lse)). Made dense (b, h, s_q) once, so neither pass copies it.
    dcap = (g.float() * o).sum(-1)
    if g_lse is not None:
        dcap = dcap - g_lse.float()
    dcap = dcap.transpose(1, 2).contiguous()
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
