"""Fused Adam step: a hand-written CUDA kernel, its plain PyTorch version,
and the optimizer built on them.

Counterpart of ``kubeshare_tpu/ops/fused_adam.py``. The Pallas kernel
there (``_kernel``, launched by ``_fused_flat``) becomes
``csrc/fused_adam.cu``; the note at the top of that file says what bounds
the step on an H100 (bytes: 28 per parameter) and what the kernel does
about it.

The wrapper :func:`adam_update` picks by where the tensors lie: CPU
tensors take the plain version (:func:`adam_update_reference`), CUDA
tensors launch the kernel or raise. There is no fallback from one to the
other. Both update ``p``, ``m`` and ``v`` in place — the TPU kernel's
``input_output_aliases`` — so a step allocates nothing.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from ..utils.tree import tree_flatten, tree_map

#: kernel launches made by :func:`adam_update` (one per call on CUDA
#: tensors; plain-version calls on the CPU add nothing)
launches = 0
_launch_lock = threading.Lock()


def reset_launches() -> None:
    global launches
    with _launch_lock:
        launches = 0


def _count_launch() -> None:
    global launches
    with _launch_lock:
        launches += 1


def _adam_math(p, g, m, v, t, lr, b1, b2, eps):
    """One Adam step (bias-corrected, Kingma & Ba 2014) — the formula of
    the JAX package's ``_adam_math``, term for term; ``csrc/fused_adam.cu``
    (``adam_elem``) computes the same operations in the same order."""
    m_new = b1 * m + (1.0 - b1) * g
    v_new = b2 * v + (1.0 - b2) * (g * g)
    m_hat = m_new / (1.0 - b1 ** t)
    v_hat = v_new / (1.0 - b2 ** t)
    p_new = p - lr * m_hat / (torch.sqrt(v_hat) + eps)
    return p_new, m_new, v_new


def _step_tensor(step, like: torch.Tensor) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step
    return torch.tensor(float(step), dtype=torch.float32, device=like.device)


def adam_update_reference(p, g, m, v, step, lr=1e-3, b1=0.9, b2=0.999,
                          eps=1e-8):
    """Plain PyTorch Adam step, in place on ``p``, ``m``, ``v``; ``step``
    is the 1-based step count (a number or a one-element tensor)."""
    t = _step_tensor(step, p).reshape(()).to(p.dtype)
    p_new, m_new, v_new = _adam_math(p, g, m, v, t, lr, b1, b2, eps)
    p.copy_(p_new)
    m.copy_(m_new)
    v.copy_(v_new)
    return p, m, v


def _check_cuda_args(p, g, m, v, step):
    dev = p.device
    for name, x in (("p", p), ("g", g), ("m", m), ("v", v)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, p on {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.numel() != p.numel():
            raise ValueError(f"{name} has {x.numel()} elements, p "
                             f"{p.numel()}")
    if (step.device != dev or step.dtype != torch.float32
            or step.numel() != 1):
        raise ValueError("step must be one float32 on p's device, got "
                         f"{step.numel()} x {step.dtype} on {step.device}")
    for x in (p, m, v):
        if x.requires_grad:
            raise ValueError("in-place update of a tensor that requires grad")


_fn = None


def _kernel_fn():
    """The library's entry point with its C signature set (once)."""
    global _fn
    if _fn is None:
        from .build import load

        lib = load("fused_adam")
        fn = lib.kst_fused_adam
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                       + [ctypes.c_float] * 6 + [ctypes.c_void_p])
        lib.kst_error_string.restype = ctypes.c_char_p
        lib.kst_error_string.argtypes = [ctypes.c_int]
        _fn = (fn, lib.kst_error_string)
    return _fn


def _launch(p, g, m, v, step, lr, b1, b2, eps) -> None:
    fn, error_string = _kernel_fn()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = fn(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                step.data_ptr(), p.numel(), lr, b1, b2, 1.0 - b1, 1.0 - b2,
                eps, stream)
    if rc != 0:
        raise RuntimeError("fused_adam kernel launch failed: "
                           f"{error_string(rc).decode()} ({rc})")
    _count_launch()


def adam_update(p, g, m, v, step, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8):
    """Adam step over one tensor, in place on ``p``, ``m``, ``v``.

    CUDA tensors launch the kernel (``step`` should then be a one-element
    float32 tensor on the card, e.g. the optimizer's ``count``, so no host
    sync is needed); CPU tensors run the plain version. Any other device
    raises."""
    if p.device.type == "cpu":
        return adam_update_reference(p, g, m, v, step, lr, b1, b2, eps)
    if p.device.type != "cuda":
        raise ValueError(f"fused Adam runs on cuda or cpu, not {p.device}")
    step = _step_tensor(step, p)
    # g is only read: a strided gradient (e.g. of a permuted conv weight)
    # is copied to a dense one; p, m and v are written and must be dense
    g = g.contiguous()
    _check_cuda_args(p, g, m, v, step)
    if p.numel():
        _launch(p, g, m, v, step, float(lr), float(b1), float(b2),
                float(eps))
    return p, m, v


def adam_update_tree(params, grads, mu, nu, step, **hyper):
    """Tree version: one kernel launch per leaf, as on the TPU."""
    flat_p, treedef = tree_flatten(params)
    flat_g, g_def = tree_flatten(grads)
    flat_m, m_def = tree_flatten(mu)
    flat_v, v_def = tree_flatten(nu)
    if not treedef == g_def == m_def == v_def:
        raise ValueError("params, grads, mu and nu differ in structure")
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        adam_update(p, g, m, v, step, **hyper)
    return params, mu, nu


class Optimizer(NamedTuple):
    """``init(params) -> state``; ``update(grads, state, params) ->
    (params, state)``, updating params and state in place."""
    init: object
    update: object


def fused_adam(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8) -> Optimizer:
    """The kernel as an optimizer — counterpart of the JAX package's
    ``fused_adam()`` (an optax transformation there). The state has the
    same layout, ``{"count", "mu", "nu"}``, with ``count`` a float32
    scalar on the parameters' device so the kernel reads it there.

    Unlike optax's contract, ``update`` returns the new parameters, not
    the updates: the step is in place, so there is no ``p_new - p`` to
    form."""

    def init(params):
        leaves = tree_flatten(params)[0]
        device = leaves[0].device if leaves else torch.device("cpu")
        zeros = lambda t: tree_map(torch.zeros_like, t)
        return {"count": torch.zeros((), dtype=torch.float32, device=device),
                "mu": zeros(params), "nu": zeros(params)}

    def update(grads, state, params):
        count = state["count"]
        count.add_(1.0)
        adam_update_tree(params, grads, state["mu"], state["nu"], count,
                         lr=lr, b1=b1, b2=b2, eps=eps)
        return params, state

    return Optimizer(init, update)
