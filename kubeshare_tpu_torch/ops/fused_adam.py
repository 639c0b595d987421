"""Fused Adam step: a hand-written CUDA kernel, its plain PyTorch version,
and the optimizer built on them.

Counterpart of ``kubeshare_tpu/ops/fused_adam.py``. The Pallas kernel
there (``_kernel``, launched by ``_fused_flat``) becomes
``csrc/fused_adam.cu``; the note at the top of that file says what bounds
the step on an H100 (bytes: 28 per parameter) and what the kernel does
about it. Where the TPU launches once per leaf, the kernel updates a
whole tree in one multi-tensor launch.

The step is one ``torch.library`` custom op,
``kubeshare_tpu_torch::fused_adam``, that mutates its p, m and v lists in
place — the TPU kernel's ``input_output_aliases`` — so a step allocates
nothing. The dispatcher picks its implementation by where the tensors
lie: CUDA tensors launch the kernel or raise, CPU tensors take the plain
version (:func:`adam_update_reference`, leaf by leaf). There is no
fallback from one to the other. A fake implementation gives the op to a
fake-tensor trace (``make_fx``, ``torch.export``) without running it, so
an exported train step carries the op and its in-place updates. The
wrappers :func:`adam_update` and :func:`adam_update_tree` call the op.
"""

from __future__ import annotations

import ctypes
import math
import threading
from collections import OrderedDict
from itertools import chain
from operator import attrgetter
from typing import NamedTuple

import torch

from ..utils.device import launch_on
from ..utils.tree import tree_flatten, tree_leaves, tree_map

#: leaves one kernel launch updates (the size of the by-value table in
#: csrc/fused_adam.cu, ``kTableLeaves``)
TABLE_LEAVES = 64

#: kernel launches (one per call of a CUDA tree of up to TABLE_LEAVES
#: leaves; plain-version calls on the CPU add nothing)
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


def _check_step(step, dev) -> None:
    if (step.device != dev or step.dtype != torch.float32
            or step.numel() != 1):
        raise ValueError("step must be one float32 on p's device, got "
                         f"{step.numel()} x {step.dtype} on {step.device}")


_numel, _ptr = torch.Tensor.numel, torch.Tensor.data_ptr
_dense = torch.Tensor.is_contiguous
_dtype, _device = attrgetter("dtype"), attrgetter("device")
_needs_grad = attrgetter("requires_grad")


def _refuse(name, xs, dev, sizes) -> None:
    """Raises for the first leaf of ``xs`` the kernel does not take."""
    for x, n in zip(xs, sizes):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, p on {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got "
                            f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.numel() != n:
            raise ValueError(f"{name} has {x.numel()} elements, p {n}")


def _table_rows(ps, gs, ms, vs) -> tuple[list[int], list[int]]:
    """Checks every leaf for the kernel (one device, float32, dense, equal
    sizes, p/m/v not requiring grad) and returns the kernel table's rows:
    the p, g, m, v pointers and the size of each non-empty leaf. Each
    check is one pass over a list, not one Python branch per tensor: the
    transformer's tree has 184 tensors a step."""
    dev = ps[0].device
    sizes = list(map(_numel, ps))
    for name, xs in (("p", ps), ("g", gs), ("m", ms), ("v", vs)):
        if (len(xs) != len(sizes) or set(map(_device, xs)) != {dev}
                or set(map(_dtype, xs)) != {torch.float32}
                or not all(map(_dense, xs))
                or list(map(_numel, xs)) != sizes):
            _refuse(name, xs, dev, sizes)
    if any(map(_needs_grad, chain(ps, ms, vs))):
        raise ValueError("in-place update of a tensor that requires grad")
    live = [i for i, n in enumerate(sizes) if n]
    pp, gp, mp, vp = (list(map(_ptr, xs)) for xs in (ps, gs, ms, vs))
    return ([x for i in live for x in (pp[i], gp[i], mp[i], vp[i])],
            [sizes[i] for i in live])


def tree_launches(tree) -> int:
    """Kernel launches one optimizer step over ``tree`` (tensors or arrays
    of its shapes) makes on the card: one per :data:`TABLE_LEAVES` leaves;
    leaves of no elements take none."""
    leaves = sum(1 for x in tree_leaves(tree) if math.prod(tuple(x.shape)))
    return -(-leaves // TABLE_LEAVES)


_fn = None


def _kernel_fn():
    """The library's entry point with its C signature set (once)."""
    global _fn
    if _fn is None:
        from .build import load

        lib = load("fused_adam")
        if lib.kst_fused_adam_table_leaves() != TABLE_LEAVES:
            raise RuntimeError("csrc/fused_adam.cu's table size is not "
                               f"TABLE_LEAVES = {TABLE_LEAVES}")
        fn = lib.kst_fused_adam_multi
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_float] * 6 + [ctypes.c_void_p])
        lib.kst_error_string.restype = ctypes.c_char_p
        lib.kst_error_string.argtypes = [ctypes.c_int]
        _fn = (fn, lib.kst_error_string)
    return _fn


#: ctypes tables by tree layout, the (data_ptr, numel) of every leaf's
#: p, g, m and v: built once per layout, after a full check of its leaves
_tables: OrderedDict = OrderedDict()
_tables_lock = threading.Lock()
_TABLES_KEPT = 16


def _ctypes_tables(ptrs: list[int], sizes: list[int]) -> list:
    """``(pointer array, size array, leaves)`` for each launch of one step,
    :data:`TABLE_LEAVES` leaves at a time."""
    tables = []
    for i in range(0, len(sizes), TABLE_LEAVES):
        rows = sizes[i:i + TABLE_LEAVES]
        row_ptrs = ptrs[4 * i:4 * (i + len(rows))]
        tables.append(((ctypes.c_void_p * len(row_ptrs))(*row_ptrs),
                       (ctypes.c_longlong * len(rows))(*rows), len(rows)))
    return tables


def _layout_tables(ps, gs, ms, vs) -> list:
    """The launch tables of one step over these leaves. A layout seen
    before (the same data_ptr and numel for every p, g, m and v) reuses
    its tables and, of its checks, repeats only what a tensor at the same
    address and size could change (dtype, requires_grad); a new layout is
    checked leaf by leaf (``_table_rows``) and its tables built. The
    same address implies the same device (one address space for the host
    and every card)."""
    xs = [*ps, *gs, *ms, *vs]
    key = (tuple(map(_ptr, xs)), tuple(map(_numel, xs)))
    with _tables_lock:
        tables = _tables.get(key)
        if tables is not None:
            _tables.move_to_end(key)
    if tables is not None and set(map(_dtype, xs)) == {torch.float32} \
            and not any(map(_needs_grad, chain(ps, ms, vs))):
        return tables
    ptrs, sizes = _table_rows(ps, gs, ms, vs)  # raises on what it refuses
    tables = _ctypes_tables(ptrs, sizes)
    with _tables_lock:
        _tables[key] = tables
        while len(_tables) > _TABLES_KEPT:
            _tables.popitem(last=False)
    return tables


def _multi_step(ps, gs, ms, vs, step, lr=1e-3, b1=0.9, b2=0.999,
                eps=1e-8) -> None:
    """One Adam step over CUDA leaves: one kernel launch per
    :data:`TABLE_LEAVES` non-empty leaves."""
    dev = ps[0].device
    step = _step_tensor(step, ps[0])
    _check_step(step, dev)
    # g is only read: a strided gradient (e.g. of a permuted conv weight)
    # is copied to a dense one; p, m and v are written and must be dense
    tables = _layout_tables(ps, [g.contiguous() for g in gs], ms, vs)
    fn, error_string = _kernel_fn()
    hyper = (float(lr), float(b1), float(b2), 1.0 - float(b1),
             1.0 - float(b2), float(eps))
    step_ptr = step.data_ptr()

    def launch(stream):
        for ptr_arr, size_arr, n in tables:
            rc = fn(ptr_arr, size_arr, n, step_ptr, *hyper, stream)
            if rc != 0:
                raise RuntimeError("fused_adam kernel launch failed: "
                                   f"{error_string(rc).decode()} ({rc})")
            _count_launch()

    launch_on(dev, launch)


def _device_kind(p) -> str:
    kind = p.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"fused Adam runs on cuda or cpu, not {p.device}")
    return kind


# --- the custom op -------------------------------------------------------------

#: the port's own custom-op namespace (the proxy runs no other custom op)
OP_NAMESPACE = "kubeshare_tpu_torch"

#: the port's ops, defined on a library fragment of their namespace, each
#: backend's implementation registered to its dispatch key. Not with
#: ``torch.library.custom_op``: its Python wrapper (autograd, in-place and
#: aliasing bookkeeping around every call) took the Adam op's host time
#: over the LM's 184 tensors from 0.11 to 0.36 ms a call on an H100 host
#: (``scripts/torch_dispatch_ab.py``)
OP_LIBRARY = torch.library.Library(OP_NAMESPACE, "FRAGMENT")
OP_LIBRARY.define(
    "fused_adam(Tensor(a0!)[] ps, Tensor[] gs, Tensor(a2!)[] ms, "
    "Tensor(a3!)[] vs, Tensor step, float lr, float b1, float b2, "
    "float eps) -> ()")


def _adam_op_cpu(ps, gs, ms, vs, step, lr, b1, b2, eps) -> None:
    """One Adam step over the leaves, in place on ``ps``, ``ms``, ``vs``.
    CPU: the plain version, leaf by leaf — the plain counterpart of the
    kernel's one launch, and the TPU's one launch per leaf."""
    for p, g, m, v in zip(ps, gs, ms, vs):
        adam_update_reference(p, g, m, v, step, lr, b1, b2, eps)
    torch.autograd.graph.increment_version([*ps, *ms, *vs])


def _adam_op_cuda(ps, gs, ms, vs, step, lr, b1, b2, eps) -> None:
    _multi_step(ps, gs, ms, vs, step, lr, b1, b2, eps)
    # the kernel writes through pointers: count the write, as an in-place
    # op does
    torch.autograd.graph.increment_version([*ps, *ms, *vs])


def _adam_op_fake(ps, gs, ms, vs, step, lr, b1, b2, eps) -> None:
    # a fake tensor reports the device it stands for; a real meta tensor
    # here means a tree that mixes meta leaves in, which nothing runs
    for x in (*ps, *gs, *ms, *vs, step):
        _device_kind(x)


OP_LIBRARY.impl("fused_adam", _adam_op_cpu, "CPU")
OP_LIBRARY.impl("fused_adam", _adam_op_cuda, "CUDA")
torch.library.register_fake(f"{OP_NAMESPACE}::fused_adam", _adam_op_fake,
                            lib=OP_LIBRARY)
_adam_op = torch.ops.kubeshare_tpu_torch.fused_adam.default


def adam_update(p, g, m, v, step, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8):
    """Adam step over one tensor, in place on ``p``, ``m``, ``v``.

    CUDA tensors launch the kernel with a one-leaf table (``step`` should
    then be a one-element float32 tensor on the card, e.g. the optimizer's
    ``count``, so no host sync is needed); CPU tensors run the plain
    version. Any other device raises."""
    _device_kind(p)
    _adam_op([p], [g], [m], [v], _step_tensor(step, p), float(lr),
             float(b1), float(b2), float(eps))
    return p, m, v


def adam_update_tree(params, grads, mu, nu, step, lr=1e-3, b1=0.9,
                     b2=0.999, eps=1e-8):
    """Tree version, in place: one call of the op. CUDA leaves: one kernel
    launch updates the whole tree (one per :data:`TABLE_LEAVES` leaves,
    :func:`tree_launches`); CPU leaves: the plain version, leaf by leaf."""
    flat_p, treedef = tree_flatten(params)
    flat_g, g_def = tree_flatten(grads)
    flat_m, m_def = tree_flatten(mu)
    flat_v, v_def = tree_flatten(nu)
    if not treedef == g_def == m_def == v_def:
        raise ValueError("params, grads, mu and nu differ in structure")
    if not flat_p:
        return params, mu, nu
    if _device_kind(flat_p[0]) == "cpu":
        for x in chain(flat_p, flat_g, flat_m, flat_v):
            if x.device.type != "cpu":
                raise ValueError(f"a tree on the cpu has a leaf on "
                                 f"{x.device}")
    _adam_op(flat_p, flat_g, flat_m, flat_v, _step_tensor(step, flat_p[0]),
             float(lr), float(b1), float(b2), float(eps))
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
