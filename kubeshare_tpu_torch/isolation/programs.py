"""Registered programs: what a client asks the proxy to run.

JAX clients ship StableHLO to the proxy (``jax.export``). PyTorch has no
counterpart that carries a training step with its backward pass and an
in-place custom kernel, so in the port a program travels as a named
**program spec**, a JSON object such as::

    {"program": "train_step", "model": "mnist",
     "optimizer": {"name": "fused_adam", "lr": 1e-3, "b1": 0.9,
                   "b2": 0.999, "eps": 1e-8}}

and the proxy resolves it against this package's own modules. A resolved
:class:`Program` is a loop program: ``program(carry, consts) -> (carry,
aux)`` over flat lists of tensors, the first ``ncarry`` of its arguments
threading from one step to the next. Arbitrary user programs (through
``torch.export`` or the attach path) are later work.

``train_step``'s carry is ``(params, opt_state)`` flattened in tree order
(dict keys sorted), its consts the batch ``(x, y)``, its aux the loss.
The optimizer updates the carry IN PLACE: the tensors a step returns are
the tensors it was given, which is why the proxy consumes (forgets) a
loop program's carry handles on every dispatch.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..models import get_model
from ..models.common import make_train_step
from ..ops.fused_adam import fused_adam
from ..utils.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

PROGRAMS = ("train_step",)
_ADAM_DEFAULTS = {"lr": 1e-3, "b1": 0.9, "b2": 0.999, "eps": 1e-8}

_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _TORCH_DTYPES[str(name)]
    except KeyError:
        raise TypeError(f"dtype {name!r} cannot cross the proxy") from None


def dtype_name(dtype: torch.dtype) -> str:
    return _DTYPE_NAMES[dtype]


def _meta(shape, dtype) -> tuple[tuple[int, ...], str]:
    return tuple(int(d) for d in shape), str(dtype)


class Program:
    """A resolved loop program. ``in_meta``/``out_meta`` are ``(shape,
    dtype name)`` per argument/output; ``out_nbytes`` is what one dispatch
    allocates in the proxy's accounting (every output, carry included,
    as the JAX proxy counts it)."""

    def __init__(self, spec: dict, in_meta: list, ncarry: int):
        if spec.get("program") not in PROGRAMS:
            raise ValueError(f"unknown program {spec.get('program')!r}; "
                             f"have {PROGRAMS}")
        self.spec = spec
        self.ncarry = ncarry
        self.in_meta = [_meta(s, d) for s, d in in_meta]
        model = get_model(str(spec.get("model")))
        opt = dict(spec.get("optimizer") or {"name": "fused_adam"})
        if opt.pop("name", None) != "fused_adam":
            raise ValueError("train_step supports optimizer fused_adam")
        unknown = set(opt) - set(_ADAM_DEFAULTS)
        if unknown:
            raise ValueError(f"unknown fused_adam options {sorted(unknown)}")
        hyper = {k: float(opt.get(k, v)) for k, v in _ADAM_DEFAULTS.items()}

        leaves, self._carry_def = tree_flatten(_carry(model.init(0)))
        want = [_meta(np.shape(a), "float32") for a in leaves]
        if ncarry != len(want) or self.in_meta[:ncarry] != want:
            raise ValueError(
                f"train_step carry for {spec['model']} must be (params, "
                f"fused_adam state): {len(want)} float32 leaves "
                f"{want}, got {self.in_meta[:ncarry]}")
        consts = self.in_meta[ncarry:]
        x_like = model.batch_fn(0)[0]
        if (len(consts) != 2 or consts[0][1] != "float32"
                or consts[0][0][1:] != x_like.shape[1:]
                or len(consts[1][0]) != 1
                or consts[1][0][0] != consts[0][0][0]
                or not consts[1][1].startswith("int")):
            raise ValueError(
                f"train_step consts are the batch (x, y): x float32 "
                f"(B, {', '.join(map(str, x_like.shape[1:]))}), y int (B,); "
                f"got {consts}")
        self.out_meta = want + [((), "float32")]
        self.naux = 1
        self.out_nbytes = sum(
            int(np.prod(s, dtype=np.int64)) * np.dtype(d).itemsize
            for s, d in self.out_meta)
        self._step = make_train_step(model.loss_fn, fused_adam(**hyper))

    @property
    def key(self) -> str:
        """Program identity: identical clients share one cost model."""
        return json.dumps([self.spec, self.ncarry, self.in_meta],
                          sort_keys=True)

    def __call__(self, carry: list, consts: list) -> tuple[list, list]:
        params, opt_state = tree_unflatten(self._carry_def, carry)
        params, opt_state, loss = self._step(params, opt_state, tuple(consts))
        return tree_leaves((params, opt_state)), [loss]


def resolve(spec: dict, in_meta: list, ncarry: int) -> Program:
    """Spec + argument metadata → a runnable :class:`Program`; raises
    ValueError on a spec or arguments the program cannot take."""
    if not isinstance(spec, dict):
        raise ValueError(f"a program spec is a JSON object, got {spec!r}")
    return Program(spec, in_meta, int(ncarry))


def initial_carry(spec: dict, seed: int = 0) -> tuple[dict, dict]:
    """Host-side ``(params, opt_state)`` for ``spec``'s model, made from
    ``seed``, as numpy trees ready for ``ProxyClient.put_tree``."""
    return _carry(get_model(str(spec["model"])).init(seed))


def _carry(params: dict) -> tuple[dict, dict]:
    """``(params, fused_adam state at step 0)`` as numpy trees."""
    zeros = lambda t: tree_map(np.zeros_like, t)
    return params, {"count": np.zeros((), np.float32),
                    "mu": zeros(params), "nu": zeros(params)}
