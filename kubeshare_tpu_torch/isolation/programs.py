"""Registered programs: what a client asks the proxy to run.

JAX clients ship StableHLO to the proxy (``jax.export``). PyTorch has no
counterpart that carries a training step with its backward pass and an
in-place custom kernel, so in the port a program travels as a named
**program spec**, a JSON object such as::

    {"program": "train_step", "model": "mnist",
     "optimizer": {"name": "fused_adam", "lr": 1e-3, "b1": 0.9,
                   "b2": 0.999, "eps": 1e-8}}

and the proxy resolves it against this package's own modules, at the
model module's own sizes. One optional field, ``"attention": "dense" |
"flash"``, picks the attention body of a model that has one (the
transformer; what a JAX client says by closing ``flash_attention`` into
its program); any other field is refused. A resolved
:class:`Program` is a loop program: ``program(carry, consts) -> (carry,
aux)`` over flat lists of tensors, the first ``ncarry`` of its arguments
threading from one step to the next. A tenant's own functions travel as
saved ``torch.export`` programs instead (:mod:`.exported`, the proxy-mode
attach), run once a call.

``train_step``'s carry is ``(params, opt_state)`` flattened in tree order
(dict keys sorted), its consts the model's batch (``(x, y)`` images and
labels, or ``(tokens, targets)``), its aux the loss.
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
SPEC_FIELDS = ("program", "model", "optimizer", "attention")
ATTENTION = ("dense", "flash")
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
        unknown = sorted(set(spec) - set(SPEC_FIELDS))
        if unknown:
            raise ValueError(f"unknown spec fields {unknown}; have "
                             f"{SPEC_FIELDS}")
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
        loss_fn = _loss_fn(model, spec.get("attention", "dense"))

        leaves, self._carry_def = tree_flatten(_carry(model.init(0)))
        want = [_meta(np.shape(a), "float32") for a in leaves]
        if ncarry != len(want) or self.in_meta[:ncarry] != want:
            raise ValueError(
                f"train_step carry for {spec['model']} must be (params, "
                f"fused_adam state): {len(want)} float32 leaves "
                f"{want}, got {self.in_meta[:ncarry]}")
        _check_consts(model, spec["model"], self.in_meta[ncarry:])
        self.out_meta = want + [((), "float32")]
        self.naux = 1
        self.out_nbytes = sum(
            int(np.prod(s, dtype=np.int64)) * np.dtype(d).itemsize
            for s, d in self.out_meta)
        self._step = make_train_step(loss_fn, fused_adam(**hyper))

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


def _loss_fn(model, attention: str):
    """The model's loss with the spec's attention body."""
    if attention not in ATTENTION:
        raise ValueError(f"attention must be one of {ATTENTION}, got "
                         f"{attention!r}")
    if attention == "dense":
        return model.loss_fn
    if not hasattr(model, "flash_loss_fn"):
        raise ValueError(f"{model.__name__} has no attention to make flash")
    return model.flash_loss_fn


def _check_consts(model, name: str, consts: list) -> None:
    """The consts are one batch of the model: as many arrays as its
    ``batch_fn`` makes, each of the same rank, trailing shape and kind
    (float32, or any int), all with one batch size."""
    like = [np.asarray(a) for a in model.batch_fn(0)]

    def fits(meta, a) -> bool:
        shape, dtype = meta
        kind = "f" if dtype == "float32" else (
            "i" if dtype.startswith("int") else None)
        return (len(shape) == a.ndim and shape[1:] == a.shape[1:]
                and kind == a.dtype.kind)

    if (len(consts) != len(like) or len({s[:1] for s, _ in consts}) != 1
            or not all(map(fits, consts, like))):
        want = [(f"(B, {', '.join(map(str, a.shape[1:]))})",
                 "float32" if a.dtype.kind == "f" else "int") for a in like]
        raise ValueError(f"train_step consts for {name} are its "
                         f"batch {want}; got {consts}")


def _carry(params: dict) -> tuple[dict, dict]:
    """``(params, fused_adam state at step 0)`` as numpy trees."""
    zeros = lambda t: tree_map(np.zeros_like, t)
    return params, {"count": np.zeros((), np.float32),
                    "mu": zeros(params), "nu": zeros(params)}
