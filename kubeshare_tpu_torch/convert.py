"""Converters between the JAX package's trees and the port's.

The port keeps the JAX package's parameter layout on purpose (conv ``w``
HWIO, dense ``w`` ``(in, out)``, NHWC flatten before ``fc1``), so a
parameter tree crosses unchanged in shape and order; what the converters
do is make every leaf a C-ordered numpy array of the expected dtype and
check the structure. Both directions return trees of numpy arrays: the
JAX side wraps them with ``jnp.asarray``, the port side with
``models.common.to_device``. Nothing here imports JAX.

The Adam state is the fused-Adam layout of both packages,
``{"count": f32 scalar, "mu": params-shaped, "nu": params-shaped}``.
"""

from __future__ import annotations

import numpy as np

from .utils.tree import tree_map

ADAM_KEYS = ("count", "mu", "nu")


def _to_numpy(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):              # a torch tensor, any device
        leaf = leaf.detach().cpu().numpy()
    arr = np.asarray(leaf, order="C")
    if not np.issubdtype(arr.dtype, np.floating):
        raise TypeError(f"parameter leaves are floating point, got "
                        f"{arr.dtype}")
    return arr.astype(np.float32, copy=False)


def params_from_jax(params) -> dict:
    """JAX parameter tree → the port's (numpy leaves, float32)."""
    return tree_map(_to_numpy, params)


def params_to_jax(params) -> dict:
    """The port's parameter tree (tensors or arrays) → numpy leaves in the
    JAX package's layout."""
    return tree_map(_to_numpy, params)


def _adam_state(state) -> dict:
    if not isinstance(state, dict) or set(state) != set(ADAM_KEYS):
        raise ValueError(f"fused-Adam state has keys {ADAM_KEYS}, got "
                         f"{sorted(state) if isinstance(state, dict) else state!r}")
    count = _to_numpy(state["count"]).reshape(())
    return {"count": count, "mu": tree_map(_to_numpy, state["mu"]),
            "nu": tree_map(_to_numpy, state["nu"])}


def adam_state_from_jax(state) -> dict:
    """JAX ``fused_adam()`` state → the port's (numpy leaves)."""
    return _adam_state(state)


def adam_state_to_jax(state) -> dict:
    """The port's fused-Adam state → the JAX package's (numpy leaves)."""
    return _adam_state(state)
