"""Microsecond-step MLP — the burst-controller exercise model.

Counterpart of ``kubeshare_tpu/models/tinymlp.py``: a 32-wide two-layer
MLP on batch 8, whose steps are short enough that the proxy's burst sizing
(``_cap_repeat``) runs in its intended regime of hundreds of steps per
burst even on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import dense_apply, dense_init, softmax_cross_entropy
from .common import main_cli

BATCH_SIZE = 8
FEATURES = 32
CLASSES = 4


def init(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "fc1": dense_init(rng, FEATURES, FEATURES),
        "fc2": dense_init(rng, FEATURES, CLASSES),
    }


def apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    x = torch.relu(dense_apply(params["fc1"], x))
    return dense_apply(params["fc2"], x)


def loss_fn(params: dict, batch) -> torch.Tensor:
    x, y = batch
    return softmax_cross_entropy(apply(params, x), y)


def batch_fn(seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BATCH_SIZE, FEATURES)).astype(np.float32)
    y = rng.integers(0, CLASSES, (BATCH_SIZE,)).astype(np.int64)
    return x, y


if __name__ == "__main__":
    main_cli("tinymlp", init, loss_fn, batch_fn)
