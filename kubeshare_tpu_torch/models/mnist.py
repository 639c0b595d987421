"""MNIST-scale workload — the north-star benchmark model.

Counterpart of ``kubeshare_tpu/models/mnist.py`` at the same widths: a
conv net on 28×28×1 NHWC inputs, conv 1→32→64, fc 3136→256→10, batch 128.
Activations run in bfloat16 with fp32 parameters; the loss is fp32.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..ops import (conv2d_apply, conv2d_init, dense_apply, dense_init,
                   max_pool, softmax_cross_entropy)
from .common import main_cli, synthetic_image_batch

BATCH_SIZE = 128
CLASSES = 10
DTYPE = torch.bfloat16


def init(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "conv1": conv2d_init(rng, 1, 32),
        "conv2": conv2d_init(rng, 32, 64),
        "fc1": dense_init(rng, 7 * 7 * 64, 256),
        "fc2": dense_init(rng, 256, CLASSES),
    }


def apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    x = torch.relu(conv2d_apply(params["conv1"], x, dtype=DTYPE))
    x = max_pool(x)
    x = torch.relu(conv2d_apply(params["conv2"], x, dtype=DTYPE))
    x = max_pool(x)
    # NHWC flatten, as the JAX model does: fc1's rows stay in its order
    x = x.reshape(x.shape[0], -1)
    x = torch.relu(dense_apply(params["fc1"], x, dtype=DTYPE))
    return dense_apply(params["fc2"], x, dtype=DTYPE)


def loss_fn(params: dict, batch) -> torch.Tensor:
    x, y = batch
    return softmax_cross_entropy(apply(params, x), y)


batch_fn = partial(synthetic_image_batch, batch_size=BATCH_SIZE, hw=28,
                   channels=1, classes=CLASSES)


if __name__ == "__main__":
    main_cli("mnist", init, loss_fn, batch_fn)
