"""VGG-16-style workload: 5 conv stacks and a classifier on 32×32×3.

Counterpart of ``kubeshare_tpu/models/vgg.py`` at the same widths: stacks
of 3×3 convs ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3)), each
stack closed by a 2×2 max pool, then fc 512→512→10 over the NHWC
flatten, batch 64. bf16 activations with fp32 parameters; the loss is
fp32.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..ops import (conv2d_apply, conv2d_init, dense_apply, dense_init,
                   max_pool, softmax_cross_entropy)
from .common import main_cli, synthetic_image_batch

BATCH_SIZE = 64
CLASSES = 10
DTYPE = torch.bfloat16
# (channels, convs-per-stack) — the VGG-16 configuration
STACKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


def init(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    params: dict = {}
    in_ch = 3
    for s, (ch, n) in enumerate(STACKS):
        for c in range(n):
            params[f"s{s}c{c}"] = conv2d_init(rng, in_ch, ch)
            in_ch = ch
    params["fc1"] = dense_init(rng, STACKS[-1][0], 512)
    params["fc2"] = dense_init(rng, 512, CLASSES)
    return params


def apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    for s, (_, n) in enumerate(STACKS):
        for c in range(n):
            x = torch.relu(conv2d_apply(params[f"s{s}c{c}"], x, dtype=DTYPE))
        x = max_pool(x)
    x = x.reshape(x.shape[0], -1)
    x = torch.relu(dense_apply(params["fc1"], x, dtype=DTYPE))
    return dense_apply(params["fc2"], x, dtype=DTYPE)


def loss_fn(params: dict, batch) -> torch.Tensor:
    x, y = batch
    return softmax_cross_entropy(apply(params, x), y)


batch_fn = partial(synthetic_image_batch, batch_size=BATCH_SIZE, hw=32,
                   channels=3, classes=CLASSES)


if __name__ == "__main__":
    main_cli("vgg", init, loss_fn, batch_fn)
