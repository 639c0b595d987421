"""CIFAR-10 conv workload: a 3-stage conv net on 32×32×3 NHWC inputs.

Counterpart of ``kubeshare_tpu/models/cifar10.py`` at the same widths:
each stage is two 3×3 convs (stages 64/128/256), a batchnorm in fp32 and
a 2×2 max pool; then fc 4096→10 over the NHWC flatten, batch 128. Convs
and the classifier run in bfloat16 with fp32 parameters; the loss is
fp32.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..ops import (batchnorm_apply, batchnorm_init, conv2d_apply, conv2d_init,
                   dense_apply, dense_init, max_pool, softmax_cross_entropy)
from .common import main_cli, synthetic_image_batch

BATCH_SIZE = 128
CLASSES = 10
DTYPE = torch.bfloat16
STAGES = (64, 128, 256)


def init(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    params: dict = {}
    in_ch = 3
    for i, ch in enumerate(STAGES):
        params[f"conv{i}a"] = conv2d_init(rng, in_ch, ch)
        params[f"conv{i}b"] = conv2d_init(rng, ch, ch)
        params[f"bn{i}"] = batchnorm_init(ch)
        in_ch = ch
    params["fc"] = dense_init(rng, 4 * 4 * STAGES[-1], CLASSES)
    return params


def apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    for i in range(len(STAGES)):
        x = torch.relu(conv2d_apply(params[f"conv{i}a"], x, dtype=DTYPE))
        x = torch.relu(conv2d_apply(params[f"conv{i}b"], x, dtype=DTYPE))
        x = batchnorm_apply(params[f"bn{i}"], x.float())
        x = max_pool(x)
    # NHWC flatten, as the JAX model does: fc's rows stay in its order
    x = x.reshape(x.shape[0], -1)
    return dense_apply(params["fc"], x, dtype=DTYPE)


def loss_fn(params: dict, batch) -> torch.Tensor:
    x, y = batch
    return softmax_cross_entropy(apply(params, x), y)


batch_fn = partial(synthetic_image_batch, batch_size=BATCH_SIZE, hw=32,
                   channels=3, classes=CLASSES)


if __name__ == "__main__":
    main_cli("cifar10", init, loss_fn, batch_fn)
