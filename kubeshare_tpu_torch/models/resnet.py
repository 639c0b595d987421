"""ResNet-18-style workload: basic residual blocks on 32×32×3 inputs.

Counterpart of ``kubeshare_tpu/models/resnet.py`` at the same widths: a
3×3 stem (64) with batchnorm, 4 stages (64, 128, 256, 512) of 2 blocks,
a global average pool and fc 512→10, batch 64. ``init(...,
blocks_per_stage=RESNET50_BLOCKS)`` (``init50``) gives the
ResNet-50-class depth (3, 4, 6, 3) with the same blocks. Each stage after
the first opens with a stride-2 block whose shortcut is a stride-2 1×1
projection. Convs run in bf16; each block casts to fp32 before its
batchnorms and adds the shortcut in fp32.
"""

from __future__ import annotations

import itertools
from functools import partial

import numpy as np
import torch

from ..ops import (batchnorm_apply, batchnorm_init, conv2d_apply,
                   conv2d_init, dense_apply, dense_init, softmax_cross_entropy)
from .common import main_cli, synthetic_image_batch

BATCH_SIZE = 64
CLASSES = 10
DTYPE = torch.bfloat16
STAGES = (64, 128, 256, 512)
BLOCKS_PER_STAGE = 2
RESNET50_BLOCKS = (3, 4, 6, 3)


def _block_init(rng: np.random.Generator, in_ch: int, out_ch: int) -> dict:
    params = {
        "conv1": conv2d_init(rng, in_ch, out_ch),
        "bn1": batchnorm_init(out_ch),
        "conv2": conv2d_init(rng, out_ch, out_ch),
        "bn2": batchnorm_init(out_ch),
    }
    if in_ch != out_ch:
        params["proj"] = conv2d_init(rng, in_ch, out_ch, kernel=1)
    return params


def _block_apply(params: dict, x: torch.Tensor, stride: int) -> torch.Tensor:
    y = conv2d_apply(params["conv1"], x, stride=stride, dtype=DTYPE)
    y = torch.relu(batchnorm_apply(params["bn1"], y.float()))
    y = conv2d_apply(params["conv2"], y, dtype=DTYPE)
    y = batchnorm_apply(params["bn2"], y.float())
    if "proj" in params:
        x = conv2d_apply(params["proj"], x, stride=stride, dtype=DTYPE)
    return torch.relu(y + x.to(y.dtype))


def init(seed: int = 0, *, blocks_per_stage: tuple | None = None) -> dict:
    """``blocks_per_stage`` defaults to the ResNet-18 class (2, 2, 2, 2);
    ``RESNET50_BLOCKS`` gives the ResNet-50-class depth."""
    bps = blocks_per_stage or (BLOCKS_PER_STAGE,) * len(STAGES)
    rng = np.random.default_rng(seed)
    params: dict = {"stem": conv2d_init(rng, 3, STAGES[0]),
                    "stem_bn": batchnorm_init(STAGES[0])}
    in_ch = STAGES[0]
    for s, ch in enumerate(STAGES):
        for b in range(bps[s]):
            params[f"s{s}b{b}"] = _block_init(rng, in_ch, ch)
            in_ch = ch
    params["fc"] = dense_init(rng, STAGES[-1], CLASSES)
    return params


def init50(seed: int = 0) -> dict:
    return init(seed, blocks_per_stage=RESNET50_BLOCKS)


def apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    x = conv2d_apply(params["stem"], x, dtype=DTYPE)
    x = torch.relu(batchnorm_apply(params["stem_bn"], x.float()))
    for s in range(len(STAGES)):
        for b in itertools.count():             # walk whatever depth exists
            if f"s{s}b{b}" not in params:
                break
            stride = 2 if (s > 0 and b == 0) else 1
            x = _block_apply(params[f"s{s}b{b}"], x, stride)
    x = x.mean(dim=(1, 2))                      # global average pool
    return dense_apply(params["fc"], x, dtype=DTYPE)


def loss_fn(params: dict, batch) -> torch.Tensor:
    x, y = batch
    return softmax_cross_entropy(apply(params, x), y)


batch_fn = partial(synthetic_image_batch, batch_size=BATCH_SIZE, hw=32,
                   channels=3, classes=CLASSES)


if __name__ == "__main__":
    main_cli("resnet", init, loss_fn, batch_fn)
