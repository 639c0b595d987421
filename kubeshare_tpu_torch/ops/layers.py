"""Layer primitives as plain functions over parameter dicts.

Counterpart of ``kubeshare_tpu/ops/layers.py`` for the layers mnist,
tinymlp and the transformer use: dense, conv2d, max-pool and layernorm.
The public layouts are the JAX package's, so a parameter tree crosses
between the two unchanged:

- activations are NHWC;
- conv ``w`` is HWIO ``(kh, kw, in, out)``, dense ``w`` is ``(in, out)``.

Inside, a conv runs on an NCHW *view* of the NHWC tensor (a permute, no
copy): that view has channels-last strides, which cuDNN takes as is.
``dtype`` casts inputs and parameters (bf16 activations with fp32
parameters), as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


# --- dense -------------------------------------------------------------------

def dense_init(rng: np.random.Generator, in_dim: int, out_dim: int) -> dict:
    scale = math.sqrt(1.0 / in_dim)
    return {"w": rng.uniform(-scale, scale, (in_dim, out_dim)).astype(np.float32),
            "b": rng.uniform(-scale, scale, (out_dim,)).astype(np.float32)}


def dense_apply(params: dict, x: torch.Tensor, dtype=None) -> torch.Tensor:
    w, b = params["w"], params["b"]
    if dtype is not None:
        x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
    return x @ w + b


# --- conv2d (NHWC activations, HWIO weights) ---------------------------------

def conv2d_init(rng: np.random.Generator, in_ch: int, out_ch: int,
                kernel: int = 3) -> dict:
    fan_in = in_ch * kernel * kernel
    scale = math.sqrt(2.0 / fan_in)  # He init
    w = rng.standard_normal((kernel, kernel, in_ch, out_ch)) * scale
    return {"w": w.astype(np.float32),
            "b": np.zeros((out_ch,), np.float32)}


def conv2d_apply(params: dict, x: torch.Tensor, stride: int = 1,
                 padding: str = "SAME", dtype=None) -> torch.Tensor:
    """``x`` NHWC → NHWC. ``padding`` is ``"SAME"`` or ``"VALID"``, with
    XLA's meaning (SAME pads the low side by the smaller half)."""
    w, b = params["w"], params["b"]
    if dtype is not None:
        x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
    kh, kw = w.shape[0], w.shape[1]
    xc = x.permute(0, 3, 1, 2)                     # NCHW view, channels-last
    if padding == "SAME":
        pads = []
        for size, k in ((x.shape[2], kw), (x.shape[1], kh)):  # W then H
            out = -(-size // stride)
            total = max((out - 1) * stride + k - size, 0)
            pads += [total // 2, total - total // 2]
        if any(pads):
            xc = F.pad(xc, pads)
    elif padding != "VALID":
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride)
    # bias added after the conv's own rounding, as `y + b` in JAX
    return y.permute(0, 2, 3, 1) + b


def max_pool(x: torch.Tensor, window: int = 2,
             stride: int | None = None) -> torch.Tensor:
    """NHWC max pool with VALID padding."""
    stride = stride or window
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1)


# --- layernorm ---------------------------------------------------------------

def layernorm_init(dim: int) -> dict:
    return {"scale": np.ones((dim,), np.float32),
            "bias": np.zeros((dim,), np.float32)}


def layernorm_apply(params: dict, x: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """Normalize the trailing axis in fp32 with the population variance,
    then cast back to the input dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(x.dtype)
