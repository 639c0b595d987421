"""Layer primitives as plain functions over parameter dicts.

Counterpart of ``kubeshare_tpu/ops/layers.py``: dense, conv2d, max- and
average-pool, layernorm, batchnorm and the LSTM. The public layouts are
the JAX package's, so a parameter tree crosses between the two
unchanged:

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
    if kh == kw == 1 and stride > 1:
        # a 1x1 conv at stride s reads every s-th pixel and pads nothing
        # (SAME or VALID): taking those pixels first gives the same sums.
        # oneDNN's CPU backward of a strided 1x1 conv over a channels-last
        # input corrupts the heap (fp32, 4 or more threads, batch 2)
        xc = xc[:, :, ::stride, ::stride]
        stride = 1
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


def avg_pool(x: torch.Tensor, window: int = 2,
             stride: int | None = None) -> torch.Tensor:
    """NHWC average pool with VALID padding: each window's sum divided by
    ``window²``."""
    stride = stride or window
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), window, stride)
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


# --- batchnorm (training-mode batch statistics) ------------------------------

def batchnorm_init(ch: int) -> dict:
    return {"scale": np.ones((ch,), np.float32),
            "bias": np.zeros((ch,), np.float32)}


def batchnorm_apply(params: dict, x: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """Normalize over every axis but the last with this batch's mean and
    population variance (``jnp.var``'s; no running statistics, as in the
    JAX package), in the dtype of ``x``.

    Inside a sharded step whose batch is split over mesh axes, the
    statistics are the GLOBAL batch's, as XLA computes them under the
    JAX package's data parallelism: fp32 sums over this rank's rows,
    summed over those axes (:func:`~kubeshare_tpu_torch.parallel.
    collectives.sum_over_axes`, differentiable)."""
    axes = tuple(range(x.ndim - 1))
    from ..parallel.collectives import current_view, sum_over_axes

    view = current_view()
    if view is None or not view.batch_axes:
        mean = x.mean(axes, keepdim=True)
        var = x.var(axes, keepdim=True, correction=0)
    else:
        count = x[..., 0].numel()
        for name in view.batch_axes:
            count *= view.mesh.size(view.mesh.mesh_dim_names.index(name))
        xf = x.float()
        mean = sum_over_axes(xf.sum(axes, keepdim=True), view.mesh,
                             view.batch_axes) / count
        var = sum_over_axes(((xf - mean) ** 2).sum(axes, keepdim=True),
                            view.mesh, view.batch_axes) / count
        mean, var = mean.to(x.dtype), var.to(x.dtype)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * params["scale"] + params["bias"]


# --- LSTM --------------------------------------------------------------------

def lstm_init(rng: np.random.Generator, in_dim: int, hidden: int) -> dict:
    scale = math.sqrt(1.0 / hidden)
    uniform = lambda shape: rng.uniform(-scale, scale, shape).astype(
        np.float32)
    return {"wi": uniform((in_dim, 4 * hidden)),
            "wh": uniform((hidden, 4 * hidden)),
            "b": uniform((4 * hidden,))}


def lstm_apply(params: dict, xs: torch.Tensor, dtype=None) -> torch.Tensor:
    """Run an LSTM over ``xs`` (batch, time, in_dim) → hidden states
    (batch, time, hidden), every operation in ``dtype`` when given.

    The JAX package's ``lax.scan`` becomes a loop over time with its cell:
    gates ``x_t @ wi + h @ wh + b``, split i, f, g, o. The input products
    ``x_t @ wi`` of every step are one matmul before the loop (each row
    rounds as it would alone), which takes ``time`` launches off the loop;
    the recurrence keeps one ``h @ wh`` a step."""
    wi, wh, b = params["wi"], params["wh"], params["b"]
    if dtype is not None:
        xs, wi, wh, b = (a.to(dtype) for a in (xs, wi, wh, b))
    hidden = wh.shape[0]
    h = xs.new_zeros((xs.shape[0], hidden))
    c = xs.new_zeros((xs.shape[0], hidden))
    xw = xs @ wi
    hs = []
    for t in range(xs.shape[1]):
        gates = xw[:, t] + h @ wh + b
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        g = torch.tanh(g)
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1)
