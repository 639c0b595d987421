"""Layers, attention, loss and the hand-written kernels of the port."""

from .layers import (conv2d_apply, conv2d_init, dense_apply, dense_init,
                     layernorm_apply, layernorm_init, max_pool)
from .losses import softmax_cross_entropy

__all__ = ["conv2d_apply", "conv2d_init", "dense_apply", "dense_init",
           "layernorm_apply", "layernorm_init", "max_pool",
           "softmax_cross_entropy"]
