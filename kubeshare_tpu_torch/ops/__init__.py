"""Layers, loss and the fused-Adam kernel of the port."""

from .layers import (conv2d_apply, conv2d_init, dense_apply, dense_init,
                     max_pool)
from .losses import softmax_cross_entropy

__all__ = ["conv2d_apply", "conv2d_init", "dense_apply", "dense_init",
           "max_pool", "softmax_cross_entropy"]
