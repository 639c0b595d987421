"""Layers, attention, losses, the mixture-of-experts FFN and the
hand-written kernels of the port, exported as the JAX package's
``ops/__init__.py`` exports them, but for the ``flash_attention``
function: under that name the package keeps its kernel module, whose
launch counts, tolerances and plain versions the card's checks and the
tests read as ``ops.flash_attention``. The function is
``ops.flash_attention.flash_attention``."""

from .layers import (avg_pool, batchnorm_apply, batchnorm_init, conv2d_apply,
                     conv2d_init, dense_apply, dense_init, layernorm_apply,
                     layernorm_init, lstm_apply, lstm_init, max_pool)
from .attention import dot_product_attention, mha_apply, mha_init
from . import flash_attention
from .fused_adam import adam_update, adam_update_reference, adam_update_tree
from .losses import accuracy, softmax_cross_entropy

__all__ = [
    "accuracy",
    "adam_update",
    "adam_update_reference",
    "adam_update_tree",
    "avg_pool",
    "batchnorm_apply",
    "batchnorm_init",
    "conv2d_apply",
    "conv2d_init",
    "dense_apply",
    "dense_init",
    "dot_product_attention",
    "layernorm_apply",
    "layernorm_init",
    "lstm_apply",
    "lstm_init",
    "max_pool",
    "mha_apply",
    "mha_init",
    "softmax_cross_entropy",
]
