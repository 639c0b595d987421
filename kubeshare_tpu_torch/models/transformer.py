"""Decoder-only transformer LM — the long-context model family.

Counterpart of ``kubeshare_tpu/models/transformer.py`` at the same widths
and with the same env knobs: pre-norm residual blocks, bf16 matmuls with
fp32 parameters, layernorm and softmax in fp32. The attention body is
pluggable: ``attn_fn=None`` is dense attention, and the single-card
long-context path passes
:func:`~kubeshare_tpu_torch.ops.flash_attention.flash_attention`.

``init(..., n_experts=E)`` swaps every block's dense FFN for a top-1
routed mixture of ``E`` experts (:mod:`~kubeshare_tpu_torch.ops.moe`);
its Switch load-balancing loss, summed over the blocks, enters
``loss_fn`` at ``AUX_COEF``. The dense LM has no aux term to add. The
sequence-parallel loss hooks come with the port's meshes.
"""

from __future__ import annotations

import os
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import (dense_apply, dense_init, layernorm_apply, layernorm_init,
                   softmax_cross_entropy)
from ..ops.attention import dot_product_attention, mha_apply, mha_init
from ..ops.flash_attention import flash_attention
from ..ops.moe import moe_apply, moe_init
from .common import main_cli, synthetic_token_batch

BATCH_SIZE = 8
SEQ_LEN = 256
VOCAB = 4096
DIM = 256
HEADS = 8
LAYERS = 4
MLP_MULT = 4
DTYPE = torch.bfloat16

if os.environ.get("KUBESHARE_TPU_TRANSFORMER_PRESET", "") == "small":
    # CPU preset: same code paths at a size a test can afford
    BATCH_SIZE, SEQ_LEN, VOCAB, DIM, HEADS, LAYERS = 4, 32, 64, 32, 4, 2

# Attention knobs, read from the same variables as the JAX package
# (0/off = the classic full-causal multi-head block):
#   KV_HEADS < HEADS -> grouped-query / multi-query attention
#   ROPE             -> rotary positions on q/k, replacing the pos table
#   WINDOW > 0       -> sliding-window attention band
KV_HEADS = int(os.environ.get("KUBESHARE_TPU_TRANSFORMER_KV_HEADS", "0")) \
    or None
USE_ROPE = os.environ.get("KUBESHARE_TPU_TRANSFORMER_ROPE", "").lower() in \
    ("1", "true", "yes", "on")
WINDOW = int(os.environ.get("KUBESHARE_TPU_TRANSFORMER_WINDOW", "0")) \
    or None


def init(seed: int = 0, *, seq_len: int = SEQ_LEN, vocab: int = VOCAB,
         dim: int = DIM, layers: int = LAYERS, n_experts: int = 0) -> dict:
    """Parameters as numpy trees made from ``seed``, in the JAX layout.
    ``n_experts > 0`` gives every block ``"moe"`` in place of its dense
    ``"fc"`` and ``"proj"``."""
    rng = np.random.default_rng(seed)
    blocks = []
    for _ in range(layers):
        block = {
            "ln1": layernorm_init(dim),
            "attn": mha_init(rng, dim, HEADS, kv_heads=KV_HEADS),
            "ln2": layernorm_init(dim),
        }
        if n_experts:
            block["moe"] = moe_init(rng, dim, MLP_MULT * dim, n_experts)
        else:
            block["fc"] = dense_init(rng, dim, MLP_MULT * dim)
            block["proj"] = dense_init(rng, MLP_MULT * dim, dim)
        blocks.append(block)
    normal = lambda shape: (rng.standard_normal(shape) * 0.02).astype(
        np.float32)
    return {
        "embed": normal((vocab, dim)),
        "pos": normal((seq_len, dim)),
        "blocks": blocks,
        "ln_f": layernorm_init(dim),
        "out": dense_init(rng, dim, vocab),
    }


def _forward(params: dict, tokens: torch.Tensor, attn_fn=None):
    """Logits (batch, seq, vocab) fp32 and the experts' aux loss summed
    over the blocks, or None for the dense LM."""
    seq = tokens.shape[1]
    x = params["embed"][tokens.long()]
    if not USE_ROPE:
        # learned absolute positions, added in fp32; RoPE replaces them
        x = x + params["pos"][:seq]
    x = x.to(DTYPE)
    if attn_fn is None and WINDOW is not None:
        attn_fn = partial(dot_product_attention, causal=True, window=WINDOW)
    aux_total = None
    for blk in params["blocks"]:
        x = x + mha_apply(blk["attn"], layernorm_apply(blk["ln1"], x),
                          HEADS, causal=True, attn_fn=attn_fn,
                          use_rope=USE_ROPE, dtype=DTYPE).to(DTYPE)
        hin = layernorm_apply(blk["ln2"], x)
        if "moe" in blk:
            ffn, aux = moe_apply(blk["moe"], hin, dtype=DTYPE)
            aux_total = aux if aux_total is None else aux_total + aux
        else:
            # jax.nn.gelu's default is the tanh approximation
            h = F.gelu(dense_apply(blk["fc"], hin, dtype=DTYPE),
                       approximate="tanh")
            ffn = dense_apply(blk["proj"], h, dtype=DTYPE)
        x = x + ffn
    x = layernorm_apply(params["ln_f"], x)
    return dense_apply(params["out"], x, dtype=DTYPE).float(), aux_total


def apply(params: dict, tokens: torch.Tensor, attn_fn=None,
          return_aux: bool = False):
    """``tokens`` (batch, seq) int → logits (batch, seq, vocab) fp32, with
    ``return_aux`` ``(logits, aux)``: the experts' load-balancing loss
    summed over the blocks (an fp32 zero for the dense LM).
    ``attn_fn(q, k, v)`` replaces the dense causal attention."""
    logits, aux = _forward(params, tokens, attn_fn)
    if not return_aux:
        return logits
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    return logits, aux


AUX_COEF = 0.01  # Switch load-balance coefficient


def loss_fn(params: dict, batch, attn_fn=None) -> torch.Tensor:
    """Cross entropy plus ``AUX_COEF`` times the experts' aux loss. The
    dense LM's aux is exactly zero, so its loss is the cross entropy
    alone, with no operation added for the zero."""
    tokens, targets = batch
    logits, aux = _forward(params, tokens, attn_fn)
    loss = softmax_cross_entropy(logits, targets)
    return loss if aux is None else loss + AUX_COEF * aux


def flash_loss_fn(params: dict, batch) -> torch.Tensor:
    """``loss_fn`` with the flash kernels as the attention body (and the
    band of the window knob, as the dense path has it), experts or not."""
    return loss_fn(params, batch, attn_fn=partial(
        flash_attention, causal=True, window=WINDOW))


batch_fn = partial(synthetic_token_batch, batch_size=BATCH_SIZE,
                   seq_len=SEQ_LEN, vocab=VOCAB)


if __name__ == "__main__":
    main_cli("transformer", init, loss_fn, batch_fn)
