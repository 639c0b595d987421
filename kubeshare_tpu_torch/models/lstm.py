"""LSTM language-model workload: embedding → 2 LSTM layers → softmax
projection (untied: EMBED and HIDDEN differ).

Counterpart of ``kubeshare_tpu/models/lstm.py`` at the same widths:
batch 32, seq 64, vocab 8192, embed 256, hidden 512. The recurrence is
:func:`~kubeshare_tpu_torch.ops.layers.lstm_apply`, every operation in
bfloat16 with fp32 parameters; the loss is fp32.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..ops import (dense_apply, dense_init, lstm_apply, lstm_init,
                   softmax_cross_entropy)
from .common import main_cli, synthetic_token_batch

BATCH_SIZE = 32
SEQ_LEN = 64
VOCAB = 8192
EMBED = 256
HIDDEN = 512
DTYPE = torch.bfloat16


def init(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "embed": (rng.standard_normal((VOCAB, EMBED)) * 0.02).astype(
            np.float32),
        "lstm1": lstm_init(rng, EMBED, HIDDEN),
        "lstm2": lstm_init(rng, HIDDEN, HIDDEN),
        "out": dense_init(rng, HIDDEN, VOCAB),
    }


def apply(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens.long()].to(DTYPE)
    x = lstm_apply(params["lstm1"], x, dtype=DTYPE)
    x = lstm_apply(params["lstm2"], x, dtype=DTYPE)
    return dense_apply(params["out"], x, dtype=DTYPE)


def loss_fn(params: dict, batch) -> torch.Tensor:
    tokens, targets = batch
    return softmax_cross_entropy(apply(params, tokens), targets)


batch_fn = partial(synthetic_token_batch, batch_size=BATCH_SIZE,
                   seq_len=SEQ_LEN, vocab=VOCAB)


if __name__ == "__main__":
    main_cli("lstm", init, loss_fn, batch_fn)
