"""Classification loss and accuracy — counterpart of
``kubeshare_tpu/ops/losses.py``. The loss runs in fp32 whatever the
activation dtype (bf16 logits are fine, a bf16 log-sum-exp is not)."""

from __future__ import annotations

import torch


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy; ``labels`` are integer class ids of any rank
    (``logits`` carry one trailing class axis more)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    return nll.mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Share of rows whose largest logit is at the label, as fp32."""
    return (logits.argmax(-1) == labels.long()).float().mean()
