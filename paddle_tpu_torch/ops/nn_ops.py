"""Loss operators of the port (from ``paddle_tpu/ops/nn_ops.py``)."""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.op import op

__all__ = ["softmax_with_cross_entropy"]


@op
def softmax_with_cross_entropy(logits, label, ignore_index=-100):
    """Per-position loss over the last axis, the JAX op's semantics for
    hard labels: low-precision logits are taken to f32 first (the loss
    is f32); labels may carry a trailing 1; positions labelled
    ``ignore_index`` get loss 0. The loss keeps the class axis with size
    1. No reduction here: the caller takes the mean (over ALL positions,
    ignored ones included, in ``LlamaPretrainingCriterion``)."""
    if logits.is_floating_point() and logits.element_size() < 4:
        logits = logits.float()
    logp = torch.log_softmax(logits, dim=-1)
    if label.dim() == logits.dim():
        label = label.squeeze(-1)
    valid = (label != ignore_index).unsqueeze(-1)
    safe = torch.where(valid, label.unsqueeze(-1).long(), 0)
    return torch.where(valid, -logp.gather(-1, safe), 0.0)
