"""Loss layers (port of ``paddle_tpu/nn/loss.py``), over the port's
registry ops; ``CTCLoss`` and ``RNNTLoss`` over ``F.ctc_loss`` and
``F.rnnt_loss`` (the ``warpctc`` and ``rnnt`` ops)."""
from __future__ import annotations

from paddle_tpu_torch import ops
from paddle_tpu_torch.nn.layer import Layer

__all__ = ["CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
           "BCEWithLogitsLoss", "SmoothL1Loss", "KLDivLoss", "HingeLoss",
           "MarginRankingLoss", "CosineEmbeddingLoss", "CTCLoss", "RNNTLoss"]


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return ops.cross_entropy(
            input, label, weight=self.weight, ignore_index=self.ignore_index,
            reduction=self.reduction, soft_label=self.soft_label,
            axis=self.axis, use_softmax=self.use_softmax,
            label_smoothing=self.label_smoothing)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return ops.mse_loss(input, label, reduction=self.reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return ops.l1_loss(input, label, reduction=self.reduction)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return ops.nll_loss(input, label, weight=self.weight,
                            ignore_index=self.ignore_index,
                            reduction=self.reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return ops.binary_cross_entropy(input, label, weight=self.weight,
                                        reduction=self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return ops.binary_cross_entropy_with_logits(
            logit, label, weight=self.weight, reduction=self.reduction,
            pos_weight=self.pos_weight)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):
        return ops.smooth_l1_loss(input, label, reduction=self.reduction,
                                  delta=self.delta)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return ops.kl_div(input, label, reduction=self.reduction)


class HingeLoss(Layer):
    def forward(self, input, label):
        return ops.hinge_loss(input, label)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, other, label):
        return ops.margin_ranking_loss(input, other, label,
                                       margin=self.margin,
                                       reduction=self.reduction)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input1, input2, label):
        return ops.cosine_embedding_loss(input1, input2, label,
                                         margin=self.margin,
                                         reduction=self.reduction)


class CTCLoss(Layer):
    """CTC loss with warp-ctc's semantics (unscaled logits)."""

    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, logits, labels, input_lengths, label_lengths,
                norm_by_times=False):
        from paddle_tpu_torch.nn import functional as F

        return F.ctc_loss(logits, labels, input_lengths, label_lengths,
                          blank=self.blank, reduction=self.reduction,
                          norm_by_times=norm_by_times)


class RNNTLoss(Layer):
    """RNN-T loss with warp-transducer's semantics, FastEmit included."""

    def __init__(self, blank=0, fastemit_lambda=0.001, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.fastemit_lambda = fastemit_lambda
        self.reduction = reduction

    def forward(self, input, label, input_lengths, label_lengths):
        from paddle_tpu_torch.nn import functional as F

        return F.rnnt_loss(input, label, input_lengths, label_lengths,
                           blank=self.blank,
                           fastemit_lambda=self.fastemit_lambda,
                           reduction=self.reduction)
