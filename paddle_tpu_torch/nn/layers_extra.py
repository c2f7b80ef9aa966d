"""nn long-tail layer classes (port of ``paddle_tpu/nn/layers_extra.py``):
pooling and unpooling, shuffles, pads, transposed convolutions, the
remaining losses, ``BiRNN``, and seq2seq decoding (``BeamSearchDecoder``
with ``dynamic_decode``).

Each layer wraps the matching registry op (``ops/nn_extras.py``). The
beam search keeps its per-beam state on the device; ``dynamic_decode``
reads the finished flags on the host once a step and backtracks the
parents there, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch import ops as _ops
from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.ops.registry import API as _API

__all__ = [
    "AdaptiveAvgPool1D", "AdaptiveAvgPool3D", "AdaptiveMaxPool1D",
    "AdaptiveMaxPool3D", "AvgPool3D", "MaxPool3D", "MaxUnPool1D",
    "MaxUnPool2D", "MaxUnPool3D", "FractionalMaxPool2D",
    "FractionalMaxPool3D", "ChannelShuffle", "PixelUnshuffle",
    "ZeroPad2D", "Unflatten", "Fold", "Softmax2D", "RReLU",
    "Conv1DTranspose", "Conv3DTranspose", "GaussianNLLLoss",
    "HingeEmbeddingLoss", "HSigmoidLoss", "MultiLabelSoftMarginLoss",
    "MultiMarginLoss", "PoissonNLLLoss", "SoftMarginLoss",
    "TripletMarginLoss", "TripletMarginWithDistanceLoss", "BiRNN",
    "RNNCellBase", "BeamSearchDecoder", "dynamic_decode",
]


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------
class _Pool(Layer):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCDHW", **kw):
        super().__init__()
        self._k, self._s, self._p = kernel_size, stride, padding
        self._ceil, self._df = ceil_mode, data_format
        self._kw = kw

    def forward(self, x):
        return _API[self._fn](x, self._k, stride=self._s,
                              padding=self._p, ceil_mode=self._ceil,
                              data_format=self._df, **self._kw)


class MaxPool3D(_Pool):
    _fn = "max_pool3d"


class AvgPool3D(_Pool):
    _fn = "avg_pool3d"


class _AdaptivePool(Layer):
    _fn = None

    def __init__(self, output_size, **kw):
        super().__init__()
        self._o = output_size

    def forward(self, x):
        return _API[self._fn](x, self._o)


class AdaptiveAvgPool1D(_AdaptivePool):
    _fn = "adaptive_avg_pool1d"


class AdaptiveMaxPool1D(_AdaptivePool):
    _fn = "adaptive_max_pool1d"


class AdaptiveAvgPool3D(_AdaptivePool):
    _fn = "adaptive_avg_pool3d"


class AdaptiveMaxPool3D(_AdaptivePool):
    _fn = "adaptive_max_pool3d"


class FractionalMaxPool2D(Layer):
    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__()
        self._o, self._u = output_size, random_u

    def forward(self, x):
        return _API["fractional_max_pool2d"](x, self._o,
                                             random_u=self._u)


class FractionalMaxPool3D(Layer):
    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__()
        self._o, self._u = output_size, random_u

    def forward(self, x):
        return _API["fractional_max_pool3d"](x, self._o,
                                             random_u=self._u)


class _Unpool(Layer):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format=None, output_size=None, name=None):
        super().__init__()
        self._k, self._s, self._p = kernel_size, stride, padding
        self._os = output_size

    def forward(self, x, indices):
        return _API[self._fn](x, indices, self._k, stride=self._s,
                              padding=self._p, output_size=self._os)


class MaxUnPool1D(_Unpool):
    _fn = "max_unpool1d"


class MaxUnPool2D(_Unpool):
    _fn = "max_unpool2d"


class MaxUnPool3D(_Unpool):
    _fn = "max_unpool3d"


# ---------------------------------------------------------------------------
# shuffles / pads / shapes / activations
# ---------------------------------------------------------------------------
class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self._g = groups

    def forward(self, x):
        return _API["channel_shuffle"](x, self._g)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self._r = downscale_factor

    def forward(self, x):
        return _API["pixel_unshuffle"](x, self._r)


class ZeroPad2D(Layer):
    """Reference layer/common.py ZeroPad2D: padding [l, r, t, b]."""

    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__()
        p = padding if isinstance(padding, (list, tuple)) \
            else [padding] * 4
        self._p = [int(v) for v in p]

    def forward(self, x):
        out = torch.nn.functional.pad(x._data, self._p)
        return Tensor._from_data(out, stop_gradient=not out.requires_grad)


class Unflatten(Layer):
    def __init__(self, axis, shape, name=None):
        super().__init__()
        self._axis, self._shape = axis, shape

    def forward(self, x):
        return _API["unflatten"](x, self._axis, self._shape)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1,
                 paddings=0, dilations=1, name=None):
        super().__init__()
        self._args = (output_sizes, kernel_sizes, strides, paddings,
                      dilations)

    def forward(self, x):
        return _API["fold"](x, *self._args)


class Softmax2D(Layer):
    """Softmax over the channel dim of NCHW inputs (reference
    layer/activation.py Softmax2D)."""

    def forward(self, x):
        return _API["softmax"](x, axis=-3)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None):
        super().__init__()
        self._lo, self._hi = lower, upper

    def forward(self, x):
        return _API["rrelu"](x, self._lo, self._hi,
                             training=self.training)


# ---------------------------------------------------------------------------
# conv transposes
# ---------------------------------------------------------------------------
class _ConvTranspose(Layer):
    _fn = None
    _nd = 1

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format=None):
        super().__init__()
        import math

        from paddle_tpu_torch.nn import initializer as init

        nd = self._nd
        k = kernel_size if isinstance(kernel_size, (list, tuple)) \
            else (kernel_size,) * nd
        k = tuple(int(v) for v in k)
        fan = in_channels * math.prod(k)
        bound = 1.0 / max(fan, 1) ** 0.5
        u = init.Uniform(-bound, bound)
        # paddle transpose-conv weight layout: [C_in, C_out/groups, *K]
        self.weight = self.create_parameter(
            [in_channels, out_channels // groups, *k], attr=weight_attr,
            default_initializer=u)
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter(
                [out_channels], attr=bias_attr, is_bias=True)
        self._cfg = (stride, padding, output_padding, dilation, groups)

    def forward(self, x):
        s, p, op_, d, g = self._cfg
        return _API[self._fn](x, self.weight, self.bias, stride=s,
                              padding=p, output_padding=op_,
                              dilation=d, groups=g)


class Conv1DTranspose(_ConvTranspose):
    _fn = "conv1d_transpose"
    _nd = 1


class Conv3DTranspose(_ConvTranspose):
    _fn = "conv3d_transpose"
    _nd = 3


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
class _Loss(Layer):
    _fn = None

    def __init__(self, reduction="mean", **kw):
        super().__init__()
        self.reduction = reduction
        self._kw = kw

    def forward(self, *args):
        return _API[self._fn](*args, reduction=self.reduction,
                              **self._kw)


class GaussianNLLLoss(_Loss):
    _fn = "gaussian_nll_loss"

    def __init__(self, full=False, epsilon=1e-6, reduction="mean",
                 name=None):
        super().__init__(reduction=reduction, full=full,
                         epsilon=epsilon)


class HingeEmbeddingLoss(_Loss):
    _fn = "hinge_embedding_loss"

    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__(reduction=reduction, margin=margin)


class MultiLabelSoftMarginLoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self._w, self.reduction = weight, reduction

    def forward(self, input, label):
        return _API["multi_label_soft_margin_loss"](
            input, label, self._w, reduction=self.reduction)


class MultiMarginLoss(Layer):
    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean",
                 name=None):
        super().__init__()
        self._p, self._m, self._w = p, margin, weight
        self.reduction = reduction

    def forward(self, input, label):
        return _API["multi_margin_loss"](input, label, weight=self._w,
                                         p=self._p, margin=self._m,
                                         reduction=self.reduction)


class PoissonNLLLoss(_Loss):
    _fn = "poisson_nll_loss"

    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean", name=None):
        super().__init__(reduction=reduction, log_input=log_input,
                         full=full, epsilon=epsilon)


class SoftMarginLoss(_Loss):
    _fn = "soft_margin_loss"

    def __init__(self, reduction="mean", name=None):
        super().__init__(reduction=reduction)


class TripletMarginLoss(_Loss):
    _fn = "triplet_margin_loss"

    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__(reduction=reduction, margin=margin, p=p,
                         epsilon=epsilon, swap=swap)


class TripletMarginWithDistanceLoss(Layer):
    """Reference layer/loss.py — triplet loss with a user distance fn."""

    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self._dist = distance_function
        self._margin, self._swap = margin, swap
        self.reduction = reduction

    def forward(self, input, positive, negative):
        if self._dist is None:
            return _API["triplet_margin_loss"](
                input, positive, negative, margin=self._margin,
                swap=self._swap, reduction=self.reduction)
        dp = self._dist(input, positive)
        dn = self._dist(input, negative)
        if self._swap:
            dpn = self._dist(positive, negative)
            dn = _ops.minimum(dn, dpn)
        loss = _ops.clip(dp - dn + self._margin, min=0.0)
        if self.reduction == "mean":
            return loss.mean()
        if self.reduction == "sum":
            return loss.sum()
        return loss


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid (reference layer/loss.py HSigmoidLoss)."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        self._num_classes = num_classes
        n_nodes = num_classes - 1 if not is_custom else num_classes
        self.weight = self.create_parameter(
            [max(n_nodes, 1), feature_size], attr=weight_attr)
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter([max(n_nodes, 1), 1],
                                              attr=bias_attr,
                                              is_bias=True)

    def forward(self, input, label, path_table=None, path_code=None):
        return _API["hsigmoid_loss"](input, label, self._num_classes,
                                     self.weight, self.bias,
                                     path_table, path_code)


# ---------------------------------------------------------------------------
# RNN: base cell, bidirectional wrapper, seq2seq decoding
# ---------------------------------------------------------------------------
class RNNCellBase(Layer):
    """Base for user-defined cells (reference layer/rnn.py RNNCellBase):
    subclasses implement forward(inputs, states) -> (outputs, states)."""

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        b = batch_ref.shape[batch_dim_idx]
        h = shape[-1] if shape is not None else self.hidden_size
        return _ops.full([b, h], init_value)


class BiRNN(Layer):
    """Bidirectional cell wrapper (reference layer/rnn.py BiRNN)."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        from paddle_tpu_torch.nn.rnn import RNN

        self.cell_fw = cell_fw
        self.cell_bw = cell_bw
        self._fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self._bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None):
        sf, sb = (initial_states if initial_states is not None
                  else (None, None))
        of, fw_state = self._fw(inputs, sf)
        ob, bw_state = self._bw(inputs, sb)
        return _ops.concat([of, ob], axis=-1), (fw_state, bw_state)


class BeamSearchDecoder(Layer):
    """Beam-search step decoder over a cell (reference layer/rnn.py
    BeamSearchDecoder; the step contract of dynamic_decode).

    MVP of the reference surface: embedding_fn maps token ids to cell
    inputs; output_fn maps cell outputs to vocab logits. States are kept
    per beam as [batch*beam, ...]."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        super().__init__()
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def initialize(self, batch_size, initial_state=None):
        k = self.beam_size
        tokens = _ops.full([batch_size * k], self.start_token,
                           dtype="int64")
        dev = tokens._data.device
        # beam 0 live, the others -1e9, so step 1 expands one beam a batch
        lp = torch.tensor([0.0] + [-1e9] * (k - 1), dtype=torch.float32,
                          device=dev).repeat(batch_size)
        log_probs = Tensor._from_data(lp)
        finished = Tensor._from_data(
            torch.zeros((batch_size * k,), dtype=torch.bool, device=dev))
        return tokens, initial_state, log_probs, finished

    def step(self, tokens, state, log_probs, finished):
        k = self.beam_size
        inp = self.embedding_fn(tokens) if self.embedding_fn else tokens
        out, new_state = self.cell(inp, state)
        logits = self.output_fn(out) if self.output_fn else out
        ld = logits._data.detach()
        v = ld.shape[-1]
        step_lp = torch.log_softmax(ld.float(), -1)
        # a finished beam extends only with end_token, at no cost
        mask = torch.full((v,), -1e9, device=ld.device)
        mask[self.end_token] = 0.0
        slp = torch.where(finished._data[:, None], mask[None, :], step_lp)
        total = log_probs._data[:, None] + slp        # [b*k, v]
        b = total.shape[0] // k
        top_lp, top_idx = torch.topk(total.reshape(b, k * v), k)
        beam_src = top_idx // v                        # [b, k]
        new_tok = top_idx % v
        gather = (torch.arange(b, device=ld.device)[:, None] * k
                  + beam_src).reshape(-1)

        def regather(t):
            if t is None:
                return None
            if isinstance(t, (tuple, list)):
                return type(t)(regather(s) for s in t)
            d = t._data if isinstance(t, Tensor) else t
            return Tensor._from_data(d[gather])

        new_state = regather(new_state)
        new_fin = Tensor._from_data(
            finished._data[gather]
            | (new_tok.reshape(-1) == self.end_token))
        # parents: the beam slot each new beam descends from (the
        # backtracking of dynamic_decode reads them)
        return (Tensor._from_data(new_tok.reshape(-1)), new_state,
                Tensor._from_data(top_lp.reshape(-1)), new_fin,
                Tensor._from_data(beam_src))


def dynamic_decode(decoder, inits=None, max_step_num=32,
                   batch_size=None, **kwargs):
    """Run a decoder until every beam finishes or ``max_step_num``; the
    sequences are recovered by backtracking the parent beams (gather_tree).
    Returns (token ids [batch, beam, steps], final log probs [batch,
    beam])."""
    if batch_size is None:
        batch_size = 1
    tokens, state, log_probs, finished = decoder.initialize(
        batch_size, inits)
    k = decoder.beam_size
    toks, parents = [], []
    for _ in range(int(max_step_num)):
        tokens, state, log_probs, finished, src = decoder.step(
            tokens, state, log_probs, finished)
        toks.append(tokens._data.cpu().numpy().reshape(batch_size, k))
        parents.append(src._data.cpu().numpy().reshape(batch_size, k))
        if bool(finished._data.all()):
            break
    steps = len(toks)
    ids = np.zeros((batch_size, k, steps), np.int64)
    cur = np.tile(np.arange(k), (batch_size, 1))
    rows = np.arange(batch_size)[:, None]
    for ti in range(steps - 1, -1, -1):
        ids[:, :, ti] = toks[ti][rows, cur]
        cur = parents[ti][rows, cur]
    dev = log_probs._data.device
    return (Tensor._from_data(torch.from_numpy(ids).to(dev)),
            Tensor._from_data(log_probs._data.reshape(batch_size, k)))
