"""NN emitters (port of ``paddle_tpu/ops/nn_ops.py``): activations,
linear and embedding, conv and pool, normalization, dropout and sampling
(each draw one key from the global generator), losses and attention.

Conv, pool and products call torch's own functions (the JAX package
computes them in XLA, outside any Pallas kernel); paddings the torch
functions do not take (asymmetric pairs, ``"SAME"`` at a stride) are
applied first, as ``lax`` computes them. ``interpolate`` is
``jax.image.resize``'s algorithm (half-pixel sampling, the Keys cubic
with a = -0.5, antialiasing when shrinking). ``flash_attention`` is the
op over :func:`paddle_tpu_torch.ops.flash_attention.flash_attention_data`:
the hand-written kernels on the card (forward, and dQ and dK/dV when
autograd runs backward), their plain versions on the CPU.

``rms_norm``, ``softmax_with_cross_entropy``,
``scaled_dot_product_attention`` and ``flash_attention`` are also the raw
functions the Llama model calls (marked with :func:`~paddle_tpu_torch.
core.op.op`, so that ``amp.auto_cast`` sees each as one call).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core import generator as gen
from paddle_tpu_torch.core.op import op as _one_call
from paddle_tpu_torch.ops.flash_attention import flash_attention_data
from paddle_tpu_torch.ops import threefry
from paddle_tpu_torch.ops.random_ops import bernoulli_bits
from paddle_tpu_torch.ops.registry import register_emitter as op

__all__ = ["rms_norm", "softmax_with_cross_entropy",
           "scaled_dot_product_attention", "flash_attention"]


def _scalar(v, like):
    return torch.full((), v, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------
@op
def relu(x):
    return F.relu(x)


@op
def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


@op
def gelu(x, approximate=False):
    return F.gelu(x, approximate="tanh" if approximate else "none")


@op
def sigmoid(x):
    return torch.sigmoid(x)


@op
def silu(x):
    return F.silu(x)


@op
def swish(x):
    return F.silu(x)


@op
def mish(x):
    return x * torch.tanh(_softplus(x))


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


@op
def softplus(x, beta=1.0, threshold=20.0):
    scaled = beta * x
    return torch.where(scaled > threshold, x, _softplus(scaled) / beta)


@op
def softsign(x):
    return x / (1 + torch.abs(x))


@op
def hardswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


@op
def hardsigmoid(x, slope=1.0 / 6.0, offset=0.5):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


@op
def hardtanh(x, min=-1.0, max=1.0):
    return torch.clamp(x, min, max)


@op
def leaky_relu(x, negative_slope=0.01):
    return torch.where(x >= 0, x, negative_slope * x)


@op
def elu(x, alpha=1.0):
    return F.elu(x, alpha=alpha)


@op
def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


@op
def celu(x, alpha=1.0):
    return F.celu(x, alpha=alpha)


@op
def prelu(x, weight):
    return torch.where(x > 0, x, weight * x)


@op
def glu(x, axis=-1):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


@op
def tanhshrink(x):
    return x - torch.tanh(x)


@op
def hardshrink(x, threshold=0.5):
    return torch.where(torch.abs(x) > threshold, x, _scalar(0.0, x))


@op
def softshrink(x, threshold=0.5):
    zero = _scalar(0.0, x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


@op
def thresholded_relu(x, threshold=1.0):
    return torch.where(x > threshold, x, _scalar(0.0, x))


@op
def softmax(x, axis=-1):
    return torch.softmax(x, dim=int(axis))


@op
def log_softmax(x, axis=-1):
    return torch.log_softmax(x, dim=int(axis))


@op
def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1):
    """Softmax of ``(x + g) / temperature`` with ``g`` Gumbel noise of
    ``x``'s dtype from one key; ``hard`` gives the one-hot of the argmax
    in the forward and the soft gradient."""
    g = threefry.gumbel(gen.active_key(), x.shape, x.dtype, x.device)
    y = torch.softmax((x + g) / _scalar(temperature, x), dim=int(axis))
    if hard:
        idx = torch.argmax(y, dim=int(axis), keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(int(axis), idx, 1.0)
        y = (y_hard - y).detach() + y
    return y


# ---------------------------------------------------------------------------
# linear / embedding
# ---------------------------------------------------------------------------
@op
def linear(x, weight, bias=None):
    """weight layout: [in_features, out_features] (paddle's)."""
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias
    return out


@op
def embedding(x, weight, padding_idx=None, sparse=False):
    out = F.embedding(x, weight)
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None], _scalar(0.0, out),
                          out)
    return out


# ---------------------------------------------------------------------------
# conv / pool  (NCHW)
# ---------------------------------------------------------------------------
def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(int(a) for a in v)
    return (int(v),) * n


def _pads(padding, in_sizes, k, stride, dilation):
    """lax's (lo, hi) per spatial dim for an int, per-dim, per-side or
    ``"SAME"``/``"VALID"`` padding."""
    nd = len(k)
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [(0, 0)] * nd
        out = []
        for n, kk, s, d in zip(in_sizes, k, stride, dilation):
            o = -(-n // s)
            total = max((o - 1) * s + (kk - 1) * d + 1 - n, 0)
            out.append((total // 2, total - total // 2))
        return out
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    padding = list(padding)
    if len(padding) == nd:
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * nd:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(nd)]
    raise ValueError(f"bad padding {padding}")


def _pad_spatial(x, pads, value=0.0):
    if not any(lo or hi for lo, hi in pads):
        return x
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(x, flat, value=value)


def _conv(fn, nd, x, weight, bias, stride, padding, dilation, groups):
    stride = _pair(stride, nd)
    dilation = _pair(dilation, nd)
    pads = _pads(padding, x.shape[2:], weight.shape[2:], stride, dilation)
    out = fn(_pad_spatial(x, pads), weight, None, stride, 0, dilation,
             int(groups))
    if bias is not None:
        out = out + bias.reshape(1, -1, *([1] * nd))
    return out


@op
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    return _conv(F.conv2d, 2, x, weight, bias, stride, padding, dilation,
                 groups)


@op
def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL"):
    return _conv(F.conv1d, 1, x, weight, bias, stride, padding, dilation,
                 groups)


@op
def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW"):
    return _conv(F.conv3d, 3, x, weight, bias, stride, padding, dilation,
                 groups)


@op
def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCHW"):
    """paddle's weight layout [in, out/groups, kh, kw] is torch's. The
    full transposed convolution is cropped by (lo, hi) per dim and
    extended by ``output_padding``, as the JAX op's dilated convolution
    places it."""
    stride = _pair(stride)
    dilation = _pair(dilation)
    opad = _pair(output_padding)
    if isinstance(padding, str):
        raise NotImplementedError("string padding for conv_transpose")
    pads = _pads(padding, x.shape[2:], weight.shape[2:], stride, dilation)
    full = F.conv_transpose2d(x, weight, None, stride, 0, 0, int(groups),
                              dilation)
    for d, ((lo, hi), extra) in enumerate(zip(pads, opad)):
        n = full.shape[2 + d]
        end = n - hi + extra
        if end > n:   # past the last input's reach: zeros
            full = F.pad(full, [0, end - n] if d == 1
                         else [0, 0, 0, end - n])
        full = full.narrow(2 + d, lo, end - lo)
    if bias is not None:
        full = full + bias.reshape(1, -1, 1, 1)
    return full


def _neg_inf(x):
    if x.is_floating_point():
        return float("-inf")
    return torch.iinfo(x.dtype).min


def _pool(kind, nd, x, kernel_size, stride, padding, exclusive=True):
    k = _pair(kernel_size, nd)
    s = _pair(stride, nd) if stride is not None else k
    pads = _pads(padding, x.shape[2:], k, s, (1,) * nd)
    string_pad = isinstance(padding, str)
    if kind == "max":
        fn = (F.max_pool1d, F.max_pool2d)[nd - 1]
        return fn(_pad_spatial(x, pads, _neg_inf(x)), k, s)
    fn = (F.avg_pool1d, F.avg_pool2d)[nd - 1]
    summed = fn(_pad_spatial(x, pads), k, s) * float(np.prod(k))
    if exclusive and not string_pad:
        counts = fn(_pad_spatial(torch.ones_like(x), pads), k, s) * float(
            np.prod(k))
        return summed / counts
    return summed / float(np.prod(k))


@op
def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCHW"):
    return _pool("max", 2, x, kernel_size, stride, padding)


@op
def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, data_format="NCHW"):
    return _pool("avg", 2, x, kernel_size, stride, padding, exclusive)


@op
def max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False):
    return _pool("max", 1, x, kernel_size, stride, padding)


@op
def avg_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True):
    return _pool("avg", 1, x, kernel_size, stride, padding, exclusive)


@op
def adaptive_avg_pool2d(x, output_size):
    size = _pair(output_size)
    if size == (1, 1):
        # the whole map's mean as one average-pooling window: CUDA's
        # adaptive pooling backward has no deterministic kernel, and
        # torch.use_deterministic_algorithms(True) refuses it
        return F.avg_pool2d(x, tuple(x.shape[-2:]))
    return F.adaptive_avg_pool2d(x, size)


@op
def adaptive_max_pool2d(x, output_size):
    return F.adaptive_max_pool2d(x, _pair(output_size))


@op
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    """im2col: (N, C * kh * kw, L), channel-major."""
    k = _pair(kernel_sizes)
    s = _pair(strides)
    d = _pair(dilations)
    pads = _pads(paddings, x.shape[2:], k, s, d)
    return F.unfold(_pad_spatial(x, pads), k, dilation=d, padding=0,
                    stride=s)


@op
def pixel_shuffle(x, upscale_factor, data_format="NCHW"):
    r = int(upscale_factor)
    n, c, h, w = x.shape
    x = x.reshape(n, c // (r * r), r, r, h, w)
    x = x.permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, c // (r * r), h * r, w * r)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x):
    return torch.clamp(1.0 - torch.abs(x), min=0.0)


def _resize_weights(m, n, kernel, device):
    """jax.image's weight matrix [m, n] for resizing a dim of m samples to
    n (scale n / m, no translation, antialiased when shrinking), in f32."""
    scale = np.float32(n / m)
    inv = 1.0 / scale
    kernel_scale = max(float(inv), 1.0)
    sample = ((torch.arange(n, dtype=torch.float32, device=device) + 0.5)
              * float(inv) - 0.5)
    xs = torch.abs(sample[None, :] - torch.arange(
        m, dtype=torch.float32, device=device)[:, None]) / kernel_scale
    w = kernel(xs)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize_nearest_index(m, n, device):
    off = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * (
        m / n)
    return torch.floor(off).long()


def _bilinear_align_corners(x, oh, ow):
    n, c, h, w = x.shape
    ys = torch.linspace(0.0, h - 1.0, oh, device=x.device)
    xs = torch.linspace(0.0, w - 1.0, ow, device=x.device)
    y0 = torch.clamp(torch.floor(ys).long(), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs).long(), 0, w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    wy = (ys - y0).to(x.dtype)[:, None]
    wx = (xs - x0).to(x.dtype)[None, :]

    def g(yi, xi):
        return x[:, :, yi][:, :, :, xi]

    top = g(y0, x0) * (1 - wx) + g(y0, x1) * wx
    bot = g(y1, x0) * (1 - wx) + g(y1, x1) * wx
    return top * (1 - wy) + bot * wy


@op
def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, data_format="NCHW"):
    n, c, h, w = x.shape
    if size is None:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) else (
            scale_factor, scale_factor)
        size = (int(h * sf[0]), int(w * sf[1]))
    oh, ow = int(size[0]), int(size[1])
    if align_corners and mode in ("bilinear", "linear") and oh > 1 and ow > 1:
        return _bilinear_align_corners(x, oh, ow)
    method = {"nearest": "nearest", "bilinear": "linear", "bicubic": "cubic",
              "linear": "linear", "area": "linear"}[mode]
    if method == "nearest":
        x = torch.index_select(x, 2, _resize_nearest_index(h, oh, x.device))
        return torch.index_select(x, 3,
                                  _resize_nearest_index(w, ow, x.device))
    kernel = _triangle if method == "linear" else _keys_cubic
    wh = _resize_weights(h, oh, kernel, x.device).to(x.dtype)
    ww = _resize_weights(w, ow, kernel, x.device).to(x.dtype)
    return torch.einsum("nchw,hp,wq->ncpq", x, wh, ww)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------
def _var(x, dims):
    return torch.var(x, dim=dims, correction=0, keepdim=True)


@op
def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW"):
    """Returns (out, batch_mean, batch_var); the Layer updates the running
    statistics, as in the JAX package."""
    axes = tuple(i for i in range(x.dim()) if i != 1)
    if training:
        mean = torch.mean(x, dim=axes)
        var = torch.var(x, dim=axes, correction=0)
    else:
        mean, var = running_mean, running_var
    bshape = [1, -1] + [1] * (x.dim() - 2)
    inv = torch.rsqrt(var + epsilon).reshape(bshape)
    out = (x - mean.reshape(bshape)) * inv
    if weight is not None:
        out = out * weight.reshape(bshape)
    if bias is not None:
        out = out + bias.reshape(bshape)
    if training:
        return out, mean, var
    return out, running_mean.clone(), running_var.clone()


@op
def layer_norm(x, weight=None, bias=None, epsilon=1e-5,
               begin_norm_axis=None, normalized_shape=None):
    if normalized_shape is not None:
        nd = len(normalized_shape) if isinstance(
            normalized_shape, (list, tuple)) else 1
        axes = tuple(range(x.dim() - nd, x.dim()))
    elif begin_norm_axis is not None:
        axes = tuple(range(begin_norm_axis, x.dim()))
    else:
        axes = (x.dim() - 1,)
    mean = torch.mean(x, dim=axes, keepdim=True)
    out = (x - mean) * torch.rsqrt(_var(x, axes) + epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


@op
@_one_call
def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm, in the JAX op's order: normalise in f32, cast back to the
    input dtype, then multiply by the weight."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + epsilon)).to(dt)
    if weight is not None:
        out = out * weight
    return out


@op
def group_norm(x, groups, weight=None, bias=None, epsilon=1e-5,
               data_format="NCHW"):
    n, c = x.shape[0], x.shape[1]
    g = int(groups)
    xs = x.reshape(n, g, c // g, *x.shape[2:])
    axes = tuple(range(2, xs.dim()))
    mean = torch.mean(xs, dim=axes, keepdim=True)
    out = ((xs - mean) * torch.rsqrt(_var(xs, axes) + epsilon)).reshape(
        x.shape)
    bshape = [1, -1] + [1] * (x.dim() - 2)
    if weight is not None:
        out = out * weight.reshape(bshape)
    if bias is not None:
        out = out + bias.reshape(bshape)
    return out


@op
def instance_norm(x, weight=None, bias=None, epsilon=1e-5):
    axes = tuple(range(2, x.dim()))
    mean = torch.mean(x, dim=axes, keepdim=True)
    out = (x - mean) * torch.rsqrt(_var(x, axes) + epsilon)
    bshape = [1, -1] + [1] * (x.dim() - 2)
    if weight is not None:
        out = out * weight.reshape(bshape)
    if bias is not None:
        out = out + bias.reshape(bshape)
    return out


@op
def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0):
    sq = torch.square(x)
    half = size // 2
    c = x.shape[1]
    flat = [0, 0] * (x.dim() - 2) + [half, size - 1 - half]
    pad = F.pad(sq, flat)
    acc = sum(pad[:, i:i + c] for i in range(size))
    return x / torch.pow(k + alpha * acc / size, beta)


@op
def normalize(x, p=2, axis=1, epsilon=1e-12):
    nrm = torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=axis,
                              keepdim=True), 1.0 / p)
    return x / torch.clamp(nrm, min=epsilon)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def _reduce(loss, reduction):
    if reduction == "mean":
        return torch.mean(loss)
    if reduction == "sum":
        return torch.sum(loss)
    return loss


def _take(logp, label, axis):
    """logp's entries at ``label`` along ``axis`` (label without that axis),
    keeping the axis with size 1."""
    return torch.gather(logp, axis, label.unsqueeze(axis).long())


@op
def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Reference: paddle.nn.functional.cross_entropy."""
    logp = torch.log_softmax(input, dim=axis) if use_softmax else torch.log(
        torch.clamp(input, min=1e-30))
    if soft_label:
        lbl = label.to(logp.dtype)
        if label_smoothing > 0.0:
            n = lbl.shape[axis]
            lbl = lbl * (1 - label_smoothing) + label_smoothing / n
        return _reduce(-torch.sum(lbl * logp, dim=axis), reduction)
    if label.dim() == logp.dim():
        label = label.squeeze(axis)
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label))
    nll = -_take(logp, safe, axis).squeeze(axis)
    if label_smoothing > 0.0:
        smooth = -torch.mean(logp, dim=axis)
        nll = (1 - label_smoothing) * nll + label_smoothing * smooth
    zero = _scalar(0.0, nll)
    if weight is not None:
        w = weight[safe.long()]
        nll = nll * w
        if reduction == "mean":
            return torch.sum(torch.where(valid, nll, zero)) / torch.clamp(
                torch.sum(torch.where(valid, w, _scalar(0.0, w))),
                min=1e-12)
    nll = torch.where(valid, nll, zero)
    if reduction == "mean":
        return torch.sum(nll) / torch.clamp(
            torch.sum(valid.to(nll.dtype)), min=1.0)
    return _reduce(nll, reduction)


@op
@_one_call
def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False):
    """Per-position loss along ``axis``, keeping the axis with size 1.
    Low-precision logits are taken to f32 first (the loss is f32); hard
    labels may carry the class axis with size 1; positions labelled
    ``ignore_index`` get loss 0. No reduction."""
    if logits.is_floating_point() and logits.element_size() < 4:
        logits = logits.float()
    logp = torch.log_softmax(logits, dim=axis)
    if soft_label:
        loss = -torch.sum(label.to(logp.dtype) * logp, dim=axis,
                          keepdim=True)
    else:
        if label.dim() == logits.dim():
            label = label.squeeze(axis)
        valid = (label != ignore_index).unsqueeze(axis)
        safe = torch.where(valid, label.unsqueeze(axis).long(), 0)
        loss = torch.where(valid, -logp.gather(axis, safe), 0.0)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss


@op
def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean"):
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label))
    picked = _take(input, safe, -1).squeeze(-1)
    loss = torch.where(valid, -picked, _scalar(0.0, picked))
    if weight is not None:
        loss = loss * weight[safe.long()]
    if reduction == "mean":
        return torch.sum(loss) / torch.clamp(
            torch.sum(valid.to(loss.dtype)), min=1.0)
    return _reduce(loss, reduction)


@op
def binary_cross_entropy(input, label, weight=None, reduction="mean"):
    eps = 1e-12
    loss = -(label * torch.log(torch.clamp(input, min=eps)) +
             (1 - label) * torch.log(torch.clamp(1 - input, min=eps)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@op
def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    softplus_neg_abs = torch.log1p(torch.exp(-torch.abs(logit)))
    if pos_weight is not None:
        log_w = (pos_weight - 1.0) * label + 1.0
        loss = (1 - label) * logit + log_w * (
            softplus_neg_abs + torch.clamp(-logit, min=0.0))
    else:
        loss = torch.clamp(logit, min=0.0) - logit * label + softplus_neg_abs
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@op
def mse_loss(input, label, reduction="mean"):
    return _reduce(torch.square(input - label), reduction)


@op
def l1_loss(input, label, reduction="mean"):
    return _reduce(torch.abs(input - label), reduction)


@op
def smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    d = torch.abs(input - label)
    loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce(loss, reduction)


@op
def kl_div(input, label, reduction="mean"):
    loss = label * (torch.log(torch.clamp(label, min=1e-12)) - input)
    if reduction == "batchmean":
        return torch.sum(loss) / input.shape[0]
    return _reduce(loss, reduction)


@op
def hinge_loss(input, label):
    return torch.mean(torch.clamp(1.0 - input * label, min=0.0))


@op
def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean"):
    return _reduce(torch.clamp(-label * (input - other) + margin, min=0.0),
                   reduction)


@op
def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    dot_ = torch.sum(x1 * x2, dim=axis)
    n1 = torch.sqrt(torch.sum(torch.square(x1), dim=axis))
    n2 = torch.sqrt(torch.sum(torch.square(x2), dim=axis))
    return dot_ / torch.clamp(n1 * n2, min=eps)


@op
def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean"):
    cos = torch.sum(input1 * input2, dim=-1) / torch.clamp(
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1), min=1e-12)
    loss = torch.where(label > 0, 1.0 - cos,
                       torch.clamp(cos - margin, min=0.0))
    return _reduce(loss, reduction)


@op
def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum"):
    p = torch.sigmoid(logit)
    ce = torch.clamp(logit, min=0.0) - logit * label + torch.log1p(
        torch.exp(-torch.abs(logit)))
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * torch.pow(1 - p_t, gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


# ---------------------------------------------------------------------------
# dropout & random
# ---------------------------------------------------------------------------
@op
def dropout(x, p=0.5, training=True, mode="upscale_in_train", axis=None):
    """One key from the global generator per call in training with
    ``p > 0`` (none otherwise): the keep mask is an f32 uniform below
    ``1 - p`` over ``x``'s shape (1 on the axes ``axis`` leaves out); in a
    :func:`~paddle_tpu_torch.core.generator.batch_view`, the share's
    slice of the mask over the whole batch."""
    if not training or p == 0.0:
        # downscale_in_infer trains with out = x * mask (no upscale), so
        # inference compensates by (1 - p)
        if mode == "downscale_in_infer" and p > 0.0:
            return x * _scalar(1.0 - p, x)
        return x
    key = gen.active_key()
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = 1.0 - p
    view = gen.current_batch_view()
    if view is not None and len(shape) > view[0] and shape[view[0]] > 1:
        # one data-parallel share of a batch: its slice of the whole
        # batch's mask
        d, n, i = view
        whole = list(shape)
        whole[d] *= n
        mask = bernoulli_bits(key, keep, whole, x.device).narrow(
            d, i * shape[d], shape[d])
    else:
        mask = bernoulli_bits(key, keep, shape, x.device)
    if mode == "upscale_in_train":
        return torch.where(mask, x / _scalar(keep, x), _scalar(0.0, x))
    return torch.where(mask, x, _scalar(0.0, x))


@op
def bernoulli(x):
    return bernoulli_bits(gen.active_key(), x, x.shape,
                          x.device).to(x.dtype)


@op
def multinomial(x, num_samples=1, replacement=False):
    """Indices drawn from the rows of ``x`` (unnormalised probabilities):
    with replacement as ``jax.random.categorical`` draws them (its shape
    rule included), without by the Gumbel top-k trick. int64 (the JAX
    package gives int32; ROADMAP, by design)."""
    key = gen.active_key()
    logits = torch.log(torch.clamp_min(x, 1e-30))
    if replacement:
        return threefry.categorical(key, logits, -1,
                                    (*x.shape[:-1], int(num_samples)))
    z = threefry.gumbel(key, x.shape, torch.float32, x.device) + logits
    return torch.topk(z, int(num_samples), dim=-1).indices


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
@op
@_one_call
def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """Plain attention on [batch, seq, heads, head_dim], as the JAX emitter
    computes it: scores in the inputs' dtype, masked entries set to -1e9
    (causal bottom-right aligned; a bool ``attn_mask`` selects, any other
    is added), softmax in f32 cast back, then, in training with
    ``dropout_p > 0``, dropout whose keep mask takes one key from the
    global generator."""
    q = query.transpose(1, 2)
    k = key.transpose(1, 2)
    v = value.transpose(1, 2)
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    neg = _scalar(-1e9, scores)    # a fill: capture-safe
    if is_causal:
        sq, sk = scores.shape[-2:]
        causal = torch.ones((sq, sk), dtype=torch.bool,
                            device=scores.device).tril(sk - sq)
        scores = torch.where(causal, scores, neg)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = torch.where(attn_mask, scores, neg)
        else:
            scores = scores + attn_mask
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    if dropout_p > 0.0 and training:
        keep = bernoulli_bits(gen.active_key(), 1.0 - dropout_p,
                              probs.shape, probs.device)
        probs = torch.where(keep, probs / _scalar(1.0 - dropout_p, probs),
                            _scalar(0.0, probs))
    return torch.matmul(probs, v).transpose(1, 2)


@op
@_one_call
def flash_attention(q, k, v, causal=False):
    """Flash attention on [B, S, H, D]: the hand-written kernels on the
    card, their plain versions on the CPU."""
    return flash_attention_data(q, k, v, causal=causal)


# ---------------------------------------------------------------------------
# sequence losses: CTC and RNN-T, with the JAX package's -1e30 sentinel
# where no alignment exists
# ---------------------------------------------------------------------------
_NEG = -1e30


def _lae(terms):
    """log(sum(exp(terms))) with the JAX package's double where: where
    every term is at or below the sentinel the result is the sentinel and
    no gradient reaches a term through an infinite or NaN branch."""
    m = terms[0]
    for t in terms[1:]:
        m = torch.maximum(m, t)
    all_neg = m <= _NEG
    m_safe = torch.where(all_neg, torch.zeros_like(m), m)
    s = torch.exp(terms[0] - m_safe)
    for t in terms[1:]:
        s = s + torch.exp(t - m_safe)
    s_safe = torch.where(all_neg, torch.ones_like(s), s)
    return torch.where(all_neg, torch.full_like(m, _NEG),
                       m_safe + torch.log(s_safe))


@op
def warpctc(logits, labels, input_lengths, label_lengths, blank=0,
            norm_by_times=False):
    """CTC loss per batch element (warp-ctc's semantics): ``logits`` [T,
    B, C] unscaled (log-softmax taken here), ``labels`` [B, Lmax],
    lengths [B] -> [B] losses, through torch's ``ctc_loss`` (the same
    alpha recursion; its gradient reaches the logits through the
    log-softmax as the JAX package's does). An alignment is infeasible
    when a row's frames are fewer than its labels plus their adjacent
    repeats: there the JAX package's log-domain recursion bottoms out at
    its -1e30 sentinel, giving a loss of 1e30 and no gradient, and so
    does this op (torch's gives inf, zeroed with ``zero_infinity``)."""
    labels = labels.long()
    in_len = input_lengths.long().to(logits.device)
    lab_len = label_lengths.long().to(logits.device)
    lp = torch.log_softmax(logits.float(), dim=-1)
    loss = F.ctc_loss(lp, labels, in_len, lab_len, blank=blank,
                      reduction="none", zero_infinity=True)
    need = lab_len
    if labels.shape[1] > 1:
        pos = torch.arange(1, labels.shape[1], device=logits.device)
        rep = (labels[:, 1:] == labels[:, :-1]) & \
            (pos[None, :] < lab_len[:, None])
        need = need + rep.sum(1)
    loss = torch.where(in_len < need, torch.full_like(loss, -_NEG), loss)
    if norm_by_times:
        loss = loss / torch.clamp(in_len.float(), min=1.0)
    return loss.to(logits.dtype)


def _skew(v, D, offset):
    """v [B, T, W] -> [B, D, W] with out[b, d, u] = v[b, d - u - offset,
    u], and the mask of the entries whose time index lies in [0, T)."""
    B, T, W = v.shape
    d = torch.arange(D, device=v.device)[:, None]
    u = torch.arange(W, device=v.device)[None, :]
    t = d - u - offset
    ok = (t >= 0) & (t < T)
    idx = torch.clamp(t, 0, T - 1)[None].expand(B, D, W)
    return torch.gather(v, 1, idx), ok


@op
def rnnt(logits, labels, input_lengths, label_lengths, blank=0,
         fastemit_lambda=0.0):
    """RNN-T (transducer) loss per batch element (warp-transducer's
    semantics): ``logits`` [B, T, U+1, V] unscaled joint outputs,
    ``labels`` [B, U] -> [B] losses. The forward variable alpha[t, u] =
    logaddexp(alpha[t-1, u] + blank[t-1, u], alpha[t, u-1] + emit[t, u-1])
    runs over the anti-diagonals t + u (T + U steps, each cell in
    parallel), each cell computed by the JAX package's formula from the
    same two terms, so its row-by-row scan and this order give the same
    cells. FastEmit scales the gradient of the label emissions by
    1 + lambda through the value-preserving ``e + lambda (e - stop(e))``."""
    labels = labels.long()
    in_len = input_lengths.long().to(logits.device)
    lab_len = label_lengths.long().to(logits.device)
    B, T, U1, V = logits.shape
    U = U1 - 1
    dev = logits.device
    lp = torch.log_softmax(logits.float(), dim=-1)
    blank_lp = lp[..., blank]                               # [B, T, U+1]
    emit_lp = torch.gather(
        lp[:, :, :U, :], 3,
        labels[:, None, :, None].expand(B, T, U, 1))[..., 0]  # [B, T, U]
    if fastemit_lambda:
        emit_lp = emit_lp + fastemit_lambda * (emit_lp - emit_lp.detach())
    D = T + U1 - 1
    # vertical term into cell (t, u) of diagonal d: blank[t - 1, u]
    vb, vok = _skew(blank_lp, D, 1)
    # horizontal term into (t, u), u >= 1: emit[t, u - 1], laid at u
    eh, hok = _skew(torch.cat([torch.zeros((B, T, 1), device=dev),
                               emit_lp], dim=2), D, 0)
    hok = hok & (torch.arange(U1, device=dev) >= 1)[None, :]
    valid_u = torch.arange(U1, device=dev)[None, :] <= lab_len[:, None]
    neg = torch.full((), _NEG, device=dev)
    diag = torch.full((B, U1), _NEG, device=dev)
    diag = torch.cat([torch.zeros((B, 1), device=dev), diag[:, 1:]], dim=1)
    pad1 = torch.full((B, 1), _NEG, device=dev)
    diags = [diag]
    for d in range(1, D):
        vert = torch.where(vok[d], diag + vb[:, d], neg)
        hor = torch.where(hok[d], torch.cat([pad1, diag[:, :-1]], dim=1)
                          + eh[:, d], neg)
        cell = torch.cat([vert[:, :1], _lae([vert, hor])[:, 1:]], dim=1)
        cell = torch.where(valid_u, cell, neg)
        diag = cell
        diags.append(diag)
    alpha = torch.stack(diags, dim=1)                       # [B, D, U+1]
    t_end = torch.clamp(in_len - 1, min=0)
    bidx = torch.arange(B, device=dev)
    alpha_end = alpha[bidx, t_end + lab_len, lab_len]
    final_blank = blank_lp[bidx, t_end, lab_len]
    return (-(alpha_end + final_blank)).to(logits.dtype)
