"""nn.functional namespace completion (port of
``paddle_tpu/nn/functional/extras.py``): re-exports of the nn long-tail
registry ops, in-place activation variants, and the remaining
functionals (alpha_dropout, bilinear, dice / log / npair losses,
pairwise_distance, temporal_shift, gather_tree, margin_cross_entropy,
class_center_sample, the packed flash attention wrappers).

The functionals compute with torch on the Tensors' data and keep torch's
graph, so they are differentiable (the JAX package's wrap their results
in fresh Tensors, which its tape does not follow: ROADMAP queue 3).
``flash_attn_qkvpacked`` slices the packed tensor and calls
:func:`~paddle_tpu_torch.nn.functional.flash_attention.flash_attention`,
the hand-written kernels on the card: the gradient comes back packed,
[B, S, 3, H, D].
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as tF

from paddle_tpu_torch.core import generator as gen
from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.ops.random_ops import bernoulli_bits
from paddle_tpu_torch.ops.registry import API as _API, rebind_inplace

EXPORTS = {}

for _nm in ["adaptive_avg_pool1d", "adaptive_avg_pool3d",
            "adaptive_max_pool1d", "adaptive_max_pool3d", "avg_pool3d",
            "max_pool3d", "max_unpool1d", "max_unpool2d", "max_unpool3d",
            "fractional_max_pool2d", "fractional_max_pool3d",
            "channel_shuffle", "pixel_unshuffle", "fold", "rrelu",
            "conv1d_transpose", "conv3d_transpose", "gaussian_nll_loss",
            "hinge_embedding_loss", "multi_label_soft_margin_loss",
            "multi_margin_loss", "poisson_nll_loss", "soft_margin_loss",
            "triplet_margin_loss", "hsigmoid_loss"]:
    EXPORTS[_nm] = _API[_nm]


def _export(fn, name=None):
    EXPORTS[name or fn.__name__] = fn
    return fn


def _mk_inplace(base):
    api = _API[base]

    def fn(x, *a, **k):
        return rebind_inplace(x, api(x, *a, **k))

    fn.__name__ = base + "_"
    return fn


for _base in ["relu", "elu", "tanh", "softmax", "hardtanh", "leaky_relu",
              "thresholded_relu"]:
    EXPORTS[_base + "_"] = _mk_inplace(_base)


def _d(t):
    return t._data if isinstance(t, Tensor) else torch.as_tensor(t)


def _t(data):
    return Tensor._from_data(data, stop_gradient=not data.requires_grad)


@_export
def log_sigmoid(x, name=None):
    return _t(tF.logsigmoid(_d(x)))


@_export
def zeropad2d(x, padding, data_format="NCHW", name=None):
    p = padding if isinstance(padding, (list, tuple)) else [padding] * 4
    l, r, t, b = (int(v) for v in p)
    if data_format == "NHWC":
        return _t(tF.pad(_d(x), (0, 0, l, r, t, b)))
    return _t(tF.pad(_d(x), (l, r, t, b)))


@_export
def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU-consistent dropout: dropped units take -alpha' and an affine
    correction keeps the mean and variance; one key from the generator."""
    if not training or p == 0.0:
        return x if isinstance(x, Tensor) else _t(_d(x))
    d = _d(x)
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    neg_sat = -alpha * scale
    keep = bernoulli_bits(gen.active_key(), 1.0 - p, d.shape, d.device)
    a = (1.0 / ((1.0 - p) * (1.0 + p * neg_sat ** 2)) ** 0.5)
    b = -a * p * neg_sat
    out = a * torch.where(keep, d, torch.full_like(d, neg_sat)) + b
    return _t(out.to(d.dtype))


@_export
def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """Channel-wise dropout: whole feature maps are zeroed together."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return _API["dropout"](x, p=p, training=training, axis=axis)


@_export
def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return _API["dropout"](x, p=p, training=training, axis=axis)


@_export
def bilinear(x1, x2, weight, bias=None, name=None):
    """out[:, k] = x1 W_k x2^T, weight [out, in1, in2]."""
    out = torch.einsum("bi,oij,bj->bo", _d(x1), _d(weight), _d(x2))
    if bias is not None:
        out = out + _d(bias)
    return _t(out)


@_export
def maxout(x, groups, axis=1, name=None):
    d = _d(x)
    axis = axis % d.dim()
    c = d.shape[axis]
    shape = d.shape[:axis] + (c // groups, groups) + d.shape[axis + 1:]
    return _t(torch.amax(d.reshape(shape), dim=axis + 1))


@_export
def dice_loss(input, label, epsilon=1e-5, name=None):
    """1 - 2|X & Y| / (|X| + |Y|), label the class ids one-hot against
    input's last dim."""
    d = _d(input)
    lab = tF.one_hot(_d(label).reshape(d.shape[:-1]).long(),
                     d.shape[-1]).to(d.dtype)
    dims = tuple(range(1, d.dim()))
    inter = torch.sum(d * lab, dim=dims)
    union = torch.sum(d, dim=dims) + torch.sum(lab, dim=dims)
    return _t(torch.mean(1.0 - (2.0 * inter + epsilon) / (union + epsilon)))


@_export
def log_loss(input, label, epsilon=1e-4, name=None):
    d = torch.clamp(_d(input), epsilon, 1.0 - epsilon)
    lab = _d(label)
    return _t(-lab * torch.log(d) - (1.0 - lab) * torch.log(1.0 - d))


@_export
def square_error_cost(input, label, name=None):
    return _t((_d(input) - _d(label)) ** 2)


@_export
def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    """Cross-entropy over anchor . positive^T with same-label targets,
    plus an L2 term on the embeddings."""
    a, p = _d(anchor), _d(positive)
    lab = _d(labels).reshape(-1)
    sim = a @ p.T
    same = (lab[:, None] == lab[None, :]).to(a.dtype)
    tgt = same / torch.clamp(same.sum(-1, keepdim=True), min=1.0)
    logp = torch.log_softmax(sim, dim=-1)
    ce = -torch.mean(torch.sum(tgt * logp, dim=-1))
    reg = l2_reg * (torch.mean(torch.sum(a * a, -1))
                    + torch.mean(torch.sum(p * p, -1))) * 0.25
    return _t(ce + reg)


@_export
def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    diff = _d(x) - _d(y) + epsilon
    return _t(torch.sum(torch.abs(diff) ** p, dim=-1, keepdim=keepdim)
              ** (1.0 / p))


@_export
def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """TSM: a quarter of the channels shifted one frame back, a quarter
    one frame forward, within each segment."""
    d = _d(x)
    if data_format == "NHWC":
        d = d.permute(0, 3, 1, 2)
    nt, c, h, w = d.shape
    n = nt // seg_num
    v = d.reshape(n, seg_num, c, h, w)
    fold_ = int(c * shift_ratio)
    back = torch.cat([v[:, 1:, :fold_], torch.zeros_like(v[:, :1, :fold_])],
                     dim=1)
    fwd = torch.cat([torch.zeros_like(v[:, :1, fold_:2 * fold_]),
                     v[:, :-1, fold_:2 * fold_]], dim=1)
    out = torch.cat([back, fwd, v[:, :, 2 * fold_:]], dim=2).reshape(
        nt, c, h, w)
    if data_format == "NHWC":
        out = out.permute(0, 2, 3, 1)
    return _t(out)


@_export
def gather_tree(ids, parents):
    """Backtrack beam-search ancestry: ids / parents [T, B, K] -> the full
    sequence of each final beam (on the host, as in the JAX package)."""
    idd = _d(ids)
    idv = idd.detach().cpu().numpy()
    par = _d(parents).detach().cpu().numpy()
    T, B, K = idv.shape
    out = np.zeros_like(idv)
    cur = np.tile(np.arange(K), (B, 1))
    rows = np.arange(B)[:, None]
    for t in range(T - 1, -1, -1):
        out[t] = idv[t][rows, cur]
        cur = par[t][rows, cur]
    return _t(torch.from_numpy(out).to(idd.device))


@_export
def class_center_sample(label, num_classes, num_samples, group=None):
    """Sample class centers for PartialFC: the positive classes plus
    negatives drawn on the host (numpy's fresh entropy, as in the JAX
    package). Returns (remapped_label, sampled_class_indices)."""
    ld = _d(label)
    lab = ld.detach().cpu().numpy().reshape(-1).astype(np.int64)
    pos = np.unique(lab)
    n_extra = max(0, int(num_samples) - len(pos))
    rest = np.setdiff1d(np.arange(num_classes), pos)
    if n_extra > 0 and len(rest) > 0:
        extra = np.random.default_rng().choice(
            rest, min(n_extra, len(rest)), replace=False)
        sampled = np.concatenate([pos, np.sort(extra)])
    else:
        sampled = pos
    remap = {int(c): i for i, c in enumerate(sampled)}
    new_lab = np.asarray([remap[int(v)] for v in lab], np.int64)
    return (_t(torch.from_numpy(new_lab).to(ld.device)),
            _t(torch.from_numpy(sampled.astype(np.int64)).to(ld.device)))


@_export
def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean"):
    """ArcFace-family margin softmax: cos(m1 theta + m2) - m3 on the target
    logit, then a scaled cross-entropy."""
    d = _d(logits)
    lab = _d(label).reshape(-1).long()
    n, c = d.shape
    theta = torch.arccos(torch.clamp(d, -1.0 + 1e-7, 1.0 - 1e-7))
    target_cos = torch.cos(margin1 * theta + margin2) - margin3
    onehot = tF.one_hot(lab, c).to(d.dtype)
    adjusted = torch.where(onehot > 0, target_cos, d) * scale
    logp = torch.log_softmax(adjusted, dim=-1)
    loss = -torch.gather(logp, 1, lab[:, None])[:, 0]
    if reduction == "mean":
        loss_t = _t(torch.mean(loss))
    elif reduction == "sum":
        loss_t = _t(torch.sum(loss))
    else:
        loss_t = _t(loss[:, None])
    if return_softmax:
        return loss_t, _t(torch.softmax(adjusted, -1))
    return loss_t


@_export
def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, **kwargs):
    raise NotImplementedError(
        "sparse_attention is a GPU-only CUDA kernel in the reference; "
        "the TPU serving/attention paths are flash_attention (Pallas), "
        "incubate block_multihead_attention (paged), and "
        "paddle.sparse softmax/masked_matmul for explicit CSR patterns")


@_export
def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False, return_softmax=False,
                         fixed_seed_offset=None, rng_name="", training=True,
                         name=None):
    """qkv [B, S, 3, H, D] packed -> ``(out, None)`` through
    :func:`flash_attention` on the three slices."""
    from paddle_tpu_torch.nn.functional.flash_attention import (
        flash_attention,
    )

    d = _d(qkv)
    q, k, v = (_t(d[:, :, i]) for i in range(3))
    return flash_attention(q, k, v, dropout=dropout, causal=causal,
                           training=training)


@_export
def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k,
                                max_seqlen_q, max_seqlen_k, scale=None,
                                dropout=0.0, causal=False,
                                return_softmax=False, training=True,
                                name=None):
    """qkv [total, 3, H, D] varlen-packed -> ``flash_attn_unpadded``."""
    from paddle_tpu_torch.nn.functional.flash_attention import (
        flash_attn_unpadded,
    )

    d = _d(qkv)
    q, k, v = (_t(d[:, i]) for i in range(3))
    sc = scale if scale is not None else 1.0 / math.sqrt(d.shape[-1])
    return flash_attn_unpadded(q, k, v, cu_seqlens_q, cu_seqlens_k,
                               max_seqlen_q, max_seqlen_k, scale=sc,
                               causal=causal)


@_export
def flash_attention_with_sparse_mask(query, key, value,
                                     attn_mask_start_row_indices=None,
                                     attn_mask_start_row=0,
                                     dropout_p=0.0, is_causal=True,
                                     training=True, name=None):
    """Row-sparse causal masks as dense attention with the expanded mask:
    column j is seen by rows i with j <= i < start[b, h, j]. The mask's
    blocked value is float32's lowest cast to q's dtype, as in the JAX
    package (in bf16 that is -inf, so a row that sees no column is NaN
    there, and in the port too)."""
    from paddle_tpu_torch.nn.functional.flash_attention import (
        scaled_dot_product_attention,
    )

    if attn_mask_start_row_indices is None:
        return scaled_dot_product_attention(
            query, key, value, dropout_p=dropout_p, is_causal=is_causal,
            training=training)
    q = _d(query)
    B, S = q.shape[0], q.shape[1]
    start = _d(attn_mask_start_row_indices).reshape(B, -1, S)
    rows = torch.arange(S, device=q.device)[None, None, :, None]
    cols = torch.arange(S, device=q.device)[None, None, None, :]
    allow = (cols <= rows) & (rows < start[..., None, :])
    neg = torch.tensor(torch.finfo(torch.float32).min).to(q.dtype)
    mask = torch.where(allow, torch.zeros((), dtype=q.dtype),
                       neg).to(q.device)
    return scaled_dot_product_attention(
        query, key, value, attn_mask=_t(mask), dropout_p=dropout_p,
        is_causal=False, training=training)


@_export
def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    from paddle_tpu_torch.nn.layers_extra import (
        TripletMarginWithDistanceLoss,
    )

    layer = TripletMarginWithDistanceLoss(
        distance_function=distance_function, margin=margin, swap=swap,
        reduction=reduction)
    return layer(input, positive, negative)
