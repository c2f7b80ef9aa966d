"""nn long-tail emitters (port of ``paddle_tpu/ops/nn_extras.py``, the
manifest's "nn long tail" section): 1-D and 3-D pooling, unpooling,
fractional pooling, channel and pixel shuffles, ``fold`` (col2im),
``rrelu``, the 1-D and 3-D transposed convolutions and the remaining loss
functionals.

Pools with padding follow ``lax.reduce_window``: max pads with -inf, avg
divides by the count of real elements when ``exclusive`` (or when
``ceil_mode`` added a partial window). The fractional pools and ``rrelu``
draw their uniforms from the global generator, bit for bit as
``jax.random.uniform`` draws them. Index results are int64.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

from paddle_tpu_torch.core import generator as gen
from paddle_tpu_torch.ops import threefry
from paddle_tpu_torch.ops.nn_ops import _pair as _tup, _reduce
from paddle_tpu_torch.ops.registry import register_emitter as op


def _window_view(x, k, s, nd):
    """x [N, C, *spatial] (already padded) -> [N, C, *out, *k] windows."""
    for i in range(nd):
        x = x.unfold(2 + i, k[i], s[i])
    return x


def _pool_nd(x, k, s, pad, nd, kind, exclusive=True, ceil_mode=False):
    """Pooling over the trailing ``nd`` dims with reduce_window's padding:
    (pad, pad + extra) per dim, extra from ``ceil_mode``."""
    extra = [0] * nd
    if ceil_mode:
        for i in range(nd):
            span = x.shape[2 + i] + 2 * pad[i] - k[i]
            rem = span % s[i]
            if rem:
                extra[i] = s[i] - rem
    cfg = []
    for i in reversed(range(nd)):
        cfg += [pad[i], pad[i] + extra[i]]
    red = tuple(range(-nd, 0))
    if kind == "max":
        xp = tF.pad(x, cfg, value=-math.inf) if any(cfg) else x
        return torch.amax(_window_view(xp, k, s, nd), dim=red)
    xp = tF.pad(x, cfg) if any(cfg) else x
    sums = torch.sum(_window_view(xp, k, s, nd), dim=red)
    if (exclusive and any(pad)) or any(extra):
        ones = tF.pad(torch.ones_like(x), cfg)
        counts = torch.sum(_window_view(ones, k, s, nd), dim=red)
        return sums / counts
    return sums / float(math.prod(k))


def _to_nc_first(x, data_format, nd):
    if data_format in (None, "NCDHW", "NCHW", "NCL"):
        return x, None
    perm = (0, nd + 1) + tuple(range(1, nd + 1))
    inv = (0,) + tuple(range(2, nd + 2)) + (1,)
    return x.permute(perm), inv


@op
def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCDHW"):
    k = _tup(kernel_size, 3)
    s = _tup(stride, 3) if stride is not None else k
    x, inv = _to_nc_first(x, data_format, 3)
    out = _pool_nd(x, k, s, _tup(padding, 3), 3, "max", ceil_mode=ceil_mode)
    return out.permute(inv) if inv else out


@op
def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, data_format="NCDHW"):
    k = _tup(kernel_size, 3)
    s = _tup(stride, 3) if stride is not None else k
    x, inv = _to_nc_first(x, data_format, 3)
    out = _pool_nd(x, k, s, _tup(padding, 3), 3, "avg",
                   exclusive=exclusive, ceil_mode=ceil_mode)
    return out.permute(inv) if inv else out


def _adaptive_bins(length, out):
    """[floor(i L / out), ceil((i + 1) L / out)) per output cell."""
    return [(int(math.floor(i * length / out)),
             int(math.ceil((i + 1) * length / out)))
            for i in range(out)]


def _adaptive_pool(x, out_sizes, kind):
    nd = len(out_sizes)

    def red(v, axis, keepdim=False):
        if kind == "max":
            return torch.amax(v, dim=axis, keepdim=keepdim)
        return torch.mean(v, dim=axis, keepdim=keepdim)

    for d, o in enumerate(out_sizes):
        axis = x.dim() - nd + d
        L = x.shape[axis]
        if L % o == 0:
            shape = x.shape[:axis] + (o, L // o) + x.shape[axis + 1:]
            x = red(x.reshape(shape), axis + 1)
        else:
            x = torch.cat([red(x.narrow(axis, a, b - a), axis, True)
                           for a, b in _adaptive_bins(L, o)], dim=axis)
    return x


@op
def adaptive_avg_pool1d(x, output_size):
    return _adaptive_pool(x, (int(output_size),), "avg")


@op
def adaptive_max_pool1d(x, output_size):
    return _adaptive_pool(x, (int(output_size),), "max")


@op
def adaptive_avg_pool3d(x, output_size):
    return _adaptive_pool(x, _tup(output_size, 3), "avg")


@op
def adaptive_max_pool3d(x, output_size):
    return _adaptive_pool(x, _tup(output_size, 3), "max")


@op
def fractional_max_pool2d(x, output_size, kernel_size=None,
                          random_u=None, return_mask=False):
    """Fractional max pooling (Graham 2014): the regions come from one
    uniform ``u`` (drawn when ``random_u`` is None); row i covers
    [floor((i + u) L / out) - floor(u L / out), ...)."""
    oh, ow = _tup(output_size, 2)
    dev = x.device
    if random_u is None:
        u = threefry.uniform(gen.active_key(), (), device=dev)
    else:
        u = torch.as_tensor(random_u, dtype=torch.float32, device=dev)
    n, c, h, w = x.shape

    def starts(L, o):
        i = torch.arange(o + 1, dtype=torch.float32, device=dev)
        raw = torch.floor((i + u) * L / o) - torch.floor(u * L / o)
        return torch.clamp(raw, 0, L).long()

    hs, ws = starts(h, oh), starts(w, ow)
    bh = int(math.ceil(h / oh)) + 1
    bw = int(math.ceil(w / ow)) + 1
    rows = hs[:-1][:, None] + torch.arange(bh, device=dev)[None, :]
    cols = ws[:-1][:, None] + torch.arange(bw, device=dev)[None, :]
    row_ok = rows < hs[1:][:, None]
    col_ok = cols < ws[1:][:, None]
    rcl = torch.clamp(rows, 0, h - 1)
    ccl = torch.clamp(cols, 0, w - 1)
    g = x[:, :, rcl][:, :, :, :, ccl]            # [n, c, oh, bh, ow, bw]
    mask = row_ok[:, :, None, None] & col_ok[None, None, :, :]
    g = torch.where(mask[None, None], g,
                    torch.full((), -math.inf, dtype=x.dtype, device=dev))
    out = torch.amax(g, dim=(3, 5))
    if not return_mask:
        return out
    gf = g.permute(0, 1, 2, 4, 3, 5).reshape(n, c, oh, ow, bh * bw)
    am = torch.argmax(gf, dim=-1)
    ar, ac = am // bw, am % bw
    oh_i = torch.arange(oh, device=dev)[None, None, :, None]
    ow_i = torch.arange(ow, device=dev)[None, None, None, :]
    r_idx = rcl[oh_i, ar]
    c_idx = ccl[ow_i, ac]
    return out, r_idx * w + c_idx


@op
def fractional_max_pool3d(x, output_size, kernel_size=None,
                          random_u=None, return_mask=False):
    """Depth bins by the adaptive split, then the 2-D fractional pool of
    each slab; each slab draws its own ``u`` when ``random_u`` is None."""
    od, oh, ow = _tup(output_size, 3)
    out = []
    for a, b in _adaptive_bins(x.shape[2], od):
        slab = torch.amax(x[:, :, a:b], dim=2)
        out.append(fractional_max_pool2d(slab, (oh, ow), random_u=random_u))
    return torch.stack(out, dim=2)


def _unpool_nd(x, indices, spatial_out):
    """Scatter the pooled values to their flat positions in each [N, C]
    plane of the output."""
    n, c = x.shape[:2]
    plane = int(math.prod(spatial_out))
    out = torch.zeros((n, c, plane), dtype=x.dtype, device=x.device)
    out = out.scatter(2, indices.reshape(n, c, -1).long(),
                      x.reshape(n, c, -1))
    return out.reshape((n, c) + tuple(spatial_out))


@op
def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCL"):
    k = _tup(kernel_size, 1)[0]
    s = _tup(stride, 1)[0] if stride is not None else k
    L = output_size[-1] if output_size is not None else \
        (x.shape[-1] - 1) * s + k - 2 * _tup(padding, 1)[0]
    return _unpool_nd(x, indices, (int(L),))


@op
def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCHW"):
    k = _tup(kernel_size, 2)
    s = _tup(stride, 2) if stride is not None else k
    p = _tup(padding, 2)
    if output_size is not None:
        hw = tuple(int(v) for v in output_size[-2:])
    else:
        hw = tuple((x.shape[2 + i] - 1) * s[i] + k[i] - 2 * p[i]
                   for i in range(2))
    return _unpool_nd(x, indices, hw)


@op
def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCDHW"):
    k = _tup(kernel_size, 3)
    s = _tup(stride, 3) if stride is not None else k
    p = _tup(padding, 3)
    if output_size is not None:
        dhw = tuple(int(v) for v in output_size[-3:])
    else:
        dhw = tuple((x.shape[2 + i] - 1) * s[i] + k[i] - 2 * p[i]
                    for i in range(3))
    return _unpool_nd(x, indices, dhw)


@op
def channel_shuffle(x, groups, data_format="NCHW"):
    n, c, h, w = x.shape
    g = int(groups)
    return x.reshape(n, g, c // g, h, w).transpose(1, 2).reshape(n, c, h, w)


@op
def pixel_unshuffle(x, downscale_factor, data_format="NCHW"):
    n, c, h, w = x.shape
    r = int(downscale_factor)
    x = x.reshape(n, c, h // r, r, w // r, r)
    return x.permute(0, 1, 3, 5, 2, 4).reshape(n, c * r * r, h // r, w // r)


@op
def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0,
         dilations=1):
    """col2im, the inverse of unfold: overlapping patches add up."""
    oh, ow = _tup(output_sizes, 2)
    kh, kw = _tup(kernel_sizes, 2)
    sh, sw = _tup(strides, 2)
    ph, pw = _tup(paddings, 2)
    dh, dw = _tup(dilations, 2)
    n, ckk, L = x.shape
    c = ckk // (kh * kw)
    nh = (oh + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    nw = (ow + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    cols = x.reshape(n, c, kh, kw, nh, nw)
    dev = x.device
    out = torch.zeros((n, c, oh + 2 * ph, ow + 2 * pw), dtype=x.dtype,
                      device=dev)
    ni = torch.arange(n, device=dev)[:, None, None, None]
    ci = torch.arange(c, device=dev)[None, :, None, None]
    for i in range(kh):
        for j in range(kw):
            rows = torch.arange(nh, device=dev) * sh + i * dh
            colsj = torch.arange(nw, device=dev) * sw + j * dw
            out = out.index_put((ni, ci, rows[None, None, :, None],
                                 colsj[None, None, None, :]),
                                cols[:, :, i, j], accumulate=True)
    return out[:, :, ph:ph + oh, pw:pw + ow]


@op
def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=True):
    """Randomized leaky relu: a slope drawn from U[lower, upper] per
    element in training, the mean slope in eval."""
    if training:
        a = threefry.uniform(gen.active_key(), x.shape, lower, upper,
                             device=x.device)
    else:
        a = (lower + upper) / 2.0
    return torch.where(x >= 0, x, a * x)


def _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                       dilation, groups, nd):
    """Paddle's transposed convolution (weight [C_in, C_out/groups, *K])."""
    fn = {1: tF.conv_transpose1d, 3: tF.conv_transpose3d}[nd]
    return fn(x, weight, bias, stride=_tup(stride, nd),
              padding=_tup(padding, nd),
              output_padding=_tup(output_padding, nd), groups=int(groups),
              dilation=_tup(dilation, nd))


@op
def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCL"):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 1)


@op
def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCDHW"):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 3)


# ---------------------------------------------------------------------------
# loss functionals
# ---------------------------------------------------------------------------
@op
def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean"):
    var = torch.clamp(variance, min=epsilon)
    loss = 0.5 * (torch.log(var) + (input - label) ** 2 / var)
    if full:
        loss = loss + 0.5 * math.log(2 * math.pi)
    return _reduce(loss, reduction)


@op
def hinge_embedding_loss(input, label, margin=1.0, reduction="mean"):
    loss = torch.where(label == 1.0, input,
                       torch.clamp(margin - input, min=0.0))
    return _reduce(loss, reduction)


@op
def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean"):
    term = (label * tF.logsigmoid(input)
            + (1 - label) * tF.logsigmoid(-input))
    if weight is not None:
        term = term * weight
    loss = -torch.mean(term, dim=-1)
    return _reduce(loss, reduction)


@op
def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean"):
    n, c = input.shape
    lab = label.long().reshape(n)
    correct = torch.gather(input, 1, lab[:, None])
    m = torch.clamp(margin - correct + input, min=0.0) ** p
    if weight is not None:
        m = m * weight[lab][:, None]
    mask = tF.one_hot(lab, c).to(input.dtype)
    loss = torch.sum(m * (1 - mask), dim=1) / c
    return _reduce(loss, reduction)


@op
def poisson_nll_loss(input, label, log_input=True, full=False,
                     epsilon=1e-8, reduction="mean"):
    if log_input:
        loss = torch.exp(input) - label * input
    else:
        loss = input - label * torch.log(input + epsilon)
    if full:
        # Stirling's approximation of log(label!)
        lab1 = torch.clamp(label, min=1.0)
        stir = (label * torch.log(lab1) - label
                + 0.5 * torch.log(2 * math.pi * lab1))
        loss = loss + torch.where(label > 1, stir, torch.zeros_like(stir))
    return _reduce(loss, reduction)


@op
def soft_margin_loss(input, label, reduction="mean"):
    z = -label * input
    loss = torch.logaddexp(torch.zeros_like(z), z)
    return _reduce(loss, reduction)


@op
def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean"):
    def dist(a, b):
        return torch.sum(torch.abs(a - b + epsilon) ** p, dim=-1) \
            ** (1.0 / p)

    dp = dist(input, positive)
    dn = dist(input, negative)
    if swap:
        dn = torch.minimum(dn, dist(positive, negative))
    return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)


@op
def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False):
    """Hierarchical sigmoid over the default complete binary tree, or the
    given ``path_table`` / ``path_code``."""
    n = input.shape[0]
    lab = label.long().reshape(n)
    if path_table is None:
        code_len = int(math.ceil(math.log2(num_classes)))
        nodes, codes = [], []
        for b in range(code_len):
            leaf = lab + num_classes
            nodes.append(leaf // (2 ** (b + 1)) - 1)
            codes.append((leaf // (2 ** b) % 2).to(input.dtype))
        node_ids = torch.stack(nodes, 1)
        code_bits = torch.stack(codes, 1)
    else:
        node_ids = path_table.long().reshape(n, -1)
        code_bits = path_code.to(input.dtype).reshape(n, -1)
    valid = node_ids >= 0
    node_ids = torch.clamp(node_ids, min=0)
    w = weight[node_ids]                             # [n, code_len, d]
    logits = torch.einsum("nkd,nd->nk", w, input)
    if bias is not None:
        logits = logits + bias.reshape(-1)[node_ids]
    per = (torch.clamp(logits, min=0) - logits * code_bits
           + torch.log1p(torch.exp(-torch.abs(logits))))
    per = torch.where(valid, per, torch.zeros_like(per))
    return torch.sum(per, dim=1, keepdim=True)
