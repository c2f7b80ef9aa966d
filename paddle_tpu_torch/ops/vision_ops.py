"""Vision op emitters (port of ``paddle_tpu/ops/vision_ops.py``): the RoI
pooling family, deformable convolution, the YOLOv3 loss, ``affine_grid``
and ``grid_sample``.

The sampling grids are fixed by the attributes (output size, sampling
ratio, kernel size), as in the JAX package: ``roi_align`` with
``sampling_ratio <= 0`` takes 2 x 2 samples a bin, and a bilinear sample
outside (-1, size) is zero, its taps outside [0, size) too. The bilinear
taps gather rows of a channels-last copy of the feature map, so the
gathers are (samples, C) blocks and their gradients one ``index_add``
each; autograd is torch's.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tF

from paddle_tpu_torch.ops.registry import register_emitter


def _bilinear_rows(flat, base, H, W, y, x):
    """Bilinear samples of a channels-last map ``flat`` [N*H*W, C] at
    (y, x) (any shape S, feature-map scale) in image ``base`` (S-shaped
    row offsets ``n*H*W``) -> [*S, C]; zero outside (-1, size) and for
    taps outside the map."""
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    ly = y - y0
    lx = x - x0
    valid = (y > -1.0) & (y < H) & (x > -1.0) & (x < W)
    dt = flat.dtype

    def tap(yy, xx, w):
        inb = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        yi = torch.clamp(yy, 0, H - 1).long()
        xi = torch.clamp(xx, 0, W - 1).long()
        rows = flat.index_select(0, (base + yi * W + xi).reshape(-1))
        return rows.reshape(*y.shape, -1) * (w * inb.to(dt))[..., None]

    out = (tap(y0, x0, (1 - ly) * (1 - lx))
           + tap(y0, x0 + 1, (1 - ly) * lx)
           + tap(y0 + 1, x0, ly * (1 - lx))
           + tap(y0 + 1, x0 + 1, ly * lx))
    return out * valid.to(dt)[..., None]


def _channels_last(x):
    n, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(n * h * w, c)


@register_emitter("roi_align")
def roi_align(x, boxes, box_indices, output_size=(1, 1), spatial_scale=1.0,
              sampling_ratio=-1, aligned=True):
    """x (N, C, H, W); boxes (R, 4) xyxy; box_indices (R,) image index ->
    (R, C, ph, pw): the mean of sh x sw bilinear samples a bin."""
    ph, pw = output_size
    N, C, H, W = x.shape
    sratio = int(sampling_ratio)
    off = 0.5 if aligned else 0.0
    boxes = boxes.float()
    dev = x.device
    x1 = boxes[:, 0] * spatial_scale - off
    y1 = boxes[:, 1] * spatial_scale - off
    x2 = boxes[:, 2] * spatial_scale - off
    y2 = boxes[:, 3] * spatial_scale - off
    w = x2 - x1
    h = y2 - y1
    if not aligned:
        w = torch.clamp(w, min=1.0)
        h = torch.clamp(h, min=1.0)
    bin_h = (h / ph)[:, None, None]
    bin_w = (w / pw)[:, None, None]
    sh = sw = sratio if sratio > 0 else 2
    ar = torch.arange
    iy = (ar(ph, device=dev)[:, None] * bin_h
          + (ar(sh, device=dev)[None, :] + 0.5) * bin_h / sh
          + y1[:, None, None])                             # (R, ph, sh)
    ix = (ar(pw, device=dev)[:, None] * bin_w
          + (ar(sw, device=dev)[None, :] + 0.5) * bin_w / sw
          + x1[:, None, None])                             # (R, pw, sw)
    R = boxes.shape[0]
    yy = iy[:, :, None, :, None].expand(R, ph, pw, sh, sw)
    xx = ix[:, None, :, None, :].expand(R, ph, pw, sh, sw)
    base = (box_indices.long() * (H * W))[:, None, None, None, None]
    vals = _bilinear_rows(_channels_last(x), base, H, W, yy, xx)
    return vals.mean(dim=(3, 4)).permute(0, 3, 1, 2)


def _quantized_box(boxes, spatial_scale):
    """The boxes' x1, y1, x2, y2 on the feature map, rounded."""
    return torch.round(boxes * spatial_scale).unbind(1)


def _bin_masks(y0, y1, x0, x1, H, W, dev):
    ys = torch.arange(H, dtype=torch.float32, device=dev)
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    ymask = (ys[None, None, :] >= y0[..., None]) & \
        (ys[None, None, :] < y1[..., None])                # (R, ph, H)
    xmask = (xs[None, None, :] >= x0[..., None]) & \
        (xs[None, None, :] < x1[..., None])                # (R, pw, W)
    return ymask[:, :, None, :, None] & xmask[:, None, :, None, :]


@register_emitter("roi_pool")
def roi_pool(x, boxes, box_indices, output_size=(1, 1), spatial_scale=1.0):
    """Max pooling over quantized RoI bins -> (R, C, ph, pw)."""
    ph, pw = output_size
    N, C, H, W = x.shape
    dev = x.device
    boxes = boxes.float()
    x1, y1, x2, y2 = _quantized_box(boxes, spatial_scale)
    h = torch.clamp(y2 - y1 + 1, min=1.0)[:, None]
    w = torch.clamp(x2 - x1 + 1, min=1.0)[:, None]
    ip = torch.arange(ph, device=dev)[None, :]
    jp = torch.arange(pw, device=dev)[None, :]
    mask = _bin_masks(torch.floor(ip * h / ph) + y1[:, None],
                      torch.ceil((ip + 1) * h / ph) + y1[:, None],
                      torch.floor(jp * w / pw) + x1[:, None],
                      torch.ceil((jp + 1) * w / pw) + x1[:, None],
                      H, W, dev)                     # (R, ph, pw, H, W)
    fmap = x[box_indices.long()]                     # (R, C, H, W)
    neg = torch.finfo(x.dtype).min
    masked = torch.where(mask[:, None], fmap[:, :, None, None],
                         torch.full((), neg, dtype=x.dtype, device=dev))
    out = torch.amax(masked, dim=(4, 5))
    return torch.where(mask.any(dim=(3, 4))[:, None], out,
                       torch.zeros((), dtype=x.dtype, device=dev))


@register_emitter("psroi_pool")
def psroi_pool(x, boxes, box_indices, output_size=(1, 1),
               spatial_scale=1.0):
    """Position-sensitive RoI average pooling: C = out_c * ph * pw input
    channels, bin (i, j) pooling its own channel group."""
    ph, pw = output_size
    N, C, H, W = x.shape
    out_c = C // (ph * pw)
    dev = x.device
    boxes = boxes.float()
    x1, y1, x2, y2 = _quantized_box(boxes, spatial_scale)
    h = torch.clamp(y2 - y1, min=0.1)[:, None]
    w = torch.clamp(x2 - x1, min=0.1)[:, None]
    ip = torch.arange(ph, device=dev)[None, :]
    jp = torch.arange(pw, device=dev)[None, :]
    mask = _bin_masks(torch.floor(ip * h / ph + y1[:, None]),
                      torch.ceil((ip + 1) * h / ph + y1[:, None]),
                      torch.floor(jp * w / pw + x1[:, None]),
                      torch.ceil((jp + 1) * w / pw + x1[:, None]),
                      H, W, dev).to(x.dtype)
    area = torch.clamp(mask.sum(dim=(3, 4)), min=1.0)     # (R, ph, pw)
    grouped = x[box_indices.long()].reshape(-1, out_c, ph, pw, H, W)
    summed = torch.einsum("rcijhw,rijhw->rcij", grouped, mask)
    return summed / area[:, None]


@register_emitter("deform_conv2d")
def deform_conv2d(x, offset, weight, mask=None, bias=None, stride=(1, 1),
                  padding=(0, 0), dilation=(1, 1), deformable_groups=1,
                  groups=1):
    """Deformable convolution v1 (v2 with ``mask``): offset-shifted
    bilinear im2col, then one grouped matmul. x (N, Cin, H, W); offset
    (N, 2*dg*kh*kw, Ho, Wo) as (dy, dx) pairs; weight (Cout, Cin/groups,
    kh, kw); mask (N, dg*kh*kw, Ho, Wo)."""
    N, Cin, H, W = x.shape
    Cout, Cin_g, kh, kw = weight.shape
    sh, sw = (stride, stride) if isinstance(stride, int) else stride
    ph_, pw_ = (padding, padding) if isinstance(padding, int) else padding
    dh, dw = (dilation, dilation) if isinstance(dilation, int) else dilation
    Ho = (H + 2 * ph_ - dh * (kh - 1) - 1) // sh + 1
    Wo = (W + 2 * pw_ - dw * (kw - 1) - 1) // sw + 1
    dg = deformable_groups
    cpg = Cin // dg
    K = kh * kw
    dev = x.device
    ar = torch.arange
    gy = ((ar(kh, device=dev) * dh)[:, None, None, None]
          + (ar(Ho, device=dev) * sh - ph_)[None, None, :, None]
          + torch.zeros((1, kw, 1, Wo), device=dev)).reshape(K, Ho, Wo)
    gx = ((ar(kw, device=dev) * dw)[None, :, None, None]
          + (ar(Wo, device=dev) * sw - pw_)[None, None, None, :]
          + torch.zeros((kh, 1, Ho, 1), device=dev)).reshape(K, Ho, Wo)
    off = offset.reshape(N, dg, K, 2, Ho, Wo)
    base = (ar(N, device=dev) * (H * W))[:, None, None, None]
    cols = []
    for g in range(dg):
        flat = _channels_last(x[:, g * cpg:(g + 1) * cpg])
        v = _bilinear_rows(flat, base, H, W, gy + off[:, g, :, 0],
                           gx + off[:, g, :, 1])      # (N, K, Ho, Wo, cpg)
        if mask is not None:
            v = v * mask.reshape(N, dg, K, Ho, Wo)[:, g, ..., None]
        cols.append(v.permute(0, 4, 1, 2, 3))          # (N, cpg, K, Ho, Wo)
    col = torch.cat(cols, dim=1).reshape(N, groups, Cin // groups * K,
                                         Ho * Wo)
    wmat = weight.reshape(groups, Cout // groups, Cin_g * K)
    out = torch.einsum("gok,ngkp->ngop", wmat, col).reshape(N, Cout, Ho, Wo)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


@register_emitter("yolo_loss")
def yolo_loss(x, gt_box, gt_label, gt_score=None, anchors=(),
              anchor_mask=(), class_num=1, ignore_thresh=0.7,
              downsample_ratio=32, use_label_smooth=True, scale_x_y=1.0):
    """YOLOv3 loss per image: coordinate bce / l1, objectness and class
    bce over anchor-matched targets. Targets are one-hot sums over the
    gts (colliding gts add, as in the JAX package)."""
    dev = x.device
    xd = x.float()
    gtb = gt_box.float()                              # (N, B, 4) xywh
    gtl = gt_label.long()                             # (N, B)
    gts = (torch.ones(gtl.shape, dtype=torch.float32, device=dev)
           if gt_score is None else gt_score.float())
    n, c, h, w = xd.shape
    na_all = len(anchors) // 2
    na = len(anchor_mask)
    an_np = np.asarray(anchors, np.float32).reshape(na_all, 2)
    an_all = torch.from_numpy(an_np).to(dev)
    an = torch.from_numpy(an_np[list(anchor_mask)]).to(dev)
    p = xd.reshape(n, na, 5 + class_num, h, w)
    in_sz = h * downsample_ratio
    tx, ty = p[:, :, 0], p[:, :, 1]
    tw, th = p[:, :, 2], p[:, :, 3]
    tobj = p[:, :, 4]
    tcls = p[:, :, 5:]

    gx = gtb[..., 0] * w
    gy = gtb[..., 1] * h
    gw = gtb[..., 2] * in_sz
    gh = gtb[..., 3] * in_sz
    gi = torch.clamp(gx.to(torch.int32), 0, w - 1).long()
    gj = torch.clamp(gy.to(torch.int32), 0, h - 1).long()
    inter = (torch.minimum(gw[..., None], an_all[None, None, :, 0])
             * torch.minimum(gh[..., None], an_all[None, None, :, 1]))
    union = (gw * gh)[..., None] + \
        (an_all[:, 0] * an_all[:, 1])[None, None, :] - inter
    best = torch.argmax(inter / torch.clamp(union, min=1e-9), dim=-1)
    valid = (gtb[..., 2] > 0) & (gtb[..., 3] > 0)

    mask_idx = torch.tensor(list(anchor_mask), dtype=torch.int64,
                            device=dev)
    a_onehot = best[..., None] == mask_idx[None, None, :]
    sel = (valid[..., None] & a_onehot).float()
    cj = tF.one_hot(gj, h).float()
    ci = tF.one_hot(gi, w).float()
    wgt = (sel[:, :, :, None, None] * cj[:, :, None, :, None]
           * ci[:, :, None, None, :])                 # (N, B, na, h, w)
    got = wgt.sum(dim=1)

    def scatter(vals):
        return (vals[:, :, None, None, None] * wgt).sum(dim=1)

    zero = torch.zeros((), device=dev)
    obj = got > 0
    txt = scatter(gx - torch.floor(gx))
    tyt = scatter(gy - torch.floor(gy))
    anchor_w = an[:, 0][None, :, None, None]
    anchor_h = an[:, 1][None, :, None, None]
    twt = scatter(torch.log(torch.clamp(gw, min=1e-9)))
    tht = scatter(torch.log(torch.clamp(gh, min=1e-9)))
    twt = torch.where(obj, twt - torch.log(anchor_w), zero)
    tht = torch.where(obj, tht - torch.log(anchor_h), zero)
    score_t = scatter(gts)
    cls_t = scatter(gtl.float())

    def bce(logit, t):
        return (torch.clamp(logit, min=0) - logit * t
                + torch.log1p(torch.exp(-torch.abs(logit))))

    def bce_p(pr, t, eps=1e-7):
        pr = torch.clamp(pr, eps, 1.0 - eps)
        return -(t * torch.log(pr) + (1.0 - t) * torch.log(1.0 - pr))

    sxy = float(scale_x_y)
    px = torch.sigmoid(tx) * sxy - 0.5 * (sxy - 1.0)
    py = torch.sigmoid(ty) * sxy - 0.5 * (sxy - 1.0)

    scale = 2.0 - scatter(gtb[..., 2] * gtb[..., 3])
    loss_xy = torch.where(obj, (bce_p(px, txt) + bce_p(py, tyt)) * scale,
                          zero)
    loss_wh = torch.where(obj, (torch.abs(tw - twt) + torch.abs(th - tht))
                          * scale * 0.5, zero)
    smooth = 1.0 / max(class_num, 1) if use_label_smooth else 0.0

    # a prediction whose best IoU against any gt passes ignore_thresh
    # takes no negative objectness loss
    gx_rel = (torch.arange(w, dtype=torch.float32, device=dev)[
        None, None, None, :] + px.detach()) / w
    gy_rel = (torch.arange(h, dtype=torch.float32, device=dev)[
        None, None, :, None] + py.detach()) / h
    pw_rel = torch.exp(tw.detach()) * an[:, 0][None, :, None, None] / in_sz
    ph_rel = torch.exp(th.detach()) * an[:, 1][None, :, None, None] / in_sz
    p1x = gx_rel - pw_rel * 0.5
    p1y = gy_rel - ph_rel * 0.5
    p2x = gx_rel + pw_rel * 0.5
    p2y = gy_rel + ph_rel * 0.5
    g1x = gtb[..., 0] - gtb[..., 2] * 0.5
    g1y = gtb[..., 1] - gtb[..., 3] * 0.5
    g2x = gtb[..., 0] + gtb[..., 2] * 0.5
    g2y = gtb[..., 1] + gtb[..., 3] * 0.5
    pa = pw_rel * ph_rel
    best_pred_iou = torch.zeros_like(tobj)
    for b in range(gtb.shape[1]):
        e = (slice(None), b, None, None, None)
        iw = torch.clamp(torch.minimum(p2x, g2x[e]) - torch.maximum(
            p1x, g1x[e]), min=0.0)
        ih = torch.clamp(torch.minimum(p2y, g2y[e]) - torch.maximum(
            p1y, g1y[e]), min=0.0)
        inter_ = iw * ih
        ga = (gtb[:, b, 2] * gtb[:, b, 3])[:, None, None, None]
        iou = inter_ / torch.clamp(pa + ga - inter_, min=1e-9)
        best_pred_iou = torch.maximum(best_pred_iou,
                                      torch.where(valid[e], iou, zero))
    ignore = best_pred_iou > ignore_thresh

    loss_obj = torch.where(
        obj, bce(tobj, torch.ones_like(tobj)) * score_t,
        torch.where(ignore, zero, bce(tobj, torch.zeros_like(tobj))))
    onehot = tF.one_hot(torch.clamp(cls_t, 0, class_num - 1).long(),
                        class_num).float().permute(0, 1, 4, 2, 3)
    onehot = onehot * (1.0 - smooth) + smooth * \
        torch.ones_like(onehot) / class_num
    loss_cls = torch.where(obj[:, :, None], bce(tcls, onehot), zero)
    return (loss_xy.sum(dim=(1, 2, 3)) + loss_wh.sum(dim=(1, 2, 3))
            + loss_obj.sum(dim=(1, 2, 3))
            + loss_cls.sum(dim=(1, 2, 3, 4)))


# ---------------------------------------------------------------------------
# affine_grid / grid_sample
# ---------------------------------------------------------------------------
@register_emitter
def affine_grid(theta, out_shape, align_corners=True):
    """The sampling grid of batched 2x3 (4-D) or 3x4 (5-D) ``theta``."""
    out_shape = [int(s) for s in out_shape]
    dt, dev = theta.dtype, theta.device

    def axis_coords(n):
        if align_corners:
            return torch.linspace(-1.0, 1.0, n, dtype=dt, device=dev) \
                if n > 1 else torch.zeros((1,), dtype=dt, device=dev)
        step = 2.0 / n
        return (torch.arange(n, dtype=dt, device=dev) + 0.5) * step - 1.0

    if theta.dim() == 3 and tuple(theta.shape[1:]) == (2, 3):
        _, _, H, W = out_shape
        gy, gx = torch.meshgrid(axis_coords(H), axis_coords(W),
                                indexing="ij")
        base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
        return torch.einsum("hwk,nik->nhwi", base, theta)
    if theta.dim() == 3 and tuple(theta.shape[1:]) == (3, 4):
        _, _, D, H, W = out_shape
        gz, gy, gx = torch.meshgrid(axis_coords(D), axis_coords(H),
                                    axis_coords(W), indexing="ij")
        base = torch.stack([gx, gy, gz, torch.ones_like(gx)], dim=-1)
        return torch.einsum("dhwk,nik->ndhwi", base, theta)
    raise ValueError(
        f"affine_grid theta must be [N,2,3] or [N,3,4], got "
        f"{tuple(theta.shape)}")


def _gs_unnormalize(coord, size, align_corners):
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _gs_reflect(x, size, align_corners):
    if align_corners:
        if size <= 1:
            return torch.zeros_like(x)
        span = 2.0 * (size - 1)
        x = torch.remainder(torch.abs(x), span)
        return torch.where(x > size - 1, span - x, x)
    span = 2.0 * size
    x = torch.abs(torch.remainder(x + 0.5, span))
    x = torch.where(x > size, span - x, x)
    return torch.clamp(x - 0.5, 0.0, size - 1)


def _gs_resolve(coord, size, padding_mode, align_corners):
    """Unnormalize and apply the padding mode: (coords, in_bounds)."""
    c = _gs_unnormalize(coord, size, align_corners)
    if padding_mode == "border":
        return torch.clamp(c, 0.0, size - 1), None
    if padding_mode == "reflection":
        return _gs_reflect(c, size, align_corners), None
    return c, (c >= -1.0) & (c <= size)


def _gather_flat(x, idx, inb):
    """x (N, C, P) gathered at idx (N, *S) -> (N, C, *S), zero where not
    ``inb``."""
    N, C = x.shape[:2]
    g = torch.gather(x, 2, idx.reshape(N, 1, -1).expand(N, C, -1))
    g = g.reshape(N, C, *idx.shape[1:])
    return torch.where(inb[:, None], g, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


@register_emitter
def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True):
    """Sample ``x`` (N, C, H, W) at the normalized ``grid`` (N, Ho, Wo, 2),
    or 5-D with a (..., 3) grid; modes bilinear / nearest, padding zeros /
    border / reflection."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"mode must be bilinear|nearest, got {mode!r}")
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(
            f"padding_mode must be zeros|border|reflection, got "
            f"{padding_mode!r}")
    if x.dim() not in (4, 5):
        raise ValueError(
            f"grid_sample expects 4-D or 5-D x, got {x.dim()}-D")
    nd = x.dim() - 2
    sizes = list(x.shape[2:])                      # (D,) H, W
    N, C = x.shape[:2]
    flat = x.reshape(N, C, -1)
    coords, valid = [], None
    for a in range(nd):                            # x, y (, z) of the grid
        size = sizes[nd - 1 - a]
        c, v = _gs_resolve(grid[..., a], size, padding_mode, align_corners)
        coords.append(c)
        if v is not None:
            valid = v if valid is None else valid & v
    if valid is None:
        valid = torch.ones(grid.shape[:-1], dtype=torch.bool,
                           device=x.device)

    def gather(ints):
        """ints: integer coords per grid axis (x, y[, z])."""
        inb = valid
        if padding_mode == "zeros":
            for a, i in enumerate(ints):
                size = sizes[nd - 1 - a]
                inb = inb & (i >= 0) & (i < size)
        idx = torch.zeros_like(ints[0])
        for a in reversed(range(nd)):              # z, y, x: row-major
            size = sizes[nd - 1 - a]
            idx = idx * size + torch.clamp(ints[a], 0, size - 1)
        return _gather_flat(flat, idx, inb)

    if mode == "nearest":
        return gather([torch.round(c).long() for c in coords])
    lows = [torch.floor(c) for c in coords]
    fracs = [c - l for c, l in zip(coords, lows)]
    out = 0.0
    for corner in range(2 ** nd):
        bits = [(corner >> (nd - 1 - a)) & 1 for a in range(nd)]
        # the reference sums corners with z outermost, then y, then x
        bits = bits[::-1]
        w = 1.0
        ints = []
        for a in range(nd):
            ints.append((lows[a] + bits[a]).long())
            w = w * (fracs[a] if bits[a] else 1.0 - fracs[a])
        out = out + gather(ints) * w[:, None]
    return out
