"""paddle.vision.ops: detection and vision operators (port of
``paddle_tpu/vision/ops.py``).

Reference: python/paddle/vision/ops.py (yolo_loss:58, yolo_box:266,
prior_box:427, box_coder:573, deform_conv2d:753, DeformConv2D:960,
distribute_fpn_proposals:1156, psroi_pool:1393, roi_pool:1514,
roi_align:1640, ConvNormActivation:1810, nms:1867,
generate_proposals:2038, matrix_nms:2236).

Two halves:

* The differentiable feature ops (``roi_align``, ``roi_pool``,
  ``psroi_pool``, ``deform_conv2d``, ``yolo_loss``) wrap the registry's
  emitters (``ops/vision_ops.py``); the RoI wrappers turn the per-image
  box counts into a flat image index on the host.
* The post-processing (``box_coder``, ``prior_box``, ``yolo_box``,
  ``nms``, ``matrix_nms``, ``generate_proposals``,
  ``distribute_fpn_proposals``) computes in torch on the tensors'
  device; a result whose length depends on the data is selected on the
  host, as in the JAX package. Greedy NMS takes one IoU matrix on the
  device, packs its "suppresses" bits and walks them on the host in
  score order: the JAX package's kept set, without one device step and
  host read per box. Matrix NMS decays every class of an image in one
  batched device computation.

Kept indices are int64 and per-image counts int32, as in the JAX
package.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.nn.layer import Layer

__all__ = [
    "yolo_loss", "yolo_box", "prior_box", "box_coder", "deform_conv2d",
    "DeformConv2D", "distribute_fpn_proposals", "psroi_pool", "PSRoIPool",
    "roi_pool", "RoIPool", "roi_align", "RoIAlign", "nms", "matrix_nms",
    "generate_proposals", "ConvNormActivation", "read_file", "decode_jpeg",
]


def _data(x) -> torch.Tensor:
    """A Tensor's torch tensor; a torch tensor as it is; anything else
    (numpy, lists) on the default place."""
    if isinstance(x, Tensor):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return Tensor(np.asarray(x))._data


def _wrap(d: torch.Tensor) -> Tensor:
    return Tensor._from_data(d)


def _host(x) -> np.ndarray:
    d = x._data if isinstance(x, Tensor) else x
    if isinstance(d, torch.Tensor):
        return d.detach().cpu().numpy()
    return np.asarray(d)


def _boxes_to_flat(boxes, boxes_num):
    """The RoI ops take per-image box counts; the emitters take a flat
    (R,) image index, made on the host and placed beside ``boxes``."""
    bn = _host(boxes_num).astype(np.int64)
    idx = np.repeat(np.arange(len(bn)), bn).astype(np.int32)
    return _wrap(torch.from_numpy(idx).to(_data(boxes).device))


# ---------------------------------------------------------------------------
# RoI family + deformable conv (registry ops)
# ---------------------------------------------------------------------------

def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    from paddle_tpu_torch import ops

    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    idx = _boxes_to_flat(boxes, boxes_num)
    return ops.roi_align(x, boxes, idx, output_size=tuple(output_size),
                         spatial_scale=float(spatial_scale),
                         sampling_ratio=int(sampling_ratio),
                         aligned=bool(aligned))


class RoIAlign(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._output_size = output_size
        self._spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_align(x, boxes, boxes_num, self._output_size,
                         self._spatial_scale)


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
             name=None):
    from paddle_tpu_torch import ops

    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    idx = _boxes_to_flat(boxes, boxes_num)
    return ops.roi_pool(x, boxes, idx, output_size=tuple(output_size),
                        spatial_scale=float(spatial_scale))


class RoIPool(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._output_size = output_size
        self._spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self._output_size,
                        self._spatial_scale)


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
               name=None):
    from paddle_tpu_torch import ops

    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    idx = _boxes_to_flat(boxes, boxes_num)
    return ops.psroi_pool(x, boxes, idx, output_size=tuple(output_size),
                          spatial_scale=float(spatial_scale))


class PSRoIPool(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._output_size = output_size
        self._spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return psroi_pool(x, boxes, boxes_num, self._output_size,
                          self._spatial_scale)


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    from paddle_tpu_torch import ops

    return ops.deform_conv2d(x, offset, weight, mask, bias,
                             stride=stride, padding=padding,
                             dilation=dilation,
                             deformable_groups=deformable_groups,
                             groups=groups)


class DeformConv2D(Layer):
    """Deformable conv layer (reference vision/ops.py:960). v1 when
    forward gets no mask, v2 (modulated) with one."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        from paddle_tpu_torch.nn.initializer import Uniform

        if isinstance(kernel_size, int):
            kernel_size = (kernel_size, kernel_size)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._deformable_groups = deformable_groups
        self._groups = groups
        fan_in = in_channels * kernel_size[0] * kernel_size[1] // groups
        bound = 1.0 / math.sqrt(fan_in)
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, *kernel_size],
            default_initializer=Uniform(-bound, bound))
        if bias_attr is not False:
            self.bias = self.create_parameter([out_channels], is_bias=True)
        else:
            self.bias = None

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, self.bias,
                             stride=self._stride, padding=self._padding,
                             dilation=self._dilation,
                             deformable_groups=self._deformable_groups,
                             groups=self._groups, mask=mask)


# ---------------------------------------------------------------------------
# box codecs / anchors
# ---------------------------------------------------------------------------

def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              axis=0, name=None):
    """Encode/decode boxes against anchors (reference vision/ops.py:573,
    phi/kernels/gpu/box_coder_kernel.cu)."""
    pb = _data(prior_box).float()
    dev = pb.device
    tb = _data(target_box).float().to(dev)
    if prior_box_var is None:
        pbv = torch.ones((4,), device=dev)
    elif isinstance(prior_box_var, (list, tuple)):
        pbv = torch.tensor(prior_box_var, dtype=torch.float32, device=dev)
    else:
        pbv = _data(prior_box_var).float().to(dev)
    norm = 0.0 if box_normalized else 1.0

    pw = pb[:, 2] - pb[:, 0] + norm
    ph = pb[:, 3] - pb[:, 1] + norm
    pcx = pb[:, 0] + pw * 0.5
    pcy = pb[:, 1] + ph * 0.5

    if code_type == "encode_center_size":
        # tb: (M, 4) targets vs each prior: out (M, N, 4)
        tw = tb[:, 2] - tb[:, 0] + norm
        th = tb[:, 3] - tb[:, 1] + norm
        tcx = tb[:, 0] + tw * 0.5
        tcy = tb[:, 1] + th * 0.5
        dx = (tcx[:, None] - pcx[None, :]) / pw[None, :]
        dy = (tcy[:, None] - pcy[None, :]) / ph[None, :]
        dw = torch.log(torch.abs(tw[:, None] / pw[None, :]))
        dh = torch.log(torch.abs(th[:, None] / ph[None, :]))
        out = torch.stack([dx, dy, dw, dh], dim=-1)
        out = out / (pbv.reshape(1, -1, 4) if pbv.dim() == 2
                     else pbv.reshape(1, 1, 4))
        return _wrap(out)
    if code_type == "decode_center_size":
        # tb: (N, M, 4) deltas; priors broadcast along `axis`
        if pbv.dim() == 2:
            var = pbv[:, None, :] if axis == 0 else pbv[None, :, :]
        else:
            var = pbv.reshape(1, 1, 4)
        if axis == 0:
            pw_, ph_, pcx_, pcy_ = (pw[:, None], ph[:, None],
                                    pcx[:, None], pcy[:, None])
        else:
            pw_, ph_, pcx_, pcy_ = (pw[None, :], ph[None, :],
                                    pcx[None, :], pcy[None, :])
        d = tb * var
        ocx = d[..., 0] * pw_ + pcx_
        ocy = d[..., 1] * ph_ + pcy_
        ow = torch.exp(d[..., 2]) * pw_
        oh = torch.exp(d[..., 3]) * ph_
        out = torch.stack([ocx - ow * 0.5, ocy - oh * 0.5,
                           ocx + ow * 0.5 - norm, ocy + oh * 0.5 - norm],
                          dim=-1)
        return _wrap(out)
    raise ValueError(f"unknown code_type {code_type!r}")


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, min_max_aspect_ratios_order=False,
              name=None):
    """SSD prior (anchor) boxes (reference vision/ops.py:427). The anchor
    geometry depends on shapes alone: numpy on the host, one copy to the
    input's device."""
    x = _data(input)
    _, _, fh, fw = x.shape
    _, _, ih, iw = _data(image).shape
    ars = [1.0]
    for ar in aspect_ratios:
        if not any(abs(ar - e) < 1e-6 for e in ars):
            ars.append(float(ar))
            if flip:
                ars.append(1.0 / float(ar))
    step_w = steps[0] or iw / fw
    step_h = steps[1] or ih / fh
    boxes = []
    vars_ = []
    for y in range(fh):
        for xx in range(fw):
            cx = (xx + offset) * step_w
            cy = (y + offset) * step_h
            cell = []
            for k, ms in enumerate(min_sizes):
                ms = float(ms)
                if min_max_aspect_ratios_order:
                    cell.append((cx, cy, ms, ms))
                    if max_sizes:
                        sq = np.sqrt(ms * float(max_sizes[k]))
                        cell.append((cx, cy, sq, sq))
                    for ar in ars:
                        if abs(ar - 1.0) < 1e-6:
                            continue
                        cell.append((cx, cy, ms * np.sqrt(ar),
                                     ms / np.sqrt(ar)))
                else:
                    for ar in ars:
                        cell.append((cx, cy, ms * np.sqrt(ar),
                                     ms / np.sqrt(ar)))
                    if max_sizes:
                        sq = np.sqrt(ms * float(max_sizes[k]))
                        cell.append((cx, cy, sq, sq))
            for (ccx, ccy, w, h) in cell:
                boxes.append(((ccx - w / 2) / iw, (ccy - h / 2) / ih,
                              (ccx + w / 2) / iw, (ccy + h / 2) / ih))
                vars_.append(variance)
    n_per_cell = len(boxes) // (fh * fw)
    b = np.asarray(boxes, np.float32).reshape(fh, fw, n_per_cell, 4)
    if clip:
        b = np.clip(b, 0.0, 1.0)
    v = np.asarray(vars_, np.float32).reshape(fh, fw, n_per_cell, 4)
    return (_wrap(torch.from_numpy(b).to(x.device)),
            _wrap(torch.from_numpy(v).to(x.device)))


# ---------------------------------------------------------------------------
# YOLO head
# ---------------------------------------------------------------------------

def _yolo_grid(x, anchors, class_num, downsample_ratio, scale_x_y):
    n, c, h, w = x.shape
    na = len(anchors) // 2
    an = torch.tensor(np.asarray(anchors, np.float32).reshape(na, 2),
                      device=x.device)
    p = x.reshape(n, na, 5 + class_num, h, w)
    gx = torch.arange(w, dtype=torch.float32, device=x.device)[
        None, None, None, :]
    gy = torch.arange(h, dtype=torch.float32, device=x.device)[
        None, None, :, None]
    bx = (torch.sigmoid(p[:, :, 0]) * scale_x_y
          - 0.5 * (scale_x_y - 1.0) + gx) / w
    by = (torch.sigmoid(p[:, :, 1]) * scale_x_y
          - 0.5 * (scale_x_y - 1.0) + gy) / h
    bw = torch.exp(p[:, :, 2]) * an[None, :, 0, None, None] / (
        w * downsample_ratio)
    bh = torch.exp(p[:, :, 3]) * an[None, :, 1, None, None] / (
        h * downsample_ratio)
    conf = torch.sigmoid(p[:, :, 4])
    cls = torch.sigmoid(p[:, :, 5:])
    return bx, by, bw, bh, conf, cls


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, clip_bbox=True, name=None, scale_x_y=1.0,
             iou_aware=False, iou_aware_factor=0.5):
    """Decode a YOLOv3 head into boxes and scores (reference
    vision/ops.py:266). Fixed-size outputs: a box under ``conf_thresh``
    is zeroed, not dropped."""
    xd = _data(x).float()
    imgs = _data(img_size).float().to(xd.device)
    if iou_aware:
        na = len(anchors) // 2
        ioup = torch.sigmoid(xd[:, :na])
        xd = xd[:, na:]
    bx, by, bw, bh, conf, cls = _yolo_grid(
        xd, anchors, class_num, downsample_ratio, scale_x_y)
    if iou_aware:
        conf = conf ** (1.0 - iou_aware_factor) * \
            ioup ** iou_aware_factor
    n, na, h, w = conf.shape
    ih = imgs[:, 0].reshape(n, 1, 1, 1)
    iw = imgs[:, 1].reshape(n, 1, 1, 1)
    x1 = (bx - bw * 0.5) * iw
    y1 = (by - bh * 0.5) * ih
    x2 = (bx + bw * 0.5) * iw
    y2 = (by + bh * 0.5) * ih
    if clip_bbox:
        zero = torch.zeros((), device=xd.device)
        x1 = torch.minimum(torch.maximum(x1, zero), iw - 1)
        y1 = torch.minimum(torch.maximum(y1, zero), ih - 1)
        x2 = torch.minimum(torch.maximum(x2, zero), iw - 1)
        y2 = torch.minimum(torch.maximum(y2, zero), ih - 1)
    keep = (conf > conf_thresh).float()
    boxes = torch.stack([x1, y1, x2, y2], dim=-1) * keep[..., None]
    scores = cls * (conf * keep)[:, :, None]
    boxes = boxes.permute(0, 1, 3, 4, 2).reshape(n, na * h * w, 4)
    scores = scores.permute(0, 1, 3, 4, 2).reshape(n, na * h * w,
                                                   class_num)
    return _wrap(boxes), _wrap(scores)


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """YOLOv3 training loss (reference vision/ops.py:58), through the
    registry, so autograd records it."""
    from paddle_tpu_torch import ops

    return ops.yolo_loss(x, gt_box, gt_label, gt_score,
                         anchors=tuple(anchors),
                         anchor_mask=tuple(anchor_mask),
                         class_num=int(class_num),
                         ignore_thresh=float(ignore_thresh),
                         downsample_ratio=int(downsample_ratio),
                         use_label_smooth=bool(use_label_smooth),
                         scale_x_y=float(scale_x_y))


# ---------------------------------------------------------------------------
# the NMS family (variable-length outputs)
# ---------------------------------------------------------------------------

def _iou_matrix(boxes):
    """IoU of every pair of (..., R, 4) xyxy boxes -> (..., R, R)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)
    iw = (torch.minimum(x2[..., :, None], x2[..., None, :])
          - torch.maximum(x1[..., :, None], x1[..., None, :])).clamp_min(0)
    ih = (torch.minimum(y2[..., :, None], y2[..., None, :])
          - torch.maximum(y1[..., :, None], y1[..., None, :])).clamp_min(0)
    inter = iw * ih
    return inter / (area[..., :, None] + area[..., None, :] - inter
                    ).clamp_min(1e-10)


def _nms_keep_mask(boxes, iou_threshold) -> np.ndarray:
    """Greedy NMS over ``boxes`` sorted by descending score -> a (R,)
    bool keep mask on the host. The device computes which box suppresses
    which (IoU above the threshold, later boxes only) and packs those
    bits, R/8 bytes a box; the host walks them in order, OR-ing in the
    row of each box it keeps: box i is kept unless a kept box before it
    suppresses it, the JAX package's loop."""
    r = boxes.shape[0]
    keep = np.zeros(r, bool)
    if r == 0:
        return keep
    over = torch.triu(_iou_matrix(boxes) > iou_threshold, diagonal=1)
    rows = np.packbits(over.cpu().numpy(), axis=1, bitorder="little")
    removed = 0
    for i in range(r):
        if not (removed >> i) & 1:
            keep[i] = True
            removed |= int.from_bytes(rows[i].tobytes(), "little")
    return keep


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """Greedy, optionally per-category, NMS (reference
    vision/ops.py:1867): the kept boxes' indices, by descending score
    (int64, on the boxes' device)."""
    bd = _data(boxes).float()
    dev = bd.device
    if scores is None:
        keep = _nms_keep_mask(bd, iou_threshold)
        return _wrap(torch.from_numpy(np.nonzero(keep)[0].astype(np.int64))
                     .to(dev))
    sd = _data(scores).float().to(dev)
    order = torch.argsort(-sd, stable=True)
    if category_idxs is not None:
        # per category: boxes shifted by category so that boxes of two
        # categories never overlap (the batched-NMS trick)
        cd = _data(category_idxs).float().to(dev)
        span = (bd.max() - bd.min()) + 1.0
        bd_off = bd + (cd * span)[:, None]
    else:
        bd_off = bd
    keep_sorted = _nms_keep_mask(bd_off[order], iou_threshold)
    kept = order.cpu().numpy()[keep_sorted]
    if top_k is not None:
        kept = kept[:top_k]
    return _wrap(torch.from_numpy(kept.astype(np.int64)).to(dev))


def matrix_nms(bboxes, scores, score_threshold, post_threshold=0.,
               nms_top_k=400, keep_top_k=200, use_gaussian=False,
               gaussian_sigma=2., background_label=0, normalized=True,
               return_index=False, return_rois_num=True, name=None):
    """Matrix NMS (reference vision/ops.py:2236; the SOLOv2 paper): each
    score decays by its IoU with the higher-scored boxes of its class,
    each suppressor compensated by its own largest overlap above it. One
    image's classes decay together on the device: per class the
    ``nms_top_k`` best scores above ``score_threshold``, their IoU
    matrix, the decay; then the host keeps those at or above
    ``post_threshold`` and the ``keep_top_k`` best of the image."""
    bd = _data(bboxes).float()                  # (N, M, 4)
    dev = bd.device
    sd = _data(scores).float().to(dev)          # (N, C, M)
    n, c, m = sd.shape
    classes = [ci for ci in range(c) if ci != background_label]
    cls_t = torch.tensor(classes, dtype=torch.int64, device=dev)
    k = min(int(nms_top_k), m) if nms_top_k >= 0 else m
    outs, idxs, nums = [], [], []
    for b in range(n):
        s = sd[b].index_select(0, cls_t)                   # (C', M)
        valid_all = s > score_threshold
        top, sel = torch.where(valid_all, s, float("-inf")).topk(
            k, dim=1, sorted=True)
        # a class's first ``[:nms_top_k]`` of its scores above the
        # threshold, as a Python slice takes them (-1: all but the last)
        cnt = valid_all.sum(dim=1, keepdim=True)
        limit = cnt.clamp_max(nms_top_k) if nms_top_k >= 0 else \
            (cnt + nms_top_k).clamp_min(0)
        valid = torch.arange(k, device=dev)[None, :] < limit  # (C', K)
        bx = bd[b][sel]                                    # (C', K, 4)
        iou = _iou_matrix(bx) * (valid[:, :, None] & valid[:, None, :])
        iou = torch.triu(iou, diagonal=1)  # [i, j]: box j vs higher i
        comp = iou.max(dim=1).values       # each box's largest overlap
        if use_gaussian:
            decay = torch.exp(-(iou ** 2 - comp[:, :, None] ** 2)
                              / gaussian_sigma).min(dim=1).values
        else:
            decay = ((1 - iou) / (1 - comp[:, :, None]).clamp_min(1e-10)
                     ).min(dim=1).values
        dec = torch.where(valid, s.gather(1, sel) * decay,
                          torch.zeros((), device=dev))
        keep = valid & (dec >= post_threshold)
        keep_h, sel_h, dec_h = (t.cpu().numpy() for t in (keep, sel, dec))
        ci_h, ki_h = np.nonzero(keep_h)        # class-major, score order
        box_ids = sel_h[ci_h, ki_h]
        flat_scores = dec_h[ci_h, ki_h]
        cls_ids = np.asarray(classes, np.int64)[ci_h]
        order = np.argsort(-flat_scores) if len(flat_scores) \
            else np.array([], np.int64)
        order = order[:keep_top_k]
        picked = torch.from_numpy(box_ids[order].astype(np.int64)).to(dev)
        rows = torch.cat([
            torch.from_numpy(np.stack([cls_ids[order].astype(np.float32),
                                       flat_scores[order]], axis=1)
                             .reshape(-1, 2)).to(dev),
            bd[b][picked]], dim=1)
        outs.append(rows)
        idxs.append(b * m + box_ids[order].astype(np.int64))
        nums.append(len(order))
    out = _wrap(torch.cat(outs, dim=0) if outs
                else torch.zeros((0, 6), device=dev))
    ret = [out]
    if return_index:
        ret.append(_wrap(torch.from_numpy(
            np.concatenate(idxs) if idxs else np.zeros(0, np.int64))
            .to(dev)))
    if return_rois_num:
        ret.append(_wrap(torch.tensor(nums, dtype=torch.int32,
                                      device=dev)))
    return tuple(ret) if len(ret) > 1 else out


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=False, return_rois_num=False,
                       name=None):
    """RPN proposals (reference vision/ops.py:2038), per image: the
    ``pre_nms_top_n`` best anchors decoded from their deltas, clipped to
    the image, those under ``min_size`` dropped, greedy NMS, the first
    ``post_nms_top_n`` kept."""
    sd = _data(scores).float()                 # (N, A, H, W)
    dev = sd.device
    dd = _data(bbox_deltas).float().to(dev)    # (N, 4A, H, W)
    iszs = _host(img_size)                     # (N, 2) (h, w)
    an = _data(anchors).float().to(dev).reshape(-1, 4)
    va = _data(variances).float().to(dev).reshape(-1, 4)
    n, _, fh, fw = sd.shape
    offset = 1.0 if pixel_offset else 0.0
    all_rois, all_scores, nums = [], [], []
    for b in range(n):
        s = sd[b].permute(1, 2, 0).reshape(-1)
        d = dd[b].reshape(-1, 4, fh, fw).permute(2, 3, 0, 1).reshape(-1, 4)
        order = torch.argsort(-s, stable=True)[:pre_nms_top_n]
        s, d, a, v = s[order], d[order], an[order], va[order]
        aw = a[:, 2] - a[:, 0] + offset
        ah = a[:, 3] - a[:, 1] + offset
        acx = a[:, 0] + aw * 0.5
        acy = a[:, 1] + ah * 0.5
        cx = v[:, 0] * d[:, 0] * aw + acx
        cy = v[:, 1] * d[:, 1] * ah + acy
        w = torch.exp(torch.clamp_max(v[:, 2] * d[:, 2], 10.0)) * aw
        h = torch.exp(torch.clamp_max(v[:, 3] * d[:, 3], 10.0)) * ah
        ih, iw = float(iszs[b][0]), float(iszs[b][1])
        props = torch.stack([
            (cx - w * 0.5).clamp(0, iw - offset),
            (cy - h * 0.5).clamp(0, ih - offset),
            (cx + w * 0.5 - offset).clamp(0, iw - offset),
            (cy + h * 0.5 - offset).clamp(0, ih - offset)], dim=1)
        ws = props[:, 2] - props[:, 0] + offset
        hs = props[:, 3] - props[:, 1] + offset
        big = torch.nonzero((ws >= min_size) & (hs >= min_size)
                            ).squeeze(1)
        props, s = props[big], s[big]
        if props.shape[0]:
            km = _nms_keep_mask(props, nms_thresh)
            sel = torch.from_numpy(
                np.nonzero(km)[0][:post_nms_top_n]).to(dev)
            props, s = props[sel], s[sel]
        all_rois.append(props)
        all_scores.append(s)
        nums.append(props.shape[0])
    rois = _wrap(torch.cat(all_rois, dim=0))
    rscores = _wrap(torch.cat(all_scores, dim=0))
    if return_rois_num:
        return rois, rscores, _wrap(torch.tensor(nums, dtype=torch.int32,
                                                 device=dev))
    return rois, rscores


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False,
                             rois_num=None, name=None):
    """Route RoIs to FPN levels by scale (reference vision/ops.py:1156):
    the levels on the device, the variable-size split on the host. Also
    the index that restores the input order, (R, 1) int64."""
    rois = _data(fpn_rois).float()
    dev = rois.device
    offset = 1.0 if pixel_offset else 0.0
    w = rois[:, 2] - rois[:, 0] + offset
    h = rois[:, 3] - rois[:, 1] + offset
    scale = torch.sqrt((w * h).clamp_min(0.0))
    lvl = torch.floor(torch.log2(scale / refer_scale + 1e-8)) + refer_level
    lvl = lvl.clamp(min_level, max_level).to(torch.int64).cpu().numpy()
    n_levels = max_level - min_level + 1
    outs, order = [], []
    for li in range(n_levels):
        idx = np.nonzero(lvl == min_level + li)[0]
        outs.append(_wrap(rois[torch.from_numpy(idx).to(dev)]))
        order.extend(idx.tolist())
    restore_idx = np.empty(len(order), np.int64)
    restore_idx[np.asarray(order, np.int64)] = np.arange(len(order))
    restore = _wrap(torch.from_numpy(restore_idx.reshape(-1, 1)).to(dev))
    if rois_num is None:
        return outs, restore
    rn = _host(rois_num)
    img_of = np.repeat(np.arange(len(rn)), rn)
    per_level = [
        _wrap(torch.from_numpy(np.bincount(
            img_of[lvl == min_level + li],
            minlength=len(rn)).astype(np.int32)).to(dev))
        for li in range(n_levels)]
    return outs, restore, per_level


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------

class ConvNormActivation(object):
    """Conv2D + Norm + Activation block (reference vision/ops.py:1810).
    Returns an nn.Sequential."""

    def __new__(cls, in_channels, out_channels, kernel_size=3, stride=1,
                padding=None, groups=1, norm_layer=None,
                activation_layer=None, dilation=1, bias=None):
        from paddle_tpu_torch import nn

        if padding is None:
            padding = (kernel_size - 1) // 2 * dilation
        if norm_layer is None:
            norm_layer = nn.BatchNorm2D
        if activation_layer is None:
            activation_layer = nn.ReLU
        if bias is None:
            bias = norm_layer is None
        layers = [nn.Conv2D(in_channels, out_channels, kernel_size,
                            stride, padding, dilation=dilation,
                            groups=groups,
                            bias_attr=None if bias else False)]
        if norm_layer is not None:
            layers.append(norm_layer(out_channels))
        if activation_layer is not None:
            layers.append(activation_layer())
        return nn.Sequential(*layers)


def read_file(filename, name=None):
    """Raw file bytes as a uint8 tensor (reference vision/ops.py:1301)."""
    with open(filename, "rb") as f:
        raw = np.frombuffer(f.read(), np.uint8)
    return Tensor(raw.copy())


def decode_jpeg(x, mode="unchanged", name=None):
    """JPEG decode (reference vision/ops.py:1344, nvjpeg-backed), on the
    host through Pillow; without Pillow it raises as the JAX package
    does."""
    try:
        from PIL import Image
    except ImportError as e:
        raise NotImplementedError(
            "decode_jpeg needs Pillow on the host (the reference uses "
            "nvjpeg, which has no TPU analog); install pillow or decode "
            "in the input pipeline") from e
    import io as _io

    raw = bytes(_host(x).astype(np.uint8))
    img = Image.open(_io.BytesIO(raw))
    if mode == "gray":
        img = img.convert("L")
    elif mode == "rgb":
        img = img.convert("RGB")
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[None]
    else:
        arr = arr.transpose(2, 0, 1)
    return Tensor(np.ascontiguousarray(arr))
