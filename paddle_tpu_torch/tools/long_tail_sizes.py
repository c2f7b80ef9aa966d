"""The long tail's heavy ops at the sizes their published models use, for
``chip_smoke.py`` phase 24: each workload builds its inputs from a seeded
CPU generator (so the card and the CPU get the same numbers at the
reduced batch the CPU check uses), runs the op through the port's Tensor
API, and backpropagates a fixed cotangent.

* ``ctc``: DeepSpeech2 on LibriSpeech: logits [800 frames, B, 29
  characters], labels of 150-250 characters, ``F.ctc_loss`` (mean);
  B 32, checked at 4.
* ``rnnt``: an RNN-T joint output [B, T 200, U 51, V 1024] (a 1024-piece
  vocabulary), ``F.rnnt_loss`` with FastEmit 0.001; B 8, checked at 1.
* ``roi_align``: Mask R-CNN R50-FPN's P2 level: features [N, 256, 200,
  336] (an 800 x 1344 image at stride 4), 512 boxes an image of 16-112
  pixels, 7 x 7 bins, sampling ratio 2, aligned; N 2, checked at 1.
* ``deform_conv2d``: a DCNv2 3 x 3 layer with its mask, [N, 256, 100,
  168] -> 256 channels (stride-8 features of an 800 x 1344 image); N 2,
  checked at 1.
* ``grid_sample``: a spatial transformer's sampler: ``affine_grid`` of
  [N, 2, 3] thetas near the identity and ``grid_sample`` (bilinear,
  zeros) of [N, 3, 224, 224] images; N 32, checked at 4.
* ``yolo_loss``: YOLOv3's stride-8 head on a 608 x 608 image: [N, 255,
  76, 76] (3 anchors x (5 + 80 classes)), 50 boxes an image; N 8,
  checked at 2.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["WORKLOADS", "TOL", "forward_backward", "numpy"]

COCO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                156, 198, 373, 326]


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _t(P, x, place, grad=False):
    return P.to_tensor(x, place=place, stop_gradient=not grad)


def _ctc(n, place):
    import paddle_tpu_torch as P

    g = _gen(1)
    T, C, L = 800, 29, 250
    logits = torch.randn((T, n, C), generator=g)
    labels = torch.randint(1, C, (n, L), generator=g)
    ll = torch.randint(150, L + 1, (n,), generator=g)
    il = T - torch.randint(0, 100, (n,), generator=g)
    x = _t(P, logits, place, True)
    args = (x, _t(P, labels, place), _t(P, il, place), _t(P, ll, place))
    return {"fn": lambda: P.nn.functional.ctc_loss(*args),
            "leaves": {"logits": x}, "cot": None}


def _rnnt(n, place):
    import paddle_tpu_torch as P

    g = _gen(2)
    T, U, V = 200, 50, 1024
    logits = torch.randn((n, T, U + 1, V), generator=g)
    labels = torch.randint(1, V, (n, U), generator=g)
    il = T - torch.randint(0, 40, (n,), generator=g)
    ll = torch.randint(30, U + 1, (n,), generator=g)
    il[0], ll[0] = T, U
    x = _t(P, logits, place, True)
    args = (x, _t(P, labels, place), _t(P, il, place), _t(P, ll, place))
    return {"fn": lambda: P.nn.functional.rnnt_loss(
        *args, fastemit_lambda=0.001), "leaves": {"logits": x}, "cot": None}


def _roi_align(n, place):
    import paddle_tpu_torch as P

    g = _gen(3)
    per = 512
    feats = torch.randn((n, 256, 200, 336), generator=g)
    wh = 16 + 96 * torch.rand((n * per, 2), generator=g)
    xy = torch.rand((n * per, 2), generator=g) * (
        torch.tensor([1344.0, 800.0]) - wh)
    boxes = torch.cat([xy, xy + wh], dim=1)
    idx = torch.arange(n).repeat_interleave(per)
    cot = torch.randn((n * per, 256, 7, 7), generator=g)
    x = _t(P, feats, place, True)
    args = (x, _t(P, boxes, place), _t(P, idx, place))
    return {"fn": lambda: P.roi_align(*args, output_size=(7, 7),
                                      spatial_scale=0.25, sampling_ratio=2,
                                      aligned=True),
            "leaves": {"x": x}, "cot": _t(P, cot, place)}


def _deform(n, place):
    import paddle_tpu_torch as P

    g = _gen(4)
    H, W = 100, 168
    x = torch.randn((n, 256, H, W), generator=g)
    off = 2.0 * torch.randn((n, 18, H, W), generator=g)
    mask = torch.sigmoid(torch.randn((n, 9, H, W), generator=g))
    w = 0.02 * torch.randn((256, 256, 3, 3), generator=g)
    b = 0.1 * torch.randn((256,), generator=g)
    cot = torch.randn((n, 256, H, W), generator=g)
    xt, ot, wt, mt = (_t(P, a, place, True) for a in (x, off, w, mask))
    bt = _t(P, b, place, True)
    return {"fn": lambda: P.deform_conv2d(xt, ot, wt, mt, bt,
                                          padding=(1, 1)),
            "leaves": {"x": xt, "offset": ot, "weight": wt, "mask": mt},
            "cot": _t(P, cot, place)}


def _grid(n, place):
    import paddle_tpu_torch as P

    g = _gen(5)
    x = torch.randn((n, 3, 224, 224), generator=g)
    theta = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]) + \
        0.1 * torch.randn((n, 2, 3), generator=g)
    cot = torch.randn((n, 3, 224, 224), generator=g)
    xt, tt = _t(P, x, place, True), _t(P, theta, place, True)
    F = P.nn.functional

    def fn():
        grid = F.affine_grid(tt, [n, 3, 224, 224], align_corners=False)
        return F.grid_sample(xt, grid, align_corners=False)

    return {"fn": fn, "leaves": {"x": xt, "theta": tt},
            "cot": _t(P, cot, place)}


def _yolo(n, place):
    import paddle_tpu_torch as P

    g = _gen(6)
    B = 50
    x = 0.5 * torch.randn((n, 255, 76, 76), generator=g)
    xy = 0.05 + 0.9 * torch.rand((n, B, 2), generator=g)
    wh = 0.01 + 0.29 * torch.rand((n, B, 2), generator=g)
    lab = torch.randint(0, 80, (n, B), generator=g)
    xt = _t(P, x, place, True)
    args = (xt, _t(P, torch.cat([xy, wh], -1), place), _t(P, lab, place))
    return {"fn": lambda: P.yolo_loss(*args, anchors=COCO_ANCHORS,
                                      anchor_mask=[0, 1, 2], class_num=80,
                                      ignore_thresh=0.7,
                                      downsample_ratio=8),
            "leaves": {"x": xt}, "cot": None}


# name -> builder, full batch, the CPU check's batch, and the check's
# tolerance (rtol, atol as a share of the CPU's largest magnitude)
TOL = (1e-4, 1e-4)
WORKLOADS = {
    # torch's CTC kernels on the card and on the CPU add 800 frames of
    # log-space terms in another order: gradient entries up to 5e-4 of
    # the largest one apart (an H100 against the CPU at batch 4)
    "ctc": {"make": _ctc, "full": 32, "check": 4, "tol": (1e-4, 1e-3)},
    "rnnt": {"make": _rnnt, "full": 8, "check": 1},
    "roi_align": {"make": _roi_align, "full": 2, "check": 1},
    "deform_conv2d": {"make": _deform, "full": 2, "check": 1},
    "grid_sample": {"make": _grid, "full": 32, "check": 4},
    "yolo_loss": {"make": _yolo, "full": 8, "check": 2},
}


def forward_backward(w):
    """One forward and backward: {"out": ..., "grad_<leaf>": ...} as
    Tensors (gradients accumulate across calls)."""
    out = w["fn"]()
    loss = out.sum() if w["cot"] is None else (out * w["cot"]).sum()
    loss.backward()
    return {"out": out, **{f"grad_{k}": t.grad
                           for k, t in w["leaves"].items()}}


def numpy(res):
    return {k: np.asarray(v.numpy()) for k, v in res.items()}
