"""The cases of the manifest's vision, long-tail and nn long tail
sections: one or more per entry, each tagged with its section. Two
drivers read this table: the op parity sweep on the CPU
(``tests/test_torch_ops_cases.py``, each case through the JAX package and
the port) and ``chip_smoke.py`` phase 24 (each case through the port on
the card and on the CPU, :func:`run_case`).

A case is ``make(rng) -> (args, kwargs)``; numpy arrays among them become
Tensors (float32 ones differentiable for an op with ``diff: true``), and
``post(P, outs)`` maps the outputs to what is compared. ``tol`` is
(rtol, atol) for the values; the gradients of a seeded cotangent are
held at (max(rtol, 1e-5), max(atol, 1e-5)), as the sweep holds them.
"""
from __future__ import annotations

import zlib

import numpy as np

__all__ = ["CASES", "VISION", "LONG_TAIL", "NN_TAIL", "run_case",
           "card_tol", "compare", "NAN_GRAD_BY_ROUNDING"]


class Case:
    def __init__(self, op, make, grad=True, post=None, name=None, tol=None):
        self.op = op
        self.make = make
        self.grad = grad
        self.post = post
        self.id = name or op
        self.tol = tol


CASES = []
SECTION = None


def add(op, make, **kw):
    case = Case(op, make, **kw)
    case.section = SECTION
    CASES.append(case)


def f(rng, *shape, lo=None, hi=None):
    if lo is None:
        return rng.standard_normal(shape).astype(np.float32)
    return rng.uniform(lo, hi, shape).astype(np.float32)


def pos(rng, *shape):
    return f(rng, *shape, lo=0.5, hi=2.0)


def ints(rng, lo, hi, *shape):
    return rng.integers(lo, hi, shape).astype(np.int64)


def X(fn, **kw):
    """args from a function of rng."""
    return lambda rng: (fn(rng), kw)

VISION = "vision (RoI family + deformable conv; emitters in vision_ops.py)"
LONG_TAIL = "long-tail surface (emitters in extras.py)"
NN_TAIL = "nn long tail (emitters in nn_extras.py)"


def _boxes(r, n, h, w):
    """n xyxy boxes inside an h x w image."""
    x1 = r.uniform(0, w * 0.6, n)
    y1 = r.uniform(0, h * 0.6, n)
    return np.stack([x1, y1, x1 + r.uniform(1.5, w * 0.4, n),
                     y1 + r.uniform(1.5, h * 0.4, n)], 1).astype(np.float32)


def _pool_indices(r, n, c, out, k, size):
    """max-pool argmax positions: one position inside each output cell's
    window, flattened over the input plane ``size``."""
    nd = len(out)
    grids = np.meshgrid(*[np.arange(o) for o in out], indexing="ij")
    flat = np.zeros((n, c) + tuple(out), np.int64)
    for i in range(nd):
        pos = grids[i] * k + r.integers(0, k, (n, c) + tuple(out))
        flat = flat * size[i] + pos
    return flat


def _bool_post(fn):
    return lambda P, outs: [fn(P, outs[0])]


SECTION = VISION
add("affine_grid", X(lambda r: [f(r, 2, 2, 3), [2, 3, 4, 5]]))
add("affine_grid", X(lambda r: [f(r, 2, 2, 3), [2, 3, 4, 5]],
                     align_corners=False), name="affine_grid_half_pixel")
add("affine_grid", X(lambda r: [f(r, 1, 3, 4), [1, 1, 2, 3, 4]]),
    name="affine_grid_3d")
for _mode, _pad, _ac in (("bilinear", "zeros", True),
                         ("nearest", "zeros", True),
                         ("bilinear", "border", False),
                         ("bilinear", "reflection", False),
                         ("bilinear", "reflection", True)):
    add("grid_sample", X(lambda r: [f(r, 2, 3, 5, 6),
                                    f(r, 2, 4, 3, 2, lo=-1.2, hi=1.2)],
                         mode=_mode, padding_mode=_pad, align_corners=_ac),
        name=f"grid_sample_{_mode}_{_pad}_{int(_ac)}")
add("grid_sample", X(lambda r: [f(r, 1, 2, 3, 4, 5),
                                f(r, 1, 2, 3, 2, 3, lo=-1.1, hi=1.1)]),
    name="grid_sample_3d")
_CTC_LAB = np.array([[1, 2, 2], [3, 1, 0], [4, 0, 0]])
add("warpctc", X(lambda r: [f(r, 6, 3, 5), _CTC_LAB,
                            np.array([6, 5, 4]), np.array([3, 2, 1])]))
add("warpctc", X(lambda r: [f(r, 6, 3, 5), _CTC_LAB,
                            np.array([6, 5, 4]), np.array([3, 2, 1])],
                 norm_by_times=True, blank=0), name="warpctc_norm_by_times")
# an infeasible alignment: 3 labels with a repeat need 4 frames, 3 given
add("warpctc", X(lambda r: [f(r, 5, 2, 4), np.array([[1, 1, 2], [2, 3, 0]]),
                            np.array([3, 5]), np.array([3, 2])]),
    name="warpctc_infeasible")
add("rnnt", X(lambda r: [f(r, 2, 4, 3, 5), np.array([[1, 3], [2, 0]]),
                         np.array([4, 3]), np.array([2, 1])]))
add("rnnt", X(lambda r: [f(r, 2, 5, 4, 6), np.array([[1, 3, 5], [2, 4, 0]]),
                         np.array([5, 2]), np.array([3, 2])],
              fastemit_lambda=0.3), name="rnnt_fastemit")
add("roi_align", X(lambda r: [f(r, 2, 3, 8, 9), _boxes(r, 4, 16, 18),
                              np.array([0, 1, 1, 0])],
                   output_size=(2, 3), spatial_scale=0.5, sampling_ratio=2))
add("roi_align", X(lambda r: [f(r, 2, 3, 8, 9), _boxes(r, 3, 8, 9),
                              np.array([1, 0, 1])],
                   output_size=(2, 2), sampling_ratio=-1, aligned=False),
    name="roi_align_unaligned")
add("roi_pool", X(lambda r: [f(r, 2, 3, 8, 8), _boxes(r, 3, 8, 8),
                             np.array([0, 1, 0])], output_size=(2, 2)))
add("psroi_pool", X(lambda r: [f(r, 2, 8, 6, 6), _boxes(r, 3, 6, 6),
                               np.array([1, 0, 1])], output_size=(2, 2)))
add("deform_conv2d", X(lambda r: [f(r, 2, 4, 6, 6),
                                  f(r, 2, 18, 4, 4) * 0.7,
                                  f(r, 3, 4, 3, 3),
                                  f(r, 2, 9, 4, 4, lo=0.0, hi=1.0),
                                  f(r, 3)]))
add("deform_conv2d", X(lambda r: [f(r, 1, 4, 5, 5),
                                  f(r, 1, 36, 3, 3) * 0.7,
                                  f(r, 4, 2, 3, 3)],
                       deformable_groups=2, groups=2),
    name="deform_conv2d_groups")
_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]
add("yolo_loss", X(lambda r: [
    f(r, 2, 21, 4, 4),
    np.concatenate([f(r, 2, 3, 2, lo=0.05, hi=0.95),
                    f(r, 2, 3, 2, lo=0.05, hi=0.5)], -1),
    ints(r, 0, 2, 2, 3)],
    anchors=_ANCHORS, anchor_mask=[0, 1, 2], class_num=2,
    downsample_ratio=8, ignore_thresh=0.5))
add("yolo_loss", X(lambda r: [
    f(r, 1, 24, 3, 3),
    np.concatenate([f(r, 1, 2, 2, lo=0.05, hi=0.95),
                    f(r, 1, 2, 2, lo=0.1, hi=0.9)], -1),
    ints(r, 0, 3, 1, 2), f(r, 1, 2, lo=0.5, hi=1.0)],
    anchors=_ANCHORS, anchor_mask=[3, 4, 5], class_num=3,
    downsample_ratio=16, use_label_smooth=False, scale_x_y=1.2),
    name="yolo_loss_score_scale")
add("vander", X(lambda r: [f(r, 5)]))
add("vander", X(lambda r: [f(r, 4)], n=6, increasing=True),
    name="vander_increasing")
add("vander", X(lambda r: [ints(r, -3, 4, 4)]), name="vander_int")

SECTION = LONG_TAIL
for _op in ("hstack", "vstack", "column_stack", "row_stack"):
    add(_op, X(lambda r: [[f(r, 2, 3), f(r, 2, 3)]]))
add("dstack", X(lambda r: [[f(r, 2, 3), f(r, 2, 3), f(r, 2, 3)]]))
add("hstack", X(lambda r: [[f(r, 2), f(r, 3)]]), name="hstack_1d")
add("hsplit", X(lambda r: [f(r, 4, 6), 2]))
add("hsplit", X(lambda r: [f(r, 4, 6), [1, 4]]), name="hsplit_points")
add("vsplit", X(lambda r: [f(r, 4, 3), 2]))
add("dsplit", X(lambda r: [f(r, 2, 3, 4), [1, 3]]))
add("tensor_split", X(lambda r: [f(r, 7, 3), 3]))
add("tensor_split", X(lambda r: [f(r, 3, 7), [2, 5]], axis=1),
    name="tensor_split_points")
add("unstack", X(lambda r: [f(r, 3, 4)], axis=1))
add("unflatten", X(lambda r: [f(r, 2, 6), 1, [2, -1]]))
add("addmm", X(lambda r: [f(r, 3, 5), f(r, 3, 4), f(r, 4, 5)],
               beta=0.5, alpha=2.0))
add("copysign", X(lambda r: [f(r, 3, 4), f(r, 3, 4)]))
add("ldexp", X(lambda r: [f(r, 3, 4), ints(r, -3, 4, 3, 4)]))
add("nextafter", X(lambda r: [f(r, 3, 4), f(r, 3, 4)]))
# frexp's mantissa is piecewise linear; jnp's has no derivative rule
add("frexp", X(lambda r: [f(r, 3, 4) * 10]), grad=False)
add("sgn", X(lambda r: [f(r, 3, 4)]))
add("sgn", X(lambda r: [f(r, 3, 4) + 1j * f(r, 3, 4)]), name="sgn_complex")
add("signbit", X(lambda r: [f(r, 3, 4)]))
add("stanh", X(lambda r: [f(r, 3, 4)], scale_a=0.5, scale_b=2.0))
add("logcumsumexp", X(lambda r: [f(r, 3, 5)], axis=1))
add("logcumsumexp", X(lambda r: [f(r, 2, 3)]), name="logcumsumexp_flat")
add("trapezoid", X(lambda r: [f(r, 3, 5)]))
add("trapezoid", X(lambda r: [f(r, 3, 5), np.sort(f(r, 5))]),
    name="trapezoid_x")
add("trapezoid", X(lambda r: [f(r, 4, 3)], dx=0.5, axis=0),
    name="trapezoid_dx")
add("cumulative_trapezoid", X(lambda r: [f(r, 3, 5)]))
add("cumulative_trapezoid", X(lambda r: [f(r, 3, 5), f(r, 3, 5)]),
    name="cumulative_trapezoid_x")
add("gammaln", X(lambda r: [pos(r, 3, 4) * 3]))
add("gammainc", X(lambda r: [pos(r, 3, 4) * 2, pos(r, 3, 4) * 2]))
add("gammaincc", X(lambda r: [pos(r, 3, 4) * 2, pos(r, 3, 4) * 2]))
add("multigammaln", X(lambda r: [pos(r, 3, 4) + 2, 3]))
add("polygamma", X(lambda r: [pos(r, 3, 4), 1]))
add("polygamma", X(lambda r: [pos(r, 3, 4), 2]), name="polygamma_2")
for _op in ("i0", "i0e", "i1", "i1e"):
    add(_op, X(lambda r: [f(r, 3, 4) * 2]))
add("cdist", X(lambda r: [f(r, 4, 3), f(r, 5, 3)]))
add("cdist", X(lambda r: [f(r, 2, 4, 3), f(r, 2, 5, 3)], p=1.0),
    name="cdist_p1")
add("cdist", X(lambda r: [f(r, 4, 3), f(r, 5, 3)], p=float("inf")),
    name="cdist_inf")
add("cdist", X(lambda r: [f(r, 4, 3), f(r, 5, 3)], p=3.0,
               compute_mode="donot_use_mm_for_euclid_dist"),
    name="cdist_p3")
add("pdist", X(lambda r: [f(r, 5, 3)]))


def _with_nans(r, *shape):
    x = f(r, *shape)
    x[r.random(shape) < 0.25] = np.nan
    return x


add("nanmedian", X(lambda r: [f(r, 4, 6)], axis=1))
add("nanmedian", X(lambda r: [f(r, 3, 5)]), name="nanmedian_all")
add("nanmedian", X(lambda r: [_with_nans(r, 4, 7)], axis=1, keepdim=True),
    grad=False, name="nanmedian_nans")
add("nanquantile", X(lambda r: [f(r, 4, 6), 0.3], axis=1))
add("nanquantile", X(lambda r: [_with_nans(r, 4, 6),
                                np.array([0.25, 0.75], np.float32)]),
    grad=False, name="nanquantile_nans")
add("renorm", X(lambda r: [f(r, 3, 4), 2.0, 1, 1.0]))
add("multiplex", X(lambda r: [[f(r, 4, 3), f(r, 4, 3), f(r, 4, 3)],
                              ints(r, 0, 3, 4, 1)]))
add("tensordot", X(lambda r: [f(r, 2, 3, 4), f(r, 3, 4, 5)]))
add("tensordot", X(lambda r: [f(r, 2, 3), f(r, 3, 4)], axes=[[1], [0]]),
    name="tensordot_axes")
add("combinations", X(lambda r: [f(r, 4)]))
add("combinations", X(lambda r: [f(r, 4)], r=3, with_replacement=True),
    name="combinations_replacement")


def _infs(r):
    x = f(r, 3, 4)
    x[0, 0], x[1, 2], x[2, 3] = np.inf, -np.inf, np.nan
    return x


add("isneginf", X(lambda r: [_infs(r)]))
add("isposinf", X(lambda r: [_infs(r)]))
add("isreal", X(lambda r: [f(r, 2, 3) + 1j * (f(r, 2, 3) > 0)]))
add("is_empty", X(lambda r: [f(r, 0, 3)]))
add("is_empty", X(lambda r: [f(r, 2)]), name="is_empty_not")
add("diag_embed", X(lambda r: [f(r, 2, 3)]))
add("diag_embed", X(lambda r: [f(r, 2, 3)], offset=1, dim1=0, dim2=2),
    name="diag_embed_dims")
add("diagonal_scatter", X(lambda r: [f(r, 4, 5), f(r, 4)], offset=1))
add("select_scatter", X(lambda r: [f(r, 3, 4), f(r, 4), 0, 1]))
add("slice_scatter", X(lambda r: [f(r, 4, 6), f(r, 2, 3), [0, 1], [1, 0],
                                  [3, 6], [1, 2]]))
add("index_fill", X(lambda r: [f(r, 4, 5), np.array([0, 2]), 1, -1.0]))
add("take", X(lambda r: [f(r, 3, 4), ints(r, -12, 12, 5)]))
add("take", X(lambda r: [f(r, 3, 4), ints(r, -20, 20, 2, 3)], mode="wrap"),
    name="take_wrap")
add("take", X(lambda r: [f(r, 3, 4), ints(r, -20, 20, 6)], mode="clip"),
    name="take_clip")
add("kthvalue", X(lambda r: [f(r, 3, 6), 2]))
add("kthvalue", X(lambda r: [f(r, 5, 3), 4], axis=0, keepdim=True),
    name="kthvalue_axis0")
# ties: which tied input the sort's gradient reaches is the sort's own
add("mode", X(lambda r: [r.integers(0, 3, (3, 7)).astype(np.float32)]),
    grad=False)
add("mode", X(lambda r: [f(r, 4, 5)], axis=0, keepdim=True),
    name="mode_distinct")
add("scatter_nd", X(lambda r: [ints(r, 0, 3, 4, 2), f(r, 4), [3, 3]]))
add("scatter_nd", X(lambda r: [ints(r, 0, 3, 4, 1), f(r, 4, 5), [3, 5]]),
    name="scatter_nd_rows")
add("unique_consecutive", X(lambda r: [np.array([1, 1, 2, 2, 3, 1, 1, 5],
                                                np.float32)],
                            return_inverse=True, return_counts=True))
add("reverse", X(lambda r: [f(r, 3, 4), [0, 1]]))
add("crop", X(lambda r: [f(r, 4, 5)], shape=[2, 3], offsets=[1, 1]))
add("crop", X(lambda r: [f(r, 4, 5)], shape=[2, -1], offsets=[3, 2]),
    name="crop_clamped")
add("strided_slice", X(lambda r: [f(r, 5, 6), [0, 1], [0, 5], [5, 0],
                                  [2, -2]]))
add("slice", X(lambda r: [f(r, 4, 5), [0, 1], [1, -3], [3, 100]]))
add("as_complex", X(lambda r: [f(r, 3, 4, 2)]))
add("as_real", X(lambda r: [f(r, 3, 4) + 1j * f(r, 3, 4)]))
add("atleast_1d", X(lambda r: [f(r, 1).reshape(())]))
add("atleast_2d", X(lambda r: [f(r, 3)]))
add("atleast_3d", X(lambda r: [f(r, 2, 3)]))
# draws held to jax.random's distribution (tests/test_torch_long_tail.py);
# here the support, and one key taken from the generator
add("binomial", X(lambda r: [np.full((64,), 20, np.int64),
                             f(r, 64, lo=0.05, hi=0.95)]),
    post=_bool_post(lambda P, o: P.logical_and(o >= 0, o <= 20)))
add("standard_gamma", X(lambda r: [pos(r, 40)]),
    post=_bool_post(lambda P, o: o > 0))
add("rad2deg", X(lambda r: [f(r, 3, 4)]))
add("deg2rad", X(lambda r: [f(r, 3, 4) * 90]))

SECTION = NN_TAIL
add("max_pool3d", X(lambda r: [f(r, 1, 2, 4, 6, 4), 2]))
add("max_pool3d", X(lambda r: [f(r, 1, 2, 5, 5, 4), 3], stride=2,
                    padding=1, ceil_mode=True), name="max_pool3d_ceil")
add("avg_pool3d", X(lambda r: [f(r, 1, 2, 4, 5, 6), 2], stride=2,
                    padding=1))
add("avg_pool3d", X(lambda r: [f(r, 1, 2, 5, 5, 5), 2], ceil_mode=True,
                    exclusive=False), name="avg_pool3d_ceil")
add("avg_pool3d", X(lambda r: [f(r, 1, 4, 4, 4, 2), 2],
                    data_format="NDHWC"), name="avg_pool3d_ndhwc")
add("adaptive_avg_pool1d", X(lambda r: [f(r, 2, 3, 7), 3]))
add("adaptive_max_pool1d", X(lambda r: [f(r, 2, 3, 8), 4]))
add("adaptive_avg_pool3d", X(lambda r: [f(r, 1, 2, 5, 6, 7), [2, 3, 3]]))
add("adaptive_max_pool3d", X(lambda r: [f(r, 1, 2, 4, 6, 5), 2]))
add("fractional_max_pool2d", X(lambda r: [f(r, 1, 2, 9, 9), 4]))
add("fractional_max_pool2d", X(lambda r: [f(r, 2, 2, 7, 8), [3, 5]],
                               random_u=0.3, return_mask=True),
    name="fractional_max_pool2d_mask")
add("fractional_max_pool3d", X(lambda r: [f(r, 1, 2, 6, 7, 7), [2, 3, 3]]))
add("max_unpool1d", X(lambda r: [f(r, 2, 3, 4),
                                 _pool_indices(r, 2, 3, (4,), 2, (8,)), 2]))
add("max_unpool2d", X(lambda r: [f(r, 1, 2, 3, 2),
                                 _pool_indices(r, 1, 2, (3, 2), 2, (6, 4)),
                                 2]))
add("max_unpool2d", X(lambda r: [f(r, 1, 2, 2, 2),
                                 _pool_indices(r, 1, 2, (2, 2), 2, (5, 5)),
                                 2], output_size=[5, 5]),
    name="max_unpool2d_output_size")
add("max_unpool3d", X(lambda r: [f(r, 1, 2, 2, 2, 2),
                                 _pool_indices(r, 1, 2, (2, 2, 2), 2,
                                               (4, 4, 4)), 2]))
add("channel_shuffle", X(lambda r: [f(r, 2, 6, 3, 3), 3]))
add("pixel_unshuffle", X(lambda r: [f(r, 1, 2, 4, 6), 2]))
add("fold", X(lambda r: [f(r, 1, 8, 12), [4, 5], 2]))
add("fold", X(lambda r: [f(r, 2, 18, 9), [5, 5], [3, 3]], strides=2,
              paddings=1, dilations=1), name="fold_strided")
add("rrelu", X(lambda r: [f(r, 4, 6)]))
add("rrelu", X(lambda r: [f(r, 4, 6)], lower=0.1, upper=0.3,
               training=False), name="rrelu_eval")
add("conv1d_transpose", X(lambda r: [f(r, 2, 4, 5), f(r, 4, 3, 3), f(r, 3)],
                          stride=2, padding=1, output_padding=1))
add("conv1d_transpose", X(lambda r: [f(r, 1, 4, 6), f(r, 4, 2, 3)],
                          groups=2, dilation=2),
    name="conv1d_transpose_groups")
add("conv3d_transpose", X(lambda r: [f(r, 1, 2, 3, 3, 3),
                                     f(r, 2, 3, 2, 2, 2), f(r, 3)],
                          stride=2))
add("gaussian_nll_loss", X(lambda r: [f(r, 3, 4), f(r, 3, 4),
                                      pos(r, 3, 4)]))
add("gaussian_nll_loss", X(lambda r: [f(r, 3, 4), f(r, 3, 4), pos(r, 3, 4)],
                           full=True, reduction="sum"),
    name="gaussian_nll_loss_full")
add("hinge_embedding_loss", X(lambda r: [f(r, 3, 4),
                                         np.sign(f(r, 3, 4))]))
add("multi_label_soft_margin_loss",
    X(lambda r: [f(r, 3, 4), (f(r, 3, 4) > 0).astype(np.float32),
                 pos(r, 4)]))
add("multi_margin_loss", X(lambda r: [f(r, 4, 5), ints(r, 0, 5, 4)],
                           weight=pos(np.random.default_rng(3), 5)))
add("multi_margin_loss", X(lambda r: [f(r, 4, 5), ints(r, 0, 5, 4)], p=2,
                           margin=0.5, reduction="none"),
    name="multi_margin_loss_p2")
add("poisson_nll_loss", X(lambda r: [f(r, 3, 4), pos(r, 3, 4) * 3]))
add("poisson_nll_loss", X(lambda r: [pos(r, 3, 4), pos(r, 3, 4) * 3],
                          log_input=False, full=True),
    name="poisson_nll_loss_full")
add("soft_margin_loss", X(lambda r: [f(r, 3, 4), np.sign(f(r, 3, 4))]))
add("triplet_margin_loss", X(lambda r: [f(r, 4, 5), f(r, 4, 5),
                                        f(r, 4, 5)]))
add("triplet_margin_loss", X(lambda r: [f(r, 4, 5), f(r, 4, 5), f(r, 4, 5)],
                             p=1.0, swap=True, reduction="sum"),
    name="triplet_margin_loss_swap")
add("hsigmoid_loss", X(lambda r: [f(r, 4, 6), ints(r, 0, 5, 4), 5,
                                  f(r, 4, 6), f(r, 4, 1)]))
add("hsigmoid_loss", X(lambda r: [f(r, 3, 6), ints(r, 0, 4, 3), 4,
                                  f(r, 4, 6), None,
                                  np.array([[0, 1, -1], [0, 2, 3],
                                            [1, -1, -1]]),
                                  np.array([[1, 0, 0], [0, 1, 1],
                                            [1, 0, 0]])]),
    name="hsigmoid_loss_custom_path")



# ---------------------------------------------------------------------------
# one case through the port on one place
# ---------------------------------------------------------------------------
RTOL, ATOL = 1e-5, 1e-6
# the card against the CPU: ops whose card kernels (cuDNN, cuBLAS, the
# reductions) add in another order than the CPU's, or whose transcendental
# functions round differently, at the sweep's loose tolerance
_CARD_LOOSE = {
    "conv1d_transpose", "conv3d_transpose", "deform_conv2d", "addmm",
    "tensordot", "cdist", "pdist", "avg_pool3d", "adaptive_avg_pool1d",
    "adaptive_avg_pool3d", "fold", "affine_grid", "grid_sample",
    "roi_align", "psroi_pool", "yolo_loss", "warpctc", "rnnt",
    "logcumsumexp", "gammainc", "gammaincc", "multigammaln", "polygamma",
    "i0", "i0e", "i1", "i1e", "gammaln", "trapezoid",
    "cumulative_trapezoid", "hsigmoid_loss", "multi_margin_loss",
    "multi_label_soft_margin_loss", "gaussian_nll_loss",
    "poisson_nll_loss", "soft_margin_loss", "triplet_margin_loss",
    "renorm", "nanquantile", "vander", "stanh"}


# the gradient through pdist's zero diagonal is sqrt'(0) = inf times 0 in
# both packages wherever x2 + y2 - 2xy rounds to <= 0 there, NaN: which
# entries depends on the rounding, so the card and the CPU hold their
# gradients where both are finite (the values everywhere)
NAN_GRAD_BY_ROUNDING = {"pdist"}


def card_tol(case):
    """(rtol, atol) for the card against the CPU."""
    if case.tol is not None:
        return case.tol
    return (1e-4, 1e-5) if case.op in _CARD_LOOSE else (RTOL, ATOL)


def _to(P, v, diff, place):
    if isinstance(v, np.ndarray):
        sg = not (diff and v.dtype == np.float32)
        return P.to_tensor(v, place=place, stop_gradient=sg)
    if isinstance(v, list) and v and all(isinstance(a, np.ndarray)
                                         for a in v):
        return [_to(P, a, diff, place) for a in v]
    return v


def _leaves(args, kwargs):
    out = []
    for v in list(args) + list(kwargs.values()):
        if isinstance(v, (list, tuple)):
            out += [a for a in v if hasattr(a, "_data")]
        elif hasattr(v, "_data"):
            out.append(v)
    return out


def run_case(case, place):
    """The port's outputs for ``case`` on ``place`` and, for a
    differentiable op, the gradients of the seeded cotangent for every
    floating input: (outputs, gradients, rng state), as numpy."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.ops import registry

    seed = zlib.crc32(case.id.encode())
    args, kw = case.make(np.random.default_rng(seed))
    diff = case.grad and registry.OPS[case.op].diff
    targs = [_to(P, a, diff, place) for a in args]
    tkw = {k: _to(P, v, diff, place) for k, v in kw.items()}
    P.seed(seed)
    out = registry.API[case.op](*targs, **tkw)
    outs = list(out) if isinstance(out, tuple) else [out]
    if case.post is not None:
        outs = case.post(P, outs)
    state = P.get_rng_state()
    got = [np.asarray(o.numpy()) for o in outs]
    grads = []
    float_outs = [o for o in outs
                  if o.dtype.name == "float32" and not o.stop_gradient]
    leaves = [t for t in _leaves(targs, tkw) if not t.stop_gradient]
    if diff and float_outs and leaves:
        rng = np.random.default_rng(seed + 1)
        cots = [P.to_tensor(rng.standard_normal(o.shape).astype(np.float32),
                            place=place) for o in float_outs]
        P.autograd.backward(float_outs, cots)
        grads = [np.zeros(t.shape, np.float32) if t.grad is None
                 else np.asarray(t.grad.numpy()) for t in leaves]
    return got, grads, state


def compare(case, card, cpu):
    """The card's ``run_case`` result against the CPU's: a list of the
    mismatches (empty when they agree) and the largest errors."""
    got, ggot, sgot = card
    want, gwant, swant = cpu
    bad = []
    if sgot != swant:
        bad.append(f"rng state {sgot} != {swant}")
    rtol, atol = card_tol(case)
    err = gerr = 0.0
    if len(got) != len(want) or len(ggot) != len(gwant):
        return [f"{len(got)}/{len(ggot)} outputs/gradients, CPU "
                f"{len(want)}/{len(gwant)}"], err, gerr
    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or a.dtype != b.dtype:
            bad.append(f"out {i}: {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
            continue
        try:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
        except AssertionError as e:
            bad.append(f"out {i}: {str(e)[:300]}")
        if a.size:
            d = np.abs(a.astype(np.complex128) - b.astype(np.complex128))
            err = max(err, float(np.nanmax(d)) if np.isfinite(d).any()
                      else 0.0)
    for i, (a, b) in enumerate(zip(ggot, gwant)):
        if case.op in NAN_GRAD_BY_ROUNDING:
            keep = np.isfinite(a) & np.isfinite(b)
            a, b = a[keep], b[keep]
        try:
            np.testing.assert_allclose(a, b, rtol=max(rtol, 1e-5),
                                       atol=max(atol, 1e-5))
        except AssertionError as e:
            bad.append(f"grad {i}: {str(e)[:300]}")
        if a.size:
            gerr = max(gerr, float(np.nanmax(np.abs(a - b))))
    return bad, err, gerr
