"""The port's ``vision.ops`` against the JAX package's, in f32.

The RoI wrappers (``boxes_num`` over two images, the layers, a gradient),
deformable convolution (v1 and v2, the layer), ``yolo_loss``; then the
post-processing: ``box_coder`` both ways, ``prior_box``, ``yolo_box``
(with ``iou_aware``), greedy ``nms`` (plain, by category, ``top_k``),
``matrix_nms`` (linear and Gaussian, with its index and counts),
``generate_proposals``, ``distribute_fpn_proposals`` with its restore
index; and ``ConvNormActivation``, ``read_file``, ``decode_jpeg``. Kept
indices must be identical; values within rtol 1e-5. The port's indices
are int64 and its counts int32, the dtypes the JAX package's code asks
for; the JAX package runs with 64-bit types off, so its indices arrive as
int32 (the values are compared).
"""
import io as _io

import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.vision import ops as jops
from paddle_tpu_torch.core import place as _place
from paddle_tpu_torch.models.convert import vision_state_from_jax
from paddle_tpu_torch.vision import ops as tops

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _cpu_place():
    saved = (_place._current_place, _place._current_device)
    tpaddle.set_device("cpu")
    yield
    _place._current_place, _place._current_device = saved


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _both(fn, *arrays):
    """``fn(P, ops, *tensors)`` in each package, the arrays as its
    tensors."""
    return [fn(P, O, *[P.to_tensor(np.asarray(a)) for a in arrays])
            for P, O in ((jpaddle, jops), (tpaddle, tops))]


def _same(j, t, tol=TOL, exact=False):
    if isinstance(j, (list, tuple)):
        assert isinstance(t, type(j)) and len(j) == len(t)
        for a, b in zip(j, t):
            _same(a, b, tol, exact)
        return
    a, b = _np(j), _np(t)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    if exact:
        np.testing.assert_array_equal(b, a)
    else:
        np.testing.assert_allclose(b, a, **tol)


def _same_index(j, t):
    """Kept indices: the port's int64, equal to the reference's (int32
    under JAX's default 32-bit types)."""
    a, b = _np(j), _np(t)
    assert b.dtype == np.int64, b.dtype
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(b, a.astype(np.int64))


def _boxes(rng, n, lo=0, hi=50, wlo=5, whi=25):
    xy = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(wlo, whi, (n, 2))
    return np.concatenate([xy, xy + wh], axis=1).astype("float32")


# ---------------------------------------------------------------------------
# the RoI family, deformable convolution, yolo_loss
# ---------------------------------------------------------------------------
_RNG = np.random.default_rng(0)
_FEAT = _RNG.normal(size=(2, 8, 12, 14)).astype("float32")
_ROIS = _boxes(_RNG, 5, 0, 40, 4, 20) / 2
_NUM = np.asarray([3, 2], "int32")


@pytest.mark.parametrize("name,kw", [
    ("roi_align", dict(output_size=3, spatial_scale=0.5)),
    ("roi_align", dict(output_size=(2, 4), sampling_ratio=2,
                       aligned=False)),
    ("roi_pool", dict(output_size=3, spatial_scale=0.5)),
    ("psroi_pool", dict(output_size=2, spatial_scale=0.5)),
])
def test_roi_wrappers_take_boxes_num(name, kw):
    j, t = _both(lambda P, O, x, b, n: getattr(O, name)(x, b, n, **kw),
                 _FEAT, _ROIS, _NUM)
    _same(j, t)


@pytest.mark.parametrize("layer", ["RoIAlign", "RoIPool", "PSRoIPool"])
def test_roi_layers(layer):
    j, t = _both(lambda P, O, x, b, n: getattr(O, layer)(2, 0.5)(x, b, n),
                 _FEAT, _ROIS, _NUM)
    _same(j, t)


def test_roi_align_gradient():
    grads = []
    for P, O in ((jpaddle, jops), (tpaddle, tops)):
        x = P.to_tensor(_FEAT)
        x.stop_gradient = False
        out = O.roi_align(x, P.to_tensor(_ROIS), P.to_tensor(_NUM), 2,
                          spatial_scale=0.5)
        P.sum(out * out).backward()
        grads.append(x.grad)
    _same(*grads)


_DX = _RNG.normal(size=(2, 4, 7, 7)).astype("float32")
_DW = _RNG.normal(size=(6, 4, 3, 3)).astype("float32") * 0.2
_DB = _RNG.normal(size=(6,)).astype("float32")
_OFF = _RNG.normal(size=(2, 2 * 9, 5, 5)).astype("float32")
_MASK = _RNG.uniform(size=(2, 9, 5, 5)).astype("float32")


@pytest.mark.parametrize("v2", [False, True])
def test_deform_conv2d(v2):
    def run(P, O, x, off, w, b, m):
        return O.deform_conv2d(x, off, w, b, mask=m if v2 else None)

    j, t = _both(run, _DX, _OFF, _DW, _DB, _MASK)
    _same(j, t)


def test_deform_conv2d_layer_from_the_jax_weights():
    jpaddle.seed(3)
    jl = jops.DeformConv2D(4, 6, 3, padding=1, stride=1)
    tl = tops.DeformConv2D(4, 6, 3, padding=1, stride=1)
    vision_state_from_jax({k: _np(v) for k, v in jl.state_dict().items()},
                          jpaddle.get_rng_state(), tl)
    off = _RNG.normal(size=(2, 18, 7, 7)).astype("float32")
    mask = _RNG.uniform(size=(2, 9, 7, 7)).astype("float32")
    for m in (None, mask):
        args = [(_DX, off) if m is None else (_DX, off, m)][0]
        j = jl(*[jpaddle.to_tensor(a) for a in args])
        t = tl(*[tpaddle.to_tensor(a) for a in args])
        _same(j, t)


def test_yolo_loss():
    rng = np.random.default_rng(1)
    cn = 3
    x = rng.normal(scale=0.5, size=(2, 3 * (5 + cn), 4, 4)).astype("float32")
    gtb = rng.uniform(0.2, 0.6, (2, 2, 4)).astype("float32")
    gtl = rng.integers(0, cn, (2, 2)).astype("int32")
    gts = rng.uniform(0.5, 1.0, (2, 2)).astype("float32")

    def run(P, O, x, b, lab, sc):
        x.stop_gradient = False
        loss = O.yolo_loss(x, b, lab, [10, 13, 16, 30, 33, 23], [0, 1, 2],
                           cn, ignore_thresh=0.7, downsample_ratio=8,
                           gt_score=sc, use_label_smooth=True)
        P.sum(loss).backward()
        return loss, x.grad

    j, t = _both(run, x, gtb, gtl, gts)
    _same(j, t)


# ---------------------------------------------------------------------------
# box codecs, anchors, the YOLO head
# ---------------------------------------------------------------------------
_PRI = _boxes(np.random.default_rng(2), 6, 0, 40, 4, 30)
_TGT = _boxes(np.random.default_rng(3), 4, 0, 40, 4, 30)


@pytest.mark.parametrize("var", ["none", "list", "tensor1", "tensor2"])
@pytest.mark.parametrize("normalized", [True, False])
def test_box_coder_encode(var, normalized):
    v = {"none": None, "list": [0.1, 0.1, 0.2, 0.2],
         "tensor1": np.asarray([0.1, 0.2, 0.3, 0.4], "float32"),
         "tensor2": np.random.default_rng(4).uniform(
             0.1, 0.5, (6, 4)).astype("float32")}[var]

    def run(P, O, pb, tb):
        vv = P.to_tensor(v) if isinstance(v, np.ndarray) else v
        return O.box_coder(pb, vv, tb, box_normalized=normalized)

    _same(*_both(run, _PRI, _TGT))


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("var", ["list", "tensor2"])
def test_box_coder_decode(axis, var):
    rng = np.random.default_rng(5)
    deltas = rng.normal(scale=0.3, size=(6, 3, 4) if axis == 0
                        else (3, 6, 4)).astype("float32")
    v = [0.1, 0.1, 0.2, 0.2] if var == "list" else \
        rng.uniform(0.1, 0.5, (6, 4)).astype("float32")

    def run(P, O, pb, tb):
        vv = P.to_tensor(v) if isinstance(v, np.ndarray) else v
        return O.box_coder(pb, vv, tb, code_type="decode_center_size",
                           axis=axis, box_normalized=False)

    _same(*_both(run, _PRI, deltas))


def test_box_coder_unknown_code_type_raises():
    for P, O in ((jpaddle, jops), (tpaddle, tops)):
        with pytest.raises(ValueError, match="code_type"):
            O.box_coder(P.to_tensor(_PRI), None, P.to_tensor(_TGT),
                        code_type="nope")


@pytest.mark.parametrize("kw", [
    dict(min_sizes=[8.0], aspect_ratios=[2.0], clip=True),
    dict(min_sizes=[4.0, 8.0], max_sizes=[8.0, 16.0],
         aspect_ratios=[2.0, 3.0], flip=True),
    dict(min_sizes=[6.0], max_sizes=[12.0], aspect_ratios=[2.0],
         flip=True, min_max_aspect_ratios_order=True, steps=(8.0, 8.0),
         offset=0.3, variance=(0.1, 0.2, 0.3, 0.4)),
])
def test_prior_box(kw):
    j, t = _both(lambda P, O, x, im: O.prior_box(x, im, **kw),
                 np.ones((1, 8, 4, 5), "float32"),
                 np.ones((1, 3, 32, 40), "float32"))
    _same(j, t)


@pytest.mark.parametrize("kw", [
    dict(), dict(clip_bbox=False, scale_x_y=1.2),
    dict(iou_aware=True, iou_aware_factor=0.4),
])
def test_yolo_box(kw):
    rng = np.random.default_rng(6)
    na, cn = 3, 4
    c = na * (5 + cn) + (na if kw.get("iou_aware") else 0)
    x = rng.normal(size=(2, c, 5, 6)).astype("float32")
    size = np.asarray([[160, 192], [100, 120]], "int32")
    j, t = _both(lambda P, O, x, s: O.yolo_box(
        x, s, anchors=[10, 13, 16, 30, 33, 23], class_num=cn,
        conf_thresh=0.4, downsample_ratio=32, **kw), x, size)
    _same(j, t)


# ---------------------------------------------------------------------------
# greedy NMS
# ---------------------------------------------------------------------------
def _nms_case(n=200, seed=0):
    rng = np.random.default_rng(seed)
    return _boxes(rng, n, 0, 100, 5, 40), \
        rng.uniform(size=n).astype("float32"), \
        rng.integers(0, 4, n).astype("int64")


@pytest.mark.parametrize("thr", [0.3, 0.5, 0.7])
def test_nms_kept_set_is_the_reference(thr):
    b, s, c = _nms_case()
    cases = {
        "plain": lambda P, O, b, s, c: O.nms(b, thr),
        "scores": lambda P, O, b, s, c: O.nms(b, thr, s),
        "categories": lambda P, O, b, s, c: O.nms(b, thr, s, c, [0, 1, 2, 3]),
        "top_k": lambda P, O, b, s, c: O.nms(b, thr, s, top_k=7),
        "categories_top_k": lambda P, O, b, s, c: O.nms(
            b, thr, s, c, [0, 1, 2, 3], top_k=11),
    }
    for name, fn in cases.items():
        j, t = _both(fn, b, s, c)
        _same_index(j, t)
        if name == "top_k":
            assert len(_np(t)) == 7


def test_nms_edge_cases():
    one = np.asarray([[0, 0, 10, 10]], "float32")
    _same_index(*_both(lambda P, O, b: O.nms(b, 0.5), one))
    _same_index(*_both(lambda P, O, b, s: O.nms(b, 0.5, s), one,
                       np.asarray([0.3], "float32")))
    same = np.repeat(one, 5, axis=0)          # every box suppresses the next
    _same_index(*_both(lambda P, O, b, s: O.nms(b, 0.1, s), same,
                       np.asarray([0.1, 0.9, 0.5, 0.9, 0.2], "float32")))


# ---------------------------------------------------------------------------
# matrix NMS
# ---------------------------------------------------------------------------
def _matrix_case(seed=1):
    rng = np.random.default_rng(seed)
    n, c, m = 2, 4, 60
    boxes = np.stack([_boxes(rng, m, 0, 80, 5, 40) for _ in range(n)])
    scores = rng.uniform(size=(n, c, m)).astype("float32") ** 2
    return boxes, scores


@pytest.mark.parametrize("kw", [
    dict(score_threshold=0.3, post_threshold=0.2, background_label=0),
    dict(score_threshold=0.2, post_threshold=0.1, use_gaussian=True,
         gaussian_sigma=2.0, background_label=-1, keep_top_k=25),
    dict(score_threshold=0.1, post_threshold=0.0, nms_top_k=10,
         keep_top_k=30, background_label=2),
    dict(score_threshold=0.5, nms_top_k=-1, keep_top_k=100,
         background_label=-1, use_gaussian=True, gaussian_sigma=0.5),
])
def test_matrix_nms(kw):
    b, s = _matrix_case()
    j, t = _both(lambda P, O, b, s: O.matrix_nms(
        b, s, return_index=True, return_rois_num=True, **kw), b, s)
    out, idx, num = t
    _same_index(j[1], idx)
    _same(j[2], num, exact=True)
    _same(j[0], out)


def test_matrix_nms_return_shapes_and_empty():
    b, s = _matrix_case(2)
    for flags in ((False, False), (True, False), (False, True)):
        j, t = _both(lambda P, O, b, s: O.matrix_nms(
            b, s, 0.3, return_index=flags[0], return_rois_num=flags[1]),
            b, s)
        if flags == (True, False):
            _same(j[0], t[0])
            _same_index(j[1], t[1])
        else:
            _same(j, t)
    # nothing above the threshold: a (0, 6) result, zero counts
    j, t = _both(lambda P, O, b, s: O.matrix_nms(
        b, s, 2.0, return_index=True), b, s)
    assert _np(t[0]).shape == (0, 6)
    _same(j[0], t[0])
    _same_index(j[1], t[1])
    _same(j[2], t[2], exact=True)


# ---------------------------------------------------------------------------
# proposals and FPN routing
# ---------------------------------------------------------------------------
def _rpn_case(seed=0, n=2, a=3, h=6, w=8):
    rng = np.random.default_rng(seed)
    scores = rng.uniform(size=(n, a, h, w)).astype("float32")
    deltas = rng.normal(scale=0.2, size=(n, 4 * a, h, w)).astype("float32")
    anchors = rng.uniform(0, 60, (h, w, a, 4)).astype("float32")
    anchors[..., 2:] = anchors[..., :2] + rng.uniform(4, 30, (h, w, a, 2))
    var = rng.uniform(0.5, 1.0, (h, w, a, 4)).astype("float32")
    size = np.asarray([[64, 80], [50, 70]], "float32")
    return scores, deltas, size, anchors, var


@pytest.mark.parametrize("kw", [
    dict(pre_nms_top_n=100, post_nms_top_n=20, nms_thresh=0.5,
         min_size=2.0),
    dict(pre_nms_top_n=60, post_nms_top_n=50, nms_thresh=0.7,
         min_size=0.1, pixel_offset=True),
    dict(pre_nms_top_n=6000, post_nms_top_n=300, nms_thresh=0.3,
         min_size=16.0),
])
def test_generate_proposals(kw):
    case = _rpn_case()
    j, t = _both(lambda P, O, *a: O.generate_proposals(
        *a, return_rois_num=True, **kw), *case)
    assert _np(t[2]).dtype == np.int32
    _same(j[2], t[2], exact=True)
    _same(j[:2], t[:2])
    j2, t2 = _both(lambda P, O, *a: O.generate_proposals(*a, **kw), *case)
    assert len(t2) == 2
    _same(j2, t2)


@pytest.mark.parametrize("pixel_offset", [False, True])
def test_distribute_fpn_proposals(pixel_offset):
    rng = np.random.default_rng(7)
    xy = rng.uniform(0, 300, (40, 2))
    wh = np.exp(rng.uniform(np.log(4), np.log(600), (40, 2)))
    rois = np.concatenate([xy, xy + wh], axis=1).astype("float32")
    num = np.asarray([25, 15], "int32")
    j, t = _both(lambda P, O, r, n: O.distribute_fpn_proposals(
        r, 2, 5, 4, 224, pixel_offset=pixel_offset, rois_num=n), rois, num)
    _same(j[0], t[0], exact=True)
    assert _np(t[1]).shape == (40, 1)
    _same_index(j[1], t[1])
    _same(j[2], t[2], exact=True)
    cat = np.concatenate([_np(o) for o in t[0]], axis=0)
    np.testing.assert_array_equal(cat[_np(t[1]).reshape(-1)], rois)
    j2, t2 = _both(lambda P, O, r: O.distribute_fpn_proposals(
        r, 2, 5, 4, 224), rois)
    assert len(t2) == 2
    _same(j2[0], t2[0], exact=True)
    _same_index(j2[1], t2[1])


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------
def test_conv_norm_activation_from_the_jax_weights():
    jpaddle.seed(0)
    jb = jops.ConvNormActivation(3, 8, 3, stride=2)
    tb = tops.ConvNormActivation(3, 8, 3, stride=2)
    assert [type(m).__name__ for m in tb] == ["Conv2D", "BatchNorm2D",
                                             "ReLU"]
    assert tb[0].bias is None
    vision_state_from_jax({k: _np(v) for k, v in jb.state_dict().items()},
                          jpaddle.get_rng_state(), tb)
    x = np.random.default_rng(8).normal(size=(2, 3, 9, 9)).astype("float32")
    for train in (True, False):
        for blk in (jb, tb):
            blk.train() if train else blk.eval()
        _same(jb(jpaddle.to_tensor(x)), tb(tpaddle.to_tensor(x)))
    for k, v in jb.state_dict().items():      # the running statistics
        _same(v, tb.state_dict()[k])
    # None picks the defaults (batch norm, ReLU), as in the reference
    for O in (jops, tops):
        plain = O.ConvNormActivation(3, 4, 1, norm_layer=None,
                                     activation_layer=None)
        assert len(plain) == 3 and plain[0].bias is None


def test_vision_state_from_jax_names_every_key():
    jpaddle.seed(0)
    jb = jops.ConvNormActivation(3, 8, 3)
    tb = tops.ConvNormActivation(3, 8, 3)
    state = {k: _np(v) for k, v in jb.state_dict().items()}
    assert {"1._mean", "1._variance"} <= set(state)
    for bad in ({k: v for k, v in state.items() if k != "1._mean"},
                {**state, "extra.weight": np.zeros(1, np.float32)}):
        with pytest.raises(KeyError):
            vision_state_from_jax(bad, (0, 0), tb)


def test_read_file_and_decode_jpeg(tmp_path):
    p = tmp_path / "blob.bin"
    p.write_bytes(bytes(range(16)))
    j, t = jops.read_file(str(p)), tops.read_file(str(p))
    _same(j, t, exact=True)
    try:
        from PIL import Image
    except ImportError:
        for O in (jops, tops):
            with pytest.raises(NotImplementedError, match="Pillow"):
                O.decode_jpeg(O.read_file(str(p)))
        return
    img = (np.random.default_rng(9).uniform(size=(12, 10, 3)) * 255
           ).astype(np.uint8)
    buf = _io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    jp = tmp_path / "x.jpg"
    jp.write_bytes(buf.getvalue())
    for mode in ("unchanged", "gray", "rgb"):
        j = jops.decode_jpeg(jops.read_file(str(jp)), mode=mode)
        t = tops.decode_jpeg(tops.read_file(str(jp)), mode=mode)
        _same(j, t, exact=True)


def test_decode_jpeg_without_pillow_raises(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "PIL", None)
    for P, O in ((jpaddle, jops), (tpaddle, tops)):
        with pytest.raises(NotImplementedError, match="Pillow"):
            O.decode_jpeg(P.to_tensor(np.zeros(4, np.uint8)))
