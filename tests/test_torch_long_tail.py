"""The reference's own scenarios for the long tail, driven through the
port: the test functions of ``tests/test_extras_ops.py``,
``tests/test_nn_extras.py`` and the grid / CTC / RNN-T ones of
``tests/test_r5_ops_optimizers.py`` run again with ``paddle`` (and
``nn``, ``optimizer``, ``F``, and every helper of their module) bound to
``paddle_tpu_torch``; their assertions are the checks. The vision ones
(``tests/test_vision_ops.py``) call ``paddle.vision.ops``, which the port
has not (ROADMAP E2), so their scenarios are restated over the registry
ops and run through both packages. Then the draws: the uniform-based ones
(``rrelu``, the fractional pools, ``top_p_sampling``'s categorical)
bit-identical under ``paddle.seed``; ``binomial`` and ``standard_gamma``
held to ``jax.random``'s distribution (KS or chi-square at p > 1e-3).
"""
import inspect
import sys
import types

import numpy as np
import pytest
from scipy import stats

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
import test_extras_ops
import test_nn_extras
import test_r5_ops_optimizers
from paddle_tpu_torch.core import place as port_place


@pytest.fixture(autouse=True)
def _cpu_place():
    prev = (port_place._current_place, port_place._current_device)
    tpaddle.set_device("cpu")
    yield
    port_place._current_place, port_place._current_device = prev


_PORT_NAMES = {"paddle": tpaddle, "nn": tpaddle.nn,
               "optimizer": tpaddle.optimizer, "F": tpaddle.nn.functional}
# the modules a test body imports from the reference, and the port's
_BODY_IMPORTS = {"paddle_tpu.nn.rnn": "paddle_tpu_torch.nn.rnn"}
_R5 = ("grid_sample", "affine_grid", "stn", "ctc", "rnnt")


def _port_module(mod):
    """A copy of ``mod``'s namespace whose package names and module-level
    functions refer to the port."""
    g = dict(mod.__dict__)
    g.update({k: v for k, v in _PORT_NAMES.items() if k in g})
    for name, obj in mod.__dict__.items():
        if isinstance(obj, types.FunctionType) and \
                obj.__module__ == mod.__name__ and \
                not hasattr(obj, "_pytestfixturefunction") and \
                not hasattr(obj, "_fixture_function_marker"):
            g[name] = types.FunctionType(obj.__code__, g, name,
                                         obj.__defaults__, obj.__closure__)
    return g


def _scenarios():
    out = []
    for mod, pick in ((test_extras_ops, None), (test_nn_extras, None),
                      (test_r5_ops_optimizers, _R5)):
        for name, fn in inspect.getmembers(mod, inspect.isfunction):
            if not name.startswith("test_") or fn.__module__ != mod.__name__:
                continue
            if pick and not any(p in name for p in pick):
                continue
            params = [{}]
            for mark in getattr(fn, "pytestmark", []):
                if mark.name == "parametrize":
                    names = [n.strip() for n in mark.args[0].split(",")]
                    params = [dict(p, **dict(zip(names, v if len(names) > 1
                                                 else (v,))))
                              for p in params for v in mark.args[1]]
            for p in params:
                pid = "-".join(str(v) for v in p.values())
                out.append(pytest.param(mod, name, p, id=f"{mod.__name__}::"
                                        f"{name}" + (f"[{pid}]" if pid
                                                     else "")))
    return out


@pytest.mark.parametrize("mod,name,params", _scenarios())
def test_reference_scenario_passes_on_the_port(mod, name, params,
                                               monkeypatch, tmp_path):
    g = _port_module(mod)
    for ref, port in _BODY_IMPORTS.items():
        __import__(port)
        monkeypatch.setitem(sys.modules, ref, sys.modules[port])
    fn = g[name]
    kw = dict(params)
    for arg in inspect.signature(fn).parameters:
        if arg == "rng":
            kw[arg] = np.random.default_rng(0)
        elif arg == "tmp_path":
            kw[arg] = tmp_path
    tpaddle.seed(0)
    fn(**kw)


# ---------------------------------------------------------------------------
# the vision scenarios over the registry ops, in both packages
# ---------------------------------------------------------------------------
def _both(fn):
    """fn(P) in each package; the two results (lists of arrays)."""
    out = []
    for P in (jpaddle, tpaddle):
        res = fn(P)
        out.append([np.asarray(r.numpy()) if hasattr(r, "numpy") else r
                    for r in res])
    return out


def test_roi_align_constant_map_and_linear_ramp():
    def run(P):
        x = np.full((1, 3, 16, 16), 7.0, "float32")
        boxes = np.asarray([[2, 2, 10, 10], [0, 0, 15, 15]], "float32")
        c = P.roi_align(P.to_tensor(x), P.to_tensor(boxes),
                        P.to_tensor(np.array([0, 0])), output_size=(4, 4))
        ramp = np.tile(np.arange(16, dtype="float32"), (16, 1))[None, None]
        r = P.roi_align(P.to_tensor(ramp),
                        P.to_tensor(np.asarray([[4., 4., 12., 12.]],
                                               "float32")),
                        P.to_tensor(np.array([0])), output_size=(2, 2),
                        sampling_ratio=2, aligned=True)
        return [c, r]

    ref, got = _both(run)
    np.testing.assert_allclose(got[0], 7.0, rtol=1e-6)
    assert got[0].shape == (2, 3, 4, 4)
    np.testing.assert_allclose(got[1][0, 0, 0, 0], 5.5, atol=1e-5)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


def test_roi_pool_and_psroi_pool_semantics():
    def run(P):
        x = np.zeros((1, 1, 8, 8), "float32")
        x[0, 0, 2, 2], x[0, 0, 5, 5] = 5.0, 9.0
        rp = P.roi_pool(P.to_tensor(x),
                        P.to_tensor(np.asarray([[0, 0, 7, 7]], "float32")),
                        P.to_tensor(np.array([0])), output_size=(2, 2))
        xs = np.zeros((1, 12, 6, 6), "float32")
        for c in range(12):
            xs[0, c] = float(c)
        ps = P.psroi_pool(P.to_tensor(xs),
                          P.to_tensor(np.asarray([[0, 0, 6, 6]], "float32")),
                          P.to_tensor(np.array([0])), output_size=(2, 2))
        return [rp, ps]

    ref, got = _both(run)
    assert got[0][0, 0, 0, 0] == 5.0 and got[0][0, 0, 1, 1] == 9.0
    want = np.arange(12, dtype=np.float32).reshape(1, 3, 2, 2)
    np.testing.assert_array_equal(got[1], want)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b, a)


def test_deform_conv2d_zero_offset_is_conv2d_and_mask_scales():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 4, 9, 9)).astype("float32")
    w = rng.normal(size=(6, 4, 3, 3)).astype("float32") * 0.1
    off = np.zeros((2, 18, 7, 7), "float32")
    half = np.full((2, 9, 7, 7), 0.5, "float32")

    def run(P):
        t = P.to_tensor
        d = P.deform_conv2d(t(x), t(off), t(w))
        m = P.deform_conv2d(t(x), t(off), t(w), mask=t(half))
        return [d, m, P.nn.functional.conv2d(t(x), t(w))]

    ref, got = _both(run)
    np.testing.assert_allclose(got[0], got[2], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[1], got[0] * 0.5, rtol=1e-4, atol=1e-5)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)


def test_yolo_loss_decreases_on_fit_in_both_packages():
    rng = np.random.default_rng(0)
    x0 = rng.normal(scale=0.1, size=(1, 24, 4, 4)).astype("float32")
    gtb = np.asarray([[[0.5, 0.5, 0.3, 0.4]]], "float32")
    gtl = np.asarray([[1]], "int64")

    def run(P):
        x = P.to_tensor(x0, stop_gradient=False)
        losses = []
        for _ in range(12):
            loss = P.yolo_loss(x, P.to_tensor(gtb), P.to_tensor(gtl),
                               anchors=[10, 13, 16, 30, 33, 23],
                               anchor_mask=[0, 1, 2], class_num=3,
                               ignore_thresh=0.7, downsample_ratio=8)
            P.sum(loss).backward()
            losses.append(float(P.sum(loss)))
            x = P.to_tensor(x.numpy() - 0.1 * x.grad.numpy(),
                            stop_gradient=False)
        return [np.asarray(losses)]

    ref, got = _both(run)
    assert got[0][-1] < got[0][0]
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-4)


# ---------------------------------------------------------------------------
# the draws
# ---------------------------------------------------------------------------
def _drawn(fn, seed=13):
    out = []
    for P in (jpaddle, tpaddle):
        P.seed(seed)
        res = fn(P)
        out.append([np.asarray(r.numpy()) for r in res])
        out.append(P.get_rng_state())
    return out


def test_uniform_based_draws_are_bit_identical():
    """rrelu's slopes, the fractional pools' u, top_p_sampling's
    categorical: one sequence of draws under one seed."""
    x = np.random.default_rng(0).standard_normal((2, 3, 9, 9)).astype(
        np.float32)
    probs = np.random.default_rng(1).dirichlet(np.ones(12), 5).astype(
        np.float32)

    def run(P):
        t = P.to_tensor(x)
        a = P.rrelu(t)
        b = P.fractional_max_pool2d(t, 4)
        c, m = P.fractional_max_pool2d(t, [3, 5], return_mask=True)
        d = P.fractional_max_pool3d(P.to_tensor(x[:, :, None].repeat(
            4, 2)), [2, 3, 3])
        v, ids = P.top_p_sampling(P.to_tensor(probs),
                                  P.to_tensor(np.full(5, 0.7, np.float32)))
        return [a, b, c, m, d, v, ids]

    ref, rs, got, gs = _drawn(run)
    assert rs == gs
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b, a.astype(b.dtype))


def test_top_p_sampling_with_threshold_and_seed():
    probs = np.random.default_rng(2).dirichlet(np.ones(9), 6).astype(
        np.float32)

    def run(P):
        return P.top_p_sampling(P.to_tensor(probs),
                                P.to_tensor(np.full(6, 0.9, np.float32)),
                                threshold=P.to_tensor(np.full(
                                    6, 0.05, np.float32)), seed=5)

    ref, rs, got, gs = _drawn(run)
    assert rs == gs
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b, a.astype(b.dtype))


def _samples(P, fn, seeds):
    out = []
    for s in seeds:
        P.seed(s)
        out.append(np.asarray(fn(P).numpy()))
    return np.concatenate([o.reshape(-1) for o in out])


@pytest.mark.parametrize("count,p", [(20, 0.3), (200, 0.6), (5, 0.9)])
def test_binomial_same_distribution_as_reference(count, p):
    """Inversion (count * q <= 10) and BTRS (above): chi-square of the
    port's counts against the exact pmf, and the reference's draws beside
    them."""
    def fn(P):
        return P.binomial(P.to_tensor(np.full((2000,), count, np.int64)),
                          P.to_tensor(np.full((2000,), p, np.float32)))

    got = _samples(tpaddle, fn, range(3))
    ref = _samples(jpaddle, fn, range(3))
    assert got.min() >= 0 and got.max() <= count
    k = np.arange(count + 1)
    pmf = stats.binom.pmf(k, count, p)
    # pool the tails into bins of at least 5 expected draws
    edges = [0]
    acc = 0.0
    for i, v in enumerate(pmf * got.size):
        acc += v
        if acc >= 5:
            edges.append(i + 1)
            acc = 0.0
    edges[-1] = count + 1
    for sample in (got, ref):
        obs = np.histogram(sample, bins=edges)[0]
        exp = np.add.reduceat(pmf, edges[:-1]) * sample.size
        assert stats.chisquare(obs, exp * obs.sum() / exp.sum()).pvalue \
            > 1e-3
    assert abs(got.mean() - count * p) < 4 * np.sqrt(
        count * p * (1 - p) / got.size)


@pytest.mark.parametrize("alpha", [0.4, 1.0, 3.5])
def test_standard_gamma_same_distribution_as_reference(alpha):
    def fn(P):
        return P.standard_gamma(P.to_tensor(np.full((3000,), alpha,
                                                    np.float32)))

    got = _samples(tpaddle, fn, range(2))
    ref = _samples(jpaddle, fn, range(2))
    assert (got > 0).all()
    assert stats.kstest(got, stats.gamma(alpha).cdf).pvalue > 1e-3
    assert stats.ks_2samp(got, ref).pvalue > 1e-3


def test_standard_gamma_gradient_is_the_reference_reparameterization():
    """d sample / d alpha: the implicit gradient, as jax.random.gamma's;
    checked on the port's own sample against the reference's formula
    (-dF/dalpha / pdf) by a finite difference of the CDF."""
    a = tpaddle.to_tensor(np.array([0.5, 1.5, 4.0], np.float32),
                          stop_gradient=False)
    tpaddle.seed(3)
    s = tpaddle.standard_gamma(a)
    s.sum().backward()
    sv = s.numpy().astype(np.float64)
    av = a.numpy().astype(np.float64)
    h = 1e-5
    dF = (stats.gamma(av + h).cdf(sv) - stats.gamma(av - h).cdf(sv)) / (2 * h)
    want = -dF / stats.gamma(av).pdf(sv)
    np.testing.assert_allclose(a.grad.numpy(), want, rtol=1e-3)


# ---------------------------------------------------------------------------
# the packed flash wrappers and the sparse-mask attention, on the CPU
# ---------------------------------------------------------------------------
def test_flash_attn_qkvpacked_matches_reference_and_packs_the_gradient():
    """Forward values against the reference's wrapper (its Pallas kernel
    in interpret mode); the port's gradient comes back packed and equals
    ``F.flash_attention``'s on the slices (the reference's wrapper takes
    the slices' data, so its tape gives the packed tensor none: ROADMAP
    queue 3)."""
    x = np.random.default_rng(8).standard_normal((2, 64, 3, 2, 16)).astype(
        np.float32)
    do = np.random.default_rng(9).standard_normal((2, 64, 2, 16)).astype(
        np.float32)
    ref, _ = jpaddle.nn.functional.flash_attn_qkvpacked(
        jpaddle.to_tensor(x), causal=True)
    qkv = tpaddle.to_tensor(x, stop_gradient=False)
    out, none = tpaddle.nn.functional.flash_attn_qkvpacked(qkv, causal=True)
    assert none is None
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    out.backward(tpaddle.to_tensor(do))
    parts = [tpaddle.to_tensor(x[:, :, i], stop_gradient=False)
             for i in range(3)]
    o2, _ = tpaddle.nn.functional.flash_attention(*parts, causal=True)
    o2.backward(tpaddle.to_tensor(do))
    np.testing.assert_array_equal(out.numpy(), o2.numpy())
    g = qkv.grad.numpy()
    assert g.shape == x.shape
    for i in range(3):
        np.testing.assert_array_equal(g[:, :, i], parts[i].grad.numpy())


def test_flash_attn_varlen_qkvpacked_matches_reference():
    lens = [9, 3, 14]
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    x = np.random.default_rng(10).standard_normal(
        (int(cu[-1]), 3, 2, 16)).astype(np.float32)
    outs = []
    for P in (jpaddle, tpaddle):
        o, _ = P.nn.functional.flash_attn_varlen_qkvpacked(
            P.to_tensor(x), P.to_tensor(cu), P.to_tensor(cu), 14, 14,
            causal=True)
        outs.append(np.asarray(o.numpy()))
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_with_sparse_mask_matches_reference(dtype):
    """Row-sparse causal masks: live rows agree; a row that sees no
    column is NaN in both packages in bf16 (float32's lowest rounds to
    -inf there) and in f32 the mean of V in both (ROADMAP queue 3)."""
    B, S, H, D = 2, 8, 2, 16
    r = np.random.default_rng(11)
    q, k, v = (r.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    start = np.full((B, H, S), S, np.int32)
    start[0, 0, :] = [3, 8, 8, 8, 8, 8, 8, 8]      # column 0 hidden from 3
    start[1, 1, 0] = 0                             # column 0 hidden always
    outs = []
    for P in (jpaddle, tpaddle):
        t = [P.to_tensor(a, dtype=dtype) for a in (q, k, v)]
        o = P.nn.functional.flash_attention_with_sparse_mask(
            *t, attn_mask_start_row_indices=P.to_tensor(start))
        outs.append(np.asarray(o.astype("float32").numpy()))
    ref, got = outs
    dead = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), dead)
    if dtype == "bfloat16":
        assert dead[1, 0, 1].all()          # row 0 of head 1 sees nothing
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got[~dead], ref[~dead], rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the functionals of nn/functional (extras and __init__), both packages
# ---------------------------------------------------------------------------
def _fx(r, *shape):
    return r.standard_normal(shape).astype(np.float32)


_F_CASES = {
    "log_sigmoid": lambda F, t, r: F.log_sigmoid(t(_fx(r, 3, 4))),
    "zeropad2d": lambda F, t, r: F.zeropad2d(t(_fx(r, 1, 2, 3, 3)),
                                             [1, 2, 0, 1]),
    "zeropad2d_nhwc": lambda F, t, r: F.zeropad2d(
        t(_fx(r, 1, 3, 3, 2)), 1, data_format="NHWC"),
    "alpha_dropout": lambda F, t, r: F.alpha_dropout(t(_fx(r, 4, 6)), 0.3),
    "dropout2d": lambda F, t, r: F.dropout2d(t(_fx(r, 2, 3, 4, 4)), 0.5),
    "dropout3d": lambda F, t, r: F.dropout3d(t(_fx(r, 2, 3, 2, 2, 2)), 0.5),
    "bilinear": lambda F, t, r: F.bilinear(t(_fx(r, 3, 4)), t(_fx(r, 3, 5)),
                                           t(_fx(r, 2, 4, 5)),
                                           t(_fx(r, 2))),
    "maxout": lambda F, t, r: F.maxout(t(_fx(r, 2, 6, 3)), 2),
    "dice_loss": lambda F, t, r: F.dice_loss(
        t(np.abs(_fx(r, 3, 4))), t(r.integers(0, 4, (3, 1)))),
    "log_loss": lambda F, t, r: F.log_loss(
        t(r.uniform(0.05, 0.95, (3, 1)).astype(np.float32)),
        t((r.random((3, 1)) > 0.5).astype(np.float32))),
    "square_error_cost": lambda F, t, r: F.square_error_cost(
        t(_fx(r, 3, 2)), t(_fx(r, 3, 2))),
    "npair_loss": lambda F, t, r: F.npair_loss(
        t(_fx(r, 4, 3)), t(_fx(r, 4, 3)), t(np.array([0, 1, 0, 2]))),
    "pairwise_distance": lambda F, t, r: F.pairwise_distance(
        t(_fx(r, 3, 5)), t(_fx(r, 3, 5)), p=3.0, keepdim=True),
    "temporal_shift": lambda F, t, r: F.temporal_shift(
        t(_fx(r, 4, 8, 2, 2)), 2),
    "temporal_shift_nhwc": lambda F, t, r: F.temporal_shift(
        t(_fx(r, 6, 2, 2, 8)), 3, shift_ratio=0.125, data_format="NHWC"),
    "gather_tree": lambda F, t, r: F.gather_tree(
        t(r.integers(0, 9, (4, 2, 3))), t(r.integers(0, 3, (4, 2, 3)))),
    "margin_cross_entropy": lambda F, t, r: F.margin_cross_entropy(
        t(r.uniform(-0.9, 0.9, (4, 6)).astype(np.float32)),
        t(r.integers(0, 6, (4,))), return_softmax=True, reduction="none"),
    "margin_cross_entropy_mean": lambda F, t, r: F.margin_cross_entropy(
        t(r.uniform(-0.9, 0.9, (4, 6)).astype(np.float32)),
        t(r.integers(0, 6, (4,))), margin2=0.3, scale=16.0),
    "triplet_margin_with_distance_loss": lambda F, t, r:
        F.triplet_margin_with_distance_loss(
            t(_fx(r, 4, 5)), t(_fx(r, 4, 5)), t(_fx(r, 4, 5)),
            distance_function=F.pairwise_distance, swap=True),
    "upsample": lambda F, t, r: F.upsample(t(_fx(r, 1, 2, 3, 4)),
                                           scale_factor=2),
    "sequence_mask": lambda F, t, r: F.sequence_mask(
        t(np.array([1, 3, 0, 4])), dtype="float32"),
    "sequence_mask_maxlen": lambda F, t, r: F.sequence_mask(
        t(np.array([[2, 5]])), maxlen=6, dtype="int32"),
    "label_smooth": lambda F, t, r: F.label_smooth(
        t(np.eye(4, dtype=np.float32)), epsilon=0.2),
    "label_smooth_prior": lambda F, t, r: F.label_smooth(
        t(np.eye(3, dtype=np.float32)),
        prior_dist=t(np.array([0.2, 0.3, 0.5], np.float32))),
    "relu_": lambda F, t, r: F.relu_(t(_fx(r, 3, 4))),
    "leaky_relu_": lambda F, t, r: F.leaky_relu_(t(_fx(r, 3, 4)), 0.2),
    "softmax_": lambda F, t, r: F.softmax_(t(_fx(r, 3, 4))),
}


@pytest.mark.parametrize("name", sorted(_F_CASES))
def test_functional_matches_reference(name):
    outs = []
    for P in (jpaddle, tpaddle):
        P.seed(21)
        r = np.random.default_rng(21)
        out = _F_CASES[name](P.nn.functional, P.to_tensor, r)
        outs.append([np.asarray(o.numpy()) for o in (
            out if isinstance(out, (tuple, list)) else [out])])
        outs.append(P.get_rng_state())
    ref, rs, got, gs = outs
    assert rs == gs
    for a, b in zip(ref, got):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a.astype(b.dtype), rtol=1e-5,
                                   atol=1e-6)


def test_class_center_sample_and_sparse_attention():
    """The sampled centers hold every positive class and remap the
    labels onto them (the negatives come from numpy's fresh entropy in
    both packages); ``sparse_attention`` raises the reference's error."""
    lab = np.array([3, 7, 3, 1], np.int64)
    for P in (jpaddle, tpaddle):
        new, centers = P.nn.functional.class_center_sample(
            P.to_tensor(lab), 10, 6)
        c, n = np.asarray(centers.numpy()), np.asarray(new.numpy())
        assert len(c) == 6 and set(lab) <= set(c.tolist())
        np.testing.assert_array_equal(c[n], lab)
    errs = []
    for P in (jpaddle, tpaddle):
        with pytest.raises(NotImplementedError) as e:
            P.nn.functional.sparse_attention(None, None, None, None, None)
        errs.append(str(e.value))
    assert errs[0] == errs[1]
