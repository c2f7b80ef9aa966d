"""Every class of the port's ``nn/layers_extra.py`` (and ``nn.CTCLoss`` /
``nn.RNNTLoss``) against the JAX package's, through the layer runner of
``tests/test_torch_nn_layers.py``: the same ``state_dict`` keys, shapes
and dtypes; with the reference's values loaded, the same outputs and
gradients of a seeded cotangent (rtol / atol 1e-5, 1e-4 for the pools and
transposed convolutions). Then the sequence losses' own cases: an
infeasible CTC alignment gives the reference's finite sentinel loss and
its gradient, ``norm_by_times`` and the reductions match, and FastEmit
keeps the RNN-T loss and scales the emission gradients as the reference
does."""
import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
import test_torch_nn_layers as L
from test_torch_nn_layers import LOOSE, TOL, f, ints, pos
from test_torch_nn_layers import _cpu_place  # noqa: F401


def _unpool_idx(r, n, c, out, k, size):
    grids = np.meshgrid(*[np.arange(o) for o in out], indexing="ij")
    flat = np.zeros((n, c) + tuple(out), np.int64)
    for i in range(len(out)):
        flat = flat * size[i] + grids[i] * k + r.integers(
            0, k, (n, c) + tuple(out))
    return flat


def sign(r, *shape):
    return np.sign(f(r, *shape)).astype(np.float32)


_LAB = np.array([[1, 2, 2], [3, 1, 0], [4, 0, 0]])

CASES = [
    ("MaxPool3D", "", "MaxPool3D", (2,), {}, lambda r: [f(r, 1, 2, 4, 4, 4)],
     LOOSE),
    ("AvgPool3D", "", "AvgPool3D", (2,), {"stride": 1, "padding": 1},
     lambda r: [f(r, 1, 2, 3, 4, 4)], LOOSE),
    ("AdaptiveAvgPool1D", "", "AdaptiveAvgPool1D", (3,), {},
     lambda r: [f(r, 2, 3, 7)], LOOSE),
    ("AdaptiveMaxPool1D", "", "AdaptiveMaxPool1D", (4,), {},
     lambda r: [f(r, 2, 3, 8)], LOOSE),
    ("AdaptiveAvgPool3D", "", "AdaptiveAvgPool3D", (2,), {},
     lambda r: [f(r, 1, 2, 5, 4, 4)], LOOSE),
    ("AdaptiveMaxPool3D", "", "AdaptiveMaxPool3D", ([1, 2, 2],), {},
     lambda r: [f(r, 1, 2, 3, 4, 4)], LOOSE),
    ("FractionalMaxPool2D", "", "FractionalMaxPool2D", (3,), {},
     lambda r: [f(r, 1, 2, 7, 7)], LOOSE),
    ("FractionalMaxPool3D", "", "FractionalMaxPool3D", ([2, 2, 2],),
     {"random_u": 0.4}, lambda r: [f(r, 1, 2, 4, 5, 5)], LOOSE),
    ("MaxUnPool1D", "", "MaxUnPool1D", (2,), {},
     lambda r: [f(r, 2, 3, 4), _unpool_idx(r, 2, 3, (4,), 2, (8,))], TOL),
    ("MaxUnPool2D", "", "MaxUnPool2D", (2,), {},
     lambda r: [f(r, 1, 2, 2, 3), _unpool_idx(r, 1, 2, (2, 3), 2, (4, 6))],
     TOL),
    ("MaxUnPool3D", "", "MaxUnPool3D", (2,), {},
     lambda r: [f(r, 1, 1, 2, 2, 2),
                _unpool_idx(r, 1, 1, (2, 2, 2), 2, (4, 4, 4))], TOL),
    ("ChannelShuffle", "", "ChannelShuffle", (2,), {},
     lambda r: [f(r, 1, 4, 2, 2)], TOL),
    ("PixelUnshuffle", "", "PixelUnshuffle", (2,), {},
     lambda r: [f(r, 1, 1, 4, 4)], TOL),
    ("Unflatten", "", "Unflatten", (1, [2, 3]), {},
     lambda r: [f(r, 2, 6)], TOL),
    ("Fold", "", "Fold", ([4, 5], 2), {}, lambda r: [f(r, 1, 8, 12)], TOL),
    ("Softmax2D", "", "Softmax2D", (), {}, lambda r: [f(r, 2, 3, 4, 4)],
     TOL),
    ("RReLU", "", "RReLU", (0.1, 0.3), {}, lambda r: [f(r, 3, 4)], TOL),
    ("Conv1DTranspose", "", "Conv1DTranspose", (4, 3, 3), {"stride": 2},
     lambda r: [f(r, 2, 4, 5)], LOOSE),
    ("Conv3DTranspose", "", "Conv3DTranspose", (2, 3, 2), {},
     lambda r: [f(r, 1, 2, 3, 3, 3)], LOOSE),
    ("GaussianNLLLoss", "", "GaussianNLLLoss", (), {"full": True},
     lambda r: [f(r, 3, 4), f(r, 3, 4), pos(r, 3, 4)], TOL),
    ("HingeEmbeddingLoss", "", "HingeEmbeddingLoss", (), {"margin": 0.5},
     lambda r: [f(r, 3, 4), sign(r, 3, 4)], TOL),
    ("HSigmoidLoss", "", "HSigmoidLoss", (6, 5), {},
     lambda r: [f(r, 4, 6), ints(r, 5, 4)], TOL),
    ("MultiLabelSoftMarginLoss", "", "MultiLabelSoftMarginLoss", (), {},
     lambda r: [f(r, 3, 4), (f(r, 3, 4) > 0).astype(np.float32)], TOL),
    ("MultiMarginLoss", "", "MultiMarginLoss", (), {"p": 2, "margin": 0.5},
     lambda r: [f(r, 4, 5), ints(r, 5, 4)], TOL),
    ("PoissonNLLLoss", "", "PoissonNLLLoss", (), {},
     lambda r: [f(r, 3, 4), pos(r, 3, 4) * 3], TOL),
    ("SoftMarginLoss", "", "SoftMarginLoss", (), {"reduction": "sum"},
     lambda r: [f(r, 3, 4), sign(r, 3, 4)], TOL),
    ("TripletMarginLoss", "", "TripletMarginLoss", (), {"swap": True},
     lambda r: [f(r, 4, 5), f(r, 4, 5), f(r, 4, 5)], TOL),
    ("TripletMarginWithDistanceLoss", "", "TripletMarginWithDistanceLoss",
     (), {"margin": 0.3},
     lambda r: [f(r, 4, 5), f(r, 4, 5), f(r, 4, 5)], TOL),
    ("CTCLoss", "", "CTCLoss", (), {},
     lambda r: [f(r, 6, 3, 5), _LAB, np.array([6, 5, 4]),
                np.array([3, 2, 1])], TOL),
    ("CTCLoss_sum", "", "CTCLoss", (), {"reduction": "sum", "blank": 4},
     lambda r: [f(r, 6, 3, 5), _LAB - (_LAB > 0), np.array([6, 6, 3]),
                np.array([3, 2, 1])], TOL),
    ("RNNTLoss", "", "RNNTLoss", (), {},
     lambda r: [f(r, 2, 4, 3, 5), np.array([[1, 3], [2, 0]]),
                np.array([4, 3]), np.array([2, 1])], TOL),
    ("RNNTLoss_fastemit", "", "RNNTLoss", (),
     {"fastemit_lambda": 0.5, "reduction": "none"},
     lambda r: [f(r, 2, 5, 4, 6), np.array([[1, 3, 5], [2, 4, 0]]),
                np.array([5, 3]), np.array([3, 2])], TOL),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_layer_matches_reference(case):
    L.test_layer_matches_reference(case)


def test_zeropad2d_matches_the_reference_and_keeps_the_gradient():
    """The same padded values; the port's gradient is the cotangent's
    unpadded window, where the reference's ``ZeroPad2D`` (a fresh
    Tensor over ``jnp.pad``) passes none back (ROADMAP queue 3)."""
    x = f(np.random.default_rng(1), 1, 2, 3, 3)
    c = f(np.random.default_rng(2), 1, 2, 6, 4)
    outs = []
    for P in (jpaddle, tpaddle):
        xt = P.to_tensor(x, stop_gradient=False)
        y = P.nn.ZeroPad2D([1, 0, 2, 1])(xt)
        outs.append(np.asarray(y.numpy()))
        if P is tpaddle:
            (y * P.to_tensor(c)).sum().backward()
            np.testing.assert_array_equal(xt.grad.numpy(), c[:, :, 2:5, 1:])
    np.testing.assert_array_equal(outs[1], outs[0])


def _ctc(P, logits, labels, il, ll, **kw):
    x = P.to_tensor(logits, stop_gradient=False)
    loss = P.nn.functional.ctc_loss(x, P.to_tensor(labels), P.to_tensor(il),
                                    P.to_tensor(ll), **kw)
    (loss * P.to_tensor(np.linspace(0.5, 1.5, loss.size).reshape(
        loss.shape).astype(np.float32))).sum().backward()
    return np.asarray(loss.numpy()), np.asarray(x.grad.numpy())


@pytest.mark.parametrize("kw", [dict(reduction="none"),
                                dict(reduction="none", norm_by_times=True),
                                dict(reduction="mean"),
                                dict(reduction="sum", blank=2)],
                         ids=["none", "norm_by_times", "mean", "sum_blank2"])
def test_ctc_loss_infeasible_alignment_matches_reference(kw):
    """Row 0 asks 3 labels with a repeat (4 frames) of 3 frames: the
    reference's loss there is the sentinel's 1e30, finite, and no NaN
    reaches the gradient; the feasible rows agree as usual."""
    r = np.random.default_rng(5)
    logits = f(r, 5, 3, 4)
    labels = np.array([[1, 1, 3], [3, 1, 0], [1, 0, 0]])
    il, ll = np.array([3, 5, 4]), np.array([3, 2, 1])
    ref = _ctc(jpaddle, logits, labels, il, ll, **kw)
    got = _ctc(tpaddle, logits, labels, il, ll, **kw)
    assert np.isfinite(got[0]).all() and np.isfinite(got[1]).all()
    if kw["reduction"] == "none":
        assert got[0][0] > 1e29
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-5, atol=1e-5)


def _rnnt(P, logits, lam, red="none"):
    x = P.to_tensor(logits, stop_gradient=False)
    loss = P.nn.functional.rnnt_loss(
        x, P.to_tensor(np.array([[1, 2, 3], [3, 2, 0]])),
        P.to_tensor(np.array([6, 4])), P.to_tensor(np.array([3, 2])),
        fastemit_lambda=lam, reduction=red)
    loss.sum().backward()
    return np.asarray(loss.numpy()), np.asarray(x.grad.numpy())


def test_rnnt_fastemit_scales_the_gradient_as_the_reference():
    """FastEmit preserves the loss and moves the gradient; both the
    values and the gradients at lambda 0 and 0.7 are the reference's."""
    logits = f(np.random.default_rng(9), 2, 6, 4, 5)
    out = {}
    for lam in (0.0, 0.7):
        ref = _rnnt(jpaddle, logits, lam)
        got = _rnnt(tpaddle, logits, lam)
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[1], ref[1], rtol=1e-5, atol=1e-5)
        out[lam] = got
    np.testing.assert_allclose(out[0.7][0], out[0.0][0], rtol=1e-6)
    assert np.abs(out[0.7][1] - out[0.0][1]).max() > 1e-3


def test_rnnt_long_sequences_hold_the_reference_sum_order():
    """T 40, U 12: the port's anti-diagonal order against the reference's
    row-by-row scan, at rtol 1e-5."""
    r = np.random.default_rng(2)
    B, T, U, V = 3, 40, 12, 7
    logits = f(r, B, T, U + 1, V)
    labels = r.integers(1, V, (B, U))
    il, ll = np.array([40, 31, 17]), np.array([12, 7, 12])
    res = []
    for P in (jpaddle, tpaddle):
        x = P.to_tensor(logits, stop_gradient=False)
        loss = P.nn.functional.rnnt_loss(
            x, P.to_tensor(labels), P.to_tensor(il), P.to_tensor(ll),
            fastemit_lambda=0.0, reduction="sum")
        loss.backward()
        res.append((np.asarray(loss.numpy()), np.asarray(x.grad.numpy())))
    np.testing.assert_allclose(res[1][0], res[0][0], rtol=1e-5)
    np.testing.assert_allclose(res[1][1], res[0][1], rtol=1e-5, atol=1e-6)


def test_rnnt_loss_equals_the_brute_force_sum_over_alignments():
    """A tiny case summed over every monotone path, in float64."""
    r = np.random.default_rng(4)
    T, U, V = 3, 2, 4
    logits = f(r, 1, T, U + 1, V)
    lab = [2, 3]
    lp = logits[0] - np.log(np.exp(logits[0]).sum(-1, keepdims=True))

    def paths(t, u):
        if t == T - 1 and u == U:
            return [lp[t, u, 0]]
        out = []
        if u < U:
            out += [lp[t, u, lab[u]] + p for p in paths(t, u + 1)]
        if t < T - 1:
            out += [lp[t, u, 0] + p for p in paths(t + 1, u)]
        return out

    want = -np.log(np.sum(np.exp(np.array(paths(0, 0), np.float64))))
    got = tpaddle.nn.functional.rnnt_loss(
        tpaddle.to_tensor(logits), tpaddle.to_tensor(np.array([lab])),
        tpaddle.to_tensor(np.array([T])), tpaddle.to_tensor(np.array([U])),
        fastemit_lambda=0.0, reduction="none")
    np.testing.assert_allclose(got.numpy(), [want], rtol=1e-5)
