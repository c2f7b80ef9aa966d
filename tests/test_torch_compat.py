"""The namespace completion (``paddle_tpu_torch/compat_extra.py``) and the
Tensor's Python protocol against the JAX package.

F5 (ROADMAP queue 3, closed): the port raises the reference's
``TypeError`` where it used to answer: ``float()``, ``int()`` and
``__index__`` of a tensor with ``ndim > 0``, and a non-tuple list as an
index. The module-level in-place variants rebind their first argument to
the reference's result (values at rtol 1e-6); the aliases, dtype
predicates and the Tensor methods bound from module functions are there
and agree."""
import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.core import place as port_place


@pytest.fixture(autouse=True)
def _cpu_place():
    prev = (port_place._current_place, port_place._current_device)
    tpaddle.set_device("cpu")
    yield
    port_place._current_place, port_place._current_device = prev


def _raises(fn):
    try:
        fn()
    except TypeError as e:
        return str(e).split(";")[0]
    return None


@pytest.mark.parametrize("case", ["float", "int", "index", "list_index"])
def test_f5_the_port_raises_the_reference_type_errors(case):
    """ROADMAP's inputs: ``float(to_tensor([2.5]))``, ``int(...)``,
    ``[1, 2, 3][to_tensor([1])]`` and ``to_tensor(np.arange(6.).reshape(2,
    3))[[1, 0]]``: a ``TypeError`` with the reference's message in both
    packages."""
    fns = {"float": lambda P: float(P.to_tensor([2.5])),
           "int": lambda P: int(P.to_tensor([2.5])),
           "index": lambda P: [1, 2, 3][P.to_tensor([1])],
           "list_index": lambda P: P.to_tensor(
               np.arange(6.).reshape(2, 3))[[1, 0]]}
    ref = _raises(lambda: fns[case](jpaddle))
    got = _raises(lambda: fns[case](tpaddle))
    assert ref is not None and got == ref


def test_f5_what_still_converts_and_indexes():
    for P in (jpaddle, tpaddle):
        assert float(P.to_tensor(2.5)) == 2.5
        assert int(P.to_tensor(7)) == 7
        assert [1, 2, 3][P.to_tensor(1)] == 2
        x = P.to_tensor(np.arange(6.).reshape(2, 3))
        np.testing.assert_array_equal(np.asarray(x[(1, 0)].numpy()), 3.0)
        np.testing.assert_array_equal(
            np.asarray(x[(slice(None), [2, 0])].numpy()), [[2, 0], [5, 3]])
        np.testing.assert_array_equal(
            np.asarray(x[P.to_tensor(np.array([1, 0]))].numpy()),
            [[3, 4, 5], [0, 1, 2]])


# (name, args after x, input maker)
_INPLACE = [
    ("abs_", (), "f"), ("exp_", (), "f"), ("sqrt_", (), "pos"),
    ("log_", (), "pos"), ("tanh_", (), "f"), ("floor_", (), "f"),
    ("ceil_", (), "f"), ("round_", (), "f"), ("neg_", (), "f"),
    ("reciprocal_", (), "pos"), ("rsqrt_", (), "pos"), ("square_", (), "f"),
    ("sign_", (), "f"), ("sin_", (), "f"), ("erf_", (), "f"),
    ("clip_", (-0.5, 0.5), "f"), ("scale_", (2.0, 1.0), "f"),
    ("add_", ("y",), "f"), ("subtract_", ("y",), "f"),
    ("multiply_", ("y",), "f"), ("divide_", ("ypos",), "f"),
    ("pow_", (2.0,), "pos"), ("maximum_", ("y",), "f"),
    ("remainder_", ("ypos",), "pos"), ("mod_", ("ypos",), "pos"),
    ("floor_mod_", ("ypos",), "pos"), ("reshape_", ([4, 3],), "f"),
    ("unsqueeze_", (0,), "f"), ("flatten_", (), "f"),
    ("transpose_", ([1, 0],), "f"), ("t_", (), "f"), ("tril_", (), "f"),
    ("cumsum_", (1,), "f"), ("lerp_", ("y", 0.3), "f"),
]


@pytest.mark.parametrize("name,args,kind", _INPLACE,
                         ids=[c[0] for c in _INPLACE])
def test_module_inplace_variant_rebinds_to_the_reference_result(name, args,
                                                                kind):
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal((3, 4)).astype(np.float32)
    if kind == "pos":
        x = np.abs(x) + 0.5
    y = rng.standard_normal((3, 4)).astype(np.float32)
    ypos = np.abs(y) + 0.5
    out = []
    for P in (jpaddle, tpaddle):
        t = P.to_tensor(x)
        a = [P.to_tensor(y) if v == "y" else P.to_tensor(ypos)
             if v == "ypos" else v for v in args]
        r = getattr(P, name)(t, *a)
        assert r is t, name
        out.append(np.asarray(t.numpy()))
    assert out[0].shape == out[1].shape
    np.testing.assert_allclose(out[1], out[0], rtol=1e-6, atol=1e-6)


def test_aliases_predicates_and_small_utilities():
    x_np = np.arange(12, dtype=np.float32).reshape(3, 4) - 5.0
    res = []
    for P in (jpaddle, tpaddle):
        x = P.to_tensor(x_np)
        y = P.to_tensor(np.ones((4, 2), np.float32))
        cond = P.to_tensor(x_np > 0)
        w = P.to_tensor(x_np)
        P.where_(cond, w, P.to_tensor(np.zeros_like(x_np)))
        res.append([
            np.asarray(P.mm(x, y).numpy()),
            np.asarray(P.mod(x, P.to_tensor(np.full_like(x_np, 3.0))).numpy()),
            np.asarray(P.floor_mod(x, P.to_tensor(
                np.full_like(x_np, 3.0))).numpy()),
            np.asarray(P.view(x, [2, 6]).numpy()),
            np.asarray(P.view_as(x, P.to_tensor(np.zeros((6, 2)))).numpy()),
            np.asarray(P.clone(x).numpy()), np.asarray(w.numpy()),
            int(P.rank(x).numpy()), str(P.rank(x).dtype.name),
            list(np.asarray(P.shape(x).numpy())), P.shape(x).dtype.name,
            [P.is_floating_point(x), P.is_integer(x), P.is_complex(x)],
            [x.is_floating_point(), x.is_integer(), x.is_complex()],
            [P.is_integer(P.to_tensor(np.arange(3)))],
            np.asarray(x.mm(y).numpy()), np.asarray(x.view([12]).numpy()),
            np.asarray(x.floor_mod(P.to_tensor(
                np.full_like(x_np, 4.0))).numpy()),
            int(x.rank().numpy())])
    ref, got = res
    for a, b in zip(ref, got):
        if isinstance(a, np.ndarray):
            np.testing.assert_allclose(b, a, rtol=1e-6)
        else:
            assert a == b


def test_tensor_methods_bound_from_module_functions():
    """Every name of the reference's bound list that the port has is a
    Tensor method in both packages."""
    from paddle_tpu_torch import compat_extra

    names = ["concat", "stack", "mm", "view", "view_as", "where_", "rank",
             "uniform_", "exponential_", "floor_mod", "is_tensor",
             "tensordot", "broadcast_tensors", "atleast_1d", "unfold"]
    for nm in names:
        has_ref = hasattr(jpaddle.Tensor, nm)
        port_fn = compat_extra.EXPORTS.get(nm) or getattr(tpaddle, nm, None)
        if port_fn is not None:
            assert hasattr(tpaddle.Tensor, nm) and has_ref, nm
    for nm in compat_extra.EXPORTS:
        assert getattr(tpaddle, nm) is compat_extra.EXPORTS[nm], nm
        assert nm in dir(jpaddle), nm


# ---------------------------------------------------------------------------
# the rest of compat_extra, signal, fft, linalg, and the namespaces
# ---------------------------------------------------------------------------
def _pub(m):
    return {n for n in dir(m) if not n.startswith("_")}


@pytest.mark.parametrize("where", ["nn", "nn.functional", "compat_extra",
                                   "signal", "fft", "linalg"])
def test_port_exports_every_public_name_of_the_reference(where):
    """``nn``: every public attribute; ``nn.functional``: ``__all__`` (the
    same list, in the port's ``__all__`` too); the top level: every name
    of ``compat_extra.EXPORTS``; ``signal``, ``fft``, ``linalg``: their
    ``__all__``."""
    def resolve(P, path):
        m = P
        for part in path.split("."):
            m = getattr(m, part)
        return m

    if where == "compat_extra":
        missing = set(jpaddle.compat_extra.EXPORTS) - _pub(tpaddle)
    elif where == "nn":
        missing = _pub(jpaddle.nn) - _pub(tpaddle.nn)
    else:
        ref = resolve(jpaddle, where)
        got = resolve(tpaddle, where)
        missing = set(ref.__all__) - _pub(got)
        assert set(ref.__all__) <= set(got.__all__)
    assert not missing, sorted(missing)


def _np(t):
    return np.asarray(t.numpy())


def test_histogramdd_matches_reference():
    r = np.random.default_rng(0)
    x = r.standard_normal((50, 2)).astype(np.float32)
    w = r.uniform(0, 1, 50).astype(np.float32)
    for kw in (dict(bins=4), dict(bins=[3, 5], ranges=[[-1, 1], [-2, 2]],
                                 weights=w), dict(bins=3, density=True)):
        outs = []
        for P in (jpaddle, tpaddle):
            kw2 = dict(kw)
            if "weights" in kw2:
                kw2["weights"] = P.to_tensor(kw2["weights"])
            h, edges = P.histogramdd(P.to_tensor(x), **kw2)
            outs.append((_np(h), [_np(e) for e in edges]))
        np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-5,
                                   atol=1e-6)
        for a, b in zip(outs[0][1], outs[1][1]):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


def test_small_utilities_match_reference():
    for P in (jpaddle, tpaddle):
        assert P.broadcast_shape([2, 1, 3], [4, 3]) == [2, 4, 3]
        x = P.to_tensor(np.array([1.0, 2.0], np.float32))
        y = P.increment(x, 2.5)
        assert y is x
        np.testing.assert_array_equal(x.numpy(), [3.5, 4.5])
        big = P.to_tensor(np.arange(24, dtype=np.float32).reshape(2, 3, 4))
        np.testing.assert_array_equal(
            P.reduce_as(big, P.to_tensor(np.zeros((3, 1), np.float32)))
            .numpy(), np.arange(24.).reshape(2, 3, 4).sum((0, 2))[:, None])
        reader = P.batch(lambda: iter(range(7)), 3)
        assert list(reader()) == [[0, 1, 2], [3, 4, 5], [6]]
        assert list(P.batch(lambda: iter(range(7)), 3, True)()) == \
            [[0, 1, 2], [3, 4, 5]]
        assert P.check_shape(big, [2, -1, 4])
        with pytest.raises(ValueError):
            P.check_shape(big, [2, 4])
        assert P.disable_signal_handler() is None
        with P.LazyGuard() as g:
            assert g is not None
        t = P.create_tensor("float32", name="ct")
        assert list(t.shape) == [0] and t.name == "ct"


def test_set_printoptions_forwards_to_numpy():
    prev = np.get_printoptions()
    try:
        tpaddle.set_printoptions(precision=3, threshold=50, edgeitems=2,
                                 sci_mode=False, linewidth=60)
        o = np.get_printoptions()
        assert (o["precision"], o["threshold"], o["edgeitems"],
                o["suppress"], o["linewidth"]) == (3, 50, 2, True, 60)
    finally:
        np.set_printoptions(**prev)


@pytest.mark.parametrize("dtype", ["int8", "int32", "int64"])
def test_bit_shifts_match_reference(dtype):
    """int64 stays int64 in the port (ROADMAP queue 3, by design), where
    the JAX package computes in int32: its logical right shift is held to
    numpy's 64-bit one."""
    x = np.array([-128, -7, -1, 0, 1, 5, 100], dtype)
    s = np.array([1, 2, 3, 1, 0, 2, 4], dtype)
    for arith in (True, False):
        outs = [_np(P.bitwise_right_shift(P.to_tensor(x), P.to_tensor(s),
                                          is_arithmetic=arith))
                for P in (jpaddle, tpaddle)]
        if dtype == "int64" and not arith:
            want = (x.view(np.uint64) >> s.astype(np.uint64)).view(np.int64)
            np.testing.assert_array_equal(outs[1], want)
            continue
        np.testing.assert_array_equal(outs[1], outs[0].astype(outs[1].dtype))
    outs = [_np(P.bitwise_left_shift(P.to_tensor(x), P.to_tensor(s)))
            for P in (jpaddle, tpaddle)]
    np.testing.assert_array_equal(outs[1], outs[0].astype(outs[1].dtype))
    t = tpaddle.to_tensor(x)
    tpaddle.bitwise_left_shift_(t, tpaddle.to_tensor(s))
    np.testing.assert_array_equal(_np(t), outs[1])


def test_create_parameter_draws_as_the_reference():
    outs = []
    for P in (jpaddle, tpaddle):
        P.seed(7)
        w = P.create_parameter([4, 5], "float32")
        b = P.create_parameter([5], "float32", is_bias=True)
        outs.append((_np(w), _np(b), w.stop_gradient))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    np.testing.assert_array_equal(outs[1][1], outs[0][1])
    assert outs[1][2] == outs[0][2] is False


def test_linalg_long_tail_matches_reference():
    r = np.random.default_rng(3)
    a = r.standard_normal((4, 4)).astype(np.float32)
    spd = (a @ a.T + 4 * np.eye(4)).astype(np.float32)
    b = r.standard_normal((4, 2)).astype(np.float32)
    chol = np.linalg.cholesky(spd).astype(np.float32)
    res = {}
    for P in (jpaddle, tpaddle):
        t = P.to_tensor
        out = {"cs": _np(P.cholesky_solve(t(b), t(chol))),
               "ev": np.sort_complex(_np(P.eigvals(t(a))))}
        w, v = P.eig(t(a))
        out["eig"] = (_np(w), _np(v))
        out["ormqr"] = _np(P.ormqr(t(a), t(np.array([1.2, 0.5, 0.3],
                                                     np.float32)), t(b)))
        out["ormqr_t"] = _np(P.ormqr(t(a), t(np.array([1.2, 0.5],
                                                       np.float32)),
                                     t(b.T.copy()), left=False,
                                     transpose=True))
        u, s, vv = P.svd_lowrank(t(a[:, :3]), q=2)
        out["svd"] = _np(u) @ np.diag(_np(s)) @ _np(vv).T
        u, s, vv = P.pca_lowrank(t(a), q=3)
        out["pca"] = (_np(s), _np(u) @ np.diag(_np(s)) @ _np(vv).T)
        res[P.__name__] = out
    ref, got = res["paddle_tpu"], res["paddle_tpu_torch"]
    np.testing.assert_allclose(got["cs"], ref["cs"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["cs"], np.linalg.solve(spd, b),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["ev"], ref["ev"], rtol=1e-4, atol=1e-5)
    w, v = got["eig"]
    assert w.dtype == ref["eig"][0].dtype and v.dtype == ref["eig"][1].dtype
    np.testing.assert_allclose(a @ v, v * w[None, :], rtol=1e-4, atol=1e-4)
    for k in ("ormqr", "ormqr_t", "svd"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["pca"][0], ref["pca"][0], rtol=1e-4)
    np.testing.assert_allclose(got["pca"][1], ref["pca"][1], rtol=1e-4,
                               atol=1e-5)


def test_lu_unpack_matches_reference():
    """The same packed factorization (LAPACK's, 1-based pivots) into
    both: the same P, L and U, and P L U is the matrix."""
    from scipy.linalg import lu_factor

    r = np.random.default_rng(4)
    a = r.standard_normal((2, 4, 4)).astype(np.float32)
    packed = [lu_factor(m) for m in a]
    lu = np.stack([p[0] for p in packed]).astype(np.float32)
    piv = np.stack([p[1] + 1 for p in packed]).astype(np.int32)
    outs = []
    for P in (jpaddle, tpaddle):
        p, l_, u = P.lu_unpack(P.to_tensor(lu), P.to_tensor(piv))
        outs.append([_np(p), _np(l_), _np(u)])
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    for i in (1, 2):
        np.testing.assert_allclose(outs[1][i], outs[0][i], rtol=1e-6)
    np.testing.assert_allclose(outs[1][0] @ outs[1][1] @ outs[1][2], a,
                               rtol=1e-4, atol=1e-5)
    none = tpaddle.lu_unpack(tpaddle.to_tensor(lu[0]),
                             tpaddle.to_tensor(piv[0]), unpack_ludata=False)
    assert none[1] is None and none[2] is None and none[0] is not None


@pytest.mark.parametrize("kw", [dict(n_fft=16),
                                dict(n_fft=16, hop_length=3, win_length=12,
                                     window="hann", normalized=True),
                                dict(n_fft=8, center=False,
                                     onesided=False)],
                         ids=["default", "window", "twosided"])
def test_stft_istft_match_reference(kw):
    x = np.random.default_rng(5).standard_normal((2, 64)).astype(np.float32)
    outs = []
    for P in (jpaddle, tpaddle):
        kw2 = dict(kw)
        if kw2.get("window") == "hann":
            # nonzero at its ends: the overlap-add envelope stays away
            # from the 1e-11 floor
            kw2["window"] = P.to_tensor(np.hanning(14)[1:-1].astype(
                np.float32))
        spec = P.stft(P.to_tensor(x), **kw2)
        kw3 = {k: v for k, v in kw2.items() if k != "pad_mode"}
        back = P.istft(spec, length=64, **kw3)
        outs.append((_np(spec), _np(back)))
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=1e-4, atol=1e-4)
    if len(kw) == 1:
        # frames at hop 4 cover all 64 samples: the round trip is exact
        np.testing.assert_allclose(outs[1][1], x, rtol=1e-4, atol=1e-4)


def test_fft_and_linalg_namespaces():
    assert tpaddle.fft.__name__ == "paddle_tpu_torch.fft"
    for n in (8, 9):
        for fn in ("fftfreq", "rfftfreq"):
            a = getattr(jpaddle.fft, fn)(n, d=0.5)
            b = getattr(tpaddle.fft, fn)(n, d=0.5)
            np.testing.assert_allclose(_np(b), _np(a), rtol=1e-6)
            assert b.dtype.name == a.dtype.name
    x = np.random.default_rng(6).standard_normal((3, 8)).astype(np.float32)
    np.testing.assert_allclose(_np(tpaddle.fft.rfft(tpaddle.to_tensor(x))),
                               _np(jpaddle.fft.rfft(jpaddle.to_tensor(x))),
                               rtol=1e-5, atol=1e-5)
    a = np.random.default_rng(7).standard_normal((3, 3)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tpaddle.linalg.inv(tpaddle.to_tensor(a))),
        _np(jpaddle.linalg.inv(jpaddle.to_tensor(a))), rtol=1e-4, atol=1e-5)
    errs = []
    for P in (jpaddle, tpaddle):
        with pytest.raises(NotImplementedError) as e:
            P.linalg.eig(P.to_tensor(a))
        errs.append(str(e.value))
    assert errs[0] == errs[1]
