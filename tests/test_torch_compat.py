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
