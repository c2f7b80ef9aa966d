"""Autograd of the Tensor API against the JAX package's.

Every scenario of ``tests/test_autograd.py`` and
``tests/test_double_grad.py`` is written once as a function of the
package and driven through both; what each returns (values, gradients,
flags, the errors raised) must agree. Tolerances: rtol 1e-5, atol 1e-6
(f32). Two reference scenarios use parts of the JAX package the port
does not have yet: ``jit.to_static`` (E3) and ``fleet.recompute``
(slice D); there the port runs the same computation eagerly and must
give the reference's numbers.
"""
import numpy as np
import pytest

import paddle_tpu as P_ref
import paddle_tpu_torch as P_port
from paddle_tpu_torch.core import place as port_place

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _cpu_place():
    prev = (port_place._current_place, port_place._current_device)
    P_port.set_device("cpu")
    yield
    port_place._current_place, port_place._current_device = prev


def _np(t):
    return None if t is None else np.asarray(t.numpy())


def _rng():
    return np.random.default_rng(0)


# -- tests/test_autograd.py ---------------------------------------------------
def simple_backward(P):
    x = P.to_tensor([2.0, 3.0], stop_gradient=False)
    (x * x).sum().backward()
    return [_np(x.grad)]


def chain(P):
    x = P.to_tensor(2.0, stop_gradient=False)
    y = x * x
    z = y * x + y
    z.backward()
    return [_np(x.grad)]


def branching_accumulation(P):
    x = P.to_tensor(3.0, stop_gradient=False)
    (x * 2.0 + x * 4.0).backward()
    return [_np(x.grad)]


def matmul_grad(P):
    r = _rng()
    a = P.to_tensor(r.standard_normal((3, 4)).astype(np.float32),
                    stop_gradient=False)
    b = P.to_tensor(r.standard_normal((4, 5)).astype(np.float32),
                    stop_gradient=False)
    P.matmul(a, b).sum().backward()
    return [_np(a.grad), _np(b.grad)]


def numeric_gradient_check(P):
    x0 = _rng().standard_normal(4).astype(np.float32)
    x = P.to_tensor(x0, stop_gradient=False)
    (P.tanh(x) * x).sum().backward()
    return [_np(x.grad)]


def no_grad(P):
    x = P.to_tensor(1.0, stop_gradient=False)
    with P.no_grad():
        y = x * 2
    return [y.stop_gradient, P.autograd.is_grad_enabled()]


def stop_gradient_blocks(P):
    x = P.to_tensor(1.0, stop_gradient=False)
    y = (x * 2).detach()
    (y * 3).backward()
    return [x.grad is None, y.stop_gradient]


def grad_accumulate_multiple_backward(P):
    x = P.to_tensor(1.0, stop_gradient=False)
    (x * 2).backward()
    (x * 3).backward()
    return [_np(x.grad)]


def multi_output_op_grad(P):
    x = P.to_tensor(np.array([3.0, 1.0, 2.0], np.float32),
                    stop_gradient=False)
    vals, idx = P.topk(x, 2)
    vals.sum().backward()
    return [_np(x.grad), _np(vals), _np(idx).astype(np.int64)]


def register_hook(P):
    x = P.to_tensor(1.0, stop_gradient=False)
    y = x * 2
    seen = []

    def hook(g):
        seen.append(float(g.item()))
        return g * 10

    x.register_hook(hook)
    y.backward()
    return [seen, _np(x.grad)]


def interior_hook(P):
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)
    h = x * 3.0
    h.register_hook(lambda g: g * 2)
    (h * h).sum().backward()
    return [_np(x.grad)]


def paddle_grad_api(P):
    x = P.to_tensor(2.0, stop_gradient=False)
    (gx,) = P.grad(x * x, x)
    return [_np(gx), x.grad is None]


def retain_graph(P):
    x = P.to_tensor(2.0, stop_gradient=False)
    y = x * x
    y.backward(retain_graph=True)
    y.backward()
    return [_np(x.grad)]


def second_backward_raises(P):
    x = P.to_tensor(2.0, stop_gradient=False)
    y = x * x
    y.backward()
    with pytest.raises(RuntimeError) as err:
        y.backward()
    return ["second time" in str(err.value), "retain_graph=True"
            in str(err.value)]


def pylayer(P):
    class Double(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * 2

        @staticmethod
        def backward(ctx, grad):
            (x,) = ctx.saved_tensor()
            return grad * 2

    x = P.to_tensor(3.0, stop_gradient=False)
    y = Double.apply(x)
    y.backward()
    return [_np(y), _np(x.grad), y.stop_gradient]


def functional_vjp_jvp(P):
    x = P.to_tensor(3.0)
    out, g = P.autograd.vjp(lambda t: t * t, x)
    out2, t = P.autograd.jvp(lambda t: t * t, x)
    return [_np(out), _np(g), _np(out2), _np(t)]


def vjp_jvp_two_inputs(P):
    r = _rng()
    a = P.to_tensor(r.standard_normal((3,)).astype(np.float32))
    b = P.to_tensor(r.standard_normal((3,)).astype(np.float32))
    v = P.to_tensor(r.standard_normal((3,)).astype(np.float32))
    out, gs = P.autograd.vjp(lambda p, q: P.sin(p) * q, [a, b], v)
    out2, t = P.autograd.jvp(lambda p, q: P.sin(p) * q, [a, b], [v, v])
    return [_np(out), _np(gs[0]), _np(gs[1]), _np(t)]


def jacobian_hessian(P):
    x = P.to_tensor([1.0, 2.0])
    jac = P.autograd.jacobian(lambda t: (t * t).sum(), x)
    hes = P.autograd.hessian(lambda t: (t * t).sum(), x)
    return [_np(jac), _np(hes)]


def jacobian_of_vector_fn(P):
    x = P.to_tensor(_rng().standard_normal(3).astype(np.float32))
    jac = P.autograd.jacobian(lambda t: P.tanh(t) * t, x)
    hes = P.autograd.hessian(lambda t: (P.sin(t) * t).sum(), x)
    return [_np(jac), _np(hes)]


def backward_non_scalar_with_grad(P):
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)
    (x * 3).backward(P.to_tensor([1.0, 10.0]))
    return [_np(x.grad)]


def non_scalar_without_grad_raises(P):
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)
    with pytest.raises(RuntimeError) as err:
        (x * 3).backward()
    return ["non-scalar" in str(err.value)]


# -- tests/test_double_grad.py ------------------------------------------------
def second_derivative_cubic(P):
    x = P.to_tensor([2.0], stop_gradient=False)
    (g,) = P.grad(x * x * x, [x], create_graph=True)
    (g2,) = P.grad(g, [x])
    return [_np(g), g.stop_gradient, _np(g2)]


def third_derivative(P):
    x = P.to_tensor([3.0], stop_gradient=False)
    (g1,) = P.grad(x ** 4, [x], create_graph=True)
    (g2,) = P.grad(g1, [x], create_graph=True)
    (g3,) = P.grad(g2, [x])
    return [_np(g1), _np(g2), _np(g3)]


def grad_does_not_pollute_other_leaves(P):
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)
    w = P.to_tensor([3.0, 4.0], stop_gradient=False)
    (gx,) = P.grad((x * w).sum(), [x])
    return [_np(gx), w.grad is None, x.grad is None]


def grad_wrt_interior_tensor(P):
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)
    h = x * 3.0
    (gh,) = P.grad((h * h).sum(), [h])
    return [_np(gh)]


def allow_unused(P):
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)
    z = P.to_tensor([1.0, 2.0], stop_gradient=False)
    y = (x * 2).sum()
    with pytest.raises(ValueError) as err:
        P.grad(y, [x, z], retain_graph=True)
    gx, gz = P.grad(y, [x, z], allow_unused=True)
    return ["allow_unused=True" in str(err.value), _np(gx), gz is None]


def gradient_penalty(P):
    r = np.random.default_rng(0)
    xw = r.standard_normal((4, 3)).astype("float32")
    ww = r.standard_normal((3, 1)).astype("float32")
    x = P.to_tensor(xw, stop_gradient=False)
    w = P.to_tensor(ww, stop_gradient=False)
    out = P.matmul(P.nn.functional.relu(P.matmul(x, w)), P.ones([1, 1]))
    (gx,) = P.grad(out.sum(), [x], create_graph=True)
    penalty = ((gx * gx).sum(axis=1).sqrt() - 1.0).pow(2).mean()
    penalty.backward()
    return [_np(gx), _np(penalty), _np(w.grad)]


def double_grad_multi_input_op(P):
    x = P.to_tensor([2.0], stop_gradient=False)
    y = P.to_tensor([5.0], stop_gradient=False)
    (gx,) = P.grad((x * x * y).sum(), [x], create_graph=True)
    (gxy,) = P.grad(gx, [y])
    return [_np(gx), _np(gxy)]


def double_grad_composes_with_jit(P):
    def step(xv):
        xv.stop_gradient = False
        (g,) = P.grad((xv ** 3).sum(), [xv], create_graph=True)
        return (g * g).sum()

    if P is P_ref:
        step = P.jit.to_static(step)
    return [float(step(P.to_tensor([1.0, 2.0])))]


def double_grad_through_recompute(P):
    x = P.to_tensor([2.0], stop_gradient=False)
    if P is P_ref:
        from paddle_tpu.distributed.fleet.recompute import recompute
        y = recompute(lambda t: t * t * t, x).sum()
    else:
        y = (x * x * x).sum()
    (g,) = P.grad(y, [x], create_graph=True)
    (g2,) = P.grad(g, [x])
    return [_np(g), _np(g2)]


def pylayer_create_graph_raises(P):
    class Square(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensor()
            return g * 2.0 * x

    x = P.to_tensor([3.0], stop_gradient=False)
    y = Square.apply(x).sum()
    with pytest.raises(NotImplementedError):
        P.grad(y, [x], create_graph=True)
    (g,) = P.grad(Square.apply(x).sum(), [x])
    return [_np(g)]


def backward_still_accumulates_all_leaves(P):
    x = P.to_tensor([1.0], stop_gradient=False)
    w = P.to_tensor([2.0], stop_gradient=False)
    (x * w).sum().backward()
    return [_np(x.grad), _np(w.grad)]


def hessian_vector_product(P):
    xw = np.array([1.0, 2.0, 3.0], dtype="float32")
    v = np.array([1.0, 0.5, -1.0], dtype="float32")
    x = P.to_tensor(xw, stop_gradient=False)
    (g,) = P.grad((x * x * x).sum(), [x], create_graph=True)
    (hvp,) = P.grad((g * P.to_tensor(v)).sum(), [x])
    return [_np(hvp)]


def integer_tensor_takes_no_part(P):
    i = P.to_tensor(np.array([1, 2], np.int32), stop_gradient=False)
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)
    y = (x * i.astype("float32")).sum()
    y.backward()
    return [_np(x.grad), i.grad is None, i.stop_gradient]


def set_grad_enabled(P):
    x = P.to_tensor(1.0, stop_gradient=False)
    P.set_grad_enabled(False)
    try:
        y = x * 2
    finally:
        P.set_grad_enabled(True)
    with P.enable_grad():
        z = x * 2
    return [y.stop_gradient, z.stop_gradient]


SCENARIOS = [
    simple_backward, chain, branching_accumulation, matmul_grad,
    numeric_gradient_check, no_grad, stop_gradient_blocks,
    grad_accumulate_multiple_backward, multi_output_op_grad, register_hook,
    interior_hook, paddle_grad_api, retain_graph, second_backward_raises,
    pylayer, functional_vjp_jvp, vjp_jvp_two_inputs, jacobian_hessian,
    jacobian_of_vector_fn, backward_non_scalar_with_grad,
    non_scalar_without_grad_raises, second_derivative_cubic,
    third_derivative, grad_does_not_pollute_other_leaves,
    grad_wrt_interior_tensor, allow_unused, gradient_penalty,
    double_grad_multi_input_op, double_grad_composes_with_jit,
    double_grad_through_recompute, pylayer_create_graph_raises,
    backward_still_accumulates_all_leaves, hessian_vector_product,
    integer_tensor_takes_no_part,
    set_grad_enabled,
]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__ for s in SCENARIOS])
def test_scenario_matches_reference(scenario):
    want = scenario(P_ref)
    got = scenario(P_port)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=scenario.__name__)
        elif isinstance(w, float):
            np.testing.assert_allclose(g, w, rtol=RTOL)
        else:
            assert g == w, (scenario.__name__, g, w)


def test_post_backward_callbacks_fire_after_backward_and_grad():
    for P in (P_ref, P_port):
        from importlib import import_module
        engine = import_module(P.__name__ + ".autograd.engine")
        fired = []
        remove = engine.register_post_backward_callback(
            lambda: fired.append(1))
        try:
            x = P.to_tensor(2.0, stop_gradient=False)
            (x * x).backward()
            P.grad(x * x, [x])
        finally:
            remove()
        (x * x).backward()
        assert fired == [1, 1], (P.__name__, fired)


def test_saved_tensors_hooks_see_what_backward_saves():
    """By design: torch intercepts the tensors autograd saves, so the
    port's ``saved_tensors_hooks`` packs and unpacks them (the JAX package
    cannot reach XLA's residuals and raises on entry)."""
    with pytest.raises(NotImplementedError):
        with P_ref.autograd.saved_tensors_hooks(lambda t: t, lambda t: t):
            pass
    packed = []
    x = P_port.to_tensor([1.0, 2.0], stop_gradient=False)
    with P_port.autograd.saved_tensors_hooks(
            lambda t: packed.append(t) or t.numpy(),
            lambda a: P_port.to_tensor(a)):
        y = (x * x).sum()
    y.backward()
    assert packed and isinstance(packed[0], P_port.Tensor)
    np.testing.assert_allclose(x.grad.numpy(), [2.0, 4.0])


def test_second_backward_through_a_graph_that_saved_nothing():
    """By design: a second backward without retain_graph raises the
    reference's error wherever torch freed what the graph saved; a graph
    of additions saved nothing, so torch runs it again and accumulates
    (the reference raises)."""
    x = P_port.to_tensor(2.0, stop_gradient=False)
    y = x + 1.0
    y.backward()
    y.backward()
    assert float(x.grad) == 2.0
    r = P_ref.to_tensor(2.0, stop_gradient=False)
    s = r + 1.0
    s.backward()
    with pytest.raises(RuntimeError, match="second time"):
        s.backward()


def test_backward_with_grad_targets_fills_only_them():
    """``autograd.backward(grad_targets=)`` (what the reference's
    ``paddle.grad`` runs on): ``.grad`` lands on the targets only, a leaf
    and an interior tensor, and nowhere else."""
    out = {}
    for P in (P_ref, P_port):
        from importlib import import_module
        engine = import_module(P.__name__ + ".autograd.engine")
        x = P.to_tensor([1.0, 2.0], stop_gradient=False)
        w = P.to_tensor([3.0, 4.0], stop_gradient=False)
        h = x * w
        y = (h * h).sum()
        engine.backward([y], grad_targets=[x, h])
        out[P.__name__] = (_np(x.grad), _np(h.grad), w.grad is None)
    for got, want in zip(out["paddle_tpu_torch"], out["paddle_tpu"]):
        if isinstance(want, np.ndarray):
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        else:
            assert got == want
