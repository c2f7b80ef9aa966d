"""The port's ``jit.TrainStep`` over an ``nn.Layer`` model against the JAX
package's.

The same layer model (built from the same seed in both packages: the
uniform initializers draw bit-identical weights) takes the same numpy
batches through ``paddle_tpu.jit.TrainStep`` and
``paddle_tpu_torch.jit.TrainStep``: the cases of ``tests/test_jit.py``'s
``test_train_step_*`` and of ``tests/test_run_steps.py``, BatchNorm's
running statistics threaded through the steps, dropout masks drawn from
the device RNG chain (one generator key per ``TrainStep``, split on the
device each step and once per draw), and a ``skip_nonfinite`` step that
still advances the chain. Losses and parameters are held at the f32
tolerance of ``tests/test_torch_train.py`` (rtol 1e-5, atol 1e-6); masks,
chains and generator states are compared exactly.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.core import place as _place

TOL = dict(rtol=1e-5, atol=1e-6)
PACKAGES = (jpaddle, tpaddle)


@pytest.fixture(autouse=True)
def _cpu_place():
    saved = (_place._current_place, _place._current_device)
    tpaddle.set_device("cpu")
    yield
    _place._current_place, _place._current_device = saved


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _mlp(P, seed=0, p=0.0, opt="adam", bn=False, **step_kw):
    """``Linear(8, 16)``, ReLU (BatchNorm1D before it with ``bn``),
    Dropout(p) when p > 0, ``Linear(16, 4)``; Adam or SGD; a TrainStep
    under cross entropy."""
    P.seed(seed)
    nn = P.nn
    layers = [nn.Linear(8, 16)] + ([nn.BatchNorm1D(16)] if bn else []) \
        + [nn.ReLU()] + ([nn.Dropout(p)] if p > 0 else []) \
        + [nn.Linear(16, 4)]
    m = nn.Sequential(*layers)
    if opt == "adam":
        o = P.optimizer.Adam(learning_rate=0.01, parameters=m.parameters())
    else:
        o = P.optimizer.SGD(learning_rate=0.1, parameters=m.parameters())
    return m, o, P.jit.TrainStep(m, nn.CrossEntropyLoss(), o, **step_kw)


def _xy(seed=0, n=16, k=None):
    rng = np.random.default_rng(seed)
    lead = () if k is None else (k,)
    return (rng.normal(size=lead + (n, 8)).astype("float32"),
            rng.integers(0, 4, lead + (n,)).astype("int64"))


def _same_params(mj, mt):
    for (name, a), b in zip(mj.named_parameters(), mt.parameters()):
        np.testing.assert_allclose(_np(b), _np(a), err_msg=name, **TOL)


def _losses(P, step, batches):
    return [float(step(P.to_tensor(x), P.to_tensor(y))) for x, y in batches]


def test_train_step_descends_and_matches_eager():
    """tests/test_jit.py's case: 10 steps of an MLP under MSE, the
    TrainStep of each package against the reference's TrainStep and the
    port's eager loop."""
    np.random.seed(0)
    X = np.random.randn(32, 4).astype(np.float32)
    Y = (X.sum(-1, keepdims=True) * 0.5).astype(np.float32)
    out = {}
    for P in PACKAGES:
        nn = P.nn
        P.seed(0)
        m = nn.Sequential(nn.Linear(4, 16), nn.Tanh(), nn.Linear(16, 1))
        opt = P.optimizer.Adam(learning_rate=0.01, parameters=m.parameters())
        step = P.jit.TrainStep(m, nn.MSELoss(), opt)
        out[P] = ([float(step(P.to_tensor(X), P.to_tensor(Y)))
                   for _ in range(10)], m)
    P = tpaddle
    P.seed(0)
    m = P.nn.Sequential(P.nn.Linear(4, 16), P.nn.Tanh(), P.nn.Linear(16, 1))
    opt = P.optimizer.Adam(learning_rate=0.01, parameters=m.parameters())
    eager = []
    for _ in range(10):
        loss = P.nn.MSELoss()(m(P.to_tensor(X)), P.to_tensor(Y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        eager.append(float(loss))
    jl, tl = out[jpaddle][0], out[tpaddle][0]
    assert tl[-1] < tl[0] * 0.9
    np.testing.assert_allclose(tl, jl, **TOL)
    np.testing.assert_allclose(tl, eager, **TOL)
    _same_params(out[jpaddle][1], out[tpaddle][1])


def test_train_step_updates_params_in_layer():
    """tests/test_jit.py's case: one SGD step on ``nn.Linear(2, 1)``
    moves the Layer's own weight (the same Tensor, updated in place), to
    the reference's values."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 2)).astype("float32")
    y = rng.normal(size=(4, 1)).astype("float32")
    got = {}
    for P in PACKAGES:
        P.seed(0)
        m = P.nn.Linear(2, 1)
        w = m.weight
        w0 = w.numpy().copy()
        opt = P.optimizer.SGD(learning_rate=0.1, parameters=m.parameters())
        P.jit.TrainStep(m, P.nn.MSELoss(), opt)(P.to_tensor(x),
                                               P.to_tensor(y))
        assert m.weight is w
        assert not np.allclose(m.weight.numpy(), w0)
        got[P] = m
    _same_params(got[jpaddle], got[tpaddle])


@pytest.mark.parametrize("split", [(6,), (3, 3), (4, 2)])
def test_run_steps_matches_serial_and_the_reference(split):
    """tests/test_run_steps.py's serial cases: run_steps over the same
    batch in dispatches of ``split`` steps against 6 ``__call__``s and
    against the reference's run_steps; the optimizer counts 6 steps."""
    x, y = _xy()
    _, oa, sa = _mlp(tpaddle)
    serial = _losses(tpaddle, sa, [(x, y)] * 6)
    res = {}
    for P in PACKAGES:
        m, o, s = _mlp(P)
        got = np.concatenate([_np(s.run_steps(k, P.to_tensor(x),
                                              P.to_tensor(y)))
                              for k in split])
        assert o._step_count == 6
        res[P] = (got, m)
    np.testing.assert_allclose(res[tpaddle][0], serial, **TOL)
    np.testing.assert_allclose(res[tpaddle][0], res[jpaddle][0], **TOL)
    _same_params(res[jpaddle][1], res[tpaddle][1])
    assert oa._step_count == 6


def test_run_steps_stacked_microbatches():
    """One microbatch per step: run_steps(3, stacked=True) against 3
    ``__call__``s on the slices, and against the reference's."""
    xk, yk = _xy(1, k=3)
    _, _, sa = _mlp(tpaddle)
    serial = _losses(tpaddle, sa, [(xk[i], yk[i]) for i in range(3)])
    res = {}
    for P in PACKAGES:
        m, o, s = _mlp(P)
        res[P] = (_np(s.run_steps(3, P.to_tensor(xk), P.to_tensor(yk),
                                  stacked=True)), m)
        assert o._step_count == 3
    np.testing.assert_allclose(res[tpaddle][0], serial, **TOL)
    np.testing.assert_allclose(res[tpaddle][0], res[jpaddle][0], **TOL)
    _same_params(res[jpaddle][1], res[tpaddle][1])


def test_run_steps_stacked_shape_check():
    x, y = _xy()
    for P in PACKAGES:
        _, _, s = _mlp(P)
        with pytest.raises(ValueError):
            s.run_steps(5, P.to_tensor(x), P.to_tensor(y), stacked=True)


def test_run_steps_batch_dim_equal_k_not_stacked():
    """A batch whose batch dim equals k is the same batch each step."""
    x, y = _xy(2, n=4)
    _, _, sa = _mlp(tpaddle)
    serial = _losses(tpaddle, sa, [(x, y)] * 4)
    res = {}
    for P in PACKAGES:
        _, _, s = _mlp(P)
        res[P] = _np(s.run_steps(4, P.to_tensor(x), P.to_tensor(y)))
    np.testing.assert_allclose(res[tpaddle], serial, **TOL)
    np.testing.assert_allclose(res[tpaddle], res[jpaddle], **TOL)


def test_run_steps_stacked_slices_microbatches_on_the_cpu():
    """The port's CPU run_steps (k eager steps, the counterpart of the
    reference's per-step fallback) slices a stacked batch per step."""
    xk, yk = _xy(3, k=3)
    _, o, s = _mlp(tpaddle)
    losses = s.run_steps(3, tpaddle.to_tensor(xk), tpaddle.to_tensor(yk),
                         stacked=True)
    assert tuple(losses.shape) == (3,)
    assert o._step_count == 3
    _, _, j = _mlp(jpaddle)
    np.testing.assert_allclose(
        _np(losses), _np(j.run_steps(3, jpaddle.to_tensor(xk),
                                     jpaddle.to_tensor(yk), stacked=True)),
        **TOL)


@pytest.mark.parametrize("how", ["call", "run_steps"])
def test_batchnorm_buffers_are_threaded_through_the_steps(how):
    """BatchNorm's running mean and variance after 3 steps (the forward
    rebinds them, the step threads them back into the tensors it holds)
    equal the reference's, and the Layer's buffers stay the same torch
    tensors. SGD: the gradient of the bias in front of BatchNorm is zero
    up to rounding, and Adam's first steps would move it by the sign of
    that rounding."""
    xs = [_xy(10 + i) for i in range(3)]
    res = {}
    for P in PACKAGES:
        m, _, s = _mlp(P, bn=True, opt="sgd")
        held = [b._data for b in m.buffers()]
        if how == "call" or P is jpaddle:
            losses = _losses(P, s, xs)
        else:
            losses = list(_np(s.run_steps(
                3, P.to_tensor(np.stack([x for x, _ in xs])),
                P.to_tensor(np.stack([y for _, y in xs])), stacked=True)))
        if P is tpaddle:
            assert all(b._data is h for b, h in zip(m.buffers(), held))
        res[P] = (losses, m)
    np.testing.assert_allclose(res[tpaddle][0], res[jpaddle][0], **TOL)
    (_, mj), (_, mt) = res[jpaddle], res[tpaddle]
    for (name, a), b in zip(mj.named_buffers(), mt.buffers()):
        np.testing.assert_allclose(_np(b), _np(a), err_msg=name, **TOL)
    _same_params(mj, mt)


def _reference_masks(key, steps, shape, p):
    """The masks the JAX step's chain draws: per step ``chain, k =
    split(chain)``, and the step's one dropout draw takes
    ``split(k)[1]``."""
    chain = key
    out = []
    for _ in range(steps):
        chain, k = jax.random.split(chain)
        _, sub = jax.random.split(k)
        out.append(np.asarray(jax.random.bernoulli(sub, 1.0 - p, shape)))
    return out, chain


def _record_masks(model):
    """Each dropout call's (kept, input nonzero): where the input is 0
    the output says nothing of the mask."""
    seen = []

    def hook(layer, inputs, out):
        seen.append((out.numpy() != 0, inputs[0].numpy() != 0))

    for layer in model.sublayers():
        if isinstance(layer, tpaddle.nn.Dropout):
            layer.register_forward_post_hook(hook)
    return seen


@pytest.mark.parametrize("how", ["call", "run_steps"])
def test_dropout_masks_follow_the_reference_chain(how):
    """``nn.Dropout(0.1)`` over 3 steps: the construction takes one key
    of the default generator in both packages (equal states after it),
    the steps take none; every mask the port draws is the reference
    chain's, bit for bit; losses, parameters and the final chain words
    agree."""
    p = 0.1
    x, y = _xy(5)
    res = {}
    for P in PACKAGES:
        m, _, s = _mlp(P, p=p)
        after_build = P.get_rng_state()
        seen = _record_masks(m) if P is tpaddle else None
        if how == "call" or P is jpaddle:
            losses = _losses(P, s, [(x, y)] * 3)
        else:
            losses = list(_np(s.run_steps(3, P.to_tensor(x),
                                          P.to_tensor(y))))
        assert P.get_rng_state() == after_build
        res[P] = (losses, m, s, after_build, seen)
    (jl, mj, sj, jstate, _), (tl, mt, st, tstate, seen) = \
        res[jpaddle], res[tpaddle]
    assert jstate == tstate
    # the reference chain's root: the key its construction took
    jpaddle.set_rng_state((jstate[0], jstate[1] - 1))
    root = jpaddle.core.generator.default_generator.next_key()
    want, chain = _reference_masks(root, 3, (16, 16), p)
    assert len(seen) == 3
    for (kept, live), w in zip(seen, want):
        assert live.mean() > 0.3
        np.testing.assert_array_equal(kept[live], w[live])
    np.testing.assert_array_equal(_np(st._chain),
                                  np.asarray(jax.random.key_data(chain)))
    np.testing.assert_array_equal(
        _np(st._chain), np.asarray(jax.random.key_data(sj._carry[1])))
    np.testing.assert_allclose(tl, jl, **TOL)
    _same_params(mj, mt)


def test_skipped_nonfinite_step_still_advances_the_chain():
    """A NaN batch under ``skip_nonfinite``: the parameters keep their
    values and the step counts one skip, in both packages, and the chain
    advances as the reference's does; the next clean step matches."""
    x, y = _xy(6)
    bad = x.copy()
    bad[0, 0] = np.nan
    res = {}
    for P in PACKAGES:
        m, o, s = _mlp(P, p=0.1, skip_nonfinite=True)
        before = [p_.numpy().copy() for p_ in m.parameters()]
        chain0 = _np(s._chain if P is tpaddle
                     else jax.random.key_data(s._carry[1])).copy()
        s(P.to_tensor(bad), P.to_tensor(y))
        assert s.skipped_steps == 1
        for b, p_ in zip(before, m.parameters()):
            np.testing.assert_array_equal(p_.numpy(), b)
        chain1 = _np(s._chain if P is tpaddle
                     else jax.random.key_data(s._carry[1])).copy()
        assert not np.array_equal(chain0, chain1)
        loss = float(s(P.to_tensor(x), P.to_tensor(y)))
        res[P] = (chain1, loss, m)
    np.testing.assert_array_equal(res[tpaddle][0], res[jpaddle][0])
    np.testing.assert_allclose(res[tpaddle][1], res[jpaddle][1], **TOL)
    _same_params(res[jpaddle][2], res[tpaddle][2])


def test_a_restored_state_lands_in_the_held_tensors():
    """``set_state_dict`` rebinds a parameter's data; the next step copies
    it back into the tensor the step holds (the address a captured graph
    reads) and trains from the restored values, as a fresh model loaded
    with the same state does."""
    x, y = _xy(7)
    m, _, s = _mlp(tpaddle)
    held = [p_._data for p_ in m.parameters()]
    state = {k: v.numpy().copy() for k, v in m.state_dict().items()}
    s(tpaddle.to_tensor(x), tpaddle.to_tensor(y))
    m.set_state_dict(state)
    assert any(p_._data is not h for p_, h in zip(m.parameters(), held))
    got = float(s(tpaddle.to_tensor(x), tpaddle.to_tensor(y)))
    assert all(p_._data is h for p_, h in zip(m.parameters(), held))
    _, _, fresh = _mlp(tpaddle)
    want = float(fresh(tpaddle.to_tensor(x), tpaddle.to_tensor(y)))
    np.testing.assert_allclose(got, want, **TOL)


def test_a_torch_module_step_takes_one_key_too():
    """The chain is the step's for any model: a ``torch.nn.Module``
    TrainStep also takes one generator key at construction, as the
    reference's TrainStep always does; the chain starts at that key."""
    tpaddle.seed(3)
    m = torch.nn.Linear(4, 2)
    opt = tpaddle.optimizer.SGD(0.1, parameters=list(m.parameters()))
    step = tpaddle.jit.TrainStep(m, torch.nn.functional.mse_loss, opt)
    assert tpaddle.get_rng_state() == (3, 1)
    want = jax.random.key_data(jax.random.fold_in(jax.random.key(3), 0))
    np.testing.assert_array_equal(_np(step._chain), np.asarray(want))


def _int_stream(root, n):
    """The keys a device key stream over ``root`` hands out, as Python
    ints: ``key, sub = split(key)``, each draw taking ``sub``."""
    from paddle_tpu_torch.ops import threefry

    out, key = [], root
    for _ in range(n):
        key, sub = threefry.split(key)
        out.append(sub)
    return out


_DRAWS = {
    "rand": lambda P: P.rand([3, 5]),
    "uniform": lambda P: P.uniform([7], min=-2.0, max=3.0),
    "randn": lambda P: P.randn([4, 4]),
    "standard_normal": lambda P: P.standard_normal([6]),
    "normal": lambda P: P.normal(1.0, 2.0, [5]),
    "randint": lambda P: P.randint(0, 97, [9]),
    "randperm": lambda P: P.randperm(11),
    "shuffle": lambda P: P.shuffle(P.arange(12).reshape([4, 3])),
    "bernoulli": lambda P: P.bernoulli(P.full([8], 0.3)),
    "poisson": lambda P: P.poisson(P.full([6], 4.0)),
    "exponential": lambda P: P.exponential(P.ones([6])),
    "dropout": lambda P: P.nn.functional.dropout(P.ones([4, 6]), 0.25),
    "multinomial": lambda P: P.multinomial(P.full([2, 5], 0.2), 3),
    "multinomial_replace": lambda P: P.multinomial(
        P.full([5], 0.2), 4, replacement=True),
    "gumbel_softmax": lambda P: P.nn.functional.gumbel_softmax(
        P.zeros([3, 4])),
    "sdpa_dropout": lambda P: P.nn.functional.scaled_dot_product_attention(
        P.ones([1, 4, 2, 8]), P.ones([1, 4, 2, 8]), P.ones([1, 4, 2, 8]),
        dropout_p=0.5, training=True),
    "layer_dropout": lambda P: P.nn.Dropout(0.5)(P.ones([5, 5])),
}


@pytest.mark.parametrize("name", sorted(_DRAWS))
def test_every_draw_takes_the_stream_key(name, monkeypatch):
    """Under ``device_key_stream`` each draw takes a ``(2,)`` tensor key,
    the stream's next split, and draws what the same key as Python ints
    draws; no generator moves."""
    from paddle_tpu_torch.core import generator as gen

    root = (123456789, 987654321)
    state = tpaddle.get_rng_state()
    with gen.device_key_stream(torch.tensor(root, dtype=torch.int64)):
        got = _DRAWS[name](tpaddle)
    assert tpaddle.get_rng_state() == state
    keys = iter(_int_stream(root, 4))
    monkeypatch.setattr(gen, "active_key", lambda: next(keys))
    want = _DRAWS[name](tpaddle)
    assert torch.equal(got._data, want._data), name
