"""The port's ``TrainStep.run_steps`` and ``donate=False`` against the JAX
package's.

The scenarios of ``tests/test_run_steps.py`` and the ``donate=False``
ones of ``tests/test_train_donation.py`` go through both packages from
the same weights (the JAX model's, carried over) and the same numpy
batches: losses and parameters agree at f32 float noise (the conftest
sets XLA's matmul precision to highest; ``_TOL``). Inside the port,
``run_steps(k)`` is bit-identical to k ``__call__``s and ``donate=False``
to ``donate=True``. With a ``GradScaler`` and ``skip_nonfinite`` (an
inf microbatch inside a stacked batch) the skips, the counters and the
scaler's state equal the JAX step's; an ``LRScheduler`` is read once per
dispatch. On the CPU ``run_steps`` runs its k steps eagerly (the card's
CUDA graph replay is held to the eager step in
``tests/test_torch_card.py``)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptim
from paddle_tpu.amp import GradScaler as JGradScaler
from paddle_tpu.optimizer.lr import StepDecay as JStepDecay
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.optimizer.lr import StepDecay

# f32 on both sides; the losses and weights agree to float noise (the
# two packages add in other orders), far inside one Adam step (lr 0.01)
_TOL = dict(rtol=2e-5, atol=2e-6)


def _pair(seed=0, donate=True, lr=0.01, scaler=None, skip_nonfinite=False,
          jlr=None):
    """The JAX reference's MLP + Adam + TrainStep, and the port's with the
    same weights."""
    paddle.seed(seed)
    jm = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    jopt = joptim.Adam(learning_rate=lr if jlr is None else jlr,
                       parameters=jm.parameters())
    jscaler = None if scaler is None else JGradScaler(**scaler)
    jstep = paddle.jit.TrainStep(jm, jnn.CrossEntropyLoss(), jopt,
                                 donate=donate, scaler=jscaler,
                                 skip_nonfinite=skip_nonfinite)
    tm = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                             torch.nn.Linear(16, 4))
    with torch.no_grad():
        for tp, jp in zip(tm.parameters(), jm.parameters()):
            w = np.asarray(jp._data)
            tp.copy_(torch.from_numpy(np.array(w.T if w.ndim == 2 else w)))
    topt = Adam(learning_rate=lr, parameters=tm.parameters())
    tscaler = None if scaler is None else GradScaler(**scaler)
    tstep = TrainStep(tm, torch.nn.CrossEntropyLoss(), topt, donate=donate,
                      scaler=tscaler, skip_nonfinite=skip_nonfinite)
    return (jm, jopt, jstep, jscaler), (tm, topt, tstep, tscaler)


def _port(seed=0, **kw):
    """The port's side alone (its weights still come from the JAX
    model)."""
    return _pair(seed, jlr=0.01, **kw)[1]


def _batch(seed=0, n=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 8)).astype("float32"),
            rng.integers(0, 4, n).astype("int64"))


def _stacked(seed=1, k=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(k, 16, 8)).astype("float32"),
            rng.integers(0, 4, (k, 16)).astype("int64"))


def _jparams(jm):
    return [np.asarray(p._data).T if np.asarray(p._data).ndim == 2
            else np.asarray(p._data) for p in jm.parameters()]


def _assert_params_close(jm, tm):
    for jp, tp in zip(_jparams(jm), tm.parameters()):
        np.testing.assert_allclose(tp.detach().numpy(), jp, **_TOL)


def _assert_bitwise(tm_a, opt_a, tm_b, opt_b):
    for pa, pb in zip(tm_a.parameters(), tm_b.parameters()):
        assert torch.equal(pa, pb)
        sa, sb = opt_a._slots[id(pa)], opt_b._slots[id(pb)]
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k


def _jlosses(x):
    return np.asarray(x._data)


# --------------------------------------------------------------------------
# the six scenarios of tests/test_run_steps.py, through both packages
# --------------------------------------------------------------------------
def test_run_steps_matches_serial():
    X, Y = _batch()
    (jm, jopt, jstep, _), (tm, topt, tstep, _) = _pair()
    jl = np.concatenate([_jlosses(jstep.run_steps(3, X, Y)),
                         _jlosses(jstep.run_steps(3, X, Y))])
    tl = torch.cat([tstep.run_steps(3, X, Y), tstep.run_steps(3, X, Y)])
    np.testing.assert_allclose(tl.numpy(), jl, **_TOL)
    assert jopt._step_count == topt._step_count == 6
    # the port's run_steps against six of its own calls: bit-identical
    tm2, topt2, tstep2, _ = _port()
    serial = torch.stack([tstep2(X, Y) for _ in range(6)])
    assert torch.equal(serial, tl)
    _assert_bitwise(tm, topt, tm2, topt2)


def test_run_steps_params_match_serial():
    X, Y = _batch()
    (jm, _, jstep, _), (tm, topt, tstep, _) = _pair()
    jstep.run_steps(4, X, Y)
    tstep.run_steps(4, X, Y)
    _assert_params_close(jm, tm)
    tm2, topt2, tstep2, _ = _port()
    for _ in range(4):
        tstep2(X, Y)
    _assert_bitwise(tm, topt, tm2, topt2)


def test_run_steps_stacked_microbatches():
    Xk, Yk = _stacked()
    (jm, _, jstep, _), (tm, topt, tstep, _) = _pair()
    jl = _jlosses(jstep.run_steps(3, Xk, Yk, stacked=True))
    tl = tstep.run_steps(3, Xk, Yk, stacked=True)
    assert tuple(tl.shape) == (3,)
    np.testing.assert_allclose(tl.numpy(), jl, **_TOL)
    _assert_params_close(jm, tm)
    tm2, topt2, tstep2, _ = _port()
    serial = torch.stack([tstep2(Xk[i], Yk[i]) for i in range(3)])
    assert torch.equal(serial, tl)
    _assert_bitwise(tm, topt, tm2, topt2)


def test_run_steps_stacked_shape_check():
    X, Y = _batch()
    (_, jopt, jstep, _), (_, topt, tstep, _) = _pair()
    with pytest.raises(ValueError):
        jstep.run_steps(5, X, Y, stacked=True)   # leading dim 16, not 5
    with pytest.raises(ValueError, match="leading dim of 5"):
        tstep.run_steps(5, X, Y, stacked=True)
    # a refused dispatch advances no counter
    assert jopt._step_count == topt._step_count == 0


def test_run_steps_batch_dim_equal_k_not_stacked():
    """A batch whose batch dim happens to equal k is not scanned over
    (stacking is explicit)."""
    X, Y = _batch(seed=2, n=4)
    (_, _, jstep, _), (tm, topt, tstep, _) = _pair()
    jl = _jlosses(jstep.run_steps(4, X, Y))
    tl = tstep.run_steps(4, X, Y)
    np.testing.assert_allclose(tl.numpy(), jl, **_TOL)
    tm2, _, tstep2, _ = _port()
    serial = torch.stack([tstep2(X, Y) for _ in range(4)])
    assert torch.equal(serial, tl)


def test_run_steps_stacked_slices_microbatches():
    """Every step gets its own microbatch of the stack, not the whole
    (k, ...) stack: the losses are those of three calls on the slices."""
    Xk, Yk = _stacked(seed=3)
    _, topt, tstep, _ = _port()
    losses = tstep.run_steps(3, Xk, Yk, stacked=True)
    assert tuple(losses.shape) == (3,) and topt._step_count == 3
    _, _, tstep2, _ = _port()
    want = [float(tstep2(Xk[i], Yk[i])) for i in range(3)]
    assert losses.tolist() == want


# --------------------------------------------------------------------------
# donate=False (tests/test_train_donation.py)
# --------------------------------------------------------------------------
def test_undonated_matches_donated_and_jax():
    X, Y = _batch()
    (jm, jopt, jstep, _), (tm, topt, tstep, _) = _pair(donate=False)
    tm_d, topt_d, tstep_d, _ = _port(donate=True)
    jl = [_jlosses(jstep(X, Y)) for _ in range(5)]
    tl = [tstep(X, Y) for _ in range(5)]
    tl_d = [tstep_d(X, Y) for _ in range(5)]
    np.testing.assert_allclose(torch.stack(tl).numpy(), np.stack(jl), **_TOL)
    _assert_params_close(jm, tm)
    assert torch.equal(torch.stack(tl), torch.stack(tl_d))
    _assert_bitwise(tm, topt, tm_d, topt_d)


def test_undonated_leaves_taken_tensors_alone():
    """What the user took from a parameter or slot before a step keeps
    its values after it under donate=False, and sees the update under
    donate=True (the port's donation is the in-place update)."""
    X, Y = _batch()
    for donate in (False, True):
        tm, topt, tstep, _ = _port(donate=donate)
        tstep(X, Y)
        p = next(tm.parameters())
        taken = [p.detach(), topt._slots[id(p)]["moment1"]]
        before = [t.clone() for t in taken]
        tstep(X, Y)
        tstep.run_steps(2, X, Y)
        kept = [torch.equal(t, b) for t, b in zip(taken, before)]
        assert kept == ([True, True] if not donate else [False, False])
        assert not torch.equal(p.detach(), before[0])


def test_run_steps_undonated_matches_donated_and_jax():
    X, Y = _batch()
    (jm, _, jstep, _), (tm, topt, tstep, _) = _pair(donate=False)
    tm_d, topt_d, tstep_d, _ = _port(donate=True)
    jl = _jlosses(jstep.run_steps(5, X, Y))
    tl = tstep.run_steps(5, X, Y)
    np.testing.assert_allclose(tl.numpy(), jl, **_TOL)
    _assert_params_close(jm, tm)
    assert torch.equal(tl, tstep_d.run_steps(5, X, Y))
    _assert_bitwise(tm, topt, tm_d, topt_d)


# --------------------------------------------------------------------------
# the scaler, skip_nonfinite and a scheduler inside a dispatch
# --------------------------------------------------------------------------
def _scaler_state(s):
    return (s._scale, s._good_steps, s._bad_steps, s._skipped_steps,
            s._consecutive_skips)


@pytest.mark.parametrize("scaled", [False, True])
def test_inf_microbatch_skips_as_jax_does(scaled):
    """An inf inside microbatch 1 of a stacked batch of 4: the JAX and
    port steps skip the same step, count it, keep the step counter and
    (with a scaler) take the scale through the same schedule, synced to
    the Python scaler once after the dispatch."""
    Xk, Yk = _stacked(seed=4, k=4)
    Xk[1, 3, 2] = np.inf
    sc = dict(init_loss_scaling=8.0, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1) if scaled else None
    (jm, jopt, jstep, jsc), (tm, topt, tstep, tsc) = _pair(
        scaler=sc, skip_nonfinite=True)
    jl = _jlosses(jstep.run_steps(4, Xk, Yk, stacked=True))
    tl = tstep.run_steps(4, Xk, Yk, stacked=True).numpy()
    assert np.isnan(jl[1]) and np.isnan(tl[1])
    np.testing.assert_allclose(np.delete(tl, 1), np.delete(jl, 1), **_TOL)
    assert jstep.skipped_steps == tstep.skipped_steps == 1
    assert jopt._step_count == topt._step_count == 4
    assert float(np.asarray(jstep._carry[0])) == float(tstep._step) == 3.0
    _assert_params_close(jm, tm)
    if scaled:
        assert _scaler_state(tsc) == _scaler_state(jsc)
        assert tstep._scaler_state.tolist() == [
            float(v) for v in np.asarray(jstep._scaler_state)]
    # the same microbatches through four calls: bit-identical
    tm2, topt2, tstep2, tsc2 = _port(scaler=sc, skip_nonfinite=True)
    serial = torch.stack([tstep2(Xk[i], Yk[i]) for i in range(4)])
    assert torch.equal(serial.isnan(), torch.from_numpy(np.isnan(tl)))
    assert torch.equal(torch.nan_to_num(serial),
                       torch.nan_to_num(torch.from_numpy(tl)))
    _assert_bitwise(tm, topt, tm2, topt2)
    assert tstep2.skipped_steps == 1
    if scaled:
        assert _scaler_state(tsc2) == _scaler_state(tsc)


def test_scheduler_read_once_per_dispatch():
    """The lr of a dispatch is the scheduler's at the dispatch: two
    dispatches of 2 steps with one ``sched.step()`` between them give
    the JAX step's losses and weights; the step count advances by k per
    dispatch."""
    X, Y = _batch()
    jsched = JStepDecay(0.01, step_size=1, gamma=0.5)
    tsched = StepDecay(0.01, step_size=1, gamma=0.5)
    (jm, jopt, jstep, _), (tm, topt, tstep, _) = _pair(lr=tsched,
                                                      jlr=jsched)
    lrs = []
    for _ in range(2):
        lrs.append((jopt.get_lr(), topt.get_lr()))
        jl = _jlosses(jstep.run_steps(2, X, Y))
        tl = tstep.run_steps(2, X, Y)
        np.testing.assert_allclose(tl.numpy(), jl, **_TOL)
        jsched.step()
        tsched.step()
    assert lrs == [(0.01, 0.01), (0.005, 0.005)]
    assert float(tstep._lr) == np.float32(0.005)
    assert jopt._step_count == topt._step_count == 4
    _assert_params_close(jm, tm)
    # the same as two calls at 0.01 and two at 0.005
    sched2 = StepDecay(0.01, step_size=1, gamma=0.5)
    tm2, topt2, tstep2, _ = _port(lr=sched2)
    for _ in range(2):
        for _ in range(2):
            tstep2(X, Y)
        sched2.step()
    _assert_bitwise(tm, topt, tm2, topt2)


def test_undonated_bf16_master_weights():
    """bf16 parameters with f32 master weights (Adam multi_precision), as
    ``test_donated_matches_undonated_bf16_master_weights``: the port's
    donate=False is bit-identical to donate=True over calls and a
    dispatch, and both follow the JAX step. bf16 sides round the
    logits and gradients differently, so the JAX comparison holds the
    losses to 1e-2 relative and every master weight to 2 lr a step (an
    Adam step moves a weight by about lr)."""
    X, Y = _batch()
    paddle.set_default_dtype("bfloat16")
    try:
        paddle.seed(7)
        jm = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
        jopt = joptim.Adam(learning_rate=0.01, parameters=jm.parameters(),
                           multi_precision=True)
        jstep = paddle.jit.TrainStep(jm, jnn.CrossEntropyLoss(), jopt,
                                     donate=False)
    finally:
        paddle.set_default_dtype("float32")
    assert "master_weight" in jopt._slots[id(jm.parameters()[0])]
    w0s = [np.array(np.asarray(p._data, np.float32)) for p in jm.parameters()]
    xj = paddle.to_tensor(X).astype("bfloat16")
    jl = [float(np.asarray(jstep(xj, Y)._data, np.float32))
          for _ in range(3)]
    jl += np.asarray(jstep.run_steps(2, xj, Y)._data, np.float32).tolist()
    runs = []
    for donate in (True, False):
        tm = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                                 torch.nn.Linear(16, 4)).to(torch.bfloat16)
        with torch.no_grad():
            for tp, w0 in zip(tm.parameters(), w0s):
                tp.copy_(torch.from_numpy(np.array(w0.T if w0.ndim == 2
                                                   else w0)))
        topt = Adam(0.01, parameters=tm.parameters(), multi_precision=True)
        tstep = TrainStep(tm, torch.nn.CrossEntropyLoss(), topt,
                          donate=donate)
        xb = torch.from_numpy(X).to(torch.bfloat16)
        tl = [tstep(xb, Y) for _ in range(3)]
        tl = torch.cat([torch.stack(tl), tstep.run_steps(2, xb, Y)])
        runs.append((tm, topt, tl))
    (tm_d, topt_d, tl_d), (tm_u, topt_u, tl_u) = runs
    assert torch.equal(tl_d, tl_u)
    _assert_bitwise(tm_d, topt_d, tm_u, topt_u)
    assert topt_u._slots[id(next(tm_u.parameters()))][
        "master_weight"].dtype == torch.float32
    np.testing.assert_allclose(tl_u.float().numpy(), jl, rtol=1e-2)
    for jp, tp in zip(jm.parameters(), tm_u.parameters()):
        w = np.asarray(jopt._slots[id(jp)]["master_weight"])
        got = topt_u._slots[id(tp)]["master_weight"].numpy()
        assert np.abs(got - (w.T if w.ndim == 2 else w)).max() <= 2 * 0.01 * 5
