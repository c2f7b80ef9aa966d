"""The port's AMP (``paddle_tpu_torch/amp``) and ``TrainStep(scaler=...)``
against the JAX package's, on the same seeded numpy inputs:

* ``GradScaler``'s state sequence through an eager loop with injected
  infs, the divergence guard, and the device-state helpers: equal;
* the eager loop (``scaler.scale(loss).backward(); scaler.step(opt);
  scaler.update(); opt.clear_grad(); sched.step()``) on the tiny Llama
  in f32 with AdamW (master weights off), the global-norm clip and
  ``LinearWarmup(CosineAnnealingDecay)``: losses at rtol 1e-5, the
  parameters as Adam allows (max |diff| <= 2 lr steps, all but 0.1%
  within 1e-5), the scaler's states equal;
* ``TrainStep(scaler=...)`` with a scheduler, on the tiny Llama (losses,
  parameters as above, scaler states equal) and on a linear layer whose
  scaled gradients overflow (skips, rollbacks and states equal; f32
  parameters at rtol 1e-6);
* ``auto_cast(level="O1")`` on the tiny f32 Llama: every white- and
  black-listed call's floating input dtypes, per op name, the same set
  in both packages;
* ``decorate(level="O2")``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import optimizer as joptim
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import LlamaPretrainingCriterion as JCriterion
from paddle_tpu.ops import registry as jregistry
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.convert import llama_state_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW, Momentum
from paddle_tpu_torch.optimizer import lr as tlr

LR = 1e-3


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _close_after_adam(got, want, steps, name=""):
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert diff.max() <= 2 * LR * steps + 1e-6, (name, diff.max())
    assert (diff > 1e-5).mean() < 1e-3, (name, (diff > 1e-5).mean())


# --------------------------------------------------------------------------
# GradScaler, eager
# --------------------------------------------------------------------------
SCALER_KW = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2,
                 decr_every_n_nan_or_inf=2, max_consecutive_skips=10)
INF_AT = {2, 5, 6}        # steps whose gradient holds an inf


def _scaler_run(pkg):
    """10 eager steps of Momentum on one vector, grad = p + 1 (an inf at
    INF_AT): the scaler's state after each and the parameter bits."""
    rng = np.random.RandomState(0)
    w0 = rng.randn(5).astype(np.float32)
    if pkg == "jax":
        p = paddle.to_tensor(w0)
        p.stop_gradient = False
        opt = joptim.Momentum(0.1, parameters=[p])
        scaler = jamp.GradScaler(**SCALER_KW)
    else:
        p = torch.from_numpy(w0.copy()).requires_grad_()
        opt = Momentum(0.1, parameters=[p])
        scaler = tamp.GradScaler(**SCALER_KW)
    states, params = [], []
    for i in range(10):
        pv = _np(p.detach() if pkg == "torch" else p)
        g = (pv + 1.0) * scaler._scale
        if i in INF_AT:
            g[1] = np.inf
        if pkg == "jax":
            p.grad = paddle.to_tensor(g.astype(np.float32))
        else:
            p.grad = torch.from_numpy(g.astype(np.float32))
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        states.append(scaler.state_dict())
        params.append(_np(p.detach() if pkg == "torch" else p).copy())
    return states, params, scaler.skipped_steps


def test_grad_scaler_states_with_injected_infs_equal_jax():
    js, jp, jskip = _scaler_run("jax")
    ts, tp, tskip = _scaler_run("torch")
    assert ts == js
    # step() runs update() and so does the loop, as in the JAX package:
    # each bad step counts twice
    assert tskip == jskip == 2 * len(INF_AT)
    for i, (a, b) in enumerate(zip(tp, jp)):
        np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=str(i))
        if i in INF_AT:          # a skipped step keeps the bits
            np.testing.assert_array_equal(tp[i], tp[i - 1])
    # the scale halved after two bad updates and grew after two good ones
    scales = [s["scale"] for s in ts]
    assert any(b < a for a, b in zip(scales, scales[1:]))
    assert any(b > a for a, b in zip(scales, scales[1:]))


def test_grad_scaler_divergence_guard_raises_at_the_same_update():
    for mk in (jamp.GradScaler, tamp.GradScaler):
        scaler = mk(max_consecutive_skips=3)
        scaler._found_inf = True
        scaler.update()
        scaler.update()
        with pytest.raises(RuntimeError, match="diverged"):
            scaler.update()


def test_grad_scaler_state_dict_round_trip_with_jax():
    js = jamp.GradScaler(**SCALER_KW)
    js._found_inf = True
    js.update()
    ts = tamp.GradScaler()
    ts.load_state_dict(js.state_dict())
    assert ts.state_dict() == js.state_dict()
    assert float(ts.get_loss_scaling()) == float(_np(js.get_loss_scaling()))


def test_scaler_device_state_helpers_equal_jax():
    import jax.numpy as jnp

    for kw in (SCALER_KW, dict(SCALER_KW, use_dynamic_loss_scaling=False)):
        js, ts = jamp.GradScaler(**kw), tamp.GradScaler(**kw)
        jstate = jamp.scaler_init_state(js)
        tstate = tamp.scaler_init_state(ts)
        np.testing.assert_array_equal(tstate.numpy(), np.asarray(jstate))
        for found in (False, False, True, True, False, True, False, False):
            jstate = jamp.scaler_update_state(js, jstate, jnp.asarray(found))
            tstate = tamp.scaler_update_state(ts, tstate,
                                              torch.tensor(found))
            np.testing.assert_array_equal(tstate.numpy(), np.asarray(jstate))
        jamp.scaler_sync_from_state(js, jstate)
        tamp.scaler_sync_from_state(ts, tstate)
        assert ts.state_dict() == js.state_dict()
    g = [np.array([1.0, 2.0], np.float32), np.array([np.inf], np.float32)]
    jg, jf = jamp.scaler_unscale_and_check([jnp.asarray(x) for x in g],
                                           jamp.scaler_init_state(js))
    tg, tf = tamp.scaler_unscale_and_check([torch.from_numpy(x) for x in g],
                                           tamp.scaler_init_state(ts))
    assert bool(tf) == bool(jf) is True
    np.testing.assert_array_equal(tg[0].numpy(), np.asarray(jg[0]))


def test_unscale_reads_the_host_once():
    """unscale_ reduces every gradient's finiteness on the device and
    reads one bool: one host sync, not one per parameter."""
    ps = [torch.ones(3, requires_grad=True) for _ in range(6)]
    for p in ps:
        p.grad = torch.full((3,), 8.0)
    ps[4].grad[1] = float("inf")
    opt = Momentum(0.1, parameters=ps)
    scaler = tamp.GradScaler(init_loss_scaling=8.0)
    reads = []
    orig = torch.Tensor.__bool__

    def counting(self):
        reads.append(1)
        return orig(self)

    torch.Tensor.__bool__ = counting
    try:
        scaler.unscale_(opt)
    finally:
        torch.Tensor.__bool__ = orig
    assert len(reads) == 1 and scaler._found_inf
    assert torch.equal(ps[0].grad, torch.ones(3))


# --------------------------------------------------------------------------
# the tiny Llama: the eager loop and TrainStep(scaler=...)
# --------------------------------------------------------------------------
STEPS = 3


def _tiny_pair(seed=0):
    rng = np.random.RandomState(seed)
    jcfg, cfg = JLlamaConfig.tiny(), LlamaConfig.tiny()
    x = rng.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    y = rng.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    paddle.seed(seed)
    jm = JLlama(jcfg)
    tm = LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(llama_state_from_jax(
        {k: _np(v) for k, v in jm.state_dict().items()}))
    return jm, tm, x, y, jcfg


def _sched(mod):
    return mod.LinearWarmup(mod.CosineAnnealingDecay(LR, T_max=8),
                            warmup_steps=2, start_lr=LR / 10, end_lr=LR)


def _decay_fn_jax(jm):
    excluded = {p.name for n, p in jm.named_parameters() if "norm" in n}
    return lambda name: name not in excluded


def _params_match(jm, tm, steps):
    jp = llama_state_from_jax({k: _np(v) for k, v in jm.state_dict().items()})
    tp = tm.state_dict()
    for name in jp:
        _close_after_adam(tp[name].numpy(), jp[name].numpy(), steps, name)


def test_eager_loop_with_scheduler_and_scaler_matches_jax():
    jm, tm, x, y, jcfg = _tiny_pair()
    jsched, tsched = _sched(jlr), _sched(tlr)
    jopt = joptim.AdamW(jsched, parameters=jm.parameters(),
                        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0),
                        apply_decay_param_fun=_decay_fn_jax(jm))
    topt = AdamW(tsched, parameters=tm.parameters(),
                 grad_clip=ClipGradByGlobalNorm(1.0),
                 apply_decay_param_fun=lambda n: "norm" not in n)
    topt._model_names.update({id(p): n for n, p in tm.named_parameters()})
    kw = dict(init_loss_scaling=2.0 ** 15, incr_every_n_steps=2)
    jscaler, tscaler = jamp.GradScaler(**kw), tamp.GradScaler(**kw)
    jcrit, tcrit = JCriterion(jcfg), tm.criterion()
    jx, jy = paddle.to_tensor(x), paddle.to_tensor(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    losses, lrs, states = ([], []), ([], []), ([], [])
    for _ in range(STEPS):
        for k, (m, opt, sched, scaler, crit, xx, yy) in enumerate((
                (jm, jopt, jsched, jscaler, jcrit, jx, jy),
                (tm, topt, tsched, tscaler, tcrit, tx, ty))):
            lrs[k].append(opt.get_lr())
            loss = crit(m(xx), yy)
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            sched.step()
            losses[k].append(float(_np(loss.detach() if k else loss)))
            states[k].append(scaler.state_dict())
    assert lrs[1] == lrs[0] and len(set(lrs[1])) == STEPS
    assert states[1] == states[0]
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    assert losses[1][-1] < losses[1][0]
    assert topt._step_count == jopt._step_count == STEPS
    _params_match(jm, tm, STEPS)


def test_trainstep_with_scaler_and_scheduler_matches_jax():
    jm, tm, x, y, jcfg = _tiny_pair(1)
    jsched, tsched = _sched(jlr), _sched(tlr)
    jopt = joptim.AdamW(jsched, parameters=jm.parameters(),
                        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0),
                        apply_decay_param_fun=_decay_fn_jax(jm))
    topt = AdamW(tsched, parameters=tm.parameters(),
                 grad_clip=ClipGradByGlobalNorm(1.0),
                 apply_decay_param_fun=lambda n: "norm" not in n)
    kw = dict(init_loss_scaling=2.0 ** 15, incr_every_n_steps=2)
    jscaler, tscaler = jamp.GradScaler(**kw), tamp.GradScaler(**kw)
    jstep = paddle.jit.TrainStep(jm, JCriterion(jcfg), jopt, scaler=jscaler)
    tstep = TrainStep(tm, tm.criterion(), topt, scaler=tscaler)
    jx, jy = paddle.to_tensor(x), paddle.to_tensor(y)
    losses, states, lrs = ([], []), ([], []), []
    for _ in range(STEPS):
        lrs.append(topt.get_lr())
        losses[0].append(float(_np(jstep(jx, jy))))
        losses[1].append(float(tstep(x, y)))
        jsched.step()
        tsched.step()
        states[0].append(jscaler.state_dict())
        states[1].append(tscaler.state_dict())
    assert states[1] == states[0]
    assert states[1][-1]["scale"] == 2.0 ** 16     # grew after 2 steps
    # the schedule's lrs are not f32 values: a double lr would part from
    # the JAX step's f32 one, so the match below checks the f32 path
    assert any(float(np.float32(lr)) != lr for lr in lrs)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    np.testing.assert_allclose(tstep._scaler_state.numpy(),
                               np.asarray(jstep._scaler_state))
    _params_match(jm, tm, STEPS)


def _mse_j(out, y):
    return ((out - y) ** 2).mean()


@pytest.mark.parametrize("skip_nonfinite", [False, True])
def test_trainstep_found_inf_skips_without_rolling_back(skip_nonfinite):
    """A scale that overflows the scaled gradients: found_inf skips the
    update and the scale halves each bad step. Without the guard the
    device step is NOT rolled back; with it, the unscaled infinite
    gradients trip the guard too, which rolls the step back and counts
    the skip. The scaler's schedule is never rolled back."""
    rng = np.random.RandomState(3)
    w = rng.randn(3, 4).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    x = (rng.randn(8, 3) * 1e3).astype(np.float32)
    y = rng.randn(8, 4).astype(np.float32)
    kw = dict(init_loss_scaling=2.0 ** 120, decr_every_n_nan_or_inf=1,
              incr_every_n_steps=3, max_consecutive_skips=0)
    jl = paddle.nn.Linear(3, 4)
    jl.weight.set_value(w)
    jl.bias.set_value(b)
    jopt = joptim.Momentum(0.01, parameters=jl.parameters())
    jscaler = jamp.GradScaler(**kw)
    jstep = paddle.jit.TrainStep(jl, _mse_j, jopt, scaler=jscaler,
                                 skip_nonfinite=skip_nonfinite)
    tl = torch.nn.Linear(3, 4)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w.T.copy()))
        tl.bias.copy_(torch.from_numpy(b))
    topt = Momentum(0.01, parameters=tl.parameters())
    tscaler = tamp.GradScaler(**kw)
    tstep = TrainStep(tl, _mse_j, topt, scaler=tscaler,
                      skip_nonfinite=skip_nonfinite)
    states = ([], [])
    for _ in range(14):
        jstep(paddle.to_tensor(x), paddle.to_tensor(y))
        tstep(x, y)
        states[0].append(jscaler.state_dict())
        states[1].append(tscaler.state_dict())
    assert states[1] == states[0]
    assert states[1][0]["skipped_steps"] == 1     # the first step skipped
    assert states[1][-1]["skipped_steps"] < 14    # and later ones applied
    skipped = states[1][-1]["skipped_steps"]
    applied = float(tstep._step)
    assert applied == float(np.asarray(jstep._carry[0]))
    assert applied == (14 - skipped if skip_nonfinite else 14)
    np.testing.assert_allclose(tl.weight.detach().numpy(),
                               _np(jl.weight).T, rtol=1e-6, atol=1e-6)
    if skip_nonfinite:
        assert tstep.skipped_steps == jstep.skipped_steps == skipped
        assert topt.state_dict()["step"] == jopt.state_dict()["step"] \
            == 14 - skipped


def test_trainstep_scaler_divergence_guard_raises_at_the_same_call():
    rng = np.random.RandomState(4)
    x = rng.randn(4, 3).astype(np.float32)
    x[0, 0] = np.nan                               # every step non-finite
    y = rng.randn(4, 4).astype(np.float32)
    calls = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            m = paddle.nn.Linear(3, 4)
            opt = joptim.Momentum(0.01, parameters=m.parameters())
            step = paddle.jit.TrainStep(
                m, _mse_j, opt,
                scaler=jamp.GradScaler(max_consecutive_skips=3))
            args = (paddle.to_tensor(x), paddle.to_tensor(y))
        else:
            m = torch.nn.Linear(3, 4)
            opt = Momentum(0.01, parameters=m.parameters())
            step = TrainStep(m, _mse_j, opt,
                             scaler=tamp.GradScaler(max_consecutive_skips=3))
            args = (x, y)
        n = 0
        with pytest.raises(RuntimeError, match="diverged"):
            for n in range(1, 10):
                step(*args)
        calls.append(n)
    assert calls[0] == calls[1] == 3


# --------------------------------------------------------------------------
# auto_cast and decorate
# --------------------------------------------------------------------------
def _floating(dtypes):
    return {d for d in dtypes if d in ("float32", "bfloat16", "float16")}


def test_auto_cast_o1_casts_the_same_calls_as_jax():
    jm, tm, x, y, jcfg = _tiny_pair(2)
    seen_j = []
    orig = jamp.cast_for_op

    def hook(name, datas):
        out = orig(name, datas)
        st = jamp.amp_state()
        if st is not None and (name in st["white"] or name in st["black"]):
            seen_j.append((name, [str(getattr(d, "dtype", "")) for d in out]))
        return out

    jregistry.set_amp_hook(hook)
    try:
        with jamp.auto_cast(level="O1"):
            jlogits = jm(paddle.to_tensor(x))
            jloss = JCriterion(jcfg)(jlogits, paddle.to_tensor(y))
    finally:
        jregistry.set_amp_hook(orig)
    with tamp.auto_cast(level="O1"):
        with tamp.observe_casts() as seen_t:
            tlogits = tm(torch.from_numpy(x))
            tloss = tm.criterion()(tlogits, torch.from_numpy(y))

    def by_op(seen):
        out = {}
        for name, dts in seen:
            out.setdefault(name, set()).update(_floating(dts))
        return out

    assert by_op(seen_t) == by_op(seen_j)
    assert set(by_op(seen_t)) >= {"linear", "rms_norm", "mean",
                                  "softmax_with_cross_entropy"}
    assert str(jlogits.dtype).endswith("bfloat16")
    assert tlogits.dtype == torch.bfloat16 and tloss.dtype == torch.float32
    np.testing.assert_allclose(float(tloss), float(_np(jloss)), rtol=2e-2)
    # outside auto_cast nothing is cast
    assert tm(torch.from_numpy(x)).dtype == torch.float32


def test_auto_cast_mapping_table_covers_both_lists():
    assert set(tamp.TORCH_NAMES) == tamp.WHITE_LIST | tamp.BLACK_LIST
    assert tamp.WHITE_LIST == jamp.WHITE_LIST
    assert tamp.BLACK_LIST == jamp.BLACK_LIST
    # every name maps to a torch function or a port op of that name
    fns = {n for n in dir(torch) + dir(torch.nn.functional)
           + dir(torch.Tensor)}
    ported = {"rms_norm", "softmax_with_cross_entropy",
              "scaled_dot_product_attention"}
    assert set(tamp.TORCH_NAMES.values()) <= fns | ported


def test_auto_cast_o2_and_disabled():
    a = torch.ones(2, 3)
    w = torch.ones(4, 3)
    with tamp.auto_cast(level="O2"):
        assert torch.nn.functional.linear(a, w).dtype == torch.bfloat16
        assert (a + 1).dtype == torch.bfloat16           # any call, O2
        assert a.sum().dtype == torch.float32            # black list
        b = torch.zeros(2, 3)
        b.add_(1.0)                                      # in place: kept
        assert b.dtype == torch.float32 and float(b.sum()) == 6.0
        with tamp.auto_cast(enable=False):
            assert (a + 1).dtype == torch.float32
    assert (a + 1).dtype == torch.float32


def test_decorate_o2_casts_parameters_in_place():
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    opt = AdamW(1e-3, parameters=tm.parameters(), multi_precision=True)
    ids = [id(p) for p in tm.parameters()]
    rope = tm.llama.rope_cos.dtype
    m2, o2 = tamp.decorate(tm, opt, level="O2")
    assert m2 is tm and o2 is opt
    assert [id(p) for p in tm.parameters()] == ids
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    assert tm.llama.rope_cos.dtype == rope
    assert tamp.decorate(tm, level="O1") is tm
    assert tamp.is_bfloat16_supported() and tamp.is_float16_supported()


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_tensor_api_casts_at_the_registry_boundary(level):
    """Under ``auto_cast`` a Tensor API op is one cast site, as in the JAX
    package: a white-listed ``matmul`` of f32 inputs runs in bf16, a
    black-listed ``softmax`` of its bf16 output in f32; the dtypes are the
    JAX package's and the values agree at bf16's rounding (rtol 2e-2)."""
    import paddle_tpu_torch as tpaddle
    from paddle_tpu_torch.core import place as tplace

    prev = (tplace._current_place, tplace._current_device)
    tpaddle.set_device("cpu")
    try:
        rng = np.random.default_rng(0)
        a = rng.standard_normal((8, 16)).astype(np.float32)
        b = rng.standard_normal((16, 8)).astype(np.float32)
        got = {}
        for P, mod in ((paddle, jamp), (tpaddle, tamp)):
            with mod.auto_cast(level=level, dtype="bfloat16"):
                m = P.matmul(P.to_tensor(a), P.to_tensor(b))
                s = P.nn.functional.softmax(m)
                t = P.tanh(P.to_tensor(a))
            got[P.__name__] = (m, s, t)
        (jm, js, jt), (tm, ts, tt) = got["paddle_tpu"], \
            got["paddle_tpu_torch"]
        for j, t in ((jm, tm), (js, ts), (jt, tt)):
            assert t.dtype.name == j.dtype.name, (level, j.dtype, t.dtype)
            np.testing.assert_allclose(t.numpy(), j.numpy(), rtol=2e-2,
                                       atol=2e-2)
        assert tm.dtype.name == "bfloat16" and ts.dtype.name == "float32"
        with tamp.auto_cast(level=level), tamp.observe_casts() as seen:
            tpaddle.matmul(tpaddle.to_tensor(a), tpaddle.to_tensor(b))
        assert seen == [("matmul", ["bfloat16", "bfloat16"])], seen
    finally:
        tplace._current_place, tplace._current_device = prev
