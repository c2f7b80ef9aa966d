"""The port's optimizers and LR schedulers against the JAX package's.

The same seeded numpy inputs go through both packages:

* every scheduler's lr over 30 steps (``ReduceOnPlateau`` on a fixed
  metric list) and after a ``state_dict`` hand-off: equal, float for
  float;
* every rule's parameters and slots after 5 eager ``step()`` calls on a
  quadratic (gradients a * (p - c), computed in numpy from each side's
  own parameters) and on the tiny Llama's parameters (gradients
  0.5 p + noise, in each side's layout): f32 at rtol 1e-6 (atol 1e-7 for
  the entries that pass through zero); bf16 parameters with
  ``multi_precision`` at rtol 1e-6 on the f32 master weights and slots
  and one bf16 rounding (rtol 2^-8) on the parameters;
* ``LBFGS`` through its closure, with and without the strong-Wolfe
  line search: one ``step`` of 5 iterations, stopped short of the
  minimum (there the losses agree to the last bit or two, and a line
  search over equal-to-noise losses branches on that noise): the same
  evaluations, losses and parameters at rtol 1e-5;
* a JAX ``state_dict`` carried over by ``optimizer_state_from_jax``: the
  continuation matches (f32, rtol 1e-6).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as joptim
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.models.convert import (_torch_layout,
                                             llama_state_from_jax,
                                             optimizer_state_from_jax)
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.optimizer import lr as tlr

F32 = dict(rtol=1e-6, atol=1e-7)
STEPS = 5


# --------------------------------------------------------------------------
# schedulers
# --------------------------------------------------------------------------
SCHEDULERS = {
    "NoamDecay": lambda m: m.NoamDecay(d_model=64, warmup_steps=5,
                                       learning_rate=1.0),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.5, gamma=0.9),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.5, gamma=0.1),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.5, gamma=0.2),
    "PolynomialDecay": lambda m: m.PolynomialDecay(
        0.5, decay_steps=7, end_lr=0.01, power=2.0, cycle=True),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([5, 12], [0.5, 0.1, 0.01]),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(
        0.5, T_max=8, eta_min=0.01),
    "CosineAnnealingWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.5, T_0=4, T_mult=2, eta_min=0.01),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.5, milestones=[4, 9, 20],
                                                 gamma=0.5),
    "StepDecay": lambda m: m.StepDecay(0.5, step_size=4, gamma=0.7),
    "LambdaDecay": lambda m: m.LambdaDecay(0.5, lambda e: 0.95 ** e),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(0.5,
                                                           lambda e: 0.9),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(
        0.5, patience=2, cooldown=1, factor=0.5, threshold=0.01),
    "LinearWarmup_scheduler": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(3e-4, T_max=8), warmup_steps=2,
        start_lr=0.0, end_lr=3e-4),
    "LinearWarmup_float": lambda m: m.LinearWarmup(
        0.5, warmup_steps=5, start_lr=0.01, end_lr=0.5),
    "ConstantLR": lambda m: m.ConstantLR(0.5, factor=0.3, total_iters=5),
    "LinearLR": lambda m: m.LinearLR(0.5, start_factor=0.2,
                                     end_factor=1.0, total_steps=6),
    "OneCycleLR": lambda m: m.OneCycleLR(0.5, total_steps=30),
    "OneCycleLR_linear": lambda m: m.OneCycleLR(
        0.5, total_steps=20, anneal_strategy="linear"),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.5, step_size_up=4),
    "CyclicLR_triangular2": lambda m: m.CyclicLR(
        0.01, 0.5, step_size_up=3, step_size_down=5, mode="triangular2"),
    "CyclicLR_exp_range": lambda m: m.CyclicLR(
        0.01, 0.5, step_size_up=3, mode="exp_range", exp_gamma=0.9),
}
# a fixed metric sequence for ReduceOnPlateau: falls, stalls, falls
METRICS = [5.0, 4.0, 3.9, 3.95, 3.96, 3.97, 3.0, 2.99, 2.995, 2.999,
           3.1, 3.2, 3.3, 1.0, 1.0, 1.0, 1.0, 0.5, 0.5, 0.5, 0.5, 0.5,
           0.4, 0.4, 0.4, 0.4, 0.4, 0.4, 0.4, 0.4]


def _lrs(sched, steps=30):
    out = []
    for i in range(steps):
        out.append(sched())
        if type(sched).__name__ == "ReduceOnPlateau":
            sched.step(METRICS[i])
        else:
            sched.step()
    return out


def test_every_scheduler_is_covered():
    names = {n.split("_")[0] for n in SCHEDULERS}
    assert names == set(jlr.__all__) - {"LRScheduler"}
    assert set(tlr.__all__) == set(jlr.__all__)


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_lr_sequence_equals_jax(name):
    j, t = SCHEDULERS[name](jlr), SCHEDULERS[name](tlr)
    jl, tl = _lrs(j), _lrs(t)
    assert tl == jl
    assert len(set(tl)) > 1 or name == "ConstantLR"


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_state_dict_hand_off(name):
    """10 steps in JAX, its state_dict into a fresh port scheduler, 20 more
    steps on both: the same lrs."""
    j, t = SCHEDULERS[name](jlr), SCHEDULERS[name](tlr)
    _lrs(j, 10)
    state = j.state_dict()
    t.set_state_dict(dict(state))
    assert t.state_dict() == state
    if name == "ReduceOnPlateau":
        assert t() == j()
        return
    assert _lrs(t, 20) == _lrs(j, 20)


# --------------------------------------------------------------------------
# rules
# --------------------------------------------------------------------------
RULES = {
    "SGD": dict(learning_rate=0.1, weight_decay=0.01),
    "Momentum": dict(learning_rate=0.05, momentum=0.9, weight_decay=0.01),
    "Momentum_nesterov": dict(learning_rate=0.05, momentum=0.9,
                              use_nesterov=True),
    "Adagrad": dict(learning_rate=0.1, initial_accumulator_value=0.1),
    "Adadelta": dict(learning_rate=1.0, rho=0.9, weight_decay=0.01),
    "RMSProp": dict(learning_rate=0.01, rho=0.9, momentum=0.5),
    "RMSProp_centered": dict(learning_rate=0.01, centered=True),
    "Adam": dict(learning_rate=0.05, weight_decay=0.01),
    "AdamW": dict(learning_rate=0.05, weight_decay=0.1),
    "Adamax": dict(learning_rate=0.05, weight_decay=0.01),
    "Lamb": dict(learning_rate=0.05, lamb_weight_decay=0.01),
    "NAdam": dict(learning_rate=0.05),
    "RAdam": dict(learning_rate=0.05, beta2=0.9),
    "ASGD": dict(learning_rate=0.05, batch_num=3, weight_decay=0.01),
    "Rprop": dict(learning_rate=0.01),
}


def _rule_cls(mod, name):
    return getattr(mod, name.split("_")[0])


def test_every_rule_is_covered():
    names = {n.split("_")[0] for n in RULES} | {"LBFGS"}
    assert names == set(joptim.__dict__) & set(toptim.__all__) - {
        "Optimizer", "lr"}


class _Problem:
    """Parameters in both packages' layouts, with a gradient rule
    ``grad(i, name, p)`` over numpy arrays in the JAX layout."""

    def __init__(self, inits, grad, layout=lambda n, a: a):
        self.inits, self.grad, self.layout = inits, grad, layout


def _quadratic():
    rng = np.random.RandomState(3)
    shapes = {"w": (6, 4), "b": (4,), "v": (7,)}
    inits = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    a = {n: (0.5 + rng.rand(*s)).astype(np.float32)
         for n, s in shapes.items()}
    c = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    return _Problem(inits, lambda i, n, p: a[n] * (p - c[n]))


def _tiny_llama():
    paddle.seed(0)
    jm = JLlama(JLlamaConfig.tiny())
    inits = {n: np.asarray(p.numpy(), np.float32)
             for n, p in jm.named_parameters()}
    rng = np.random.RandomState(5)
    noise = [{n: rng.randn(*a.shape).astype(np.float32)
              for n, a in inits.items()} for _ in range(STEPS)]
    return _Problem(inits, lambda i, n, p: np.float32(0.5) * p
                    + noise[i][n], layout=_torch_layout)


@pytest.fixture(scope="module")
def tiny_llama_problem():
    return _tiny_llama()


def _run_both(name, prob, steps=STEPS, dtype="float32", mp=False):
    """``steps`` eager steps of rule ``name`` in both packages. Returns
    (jax params, port params, jax slots, port slots), as numpy in the
    JAX layout, keyed by parameter name."""
    kw = dict(RULES[name])
    if mp:
        kw["multi_precision"] = True
    names = list(prob.inits)
    jp = {}
    for n in names:
        t = paddle.to_tensor(prob.inits[n]).astype(dtype)
        t.stop_gradient = False
        jp[n] = t
    tp = {n: torch.from_numpy(np.array(prob.layout(n, prob.inits[n]),
                                       dtype=np.float32))
          .to(getattr(torch, dtype)).requires_grad_() for n in names}
    jopt = _rule_cls(joptim, name)(parameters=list(jp.values()), **kw)
    topt = _rule_cls(toptim, name)(parameters=list(tp.values()), **kw)
    for i in range(steps):
        for n in names:
            jg = prob.grad(i, n, np.asarray(jp[n].astype("float32").numpy()))
            jp[n].grad = paddle.to_tensor(jg).astype(dtype)
            tg = prob.grad(i, n, np.ascontiguousarray(
                prob.layout(n, tp[n].detach().float().numpy())))
            tp[n].grad = torch.from_numpy(np.ascontiguousarray(
                prob.layout(n, tg))).to(getattr(torch, dtype))
        jopt.step()
        jopt.clear_grad()
        topt.step()
        topt.clear_grad()
        assert all(p.grad is None for p in tp.values())

    def back(n, a):
        return np.asarray(prob.layout(n, a), np.float32)

    jparams = {n: np.asarray(p.astype("float32").numpy()) for n, p in
               jp.items()}
    tparams = {n: back(n, p.detach().float().numpy())
               for n, p in tp.items()}
    jslots = {n: {k: np.asarray(v, np.float32)
                  for k, v in jopt._slots[id(jp[n])].items()} for n in names}
    tslots = {}
    for n in names:
        tslots[n] = {}
        for k, v in topt._slots[id(tp[n])].items():
            a = v.detach().float().numpy()
            tslots[n][k] = (np.stack([back(n, x) for x in a]) if k == "ys"
                            else back(n, a))
    assert jopt._step_count == topt._step_count == steps
    return jparams, tparams, jslots, tslots


def _assert_match(res, tol):
    jparams, tparams, jslots, tslots = res
    for n in jparams:
        np.testing.assert_allclose(tparams[n], jparams[n], err_msg=n, **tol)
        assert set(tslots[n]) == set(jslots[n]), n
        for k in jslots[n]:
            np.testing.assert_allclose(tslots[n][k], jslots[n][k],
                                       err_msg=f"{n}.{k}", **tol)


@pytest.mark.parametrize("name", sorted(RULES))
def test_rule_on_the_quadratic_matches_jax(name):
    res = _run_both(name, _quadratic())
    _assert_match(res, F32)
    # every parameter moved
    q = _quadratic()
    assert all(not np.array_equal(res[1][n], q.inits[n]) for n in q.inits)


@pytest.mark.parametrize("name", sorted(RULES))
def test_rule_on_the_tiny_llama_matches_jax(name, tiny_llama_problem):
    _assert_match(_run_both(name, tiny_llama_problem), F32)


@pytest.mark.parametrize("name", sorted(RULES))
def test_rule_bf16_multi_precision_matches_jax(name):
    jparams, tparams, jslots, tslots = _run_both(
        name, _quadratic(), dtype="bfloat16", mp=True)
    for n in jparams:
        assert "master_weight" in tslots[n]
        np.testing.assert_allclose(tparams[n], jparams[n], rtol=2 ** -8,
                                   atol=0, err_msg=n)
        for k in jslots[n]:
            np.testing.assert_allclose(tslots[n][k], jslots[n][k],
                                       err_msg=f"{n}.{k}", **F32)


def test_adamw_decay_exclusion_by_name():
    """apply_decay_param_fun gets the name given with the parameter."""
    rng = np.random.RandomState(0)
    w = rng.randn(3).astype(np.float32)
    ps = {n: torch.from_numpy(w.copy()).requires_grad_()
          for n in ("norm", "w")}
    opt = toptim.AdamW(0.1, parameters=list(ps.items()), weight_decay=0.5,
                       apply_decay_param_fun=lambda n: n != "norm")
    for p in ps.values():
        p.grad = torch.zeros(3)
    opt.step()
    np.testing.assert_array_equal(ps["norm"].detach().numpy(), w)
    np.testing.assert_allclose(ps["w"].detach().numpy(), w * (1 - 0.1 * 0.5),
                               rtol=1e-6)


@pytest.mark.parametrize("name", sorted(RULES))
def test_rule_through_trainstep_matches_jax(name):
    """3 TrainStep steps of a Linear layer in both packages: the rule gets
    the f32 lr and the device step there (tensor branches of RAdam and
    ASGD), f32 at rtol 1e-5 (XLA fuses the rule's arithmetic)."""
    from paddle_tpu_torch.jit import TrainStep

    rng = np.random.RandomState(11)
    w = rng.randn(4, 3).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    x = rng.randn(8, 4).astype(np.float32)
    y = rng.randn(8, 3).astype(np.float32)

    def mse(out, yy):
        return ((out - yy) ** 2).mean()

    jl = paddle.nn.Linear(4, 3)
    jl.weight.set_value(w)
    jl.bias.set_value(b)
    jstep = paddle.jit.TrainStep(jl, mse, _rule_cls(joptim, name)(
        parameters=jl.parameters(), **RULES[name]))
    tl = torch.nn.Linear(4, 3)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w.T.copy()))
        tl.bias.copy_(torch.from_numpy(b))
    tstep = TrainStep(tl, mse, _rule_cls(toptim, name)(
        parameters=tl.parameters(), **RULES[name]))
    for _ in range(3):
        jloss = float(np.asarray(jstep(paddle.to_tensor(x),
                                       paddle.to_tensor(y)).numpy()))
        tloss = float(tstep(x, y))
        np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    np.testing.assert_allclose(tl.weight.detach().numpy(),
                               np.asarray(jl.weight.numpy()).T,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tl.bias.detach().numpy(),
                               np.asarray(jl.bias.numpy()),
                               rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# LBFGS
# --------------------------------------------------------------------------
@pytest.mark.parametrize("line_search", [None, "strong_wolfe"])
def test_lbfgs_closure_matches_jax(line_search):
    rng = np.random.RandomState(7)
    x0 = rng.randn(8).astype(np.float32)
    a = (1.0 + rng.rand(8)).astype(np.float32)
    c = rng.randn(8).astype(np.float32)

    jx = paddle.to_tensor(x0)
    jx.stop_gradient = False
    ja, jc = paddle.to_tensor(a), paddle.to_tensor(c)
    jopt = joptim.LBFGS(learning_rate=1.0, max_iter=5, history_size=4,
                        line_search_fn=line_search, parameters=[jx])

    def jclosure():
        jopt.clear_grad()
        loss = (0.5 * ja * (jx - jc) ** 2).sum() + (jx ** 4).sum() * 0.01
        loss.backward()
        return loss

    tx = torch.from_numpy(x0.copy()).requires_grad_()
    ta, tc = torch.from_numpy(a), torch.from_numpy(c)
    topt = toptim.LBFGS(learning_rate=1.0, max_iter=5, history_size=4,
                        line_search_fn=line_search, parameters=[tx])

    def tclosure():
        topt.clear_grad()
        loss = (0.5 * ta * (tx - tc) ** 2).sum() + (tx ** 4).sum() * 0.01
        loss.backward()
        return loss

    jl = float(jopt.step(jclosure))
    tl = float(topt.step(tclosure))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(float(tclosure().detach()),
                               float(jclosure()), rtol=1e-5)
    np.testing.assert_allclose(tx.detach().numpy(), np.asarray(jx.numpy()),
                               rtol=1e-5, atol=1e-6)
    assert topt._state["func_evals"] == jopt._state["func_evals"]
    assert topt._state["n_iter"] == jopt._state["n_iter"]
    # it minimised: the gradient is small at the end
    assert float(tclosure().detach()) < float(0.5 * (a * (x0 - c) ** 2).sum()
                                      + 0.01 * (x0 ** 4).sum())


# --------------------------------------------------------------------------
# state dicts across the packages
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["AdamW", "Momentum", "ASGD", "Lamb"])
def test_state_dict_from_jax_continues_alike(name, tiny_llama_problem):
    """3 JAX steps over the tiny Llama's parameters, its state_dict (and
    weights) carried into the port, 2 more steps on both."""
    prob = tiny_llama_problem
    kw = dict(RULES[name])
    sched_j = jlr.CosineAnnealingDecay(kw.pop("learning_rate"), T_max=8)
    sched_t = tlr.CosineAnnealingDecay(sched_j.base_lr, T_max=8)
    names = list(prob.inits)
    jp = {}
    for n in names:
        t = paddle.to_tensor(prob.inits[n])
        t.stop_gradient = False
        jp[n] = t
    jopt = _rule_cls(joptim, name)(learning_rate=sched_j,
                                   parameters=list(jp.values()), **kw)

    def jstep(i):
        for n in names:
            jp[n].grad = paddle.to_tensor(
                prob.grad(i, n, np.asarray(jp[n].numpy())))
        jopt.step()
        jopt.clear_grad()
        sched_j.step()

    for i in range(3):
        jstep(i)
    state = jopt.state_dict()
    assert state["step"] == 3 and "LR_Scheduler" in state
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    model.load_state_dict(llama_state_from_jax(
        {n: np.asarray(p.numpy()) for n, p in jp.items()}))
    assert [n for n, _ in model.named_parameters()] == names
    tparams = list(model.parameters())
    topt = _rule_cls(toptim, name)(learning_rate=sched_t,
                                   parameters=tparams, **kw)
    topt.set_state_dict(optimizer_state_from_jax(state, model))
    assert topt._step_count == 3 and sched_t.last_epoch == 3
    assert set(topt.state_dict()) == set(state)
    for i in range(3, 5):
        jstep(i)
        with torch.no_grad():
            for n, p in zip(names, tparams):
                p.grad = torch.from_numpy(np.ascontiguousarray(prob.layout(
                    n, prob.grad(i, n, np.ascontiguousarray(
                        prob.layout(n, p.detach().numpy()))))))
        topt.step()
        topt.clear_grad()
        sched_t.step()
    for n, p in zip(names, tparams):
        np.testing.assert_allclose(prob.layout(n, p.detach().numpy()),
                                   np.asarray(jp[n].numpy()), err_msg=n,
                                   **F32)


def test_state_dict_round_trip_in_the_port():
    """state_dict -> set_state_dict on a fresh optimizer: same keys, same
    values (copied, not shared), the step and the scheduler with them."""
    rng = np.random.RandomState(2)
    p = torch.from_numpy(rng.randn(4, 3).astype(np.float32)).requires_grad_()
    sched = tlr.StepDecay(0.1, step_size=2)
    opt = toptim.Adam(learning_rate=sched, parameters=[p])
    for _ in range(3):
        p.grad = torch.ones_like(p)
        opt.step()
        sched.step()
    sd = opt.state_dict()
    assert set(sd) == {"step", "LR_Scheduler", "param_0.moment1",
                       "param_0.moment2"}
    q = p.detach().clone().requires_grad_()
    sched2 = tlr.StepDecay(0.1, step_size=2)
    opt2 = toptim.Adam(learning_rate=sched2, parameters=[q])
    opt2.set_state_dict(sd)
    assert opt2._step_count == 3 and opt2.get_lr() == opt.get_lr()
    m2 = opt2._slots[id(q)]["moment1"]
    assert torch.equal(m2, sd["param_0.moment1"])
    assert m2.data_ptr() != sd["param_0.moment1"].data_ptr()
    for o, t in ((opt, p), (opt2, q)):
        t.grad = torch.full_like(t, 0.5)
        o.step()
    assert torch.equal(p, q)


def test_set_lr_and_minimize():
    p = torch.zeros(2, requires_grad=True)
    opt = toptim.SGD(learning_rate=0.5, parameters=[p])
    opt.set_lr(0.25)
    assert opt.get_lr() == 0.25
    opt.minimize(((p - 1.0) ** 2).sum())
    assert p.grad is None
    np.testing.assert_allclose(p.detach().numpy(), [0.5, 0.5])
    sched_opt = toptim.SGD(learning_rate=tlr.StepDecay(0.1, 1),
                           parameters=[p])
    with pytest.raises(RuntimeError, match="LRScheduler"):
        sched_opt.set_lr(0.1)

    class Variable:
        pass

    with pytest.raises(NotImplementedError, match="E3"):
        opt.minimize(Variable())


def test_adamw_takes_tensor_api_parameters():
    """Three AdamW steps on Tensor API parameters (``to_tensor(...,
    stop_gradient=False)``) against the JAX package's on the same seeded
    quadratic-plus-tanh loss: losses and parameters at rtol 1e-5; the
    update lands in each Tensor's data in place, and a Tensor whose data
    was rebound since is followed."""
    import paddle_tpu_torch as tpaddle
    from paddle_tpu_torch.core import place as tplace

    prev = (tplace._current_place, tplace._current_device)
    tpaddle.set_device("cpu")
    try:
        rng = np.random.default_rng(0)
        w0 = rng.standard_normal((4, 3)).astype(np.float32)
        b0 = rng.standard_normal((3,)).astype(np.float32)
        x = rng.standard_normal((5, 4)).astype(np.float32)
        out = {}
        for P, optim in ((paddle, joptim), (tpaddle, toptim)):
            w = P.to_tensor(w0, stop_gradient=False)
            b = P.to_tensor(b0, stop_gradient=False)
            opt = optim.AdamW(learning_rate=0.1, parameters=[w, b],
                              weight_decay=0.05)
            losses = []
            for _ in range(3):
                loss = (P.tanh(P.matmul(P.to_tensor(x), w) + b) ** 2).mean()
                loss.backward()
                opt.step()
                opt.clear_grad()
                losses.append(float(loss))
            out[P.__name__] = (losses, w.numpy(), b.numpy(), w, opt)
        (jl, jw, jb, _, _), (tl, tw, tb, tw_t, topt) = \
            out["paddle_tpu"], out["paddle_tpu_torch"]
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        np.testing.assert_allclose(tw, jw, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tb, jb, rtol=1e-5, atol=1e-6)
        assert topt._parameter_list[0] is tw_t._data
        assert tw_t.grad is None
        tw_t.set_value(np.zeros((4, 3), np.float32))   # rebinds the data
        (tw_t.sum() * 1.0).backward()
        topt.step()
        assert topt._parameter_list[0] is tw_t._data
        assert not np.allclose(tw_t.numpy(), 0.0)
    finally:
        tplace._current_place, tplace._current_device = prev
