"""The port's training step against the JAX package's.

The same numpy inputs and weights go through the JAX package (its Pallas
flash kernels in interpret mode; the tests count ``_flash_fwd`` and
``_flash_bwd`` calls to show the JAX side went through them) and the
port's CPU path: the LM criterion, AdamW (decay exclusion, multi
precision), the global-norm clip, the ``skip_nonfinite`` guard, and the
whole slice -- tiny Llama logits, first-step gradients and three
``TrainStep`` steps. f32 on both sides unless a test says otherwise (the
conftest sets XLA's matmul precision to highest).

Adam's first step is a sign function: each weight moves by about
lr * sign(g), so a gradient near zero whose sign flips under another
summation order lands 2 lr away. So the gradients are compared tightly,
and the parameters after N AdamW steps are held at max |diff| <= 2 lr N
with all but a tiny fraction of them agreeing to float noise."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import optimizer as joptim
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import LlamaPretrainingCriterion as JCriterion
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.convert import (llama_state_from_jax,
                                             optimizer_slots_from_jax)
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           LlamaPretrainingCriterion)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import Adam, AdamW

LR = 1e-3
STEPS = 3


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _close_after_adam(got, want, steps, name=""):
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert diff.max() <= 2 * LR * steps + 1e-6, (name, diff.max())
    assert (diff > 1e-5).mean() < 1e-3, (name, (diff > 1e-5).mean())


# --------------------------------------------------------------------------
# criterion, optimizer, clip
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_criterion_ignores_minus_100_and_means_over_all(dtype):
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 7, 11).astype(np.float32)
    labels = rng.randint(0, 11, (2, 7)).astype(np.int32)
    labels[0, :3] = -100
    labels[1, 5] = -100
    jl = JCriterion()(paddle.to_tensor(logits).astype(dtype),
                      paddle.to_tensor(labels))
    lt = torch.from_numpy(logits).to(getattr(torch, dtype))
    tl = LlamaPretrainingCriterion()(lt, torch.from_numpy(labels))
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(float(tl), float(_np(jl)), rtol=1e-6)
    # the mean runs over all 14 positions, not over the 10 valid ones
    ce = torch.nn.functional.cross_entropy(
        lt.float().reshape(-1, 11), torch.from_numpy(labels).long().reshape(-1),
        ignore_index=-100, reduction="sum")
    np.testing.assert_allclose(float(tl), float(ce) / 14, rtol=1e-6)


def test_adamw_decay_exclusion_and_multi_precision_bf16():
    """bf16 parameters with f32 master weights: three updates of the
    JAX rule (as its TrainStep applies it: f32 lr and step arrays) and
    of the port's, with one parameter excluded from weight decay."""
    rng = np.random.RandomState(1)
    shapes = {"w": (5, 3), "norm": (3,), "frozen_decay": (4,),
              "frozen_nodecay": (4,)}
    init = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: (np.zeros(s, np.float32) if n.startswith("frozen")
                  else rng.randn(*s).astype(np.float32))
              for n, s in shapes.items()} for _ in range(STEPS)]
    no_decay = {"norm", "frozen_nodecay"}

    jp = {n: paddle.to_tensor(a).astype("bfloat16") for n, a in init.items()}
    jnames = {jp[n].name: n for n in jp}
    jopt = joptim.AdamW(LR, parameters=list(jp.values()),
                        apply_decay_param_fun=lambda nm: jnames[nm]
                        not in no_decay, multi_precision=True)
    jslots = {n: jopt._init_slots_mp(p._data) for n, p in jp.items()}
    jdata = {n: p._data for n, p in jp.items()}

    tp = {n: torch.from_numpy(a).to(torch.bfloat16) for n, a in init.items()}
    topt = AdamW(LR, parameters=list(tp.items()),
                 apply_decay_param_fun=lambda nm: nm not in no_decay,
                 multi_precision=True)
    for i in range(STEPS):
        for n in jp:
            jopt._current_decay_enabled = jopt._decay_enabled(jp[n])
            jdata[n], jslots[n] = jopt._rule_mp(
                jdata[n], jnp.asarray(grads[i][n]).astype(jnp.bfloat16),
                jslots[n], jnp.float32(LR), jnp.float32(i + 1))
        topt._apply(list(tp.values()),
                    [torch.from_numpy(grads[i][n]).to(torch.bfloat16)
                     for n in tp], LR, torch.tensor(float(i + 1)))
    for n in tp:
        ts = topt._slots[id(tp[n])]
        assert ts["master_weight"].dtype == torch.float32
        assert ts["moment1"].dtype == torch.float32
        for k in ("master_weight", "moment1", "moment2"):
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(jslots[n][k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(tp[n].float().numpy(),
                                   np.asarray(jdata[n], np.float32),
                                   rtol=8e-3, atol=0)
    # zero gradients: only the decay moves a weight, and not an excluded
    # one (the master weights start from the bf16 parameters)
    mw = {n: topt._slots[id(tp[n])]["master_weight"].numpy() for n in tp}
    start = {n: torch.from_numpy(a).to(torch.bfloat16).float().numpy()
             for n, a in init.items()}
    np.testing.assert_array_equal(mw["frozen_nodecay"],
                                  start["frozen_nodecay"])
    np.testing.assert_allclose(mw["frozen_decay"], start["frozen_decay"]
                               * (1 - LR * 0.01) ** STEPS, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip_norm", [0.5, 100.0])
def test_global_norm_clip_matches_jax(dtype, clip_norm):
    from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JClip

    rng = np.random.RandomState(2)
    gs = [rng.randn(*s).astype(np.float32) for s in [(4, 5), (7,), (3, 3)]]
    jg = JClip(clip_norm).clip_fn([jnp.asarray(g).astype(dtype) for g in gs])
    tg = ClipGradByGlobalNorm(clip_norm).clip_fn(
        [torch.from_numpy(g).to(getattr(torch, dtype)) for g in gs])
    # bf16: one rounding of the same product, up to an ulp apart
    rtol = 1e-6 if dtype == "float32" else 8e-3
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), rtol=rtol)


# --------------------------------------------------------------------------
# skip_nonfinite (the scenario of tests/test_faults.py)
# --------------------------------------------------------------------------
def _mse(out, y):
    return ((out - y) ** 2).mean()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_skip_nonfinite_identity_update(dtype):
    """A NaN batch leaves parameters and Adam slots bit-identical, counts
    one skip (device counter, profiler provider, applied step), and the
    clean steps around it match the JAX TrainStep."""
    from paddle_tpu import nn as jnn

    paddle.seed(0)
    jm = jnn.Linear(3, 3)
    if dtype == "bfloat16":
        jm.to(dtype="bfloat16")
    jopt = joptim.Adam(learning_rate=0.01, parameters=jm.parameters())
    jstep = paddle.jit.TrainStep(jm, jnn.MSELoss(), jopt,
                                 skip_nonfinite=True)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 3)).astype(np.float32)
    y = rng.normal(size=(4, 3)).astype(np.float32)
    nan = np.full((4, 3), np.nan, np.float32)

    tdt = getattr(torch, dtype)
    tm = torch.nn.Linear(3, 3).to(tdt)
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(_np(jm.weight).astype(np.float32).T))
        tm.bias.copy_(torch.from_numpy(_np(jm.bias).astype(np.float32)))
    topt = Adam(learning_rate=0.01, parameters=tm.parameters())
    tstep = TrainStep(tm, _mse, topt, skip_nonfinite=True)

    def run_jax(a):
        return jstep(paddle.to_tensor(a).astype(dtype),
                     paddle.to_tensor(y).astype(dtype))

    def run_port(a):
        return tstep(torch.from_numpy(a).to(tdt),
                     torch.from_numpy(y).to(tdt))

    run_jax(x)
    run_port(x)
    before = [t.detach().clone() for t in tm.parameters()] + [
        v.clone() for s in topt._slots.values() for v in s.values()]
    assert not torch.isfinite(run_port(nan))
    run_jax(nan)
    after = list(tm.parameters()) + [
        v for s in topt._slots.values() for v in s.values()]
    for a, b in zip(before, after):     # bit for bit
        assert a.reshape(-1).view(torch.uint8).equal(
            b.detach().reshape(-1).view(torch.uint8))
    assert tstep.skipped_steps == 1 == jstep.skipped_steps
    assert tprof.counters()[
        f"train_step/nonfinite_skipped#{id(tstep)}"] == 1
    assert topt._step_count == 2
    run_jax(x)
    run_port(x)
    assert tstep.skipped_steps == 1
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else dict(
        rtol=2e-2, atol=1e-2)
    np.testing.assert_allclose(tm.weight.detach().float().numpy(),
                               _np(jm.weight).astype(np.float32).T, **tol)
    np.testing.assert_allclose(tm.bias.detach().float().numpy(),
                               _np(jm.bias).astype(np.float32), **tol)


# --------------------------------------------------------------------------
# the slice: tiny Llama through TrainStep
# --------------------------------------------------------------------------
def _decay_fn_jax(jm):
    excluded = {p.name for n, p in jm.named_parameters() if "norm" in n}
    return lambda name: name not in excluded


@pytest.fixture(scope="module")
def slice_run():
    """Both packages from the same weights: logits, first-step gradients,
    three AdamW + clip TrainStep steps, and a fourth step after carrying
    the JAX optimizer state into a fresh port model."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = jfa._flash_fwd, jfa._flash_bwd

    def counting_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def counting_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    jfa._flash_fwd, jfa._flash_bwd = counting_fwd, counting_bwd
    try:
        out = _slice_run(calls)
    finally:
        jfa._flash_fwd, jfa._flash_bwd = fwd, bwd
    return out


def _slice_run(calls):
    rng = np.random.RandomState(0)
    jcfg, cfg = JLlamaConfig.tiny(), LlamaConfig.tiny()
    x = rng.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    y = rng.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    y[0, :4] = -100
    paddle.seed(0)
    jm = JLlama(jcfg)
    state0 = {k: _np(v) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(llama_state_from_jax(state0))
    res = {"calls": calls, "state0": state0}

    # logits and first-step gradients (JAX eager autograd)
    jlogits = jm(paddle.to_tensor(x))
    jloss = JCriterion(jcfg)(jlogits, paddle.to_tensor(y))
    jloss.backward()
    res["logits"] = (_np(jlogits), tm(torch.from_numpy(x)).detach().numpy())
    res["calls_eager"] = dict(calls)
    tloss = tm.criterion()(tm(torch.from_numpy(x)), torch.from_numpy(y))
    tloss.backward()
    res["loss0"] = (float(_np(jloss)), float(tloss.detach()))
    res["grads"] = {n: (llama_state_from_jax({n: _np(p.grad)})[n].numpy(),
                        dict(tm.named_parameters())[n].grad.numpy())
                    for n, p in jm.named_parameters()}
    for p in jm.parameters():
        p.clear_grad()
    tm.zero_grad(set_to_none=True)

    # three TrainStep steps
    jopt = joptim.AdamW(LR, parameters=jm.parameters(),
                        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0),
                        apply_decay_param_fun=_decay_fn_jax(jm))
    jstep = paddle.jit.TrainStep(jm, JCriterion(jcfg), jopt)
    topt = AdamW(LR, parameters=tm.parameters(),
                 grad_clip=ClipGradByGlobalNorm(1.0),
                 apply_decay_param_fun=lambda n: "norm" not in n)
    tstep = TrainStep(tm, tm.criterion(), topt)
    jx, jy = paddle.to_tensor(x), paddle.to_tensor(y)
    res["losses"] = ([float(_np(jstep(jx, jy))) for _ in range(STEPS)],
                     [float(tstep(x, y)) for _ in range(STEPS)])
    res["calls_train"] = dict(calls)
    res["params"] = (llama_state_from_jax(
        {k: _np(v) for k, v in jm.state_dict().items()}),
        {k: v.detach().clone() for k, v in tm.state_dict().items()})

    # the JAX state after three steps -> a fresh port model, one more step
    fresh = LlamaForCausalLM(cfg, device="cpu")
    fresh.load_state_dict(res["params"][0])
    fopt = AdamW(LR, parameters=fresh.parameters(),
                 grad_clip=ClipGradByGlobalNorm(1.0),
                 apply_decay_param_fun=lambda n: "norm" not in n)
    optimizer_slots_from_jax(
        {n: {k: np.asarray(v) for k, v in jopt._slots[id(p)].items()}
         for n, p in jm.named_parameters()}, fresh, fopt, jopt._step_count)
    fstep = TrainStep(fresh, fresh.criterion(), fopt)
    res["step4"] = (float(_np(jstep(jx, jy))), float(fstep(x, y)))
    res["params4"] = (llama_state_from_jax(
        {k: _np(v) for k, v in jm.state_dict().items()}),
        {k: v.detach().clone() for k, v in fresh.state_dict().items()})
    return res


def test_slice_logits_match(slice_run):
    assert slice_run["calls_eager"]["fwd"] > 0       # JAX took Pallas
    jl, tl = slice_run["logits"]
    assert tl.shape == jl.shape == (2, 16, 256)
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)


def test_slice_first_step_gradients_match(slice_run):
    assert slice_run["calls_eager"]["bwd"] > 0
    np.testing.assert_allclose(*slice_run["loss0"], rtol=1e-6)
    for name, (jg, tg) in slice_run["grads"].items():
        np.testing.assert_allclose(tg, jg, rtol=1e-3, atol=1e-6,
                                   err_msg=name)


def test_slice_trainstep_losses_and_params_match(slice_run):
    c = slice_run["calls_train"]
    assert c["fwd"] > slice_run["calls_eager"]["fwd"]
    assert c["bwd"] > slice_run["calls_eager"]["bwd"]
    jl, tl = slice_run["losses"]
    assert np.all(np.isfinite(tl)) and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    jp, tp = slice_run["params"]
    for name in jp:
        _close_after_adam(tp[name].numpy(), jp[name].numpy(), STEPS, name)
        # every weight really moved
        assert not np.array_equal(tp[name].numpy(),
                                  slice_run["state0"][name].T
                                  if tp[name].dim() == 2 and name.endswith(
                                      ("_proj.weight", "lm_head.weight"))
                                  else slice_run["state0"][name]), name


def test_slice_optimizer_state_carried_from_jax(slice_run):
    """After optimizer_slots_from_jax a fresh port model takes the fourth
    step as the JAX one does (same moments, same bias correction)."""
    np.testing.assert_allclose(*slice_run["step4"], rtol=1e-5)
    jp, tp = slice_run["params4"]
    for name in jp:
        _close_after_adam(tp[name].numpy(), jp[name].numpy(), 1, name)


def test_attn_mask_branch_matches_jax():
    """With an attn_mask the attention goes through plain SDPA in both."""
    rng = np.random.RandomState(4)
    paddle.seed(1)
    jm = JLlama(JLlamaConfig.tiny())
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    tm.load_state_dict(llama_state_from_jax(
        {k: _np(v) for k, v in jm.state_dict().items()}))
    x = rng.randint(0, 256, (2, 10)).astype(np.int32)
    mask = np.tril(np.ones((10, 10), bool))[None, None] & (
        rng.rand(2, 1, 10, 10) > 0.2)
    mask[..., 0] = True
    jl = _np(jm(paddle.to_tensor(x), paddle.to_tensor(mask)))
    tl = tm(torch.from_numpy(x), torch.from_numpy(mask)).detach().numpy()
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# what this slice refuses
# --------------------------------------------------------------------------
@pytest.mark.parametrize("field,value", [
    ("recompute", True), ("sequence_parallel", True),
    ("context_parallel", True)])
def test_config_refuses_later_slices(field, value):
    with pytest.raises(NotImplementedError, match="comes with"):
        LlamaForCausalLM(LlamaConfig.tiny(**{field: value}), device="cpu")


def test_tp_degree_changes_no_number_in_one_process():
    """``LlamaConfig(tp_degree=2)`` in one process trains as
    ``tp_degree=1`` does: the same loss and the same gradient of every
    parameter, bit for bit (the reference: "exact at any value"); the
    bucketed serving forward, whose GQA packing it groups per shard,
    gives the same logits and caches."""
    rng = np.random.RandomState(3)
    ids = torch.from_numpy(rng.randint(0, 256, (2, 12)).astype(np.int64))
    labels = torch.from_numpy(rng.randint(0, 256, (2, 12)).astype(np.int64))
    got = []
    for tp in (1, 2):
        m = LlamaForCausalLM(LlamaConfig.tiny(tp_degree=tp), device="cpu")
        m.init_weights(torch.Generator().manual_seed(0))
        loss = m.criterion()(m(ids), labels)
        loss.backward()
        grads = {n: p.grad.clone() for n, p in m.named_parameters()}
        cache = torch.zeros((2, 8, 4, 2, 16))
        vcache = torch.zeros_like(cache)
        bt = torch.arange(8, dtype=torch.int32).reshape(2, 4)
        logits, kc, vc = m.forward_paged(
            ids[:, :10].int(), cache, vcache, bt,
            torch.tensor([10, 7], dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32),
            torch.tensor([10, 7], dtype=torch.int32))
        got.append((loss.detach(), grads, logits, kc, vc))
    (l1, g1, o1, k1, v1), (l2, g2, o2, k2, v2) = got
    assert torch.equal(l1, l2)
    assert g1.keys() == g2.keys()
    for n in g1:
        assert torch.equal(g1[n], g2[n]), n
    for a, b in ((o1, o2), (k1, k2), (v1, v2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw,match", [
    (dict(sharding="dp"), "comes with slice D"),
    (dict(accumulate_steps=2), "never reads it")])
def test_trainstep_refuses_later_slices(kw, match):
    """``sharding`` comes with slice D; ``accumulate_steps > 1`` is refused
    by design: the JAX TrainStep accepts it and never reads it."""
    m = torch.nn.Linear(2, 2)
    with pytest.raises(NotImplementedError, match=match):
        TrainStep(m, _mse, AdamW(parameters=m.parameters()), **kw)


def test_run_steps_and_lr_scheduler_refused():
    """An LRScheduler is taken (run_steps is ported:
    tests/test_torch_run_steps.py); any other non-number learning rate is
    refused with the JAX package's TypeError (``float(learning_rate)``)."""
    m = torch.nn.Linear(2, 2)
    with pytest.raises(TypeError):
        AdamW(learning_rate=lambda: 1e-3, parameters=m.parameters())
    with pytest.raises(TypeError):
        joptim.AdamW(learning_rate=lambda: 1e-3,
                     parameters=[paddle.to_tensor(np.zeros(2, np.float32))])


def test_trainstep_accepts_a_scaler_and_a_scheduler():
    """What the refusals used to turn away: a GradScaler and an
    LRScheduler-driven optimizer. The lr follows the scheduler, the
    scaler's state is synced from the device once per call."""
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.optimizer.lr import StepDecay

    torch.manual_seed(0)
    m = torch.nn.Linear(2, 2)
    sched = StepDecay(0.1, step_size=1, gamma=0.5)
    opt = AdamW(learning_rate=sched, parameters=m.parameters())
    scaler = GradScaler(init_loss_scaling=8.0, incr_every_n_steps=2)
    step = TrainStep(m, _mse, opt, scaler=scaler)
    x = np.ones((3, 2), np.float32)
    lrs = []
    for _ in range(3):
        lrs.append(opt.get_lr())
        w0 = m.weight.detach().clone()
        step(x, x)
        assert not torch.equal(w0, m.weight.detach())
        sched.step()
    assert lrs == [0.1, 0.05, 0.025]
    assert scaler._scale == 16.0 and scaler._good_steps == 1
    assert step._scaler_state.tolist() == [16.0, 1.0, 0.0, 0.0, 0.0]
    assert opt._step_count == 3
