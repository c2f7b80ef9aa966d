"""The port's mixture of experts (``paddle_tpu_torch.incubate.moe``)
against the JAX package's, case by case of ``tests/test_moe.py``.

Each case builds the reference test's ``MoEModel`` (Linear -> MoELayer ->
Linear, 8 experts of Linear -> gelu -> Linear) in the JAX package and
gives the port's the same weights (``models.convert.moe_state_from_jax``)
and the same generator state, so both draw the same keys: the gates'
noise and random routing, hence the routing and the tokens dropped, are
the same. The parallel cases run the JAX ``ParallelTrainStep`` in this
process on conftest's virtual devices and the port's on one gloo world
of 4 processes (``paddle_tpu_torch.testing.moe_ranks``): ep 4 with the
batch replicated over ep, ep 4 with the batch sharded over ep (the
all-to-all), dp 2 x ep 2, and dp 2 x ep 2 with the batch over both.

Bounds: losses rtol 1e-4; outputs, aux losses and parameters rtol 2e-3
/ atol 2e-5 (the parameters as ``test_torch_parallel_train.py``); each
expert leaf's gradient (one SGD step of lr 1: the parameter's move)
rtol 1e-4 / atol 1e-6; routings (dense dispatch masks) equal."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import paddle_tpu as jpaddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.core import generator as jgen
from paddle_tpu.distributed.engine import (ParallelConfig as JConfig,
                                           ParallelTrainStep as JStep)
from paddle_tpu.distributed.mesh import ProcessMesh as JMesh
from paddle_tpu.incubate.moe import moe_layer as jmoe
from test_moe import MoEModel as JMoEModel

import _hybrid_jax as hj

LOSS_RTOL = 1e-4
RTOL, ATOL = 2e-3, 2e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def _batches(n, seed=2, rows=16):
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, 4, 16).astype(np.float32)
    return [(x, np.tanh(x))] * n


def _jax_model(case):
    jpaddle.seed(case["seed"])
    m = JMoEModel(gate=case["spec"].get("gate", "gshard"),
                  ep_axis=case["spec"].get("ep_axis"))
    m.moe.capacity_factor = case["spec"].get("capacity_factor", 2.0)
    case["state"] = {k: np.asarray(v.numpy()).copy()
                     for k, v in m.state_dict().items()}
    case["rng_state"] = tuple(int(s) for s in jgen.get_rng_state())
    return m


def _jax_train(case):
    """The JAX run of ``case``: losses and final parameters."""
    m = _jax_model(case)
    cls = {"adamw": jopt.AdamW, "sgd": jopt.SGD}[case.get("opt", "adamw")]
    opt = cls(parameters=m.parameters(), **case["opt_kw"])

    def loss_fn(out, y):
        return jnn.MSELoss()(out, y) + 0.01 * m.moe.aux_loss

    if case.get("mesh") is None:
        step = jpaddle.jit.TrainStep(m, loss_fn, opt)
    else:
        n = int(np.prod(case["mesh"]))
        mesh = JMesh(np.arange(n).reshape(case["mesh"]),
                     dim_names=case["dims"])
        step = JStep(m, loss_fn, opt, mesh, JConfig(**case.get("config", {})),
                     n_model_inputs=1)

    def run():
        losses = [float(step(jpaddle.to_tensor(x), jpaddle.to_tensor(y))
                        .item()) for x, y in case["batches"]]
        final = {k: np.asarray(v.numpy()) for k, v in
                 m.state_dict().items()}
        return {"losses": losses, "final": final}
    return run


def _case(name, mesh=None, dims=None, config=None, opt="adamw", steps=3,
          gate="gshard", capacity_factor=2.0):
    return dict(name=name, mesh=mesh, dims=dims, config=config or {},
                opt=opt, seed=3,
                opt_kw=dict(learning_rate=1.0 if opt == "sgd" else 5e-3),
                spec=dict(gate=gate, ep_axis="ep" if mesh else None,
                          capacity_factor=capacity_factor),
                batches=_batches(1 if opt == "sgd" else steps))


PLACEMENTS = [
    ("ep4_replicated", [4], ["ep"], {}),
    ("ep4_sharded", [4], ["ep"], dict(dp_axes=("ep",))),
    ("dp2_ep2", [2, 2], ["dp", "ep"], {}),
    ("dp2_ep2_sharded", [2, 2], ["dp", "ep"], dict(dp_axes=("dp", "ep"))),
]
CASES = [_case("one_rank")] + [
    _case(n, m, d, c) for n, m, d, c in PLACEMENTS] + [
    _case(n + "_grad", m, d, c, opt="sgd") for n, m, d, c in PLACEMENTS] + [
    _case("one_rank_grad", opt="sgd"),
    _case("ep4_sharded_switch", [4], ["ep"], dict(dp_axes=("ep",)),
          gate="switch")] + [
    # capacity 0.5: C = 4 slots an expert for 128 choices, tokens dropped
    _case(n + "_drop", m, d, c, capacity_factor=0.5) for n, m, d, c in
    [("one_rank", None, None, {})] + PLACEMENTS]
DROP = [p[0] + "_drop" for p in PLACEMENTS]


@pytest.fixture(scope="module")
def runs():
    from paddle_tpu_torch.testing import gloo_ranks, moe_ranks

    finish = [_jax_train(c) for c in CASES]
    world = gloo_ranks.start(moe_ranks.train_cases, 4, CASES,
                             timeout_s=240)
    refs = {c["name"]: f() for c, f in zip(CASES, finish)}
    return {c["name"]: c for c in CASES}, refs, world.results()


def _check(results, case, ref, rtol=RTOL, atol=ATOL):
    name = case["name"]
    n = int(np.prod(case["mesh"])) if case.get("mesh") else 1
    for i in range(n):
        r = results[i][name]
        assert "error" not in r, r.get("error")
        np.testing.assert_allclose(r["losses"], ref["losses"],
                                   rtol=LOSS_RTOL, err_msg=f"rank {i}")
    got = hj.assemble(results, name, n) if case.get("mesh") \
        else results[0][name]["shards"]
    for pname, want in ref["final"].items():
        np.testing.assert_allclose(got[pname], want, rtol=rtol, atol=atol,
                                   err_msg=pname)
    return got


@pytest.mark.parametrize("name", ["one_rank"] + [p[0] for p in PLACEMENTS]
                         + ["ep4_sharded_switch", "one_rank_drop"] + DROP)
def test_parallel_step_matches_the_jax_step(runs, name):
    """Three AdamW steps: every rank's losses and the parameters
    assembled from the ranks' expert shards."""
    cases, refs, results = runs
    _check(results, cases[name], refs[name])


@pytest.mark.parametrize("name", ["one_rank_grad"] + [
    p[0] + "_grad" for p in PLACEMENTS])
def test_every_expert_leaf_gradient_matches(runs, name):
    """One SGD step of lr 1 moves each parameter by its gradient: every
    expert leaf's (and every other parameter's) gradient is the JAX
    step's (a join whose backward summed over ep would give ep x the
    experts' gradients)."""
    cases, refs, results = runs
    case = cases[name]
    got = _check(results, case, refs[name], GRAD_RTOL, GRAD_ATOL)
    for pname, init in case["state"].items():
        np.testing.assert_allclose(init - got[pname],
                                   init - refs[name]["final"][pname],
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=pname)


@pytest.mark.parametrize("name", DROP)
def test_the_placements_drop_the_one_rank_tokens(runs, name):
    """At capacity 0.5 each step drops choices. A rank counts the dropped
    choices of the tokens it routes: with the tokens split over ranks the
    counts of one replica's shares add up to the one-rank run's, and with
    them replicated each rank's count is the one-rank count (the global
    positions decide, not the rank's own)."""
    cases, _, results = runs
    one = results[0]["one_rank_drop"]["dropped"]
    assert len(one) == 3 and min(one) > 0
    case = cases[name]
    mesh = np.arange(int(np.prod(case["mesh"]))).reshape(case["mesh"])
    split = set(case["config"].get("dp_axes", ("dp",))) & set(case["dims"])
    # the ranks holding one copy of the batch: one along each split axis
    first = mesh[tuple(slice(None) if d in split else 0
                       for d in case["dims"])].reshape(-1)
    counts = [results[r][name]["dropped"] for r in first]
    assert [sum(c[s] for c in counts) for s in range(3)] == one


# ---------------------------------------------------------------------------
# one process: the layer against the JAX layer
# ---------------------------------------------------------------------------
def _pair(gate="gshard", seed=0):
    """(JAX model, port model) with the same weights and generator
    state."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.convert import moe_state_from_jax
    from paddle_tpu_torch.testing.moe_ranks import MoEModel

    case = dict(seed=seed, spec=dict(gate=gate))
    jm = _jax_model(case)
    paddle.set_device("cpu")
    pm = MoEModel(gate=gate)
    pm.set_state_dict(moe_state_from_jax(case["state"]))
    paddle.set_rng_state(case["rng_state"])
    return jm, pm


class _Record:
    """Each routing call's dense dispatch mask, in the JAX package and in
    the port (their ``_top1_dispatch`` / ``_top2_dispatch`` wrapped)."""

    def __init__(self, monkeypatch):
        from paddle_tpu_torch.incubate.moe import moe_layer as pmoe

        self.jax, self.port = [], []
        for fn in ("_top1_dispatch", "_top2_dispatch"):
            monkeypatch.setattr(jmoe, fn, self._jax(getattr(jmoe, fn)))
            monkeypatch.setattr(pmoe, fn, self._port(getattr(pmoe, fn)))

    def _jax(self, fn):
        def inner(*a, **kw):
            out = fn(*a, **kw)
            self.jax.append(np.asarray(out[1]))
            return out
        return inner

    def _port(self, fn):
        def inner(logits, *a, **kw):
            r = fn(logits, *a, **kw)
            self.port.append(r.dense(logits.shape[1])[1].numpy())
            return r
        return inner

    def check(self):
        assert len(self.jax) == len(self.port) > 0
        for i, (a, b) in enumerate(zip(self.jax, self.port)):
            np.testing.assert_array_equal(b, a, err_msg=f"routing call {i}")


@pytest.mark.parametrize("train", [True, False])
def test_forward_and_aux_match_the_jax_layer(monkeypatch, train):
    import paddle_tpu_torch as paddle

    rec = _Record(monkeypatch)
    jm, pm = _pair()
    for m in (jm, pm):
        m.train() if train else m.eval()
    x = np.random.RandomState(5).randn(4, 8, 16).astype(np.float32)
    jy = jm(jpaddle.to_tensor(x)).numpy()
    py = pm(paddle.to_tensor(x)).numpy()
    assert py.shape == (4, 8, 16)
    np.testing.assert_allclose(py, jy, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(pm.moe.aux_loss.item()),
                               float(jm.moe.aux_loss.item()), rtol=RTOL)
    assert float(pm.moe.aux_loss.item()) > 0.0
    rec.check()
    assert tuple(paddle.get_rng_state()) == tuple(jgen.get_rng_state())


@pytest.mark.parametrize("gate", ["gshard", "switch"])
def test_twelve_eager_steps_match_the_jax_loop(monkeypatch, gate):
    """The reference's eager loop (AdamW 5e-3, MSE + 0.01 aux, 12 steps):
    losses at rtol 1e-4, the routing of every step identical, the loss
    falling by 10% as the reference test asks."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn, optimizer

    rec = _Record(monkeypatch)
    jm, pm = _pair(gate, seed=1)
    rng = np.random.RandomState(0)
    X = rng.randn(16, 4, 16).astype(np.float32)
    Y = np.tanh(X)
    jo = jopt.AdamW(learning_rate=5e-3, parameters=jm.parameters())
    po = optimizer.AdamW(learning_rate=5e-3, parameters=pm.parameters())
    jl, pl = [], []
    for _ in range(12):
        loss = jnn.MSELoss()(jm(jpaddle.to_tensor(X)), jpaddle.to_tensor(Y)) \
            + 0.01 * jm.moe.aux_loss
        loss.backward()
        jo.step()
        jo.clear_grad()
        jl.append(float(loss.item()))
        loss = nn.MSELoss()(pm(paddle.to_tensor(X)), paddle.to_tensor(Y)) \
            + 0.01 * pm.moe.aux_loss
        loss.backward()
        po.step()
        po.clear_grad()
        pl.append(float(loss.item()))
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    assert pl[-1] < pl[0] * 0.9 and np.isfinite(pl).all()
    assert pm.moe.stacked_params[0].grad is None
    rec.check()


def test_capacity_drops_the_same_tokens(monkeypatch):
    """``capacity_factor`` 0.1: C = ceil(64 / 8 x 0.1) = 1 slot an expert
    for 128 choices; the same tokens dropped, the same finite output."""
    import paddle_tpu_torch as paddle

    rec = _Record(monkeypatch)
    jm, pm = _pair(seed=4)
    jm.moe.capacity_factor = pm.moe.capacity_factor = 0.1
    x = np.random.RandomState(6).randn(8, 8, 16).astype(np.float32)
    jy = jm(jpaddle.to_tensor(x)).numpy()
    py = pm(paddle.to_tensor(x)).numpy()
    assert np.isfinite(py).all()
    np.testing.assert_allclose(py, jy, rtol=RTOL, atol=ATOL)
    rec.check()
    kept = rec.port[0].any(-1).sum()
    assert 0 < kept <= 8


def test_switch_jitter_changes_routing_across_steps():
    """The reference's jitter test (SwitchGate eps 2.0): train-mode
    outputs differ between seeds 1 and 2, eval-mode ones are equal; each
    output equals the JAX layer's."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.incubate.moe import MoELayer, SwitchGate
    from paddle_tpu_torch.models.convert import moe_state_from_jax

    jpaddle.seed(0)
    jl = jmoe.MoELayer(8, [jnn.Linear(8, 8) for _ in range(4)],
                       gate=jmoe.SwitchGate(8, 4, switch_eps=2.0))
    x = jpaddle.randn([32, 8])
    paddle.set_device("cpu")
    pl = MoELayer(8, [nn.Linear(8, 8) for _ in range(4)],
                  gate=SwitchGate(8, 4, switch_eps=2.0))
    pl.set_state_dict(moe_state_from_jax(
        {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}))
    px = paddle.to_tensor(x.numpy())
    got = {}
    for name, layer, seed_fn, inp in (("jax", jl, jpaddle.seed, x),
                                      ("port", pl, paddle.seed, px)):
        layer.train()
        seed_fn(1)
        a = layer(inp).numpy()
        seed_fn(2)
        b = layer(inp).numpy()
        layer.eval()
        got[name] = (a, b, layer(inp).numpy(), layer(inp).numpy())
    a, b, e1, e2 = got["port"]
    assert not np.allclose(a, b), "jitter should perturb routing"
    np.testing.assert_array_equal(e1, e2)
    for p, j in zip(got["port"], got["jax"]):
        np.testing.assert_allclose(p, j, rtol=RTOL, atol=ATOL)


def test_gshard_random_routing_drops_weak_second_expert():
    """The reference's random-routing case: the same uniforms (key 0),
    the same dispatch; ~every token uses two experts without the rule,
    about 2 g2 of them with it."""
    import torch

    from paddle_tpu_torch.incubate.moe.moe_layer import _top2_dispatch
    from paddle_tpu_torch.ops import threefry

    t, e = 512, 8
    logits = np.random.RandomState(0).randn(t, e).astype(np.float32) * 0.01
    rand = jax.random.uniform(jax.random.PRNGKey(0), (t,))
    _, d_ref, aux_ref = jmoe._top2_dispatch(jnp.asarray(logits), capacity=t,
                                            rand=rand)
    prand = threefry.uniform(threefry.key(0), (t,))
    np.testing.assert_array_equal(prand.numpy(), np.asarray(rand))
    lt = torch.from_numpy(logits)
    d_norand = _top2_dispatch(lt, t).dense(e)[1]
    r = _top2_dispatch(lt, t, rand=prand)
    np.testing.assert_array_equal(r.dense(e)[1].numpy(), np.asarray(d_ref))
    np.testing.assert_allclose(float(r.aux), float(aux_ref), rtol=1e-6)
    used = float(r.dense(e)[1].sum())
    assert float(d_norand.sum()) > 1.9 * t
    assert 1.0 * t < used < 1.5 * t


def test_gshard_capacity_train_vs_eval():
    """Total skew (every token on expert 0): ``capacity`` tokens survive,
    10 in train (1.2) and 20 in eval (2.4), as in the JAX package; and
    the layer takes those factors from the gate by mode."""
    import torch

    from paddle_tpu_torch.incubate.moe import GShardGate
    from paddle_tpu_torch.incubate.moe.moe_layer import _top1_dispatch

    t, e = 32, 4
    logits = np.tile(np.array([[10.0, 0.0, 0.0, 0.0]], np.float32), (t, 1))
    for cap in (int(np.ceil(t / e * 1.2)), int(np.ceil(t / e * 2.4))):
        _, d_ref, _ = jmoe._top1_dispatch(jnp.asarray(logits), capacity=cap)
        d = _top1_dispatch(torch.from_numpy(logits), cap).dense(e)[1]
        assert int(d.sum()) == int(jnp.sum(d_ref)) == cap
        np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))
    assert GShardGate(8, 4).capacity == (1.2, 2.4)


def test_moe_grad_clip_matches_global_norm():
    """One process: ``ClipGradForMOEByGlobalNorm`` equals the plain
    global-norm clip and the JAX one; the clipped norm is clip_norm."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu.incubate.moe.grad_clip import (
        ClipGradForMOEByGlobalNorm as JClip)
    from paddle_tpu_torch.incubate.moe import ClipGradForMOEByGlobalNorm
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm

    rng = np.random.RandomState(0)
    ps = [rng.randn(4, 4).astype(np.float32) for _ in range(3)]
    gs = [rng.randn(4, 4).astype(np.float32) * 10 for _ in range(3)]
    jparams = [jpaddle.to_tensor(p) for p in ps]
    jparams[1].is_expert = True
    want = JClip(1.0, is_expert_param_func=lambda p: getattr(
        p, "is_expert", False))(list(zip(jparams,
                                         [jpaddle.to_tensor(g) for g in gs])))
    paddle.set_device("cpu")
    params = [paddle.to_tensor(p) for p in ps]
    params[1].is_expert = True
    a = ClipGradForMOEByGlobalNorm(1.0, is_expert_param_func=lambda p: getattr(
        p, "is_expert", False))(list(zip(params,
                                         [paddle.to_tensor(g) for g in gs])))
    # the port's plain clip takes the torch gradients the optimizer holds
    b = ClipGradByGlobalNorm(1.0)(list(zip(
        params, [torch.from_numpy(g.copy()) for g in gs])))
    for (_, ga), (_, gb), (_, gj) in zip(a, b, want):
        np.testing.assert_allclose(ga.numpy(), gb.numpy(), rtol=1e-6)
        np.testing.assert_allclose(ga.numpy(), gj.numpy(), rtol=1e-6)
    tot = sum(float((g.numpy() ** 2).sum()) for _, g in a)
    np.testing.assert_allclose(np.sqrt(tot), 1.0, rtol=1e-5)


def test_moe_grad_clip_sums_the_experts_over_ep():
    """At ep 2 (two gloo processes), each rank holding half the experts'
    gradient: the experts' squared norm is all-reduced over the moe group
    and the normal one counted once, so each rank's clipped gradients are
    its slices of the JAX package's global-view clip."""
    from paddle_tpu.incubate.moe.grad_clip import (
        ClipGradForMOEByGlobalNorm as JClip)
    from paddle_tpu_torch.testing import gloo_ranks, moe_ranks

    rng = np.random.RandomState(1)
    gs = [rng.randn(4, 6).astype(np.float32) * 5 for _ in range(3)]
    expert = [False, True, False]
    params = [jpaddle.to_tensor(np.zeros(1, np.float32)) for _ in gs]
    for p, e in zip(params, expert):
        p.is_expert = e
    want = JClip(1.0, is_expert_param_func=lambda p: p.is_expert)(
        list(zip(params, [jpaddle.to_tensor(g) for g in gs])))
    got = gloo_ranks.run(moe_ranks.clip_pair, 2, gs, expert, 1.0)
    full_sq = sum(float((g.astype(np.float64) ** 2).sum())
                  for g, e in zip(gs, expert) if e)
    for r in range(2):
        np.testing.assert_allclose(got[r]["expert_sq"], full_sq, rtol=1e-5)
        for (_, gj), g, e in zip(want, got[r]["grads"], expert):
            w = np.asarray(gj.numpy())
            w = np.split(w, 2)[r] if e else w
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)


def test_moe_expert_balance_statistics():
    """Near-uniform logits: top-1 fractions within 0.02 of 1/E and aux
    about 1, the JAX package's numbers."""
    import torch

    from paddle_tpu_torch.incubate.moe.moe_layer import _top1_dispatch

    t, e = 4096, 8
    logits = np.random.RandomState(0).randn(t, e).astype(np.float32) * 0.01
    _, d_ref, aux_ref = jmoe._top1_dispatch(jnp.asarray(logits), capacity=t)
    r = _top1_dispatch(torch.from_numpy(logits), t)
    d = r.dense(e)[1].numpy()
    np.testing.assert_array_equal(d, np.asarray(d_ref))
    frac = d.any(-1).sum(0).astype(np.float64)
    frac = frac / frac.sum()
    assert np.all(np.abs(frac - 1.0 / e) < 0.02), frac
    np.testing.assert_allclose(float(r.aux), float(aux_ref), rtol=1e-6)
    np.testing.assert_allclose(float(r.aux), 1.0, atol=0.05)


def test_convert_cuts_the_expert_leaves_to_an_ep_rank():
    """``moe_state_from_jax`` carries the JAX layer's state whole, or with
    each ``expert_leaf_<i>`` cut to an ep rank's E/ep experts (the slice
    ``shard_model_parameters`` leaves there); the gate and the other
    layers whole."""
    from paddle_tpu_torch.models.convert import moe_state_from_jax

    case = dict(seed=0, spec=dict(gate="gshard"))
    _jax_model(case)
    state = case["state"]
    whole = moe_state_from_jax(state)
    assert set(whole) == set(state)
    for r in range(4):
        cut = moe_state_from_jax(state, ep_rank=r, ep_size=4)
        for name, arr in state.items():
            want = arr[2 * r:2 * r + 2] if ".expert_leaf_" in name else arr
            np.testing.assert_array_equal(cut[name].numpy(), want)
    with pytest.raises(ValueError, match="do not split"):
        moe_state_from_jax(state, ep_rank=0, ep_size=3)
