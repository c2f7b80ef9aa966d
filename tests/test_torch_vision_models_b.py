"""The port's model zoo against the JAX package's, part b: the ResNet
family.

ResNet-18's train-mode and eval-mode forwards and ResNet-50's (v1.5
bottleneck) eval-mode one at rtol 1e-5, atol 1e-5 of the largest logit,
f32. ResNet-50's train-mode forward at atol 2e-4 of the largest logit:
its batch norms normalise over 8 x 1 x 1 elements a channel in layer4,
and the JAX package's own f32 logits lie 1.6e-4 of the largest from a
float64 run of the same network (the test measures the port's against
that run too).

Three ``Model.fit`` batches of ResNet-18 at 8 x 3 x 64 x 64 with
Momentum and weight decay, then ``evaluate`` and ``predict``: the
losses, every parameter and every batch norm's running mean and
variance against the reference's ``Model.fit``, which also shows that
evaluation reads the statistics training left. A float64 run of the
port's ``Model.fit`` is the arbiter: at 32 x 32 (layer4's batch norms
over 8 elements a channel) the JAX package's own f32 step 2 moves
parameters 6.9e-4 away from it while the port's stays within 4e-7, so
the fit runs at 64 x 64. There the three runs' per-batch losses agree
within rtol 1e-5 (measured 1.7e-6 at most); after three steps both f32
runs hold parameters and running statistics within 1.4e-4 of the
float64 run and of each other (f32 rounding that the batch norms carry
through the steps: the JAX run is as far from the float64 run as the
port's), held at rtol 1e-3 / atol the larger of 3e-4 and 2e-3 of the
tensor's largest magnitude (measured at most 9.4e-4 of it, a running
variance); ``evaluate``'s loss within rtol 1e-3 (measured 5.4e-4) and
``predict``'s logits within 3e-3 of the largest (measured 2.2e-3).

Under AMP "O1": a train-mode forward leaves the running statistics in
f32 and within bf16's rtol 2e-2 / atol 1e-2 of the reference's, and an
eval-mode bf16 forward's logits lie within rtol 2e-2 / atol 2e-2 of the
largest logit. The constructors ignore ``pretrained``, as the
reference's do. ``summary`` and ``flops`` give the reference's counts
on ResNet-18, ResNet-50 and two families with grouped convolutions."""
import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu.io  # noqa: F401
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.io  # noqa: F401
from paddle_tpu.vision import models as JM
from paddle_tpu_torch.core import place as _place
from paddle_tpu_torch.vision import models as TM

from _vision_models import (Runs, assert_forward, assert_state, build_pair,
                            no_draws, np_state)

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _cpu_place():
    saved = (_place._current_place, _place._current_device)
    tpaddle.set_device("cpu")
    yield
    _place._current_place, _place._current_device = saved


@pytest.fixture(scope="module")
def runs():
    return Runs(eval_families=("resnet18", "resnet50"))


def test_resnet18_train_forward(runs):
    assert_forward(runs["resnet18"])
    assert_state(runs["resnet18"])


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_eval_forward(runs, name):
    assert_forward(runs[name], "eval")


def test_resnet50_train_forward_within_f32_rounding(runs):
    run = runs["resnet50"]
    (j,), (t,) = run["train"]
    j_state, _ = run["state"]
    with no_draws():
        t64 = TM.resnet50(num_classes=10)
    t64.to(dtype="float64")
    # the weights as they were before the forward (buffers at 0 / 1)
    init = {k: np.asarray(v.numpy(), np.float64)
            for k, v in build_pair("resnet50")[0].state_dict().items()}
    t64.set_state_dict(init)
    t64.train()
    x = np.random.RandomState(0).randn(8, 3, 32, 32)
    exact = np.asarray(t64(tpaddle.to_tensor(x, dtype="float64")).numpy())
    scale = float(np.abs(exact).max())
    for got in (j, t):
        np.testing.assert_allclose(got, exact, rtol=0, atol=2e-4 * scale)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=2e-4 * scale)
    assert run["rng_after"][0] == run["rng_after"][1]
    assert set(j_state) == set(run["state"][1])


def _dataset(P, x, y):
    class DS(P.io.Dataset):
        def __len__(self):
            return len(x)

        def __getitem__(self, i):
            return x[i], y[i]

    return DS()


def _fit(P, net, x, y):
    class Grab(P.hapi.Callback):
        def __init__(self):
            super().__init__()
            self.train = []

        def on_train_batch_end(self, step, logs=None):
            self.train.append(dict(logs))

    model = P.Model(net)
    opt = P.optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                               weight_decay=1e-4,
                               parameters=net.parameters())
    model.prepare(opt, P.nn.CrossEntropyLoss(),
                  P.metric.Accuracy(topk=(1, 5)))
    grab = Grab()
    np.random.seed(0)
    model.fit(_dataset(P, x, y), batch_size=8, epochs=1, shuffle=True,
              verbose=0, log_freq=1, callbacks=[grab])
    state = np_state(net)
    ev = model.evaluate(_dataset(P, x, y), batch_size=8, verbose=0)
    pred = model.predict(_dataset(P, x, y), batch_size=8,
                         stack_outputs=True)[0]
    return {"train": grab.train, "state": state, "eval": ev, "pred": pred,
            "state_after_eval": np_state(net),
            "rng": tuple(P.get_rng_state())}


@pytest.fixture(scope="module")
def fits():
    rng = np.random.RandomState(1)
    x = rng.randn(24, 3, 64, 64).astype(np.float32)
    y = rng.randint(0, 10, 24).astype(np.int64)
    jm, tm = build_pair("resnet18", seed=1)
    with no_draws():
        t64 = TM.resnet18(num_classes=10)
    t64.to(dtype="float64")
    t64.set_state_dict({k: v.astype(np.float64)
                        for k, v in np_state(tm).items()})
    return (_fit(jpaddle, jm, x, y), _fit(tpaddle, tm, x, y),
            _fit(tpaddle, t64, x.astype(np.float64), y))


def _pairs(fits):
    j, t, exact = fits
    return (("port", t, j), ("jax_vs_f64", j, exact),
            ("port_vs_f64", t, exact))


def test_resnet18_model_fit_matches_the_reference(fits):
    j, t, _ = fits
    assert len(t["train"]) == 3
    buffers = [k for k in j["state"] if k.endswith(("_mean", "_variance"))]
    assert len(buffers) == 2 * 20          # 20 batch norms in ResNet-18
    assert t["rng"] == j["rng"]
    for tag, got, want in _pairs(fits):
        for lw, lg in zip(want["train"], got["train"]):
            assert set(lw) == set(lg) == {"loss", "acc_top1", "acc_top5"}
            for k in lw:
                np.testing.assert_allclose(lg[k], lw[k], err_msg=tag + k,
                                           **LOSS_TOL)
        assert set(got["state"]) == set(want["state"])
        for k, w in want["state"].items():
            atol = max(3e-4, 2e-3 * float(np.abs(w).max()))
            np.testing.assert_allclose(got["state"][k], w, rtol=1e-3,
                                       atol=atol, err_msg=f"{tag} {k}")


def test_resnet18_evaluate_reads_the_trained_statistics(fits):
    for tag, got, want in _pairs(fits):
        assert set(got["eval"]) == set(want["eval"]) == {
            "loss", "acc_top1", "acc_top5"}
        for k in want["eval"]:
            np.testing.assert_allclose(got["eval"][k], want["eval"][k],
                                       err_msg=tag + k, rtol=1e-3, atol=0)
        scale = float(np.abs(want["pred"]).max())
        np.testing.assert_allclose(got["pred"], want["pred"], rtol=1e-3,
                                   atol=3e-3 * scale, err_msg=tag)
    # eval mode leaves the running statistics as training left them
    t = fits[1]
    for k, v in t["state"].items():
        np.testing.assert_array_equal(t["state_after_eval"][k], v)


def test_resnet18_amp_o1_forward():
    jm, tm = build_pair("resnet18", seed=2)
    x = np.random.RandomState(2).randn(8, 3, 32, 32).astype(np.float32)
    logits = []
    for P, m in ((jpaddle, jm), (tpaddle, tm)):
        for mode in ("train", "eval"):
            getattr(m, mode)()
            with P.amp.auto_cast(level="O1"):
                out = m(P.to_tensor(x))
            assert "bfloat16" in str(out.dtype)
        logits.append(np.asarray(out.astype("float32").numpy()))
    np.testing.assert_allclose(logits[1], logits[0], rtol=2e-2,
                               atol=2e-2 * float(np.abs(logits[0]).max()))
    for name, b in tm.named_buffers():
        assert str(b._data.dtype) == "torch.float32", name
    j, t = np_state(jm), np_state(tm)
    for k in j:
        if k.endswith(("_mean", "_variance")):
            np.testing.assert_allclose(t[k], j[k], rtol=2e-2, atol=1e-2,
                                       err_msg=k)


def test_resnet_constructors_ignore_pretrained():
    for M in (JM, TM):
        for ctor in ("resnet18", "resnet34"):
            net = getattr(M, ctor)(pretrained=True, num_classes=4)
            assert net.fc.weight.shape[-1] in (4, 512)


def test_resnet50_parameter_count():
    net = TM.resnet50(num_classes=1000)
    n = sum(int(np.prod(p.shape)) for p in net.parameters())
    assert n == 25_557_032            # torchvision's count for v1.5
    assert len([k for k in net.state_dict() if k.endswith("_mean")]) == 53


@pytest.mark.parametrize("ctor,kw,size", [
    ("resnet18", dict(num_classes=10), (1, 3, 32, 32)),
    ("resnet50", dict(num_classes=1000), (1, 3, 32, 32)),
    ("shufflenet_v2_x0_25", dict(num_classes=10), (1, 3, 32, 32)),
    ("mobilenet_v2", dict(num_classes=10, scale=0.25), (1, 3, 32, 32)),
])
def test_summary_and_flops_counts(ctor, kw, size):
    jpaddle.seed(0)
    jn = getattr(JM, ctor)(**kw)
    with no_draws():
        tn = getattr(TM, ctor)(**kw)
    js = jpaddle.summary(jn, input_size=size)
    ts = tpaddle.summary(tn, input_size=size)
    assert ts == js
    assert ts["flops"] > 0 and ts["total_params"] > 0
    assert tpaddle.flops(tn, input_size=size) == ts["flops"]
