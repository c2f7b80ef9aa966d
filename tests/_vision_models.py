"""Shared body of ``tests/test_torch_vision_models_{a,b,c,d}.py``: each
family of the model zoo built in both packages with the JAX package's
weights and buffers in the port's network (``vision_state_from_jax``)
and its generator state handed over, then one train-mode forward (and
for some an eval-mode one) on the input size ``tests/test_vision_models.py``
gives it. The JAX side runs eagerly, which is slow on the CPU, so each
family is built and run once per module (:class:`Runs`)."""
import contextlib

import numpy as np

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.vision import models as JM
from paddle_tpu_torch.models.convert import vision_state_from_jax
from paddle_tpu_torch.vision import models as TM

TOL = dict(rtol=1e-5, atol=1e-5)


def assert_close(got, want, err_msg=""):
    """rtol 1e-5, atol 1e-5 of the reference's largest magnitude (at
    least 1e-5): train-mode batch norms over a few elements carry f32
    rounding from layer to layer in proportion to the activations'
    scale."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=TOL["rtol"],
                               atol=TOL["atol"] * scale, err_msg=err_msg)


# name: (constructor, kwargs, input shape); tests/test_vision_models.py's
FAMILIES = {
    "lenet": ("LeNet", dict(num_classes=10), (1, 1, 28, 28)),
    "alexnet": ("alexnet", dict(num_classes=10), (1, 3, 64, 64)),
    "vgg11": ("vgg11", dict(num_classes=10), (1, 3, 32, 32)),
    "vgg16_bn": ("vgg16", dict(batch_norm=True, num_classes=10),
                 (1, 3, 32, 32)),
    "densenet121": ("densenet121", dict(num_classes=10), (1, 3, 32, 32)),
    # batch 8: a train-mode batch norm of layer4 (1 x 1 at 32 x 32) over
    # 2 elements a channel would turn f32 rounding into 1e-3 of a logit
    "resnet18": ("resnet18", dict(num_classes=10), (8, 3, 32, 32)),
    "resnet50": ("resnet50", dict(num_classes=10), (8, 3, 32, 32)),
    "mobilenet_v1": ("mobilenet_v1", dict(num_classes=10, scale=0.25),
                     (1, 3, 32, 32)),
    "mobilenet_v2": ("mobilenet_v2", dict(num_classes=10, scale=0.25),
                     (1, 3, 32, 32)),
    "mobilenet_v3_small": ("mobilenet_v3_small",
                           dict(num_classes=10, scale=0.5), (1, 3, 32, 32)),
    "mobilenet_v3_large": ("mobilenet_v3_large",
                           dict(num_classes=10, scale=0.5), (1, 3, 32, 32)),
    "squeezenet1_0": ("squeezenet1_0", dict(num_classes=10), (1, 3, 64, 64)),
    "squeezenet1_1": ("squeezenet1_1", dict(num_classes=10), (1, 3, 64, 64)),
    "shufflenet_v2_x0_25": ("shufflenet_v2_x0_25", dict(num_classes=10),
                            (1, 3, 32, 32)),
    "shufflenet_v2_swish": ("shufflenet_v2_swish", dict(num_classes=10),
                            (1, 3, 32, 32)),
    "googlenet": ("googlenet", dict(num_classes=10), (1, 3, 64, 64)),
    "inception_v3": ("inception_v3", dict(num_classes=10), (1, 3, 96, 96)),
}


def np_state(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


@contextlib.contextmanager
def no_draws():
    """Port layers built with zero-filled parameters (their values come
    from the JAX network next): the port's initializers draw on the CPU
    far more slowly than a test can wait for at VGG's 100M weights."""
    from paddle_tpu_torch.nn import initializer
    from paddle_tpu_torch.nn.layer import Layer

    orig = Layer.create_parameter

    def zeros(self, shape, dtype=None, default_initializer=None, attr=None,
              is_bias=False):
        return orig(self, shape, dtype,
                    default_initializer=initializer.Constant(0.0),
                    attr=attr, is_bias=is_bias)

    Layer.create_parameter = zeros
    try:
        yield
    finally:
        Layer.create_parameter = orig


def build_pair(name, seed=0):
    """The family's JAX network from ``seed`` and the port's holding its
    state, both generators at the same state."""
    ctor, kw, _ = FAMILIES[name]
    jpaddle.seed(seed)
    jm = getattr(JM, ctor)(**kw)
    with no_draws():
        tm = getattr(TM, ctor)(**kw)
    _, rng = vision_state_from_jax(np_state(jm), jpaddle.get_rng_state(), tm)
    tpaddle.set_rng_state(rng)
    return jm, tm


def _outs(o):
    o = o if isinstance(o, tuple) else (o,)
    return [np.asarray(t.numpy()) for t in o]


def forwards(name, eval_too=False):
    """One train-mode forward in each package (dropout draws alike), the
    networks' states after it (batch norms' running statistics), then an
    eval-mode forward when ``eval_too``."""
    jm, tm = build_pair(name)
    shape = FAMILIES[name][2]
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    res = {"rng": (tuple(jpaddle.get_rng_state()),
                   tuple(tpaddle.get_rng_state()))}
    jm.train()
    tm.train()
    res["train"] = (_outs(jm(jpaddle.to_tensor(x))),
                    _outs(tm(tpaddle.to_tensor(x))))
    res["rng_after"] = (tuple(jpaddle.get_rng_state()),
                        tuple(tpaddle.get_rng_state()))
    res["state"] = (np_state(jm), np_state(tm))
    if eval_too:
        jm.eval()
        tm.eval()
        res["eval"] = (_outs(jm(jpaddle.to_tensor(x))),
                       _outs(tm(tpaddle.to_tensor(x))))
    return res


class Runs(dict):
    """``forwards`` of each family once per module, on first use."""

    def __init__(self, eval_families=()):
        super().__init__()
        self.eval_families = set(eval_families)

    def __missing__(self, name):
        self[name] = forwards(name, eval_too=name in self.eval_families)
        return self[name]


def assert_forward(run, mode="train", n_classes=10):
    j, t = run[mode]
    assert len(j) == len(t)
    for a, b in zip(j, t):
        assert b.shape == a.shape and b.shape[-1] == n_classes
        assert_close(b, a)


def assert_state(run):
    """Parameters as loaded; running statistics after the forward at rtol
    5e-4 / atol 5e-4 of the largest: a batch variance over the few
    elements of a 1 x 1 or 2 x 2 map of one image carries the f32
    rounding of every layer below it (2.3e-4 at most, ShuffleNetV2 with
    swish)."""
    j, t = run["state"]
    assert set(j) == set(t)
    for k in j:
        if k.endswith(("_mean", "_variance")):
            scale = max(1.0, float(np.abs(j[k]).max()))
            np.testing.assert_allclose(t[k], j[k], rtol=5e-4,
                                       atol=5e-4 * scale, err_msg=k)
        else:
            assert_close(t[k], j[k], err_msg=k)
    assert run["rng_after"][0] == run["rng_after"][1]
