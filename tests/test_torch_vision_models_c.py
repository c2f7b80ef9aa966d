"""The port's model zoo against the JAX package's, part c: MobileNet v1,
v2, v3 Small and Large and SqueezeNet 1.0 and 1.1. Each family's
train-mode forward at ``tests/test_vision_models.py``'s input size from
the JAX network's weights and buffers, the generator state handed over
(dropout draws alike): outputs at rtol 1e-5 / atol 1e-5 of the
reference's largest magnitude, running statistics at 5e-4
(``_vision_models.assert_state``) and the generator state, f32.
``pretrained=True`` raises in both packages."""
import pytest

import paddle_tpu_torch as tpaddle
from paddle_tpu.vision import models as JM
from paddle_tpu_torch.core import place as _place
from paddle_tpu_torch.vision import models as TM

from _vision_models import Runs, assert_forward, assert_state


@pytest.fixture(autouse=True, scope="module")
def _cpu_place():
    saved = (_place._current_place, _place._current_device)
    tpaddle.set_device("cpu")
    yield
    _place._current_place, _place._current_device = saved


FAMILIES = ["mobilenet_v1", "mobilenet_v2", "mobilenet_v3_small",
            "mobilenet_v3_large", "squeezenet1_0", "squeezenet1_1"]


@pytest.fixture(scope="module")
def runs():
    return Runs()


@pytest.mark.parametrize("name", FAMILIES)
def test_train_forward(runs, name):
    assert_forward(runs[name])
    assert_state(runs[name])


@pytest.mark.parametrize("ctor", FAMILIES)
def test_pretrained_raises(ctor):
    for M in (JM, TM):
        with pytest.raises(NotImplementedError, match="zero-egress"):
            getattr(M, ctor)(pretrained=True)
