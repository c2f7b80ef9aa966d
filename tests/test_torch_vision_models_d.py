"""The port's model zoo against the JAX package's, part d: ShuffleNetV2
(x0.25 and the swish variant, and its channel shuffle), GoogLeNet (its
two auxiliary heads in train mode, one tensor in eval mode) and
Inception-v3 at its smallest input, 96 x 96. Each family's train-mode
forward at ``tests/test_vision_models.py``'s input size from the JAX
network's weights and buffers, the generator state handed over (dropout
draws alike): outputs at rtol 1e-5 / atol 1e-5 of the reference's
largest magnitude, running statistics at 5e-4
(``_vision_models.assert_state``) and the generator state, f32.
``pretrained=True`` raises in both packages."""
import numpy as np
import pytest

import paddle_tpu as jpaddle
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


FAMILIES = ["shufflenet_v2_x0_25", "shufflenet_v2_swish", "googlenet",
            "inception_v3"]


@pytest.fixture(scope="module")
def runs():
    return Runs(eval_families=("googlenet",))


@pytest.mark.parametrize("name", FAMILIES)
def test_train_forward(runs, name):
    assert_forward(runs[name])
    assert_state(runs[name])


def test_googlenet_heads(runs):
    j, t = runs["googlenet"]["train"]
    assert len(j) == len(t) == 3          # (main, aux1, aux2)
    je, te = runs["googlenet"]["eval"]
    assert len(je) == len(te) == 1        # one tensor in eval mode
    assert_forward(runs["googlenet"], "eval")


@pytest.mark.parametrize("ctor", [
    "shufflenet_v2_x0_25", "shufflenet_v2_x0_33", "shufflenet_v2_x0_5",
    "shufflenet_v2_x1_0", "shufflenet_v2_x1_5", "shufflenet_v2_x2_0",
    "shufflenet_v2_swish", "googlenet", "inception_v3",
])
def test_pretrained_raises(ctor):
    for M in (JM, TM):
        with pytest.raises(NotImplementedError, match="zero-egress"):
            getattr(M, ctor)(pretrained=True)


def test_channel_shuffle():
    from paddle_tpu.vision.models.shufflenetv2 import channel_shuffle as jcs
    from paddle_tpu_torch.vision.models.shufflenetv2 import (
        channel_shuffle as tcs)

    x = np.arange(2 * 6 * 2 * 2, dtype=np.float32).reshape(2, 6, 2, 2)
    j = jcs(jpaddle.to_tensor(x), 2).numpy()
    t = tcs(tpaddle.to_tensor(x), 2).numpy()
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t[0, :, 0, 0], [0, 12, 4, 16, 8, 20])
