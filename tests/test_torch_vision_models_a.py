"""The port's model zoo against the JAX package's, part a: LeNet (also in
eval mode), AlexNet, VGG-11, VGG-16 with batch norm and DenseNet-121.
Each family's train-mode forward at ``tests/test_vision_models.py``'s
input size, from the JAX network's weights and buffers with the
generator state handed over (dropout draws alike): logits, the running
statistics after it and the generator state, at rtol 1e-5 / atol 1e-5
of the reference's largest magnitude in f32, running statistics at 5e-4
(``_vision_models.assert_state``). ``pretrained=True`` raises in both
packages."""
import pytest

import paddle_tpu_torch as tpaddle
from paddle_tpu.vision import models as JM
from paddle_tpu_torch.core import place as _place
from paddle_tpu_torch.vision import models as TM

from _vision_models import Runs, assert_forward, assert_state

FAMILIES = ["lenet", "alexnet", "vgg11", "vgg16_bn", "densenet121"]


@pytest.fixture(autouse=True, scope="module")
def _cpu_place():
    saved = (_place._current_place, _place._current_device)
    tpaddle.set_device("cpu")
    yield
    _place._current_place, _place._current_device = saved


@pytest.fixture(scope="module")
def runs():
    return Runs(eval_families=("lenet",))


@pytest.mark.parametrize("name", FAMILIES)
def test_train_forward(runs, name):
    assert_forward(runs[name])
    assert_state(runs[name])


def test_lenet_eval_forward(runs):
    assert_forward(runs["lenet"], "eval")


@pytest.mark.parametrize("ctor,kw", [
    ("alexnet", {}), ("vgg11", {}), ("vgg16", dict(batch_norm=True)),
    ("vgg19", {}), ("densenet121", {}), ("densenet264", {}),
])
def test_pretrained_raises(ctor, kw):
    for M in (JM, TM):
        with pytest.raises(NotImplementedError, match="zero-egress"):
            getattr(M, ctor)(pretrained=True, **kw)
