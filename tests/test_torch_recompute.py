"""The port's ``recompute`` and ``recompute_sequential``
(``distributed/fleet/recompute.py``) against the reference's, on one
rank: the same gradients as the JAX package's recompute and as a plain
backward, and a dropout inside the recomputed region draws in the
recompute the mask its forward drew: from the global generator eagerly,
and from the step's device key stream inside a ``TrainStep``."""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import nn as jnn
from paddle_tpu.distributed.fleet.recompute import (
    recompute as jrecompute, recompute_sequential as jrecompute_sequential)
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.distributed.fleet.recompute import (
    recompute, recompute_sequential)

tpaddle.set_device("cpu")


def _block(nn, p):
    return nn.Sequential(nn.Linear(8, 16), nn.GELU(), nn.Dropout(p),
                         nn.Linear(16, 8))


def _grads(paddle, nn, rc, mode, p, x, seed=5):
    """(output, input grad, parameter grads) of one forward/backward of
    two blocks under ``mode`` ("plain", "recompute", "sequential")."""
    paddle.seed(seed)
    blocks = [_block(nn, p), _block(nn, p)]
    xt = paddle.to_tensor(x)
    xt.stop_gradient = False
    if mode == "plain":
        out = blocks[1](blocks[0](xt))
    elif mode == "recompute":
        out = rc[0](blocks[1], rc[0](blocks[0], xt))
    else:
        out = rc[1]({"segments": 2}, blocks, xt)
    (out * out).sum().backward()
    grads = [q.grad.numpy() for b in blocks for q in b.parameters()]
    return out.numpy(), xt.grad.numpy(), grads


X = np.random.RandomState(0).randn(4, 8).astype(np.float32)


@pytest.mark.parametrize("mode", ["recompute", "sequential"])
@pytest.mark.parametrize("p", [0.0, 0.5])
def test_gradients_match_the_reference_and_a_plain_backward(mode, p):
    jrc = (jrecompute, jrecompute_sequential)
    trc = (recompute, recompute_sequential)
    jo, jx, jg = _grads(jpaddle, jnn, jrc, mode, p, X)
    to, tx, tg = _grads(tpaddle, tnn, trc, mode, p, X)
    po, px, pg = _grads(tpaddle, tnn, trc, "plain", p, X)
    # f32 summation order: rtol 1e-4 (the gradients reach ~40)
    np.testing.assert_allclose(to, jo, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tx, jx, rtol=1e-4, atol=1e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    # the recompute replays the forward's dropout mask: bit for bit the
    # plain backward's gradients
    np.testing.assert_array_equal(to, po)
    np.testing.assert_array_equal(tx, px)
    for a, b in zip(tg, pg):
        np.testing.assert_array_equal(a, b)


def test_recompute_inside_a_trainstep_replays_the_device_key_stream():
    """Inside ``TrainStep`` the dropout draws from the step's device key
    stream; three recomputed steps give the plain steps' losses and
    parameters bit for bit."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.jit import TrainStep

    class Net(tnn.Layer):
        def __init__(self, rc):
            super().__init__()
            self.a, self.b = _block(tnn, 0.5), _block(tnn, 0.5)
            self.rc = rc

        def forward(self, x):
            if self.rc:
                return recompute(self.b, recompute(self.a, x))
            return self.b(self.a(x))

    def run(rc):
        tpaddle.seed(11)
        m = Net(rc)
        step = TrainStep(m, tnn.MSELoss(), optimizer.SGD(
            learning_rate=0.1, parameters=m.parameters()))
        y = np.ones((4, 8), np.float32)
        losses = [float(step(torch.from_numpy(X), torch.from_numpy(y)))
                  for _ in range(3)]
        return losses, [q.numpy() for q in m.parameters()]

    (l1, p1), (l2, p2) = run(False), run(True)
    assert l1 == l2
    for a, b in zip(p1, p2):
        np.testing.assert_array_equal(a, b)
