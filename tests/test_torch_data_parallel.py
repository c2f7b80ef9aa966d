"""The port's eager ``DataParallel`` and the fleet gradient utilities on
two gloo ranks: the reference's ``tests/mp_scripts/eager_dp_worker.py``
checks (each rank trains a DataParallel MLP on its half of the batch,
rank 1 starting desynchronised; the averaged losses equal a serial run
on the whole batch, here the JAX package's; ``no_sync`` accumulation),
then ``broadcast_dp_parameters`` and ``fused_allreduce_gradients``
through the hybrid communicate group."""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import nn, optimizer
from paddle_tpu_torch.testing import gloo_ranks, hybrid_ranks


def _serial(X, Y):
    paddle.seed(7)
    m = nn.Sequential(nn.Linear(8, 32), nn.ReLU(), nn.Linear(32, 1))
    state = {k: np.asarray(v.numpy()).copy()
             for k, v in m.state_dict().items()}
    opt = optimizer.SGD(learning_rate=0.1, parameters=m.parameters())
    loss_fn = nn.MSELoss()
    losses = []
    for _ in range(4):
        loss = loss_fn(m(paddle.to_tensor(X)), paddle.to_tensor(Y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.item()))
    return state, losses, {n: p.numpy() for n, p in m.named_parameters()}


@pytest.fixture(scope="module")
def runs():
    rng = np.random.RandomState(0)
    X = rng.randn(16, 8).astype(np.float32)
    Y = rng.randn(16, 1).astype(np.float32)
    state, losses, params = _serial(X, Y)
    got = gloo_ranks.run(hybrid_ranks.data_parallel, 2, state, X, Y,
                         timeout_s=120)
    return losses, params, got


def test_dp_losses_match_the_serial_run(runs):
    losses, params, got = runs
    for r in got:
        np.testing.assert_allclose(r["dp_losses"], losses, rtol=1e-4,
                                   atol=1e-5)
        for n, want in params.items():
            np.testing.assert_allclose(r["params"][n], want, rtol=1e-4,
                                       atol=1e-6, err_msg=n)


def test_no_sync_accumulates_then_reduces(runs):
    """Two local backwards (one under ``no_sync``), then the synced one
    reduces the accumulated gradients: their mean over the ranks is the
    sum of the ranks' single gradients."""
    _, _, got = runs
    for r in got:
        np.testing.assert_allclose(r["g_synced"], r["g_local_sum"],
                                   rtol=2e-4, atol=2e-5)


def test_broadcast_and_fused_allreduce_through_the_hcg(runs):
    _, _, got = runs
    for n in got[0]["broadcast"]:
        np.testing.assert_array_equal(got[1]["broadcast"][n],
                                      got[0]["broadcast"][n])
    for n in got[0]["local_grads"]:
        mean = (got[0]["local_grads"][n] + got[1]["local_grads"][n]) / 2
        for r in got:
            np.testing.assert_allclose(r["fused_grads"][n], mean,
                                       rtol=1e-6, atol=1e-7, err_msg=n)
