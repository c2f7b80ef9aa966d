"""Variable-length and paged attention of the Tensor API against the JAX
package (f32, rtol 1e-5, atol 1e-6): ``flash_attn_unpadded`` with and
without GQA, causal on and off; ``variable_length_memory_efficient_
attention`` with a causal offset and an additive mask; ``paged_attention``
with -1 table entries. Inputs are seeded numpy arrays carried in with
``to_tensor``."""
import numpy as np
import pytest

import paddle_tpu as P_ref
import paddle_tpu_torch as P_port
from paddle_tpu.incubate.nn import functional as ref_incubate
from paddle_tpu.nn import functional as ref_F
from paddle_tpu_torch.core import place as port_place
from paddle_tpu_torch.incubate.nn import functional as port_incubate
from paddle_tpu_torch.nn import functional as port_F

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _cpu_place():
    prev = (port_place._current_place, port_place._current_device)
    P_port.set_device("cpu")
    yield
    port_place._current_place, port_place._current_device = prev


def _f(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("kh", [4, 2, 1])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attn_unpadded_matches_reference(kh, causal):
    rng = np.random.default_rng(kh + 10 * causal)
    lengths = [5, 1, 9, 3]
    cu = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    total = int(cu[-1])
    q, k, v = _f(rng, total, 4, 16), _f(rng, total, kh, 16), \
        _f(rng, total, kh, 16)
    out_r, none_r = ref_F.flash_attn_unpadded(
        *(P_ref.to_tensor(a) for a in (q, k, v)), P_ref.to_tensor(cu),
        P_ref.to_tensor(cu), 9, 9, causal=causal)
    out_p, none_p = port_F.flash_attn_unpadded(
        *(P_port.to_tensor(a) for a in (q, k, v)), P_port.to_tensor(cu),
        P_port.to_tensor(cu), 9, 9, causal=causal)
    assert none_r is None and none_p is None
    assert out_p.shape == out_r.shape == [total, 4, 16]
    np.testing.assert_allclose(out_p.numpy(), out_r.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_flash_attn_unpadded_q_and_k_lengths_differ():
    rng = np.random.default_rng(3)
    cq = np.array([0, 2, 5], np.int32)
    ck = np.array([0, 4, 10], np.int32)
    q, k, v = _f(rng, 5, 2, 8), _f(rng, 10, 2, 8), _f(rng, 10, 2, 8)
    out_r, _ = ref_F.flash_attn_unpadded(
        *(P_ref.to_tensor(a) for a in (q, k, v)), cq, ck, 3, 6, scale=0.3)
    out_p, _ = port_F.flash_attn_unpadded(
        *(P_port.to_tensor(a) for a in (q, k, v)), cq, ck, 3, 6, scale=0.3)
    np.testing.assert_allclose(out_p.numpy(), out_r.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_variable_length_memory_efficient_attention_matches_reference():
    rng = np.random.default_rng(4)
    q, k, v = _f(rng, 2, 4, 6, 8), _f(rng, 2, 2, 7, 8), _f(rng, 2, 2, 7, 8)
    mask = _f(rng, 2, 1, 6, 7)
    ql, kl = np.array([6, 3], np.int32), np.array([7, 5], np.int32)
    for kw in (dict(causal=True, pre_cache_length=1), dict(mask=mask),
               dict(scale=0.2)):
        conv_r = {k_: P_ref.to_tensor(a) if isinstance(a, np.ndarray) else a
                  for k_, a in kw.items()}
        conv_p = {k_: P_port.to_tensor(a) if isinstance(a, np.ndarray)
                  else a for k_, a in kw.items()}
        out_r = ref_incubate.variable_length_memory_efficient_attention(
            *(P_ref.to_tensor(a) for a in (q, k, v, ql, kl)), **conv_r)
        out_p = port_incubate.variable_length_memory_efficient_attention(
            *(P_port.to_tensor(a) for a in (q, k, v, ql, kl)), **conv_p)
        assert isinstance(out_p, P_port.Tensor)
        np.testing.assert_allclose(out_p.numpy(), out_r.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=str(list(kw)))


def test_paged_attention_matches_reference():
    rng = np.random.default_rng(5)
    b, h, kh, d, nb, bs, mb = 3, 4, 2, 8, 10, 4, 3
    q = _f(rng, b, h, d)
    kc, vc = _f(rng, nb, bs, kh, d), _f(rng, nb, bs, kh, d)
    bt = np.array([[3, 7, -1], [0, -1, -1], [9, 2, 5]], np.int32)
    sl = np.array([6, 2, 11], np.int32)
    out_r = ref_incubate.paged_attention(
        *(P_ref.to_tensor(a) for a in (q, kc, vc, bt, sl)))
    out_p = port_incubate.paged_attention(
        *(P_port.to_tensor(a) for a in (q, kc, vc, bt, sl)))
    assert out_p.shape == [b, h, d]
    np.testing.assert_allclose(out_p.numpy(), out_r.numpy(), rtol=RTOL,
                               atol=ATOL)
