"""The port's on-device sampler against the JAX package's.

``filtered_probs`` takes the same logits and knobs (numpy, from a seed)
through both packages. Greedy rows must be an exact one-hot at the
first-occurrence argmax. The port's counter-based generator is not
threefry, so sampled draws are held to the distribution, not to JAX's
bits."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import sampling as jsampling
from paddle_tpu_torch.ops import sampling as tsampling

# f32 softmax/sort/cumsum on both sides: a few ulps of values <= 1
ATOL = 1e-6


def _knobs():
    temp = np.array([0.0, 0.7, 1.0, 1.3, 0.9, 0.0, 2.0, 0.5], np.float32)
    top_k = np.array([0, 0, 5, 0, 3, 7, 50, 1], np.int32)
    top_p = np.array([1.0, 0.9, 1.0, 0.5, 0.8, 1.0, 0.95, 1.0], np.float32)
    return temp, top_k, top_p


def test_filtered_probs_matches_jax():
    rng = np.random.default_rng(0)
    logits = (3.0 * rng.standard_normal((8, 97))).astype(np.float32)
    temp, top_k, top_p = _knobs()
    pj = np.asarray(jsampling.filtered_probs(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_k),
        jnp.asarray(top_p)))
    pt = tsampling.filtered_probs(
        torch.from_numpy(logits), torch.from_numpy(temp),
        torch.from_numpy(top_k), torch.from_numpy(top_p)).numpy()
    np.testing.assert_allclose(pt, pj, rtol=1e-5, atol=ATOL)
    # same support: the filters kept the same tokens
    np.testing.assert_array_equal(pt > 0, pj > 0)


def test_greedy_rows_are_exact_one_hot_at_first_argmax():
    logits = torch.tensor([[0.5, 2.0, 2.0, -1.0],
                           [3.0, 3.0, 3.0, 3.0],
                           [-5.0, -4.0, -6.0, -4.0]])
    zeros = torch.zeros(3)
    p = tsampling.filtered_probs(logits, zeros, torch.zeros(3, dtype=torch.int32),
                                 torch.ones(3))
    want = torch.zeros(3, 4)
    want[0, 1] = want[1, 0] = want[2, 1] = 1.0
    assert torch.equal(p, want)
    keys = torch.tensor([[1, 2], [3, 4], [5, 6]])
    tok, _ = tsampling.sample_tokens(logits, keys, zeros,
                                     torch.zeros(3, dtype=torch.int32),
                                     torch.ones(3))
    assert tok.tolist() == [int(np.argmax(r)) for r in logits.numpy()]


def test_key_advance_is_fixed_and_data_independent():
    keys = torch.tensor([[0, 0], [0, 1], [1, 0], [0xFFFFFFFF, 0xFFFFFFFF]])
    a = torch.randn(4, 11)
    b = torch.randn(4, 11)
    t1 = torch.tensor([0.0, 0.5, 1.0, 2.0])
    t2 = torch.tensor([1.0, 0.0, 0.3, 0.0])
    k = torch.zeros(4, dtype=torch.int32)
    p = torch.ones(4)
    _, ka = tsampling.sample_tokens(a, keys, t1, k, p)
    _, kb = tsampling.sample_tokens(b, keys, t2, k, p)
    assert torch.equal(ka, kb)
    assert ka.min() >= 0 and ka.max() <= 0xFFFFFFFF
    # distinct keys stay distinct (the advance map is a bijection)
    assert len({tuple(r) for r in ka.tolist()}) == 4
    assert not torch.equal(ka, keys)


@pytest.mark.parametrize("temp,top_k,top_p", [(1.0, 0, 1.0), (0.8, 3, 1.0),
                                              (1.2, 0, 0.7)])
def test_sampled_draws_follow_filtered_probs(temp, top_k, top_p):
    """4096 slots with distinct seeds, one logit row: the empirical token
    frequencies match filtered_probs within 5 standard errors."""
    n, v = 4096, 6
    rng = np.random.default_rng(7)
    row = torch.from_numpy(rng.standard_normal(v).astype(np.float32))
    logits = row.expand(n, v).contiguous()
    keys = torch.from_numpy(
        rng.integers(0, 2 ** 32, size=(n, 2), dtype=np.int64))
    tv = torch.full((n,), temp)
    kv = torch.full((n,), top_k, dtype=torch.int32)
    pv = torch.full((n,), top_p)
    tok, _ = tsampling.sample_tokens(logits, keys, tv, kv, pv)
    p = tsampling.filtered_probs(logits[:1], tv[:1], kv[:1], pv[:1])[0]
    freq = torch.bincount(tok.long(), minlength=v).double() / n
    se = (p.double() * (1 - p.double()) / n).sqrt()
    assert torch.all((freq - p.double()).abs() <= 5 * se + 1e-12)
    assert torch.all(freq[p == 0] == 0)
