"""The port's on-device sampler and its threefry generator against the
JAX package's.

``filtered_probs`` takes the same logits and knobs (numpy, from a seed)
through both packages. Greedy rows must be an exact one-hot at the
first-occurrence argmax. The port's threefry (``ops/threefry.py``) must
give ``jax.random``'s bits: split keys, random bits and uniforms are
bit-identical, Gumbel noise agrees to an ulp of ``log``, and categorical
draws, ``sample_tokens`` and ``sample_or_verify`` give the same tokens,
emit counts and advanced keys."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import sampling as jsampling
from paddle_tpu_torch.ops import sampling as tsampling
from paddle_tpu_torch.ops import threefry

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


# ---------------------------------------------------------------------------
# threefry against jax.random (64 keys drawn from numpy seed 0)
# ---------------------------------------------------------------------------
def _keys(n=64, seed=0):
    keys = np.random.default_rng(seed).integers(0, 2 ** 32, size=(n, 2),
                                                dtype=np.uint32)
    return keys, torch.from_numpy(keys.astype(np.int64))


def test_threefry_split_is_bit_identical():
    keys, tk = _keys()
    want = np.asarray(jax.vmap(lambda k: jax.random.split(k, 3))(
        jnp.asarray(keys)))
    got = threefry.split(tk, 3).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("shape", [(), (7,), (3, 128256)])
def test_threefry_random_bits_are_bit_identical(shape):
    keys, tk = _keys(8 if shape == (3, 128256) else 64)
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, shape))(
        jnp.asarray(keys)))
    got = threefry.random_bits(tk, shape).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("minval,maxval", [(0.0, 1.0), (-2.0, 3.5)])
def test_threefry_uniform_is_bit_identical(minval, maxval):
    keys, tk = _keys()
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (33,), minval=minval, maxval=maxval))(jnp.asarray(keys)))
    got = threefry.uniform(tk, (33,), minval, maxval).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  want.view(np.uint32))


def test_threefry_gumbel_matches():
    """Same uniforms; ``torch.log`` and XLA's ``log`` may differ by an
    ulp, so the noise is held to rtol 1e-6 (and atol 1e-6 where it
    crosses zero, at ``-log(u)`` near 1)."""
    keys, tk = _keys()
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (500,)))(
        jnp.asarray(keys)))
    got = threefry.gumbel(tk, (500,)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_threefry_categorical_tokens_are_identical():
    keys, tk = _keys()
    logits = (2.0 * np.random.default_rng(1).standard_normal(
        (64, 300))).astype(np.float32)
    logits[::5, 40:] = -np.inf                  # truncated support
    want = np.asarray(jax.vmap(jax.random.categorical)(
        jnp.asarray(keys), jnp.asarray(logits)))
    got = threefry.categorical(tk, torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[::5] < 40).all()


# ---------------------------------------------------------------------------
# the samplers against the JAX package's, token for token
# ---------------------------------------------------------------------------
# S = 6 slots, R = 4 gathered rows, V = 256: greedy, sampled, top-k and
# top-p rows mixed
_TEMP = np.array([0.0, 0.8, 1.0, 0.0, 1.2, 0.5], np.float32)
_TOPK = np.array([0, 0, 50, 0, 5, 0], np.int32)
_TOPP = np.array([1.0, 0.9, 1.0, 1.0, 0.8, 1.0], np.float32)


def _verify_inputs(seed, n_draft):
    """Logits (6, 4, 256) from ``seed``; drafts that copy the row's
    argmax with probability 0.6 (so rows both accept and reject)."""
    rng = np.random.default_rng(seed)
    s, r, v = 6, 4, 256
    logits = (2.0 * rng.standard_normal((s, r, v))).astype(np.float32)
    am = logits.argmax(-1)
    draft = rng.integers(0, v, (s, r - 1)).astype(np.int32)
    for i in range(s):
        for j in range(r - 1):
            if rng.random() < 0.6:
                draft[i, j] = am[i, min(max(r - 1 - n_draft[i] + j, 0),
                                        r - 1)]
    keys = rng.integers(0, 2 ** 32, (s, 2), dtype=np.uint32)
    return logits, draft, keys


def _both_verify(logits, draft, n_draft, keys):
    j = jsampling.sample_or_verify(
        jnp.asarray(logits), jnp.asarray(draft), jnp.asarray(n_draft),
        jnp.asarray(keys), jnp.asarray(_TEMP), jnp.asarray(_TOPK),
        jnp.asarray(_TOPP))
    t = tsampling.sample_or_verify(
        torch.from_numpy(logits), torch.from_numpy(draft),
        torch.from_numpy(n_draft), torch.from_numpy(keys.astype(np.int64)),
        torch.from_numpy(_TEMP), torch.from_numpy(_TOPK),
        torch.from_numpy(_TOPP))
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("n_draft", [0, 1, 2, 3, "mixed"])
def test_sample_or_verify_is_identical_to_jax(seed, n_draft):
    """Tokens, emit counts and advanced keys equal the JAX package's
    exactly (numpy seeds 0-5; n_draft 0..3 on every row, or mixed)."""
    nd = (np.array([0, 1, 2, 3, 3, 1], np.int32) if n_draft == "mixed"
          else np.full((6,), n_draft, np.int32))
    logits, draft, keys = _verify_inputs(seed, nd)
    (jt, jn, jk), (tt, tn, tk) = _both_verify(logits, draft, nd, keys)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tk, jk.astype(np.int64))
    for i in range(6):  # tokens past n_emit are unspecified padding
        np.testing.assert_array_equal(tt[i, :tn[i]], jt[i, :jn[i]])
    assert (tn >= 1).all() and (tn <= nd + 1).all()


@pytest.mark.parametrize("seed", range(4))
def test_sample_tokens_is_identical_to_jax(seed):
    rng = np.random.default_rng(100 + seed)
    logits = (2.0 * rng.standard_normal((6, 256))).astype(np.float32)
    keys = rng.integers(0, 2 ** 32, (6, 2), dtype=np.uint32)
    jt, jk = jsampling.sample_tokens(
        jnp.asarray(logits), jnp.asarray(keys), jnp.asarray(_TEMP),
        jnp.asarray(_TOPK), jnp.asarray(_TOPP))
    tt, tk = tsampling.sample_tokens(
        torch.from_numpy(logits), torch.from_numpy(keys.astype(np.int64)),
        torch.from_numpy(_TEMP), torch.from_numpy(_TOPK),
        torch.from_numpy(_TOPP))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tk.numpy(),
                                  np.asarray(jk).astype(np.int64))


def test_key_advance_is_two_r_minus_one_splits():
    """Every call advances a key by exactly 2*(R-1) + 1 chain splits,
    whatever its data or n_draft."""
    logits, draft, keys = _verify_inputs(9, np.full((6,), 3, np.int32))
    tk = torch.from_numpy(keys.astype(np.int64))
    want = tk
    for _ in range(2 * 3 + 1):
        want = threefry.split(want, 2)[:, 0]
    for nd in (np.zeros(6, np.int32), np.array([3, 2, 1, 0, 3, 3],
                                               np.int32)):
        _, _, got = tsampling.sample_or_verify(
            torch.from_numpy(logits), torch.from_numpy(draft),
            torch.from_numpy(nd), tk, torch.from_numpy(_TEMP),
            torch.from_numpy(_TOPK), torch.from_numpy(_TOPP))
        assert torch.equal(got, want)


def test_top_p_on_tied_rows_keeps_what_jax_keeps():
    """S = 64 uniform rows (V = 50 zero logits), temperature 1, top-p
    0.5: the 25th sorted probability's cumulative sum is 0.49999997 in
    XLA's order and 0.5 in a plain left-to-right one, so the cut keeps
    26 tokens in the JAX package. Tokens, keys and ``filtered_probs``
    are identical to the JAX package's."""
    s, v = 64, 50
    logits = np.zeros((s, v), np.float32)
    keys = np.random.default_rng(1).integers(0, 2 ** 32, (s, 2))
    temp = np.ones((s,), np.float32)
    top_k = np.zeros((s,), np.int32)
    top_p = np.full((s,), 0.5, np.float32)
    jt, jk = jsampling.sample_tokens(
        jnp.asarray(logits), jnp.asarray(keys.astype(np.uint32)),
        jnp.asarray(temp), jnp.asarray(top_k), jnp.asarray(top_p))
    tt, tk = tsampling.sample_tokens(
        *(torch.from_numpy(x) for x in (logits, keys.astype(np.int64), temp,
                                        top_k, top_p)))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tk.numpy(),
                                  np.asarray(jk).astype(np.int64))
    pj = np.asarray(jsampling.filtered_probs(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_k),
        jnp.asarray(top_p)))
    pt = tsampling.filtered_probs(
        *(torch.from_numpy(x) for x in (logits, temp, top_k, top_p)))
    np.testing.assert_array_equal(pt.numpy(), pj)
    assert ((pj > 0).sum(axis=-1) == 26).all()


@pytest.mark.parametrize("v", [50, 256, 4096, 128256])
def test_cumsum_and_sum_are_bit_identical_to_jnp(v):
    """The sampler's cumsum and sums add in XLA:CPU's order:
    bit-identical to ``jnp.cumsum`` and ``jnp.sum`` (under ``jit``, as
    the JAX sampler runs) on uniform rows, random rows and sorted
    Dirichlet rows (what the top-p cut sums)."""
    rng = np.random.default_rng(v)
    x = np.stack([np.full((v,), 1.0 / v, np.float32),
                  rng.random(v).astype(np.float32),
                  np.sort(rng.dirichlet(np.ones(v)))[::-1].astype(
                      np.float32)])
    want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1))
    got = tsampling.xla_cumsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=-1))(x))
    got = tsampling.xla_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
