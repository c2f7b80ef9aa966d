"""The port's random draws against the JAX package's under one seed.

* Bit-identical over a mixed sequence of calls (each takes exactly one
  key, so any drift would shift every later draw): ``rand``, ``uniform``,
  ``randint``, ``randperm``, ``shuffle``, ``bernoulli``, ``dropout`` (and
  ``nn.Dropout``), the ``XavierUniform``, ``KaimingUniform`` and
  ``Uniform`` initializers, ``uniform_`` and ``randint_like``.
* The same distribution for the draws through a transcendental, each by a
  named statistic: Kolmogorov-Smirnov (``scipy.stats.kstest``) at
  p > 1e-3 against the distribution and, two-sample, against the
  reference's draws of the same seed; for the discrete ones a chi-square
  test of the counts; and the draws themselves near the reference's
  (they share its uniforms).
* Keys spent where the reference spends them: none for a ``p == 0`` or
  an eval dropout, none for ``Constant``.
* The refusals lifted with the generator: attention dropout and the
  naive ``generate`` with ``temperature > 0`` against the reference.
* The double grad through ``dropout`` (the port saves the mask; the
  reference replays the generator): the same second derivative.
"""
import numpy as np
import pytest
import torch
from scipy import stats

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.nn import initializer as jinit
from paddle_tpu.ops.registry import API as JAPI
from paddle_tpu_torch.core import place as port_place
from paddle_tpu_torch.nn import initializer as tinit
from paddle_tpu_torch.ops.registry import API as TAPI

KS_P = 1e-3


@pytest.fixture(autouse=True)
def _cpu_place():
    prev = (port_place._current_place, port_place._current_device)
    tpaddle.set_device("cpu")
    yield
    port_place._current_place, port_place._current_device = prev


def _np(t):
    return np.asarray(t.numpy()) if hasattr(t, "numpy") else np.asarray(t)


def _mixed_sequence(P, API, init, x_np, p_np):
    """Draws that come straight from threefry bits, in one sequence."""
    x = P.to_tensor(x_np)
    p = P.to_tensor(p_np)
    out = [API["rand"]([3, 5]),
           API["uniform"]([4, 2], min=-0.7, max=3.0),
           API["randint"](-3, 50, [6]),
           API["bernoulli"](p),
           API["dropout"](x, 0.4),
           API["dropout"](x, 0.0),                 # no key
           API["dropout"](x, 0.4, training=False),   # no key
           API["randperm"](17),
           API["shuffle"](x),
           API["rand"]([2, 3], dtype="bfloat16"),
           init.XavierUniform()([8, 6]),
           init.Constant(0.5)([3]),                  # no key
           init.KaimingUniform(nonlinearity="leaky_relu",
                               negative_slope=0.1)([5, 4, 3]),
           init.Uniform(-0.2, 0.9)([7]),
           P.uniform_(P.to_tensor(np.zeros((3, 3), np.float32)), -2.0,
                      2.0),
           P.randint_like(x, 0, 9),
           API["dropout"](x, 0.25, axis=1,
                          mode="downscale_in_infer")]
    return [_np(o).astype(np.float64) for o in out]


@pytest.mark.parametrize("seed", [0, 7, 2 ** 32 + 11])
def test_mixed_sequence_is_bit_identical(seed):
    rng = np.random.default_rng(seed % 1000)
    x = rng.standard_normal((6, 5)).astype(np.float32)
    p = rng.uniform(0, 1, (4, 4)).astype(np.float32)
    jpaddle.seed(seed)
    ref = _mixed_sequence(jpaddle, JAPI, jinit, x, p)
    tpaddle.seed(seed)
    got = _mixed_sequence(tpaddle, TAPI, tinit, x, p)
    for i, (a, b) in enumerate(zip(ref, got)):
        assert a.shape == b.shape, i
        assert np.array_equal(a, b), (i, a, b)
    assert tpaddle.get_rng_state() == jpaddle.get_rng_state() == (seed, 14)


def test_layer_dropouts_draw_the_reference_masks():
    """``nn.Dropout`` in training (one key a call), in eval and at p = 0
    (none), ``Dropout2D`` and ``AlphaDropout``: equal outputs, equal
    counters."""
    x = np.random.default_rng(1).standard_normal((2, 3, 4, 4)).astype(
        np.float32)
    res = {}
    for name, P in (("ref", jpaddle), ("port", tpaddle)):
        P.seed(21)
        t = P.to_tensor(x)
        d = P.nn.Dropout(0.3)
        outs = [d(t)]
        d.eval()
        outs.append(d(t))
        outs.append(P.nn.Dropout(0.0)(t))
        outs.append(P.nn.Dropout2D(0.5)(t))
        outs.append(P.nn.AlphaDropout(0.2)(t))
        outs.append(P.nn.Dropout(0.5, mode="downscale_in_infer")(t))
        res[name] = ([_np(o) for o in outs], P.get_rng_state())
    assert res["port"][1] == res["ref"][1] == (21, 4)
    for a, b in zip(res["ref"][0], res["port"][0]):
        np.testing.assert_array_equal(b, a)


def _draws(P, API, seed, n):
    P.seed(seed)
    x = P.to_tensor(np.full((n,), 3.5, np.float32))
    return {
        "randn": _np(API["randn"]([n])),
        "normal": _np(API["normal"](1.5, 2.0, [n])),
        "standard_normal": _np(API["standard_normal"]([n])),
        "exponential": _np(API["exponential"](
            P.to_tensor(np.ones((n,), np.float32)), lam=2.0)),
        "poisson": _np(API["poisson"](x)),
        "poisson_large": _np(API["poisson"](P.to_tensor(
            np.full((n,), 40.0, np.float32)))),
        "truncated": _np(P.nn.initializer.TruncatedNormal(0.0, 1.0)([n])),
        "normal_": _np(P.normal_(P.to_tensor(np.zeros((n,), np.float32)),
                                 0.5, 3.0)),
        "cauchy_": _np(P.cauchy_(P.to_tensor(np.zeros((n,), np.float32)))),
        "exponential_": _np(P.exponential_(
            P.to_tensor(np.zeros((n,), np.float32)), 0.5)),
        "geometric_": _np(P.geometric_(
            P.to_tensor(np.zeros((n,), np.float32)), 0.3)),
        "xavier_normal": _np(P.nn.initializer.XavierNormal()([n, 1])),
        "kaiming_normal": _np(P.nn.initializer.KaimingNormal()([n, 4])),
    }


_CONTINUOUS = {
    "randn": stats.norm(), "normal": stats.norm(1.5, 2.0),
    "standard_normal": stats.norm(),
    "exponential": stats.expon(scale=0.5),
    "truncated": stats.truncnorm(-2.0, 2.0),
    "normal_": stats.norm(0.5, 3.0), "cauchy_": stats.cauchy(),
    "exponential_": stats.expon(scale=2.0),
}


@pytest.fixture(scope="module")
def draws():
    prev = (port_place._current_place, port_place._current_device)
    tpaddle.set_device("cpu")
    n = 20000
    try:
        yield _draws(jpaddle, JAPI, 3, n), _draws(tpaddle, TAPI, 3, n)
    finally:
        port_place._current_place, port_place._current_device = prev


@pytest.mark.parametrize("name", sorted(_CONTINUOUS))
def test_continuous_draws_match_in_distribution(draws, name):
    ref, got = draws[0][name], draws[1][name]
    assert stats.kstest(got, _CONTINUOUS[name].cdf).pvalue > KS_P
    assert stats.ks_2samp(got, ref).pvalue > KS_P
    # the same uniforms through the reference's formula: near its values
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,dist", [
    ("poisson", stats.poisson(3.5)), ("poisson_large", stats.poisson(40.0)),
    ("geometric_", stats.geom(0.3))])
def test_discrete_draws_match_in_distribution(draws, name, dist):
    """Chi-square of the counts of each value against the distribution's
    pmf (the tail lumped), p > 1e-3; and equal to the reference's draws
    but for the rare accept test that goes the other way."""
    ref, got = draws[0][name], draws[1][name]
    lo, hi = int(dist.ppf(0.001)), int(dist.ppf(0.999))
    edges = np.arange(lo, hi + 2) - 0.5
    counts, _ = np.histogram(np.clip(got, lo, hi), edges)
    probs = np.diff(dist.cdf(edges))
    probs[0] += dist.cdf(lo - 1)
    probs[-1] += dist.sf(hi)
    expected = probs / probs.sum() * len(got)
    assert stats.chisquare(counts, expected).pvalue > KS_P
    assert np.mean(got == ref) > 0.999


def test_normal_initializers_match_in_distribution(draws):
    for name, std in (("xavier_normal", np.sqrt(2.0 / 20001)),
                      ("kaiming_normal", np.sqrt(2.0) / np.sqrt(20000))):
        got, ref = draws[1][name].ravel(), draws[0][name].ravel()
        assert stats.kstest(got, stats.norm(0, std).cdf).pvalue > KS_P
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * std)


def test_sampling_ops_match_in_distribution():
    """``multinomial`` with and without replacement and ``gumbel_softmax``
    (Gumbel noise, ``-log(-log(u))`` of the reference's uniforms): the
    reference's draws; with replacement, the frequencies of 4000 draws
    fit the probabilities (chi-square, p > 1e-3)."""
    probs = np.array([0.1, 0.2, 0.05, 0.4, 0.25], np.float32)
    logits = np.random.default_rng(2).standard_normal((6, 5)).astype(
        np.float32)
    res = {}
    for name, P, API in (("ref", jpaddle, JAPI), ("port", tpaddle, TAPI)):
        P.seed(8)
        res[name] = [
            _np(API["multinomial"](P.to_tensor(probs), 4000,
                                   replacement=True)),
            _np(API["multinomial"](P.to_tensor(probs), 3)),
            _np(API["gumbel_softmax"](P.to_tensor(logits), 0.7)),
            _np(API["gumbel_softmax"](P.to_tensor(logits), hard=True))]
    ref, got = res["ref"], res["port"]
    counts = np.bincount(got[0], minlength=5)
    assert stats.chisquare(counts, probs / probs.sum() * 4000).pvalue > KS_P
    assert np.mean(got[0] == ref[0]) > 0.999
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[3], ref[3])


# ---------------------------------------------------------------------------
# the refusals lifted with the generator
# ---------------------------------------------------------------------------
def test_attention_dropout_matches_the_reference_under_one_seed():
    """``scaled_dot_product_attention(dropout_p=0.3)`` and
    ``nn.functional.flash_attention(dropout=0.3)`` (which takes plain
    attention with dropout in both packages), causal, f32: the same
    dropped entries and outputs within rtol 1e-5, the same keys spent."""
    from paddle_tpu.nn import functional as JF
    from paddle_tpu_torch.nn import functional as TF

    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 12, 3, 8)).astype(np.float32)
               for _ in range(3))
    res = {}
    for name, P, F in (("ref", jpaddle, JF), ("port", tpaddle, TF)):
        P.seed(13)
        ts = [P.to_tensor(a) for a in (q, k, v)]
        a = F.scaled_dot_product_attention(*ts, dropout_p=0.3,
                                           is_causal=True)
        b, _ = F.flash_attention(*ts, dropout=0.3, causal=True)
        c, _ = F.flash_attention(*ts, dropout=0.3, causal=True,
                                 training=False)
        res[name] = ([_np(a), _np(b), _np(c)], P.get_rng_state())
    assert res["port"][1] == res["ref"][1] == (13, 2)
    for x, y in zip(res["ref"][0], res["port"][0]):
        np.testing.assert_allclose(y, x, rtol=1e-5, atol=1e-6)
    assert not np.allclose(res["port"][0][0], res["port"][0][1])


def test_naive_generate_samples_the_reference_tokens():
    """``generate(use_cache=False, temperature=0.8)`` on the tiny Llama
    from the reference's weights, f32: one key a token from the global
    generator, ``jax.random.categorical`` over the batch's last logits
    divided by the temperature: the same tokens."""
    from paddle_tpu.models.llama import LlamaConfig as JConfig
    from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
    from paddle_tpu_torch.models.convert import llama_state_from_jax
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    jpaddle.seed(0)
    jm = JLlama(JConfig.tiny())
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    tm.load_state_dict(llama_state_from_jax(state))
    prompt = np.array([[1, 2, 3, 4], [9, 8, 7, 6]], np.int64)
    jpaddle.seed(4)
    want = _np(jm.generate(jpaddle.to_tensor(prompt), max_new_tokens=6,
                           temperature=0.8, use_cache=False))
    tpaddle.seed(4)
    got = tm.generate(torch.from_numpy(prompt), max_new_tokens=6,
                      temperature=0.8, use_cache=False).numpy()
    np.testing.assert_array_equal(got, want)
    assert tpaddle.get_rng_state() == jpaddle.get_rng_state() == (4, 6)


# ---------------------------------------------------------------------------
# double grad through dropout
# ---------------------------------------------------------------------------
def test_double_grad_through_dropout_matches_the_reference():
    """``paddle.grad(create_graph=True)`` through ``dropout(x * x)`` and a
    second ``paddle.grad`` of the first gradient's square sum: the
    reference re-derives with the generator replayed, the port keeps the
    mask its forward drew; both give the same first and second
    derivatives (the mask of the one forward), and no extra key."""
    x_np = np.random.default_rng(3).standard_normal((5, 7)).astype(
        np.float32)
    res = {}
    for name, P in (("ref", jpaddle), ("port", tpaddle)):
        P.seed(17)
        x = P.to_tensor(x_np, stop_gradient=False)
        y = P.nn.functional.dropout(x * x, 0.4)
        (g1,) = P.grad(y.sum(), [x], create_graph=True)
        (g2,) = P.grad((g1 * g1).sum(), [x])
        res[name] = (_np(y), _np(g1), _np(g2), P.get_rng_state())
    for a, b in zip(res["ref"][:3], res["port"][:3]):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
    assert res["port"][3] == res["ref"][3] == (17, 1)
