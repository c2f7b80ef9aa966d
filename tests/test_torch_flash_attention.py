"""The port's flash attention against the JAX package's.

The same numpy inputs from a seed go through the JAX flash attention
(its Pallas kernels in interpret mode, as ``tests/test_flash_attention.py``
runs them; the tests count calls of ``_flash_fwd``/``_flash_bwd`` to show
the JAX side really went through Pallas) and the port's CPU path (the
plain PyTorch versions that the CUDA kernels are held against on the
card). Tolerances are those of the JAX tests: forward rtol 2e-4 /
atol 2e-5, gradients rtol 2e-3 / atol 2e-4 (f32 on both sides; the
conftest sets XLA's matmul precision to highest). In bf16 the plain
versions' ``round_to`` forms, which round P and dS where the TPU kernels
do, are held against the Pallas kernels after rounding both outputs to
bf16 (rtol 1e-2: one bf16 step; atol 1e-4)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import pallas_attention
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.nn import functional as NF
from paddle_tpu_torch.ops import flash_attention as tfa

FWD = dict(rtol=2e-4, atol=2e-5)
BWD = dict(rtol=2e-3, atol=2e-4)


@pytest.fixture
def pallas_calls(monkeypatch):
    """Counts of the JAX package's Pallas forward/backward launches."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = jfa._flash_fwd, jfa._flash_bwd

    def counting_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def counting_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(jfa, "_flash_fwd", counting_fwd)
    monkeypatch.setattr(jfa, "_flash_bwd", counting_bwd)
    return calls


@pytest.fixture
def port_calls(monkeypatch):
    """Counts of the port's flash forward passes (kernel or plain)."""
    calls = {"fwd": 0}
    fwd = tfa._flash_fwd

    def counting_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    monkeypatch.setattr(tfa, "_flash_fwd", counting_fwd)
    return calls


def _inputs(b, sq, sk, h, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, h, d).astype(np.float32)
            for s in (sq, sk, sk, sq)]        # q, k, v, dO


def _to_bh(x):
    b, s, h, d = x.shape
    return jnp.transpose(jnp.asarray(x), (0, 2, 1, 3)).reshape(b * h, s, d)


def _bf16(x):
    """A torch tensor rounded to bf16, as f32 numpy."""
    return x.to(torch.bfloat16).float().numpy()


def _jax_grads(q, k, v, do, causal):
    def f(q, k, v):
        o = jfa.flash_attention_data(q, k, v, causal=causal, block_q=64,
                                     block_k=64, interpret=True)
        return jnp.sum(o * do)
    g = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(x) for x in g]


def _port_grads(q, k, v, do, causal):
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = tfa.flash_attention_data(*ts, causal=causal)
    o.backward(torch.from_numpy(do))
    return o.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 128, 2, 64), (1, 256, 4, 32)])
def test_forward_and_lse_match_pallas(causal, shape, pallas_calls):
    b, s, h, d = shape
    q, k, v, _ = _inputs(b, s, s, h, d, seed=0)
    scale = d ** -0.5
    o_j, lse_j = jfa._flash_fwd(_to_bh(q), _to_bh(k), _to_bh(v), scale,
                                causal, 64, 64, True)
    assert pallas_calls["fwd"] == 1
    o_t, lse_t = tfa._flash_fwd(*(torch.from_numpy(x) for x in (q, k, v)),
                                scale, causal)
    o_j = np.asarray(o_j).reshape(b, h, s, d).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(o_t.numpy(), o_j, **FWD)
    # the TPU kernel keeps lse as [BH, 8, S] (row 0 real); the port [BH, S]
    assert lse_t.shape == (b * h, s)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[:, 0], **FWD)


@pytest.mark.parametrize("causal", [False, True])
def test_backward_matches_pallas(causal, pallas_calls):
    q, k, v, do = _inputs(1, 128, 128, 2, 32, seed=1)
    g_j = _jax_grads(q, k, v, do, causal)
    assert pallas_calls == {"fwd": 1, "bwd": 1}
    _, g_t = _port_grads(q, k, v, do, causal)
    for gt, gj in zip(g_t, g_j):
        np.testing.assert_allclose(gt, gj, **BWD)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_forward_rounding_matches_pallas(causal, pallas_calls):
    """In bf16 the TPU kernel rounds P = exp(S - running max) to bf16
    before each P V product of its online softmax; the port's plain
    forward does the same over key blocks of ``KEY_BLOCK`` with
    ``round_to``, the version the card holds the bf16 K2 kernel against.
    Same bf16 inputs on both sides, the TPU kernel's key blocks set to
    ``KEY_BLOCK``; both outputs rounded to bf16, as the kernels store
    them: O agrees within rtol, and closer than the plain forward without
    the rounding; lse agrees as in f32."""
    b, s, h, d = 1, 2 * tfa.KEY_BLOCK, 2, 32
    scale = d ** -0.5
    xs = [jnp.asarray(x, jnp.bfloat16) for x in _inputs(b, s, s, h, d, 4)]
    o_j, lse_j = jfa._flash_fwd(*(_to_bh(x) for x in xs[:3]), scale, causal,
                                64, tfa.KEY_BLOCK, True)
    assert pallas_calls["fwd"] == 1
    q, k, v = (torch.from_numpy(np.array(x.astype(jnp.float32)))
               for x in xs[:3])
    want = np.array(o_j.astype(jnp.float32)).reshape(b, h, s, d).transpose(
        0, 2, 1, 3)
    o_r, lse_r = tfa._flash_fwd_ref(q, k, v, scale, causal,
                                    round_to=torch.bfloat16)
    o_p, _ = tfa._flash_fwd_ref(q, k, v, scale, causal)
    o_r, o_p = (_bf16(x) for x in (o_r, o_p))    # as the kernels store O
    np.testing.assert_allclose(o_r, want, rtol=1e-2, atol=1e-4)
    assert np.abs(o_r - want).max() < np.abs(o_p - want).max()
    np.testing.assert_allclose(lse_r.numpy(), np.asarray(lse_j)[:, 0], **FWD)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_dkv_rounding_matches_pallas(causal, pallas_calls):
    """In bf16 the TPU kernel rounds P and dS to bf16 before its dV and
    dK products; the port's plain backward does the same with
    ``round_to``, the version the card holds the bf16 K4 kernel against.
    Same bf16 inputs, O and lse on both sides; both outputs rounded to
    bf16, as the kernels store them: dK and dV agree within rtol, and
    closer than the plain backward that keeps P and dS in f32."""
    b, s, h, d = 1, 128, 2, 32
    scale = d ** -0.5
    xs = [jnp.asarray(x, jnp.bfloat16) for x in _inputs(b, s, s, h, d, 3)]
    o_j, lse_j = jfa._flash_fwd(*(_to_bh(x) for x in xs[:3]), scale, causal,
                                64, 64, True)
    _, dk_j, dv_j = jfa._flash_bwd(*(_to_bh(x) for x in xs[:3]), o_j, lse_j,
                                   _to_bh(xs[3]), scale, causal, 64, 64,
                                   True)
    assert pallas_calls == {"fwd": 1, "bwd": 1}

    def port(x):                      # [BH, S, D] or [B, S, H, D] -> f32
        x = torch.from_numpy(np.array(x.astype(jnp.float32)))
        return x if x.shape[0] == b else (
            x.reshape(b, h, s, d).transpose(1, 2).contiguous())

    q, k, v, do, o = (port(x) for x in xs + [o_j])
    lse = torch.from_numpy(np.asarray(lse_j)[:, 0])
    want = [port(x).numpy() for x in (dk_j, dv_j)]
    rounded = tfa._flash_bwd_ref(q, k, v, o, lse, do, scale, causal,
                                 round_to=torch.bfloat16)[1:]
    plain = tfa._flash_bwd_ref(q, k, v, o, lse, do, scale, causal)[1:]
    for r, p, w in zip(rounded, plain, want):
        r, p = _bf16(r), _bf16(p)                 # as the kernels store them
        np.testing.assert_allclose(r, w, rtol=1e-2, atol=1e-4)
        assert np.abs(r - w).max() < np.abs(p - w).max()


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_dq_rounding_matches_pallas(causal, pallas_calls):
    """In bf16 the TPU kernel ``_bwd_dq_kernel`` rounds dS to bf16 before
    its dS K product; the port's plain backward does the same with
    ``round_to``, the version the card holds the bf16 K3 kernel against.
    Same bf16 inputs, O and lse on both sides; both outputs rounded to
    bf16, as the kernels store them: dQ agrees within rtol, and closer
    than the plain backward that keeps dS in f32."""
    b, s, h, d = 1, 128, 2, 32
    scale = d ** -0.5
    xs = [jnp.asarray(x, jnp.bfloat16) for x in _inputs(b, s, s, h, d, 7)]
    o_j, lse_j = jfa._flash_fwd(*(_to_bh(x) for x in xs[:3]), scale, causal,
                                64, 64, True)
    dq_j, _, _ = jfa._flash_bwd(*(_to_bh(x) for x in xs[:3]), o_j, lse_j,
                                _to_bh(xs[3]), scale, causal, 64, 64, True)
    assert pallas_calls == {"fwd": 1, "bwd": 1}

    def port(x):                      # [BH, S, D] or [B, S, H, D] -> f32
        x = torch.from_numpy(np.array(x.astype(jnp.float32)))
        return x if x.shape[0] == b else (
            x.reshape(b, h, s, d).transpose(1, 2).contiguous())

    q, k, v, do, o = (port(x) for x in xs + [o_j])
    lse = torch.from_numpy(np.asarray(lse_j)[:, 0])
    want = port(dq_j).numpy()
    rounded = _bf16(tfa._flash_bwd_ref(q, k, v, o, lse, do, scale, causal,
                                       round_to=torch.bfloat16)[0])
    plain = _bf16(tfa._flash_bwd_ref(q, k, v, o, lse, do, scale, causal)[0])
    np.testing.assert_allclose(rounded, want, rtol=1e-2, atol=1e-4)
    assert np.abs(rounded - want).max() < np.abs(plain - want).max()


@pytest.mark.parametrize("sq,sk", [(64, 128), (128, 256), (64, 256)])
def test_causal_cross_length_bottom_right(sq, sk, pallas_calls):
    """Sq != Sk: the mask is bottom-right aligned in both packages."""
    q, k, v, do = _inputs(1, sq, sk, 2, 32, seed=2)
    o_j = jfa.flash_attention_data(*(jnp.asarray(x) for x in (q, k, v)),
                                   causal=True, block_q=64, block_k=64,
                                   interpret=True)
    g_j = _jax_grads(q, k, v, do, True)
    assert pallas_calls == {"fwd": 2, "bwd": 1}
    o_t, g_t = _port_grads(q, k, v, do, True)
    np.testing.assert_allclose(o_t, np.asarray(o_j), **FWD)
    for gt, gj in zip(g_t, g_j):
        np.testing.assert_allclose(gt, gj, **BWD)


def test_untileable_length_jax_sdpa_port_flash(pallas_calls, port_calls):
    """S = 100 does not tile into the TPU blocks: the JAX dispatcher goes
    to SDPA, the port's to its flash op; same numbers."""
    import paddle_tpu as paddle

    q, k, v, _ = _inputs(2, 100, 100, 2, 16, seed=3)
    out_j = pallas_attention.flash_attention(
        *(paddle.to_tensor(x) for x in (q, k, v)), causal=True)
    assert pallas_calls["fwd"] == 0
    out_t, none = NF.flash_attention(*(torch.from_numpy(x)
                                       for x in (q, k, v)), causal=True)
    assert none is None and port_calls["fwd"] == 1
    np.testing.assert_allclose(out_t.numpy(), out_j.numpy(), **FWD)


def test_tileable_length_both_take_flash(pallas_calls, port_calls):
    import paddle_tpu as paddle

    q, k, v, _ = _inputs(1, 64, 64, 2, 16, seed=4)
    out_j = pallas_attention.flash_attention(
        *(paddle.to_tensor(x) for x in (q, k, v)), causal=True)
    out_t, _ = NF.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                  causal=True)
    assert pallas_calls["fwd"] == 1 and port_calls["fwd"] == 1
    np.testing.assert_allclose(out_t.numpy(), out_j.numpy(), **FWD)


def test_rows_that_see_no_key_are_zero(pallas_calls):
    """Causal with Sq > Sk: rows 0 .. Sq-Sk-1 see no key. The port gives
    them O = 0, lse = -inf and zero gradients. (The TPU kernel gives such
    a row the mean of V -- a quirk of the reference, recorded in
    ROADMAP.md, not copied.)"""
    q, k, v, do = _inputs(1, 128, 64, 1, 16, seed=5)
    o_j, _ = jfa._flash_fwd(_to_bh(q), _to_bh(k), _to_bh(v), 0.25, True,
                            128, 64, True)
    np.testing.assert_allclose(np.asarray(o_j)[0, 0], v[0, :, 0].mean(0),
                               atol=1e-6)
    o_t, lse_t = tfa._flash_fwd(*(torch.from_numpy(x) for x in (q, k, v)),
                                0.25, True)
    blind = 128 - 64
    assert torch.all(o_t[:, :blind] == 0)
    assert torch.all(lse_t[:, :blind] == float("-inf"))
    assert torch.all(torch.isfinite(lse_t[:, blind:]))
    o2, (dq, dk, dv) = _port_grads(q, k, v, do, True)
    assert np.all(dq[:, :blind] == 0)
    assert np.all(np.isfinite(dk)) and np.all(np.isfinite(dv))
    # the rows that do see keys agree with plain masked softmax attention
    sdpa = NF.scaled_dot_product_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), is_causal=True)
    np.testing.assert_allclose(o2[:, blind:], sdpa.numpy()[:, blind:], **FWD)


def test_sdpa_matches_jax_emitter():
    """The plain attention behind attn_mask and dropout: bool mask and
    additive mask against the JAX SDPA emitter."""
    from paddle_tpu.ops.registry import API

    import paddle_tpu as paddle

    q, k, v, _ = _inputs(2, 12, 12, 2, 8, seed=6)
    rng = np.random.RandomState(7)
    masks = [rng.rand(2, 2, 12, 12) > 0.3,
             rng.randn(2, 2, 12, 12).astype(np.float32)]
    for mask in masks:
        out_j = API["scaled_dot_product_attention"](
            *(paddle.to_tensor(x) for x in (q, k, v)),
            attn_mask=paddle.to_tensor(mask))
        out_t = NF.scaled_dot_product_attention(
            *(torch.from_numpy(x) for x in (q, k, v)),
            attn_mask=torch.from_numpy(mask))
        np.testing.assert_allclose(out_t.numpy(), out_j.numpy(), **FWD)


def test_dropout_takes_plain_attention_with_a_generator(port_calls):
    """Dropout > 0 takes plain attention, its mask drawn from the global
    generator: one ``paddle.seed`` gives the same output twice (the
    reference's numbers under one seed: ``tests/test_torch_random_ops.py``).
    (The name is the one the test had while the mask needed a
    ``generator=``; it is kept so that its record carries on.)
    """
    import paddle_tpu_torch as tpaddle

    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 16, 16, 2, 8, 8))
    tpaddle.seed(1)
    a, _ = NF.flash_attention(q, k, v, dropout=0.5, causal=True)
    tpaddle.seed(1)
    b, _ = NF.flash_attention(q, k, v, dropout=0.5, causal=True)
    assert tpaddle.get_rng_state() == (1, 1)
    assert port_calls["fwd"] == 0 and np.array_equal(a.numpy(), b.numpy())
    # not training: no dropout, the same numbers as the flash op
    c, _ = NF.flash_attention(q, k, v, dropout=0.5, causal=True,
                              training=False)
    d, _ = NF.flash_attention(q, k, v, causal=True)
    assert port_calls["fwd"] == 1
    np.testing.assert_allclose(c.numpy(), d.numpy(), **FWD)


def test_bad_shapes_raise():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="B, S, H, D"):
        tfa.flash_attention_data(q, torch.zeros(1, 8, 3, 16),
                                 torch.zeros(1, 8, 3, 16))


def test_kernel_input_checks():
    """What the CUDA wrappers check before a launch (the checks run on
    any device; the launch itself needs the card)."""
    q = torch.zeros(1, 8, 2, 16)
    kv = torch.zeros(1, 5, 2, 16)
    lse = torch.zeros(2, 8)
    ok, shape = tfa._prepare(q, kv, kv.transpose(1, 2).contiguous()
                             .transpose(1, 2), q, lse, lse)
    assert shape == (1, 2, 8, 5, 16) and all(x.is_contiguous() for x in ok)
    bad = [
        ((torch.zeros(1, 8, 2, 48), torch.zeros(1, 5, 2, 48),
          torch.zeros(1, 5, 2, 48)), "head_dim"),
        ((q.half(), kv.half(), kv.half()), "dtype"),
        ((q, kv, torch.zeros(1, 6, 2, 16)), "v "),
        ((q, kv, kv, torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16), lse,
          lse), "do "),
        ((q, kv, kv, q, torch.zeros(2, 7), lse), "lse "),
    ]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            tfa._prepare(*args)
