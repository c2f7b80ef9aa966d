"""The port's Llama against the JAX package's, weights carried across.

``LlamaConfig.tiny`` weights from the JAX model go through
``llama_state_from_jax`` into the port; both run ``forward_ragged`` on
the same mixed ragged batch (numpy inputs from a seed) and must give the
same logits and the same updated caches. Also: the device rule of the
port's entry point."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu_torch.models.convert import llama_state_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

# f32 end to end on both sides (the test config sets XLA's matmul
# precision to highest); two decoder layers of summation-order noise
ATOL = RTOL = 1e-4


@pytest.fixture(scope="module")
def jax_model():
    paddle.seed(0)
    m = JLlama(JLlamaConfig.tiny())
    m.eval()
    return m


@pytest.fixture(scope="module")
def port_model(jax_model):
    state = {k: np.asarray(v.numpy())
             for k, v in jax_model.state_dict().items()}
    m = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    m.load_state_dict(llama_state_from_jax(state))
    return m


def _ragged_batch(cfg, seed=1, bs=4, nb=24, s_slots=4, mb=8):
    """Slots: 0 decode at ctx 10, 1 prefill chunk of 5 from position 6,
    2 fresh prefill of 7, 3 padding; 2 padding rows past cu[num_seqs]."""
    rng = np.random.default_rng(seed)
    nq, ctx_live = [1, 5, 7], [10, 11, 7]
    ns = len(nq)
    cu = np.zeros((s_slots + 1,), np.int32)
    cu[1:ns + 1] = np.cumsum(nq)
    cu[ns + 1:] = cu[ns]
    ctx = np.zeros((s_slots,), np.int32)
    ctx[:ns] = ctx_live
    bt = np.full((s_slots, mb), -1, np.int32)
    perm = rng.permutation(nb)
    k = 0
    for i, c in enumerate(ctx_live):
        need = -(-c // bs)
        bt[i, :need] = perm[k:k + need]
        k += need
    t_total = int(cu[ns]) + 2
    ids = rng.integers(0, cfg.vocab_size, size=t_total).astype(np.int32)
    kh = cfg.num_key_value_heads
    hd = cfg.hidden_size // cfg.num_attention_heads
    shape = (cfg.num_hidden_layers, nb, bs, kh, hd)
    kcs = rng.standard_normal(shape).astype(np.float32)
    vcs = rng.standard_normal(shape).astype(np.float32)
    return ids, kcs, vcs, bt, cu, ctx, np.int32(ns)


def test_converter_transposes_linears(jax_model):
    state = {k: np.asarray(v.numpy())
             for k, v in jax_model.state_dict().items()}
    conv = llama_state_from_jax(state)
    k = "llama.layers.0.self_attn.k_proj.weight"
    assert state[k].shape == (64, 32)          # JAX Linear: [in, out]
    assert tuple(conv[k].shape) == (32, 64)    # torch: [out, in]
    np.testing.assert_array_equal(conv[k].numpy(), state[k].T)
    e = "llama.embed_tokens.weight"
    np.testing.assert_array_equal(conv[e].numpy(), state[e])


def test_forward_ragged_matches_jax(jax_model, port_model):
    cfg = port_model.config
    ids, kcs, vcs, bt, cu, ctx, ns = _ragged_batch(cfg)
    lg_j, kc_j, vc_j = jax_model.forward_ragged(
        jnp.asarray(ids), jnp.asarray(kcs), jnp.asarray(vcs),
        jnp.asarray(bt), jnp.asarray(cu), jnp.asarray(ctx), jnp.asarray(ns))
    kc_t = torch.from_numpy(kcs.copy())
    vc_t = torch.from_numpy(vcs.copy())
    lg_t, kc_out, vc_out = port_model.forward_ragged(
        torch.from_numpy(ids), kc_t, vc_t, torch.from_numpy(bt),
        torch.from_numpy(cu), torch.from_numpy(ctx), torch.tensor([ns]))
    assert kc_out is kc_t and vc_out is vc_t   # updated in place
    lg_j = np.asarray(lg_j.numpy())
    live = int(ns)
    assert lg_t.shape == lg_j.shape == (4, cfg.vocab_size)
    np.testing.assert_allclose(lg_t.numpy()[:live], lg_j[:live],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(kc_t.numpy(), np.asarray(kc_j),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(vc_t.numpy(), np.asarray(vc_j),
                               rtol=RTOL, atol=ATOL)
    # the step wrote exactly the live rows' slots (per layer)
    changed = np.any(kc_t.numpy() != kcs, axis=(3, 4)).sum(axis=(1, 2))
    assert list(changed) == [int(cu[live])] * cfg.num_hidden_layers


def test_rope_tables_match_jax():
    from paddle_tpu.models.llama import _rope_tables as j_rope
    from paddle_tpu_torch.models.llama import _rope_tables as t_rope

    cj, sj = j_rope(8192, 128, 500000.0)
    ct, st = t_rope(8192, 128, 500000.0)
    # same f32 recipe; sin/cos of the same f32 angles differ by an ulp
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6)


def test_rms_norm_matches_jax():
    from paddle_tpu.ops.nn_ops import rms_norm as j_rms
    from paddle_tpu_torch.nn.norm import rms_norm as t_rms

    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    w = rng.standard_normal((64,)).astype(np.float32)
    yj = np.asarray(j_rms(jnp.asarray(x), jnp.asarray(w), epsilon=1e-6))
    yt = t_rms(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-6, atol=1e-6)


def test_entry_point_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(LlamaConfig.tiny())
    with pytest.raises(RuntimeError):
        LlamaForCausalLM(LlamaConfig.tiny(), device="cuda")
    m = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    assert m.device.type == "cpu"
