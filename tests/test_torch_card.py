"""Card-only checks of the port (``gpu`` marker). They skip without a
CUDA device; on the card run them with

    python -m pytest --noconftest -q tests/test_torch_card.py

(``--noconftest``: the suite's conftest configures JAX, which the card's
machine does not have and this file does not use). The ragged attention
kernel is held against its plain version on small mixed batches, and
the tiny engine's greedy tokens on the card against the CPU's; the flash
attention kernels (forward, dQ, dK/dV) against their plain versions over
head dims, dtypes, Sq != Sk and ragged tails, and three tiny training
steps on the card against the CPU."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import ragged_paged_attention as rpa


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _batch(dev, dtype, h, kh, d, bs, seed=0, nb=64, s_slots=6, mb=16):
    rng = np.random.default_rng(seed)
    live = [(1, 9), (6, 13), (1, 8), (5, 5), (1, 61)]
    ns = len(live)
    cu = np.zeros((s_slots + 1,), np.int32)
    cu[1:ns + 1] = np.cumsum([n for n, _ in live])
    cu[ns + 1:] = cu[ns]
    ctx = np.zeros((s_slots,), np.int32)
    ctx[:ns] = [c for _, c in live]
    bt = np.full((s_slots, mb), -1, np.int32)
    perm = rng.permutation(nb)
    k = 0
    for i, (_, c) in enumerate(live):
        need = -(-c // bs)
        bt[i, :need] = perm[k:k + need]
        k += need
    t_total = int(cu[ns]) + 5

    def randn(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)

    return dict(q=randn(t_total, h, d), k_new=randn(t_total, kh, d),
                v_new=randn(t_total, kh, d), key_cache=randn(nb, bs, kh, d),
                value_cache=randn(nb, bs, kh, d),
                block_tables=torch.from_numpy(bt).to(dev),
                cu_seqlens=torch.from_numpy(cu).to(dev),
                context_lens=torch.from_numpy(ctx).to(dev),
                num_seqs=torch.tensor([ns], dtype=torch.int32, device=dev))


# f32: summation order only; bf16: the kernel's output is rounded to
# bf16 (at most half a relative step of 2^-8, covered by rtol) while the
# reference stays in f32
@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-4, 1e-4),
                                             (torch.bfloat16, 1e-2, 1e-3)])
@pytest.mark.parametrize("h,kh,d,bs", [(4, 2, 16, 4), (32, 8, 128, 16),
                                       (8, 8, 64, 8), (32, 4, 64, 32)])
def test_kernel_matches_plain(card, dtype, rtol, atol, h, kh, d, bs):
    b = _batch(card, dtype, h, kh, d, bs)
    kc_ref = b["key_cache"].clone()
    vc_ref = b["value_cache"].clone()
    before = rpa.launches
    out, kc, vc = rpa.ragged_paged_attention(**b)
    assert rpa.launches == before + 1
    seg, pos, _ = rpa._token_layout(out.shape[0], 6, b["cu_seqlens"],
                                    b["context_lens"], b["num_seqs"])
    rpa._write_kv(kc_ref, b["k_new"], b["block_tables"], seg, pos)
    rpa._write_kv(vc_ref, b["v_new"], b["block_tables"], seg, pos)
    ref = rpa._ragged_attend_ref(b["q"], kc_ref, vc_ref, b["block_tables"],
                                 b["cu_seqlens"], b["context_lens"],
                                 b["num_seqs"], d ** -0.5,
                                 out_dtype=torch.float32)
    torch.cuda.synchronize()
    live = int(b["cu_seqlens"][5])
    assert torch.equal(kc, kc_ref) and torch.equal(vc, vc_ref)
    assert torch.all(out[live:] == 0)
    torch.testing.assert_close(out[:live].float(), ref[:live], rtol=rtol,
                               atol=atol)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(card):
    b = _batch(card, torch.float16, 4, 2, 16, 4)
    with pytest.raises(ValueError, match="dtype"):
        rpa.ragged_paged_attention(**b)


@pytest.mark.gpu
def test_tiny_engine_card_matches_cpu(card):
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import (EngineConfig, LLMEngine,
                                          SamplingParams)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig.tiny()
    cpu_model = LlamaForCausalLM(cfg, device="cpu")
    cpu_model.init_weights(torch.Generator().manual_seed(0))
    card_model = LlamaForCausalLM(cfg)
    card_model.load_state_dict(cpu_model.state_dict())
    prompts = [list(range(1, 1 + n)) for n in (3, 11, 27)]
    ecfg = dict(block_size=4, max_num_seqs=4, max_model_len=64,
                max_batched_tokens=16)
    sp = SamplingParams(max_new_tokens=6)
    a = LLMEngine(card_model, EngineConfig(**ecfg)).generate(prompts, sp)
    b = LLMEngine(cpu_model, EngineConfig(**ecfg)).generate(prompts, sp)
    assert a == b


# --------------------------------------------------------------------------
# flash attention kernels
# --------------------------------------------------------------------------
def _flash_inputs(dev, dtype, b, sq, sk, h, d, seed):
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev, dtype)

    return (randn(b, sq, h, d), randn(b, sk, h, d), randn(b, sk, h, d),
            randn(b, sq, h, d))


# f32: the f32-FMA kernels and the plain version differ in summation order
# only (TF32 off). bf16: every kernel accumulates in f32 and rounds its
# output to bf16 once (half a relative step of 2^-8, which rtol covers).
# The tensor-core forward and dK/dV also round P and dS to bf16 before the
# P V-type products, as the TPU kernels do; against a plain version that
# keeps them in f32 that rounding alone exceeds atol near zero: 2.4e-3 in O
# on an H100, about 5e-3 in dK and dV as estimated on the CPU from the
# same inputs. So the plain versions round at the same places (`round_to`:
# the forward's online softmax over KEY_BLOCK keys, P and dS for dK and dV;
# held against the Pallas kernels in bf16 by
# tests/test_torch_flash_attention.py) and the tolerance stays as it was.
# dQ keeps dS in f32, as does its plain version.
_FLASH_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
              torch.bfloat16: dict(rtol=1e-2, atol=2e-3)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("b,sq,sk,h,causal", [
    (2, 128, 128, 2, True),      # whole tiles
    (1, 100, 100, 3, True),      # ragged tail tile
    (2, 70, 150, 2, True),       # Sq < Sk, bottom-right causal
    (1, 150, 70, 2, True),       # Sq > Sk: rows that see no key
    (2, 90, 130, 2, False),      # not causal, ragged both ways
    (1, 192, 192, 2, True),      # a multiple of 64, not of 128
    (1, 1024, 1024, 4, True),    # cycles the two-stage TMA ring
])
def test_flash_kernels_match_plain(card, dtype, d, b, sq, sk, h, causal):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do = _flash_inputs(card, dtype, b, sq, sk, h, d, seed=d + sq)
    scale = d ** -0.5
    before = dict(fa.launches)
    o, lse = fa._flash_fwd_cuda(q, k, v, scale, causal)
    delta = fa._delta(o, do)
    dq = fa._flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal)
    dk, dv = fa._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale, causal)
    torch.cuda.synchronize()
    assert all(fa.launches[n] == before[n] + 1 for n in before)
    f = [x.float() for x in (q, k, v, do)]
    o_ref, lse_ref = fa._flash_fwd_ref(f[0], f[1], f[2], scale, causal,
                                       round_to=dtype)
    tol = _FLASH_TOL[dtype]
    torch.testing.assert_close(o.float(), o_ref, **tol)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-4)
    # the backward's reference takes the kernel's own O and lse
    grads = fa._flash_bwd_ref(f[0], f[1], f[2], o.float(), lse, f[3], scale,
                              causal, round_to=dtype)
    for got, want in zip((dq, dk, dv), grads):
        torch.testing.assert_close(got.float(), want, **tol)
    if causal and sq > sk:
        blind = sq - sk             # rows 0 .. blind-1 see no key
        assert torch.all(o[:, :blind] == 0) and torch.all(dq[:, :blind] == 0)
        assert torch.all(lse.view(b, h, sq)[:, :, :blind] == float("-inf"))


@pytest.mark.gpu
def test_flash_autograd_on_card_matches_cpu(card):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do = _flash_inputs("cpu", torch.float32, 2, 96, 96, 2, 32, 5)
    outs = []
    for dev in ("cpu", card):
        xs = [x.detach().to(dev).requires_grad_() for x in (q, k, v)]
        o = fa.flash_attention_data(*xs, causal=True)
        o.backward(do.to(dev))
        outs.append([o.detach().cpu()] + [x.grad.cpu() for x in xs])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [48, 256])
def test_flash_kernel_refuses_head_dim(card, d):
    q, k, v, _ = _flash_inputs(card, torch.bfloat16, 1, 16, 16, 2, d, 0)
    before = dict(fa.launches)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_data(q, k, v, causal=True)
    assert fa.launches == before


@pytest.mark.gpu
def test_tiny_train_card_matches_cpu(card):
    from paddle_tpu_torch.tools import tiny_train_parity

    # asserts the losses, the parameters and the kernel launches itself
    tiny_train_parity.run(card)
