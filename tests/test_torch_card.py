"""Card-only checks of the port (``gpu`` marker). They skip without a
CUDA device; on the card run them with

    python -m pytest --noconftest -q tests/test_torch_card.py

(``--noconftest``: the suite's conftest configures JAX, which the card's
machine does not have and this file does not use). The ragged attention
kernel is held against its plain version on small mixed batches, and
the tiny engine's greedy tokens on the card against the CPU's."""
import numpy as np
import pytest
import torch

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
