"""The one measured speculative-decoding configuration of the port,
shared by ``chip_smoke.py`` (phase 9) and
:mod:`paddle_tpu_torch.tools.profile_serve` (``--spec``).

The target and the workload are those of
:mod:`paddle_tpu_torch.tools.llama3_8b_serve` (Llama-3-8B at full width
and depth in bf16, random weights from seed 0; block 16, 8 sequences,
``max_model_len`` 2048, a 2048-token step budget; 8 requests of 128-1024
prompt tokens and 32 new tokens each, 7 greedy and one at temperature
0.8, top-k 50). The draft has the published widths of Llama-3.2-1B,
which shares Llama-3's tokenizer: vocabulary 128256, hidden 2048, MLP
8192, 16 layers, 32 heads over 8 KV heads (head_dim 64), rope theta
500000, tied embeddings. It proposes ``NUM_SPEC_TOKENS`` = 4 tokens per
decode row.

What differs from the published draft model: random weights (seed 1 on
the card), no "llama3" rope scaling (neither package implements it),
and a position table cut from 131072 to 8192 positions. With random
weights the draft and the target agree by chance only, so acceptance is
near 0: the run exercises the draft forwards, the verify rows and the
rollback, not the speed-up a trained pair would give.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import EngineConfig, LLMEngine
from paddle_tpu_torch.serving.spec import SpecDecoder
from paddle_tpu_torch.tools import llama3_8b_serve

__all__ = ["DRAFT", "NUM_SPEC_TOKENS", "draft_model", "draft_shape",
           "build_engine"]

NUM_SPEC_TOKENS = 4
DRAFT = dict(vocab_size=128256, hidden_size=2048, intermediate_size=8192,
             num_hidden_layers=16, num_attention_heads=32,
             num_key_value_heads=8, max_position_embeddings=8192,
             rope_theta=500000.0, tie_word_embeddings=True)


def draft_model(device) -> LlamaForCausalLM:
    """The Llama-3.2-1B-width draft in bf16 on ``device``, random weights
    from seed 1."""
    model = LlamaForCausalLM(LlamaConfig(dtype="bfloat16", **DRAFT),
                             device=device)
    return model.init_weights(torch.Generator(device=device).manual_seed(1))


def draft_shape(prompt_lens: Sequence[int]) -> Tuple[int, int]:
    """(batch, width) of the widest draft forward the workload gives: every
    request proposing, the longest prompt at its last proposal (a request
    proposes while it has at least two tokens left to generate), bucketed
    as :class:`SpecDecoder` buckets them."""
    width = (max(prompt_lens) + llama3_8b_serve.MAX_NEW_TOKENS - 2
             + NUM_SPEC_TOKENS)
    return (SpecDecoder._bucket(len(prompt_lens)),
            SpecDecoder._bucket(width, 8))


def build_engine(device) -> LLMEngine:
    """Target, draft and engine on ``device``, warmed up by a request long
    enough to verify one draft."""
    eng = LLMEngine(llama3_8b_serve.target_model(device),
                    EngineConfig(draft_model=draft_model(device),
                                 num_spec_tokens=NUM_SPEC_TOKENS,
                                 **llama3_8b_serve.ENGINE))
    return llama3_8b_serve.warm_up(eng, 2 + NUM_SPEC_TOKENS)
