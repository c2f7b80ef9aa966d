"""The one measured serving configuration of the port, shared by
``chip_smoke.py`` (phase 4) and :mod:`paddle_tpu_torch.tools.profile_serve`
so that both read the same setup.

Llama-3-8B at full width and depth (32 layers, bf16, random weights from
a seeded generator on the card) behind an ``LLMEngine`` with block 16,
8 sequences, ``max_model_len`` 2048 and a 2048-token step budget (1024 KV
blocks). The workload is 8 requests with prompt lengths drawn from seed 0
in 128-1024 and random prompt tokens from the same generator, 32 new
tokens each: 7 greedy, the last at temperature 0.8, top-k 50.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams

__all__ = ["NUM_REQUESTS", "MAX_NEW_TOKENS", "ENGINE", "target_model",
           "warm_up", "build_engine", "add_requests"]

NUM_REQUESTS = 8
MAX_NEW_TOKENS = 32
# the engine settings, shared with the speculative configuration
# (:mod:`paddle_tpu_torch.tools.llama3_8b_spec_serve`)
ENGINE = dict(block_size=16, max_num_seqs=8, max_model_len=2048,
              max_batched_tokens=2048)


def target_model(device) -> LlamaForCausalLM:
    """Llama-3-8B in bf16 on ``device``, random weights from seed 0."""
    model = LlamaForCausalLM(LlamaConfig.llama3_8b(dtype="bfloat16"),
                             device=device)
    return model.init_weights(torch.Generator(device=device).manual_seed(0))


def warm_up(eng: LLMEngine, max_new_tokens: int = 2) -> LLMEngine:
    """Serve one request whose prompt fills the step budget, release it
    and reset the metrics window: on the card this captures the step at
    the largest bucket and at the smallest (its decode steps), the two
    that the workload's prefill and decode steps take."""
    n = min(eng._ragged_T, eng.cfg.max_model_len - max_new_tokens)
    eng.add_request("warmup", [1 + i % 1000 for i in range(n)],
                    SamplingParams(max_new_tokens=max_new_tokens))
    eng.run()
    eng.release_request("warmup")
    eng.reset_metrics()
    return eng


def build_engine(device) -> LLMEngine:
    """The model and engine on ``device``, warmed up."""
    return warm_up(LLMEngine(target_model(device), EngineConfig(**ENGINE)))


def add_requests(eng: LLMEngine) -> Tuple[List[str], np.ndarray]:
    """Queue the workload; returns the request ids and prompt lengths."""
    vocab = eng.model.config.vocab_size
    rng = np.random.default_rng(0)
    lens = rng.integers(128, 1025, size=NUM_REQUESTS)
    rids = []
    for i, n in enumerate(lens):
        sp = (SamplingParams(max_new_tokens=MAX_NEW_TOKENS, temperature=0.8,
                             top_k=50)
              if i == NUM_REQUESTS - 1
              else SamplingParams(max_new_tokens=MAX_NEW_TOKENS))
        prompt = list(map(int, rng.integers(0, vocab, size=int(n))))
        rids.append(eng.add_request(f"r{i}", prompt, sp))
    return rids, lens
