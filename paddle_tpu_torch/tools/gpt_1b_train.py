"""The one measured training configuration of the port, shared by
``chip_smoke.py`` (phase ``train``) and
:mod:`paddle_tpu_torch.tools.profile_train`, so that both read the same
setup.

It is ``bench.py``'s ``bench_gpt_1b``: a Llama-architecture decoder with
hidden 2048, MLP 5632, 16 layers, 16 heads and 16 kv heads (head_dim
128), vocab 32000 (0.95B parameters), bf16 weights, flash attention,
AdamW at lr 3e-4 (weight decay 0.01, no clip, no master weights), one
batch of 4 x 2048 random token ids and random labels from
``np.random.RandomState(0)``, repeated every step. Full width and depth;
the weights are random, from a seeded generator on the card.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.optimizer import AdamW

__all__ = ["BATCH", "SEQ", "config", "build", "flops_per_token"]

BATCH = 4
SEQ = 2048


def config() -> LlamaConfig:
    return LlamaConfig(vocab_size=32000, hidden_size=2048,
                       intermediate_size=5632, num_hidden_layers=16,
                       num_attention_heads=16, num_key_value_heads=16,
                       max_position_embeddings=SEQ, use_flash_attention=True,
                       dtype="bfloat16")


def build(device) -> Tuple[LlamaForCausalLM, TrainStep, torch.Tensor,
                           torch.Tensor]:
    """(model, train step, ids, labels), all on ``device``."""
    cfg = config()
    model = LlamaForCausalLM(cfg, device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(0))
    opt = AdamW(learning_rate=3e-4, parameters=model.parameters())
    step = TrainStep(model, model.criterion(cfg), opt)
    rng = np.random.RandomState(0)
    x = rng.randint(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    y = rng.randint(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    return (model, step, torch.from_numpy(x).to(device),
            torch.from_numpy(y).to(device))


def flops_per_token(model: LlamaForCausalLM) -> int:
    """Model flops per trained token as ``bench.py`` counts them: 6N for
    the parameters plus 6 * layers * hidden * seq for causal attention."""
    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    return 6 * n_params + 6 * cfg.num_hidden_layers * cfg.hidden_size * SEQ
