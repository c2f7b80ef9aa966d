"""The tensor-parallel serving configuration of ``chip_smoke.py`` phase
25: phase 4's (:mod:`paddle_tpu_torch.tools.llama3_8b_serve`: Llama-3-8B
widths, random weights from seed 0, block 16, 8 sequences, a 2048-token
budget, its 8-request workload) at ``tp_degree=2``, both ranks on the
model's card through :func:`paddle_tpu_torch.testing.tp_hooks.
ranks_share_one_device` (one card measures the TP path's numbers and
launches, not its speed). Each rank then holds 16 of the 32 query heads,
4 of the 8 kv heads and 7168 of the 14336 MLP columns.

:func:`f32_parity` serves the workload at f32 with 2 of the 32 layers at
``tp_degree`` 1 and 2: the tokens must be identical. Run alone with
``python -m paddle_tpu_torch.tools.llama3_8b_tp`` (prints the parity
result as JSON).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List

import torch

from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import EngineConfig, LLMEngine
from paddle_tpu_torch.testing import tp_hooks
from paddle_tpu_torch.tools import llama3_8b_serve

__all__ = ["TP", "model", "engine", "serve", "f32_parity"]

TP = 2
PARITY_LAYERS = 2


def model(device, dtype: str = "bfloat16", layers: int = None,
          config: LlamaConfig = None) -> LlamaForCausalLM:
    """Llama-3-8B (or ``config``) in ``dtype`` on ``device``, ``layers``
    of its decoder layers (default: all), random weights from seed 0."""
    cfg = config or LlamaConfig.llama3_8b()
    cfg = dataclasses.replace(cfg, dtype=dtype, num_hidden_layers=(
        layers or cfg.num_hidden_layers))
    m = LlamaForCausalLM(cfg, device=device)
    return m.init_weights(torch.Generator(device=device).manual_seed(0))


def engine(m: LlamaForCausalLM, tp: int = TP, **kw) -> LLMEngine:
    """``m`` behind phase 4's engine settings at ``tp_degree=tp``, every
    rank on ``m``'s device."""
    cfg = dict(llama3_8b_serve.ENGINE, **kw)
    with tp_hooks.ranks_share_one_device():
        return LLMEngine(m, EngineConfig(tp_degree=tp, **cfg))


def serve(eng: LLMEngine) -> Dict[str, List[int]]:
    """Phase 4's workload on ``eng`` to the end; the generated tokens by
    request id."""
    rids, _ = llama3_8b_serve.add_requests(eng)
    steps = 0
    while eng.has_unfinished():
        eng.step()
        steps += 1
        assert steps < 1000, "engine failed to converge"
    return {rid: list(eng.get_request(rid).generated) for rid in rids}


def f32_parity(device, layers: int = PARITY_LAYERS,
               config: LlamaConfig = None, **engine_kw) -> dict:
    """The workload at f32 with ``layers`` decoder layers, at tp 1 and
    ``TP``, one model each from the same seed; each engine and model is
    dropped before the next is built."""
    tokens, info = {}, {}
    for tp in (1, TP):
        eng = engine(model(device, "float32", layers, config), tp,
                     **engine_kw)
        tokens[tp] = serve(eng)
        if tp > 1:
            info = {"backend": eng._tp.backend,
                    "handoff_s": eng._tp.handoff_s}
        del eng
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    same = {rid: tokens[1][rid] == tokens[TP][rid] for rid in tokens[1]}
    return {"layers": layers, "dtype": "float32", "tp": TP,
            "token_identical": all(same.values()), "per_request": same,
            **info}


if __name__ == "__main__":
    print(json.dumps(f32_parity(torch.device("cuda", 0))))
