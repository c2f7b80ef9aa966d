"""Card-versus-CPU speculative serving parity on ``LlamaConfig.tiny``,
shared by ``chip_smoke.py`` (phase ``spec_parity``) and
``tests/test_torch_card.py``, so that both hold the port to one check.

Both sides run in f32 with TF32 off, from the same seed-0 weights; the
draft is the target itself, k = 3 (block 4, 4 sequences, a 32-token step
budget). Two engines per side:

* greedy — 4 requests of 5-33 prompt tokens, 12 new tokens each. Tokens
  must be identical card vs CPU and equal a non-speculative engine's on
  the card; with draft == target every proposal should verify, so the
  acceptance rate must exceed 0.9;
* sampled — 2 requests at temperature 0.8, top-k 50, top-p 0.9. Tokens
  and every request's final threefry key must be identical card vs CPU.
  A draft's greedy token is accepted with the target's probability of
  it, so this engine's acceptance is low with random weights (reported,
  not held to a bound).

The card side runs the ragged attention kernel (verify rows) and the
flash attention forward kernel (draft forwards), replayed from the
engines' CUDA graphs; the CPU side runs their plain versions eagerly.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import ragged_paged_attention as rpa
from paddle_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams

__all__ = ["K", "run"]

K = 3
_ENGINE = dict(block_size=4, max_num_seqs=4, max_model_len=64,
               max_batched_tokens=32)


def _serve(model, k, prompts, sps) -> dict:
    spec = dict(draft_model=model, num_spec_tokens=k) if k else {}
    eng = LLMEngine(model, EngineConfig(**_ENGINE, **spec))
    rids = [eng.add_request(f"t{i}", p, sp)
            for i, (p, sp) in enumerate(zip(prompts, sps))]
    eng.run()
    reqs = [eng.get_request(r) for r in rids]
    assert all(r.finish_reason == "length" for r in reqs)
    assert eng.block_manager.num_free_blocks == eng.cfg.num_blocks
    graphs = [g.since() for g in
              [eng._graphs] + ([eng._spec.graphs] if k else [])]
    return {"tokens": [r.generated for r in reqs],
            "keys": [[int(x) for x in r.device_key] for r in reqs],
            "captures": sum(g["captures"] for g in graphs),
            "replays": sum(sum(g["replays"].values()) for g in graphs),
            "proposed": eng.num_spec_proposed,
            "accepted": eng.num_spec_accepted,
            "acceptance": eng.spec_acceptance_rate,
            "steps": eng.metrics.engine_steps}


def run(device) -> dict:
    """Serve on ``device`` and on the CPU, assert that they agree, and
    return the numbers. Raises ``AssertionError`` when they do not, or
    when the card side launched neither kernel."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig.tiny()
    cpu_model = LlamaForCausalLM(cfg, device="cpu")
    cpu_model.init_weights(torch.Generator().manual_seed(0))
    card_model = LlamaForCausalLM(cfg, device=device)
    card_model.load_state_dict(cpu_model.state_dict())
    prompts = [list(map(int, np.random.default_rng(i).integers(
        0, cfg.vocab_size, size=n))) for i, n in enumerate([5, 17, 33, 9])]
    greedy = [SamplingParams(max_new_tokens=12)] * 4
    sampled = [SamplingParams(max_new_tokens=12, temperature=0.8, top_k=50,
                              top_p=0.9, seed=7 + i) for i in range(2)]
    k1, k2 = rpa.launches, fa.launches["flash_attention_fwd"]
    card = {"greedy": _serve(card_model, K, prompts, greedy),
            "sampled": _serve(card_model, K, prompts[:2], sampled)}
    launches = {"ragged_paged_attention": rpa.launches - k1,
                "flash_attention_fwd":
                    fa.launches["flash_attention_fwd"] - k2}
    plain = _serve(card_model, 0, prompts, greedy)
    cpu = {"greedy": _serve(cpu_model, K, prompts, greedy),
           "sampled": _serve(cpu_model, K, prompts[:2], sampled)}
    assert all(n > 0 for n in launches.values()), launches
    for kind in ("greedy", "sampled"):
        assert card[kind]["tokens"] == cpu[kind]["tokens"], (kind, card,
                                                             cpu)
        assert card[kind]["keys"] == cpu[kind]["keys"], (kind, card, cpu)
        assert card[kind]["proposed"] > 0, card
    assert card["greedy"]["tokens"] == plain["tokens"], (card, plain)
    assert card["greedy"]["acceptance"] > 0.9, card
    assert card["greedy"]["steps"] < plain["steps"], (card, plain)
    return {"model": "tiny", "dtype": "float32", "num_spec_tokens": K,
            "card": card, "cpu_identical": True,
            "plain_steps": plain["steps"], "kernel_launches": launches}
