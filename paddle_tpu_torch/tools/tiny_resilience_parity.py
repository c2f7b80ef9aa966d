"""Card-versus-CPU parity of the one-card resilience paths on
``LlamaConfig.tiny``, shared by ``chip_smoke.py`` (phase
``resilience_parity``) and ``tests/test_torch_card.py``, so that both
hold the port to one check.

Both sides run in f32 with TF32 off, from the same seed-0 weights, block
4. Each scenario's tokens (and finish reasons) must be identical on the
card and on the CPU:

* swap vs recompute — 4 requests (6, 8, 5, 7 prompt tokens, 8 new) on
  10 KV blocks, so the batch cannot all reach full length: once with
  ``swap_mode="recompute"``, once with ``"host"``; the two modes'
  tokens must be identical too, and the host run must have swapped;
* drain — 8 requests on 4 sequences with a preemption notice after the
  third step (``PreemptionMonitor.request``; ``chip_smoke.py``'s drain
  phase delivers a real SIGTERM): finish reasons and tokens;
* the bucketed engine (``ragged=False``) on a mixed workload with a
  sampled row: tokens and the ``(kind, B, S)`` keys;
* ``generate`` on a (2, 7) prompt, 5 new tokens: cached (the ragged
  engine) and naive (``forward``, the flash forward on the card) equal
  each other on the card and the CPU's cached tokens.

The card side runs the ragged attention kernel (swap, drain, cached
generate) and the flash forward kernel (naive generate); the bucketed
path runs no hand-written kernel on either side.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.distributed.watchdog import PreemptionMonitor
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import ragged_paged_attention as rpa
from paddle_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams

__all__ = ["run"]


def _prompts(seed, vocab, lens):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, vocab, size=n))) for n in lens]


def _swap(model, mode) -> dict:
    eng = LLMEngine(model, EngineConfig(
        block_size=4, num_blocks=10, max_num_seqs=4, max_model_len=32,
        swap_mode=mode))
    tokens = eng.generate(_prompts(15, model.config.vocab_size,
                                   [6, 8, 5, 7]),
                          SamplingParams(max_new_tokens=8))
    assert eng.block_manager.num_free_blocks == eng.cfg.num_blocks
    assert eng.block_manager.num_free_host_blocks == eng.cfg.num_host_blocks
    sch = eng.scheduler
    return {"tokens": tokens, "preemptions": sch.num_preemptions,
            "swap_outs": sch.num_swap_outs, "swap_ins": sch.num_swap_ins}


def _drain(model) -> dict:
    eng = LLMEngine(model, EngineConfig(block_size=4, max_num_seqs=4,
                                        max_model_len=64))
    monitor = eng.install_preemption_handler(PreemptionMonitor())
    try:
        rids = [eng.add_request(p, SamplingParams(max_new_tokens=6))
                for p in _prompts(10, model.config.vocab_size,
                                  [3, 5, 7, 4, 6, 2, 5, 3])]
        steps = 0
        while eng.has_unfinished():
            eng.step()
            steps += 1
            if steps == 3:
                monitor.request()
    finally:
        monitor.uninstall()
    assert eng.drained
    assert eng.block_manager.num_free_blocks == eng.cfg.num_blocks
    reqs = [eng.get_request(r) for r in rids]
    return {"finish": [r.finish_reason for r in reqs],
            "tokens": [r.generated for r in reqs],
            "drain_aborted": eng.num_drain_aborted}


def _bucketed(model) -> dict:
    eng = LLMEngine(model, EngineConfig(
        block_size=4, max_num_seqs=4, max_model_len=64, num_blocks=14,
        max_batched_tokens=32, ragged=False))
    prompts = _prompts(32, model.config.vocab_size, [29, 3, 22, 6, 11, 4])
    rids = [eng.add_request(
        f"b{i}", p, SamplingParams(max_new_tokens=6,
                                   temperature=0.8 if i == 1 else 0.0,
                                   seed=i))
        for i, p in enumerate(prompts)]
    eng.run()
    assert eng.block_manager.num_free_blocks == eng.cfg.num_blocks
    return {"tokens": [eng.get_request(r).generated for r in rids],
            "keys": sorted(eng._seen_shapes),
            "preemptions": eng.scheduler.num_preemptions}


def _generate(model) -> dict:
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        0, model.config.vocab_size, size=(2, 7)))
    cached = model.generate(ids, max_new_tokens=5)
    naive = model.generate(ids, max_new_tokens=5, use_cache=False)
    model.close()     # the model and its cached engine refer to each
    # other: drop the engine so both go with their last references
    return {"cached": cached.cpu().tolist(), "naive": naive.cpu().tolist()}


def _serve(model) -> dict:
    return {"swap": {m: _swap(model, m) for m in ("recompute", "host")},
            "drain": _drain(model), "bucketed": _bucketed(model),
            "generate": _generate(model)}


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
    k1, k2 = rpa.launches, fa.launches["flash_attention_fwd"]
    card = _serve(card_model)
    launches = {"ragged_paged_attention": rpa.launches - k1,
                "flash_attention_fwd":
                    fa.launches["flash_attention_fwd"] - k2}
    cpu = _serve(cpu_model)
    assert all(n > 0 for n in launches.values()), launches
    assert card == cpu, (card, cpu)
    swap = card["swap"]
    assert swap["host"]["tokens"] == swap["recompute"]["tokens"], swap
    assert swap["host"]["swap_outs"] > 0, swap
    assert swap["host"]["swap_ins"] == swap["host"]["swap_outs"], swap
    assert card["drain"]["drain_aborted"] > 0, card["drain"]
    assert card["bucketed"]["preemptions"] > 0, card["bucketed"]
    gen = card["generate"]
    assert gen["cached"] == gen["naive"], gen
    return {"model": "tiny", "dtype": "float32", "card": card,
            "cpu_identical": True, "kernel_launches": launches}
