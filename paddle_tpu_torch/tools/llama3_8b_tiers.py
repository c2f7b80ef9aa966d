"""Tiered KV serving at Llama-3-8B width and depth, shared by
``chip_smoke.py`` (phase 23, ``tiers``) and the card tests.

The model is phase 4's (:func:`llama3_8b_serve.target_model`: bf16, 32
layers, random weights from seed 0), behind engines with block 16, 8
sequences, ``max_model_len`` 4096 and a 512-token step budget. The budget
is the same in every engine here, so a tiered engine and its untiered
twin step through the same token buckets and chunk the prompts alike:
the same GEMM shapes, and the same K1 splits (they depend on shapes, not
on the pools), so their bf16 tokens can be compared bit for bit.

* :func:`over_pool` — one greedy request, a 3000-token prompt and 32 new
  tokens, on a tiered engine whose device pool holds 64 blocks (1024
  tokens) with a 512-block host tier, and on an untiered engine of 1024
  blocks: the request demotes its own cold prefix to the host tier as
  it grows, and its step reads those pages through the mirror.
* :func:`sessions` — 8 greedy two-turn sessions (turn 1: prompts of
  400-900 tokens, 32 new; parked; turn 2: turn 1's tokens plus 64 more,
  32 new) on a tiered engine, resumed with zero recompute; the resumed
  chains' bytes (read from whichever tier holds each block) against the
  bytes turn 1 left; and the turn-2 prompts served cold by an untiered
  engine.

Run alone on the card::

    python -m paddle_tpu_torch.tools.llama3_8b_tiers
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from paddle_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams

__all__ = ["ENGINE", "PROMPT_LEN", "MAX_NEW_TOKENS", "tiered_engine",
           "untiered_engine", "MirrorSteps", "HostTimes", "over_pool",
           "sessions", "chain_bytes"]

ENGINE = dict(block_size=16, max_num_seqs=8, max_model_len=4096,
              max_batched_tokens=512)
OVER_POOL_BLOCKS = 64          # 1024 device tokens
OVER_POOL_HOST_BLOCKS = 512
UNTIERED_BLOCKS = 1024
PROMPT_LEN = 3000
MAX_NEW_TOKENS = 32
SESSIONS = 8
TURN1_LENS = (400, 900)
TURN2_EXTRA = 64
SESSION_BLOCKS = 512
SESSION_HOST_BLOCKS = 1024


def tiered_engine(model, num_blocks: int, host_blocks: int) -> LLMEngine:
    return LLMEngine(model, EngineConfig(
        **ENGINE, num_blocks=num_blocks,
        kv_tiers={"num_host_blocks": host_blocks}))


def untiered_engine(model) -> LLMEngine:
    return LLMEngine(model, EngineConfig(**ENGINE,
                                         num_blocks=UNTIERED_BLOCKS))


class MirrorSteps:
    """Wraps ``eng._dispatch`` to count the steps whose block tables name
    the host tier (an entry >= num_blocks) and keep the first such ragged
    step's index arrays ``(bt, cu, ctx, num_seqs)``."""

    def __init__(self, eng: LLMEngine):
        self.steps = 0
        self.mirror_steps = 0
        self.first = None
        nb = eng.cfg.num_blocks
        inner = eng._dispatch

        def dispatch(reqs, key, arrays):
            self.steps += 1
            bt = arrays[1]
            if (bt >= nb).any():
                self.mirror_steps += 1
                if self.first is None:
                    self.first = tuple(np.array(a) for a in arrays[1:5])
            return inner(reqs, key, arrays)

        eng._dispatch = dispatch


class HostTimes:
    """Wraps the tier's ``apply_moves`` and ``claim_resume`` to collect
    their host wall times (ms; ``claim_resume`` includes its own
    ``apply_moves``, ``resume_chain`` and the tail restore)."""

    def __init__(self, eng: LLMEngine):
        self.ms: Dict[str, List[float]] = {"apply_moves": [],
                                           "claim_resume": []}
        kvt = eng._kvtier
        for name in self.ms:
            inner = getattr(kvt, name)

            def timed(*a, _inner=inner, _name=name, **kw):
                t0 = time.perf_counter()
                try:
                    return _inner(*a, **kw)
                finally:
                    self.ms[_name].append((time.perf_counter() - t0) * 1e3)

            setattr(kvt, name, timed)

    def summary(self) -> dict:
        out = {}
        for name, v in self.ms.items():
            busy = [x for x in v if x > 0.0]
            out[name] = {"calls": len(v), "ms_total": float(sum(v)),
                         "ms_p50": float(np.percentile(busy, 50))
                         if busy else 0.0,
                         "ms_max": float(max(v)) if v else 0.0}
        return out


def _serve(eng: LLMEngine, max_steps: int = 4000) -> float:
    t0 = time.perf_counter()
    steps = 0
    while eng.has_unfinished():
        eng.step()
        steps += 1
        assert steps < max_steps, "engine failed to converge"
    if eng._kvtier is not None:
        eng._kvtier.apply_moves()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    return time.perf_counter() - t0


def over_pool(model) -> dict:
    """The 3000-token request on the 64-block tiered engine and on the
    1024-block untiered one. Returns both engines (the caller frees
    them), the tokens, the tier's counters, the mirror steps and the host
    times."""
    vocab = model.config.vocab_size
    rng = np.random.default_rng(0)
    prompt = [int(t) for t in rng.integers(1, vocab, size=PROMPT_LEN)]
    sp = SamplingParams(max_new_tokens=MAX_NEW_TOKENS)
    eng = tiered_engine(model, OVER_POOL_BLOCKS, OVER_POOL_HOST_BLOCKS)
    mirror = MirrorSteps(eng)
    times = HostTimes(eng)
    snap = eng._graphs.snapshot()
    eng.add_request("long", prompt, sampling=sp)
    wall = _serve(eng)
    window = eng._graphs.since(snap)
    req = eng.get_request("long")
    eng.block_manager.check_invariants()
    ref = untiered_engine(model)
    ref.add_request("long", prompt, sampling=sp)
    ref_wall = _serve(ref)
    got, want = list(req.generated), list(ref.get_request("long").generated)
    bm = eng.block_manager
    return {"engine": eng, "untiered": ref, "mirror": mirror,
            "window": window,
            "result": {
                "prompt_len": PROMPT_LEN, "new_tokens": len(got),
                "finish_reason": req.finish_reason,
                "device_blocks": OVER_POOL_BLOCKS,
                "host_blocks": OVER_POOL_HOST_BLOCKS,
                "untiered_blocks": UNTIERED_BLOCKS,
                "tokens_identical": got == want,
                "tokens_equal": sum(a == b for a, b in zip(got, want)),
                "num_demotes": bm.num_demotes,
                "num_promotes": bm.num_promotes,
                "steps": mirror.steps, "mirror_steps": mirror.mirror_steps,
                "tier_stats": eng.tier_stats(), "host_ms": times.summary(),
                "wall_s": wall, "untiered_wall_s": ref_wall,
                "preemptions": eng.scheduler.num_preemptions}}


def chain_bytes(eng: LLMEngine, table: List[int]) -> torch.Tensor:
    """The K and V bytes of the blocks ``table`` names, read where each
    lives: device blocks from the caches, virtual entries from the host
    tier's mirror (the step's second pool); (2, L, n, BS, KH, D)."""
    nb = eng.cfg.num_blocks
    dev = torch.as_tensor([b for b in table if b < nb], dtype=torch.long,
                          device=eng.device)
    virt = torch.as_tensor([b - nb for b in table if b >= nb],
                           dtype=torch.long, device=eng.device)
    order = [i for i, b in enumerate(table) if b < nb] + \
        [i for i, b in enumerate(table) if b >= nb]
    inv = torch.as_tensor(np.argsort(order), dtype=torch.long,
                          device=eng.device)
    out = []
    for cache, mirror in ((eng._kcs, eng._htk), (eng._vcs, eng._htv)):
        both = torch.cat([cache.index_select(1, dev),
                          mirror.index_select(1, virt)], dim=1)
        out.append(both.index_select(1, inv))
    return torch.stack(out)


def sessions(model) -> dict:
    """The 8 two-turn sessions on a tiered engine and turn 2 cold on an
    untiered one. Returns both engines (the caller frees them), the
    mirror steps and the result."""
    vocab = model.config.vocab_size
    rng = np.random.default_rng(1)
    lens = rng.integers(TURN1_LENS[0], TURN1_LENS[1] + 1, size=SESSIONS)
    prompts = [[int(t) for t in rng.integers(1, vocab, size=n)]
               for n in lens]
    extra = [[int(t) for t in rng.integers(1, vocab, size=TURN2_EXTRA)]
             for _ in range(SESSIONS)]
    sp = SamplingParams(max_new_tokens=MAX_NEW_TOKENS)
    eng = tiered_engine(model, SESSION_BLOCKS, SESSION_HOST_BLOCKS)
    times = HostTimes(eng)
    snap = eng._graphs.snapshot()
    for i, p in enumerate(prompts):
        eng.add_request(f"s{i}", p, sampling=sp)
    turn1_wall = _serve(eng)
    bm = eng.block_manager
    turn1, parked, before = [], [], []
    for i in range(SESSIONS):
        rid = f"s{i}"
        turn1.append(list(eng.get_request(rid).generated))
        eng.release_request(rid)
        # the chain turn 1 left (cached-free device blocks), its bytes
        # read before the park moves them
        rec = eng._kvtier.sessions[rid]
        full = (rec.covered // bm.block_size) * bm.block_size
        table = _chain(bm, rec.tokens, full)
        before.append(chain_bytes(eng, table).clone())
        parked.append(eng.park_session(rid))
    eng._kvtier.apply_moves()
    mirror = MirrorSteps(eng)
    hits, after = [], []
    for i in range(SESSIONS):
        prompt2 = prompts[i] + turn1[i] + extra[i]
        hits.append(eng.resume_session(f"t{i}", f"s{i}", prompt2,
                                       sampling=sp))
        eng._kvtier.apply_moves()
        full = (parked[i]["tokens_covered"] // bm.block_size) \
            * bm.block_size
        table = bm.block_table(f"t{i}")[:full // bm.block_size]
        after.append(chain_bytes(eng, table))
    bytes_equal = all(torch.equal(a, b) for a, b in zip(before, after))
    turn2_wall = _serve(eng)
    window = eng._graphs.since(snap)
    turn2 = [list(eng.get_request(f"t{i}").generated)
             for i in range(SESSIONS)]
    kvt = eng._kvtier
    cold = untiered_engine(model)
    for i in range(SESSIONS):
        cold.add_request(f"t{i}", prompts[i] + turn1[i] + extra[i],
                         sampling=sp)
    cold_wall = _serve(cold)
    cold2 = [list(cold.get_request(f"t{i}").generated)
             for i in range(SESSIONS)]
    return {"engine": eng, "cold": cold, "mirror": mirror,
            "window": window, "turn2": turn2, "cold_turn2": cold2,
            "result": {
                "sessions": SESSIONS, "turn1_lens": [int(n) for n in lens],
                "turn2_extra": TURN2_EXTRA,
                "parked_covered": [p["tokens_covered"] for p in parked],
                "parked_demoted": [p["demoted"] for p in parked],
                "resume_hits": hits,
                "resume_hits_equal_parked": hits == [
                    p["tokens_covered"] for p in parked],
                "resumed_chain_bytes_equal": bytes_equal,
                "num_resume_recomputed_tokens":
                    kvt.num_resume_recomputed_tokens,
                "kv_tier_park_resumes": eng.metrics.snapshot()[
                    "serving_kv_tier_park_resumes"],
                "continuation_resumes":
                    eng.scheduler.num_continuation_resumes,
                "turn2_steps": mirror.steps,
                "turn2_mirror_steps": mirror.mirror_steps,
                "turn2_identical_to_cold": turn2 == cold2,
                "turn2_streams_equal_cold": sum(
                    a == b for a, b in zip(turn2, cold2)),
                "turn2_tokens_equal_cold": sum(
                    x == y for a, b in zip(turn2, cold2)
                    for x, y in zip(a, b)),
                "num_demotes": bm.num_demotes,
                "num_promotes": bm.num_promotes,
                "tier_stats": eng.tier_stats(), "host_ms": times.summary(),
                "turn1_wall_s": turn1_wall, "turn2_wall_s": turn2_wall,
                "cold_wall_s": cold_wall}}


def _chain(bm, tokens, full) -> List[int]:
    """The registered blocks (either tier) of ``tokens``' first ``full``
    tokens, walked through the prefix trie."""
    bs = bm.block_size
    key, out = None, []
    for i in range(0, full, bs):
        key = (key, tuple(tokens[i:i + bs]))
        out.append(bm._prefix_index[key])
    return out


def _main():
    import json

    from paddle_tpu_torch.tools import llama3_8b_serve

    dev = torch.device("cuda", 0)
    model = llama3_8b_serve.target_model(dev)
    print(json.dumps(over_pool(model)["result"], default=str))
    print(json.dumps(sessions(model)["result"], default=str))


if __name__ == "__main__":
    _main()
