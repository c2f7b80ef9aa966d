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

Phase 27 (``tp_serving_features``) serves at ``tp_degree=2`` what the
fleet, the tiers and speculative decoding bring, each token-identical
to one rank on the same weights in f32 at ``PARITY_LAYERS`` layers:

* :func:`ships_and_handoff` — phase 4's workload exported mid-decode
  from a tp 1 engine and imported by a tp 2 one (every ship a reshard,
  one prompt token computed per request), then the other way round;
  then the fleet hand-off of the JAX package's ``scripts/tp_smoke.py``
  (``fleet_handoff_phase``): a tp 1 replica drained into the tp 2 one,
  clean and under one ``serving.kv_scatter`` fault;
* :func:`spec_parity` — a tp 2 speculative engine whose draft is its
  target (the engine copies the draft before the hand-off) against tp 1;
* the tiers at tp 2 through :func:`paddle_tpu_torch.tools.
  llama3_8b_tiers.over_pool` (``tp=``), and the bf16 full-depth runs
  (the fleet's decode replica at tp 2: :func:`paddle_tpu_torch.tools.
  llama3_8b_fleet.disagg` (``decode=``); :func:`spec_engine`: phase 9's
  draft over a tp 2 target), which ``chip_smoke.py`` measures.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import time
from typing import Dict, List

import torch

from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import EngineConfig, LLMEngine
from paddle_tpu_torch.serving.fleet import (
    FleetConfig, FleetRouter, InProcessReplica,
)
from paddle_tpu_torch.testing import faults, tp_hooks
from paddle_tpu_torch.tools import llama3_8b_fleet as FL
from paddle_tpu_torch.tools import llama3_8b_serve, llama3_8b_spec_serve

__all__ = ["TP", "model", "engine", "serve", "f32_parity", "ship_all",
           "handoff", "ships_and_handoff", "spec_parity", "spec_engine"]

TP = 2
PARITY_LAYERS = 2
# new tokens a request in phase 27 (a)'s f32 spec case (phase 4's 32 cut
# to fit the run's time). Length, not depth: the draft, the target
# itself here, computes the logits of the whole padded width in every
# forward, and at 2 layers those take more than half of its work
SPEC_NEW_TOKENS = 16


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
    _run(eng, 1000)
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


def _run(eng: LLMEngine, max_steps: int = 4000) -> int:
    steps = 0
    while eng.has_unfinished():
        eng.step()
        steps += 1
        assert steps < max_steps, "engine failed to converge"
    return steps


def _sync(eng: LLMEngine):
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)


def _mid_decode(eng: LLMEngine, work, tokens: int = 2) -> LLMEngine:
    """Queue ``work`` on ``eng`` and step until every request has
    emitted ``tokens`` tokens."""
    for rid, prompt, sp in work:
        eng.add_request(rid, prompt, sp)
    steps = 0
    while min(len(eng.get_request(rid).generated)
              for rid, _, _ in work) < tokens:
        eng.step()
        steps += 1
        assert steps < 100, "the workload did not reach its decode"
    return eng


def ship_all(exp: LLMEngine, imp: LLMEngine, work) -> dict:
    """Every request of ``work`` on ``exp`` exported (``export_kv``),
    aborted there and imported into ``imp`` (``import_kv``: the prompt
    and the tokens so far, the rest of its budget, its sampling key);
    ``imp`` then serves them to the end. The tokens (the exporter's, then
    the importer's), the importer's reshards and computed prompt tokens,
    and each ship's host ms (export: the gather and the framing; import:
    the checks and the scatter; each ends in a device synchronise)."""
    done: Dict[str, List[int]] = {}
    export_ms, import_ms, nbytes = [], [], 0
    reshards = imp.num_kv_reshards
    computed = imp.metrics.num_prompt_tokens
    layout = None
    for rid, prompt, sp in work:
        req = exp.get_request(rid)
        done[rid] = list(req.generated)
        key = [int(k) for k in req.device_key]
        t0 = time.perf_counter()
        meta, payload = exp.export_kv(rid)
        _sync(exp)
        export_ms.append((time.perf_counter() - t0) * 1e3)
        exp.abort_request(rid)
        exp.release_request(rid)
        t0 = time.perf_counter()
        imp.import_kv(rid, prompt + done[rid], sampling=dataclasses.replace(
            sp, max_new_tokens=sp.max_new_tokens - len(done[rid])),
            meta=meta, payload=payload, rng_state={"device_key": key})
        _sync(imp)
        import_ms.append((time.perf_counter() - t0) * 1e3)
        nbytes += len(payload)
        layout = meta["layout"]
    _run(imp)
    tokens = {rid: done[rid] + list(imp.get_request(rid).generated)
              for rid, _, _ in work}
    for rid, _, _ in work:
        imp.release_request(rid)
    return {"tokens": tokens, "ships": len(work), "bytes": nbytes,
            "src_layout": layout, "dst_tp_degree": imp.tp_degree,
            "reshards": imp.num_kv_reshards - reshards,
            "computed_prompt_tokens":
                imp.metrics.num_prompt_tokens - computed,
            "export_ms": export_ms, "import_ms": import_ms}


def handoff(m1: LlamaForCausalLM, r2: InProcessReplica, work,
            fault: bool) -> dict:
    """``fleet_handoff_phase`` on ``work``: a tp 1 replica over ``m1``
    and the tp 2 replica ``r2`` behind one router (prefix affinity off:
    ``r2`` has served these prompts before), three router steps, then
    the tp 1 replica retired, its requests shipped to ``r2``; with
    ``fault`` under ``serving.kv_scatter:raise*1`` (one ship falls back
    to recompute)."""
    rids = [rid for rid, _, _ in work]
    r1 = InProcessReplica(m1, EngineConfig(**FL.ENGINE), replica_id="tp1")
    router = FleetRouter([r1, r2], FleetConfig(prefix_affinity=False))
    reshards = r2.engine.num_kv_reshards
    for rid, prompt, sp in work:
        router.add_request(rid, prompt, sp)
    outs = []
    for _ in range(3):
        outs += router.step()
    if fault:
        faults.install(f"{faults.SERVING_KV_SCATTER}:raise*1")
    try:
        router.retire_replica(r1, reason="tp-migration")
        steps = 0
        while router.has_unfinished():
            outs += router.step()
            steps += 1
            assert steps < 4000, "the fleet failed to converge"
    finally:
        faults.clear()
    snap = router.snapshot()
    tokens = {rid: list(router.get_request(rid).generated) for rid in rids}
    for rid in rids:
        r2.release_request(rid)
    return {"tokens": tokens, "fault": fault,
            "finished_once": FL._once(outs, rids),
            "finish": snap["fleet_finish"],
            "ships": snap["fleet_kv_ship_requests"],
            "ship_bytes": snap["fleet_kv_ship_bytes"],
            "tokens_recomputed": snap["fleet_tokens_recomputed"],
            "recompute_fallbacks": snap["fleet_recompute_fallbacks"],
            "handoffs": snap["fleet_handoffs"],
            "reshards": r2.engine.num_kv_reshards - reshards}


def ships_and_handoff(device, layers: int = PARITY_LAYERS,
                      config: LlamaConfig = None) -> dict:
    """Phase 27 (a)'s ships, f32 at ``layers`` layers: one tp 1 model
    (the reference engine, the tp 1 exporters, importers and replicas)
    and one tp 2 replica over a second model from the same seed (its
    engine the tp 2 importer, then the exporter, then the hand-off's
    peer). Each case's tokens against the tp 1 engine's."""
    m1 = model(device, "float32", layers, config)
    work = llama3_8b_serve.workload(m1.config.vocab_size)
    ref = LLMEngine(m1, EngineConfig(**FL.ENGINE))
    for rid, prompt, sp in work:
        ref.add_request(rid, prompt, sp)
    _run(ref)
    want = {rid: list(ref.get_request(rid).generated) for rid, _, _ in work}
    del ref
    with tp_hooks.ranks_share_one_device():
        r2 = InProcessReplica(model(device, "float32", layers, config),
                              EngineConfig(tp_degree=TP, **FL.ENGINE),
                              replica_id="tp2")
    res = {"tp1_to_tp2": ship_all(_mid_decode(LLMEngine(
        m1, EngineConfig(**FL.ENGINE)), work), r2.engine, work)}
    res["tp2_to_tp1"] = ship_all(_mid_decode(r2.engine, work), LLMEngine(
        m1, EngineConfig(**FL.ENGINE)), work)
    res["handoff_clean"] = handoff(m1, r2, work, fault=False)
    res["handoff_fault"] = handoff(m1, r2, work, fault=True)
    for r in res.values():
        got = r.pop("tokens")
        r["tokens_identical"] = sum(got[rid] == want[rid] for rid in want)
        r["requests"] = len(want)
    procs = list(r2.engine._tp._procs)
    del r2
    gc.collect()
    res["workers_exited"] = not any(p.is_alive() for p in procs)
    return res


def spec_parity(device, layers: int = PARITY_LAYERS,
                config: LlamaConfig = None) -> dict:
    """Phase 4's prompts with ``SPEC_NEW_TOKENS`` new tokens each through
    a tp 1 and a tp 2 speculative engine (``llama3_8b_spec_serve.
    NUM_SPEC_TOKENS`` drafts a row), f32 at ``layers`` layers, each over
    its own model from seed 0 whose draft is the target itself: the
    tokens and the draft counters."""
    out = {}
    for tp in (1, TP):
        m = model(device, "float32", layers, config)
        eng = engine(m, tp, draft_model=m,
                     num_spec_tokens=llama3_8b_spec_serve.NUM_SPEC_TOKENS)
        for rid, prompt, sp in llama3_8b_serve.workload(
                m.config.vocab_size):
            eng.add_request(rid, prompt, dataclasses.replace(
                sp, max_new_tokens=SPEC_NEW_TOKENS))
        _run(eng)
        tokens = {rid: list(r.generated)
                  for rid, r in eng._requests.items()}
        out[tp] = {"tokens": tokens, "proposed": eng.num_spec_proposed,
                   "accepted": eng.num_spec_accepted,
                   "draft_is_a_copy": eng._spec.model is not eng.model}
        del eng, m
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    same = {rid: out[1]["tokens"][rid] == out[TP]["tokens"][rid]
            for rid in out[1]["tokens"]}
    return {"layers": layers, "dtype": "float32", "tp": TP,
            "new_tokens": SPEC_NEW_TOKENS,
            "num_spec_tokens": llama3_8b_spec_serve.NUM_SPEC_TOKENS,
            "token_identical": all(same.values()), "per_request": same,
            **{f"tp{tp}": {k: v for k, v in r.items() if k != "tokens"}
               for tp, r in out.items()}}


def spec_engine(device, tp: int = TP, layers: int = None) -> LLMEngine:
    """Phase 9's configuration (phase 4's bf16 target, the
    Llama-3.2-1B-width draft proposing ``NUM_SPEC_TOKENS``) with the
    target at ``tp_degree=tp`` (``layers``: its depth cut to that many),
    every rank on ``device``, warmed up by a request long enough to
    verify one draft."""
    eng = engine(llama3_8b_serve.target_model(device, layers), tp,
                 draft_model=llama3_8b_spec_serve.draft_model(device),
                 num_spec_tokens=llama3_8b_spec_serve.NUM_SPEC_TOKENS)
    return llama3_8b_serve.warm_up(
        eng, 2 + llama3_8b_spec_serve.NUM_SPEC_TOKENS)


if __name__ == "__main__":
    print(json.dumps(f32_parity(torch.device("cuda", 0))))
