"""The port's serving engine against the JAX package's.

Greedy token streams of the port's ``LLMEngine`` (CPU, plain attention)
must equal the JAX ragged engine's on the scenarios of
``tests/test_serving_ragged.py``: a chunked mixed workload, preemption,
and prefix-cache copy-on-write. The weights are the JAX tiny model's,
carried across with ``llama_state_from_jax``. Sampled rows ride along
(they shape the batches) but are compared in distribution only
elsewhere: the port's generator is not threefry. A randomized storm of
``BlockManager``/``Scheduler`` operations drives both packages and must
give identical decisions and free lists."""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.serving import EngineConfig as JEngineConfig
from paddle_tpu.serving import LLMEngine as JLLMEngine
from paddle_tpu.serving import SamplingParams as JSamplingParams
from paddle_tpu.serving.block_manager import BlockManager as JBlockManager
from paddle_tpu.serving.block_manager import NoFreeBlocksError as JOOM
from paddle_tpu.serving.request import Request as JRequest
from paddle_tpu.serving.scheduler import Scheduler as JScheduler
from paddle_tpu.serving.scheduler import SchedulerConfig as JSchedulerConfig
from paddle_tpu_torch import profiler as tprofiler
from paddle_tpu_torch.models.convert import llama_state_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams
from paddle_tpu_torch.serving.block_manager import BlockManager
from paddle_tpu_torch.serving.block_manager import NoFreeBlocksError as TOOM
from paddle_tpu_torch.serving.request import Request
from paddle_tpu_torch.serving.scheduler import Scheduler, SchedulerConfig


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JLlama(JLlamaConfig.tiny())
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    tm.load_state_dict(llama_state_from_jax(state))
    return jm, tm


def _prompts(seed, vocab, lens):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, vocab, size=n))) for n in lens]


def _knobs(**kw):
    kw.setdefault("block_size", 4)
    kw.setdefault("max_num_seqs", 4)
    kw.setdefault("max_model_len", 64)
    return dict(ragged=True, chunked_prefill=True, prefix_cache=True, **kw)


def _serve(eng, sp_cls, prompts, samplings):
    rids = [eng.add_request(f"r{i}", p, sampling=sp_cls(**sp))
            for i, (p, sp) in enumerate(zip(prompts, samplings))]
    steps = 0
    while eng.has_unfinished():
        eng.step()
        eng.block_manager.check_invariants()
        steps += 1
        assert steps < 500, "engine failed to converge"
    return [eng.get_request(r).generated for r in rids]


def _both(models, prompts, samplings, **cfg_kw):
    jm, tm = models
    je = JLLMEngine(jm, JEngineConfig(**_knobs(**cfg_kw)))
    te = LLMEngine(tm, EngineConfig(**_knobs(**cfg_kw)))
    return (je, _serve(je, JSamplingParams, prompts, samplings),
            te, _serve(te, SamplingParams, prompts, samplings))


def _greedy_rows(samplings):
    return [i for i, sp in enumerate(samplings)
            if sp.get("temperature", 0.0) <= 0.0]


def test_mixed_workload_greedy_parity(models):
    """Long prompts over the token budget (forced chunks), short
    prompts, a sampled row: every greedy stream equals the JAX engine's,
    with chunked prefills sharing steps with decode rows."""
    prompts = _prompts(21, 256, [29, 3, 22, 6])
    sps = [dict(max_new_tokens=6),
           dict(max_new_tokens=5, temperature=0.8, seed=3),
           dict(max_new_tokens=6), dict(max_new_tokens=4)]
    je, outs_j, te, outs_t = _both(models, prompts, sps,
                                   max_batched_tokens=16)
    for i in _greedy_rows(sps):
        assert outs_t[i] == outs_j[i], i
    assert len(outs_t[1]) == 5
    snap = te.metrics.snapshot()
    assert snap["serving_prefill_chunks"] > 0
    assert snap["mixed_steps"] > 0
    assert snap["padded_token_frac"] == 0.0
    assert te.block_manager.num_free_blocks == te.cfg.num_blocks
    counters = tprofiler.counters()
    assert counters[f"serving/prefill_chunks#{id(te)}"] == \
        snap["serving_prefill_chunks"]


def test_parity_through_preemption(models):
    """A cache too small for the batch to reach full length: both
    engines preempt, greedy streams stay identical, and every block
    comes back."""
    prompts = _prompts(22, 256, [6, 8, 5, 7])
    sps = [dict(max_new_tokens=8), dict(max_new_tokens=8),
           dict(max_new_tokens=8, temperature=0.7, seed=11),
           dict(max_new_tokens=8)]
    je, outs_j, te, outs_t = _both(models, prompts, sps, num_blocks=10,
                                   max_model_len=32)
    assert je.scheduler.num_preemptions > 0
    assert te.scheduler.num_preemptions == je.scheduler.num_preemptions
    for i in _greedy_rows(sps):
        assert outs_t[i] == outs_j[i], i
    assert te.block_manager.num_free_blocks == te.cfg.num_blocks
    te.block_manager.check_invariants()
    assert te.metrics.snapshot()["padded_token_frac"] == 0.0


def test_prefix_cache_hit_cap_and_cow_keep_parity(models):
    """Re-sent identical 12-token prompts (3 full blocks) hit the
    prefix cache; the capped write lands in a shared block -> COW. All
    four streams equal the JAX engine's, and the pool returns to full."""
    jm, tm = models
    prompt = _prompts(23, 256, [12])[0]
    streams = {}
    engines = {}
    for name, eng, sp_cls in (
            ("jax", JLLMEngine(jm, JEngineConfig(**_knobs())),
             JSamplingParams),
            ("torch", LLMEngine(tm, EngineConfig(**_knobs())),
             SamplingParams)):
        waves = []
        for wave in range(2):
            rids = [eng.add_request(f"w{wave}-{i}", list(prompt),
                                    sampling=sp_cls(max_new_tokens=6))
                    for i in range(2)]
            steps = 0
            while eng.has_unfinished():
                eng.step()
                eng.block_manager.check_invariants()
                steps += 1
                assert steps < 200
            waves.append([eng.get_request(r).generated for r in rids])
        streams[name] = waves
        engines[name] = eng
    assert streams["torch"] == streams["jax"]
    w = streams["torch"]
    assert w[0][0] == w[0][1] == w[1][0] == w[1][1]
    bm = engines["torch"].block_manager
    assert bm.num_prefix_hits == engines["jax"].block_manager.num_prefix_hits
    assert bm.num_prefix_hits > 0
    assert 0 < bm.last_hit_tokens < len(prompt)
    assert bm.num_cow_copies > 0
    assert engines["torch"].metrics.snapshot()["serving_cow_copies"] == \
        bm.num_cow_copies
    for rid in [f"w{w}-{i}" for w in range(2) for i in range(2)]:
        engines["torch"].release_request(rid)
    assert bm.num_free_blocks == engines["torch"].cfg.num_blocks


def test_nonfinite_guard_aborts_only_the_poisoned_row(models):
    from paddle_tpu_torch.testing import faults

    _, tm = models
    eng = LLMEngine(tm, EngineConfig(**_knobs()))
    for i, p in enumerate(_prompts(24, 256, [5, 6, 7])):
        eng.add_request(f"p{i}", p, sampling=SamplingParams(max_new_tokens=4))
    with faults.injected(f"{faults.SERVING_NAN_LOGITS}:flag:p1*1"):
        outs = eng.run()
    final = {o.request_id: o for o in outs if o.finished}
    assert final["p1"].finish_reason == "aborted:nonfinite"
    assert final["p0"].finish_reason == final["p2"].finish_reason == "length"
    assert eng.num_poisoned_aborts == 1
    assert eng.block_manager.num_free_blocks == eng.cfg.num_blocks


@pytest.mark.parametrize("knob,value", [
    ("ragged", False), ("tp_degree", 2), ("kv_tiers", True),
    ("swap_mode", "host"), ("step_timeout_s", 1.0),
    ("draft_model", object())])
def test_unported_configurations_raise(knob, value):
    with pytest.raises(ValueError, match="not ported"):
        EngineConfig(**{knob: value})


# ---------------------------------------------------------------------------
# randomized storms through both packages
# ---------------------------------------------------------------------------
def _bm_state(bm):
    return (list(bm._free), {k: list(v) for k, v in bm._tables.items()},
            dict(bm._refs), bm.num_cow_copies, bm.num_prefix_hits)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_manager_storm_identical(seed):
    rng = np.random.default_rng(seed)
    jb = JBlockManager(24, 4, enable_prefix_cache=True)
    tb = BlockManager(24, 4, enable_prefix_cache=True)
    prefixes = _prompts(seed + 100, 5, [8, 12])
    live = {}
    for step in range(300):
        op = rng.integers(0, 4)
        if op == 0 or not live:                       # allocate
            rid = f"q{step}"
            base = prefixes[int(rng.integers(0, 2))]
            toks = base[:int(rng.integers(1, len(base) + 1))] + \
                list(map(int, rng.integers(0, 5, size=rng.integers(0, 6))))
            res = []
            for bm, oom in ((jb, JOOM), (tb, TOOM)):
                try:
                    res.append(bm.allocate(rid, len(toks), tokens=toks))
                except oom:
                    res.append("oom")
            assert res[0] == res[1]
            if res[0] != "oom":
                live[rid] = toks
        elif op == 1:                                 # grow one token
            rid = sorted(live)[int(rng.integers(0, len(live)))]
            live[rid] = live[rid] + [int(rng.integers(0, 5))]
            res = []
            for bm, oom in ((jb, JOOM), (tb, TOOM)):
                try:
                    res.append(bm.append_slot(rid, len(live[rid])))
                except oom:
                    res.append("oom")
            assert res[0] == res[1]
        elif op == 2:                                 # commit + free
            rid = sorted(live)[int(rng.integers(0, len(live)))]
            toks = live.pop(rid)
            for bm in (jb, tb):
                bm.commit_prefix(rid, toks, len(toks))
                bm.free(rid)
        else:                                         # land COW copies
            assert jb.take_cow_pairs() == tb.take_cow_pairs()
        assert _bm_state(jb) == _bm_state(tb)
    jb.take_cow_pairs()
    tb.take_cow_pairs()
    tb.check_invariants()


@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_storm_identical(seed):
    """Random arrivals, priorities and lengths through both mixed
    schedulers; each step the engine's bookkeeping is simulated the same
    way. Every batch (rows, chunk sizes, preemptions) and the free list
    must match."""
    rng = np.random.default_rng(seed)
    sides = []
    for bm_cls, sched_cls, cfg, req_cls in (
            (JBlockManager, JScheduler,
             JSchedulerConfig(max_num_seqs=4, max_batched_tokens=12,
                              chunked_prefill=True), JRequest),
            (BlockManager, Scheduler,
             SchedulerConfig(max_num_seqs=4, max_batched_tokens=12),
             Request)):
        bm = bm_cls(20, 4, enable_prefix_cache=True)
        sides.append((bm, sched_cls(bm, cfg), req_cls, {}))
    arrival = 0.0
    for step in range(120):
        if rng.random() < 0.35:
            n = int(rng.integers(1, 20))
            prompt = list(map(int, rng.integers(0, 3, size=n)))
            prio = int(rng.integers(0, 3))
            new = int(rng.integers(1, 6))
            arrival += 1.0
            for bm, sched, req_cls, reqs in sides:
                sp_mod = (JSamplingParams if req_cls is JRequest
                          else SamplingParams)
                r = req_cls(request_id=f"s{step}", prompt_ids=prompt,
                            sampling=sp_mod(max_new_tokens=new,
                                            priority=prio),
                            arrival_time=arrival)
                reqs[r.request_id] = r
                sched.add(r)
        decisions = []
        for bm, sched, _, reqs in sides:
            batch = sched.schedule()
            decisions.append((batch.kind,
                              [r.request_id for r in batch.requests],
                              list(batch.num_scheduled),
                              [r.request_id for r in batch.preempted]))
            for r, n in zip(batch.requests, batch.num_scheduled):
                r.num_cached += n
                bm.commit_prefix(r.request_id, r.prompt_ids, r.num_cached)
                if r.num_cached < len(r.tokens):
                    continue
                tok = (len(r.tokens) * 7 + 3) % 3
                if r.append_token(tok):
                    sched.finish(r)
            bm.take_cow_pairs()
        assert decisions[0] == decisions[1], step
        assert list(sides[0][0]._free) == list(sides[1][0]._free)
        sides[1][0].check_invariants()


# ---------------------------------------------------------------------------
# engine lifecycle on the port alone
# ---------------------------------------------------------------------------
def test_step_fault_retries_then_succeeds(models):
    from paddle_tpu_torch.testing import faults

    _, tm = models
    prompts = _prompts(25, 256, [7, 4])
    ref = LLMEngine(tm, EngineConfig(**_knobs())).generate(
        prompts, SamplingParams(max_new_tokens=5))
    eng = LLMEngine(tm, EngineConfig(step_retry_backoff_s=0.0, **_knobs()))
    with faults.injected(f"{faults.SERVING_STEP}:raise@1*2"):
        out = eng.generate(prompts, SamplingParams(max_new_tokens=5))
    assert out == ref
    assert eng.num_step_retries == 2
    assert eng.metrics.snapshot()["serving_step_retries"] == 2


def test_step_failure_past_budget_drains_with_structured_outputs(models):
    from paddle_tpu_torch.serving import EngineStepError
    from paddle_tpu_torch.testing import faults

    _, tm = models
    eng = LLMEngine(tm, EngineConfig(max_step_retries=1,
                                     step_retry_backoff_s=0.0, **_knobs()))
    for i, p in enumerate(_prompts(26, 256, [5, 9])):
        eng.add_request(f"e{i}", p, sampling=SamplingParams(max_new_tokens=3))
    with faults.injected(f"{faults.SERVING_STEP}:raise"):
        with pytest.raises(EngineStepError) as info:
            eng.step()
    outs = info.value.outputs
    assert sorted(o.request_id for o in outs) == ["e0", "e1"]
    assert all(o.finish_reason == "aborted:error" for o in outs)
    assert eng.block_manager.num_free_blocks == eng.cfg.num_blocks
    assert not eng.has_unfinished()
    # closed to admission after the failure: a structured rejection
    eng.add_request("late", [1, 2, 3])
    assert [o.finish_reason for o in eng.step()] == ["rejected"]


def test_admission_queue_depth_rejects(models):
    _, tm = models
    eng = LLMEngine(tm, EngineConfig(max_queue_depth=1, **_knobs()))
    eng.add_request("a", [1, 2, 3])
    eng.add_request("b", [4, 5, 6])
    assert eng.get_request("b").finish_reason == "rejected"
    outs = eng.run()
    assert {o.request_id for o in outs if o.finished} == {"a", "b"}
    assert eng.metrics.snapshot()["serving_rejected"] == 1


def test_engine_caches_follow_the_model_device_and_dtype(models):
    _, tm = models
    eng = LLMEngine(tm, EngineConfig(**_knobs()))
    assert eng._kcs.device.type == "cpu"
    assert eng._kcs.dtype == tm.dtype
    cfg = tm.config
    assert tuple(eng._kcs.shape) == (
        cfg.num_hidden_layers, eng.cfg.num_blocks, 4,
        cfg.num_key_value_heads,
        cfg.hidden_size // cfg.num_attention_heads)
