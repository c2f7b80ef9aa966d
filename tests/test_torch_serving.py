"""The port's serving engine against the JAX package's.

Token streams of the port's ``LLMEngine`` (CPU, plain attention) must
equal the JAX ragged engine's on the scenarios of
``tests/test_serving_ragged.py``: a chunked mixed workload, preemption,
and prefix-cache copy-on-write; and the JAX bucketed engine's
(``ragged=False``) on a mixed workload, with the same ``(kind, B, S)``
step keys. The weights are the JAX tiny model's, carried across with
``llama_state_from_jax``. Greedy and sampled rows alike: both packages
draw from the same threefry streams. A randomized storm of
``BlockManager``/``Scheduler`` operations (host swap included) drives
both packages and must give identical decisions and free lists."""
import numpy as np
import pytest
import torch

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
from paddle_tpu_torch.tools.step_checks import bucket_keys, record_step_sizes


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


def _knobs(ragged=True, **kw):
    kw.setdefault("block_size", 4)
    kw.setdefault("max_num_seqs", 4)
    kw.setdefault("max_model_len", 64)
    return dict(ragged=ragged, chunked_prefill=ragged, prefix_cache=ragged,
                **kw)


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
    sizes = record_step_sizes(te)
    out = (je, _serve(je, JSamplingParams, prompts, samplings),
           te, _serve(te, SamplingParams, prompts, samplings))
    if te.cfg.ragged:
        # the port steps at the lattice buckets its step sizes round up
        # to; the JAX engine compiles one shape, its whole budget
        assert te._seen_shapes == bucket_keys(te, sizes)
        assert len(je._seen_shapes) == 1
    else:
        # the bucketed path: the same (kind, B, S) keys
        assert te._seen_shapes == je._seen_shapes
    return out


def test_mixed_workload_greedy_parity(models):
    """Long prompts over the token budget (forced chunks), short
    prompts, sampled rows (a seeded one, top-k and top-p ones seeded by
    their request ids): every stream, greedy and sampled, equals the JAX
    engine's, with chunked prefills sharing steps with decode rows."""
    prompts = _prompts(21, 256, [29, 3, 22, 6, 11, 4])
    sps = [dict(max_new_tokens=6),
           dict(max_new_tokens=5, temperature=0.8, seed=3),
           dict(max_new_tokens=6), dict(max_new_tokens=4),
           dict(max_new_tokens=7, temperature=1.0, top_k=20),
           dict(max_new_tokens=6, temperature=0.7, top_p=0.9)]
    je, outs_j, te, outs_t = _both(models, prompts, sps,
                                   max_batched_tokens=16)
    assert outs_t == outs_j
    for rid in ("r1", "r4", "r5"):
        np.testing.assert_array_equal(te.get_request(rid).device_key,
                                      je.get_request(rid).device_key)
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
    assert outs_t == outs_j
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


def test_bucketed_mixed_workload_parity(models):
    """``ragged=False``: classic prefill-xor-decode batches padded to
    (B, S) buckets through ``forward_paged``. Greedy and sampled
    streams, the ``(kind, B, S)`` keys (checked in ``_both``), the
    padding fraction and the step and preemption counts equal the JAX
    bucketed engine's; a cache too small for the batch forces
    preemption on the way."""
    prompts = _prompts(32, 256, [29, 3, 22, 6, 11, 4])
    sps = [dict(max_new_tokens=6),
           dict(max_new_tokens=5, temperature=0.8, seed=3),
           dict(max_new_tokens=6), dict(max_new_tokens=4),
           dict(max_new_tokens=7, temperature=1.0, top_k=20),
           dict(max_new_tokens=6, temperature=0.7, top_p=0.9)]
    je, outs_j, te, outs_t = _both(models, prompts, sps, ragged=False,
                                   num_blocks=14, max_batched_tokens=32)
    assert outs_t == outs_j
    assert {k[0] for k in te._seen_shapes} == {"prefill", "decode"}
    snap_t, snap_j = te.metrics.snapshot(), je.metrics.snapshot()
    for k in ("padded_token_frac", "engine_steps", "prefill_steps",
              "decode_steps", "preemptions", "serving_sampled_steps"):
        assert snap_t[k] == snap_j[k], k
    assert snap_t["padded_token_frac"] > 0 and snap_t["preemptions"] > 0
    assert te.block_manager.num_free_blocks == te.cfg.num_blocks


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


@pytest.mark.parametrize("knob,value,item", [
    ("tp_degree", 2, "not ported.*C3"),
    ("kv_tiers", True, "kv_tiers needs prefix_cache"),
    ("tenant_id", "t1", "not ported.*item 6")])
def test_unported_configurations_raise(models, knob, value, item):
    """What the port does not serve yet raises at construction, naming
    the queue item that brings it. ``kv_tiers`` is ported: without
    prefix caching it raises the reference's own error, in both
    packages."""
    if knob == "kv_tiers":
        jm, tm = models
        for engine, config, m in ((JLLMEngine, JEngineConfig, jm),
                                  (LLMEngine, EngineConfig, tm)):
            with pytest.raises(ValueError, match=item):
                engine(m, config(block_size=4, max_num_seqs=2,
                                 max_model_len=32, kv_tiers=value,
                                 prefix_cache=False))
        return
    cls = SamplingParams if knob == "tenant_id" else EngineConfig
    with pytest.raises(ValueError, match=item):
        cls(**{knob: value})


@pytest.mark.parametrize("knob,value", [
    ("ragged", False), ("swap_mode", "host"), ("step_timeout_s", 1.0),
    ("drain_grace_s", 5.0), ("num_host_blocks", 4)])
def test_resilience_configurations_construct_and_serve(models, knob, value):
    """The knobs this slice ports construct an engine that serves the
    JAX engine's greedy tokens."""
    prompts = _prompts(31, 256, [7, 5, 9])
    sps = [dict(max_new_tokens=4)] * 3
    kw = ({"ragged": False} if knob == "ragged" else {knob: value})
    je, outs_j, te, outs_t = _both(models, prompts, sps, **kw)
    assert outs_t == outs_j
    assert getattr(te.cfg, knob) == getattr(je.cfg, knob) == value
    assert te.block_manager.num_free_blocks == te.cfg.num_blocks


def test_reference_config_fields_are_taken_and_validated():
    """Every field of the JAX package's ``EngineConfig`` and
    ``SamplingParams.tenant_id`` is taken at its default; out-of-range
    values raise in both packages."""
    import dataclasses

    jfields = {f.name for f in dataclasses.fields(JEngineConfig)}
    assert jfields <= {f.name for f in dataclasses.fields(EngineConfig)}
    defaults = {f.name: f.default for f in dataclasses.fields(JEngineConfig)}
    EngineConfig(**{k: defaults[k] for k in (
        "dtype", "donate_cache", "min_prefill_bucket", "drain_grace_s",
        "num_host_blocks")})
    SamplingParams(tenant_id="default")
    for bad in (dict(min_prefill_bucket=0), dict(num_host_blocks=-1),
                dict(drain_grace_s=-1.0), dict(swap_mode="disk")):
        for cls in (JEngineConfig, EngineConfig):
            with pytest.raises(ValueError):
                cls(**bad)


def test_dtype_sets_the_cache_dtype(models):
    """``EngineConfig(dtype="bfloat16")`` on the f32 tiny model: bf16
    caches in both packages, and the same greedy tokens."""
    prompts = _prompts(27, 256, [9, 4, 13])
    sps = [dict(max_new_tokens=5)] * 3
    je, outs_j, te, outs_t = _both(models, prompts, sps, dtype="bfloat16")
    assert te._kcs.dtype == te._vcs.dtype == torch.bfloat16
    assert str(je._kcs.dtype) == "bfloat16"
    assert outs_t == outs_j


def test_min_prefill_bucket_floors_the_lattice(models):
    _, tm = models
    eng = LLMEngine(tm, EngineConfig(min_prefill_bucket=3,
                                     **_knobs(max_batched_tokens=40)))
    assert eng.step_buckets == (3, 6, 12, 24, 40)
    assert [eng._bucket(n) for n in (1, 3, 4, 13, 25, 40)] == \
        [3, 3, 6, 24, 40, 40]


@pytest.mark.parametrize("case,match", [
    ("draft_only", "BOTH"), ("k_only", "BOTH"), ("negative_k", ">= 0"),
    ("ragged_false", None), ("vocab_mismatch", "tokenizer-width")])
def test_spec_configurations_raise_as_jax(models, case, match):
    """The speculative knobs are refused where the JAX engine refuses
    them: draft model and num_spec_tokens come both or neither, k >= 0,
    the ragged step only (not with ragged=False), and one tokenizer
    width for draft and target."""
    jm, tm = models
    narrow = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=128)
    paddle.seed(5)
    jn = JLlama(JLlamaConfig(**narrow))
    sides = ((JLLMEngine, JEngineConfig, jm, jn),
             (LLMEngine, EngineConfig, tm,
              LlamaForCausalLM(LlamaConfig(**narrow), device="cpu")))
    for eng_cls, cfg_cls, target, narrow_draft in sides:
        kw = {"draft_only": dict(draft_model=target),
              "k_only": dict(num_spec_tokens=2),
              "negative_k": dict(num_spec_tokens=-1),
              "ragged_false": dict(draft_model=target, num_spec_tokens=2,
                                   ragged=False),
              "vocab_mismatch": dict(draft_model=narrow_draft,
                                     num_spec_tokens=2)}[case]
        with pytest.raises(ValueError, match=match):
            eng_cls(target, cfg_cls(**kw))


# ---------------------------------------------------------------------------
# randomized storms through both packages
# ---------------------------------------------------------------------------
def _bm_state(bm):
    return (list(bm._free), {k: list(v) for k, v in bm._tables.items()},
            dict(bm._refs), bm.num_cow_copies, bm.num_prefix_hits,
            list(bm._host_free),
            {k: list(v) for k, v in bm._host_tables.items()},
            dict(bm._host_refs))


@pytest.mark.parametrize("seed,mode", [
    (0, "plain"), (1, "plain"), (2, "plain"), (0, "spec"), (1, "spec"),
    (2, "spec"), (0, "swap"), (1, "swap"), (2, "swap")],
    ids=["0", "1", "2", "spec-0", "spec-1", "spec-2", "swap-0", "swap-1",
         "swap-2"])
def test_block_manager_storm_identical(seed, mode):
    """Allocations, growth, commits and frees, COW landings: identical
    results, tables and free lists in both packages. With ``spec`` the
    growth is a verify row instead: 1+d slots claimed, then a trim to the
    accepted length (the speculative rollback). With ``swap`` it is a
    swap-out of a live request's covered tokens to an 8-slot host pool
    or a swap-in of a swapped one, and frees strike swapped requests
    too: host tables, refcounts and host free lists identical as well."""
    spec, swap = mode == "spec", mode == "swap"
    rng = np.random.default_rng(seed)
    nhb = 8 if swap else 0
    jb = JBlockManager(24, 4, num_host_blocks=nhb, enable_prefix_cache=True)
    tb = BlockManager(24, 4, num_host_blocks=nhb, enable_prefix_cache=True)
    prefixes = _prompts(seed + {"plain": 100, "spec": 200, "swap": 300}[mode],
                        5, [8, 12])
    live, swapped = {}, {}
    n_swaps = 0
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
        elif op == 1 and swap:                        # swap out or in
            if swapped and rng.random() < 0.5:
                rid = sorted(swapped)[int(rng.integers(0, len(swapped)))]
                can = [bm.can_swap_in(rid) for bm in (jb, tb)]
                assert can[0] == can[1]
                if can[0]:
                    res = [bm.swap_in(rid) for bm in (jb, tb)]
                    assert res[0] == res[1]
                    live[rid] = swapped.pop(rid)
            else:
                rid = sorted(live)[int(rng.integers(0, len(live)))]
                n = int(rng.integers(1, len(live[rid]) + 1))
                can = [bm.can_swap_out(rid, n) for bm in (jb, tb)]
                assert can[0] == can[1]
                if can[0]:
                    res = [bm.swap_out(rid, n) for bm in (jb, tb)]
                    assert res[0] == res[1]
                    # only the first n tokens' blocks come back
                    swapped[rid] = live.pop(rid)[:n]
                    n_swaps += 1
        elif op == 1 and spec:                        # verify + rollback
            rid = sorted(live)[int(rng.integers(0, len(live)))]
            n = len(live[rid])
            d = int(rng.integers(0, 5))
            acc = int(rng.integers(0, d + 1))
            res = []
            for bm, oom in ((jb, JOOM), (tb, TOOM)):
                try:
                    res.append(bm.append_slot(rid, n + d, write_from=n - 1))
                    res.append(bm.trim(rid, n + acc))
                except oom:
                    res.append("oom")
            assert res[:len(res) // 2] == res[len(res) // 2:]
            if res[0] != "oom":
                live[rid] = live[rid] + [int(rng.integers(0, 5))] * acc
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
            pool = sorted(live) + sorted(swapped)
            rid = pool[int(rng.integers(0, len(pool)))]
            toks = live.pop(rid, None) or swapped.pop(rid)
            for bm in (jb, tb):
                bm.commit_prefix(rid, toks, len(toks))
                assert bm.free(rid) >= 0
        else:                                         # land COW copies
            assert jb.take_cow_pairs() == tb.take_cow_pairs()
        assert _bm_state(jb) == _bm_state(tb)
    if spec:
        assert tb.trim("nobody", 3) == jb.trim("nobody", 3) == 0
    if swap:
        assert n_swaps > 0, "the storm never swapped"
    jb.take_cow_pairs()
    tb.take_cow_pairs()
    tb.check_invariants()


@pytest.mark.parametrize("seed,spec", [
    (0, False), (1, False), (0, True), (1, True), (2, True)],
    ids=["0", "1", "spec-0", "spec-1", "spec-2"])
def test_scheduler_storm_identical(seed, spec):
    """Random arrivals, priorities and lengths through both mixed
    schedulers; each step the engine's bookkeeping is simulated the same
    way. Every batch (rows, chunk sizes, preemptions) and the free list
    must match. With ``spec``, 0-3 draft tokens are proposed for every
    decode-eligible request before each step and the engine's
    accept/trim bookkeeping is simulated too (1+d verify costs, shed
    drafts); without it no request carries drafts (d = 0)."""
    rng = np.random.default_rng(seed)
    sides = []
    for bm_cls, sched_cls, cfg, req_cls in (
            (JBlockManager, JScheduler,
             JSchedulerConfig(max_num_seqs=4, max_batched_tokens=12,
                              chunked_prefill=True), JRequest),
            (BlockManager, Scheduler,
             SchedulerConfig(max_num_seqs=4, max_batched_tokens=12,
                             chunked_prefill=True), Request)):
        bm = bm_cls(20, 4, enable_prefix_cache=True)
        sides.append((bm, sched_cls(bm, cfg), req_cls, {}))
    arrival = 0.0
    steps, max_new = (150, 9) if spec else (120, 6)
    for step in range(steps):
        if rng.random() < 0.35:
            n = int(rng.integers(1, 20))
            prompt = list(map(int, rng.integers(0, 3, size=n)))
            prio = int(rng.integers(0, 3))
            new = int(rng.integers(1, max_new))
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
        # the proposer: drafts for fully caught-up decode rows, capped by
        # their max_new_tokens headroom, as the engine caps them
        plan = {}
        for r in sorted(sides[0][1].running, key=lambda x: x.request_id):
            if not spec:
                break
            if r.num_generated < 1 or len(r.tokens) - r.num_cached != 1:
                continue
            d = min(int(rng.integers(0, 4)),
                    r.sampling.max_new_tokens - r.num_generated - 1)
            if d > 0:
                plan[r.request_id] = list(map(int, rng.integers(0, 3, d)))
        decisions = []
        for bm, sched, _, reqs in sides:
            for rid, toks in plan.items():
                reqs[rid].draft_tokens = list(toks)
            batch = sched.schedule()
            decisions.append((batch.kind,
                              [r.request_id for r in batch.requests],
                              list(batch.num_scheduled),
                              [r.request_id for r in batch.preempted]))
            for r, n in zip(batch.requests, batch.num_scheduled):
                d = len(r.draft_tokens)
                r.draft_tokens = []
                r.num_cached += n - d
                bm.commit_prefix(r.request_id, r.prompt_ids, r.num_cached)
                if r.num_cached < len(r.tokens):
                    continue
                pre_len = len(r.tokens)
                accepted = (pre_len * 5 + step) % (d + 1)
                finished, appended = False, 0
                for _ in range(accepted + 1):
                    finished = r.append_token((len(r.tokens) * 7 + 3) % 3)
                    appended += 1
                    if finished:
                        break
                r.num_cached = pre_len + min(appended, accepted)
                if finished:
                    sched.finish(r)
                elif d:
                    bm.trim(r.request_id, len(r.tokens))
            bm.take_cow_pairs()
        assert decisions[0] == decisions[1], step
        assert list(sides[0][0]._free) == list(sides[1][0]._free)
        sides[1][0].check_invariants()


# ---------------------------------------------------------------------------
# engine lifecycle on the port alone
# ---------------------------------------------------------------------------
def test_donated_failure_is_not_retried(models):
    """With donated caches (the default on the card) a failed step is not
    retried: every request aborts with a structured output at once."""
    from paddle_tpu_torch.serving import EngineStepError
    from paddle_tpu_torch.testing import faults

    _, tm = models
    assert not LLMEngine(tm, EngineConfig(**_knobs()))._donated
    eng = LLMEngine(tm, EngineConfig(donate_cache=True, max_step_retries=2,
                                     step_retry_backoff_s=0.0, **_knobs()))
    for i, p in enumerate(_prompts(28, 256, [5, 9])):
        eng.add_request(f"d{i}", p, sampling=SamplingParams(max_new_tokens=3))
    with faults.injected(f"{faults.SERVING_STEP}:raise"):
        with pytest.raises(EngineStepError, match="non-retryable") as info:
            eng.step()
    assert eng.num_step_retries == 0
    assert sorted(o.finish_reason for o in info.value.outputs) == \
        ["aborted:error"] * 2
    assert eng.block_manager.num_free_blocks == eng.cfg.num_blocks


@pytest.mark.parametrize("spec", [False, True])
def test_engine_is_freed_without_the_collector(spec):
    """After a run (a spec run: the draft's graphs too), dropping the last
    reference frees the engine, its models and its step graphs at once:
    nothing holds them in a reference cycle, so their memory does not
    wait for the garbage collector."""
    import gc
    import weakref

    def tiny(seed):
        return LlamaForCausalLM(LlamaConfig.tiny(), device="cpu").init_weights(
            torch.Generator().manual_seed(seed))

    extra = dict(draft_model=tiny(1), num_spec_tokens=2) if spec else {}
    eng = LLMEngine(tiny(0), EngineConfig(**_knobs(), **extra))
    eng.generate(_prompts(30, 256, [5, 11]), SamplingParams(max_new_tokens=4))
    assert eng._seen_shapes
    held = [eng, eng.model, eng._graphs]
    if spec:
        assert eng.num_spec_proposed > 0
        held += [eng._spec, eng._spec.graphs, eng.cfg.draft_model]
    gone = [weakref.ref(x) for x in held]
    collecting = gc.isenabled()
    gc.disable()
    try:
        del eng, held, extra
        assert [r() is None for r in gone] == [True] * len(gone)
    finally:
        if collecting:
            gc.enable()


def test_padded_step_equals_the_exact_step(models):
    """At a mixed batch (a prefill chunk beside decode rows, one sampled
    row; 12 live rows in the 16 bucket), ``_device_step`` on the bucket's
    padded buffers and on buffers of the exact token count gives
    identical packed rows and identical cache bytes: the pad
    rows are inert. (Below 6 rows MKL's sgemm takes another kernel,
    whose sums round otherwise, so the live rows alone would differ in
    the last bit: the batch has more.)"""
    from paddle_tpu_torch.tools.step_checks import padding_is_inert

    _, tm = models
    eng = LLMEngine(tm, EngineConfig(**_knobs(max_batched_tokens=16)))
    prompts = _prompts(29, 256, [13, 3, 9, 14])
    for i, p in enumerate(prompts):
        eng.add_request(f"m{i}", p, sampling=SamplingParams(
            max_new_tokens=6, temperature=0.8 if i == 1 else 0.0, seed=i))
    dispatch, checked = eng._dispatch, []

    def checking(reqs, key, arrays):
        n = int(arrays[2][len(reqs)])
        mixed = (any(r.num_generated > 0 for r in reqs)
                 and any(r.num_cached < len(r.prompt_ids) for r in reqs))
        if mixed and n < key[1]:
            checked.append(padding_is_inert(eng, reqs, arrays))
        return dispatch(reqs, key, arrays)

    eng._dispatch = checking
    eng.run()
    assert checked, "no mixed padded step"
    for res in checked:
        assert res["packed"] and res["key_cache"] and res["value_cache"], res
        assert res["widths"][0] > res["widths"][1]


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
