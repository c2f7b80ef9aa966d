"""The port's one-card serving resilience and bucketed path against the
JAX package's.

Every scenario runs through both packages on ``LlamaConfig.tiny`` in f32,
the weights carried across with ``llama_state_from_jax``: tokens, finish
reasons, counters and block accounting must match exactly. The scenarios
are the reference's own (``tests/test_serving.py`` swap accounting,
scheduler swap, pool exhaustion, a torn spill and the abort storm;
``tests/test_serving_resilience.py`` SIGTERM, zero-grace drain, swap vs
recompute, forced OOM, the watchdog and the counters;
``tests/test_serving_ragged.py`` ``ragged=False`` resolution;
``tests/test_serving_engine.py`` ``forward_paged`` and ``generate``),
plus ``block_multihead_attention`` on random GQA inputs, the refusals
that remain, and the port's own watchdog and freeing checks."""
import gc
import time
import weakref

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as tpaddle
from paddle_tpu import profiler as jprofiler
from paddle_tpu.distributed.watchdog import PreemptionMonitor as JMonitor
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.serving import EngineConfig as JEngineConfig
from paddle_tpu.serving import EngineStepError as JEngineStepError
from paddle_tpu.serving import LLMEngine as JLLMEngine
from paddle_tpu.serving import SamplingParams as JSamplingParams
from paddle_tpu.serving import StepHungError as JStepHungError
from paddle_tpu.serving.block_manager import BlockManager as JBlockManager
from paddle_tpu.serving.block_manager import NoFreeBlocksError as JOOM
from paddle_tpu.serving.request import Request as JRequest
from paddle_tpu.serving.request import RequestStatus as JStatus
from paddle_tpu.serving.scheduler import Scheduler as JScheduler
from paddle_tpu.serving.scheduler import SchedulerConfig as JSchedulerConfig
from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch import profiler as tprofiler
from paddle_tpu_torch.distributed import watchdog as twatchdog
from paddle_tpu_torch.models.convert import llama_state_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import (EngineConfig, EngineStepError,
                                      LLMEngine, SamplingParams,
                                      StepHungError)
from paddle_tpu_torch.serving.block_manager import BlockManager
from paddle_tpu_torch.serving.block_manager import NoFreeBlocksError as TOOM
from paddle_tpu_torch.serving.request import Request, RequestStatus
from paddle_tpu_torch.serving.scheduler import Scheduler, SchedulerConfig
from paddle_tpu_torch.testing import faults as tfaults

JAX = dict(engine=JLLMEngine, config=JEngineConfig, sp=JSamplingParams,
           faults=jfaults, monitor=JMonitor, hung=JStepHungError,
           step_error=JEngineStepError, bm=JBlockManager, oom=JOOM,
           sched=JScheduler, sched_cfg=JSchedulerConfig, req=JRequest,
           status=JStatus, profiler=jprofiler)
TORCH = dict(engine=LLMEngine, config=EngineConfig, sp=SamplingParams,
             faults=tfaults, monitor=twatchdog.PreemptionMonitor,
             hung=StepHungError, step_error=EngineStepError,
             bm=BlockManager, oom=TOOM, sched=Scheduler,
             sched_cfg=SchedulerConfig, req=Request, status=RequestStatus,
             profiler=tprofiler)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JLlama(JLlamaConfig.tiny())
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    tm.load_state_dict(llama_state_from_jax(state))
    return jm, tm


@pytest.fixture(autouse=True)
def _no_fault_leak():
    yield
    jfaults.clear()
    tfaults.clear()


def _sides(models):
    jm, tm = models
    return ((JAX, jm), (TORCH, tm))


def _prompts(seed, vocab, lens):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, vocab, size=n))) for n in lens]


def _drive(eng, collect=None, max_steps=500):
    outs, steps = [], 0
    while eng.has_unfinished():
        outs.extend(eng.step())
        eng.block_manager.check_invariants()
        steps += 1
        assert steps < max_steps, "engine failed to converge"
        if collect is not None:
            collect(eng, steps)
    return outs


def _final(outs):
    return {o.request_id: (o.finish_reason, list(o.generated), o.token)
            for o in outs if o.finished}


# ---------------------------------------------------------------------------
# the host pool and the scheduler's swap, model-free (tests/test_serving.py)
# ---------------------------------------------------------------------------
class _StubSwapper:
    """Model-free KV mover: records traffic, moves no bytes."""

    def __init__(self):
        self.out_calls, self.in_calls = [], []

    def copy_out(self, request, dev_table, host_table):
        self.out_calls.append((request.request_id, list(dev_table),
                               list(host_table)))

    def copy_in(self, request, host_table, dev_table):
        self.in_calls.append((request.request_id, list(host_table),
                              list(dev_table)))


class _TornSwapper(_StubSwapper):
    def copy_out(self, request, dev_table, host_table):
        raise RuntimeError("DMA torn mid-frame")


def _bm_accounting(side):
    bm = side["bm"](num_blocks=4, block_size=2, num_host_blocks=3)
    bm.allocate("a", 5)
    log = [bm.can_swap_out("a", 5)]
    dev, host = bm.swap_out("a", 5)
    log += [dev, host, bm.num_free_blocks, bm.num_free_host_blocks,
            bm.has_table("a"), bm.has_host_table("a")]
    bm.check_invariants()
    host2, dev2 = bm.swap_in("a")
    log += [host2, dev2, bm.num_free_host_blocks, bm.num_free_blocks]
    bm.check_invariants()
    log.append(bm.free("a"))
    bm.check_invariants()
    return log


def test_block_manager_swap_accounting():
    j, t = _bm_accounting(JAX), _bm_accounting(TORCH)
    assert t == j
    can, dev, host, free, hfree, has_dev, has_host = t[:7]
    assert can and len(dev) == len(host) == 3
    assert (free, hfree, has_dev, has_host) == (4, 0, False, True)
    host2, dev2, hfree2, free2, freed = t[7:]
    assert host2 == host and len(dev2) == 3
    assert (hfree2, free2, freed) == (3, 1, 3)


def _bm_small_pool(side):
    bm = side["bm"](num_blocks=8, block_size=2, num_host_blocks=1)
    bm.allocate("a", 6)                      # needs 3 host slots
    log = [bm.can_swap_out("a", 6)]
    with pytest.raises(side["oom"], match="swap out"):
        bm.swap_out("a", 6)
    bm0 = side["bm"](num_blocks=4, block_size=2)
    bm0.allocate("a", 2)
    return log + [bm0.can_swap_out("a", 2), bm.num_free_host_blocks]


def test_block_manager_swap_rejects_when_pool_small():
    assert _bm_small_pool(TORCH) == _bm_small_pool(JAX) == [False, False, 1]


def _bm_free_host(side):
    bm = side["bm"](num_blocks=4, block_size=2, num_host_blocks=4)
    bm.allocate("a", 4)
    bm.swap_out("a", 4)
    log = [bm.num_free_host_blocks, bm.free("a"), bm.num_free_host_blocks,
           bm.free("a")]
    bm.check_invariants()
    return log


def test_block_manager_free_releases_host_slots_too():
    """The abort-while-swapped leak class: free() drops BOTH sides, and
    is idempotent."""
    assert _bm_free_host(TORCH) == _bm_free_host(JAX) == [2, 0, 4, 0]


def _two_requests(side, swapper, num_host_blocks):
    bm = side["bm"](num_blocks=4, block_size=2,
                    num_host_blocks=num_host_blocks)
    s = side["sched"](bm, side["sched_cfg"](max_num_seqs=4),
                      swap_mode="host", kv_swapper=swapper)
    reqs = []
    for rid, arrival in (("a", 1.0), ("b", 2.0)):
        r = side["req"](request_id=rid, prompt_ids=[1, 2, 3, 4],
                        sampling=side["sp"](max_new_tokens=8))
        r.arrival_time = arrival
        s.add(r)
        reqs.append(r)
    s.schedule()                             # both prefill, cache full
    for r in reqs:
        r.num_cached += len(r.tokens_to_run())
        r.append_token(7)
    batch = s.schedule()                     # OOM -> b is the victim
    return bm, s, reqs, batch


def _batch(batch):
    return (batch.kind, [r.request_id for r in batch.requests],
            [r.request_id for r in batch.preempted],
            [r.request_id for r in batch.swapped_in])


def _swap_restore(side):
    sw = _StubSwapper()
    bm, s, (a, b), batch = _two_requests(side, sw, 4)
    log = [_batch(batch), b.status.value, b.num_cached, b.num_swaps,
           s.num_swap_outs, list(sw.out_calls)]
    bm.check_invariants()
    a.num_cached += 1
    while not a.append_token(7):
        pass
    s.finish(a)
    batch = s.schedule()
    log += [_batch(batch), b.status.value, s.num_swap_ins,
            list(sw.in_calls), bm.block_table("b")]
    bm.check_invariants()
    return log


def test_scheduler_swap_preempts_and_restores():
    """Eviction with a host pool spills instead of recomputing: the
    victim keeps num_cached, rejoins running via swap-in when blocks
    free, and the swapper sees matching out/in traffic."""
    t = _swap_restore(TORCH)
    assert t == _swap_restore(JAX)
    assert t[0] == ("decode", ["a"], ["b"], [])
    assert t[1:5] == ["swapped", 4, 1, 1] and len(t[5]) == 1
    assert t[6] == ("decode", ["b"], [], ["b"])
    assert t[7:9] == ["running", 1] and len(t[9]) == 1
    assert len(t[10]) >= 2


def _pool_exhausted(side):
    sw = _StubSwapper()
    bm, s, (a, b), batch = _two_requests(side, sw, 1)
    bm.check_invariants()
    return [_batch(batch), b.status.value, b.num_cached, s.num_swap_outs,
            sw.out_calls]


def test_scheduler_host_pool_exhaustion_falls_back_to_recompute():
    t = _pool_exhausted(TORCH)
    assert t == _pool_exhausted(JAX)
    assert t == [("decode", ["a"], ["b"], []), "waiting", 0, 0, []]


def _torn(side):
    bm, s, (a, b), batch = _two_requests(side, _TornSwapper(), 4)
    bm.check_invariants()
    return [_batch(batch), b.status.value, b.num_cached, s.num_swap_outs,
            bm.has_host_table("b"), bm.num_free_host_blocks]


def test_scheduler_torn_spill_copy_frees_host_slots():
    """A copy_out that dies mid-spill does not strand the victim's host
    slots: they come back and the victim demotes to recompute."""
    t = _torn(TORCH)
    assert t == _torn(JAX)
    assert t == [("decode", ["a"], ["b"], []), "waiting", 0, 0, False, 4]


def test_randomized_abort_interleaving_never_leaks_blocks():
    """The reference's abort storm through both schedulers in lockstep:
    admission, decode, preemption (swap AND recompute), expiry and
    aborts in every lifecycle state. Every batch and both free lists
    match the JAX scheduler's, and at the end nothing leaks on either
    side of the pool."""
    rng = np.random.default_rng(7)
    sides = []
    for side in (JAX, TORCH):
        bm = side["bm"](num_blocks=10, block_size=2, num_host_blocks=4)
        s = side["sched"](bm, side["sched_cfg"](max_num_seqs=3,
                                                max_batched_tokens=32),
                          swap_mode="host", kv_swapper=_StubSwapper())
        sides.append((side, bm, s, []))
    n_aborted = 0

    def step():
        toks = None
        decisions = []
        for side, bm, s, reqs in sides:
            batch = s.schedule()
            decisions.append(_batch(batch))
            if toks is None:
                toks = [int(rng.integers(0, 100)) for _ in batch.requests]
            for r, tok in zip(batch.requests, toks):
                r.num_cached += len(r.tokens_to_run())
                if r.append_token(tok):
                    s.finish(r)
            bm.check_invariants()
        assert decisions[0] == decisions[1]
        assert list(sides[0][1]._free) == list(sides[1][1]._free)
        assert sides[0][1]._host_free == sides[1][1]._host_free

    def abort(i):
        found = [s.abort(reqs[i].request_id) for _, _, s, reqs in sides]
        assert found[0] == found[1]
        return found[0]

    for it in range(400):
        if len(sides[0][3]) < 24 and rng.random() < 0.25:
            n = int(rng.integers(2, 9))
            new = int(rng.integers(1, 6))
            prio = int(rng.integers(-1, 2))
            # a TTL from an arrival far in the past: the request expires
            # at its first sweep, on both sides alike
            dl = (float(rng.integers(1, 20)) if rng.random() < 0.3
                  else None)
            for side, _, s, reqs in sides:
                r = side["req"](
                    request_id=f"r{len(reqs)}",
                    prompt_ids=list(range(1, n)),
                    sampling=side["sp"](max_new_tokens=new, priority=prio,
                                        deadline_ms=dl))
                r.arrival_time = float(it)
                reqs.append(r)
                s.add(r)
        if rng.random() < 0.15:
            live = [i for i, r in enumerate(sides[0][3])
                    if not r.is_finished]
            if live:
                assert abort(live[int(rng.integers(0, len(live)))])
                n_aborted += 1
        if not sides[0][2].has_unfinished():
            continue
        step()
    guard = 0
    while sides[0][2].has_unfinished():
        guard += 1
        assert guard < 300, "storm failed to converge"
        live = [i for i, r in enumerate(sides[0][3]) if not r.is_finished]
        if live and rng.random() < 0.3:
            abort(live[0])
            n_aborted += 1
        step()
    assert n_aborted > 0
    for side, bm, s, reqs in sides:
        assert len(reqs) == 24 and all(r.is_finished for r in reqs)
        assert bm.num_free_blocks == bm.num_blocks
        assert bm.num_free_host_blocks == bm.num_host_blocks
        bm.check_invariants()
    assert sides[1][2].num_swap_outs == sides[0][2].num_swap_outs
    assert [r.finish_reason for r in sides[1][3]] == \
        [r.finish_reason for r in sides[0][3]]


# ---------------------------------------------------------------------------
# engine resilience (tests/test_serving_resilience.py), both packages
# ---------------------------------------------------------------------------
def _sigterm_run(side, model, prompts):
    eng = side["engine"](model, side["config"](
        block_size=4, max_num_seqs=4, max_model_len=64))
    monitor = side["monitor"]()
    eng.install_preemption_handler(monitor)
    sp = side["sp"](max_new_tokens=6)
    try:
        # a REAL SIGTERM, delivered by the fault point after the prefill
        # and two decode steps
        side["faults"].install("serving.step:sigterm@2*1")
        rids = [eng.add_request(p, sampling=sp) for p in prompts]
        outs = _drive(eng)
    finally:
        monitor.uninstall()
        side["faults"].clear()
    res = dict(final=_final(outs), rids=rids, drained=eng.drained,
               draining=eng.is_draining,
               counters=(eng.num_drains_started, eng.num_drain_aborted,
                         eng.num_drains_completed),
               free=eng.block_manager.num_free_blocks == eng.cfg.num_blocks)
    late = eng.add_request(prompts[0], sampling=sp)
    res["late"] = eng.get_request(late).finish_reason
    res["rejected"] = eng.num_rejected
    res["pending"] = [o.finish_reason for o in eng.step()]
    res["after"] = eng.step()
    return res


def test_sigterm_mid_run_drains_gracefully(models):
    """8 requests, 4 running + 4 waiting, a real SIGTERM mid-decode: the
    running half completes with the JAX engine's tokens, the waiting half
    returns structured ``aborted:drain`` outputs with no tokens, every
    block returns, a late arrival is rejected. Identical in both
    packages."""
    prompts = _prompts(10, 256, [3, 5, 7, 4, 6, 2, 5, 3])
    j, t = (_sigterm_run(side, m, prompts) for side, m in _sides(models))
    assert t == j
    reasons = [t["final"][r][0] for r in t["rids"]]
    assert reasons.count("length") == 4
    assert reasons.count("aborted:drain") == 4
    assert all(t["final"][r][1:] == ([], None) for r in t["rids"]
               if t["final"][r][0] == "aborted:drain")
    assert t["drained"] and t["draining"] and t["free"]
    assert t["counters"] == (1, 4, 1)
    assert (t["late"], t["rejected"], t["pending"], t["after"]) == \
        ("rejected", 1, ["rejected"], [])


def _zero_grace(side, model, prompts):
    eng = side["engine"](model, side["config"](
        block_size=4, max_num_seqs=2, max_model_len=64))
    sp = side["sp"](max_new_tokens=8)
    rids = [eng.add_request(p, sampling=sp) for p in prompts]
    for _ in range(3):            # prefill + 2 decodes
        eng.step()
    outs = eng.drain(grace_s=0.0)
    return dict(final=_final(outs), rids=rids, drained=eng.drained,
                free=eng.block_manager.num_free_blocks == eng.cfg.num_blocks,
                counters=(eng.num_drains_started, eng.num_drain_aborted,
                          eng.num_drains_completed))


def test_drain_api_grace_budget_aborts_stragglers(models):
    """A zero-grace drain cannot wait for the running batch: everything
    in flight aborts with ``aborted:drain``, keeping its partial
    progress."""
    prompts = _prompts(11, 256, [4, 6])
    j, t = (_zero_grace(side, m, prompts) for side, m in _sides(models))
    assert t == j
    assert all(t["final"][r][0] == "aborted:drain"
               and len(t["final"][r][1]) == 3 for r in t["rids"])
    assert t["drained"] and t["free"]


def _swap_vs_recompute(side, model, prompts, mode):
    eng = side["engine"](model, side["config"](
        block_size=4, num_blocks=10, max_num_seqs=4, max_model_len=32,
        swap_mode=mode))
    sp = side["sp"](max_new_tokens=8)
    rids = [eng.add_request(p, sampling=sp) for p in prompts]
    _drive(eng)
    snap = eng.metrics.snapshot()
    sch = eng.scheduler
    return dict(
        tokens=[eng.get_request(r).generated for r in rids],
        counts=(sch.num_preemptions, sch.num_swap_outs, sch.num_swap_ins),
        swaps=[eng.get_request(r).num_swaps for r in rids],
        free=(eng.block_manager.num_free_blocks == eng.cfg.num_blocks,
              eng.block_manager.num_free_host_blocks
              == eng.cfg.num_host_blocks),
        gauges={k: snap[k] for k in (
            "serving_swapped_out", "serving_swapped_in",
            "serving_num_swapped", "preemptions", "kv_host_blocks_total")})


def test_swap_preemption_token_parity_with_recompute(models):
    """A cache too small for the batch: ``swap_mode='host'`` preempts by
    host spill and gives the recompute path's tokens, both equal to the
    JAX engine's in either mode, with the same swap counters."""
    prompts = _prompts(15, 256, [6, 8, 5, 7])
    runs = {(side["engine"].__module__.split(".")[0], mode):
            _swap_vs_recompute(side, m, prompts, mode)
            for side, m in _sides(models) for mode in ("recompute", "host")}
    jr, jh = runs[("paddle_tpu", "recompute")], runs[("paddle_tpu", "host")]
    tr = runs[("paddle_tpu_torch", "recompute")]
    th = runs[("paddle_tpu_torch", "host")]
    assert tr == jr and th == jh
    assert th["tokens"] == tr["tokens"]
    assert tr["counts"][0] > 0 and tr["counts"][1:] == (0, 0)
    assert th["counts"][1] > 0 and th["counts"][1] == th["counts"][2]
    assert th["free"] == (True, True)
    assert th["gauges"]["serving_swapped_out"] == th["counts"][1]
    assert th["gauges"]["kv_host_blocks_total"] == 10


def _forced_oom(side, model, prompts):
    eng = side["engine"](model, side["config"](
        block_size=4, max_num_seqs=4, max_model_len=64, swap_mode="host"))
    sp = side["sp"](max_new_tokens=6)
    rids = [eng.add_request(p, sampling=sp) for p in prompts]
    # the victim is the SECOND request, on its first two block growths
    side["faults"].install(f"serving.force_oom.{rids[1]}:flag*2")
    outs = _drive(eng)
    side["faults"].clear()
    return dict(final=_final(outs),
                preemptions=eng.scheduler.num_preemptions,
                swaps=[(eng.get_request(r).num_swaps,
                        eng.get_request(r).num_preemptions) for r in rids],
                free=(eng.block_manager.num_free_blocks,
                      eng.block_manager.num_free_host_blocks))


def test_forced_oom_injection_targets_a_request(models):
    prompts = _prompts(16, 256, [5, 4, 6])
    j, t = (_forced_oom(side, m, prompts) for side, m in _sides(models))
    assert t == j
    assert t["preemptions"] > 0 and sum(sum(x) for x in t["swaps"]) > 0
    assert all(f[0] == "length" for f in t["final"].values())


def _hung(side, model, prompt):
    eng = side["engine"](model, side["config"](
        block_size=4, max_num_seqs=2, max_model_len=64,
        step_timeout_s=0.1))
    rid = eng.add_request(prompt, sampling=side["sp"](max_new_tokens=6))
    # the third step is warm, with a 0.1 s deadline, and sleeps 0.5 s
    side["faults"].install("serving.step:sleep:0.5@2*1")
    with pytest.raises(side["hung"], match="watchdog deadline") as ei:
        _drive(eng)
    side["faults"].clear()
    assert isinstance(ei.value, side["step_error"])
    # (where the deadline strikes first depends on the host's speed: a
    # slow cold step may outlast its allowance too; the outcome does not)
    return dict(reasons=[o.finish_reason for o in ei.value.outputs],
                finished=eng.get_request(rid).is_finished,
                unfinished=eng.has_unfinished(),
                free=eng.block_manager.num_free_blocks == eng.cfg.num_blocks,
                late=eng.get_request(eng.add_request(prompt)).finish_reason)


def test_hung_step_watchdog_fails_engine_with_drain_semantics(models):
    """A warm step that blows through the watchdog deadline surfaces as
    StepHungError once it completes, every request aborted with a
    structured output, and the engine closed to admission."""
    p = _prompts(21, 256, [5])[0]
    j, t = (_hung(side, m, p) for side, m in _sides(models))
    assert t == j
    assert t["reasons"] == ["aborted:error"]
    assert t["finished"] and not t["unfinished"] and t["free"]
    assert t["late"] == "rejected"


def test_watchdog_armed_run_has_no_false_alarm(models):
    """A whole workload with a deadline the CPU steps meet: tokens equal
    the JAX engine's and nothing fires."""
    prompts = _prompts(33, 256, [9, 4, 13])
    outs = []
    for side, m in _sides(models):
        eng = side["engine"](m, side["config"](
            block_size=4, max_num_seqs=4, max_model_len=64,
            step_timeout_s=5.0))
        outs.append(eng.generate(prompts, side["sp"](max_new_tokens=5)))
    assert outs[1] == outs[0]
    assert not eng._watchdog.fired and eng._hung_tags is None


def _counters(side, model, prompt):
    eng = side["engine"](model, side["config"](
        block_size=4, max_num_seqs=2, max_model_len=64, swap_mode="host",
        max_queue_depth=0))
    rid = eng.add_request(prompt, sampling=side["sp"](max_new_tokens=2))
    c = side["profiler"].counters()
    snap = eng.metrics.snapshot()
    return dict(reason=eng.get_request(rid).finish_reason,
                counters={g: c[f"serving/{g}#{id(eng)}"] for g in (
                    "rejected", "swapped_out", "swapped_in", "num_swapped",
                    "expired", "poisoned_aborts", "step_retries",
                    "drain_started", "drain_aborted", "drain_completed",
                    "finish/aborted:drain", "finish/rejected")},
                snap={k: snap[k] for k in (
                    "serving_rejected", "serving_swapped_out",
                    "serving_drain_started", "serving_finish/aborted:drain",
                    "kv_host_blocks_total")})


def test_resilience_counters_via_profiler(models):
    """The swap and drain gauges ride the counter providers like every
    other serving metric, with the JAX engine's values."""
    p = _prompts(22, 256, [4])[0]
    j, t = (_counters(side, m, p) for side, m in _sides(models))
    assert t == j
    assert t["reason"] == "rejected" and t["counters"]["rejected"] == 1
    assert t["snap"]["kv_host_blocks_total"] == 32   # = num_blocks


# ---------------------------------------------------------------------------
# the bucketed path (tests/test_serving_ragged.py, test_serving_engine.py)
# ---------------------------------------------------------------------------
def test_ragged_is_the_default_and_the_bucketed_path_resolves(models):
    res = []
    for side, m in _sides(models):
        kw = dict(block_size=4, max_num_seqs=2, max_model_len=32)
        eng = side["engine"](m, side["config"](**kw))
        eng_b = side["engine"](m, side["config"](ragged=False, **kw))
        res.append((eng._ragged, eng.cfg.chunked_prefill,
                    eng.cfg.prefix_cache, eng_b._ragged,
                    eng_b.cfg.chunked_prefill, eng_b.cfg.prefix_cache))
    assert res[1] == res[0] == (True, True, True, False, False, False)


@pytest.mark.parametrize("kw,match", [
    (dict(ragged=True, chunked_prefill=False), "chunked_prefill"),
    (dict(ragged=False, prefix_cache=True), "prefix_cache"),
    (dict(ragged=False, tp_degree=2), "tp_degree"),
    (dict(ragged=False, kv_tiers=True), "kv_tiers")])
def test_invalid_knob_combinations_raise(models, kw, match):
    """As in the reference, at construction. The bucketed path refuses
    ``tp_degree > 1`` and ``kv_tiers`` (``kv_tiers`` rides the ragged
    step in both packages; the port refuses ``tp_degree > 1`` on every
    path, naming C3)."""
    for side, m in _sides(models):
        with pytest.raises(ValueError, match=match):
            side["engine"](m, side["config"](
                block_size=4, max_num_seqs=2, max_model_len=32, **kw))


def test_forward_paged_matches_jax_and_forward(models):
    """A padded prefill batch (row 0: 6 tokens, row 1: 3 tokens padded
    to 6, row 2: padding) then a decode step continuing rows 0 and 1:
    logits within 1e-4 of the JAX ``forward_paged``, caches likewise; the
    prefill rows' logits within 1e-5 of the port's own dense
    ``forward``."""
    jm, tm = models
    cfg = tm.config
    rng = np.random.default_rng(0)
    L, kh = cfg.num_hidden_layers, cfg.num_key_value_heads
    hd = cfg.hidden_size // cfg.num_attention_heads
    ids = rng.integers(0, cfg.vocab_size, size=(3, 6)).astype(np.int32)
    ids[1, 3:] = 0
    ids[2] = 0
    bt = np.asarray([[0, 1, -1], [2, 3, -1], [-1, -1, -1]], np.int32)
    kcs = np.zeros((L, 8, 4, kh, hd), np.float32)
    steps = [(ids, np.asarray([6, 3, 0], np.int32),
              np.asarray([0, 0, 0], np.int32),
              np.asarray([6, 3, 0], np.int32))]
    nxt = rng.integers(0, cfg.vocab_size, size=(3, 1)).astype(np.int32)
    steps.append((nxt, np.zeros(3, np.int32),
                  np.asarray([6, 3, 0], np.int32),
                  np.asarray([1, 1, 0], np.int32)))
    jk, jv = kcs, kcs.copy()
    tk, tv = torch.zeros(kcs.shape), torch.zeros(kcs.shape)
    tbt = torch.from_numpy(bt)
    for ids_s, enc, dec, now in steps:
        jl, jk, jv = jm.forward_paged(ids_s, jk, jv, bt, enc, dec, now)
        tl, _, _ = tm.forward_paged(
            torch.from_numpy(ids_s), tk, tv, tbt, torch.from_numpy(enc),
            torch.from_numpy(dec), torch.from_numpy(now))
        live = now > 0
        np.testing.assert_allclose(tl.numpy()[live], jl.numpy()[live],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv),
                                   rtol=1e-4, atol=1e-4)
        if dec.max() == 0:
            with torch.no_grad():
                dense = [tm(torch.from_numpy(ids_s[i:i + 1, :n]))[0, -1]
                         for i, n in enumerate(now) if n]
            np.testing.assert_allclose(
                tl.numpy()[live], torch.stack(dense).numpy(),
                rtol=1e-5, atol=1e-5)


def test_generate_cached_equals_naive_equals_jax(models):
    """``generate`` through the cached serving engine, the naive
    recompute loop, and the JAX model's generate give the same tokens;
    the engine is cached and reused."""
    jm, tm = models
    ids = np.random.default_rng(3).integers(
        0, tm.config.vocab_size, size=(2, 7)).astype(np.int32)
    j = jm.generate(paddle.to_tensor(ids), max_new_tokens=5).numpy()
    x = torch.from_numpy(ids)
    cached = tm.generate(x, max_new_tokens=5)
    eng = tm._serving_engine
    naive = tm.generate(x, max_new_tokens=5, use_cache=False)
    again = tm.generate(x, max_new_tokens=5)
    assert tm._serving_engine is eng
    assert cached.dtype == x.dtype and cached.shape == (2, 12)
    for out in (cached, naive, again):
        np.testing.assert_array_equal(out.numpy(), j)
    tm.close()


def test_model_is_freed_without_the_collector_after_close():
    """``generate`` keeps its engine on the model, and the two refer to
    each other; after ``close`` the model and the engine go with their
    last references, the collector off."""
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    x = torch.tensor([[1, 2, 3], [4, 5, 6]])
    first = tm.generate(x, max_new_tokens=3)
    eng = weakref.ref(tm._serving_engine)
    tm.close()
    assert not hasattr(tm, "_serving_engine")
    torch.testing.assert_close(tm.generate(x, max_new_tokens=3), first,
                               rtol=0, atol=0)
    again = weakref.ref(tm._serving_engine)
    tm.close()
    gone = weakref.ref(tm)
    collecting = gc.isenabled()
    gc.disable()
    try:
        del tm
        assert gone() is None and eng() is None and again() is None
    finally:
        if collecting:
            gc.enable()


def test_generate_sampled_naive_is_refused(models):
    """The naive loop samples from the global generator, as the
    reference's does (no longer refused since the generator came, queue 1
    item 7): under one ``paddle.seed`` both packages give the same tokens
    and spend one key a token; the cached path samples through the
    engine's per-request streams. (The name is the one the test had while
    naive sampling was refused; it is kept so that its record carries
    on.)"""
    jm, tm = models
    x = np.array([[1, 2, 3]], np.int64)
    paddle.seed(6)
    want = np.asarray(jm.generate(paddle.to_tensor(x), max_new_tokens=3,
                                  temperature=0.8, use_cache=False).numpy())
    tpaddle.seed(6)
    got = tm.generate(torch.from_numpy(x), max_new_tokens=3,
                      temperature=0.8, use_cache=False)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tpaddle.get_rng_state() == paddle.get_rng_state() == (6, 3)
    out = tm.generate(torch.tensor([[1, 2, 3]]), max_new_tokens=2,
                      temperature=0.8, use_cache=True)
    assert out.shape == (1, 5)
    tm.close()


def test_block_multihead_attention_matches_jax():
    """Random GQA inputs (H 4, KH 2, D 16, block 4): a prefill row, a
    decode row continuing a 7-token prefix, a prefill row with a -1
    table entry inside its range and a padding row; output and both
    caches within 1e-5 of the JAX function, padding rows exactly 0."""
    from paddle_tpu.incubate.nn.functional import (
        block_multihead_attention as jbma)
    from paddle_tpu_torch.incubate.nn.functional import (
        block_multihead_attention)

    rng = np.random.default_rng(4)
    b, s, h, kh, d, bs, nb = 4, 5, 4, 2, 16, 4, 12
    qkv = rng.standard_normal((b, s, 3, h, d)).astype(np.float32)
    kc = rng.standard_normal((nb, bs, kh, d)).astype(np.float32)
    vc = rng.standard_normal((nb, bs, kh, d)).astype(np.float32)
    bt = np.asarray([[0, 1, -1, -1], [2, 3, -1, -1], [4, -1, -1, -1],
                     [-1, -1, -1, -1]], np.int32)
    enc = np.asarray([5, 0, 5, 0], np.int32)
    dec = np.asarray([0, 7, 0, 0], np.int32)
    now = np.asarray([5, 1, 5, 0], np.int32)
    jo, jk, jv = jbma(qkv, kc, vc, enc, dec, now, bt)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    to, tk2, tv2 = block_multihead_attention(
        torch.from_numpy(qkv), tk, tv, torch.from_numpy(enc),
        torch.from_numpy(dec), torch.from_numpy(now), torch.from_numpy(bt))
    assert tk2 is tk and tv2 is tv            # written in place
    for got, want in ((to, jo), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert not to[3].any() and not to[1, 1:].any()
    # the row with a -1 entry wrote nothing past its first block
    np.testing.assert_array_equal(tk.numpy()[5:], kc[5:])


def test_block_multihead_attention_bf16_padding_rows_are_zero():
    """In bf16 the reference's mask value (the f32 minimum) rounds to
    -inf, so a padding row (nothing visible) softmaxes to NaN and stays
    NaN after its zero mask; the port masks in f32 and gives 0 there
    (a difference by design). The live rows agree at bf16's resolution."""
    import jax.numpy as jnp

    from paddle_tpu.incubate.nn.functional import (
        block_multihead_attention as jbma)
    from paddle_tpu_torch.incubate.nn.functional import (
        block_multihead_attention)

    rng = np.random.default_rng(5)
    qkv = rng.standard_normal((2, 3, 3, 4, 16)).astype(np.float32)
    kc = np.zeros((4, 4, 2, 16), np.float32)
    lens = [np.asarray(x, np.int32) for x in ([3, 0], [0, 0], [3, 0])]
    bt = np.asarray([[0, -1], [-1, -1]], np.int32)
    jo, _, _ = jbma(jnp.asarray(qkv, jnp.bfloat16),
                    jnp.asarray(kc, jnp.bfloat16),
                    jnp.asarray(kc, jnp.bfloat16), *lens, bt)
    jo = np.asarray(jo.numpy(), np.float32)
    assert np.isnan(jo[1]).all()
    t = torch.from_numpy(qkv).to(torch.bfloat16)
    tk = torch.zeros(kc.shape, dtype=torch.bfloat16)
    to, _, _ = block_multihead_attention(
        t, tk, tk.clone(), *(torch.from_numpy(x) for x in lens),
        torch.from_numpy(bt))
    to = to.float().numpy()
    assert not to[1].any()
    np.testing.assert_allclose(to[0], jo[0], rtol=1e-2, atol=1e-2)


# ---------------------------------------------------------------------------
# the refusals that remain, and the port's watchdog
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("call", ["broadcast_abort", "on_remote_abort",
                                  "default_watchdog", "watch_step"])
def test_watchdog_gang_parts_are_refused(call):
    with pytest.raises(NotImplementedError, match="slice D"):
        if call == "broadcast_abort":
            twatchdog.StepWatchdog(timeout=1.0, broadcast_abort=True)
        elif call == "on_remote_abort":
            twatchdog.StepWatchdog(timeout=1.0, on_remote_abort=print)
        elif call == "default_watchdog":
            twatchdog.default_watchdog()
        else:
            twatchdog.watch_step(None, "step")


def test_step_watchdog_fires_only_past_the_deadline():
    """An armed entry past its deadline fires ``on_timeout`` once with its
    tag; an entry attached as done (the CPU's ``None``) never fires; a
    disabled watchdog arms nothing."""
    fired = []
    wd = twatchdog.StepWatchdog(timeout=0.05, on_timeout=fired.append)
    done = wd.arm("fast")
    wd.attach(done, None)
    wd.arm("slow")
    deadline = time.monotonic() + 5.0
    while not fired and time.monotonic() < deadline:
        time.sleep(0.01)
    assert [[e[0] for e in ents] for ents in fired] == [["slow"]]
    assert wd.fired and not wd._entries
    assert twatchdog.StepWatchdog(timeout=0.0).arm("x") == 0


def test_step_watchdog_under_concurrent_steps():
    """16 threads (more than the cores) arm, attach and disarm steps
    against one watchdog at a short switch interval, half of them
    through the prober with events that complete at once: no entry is
    lost or left behind, and nothing fires."""
    import sys
    import threading

    class Done:
        def synchronize(self):
            pass

        def query(self):
            return True

    fired = []
    wd = twatchdog.StepWatchdog(timeout=1.0, on_timeout=fired.append)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker(i):
            for n in range(200):
                eid = wd.arm(f"w{i}")
                if n % 2:
                    wd.attach(eid, Done())
                else:
                    wd.attach(eid, None)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    deadline = time.monotonic() + 10.0
    while wd._entries and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not wd._entries and not fired and not wd.fired
    assert wd._seq == 16 * 200


def test_preemption_monitor_request_and_signal():
    import os
    import signal

    m = twatchdog.PreemptionMonitor()
    assert not m.requested()
    m.install()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5.0
        while not m.requested() and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        m.uninstall()
    assert m.requested()
    assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL
    m2 = twatchdog.PreemptionMonitor()
    m2.request()
    assert m2.requested()
    assert twatchdog.preemption_monitor() is twatchdog.preemption_monitor()


def test_resilient_engine_is_freed_without_the_collector(models):
    """An engine with a host pool, a drain monitor and a watchdog whose
    threads ran, after a run that swapped: dropping the last reference
    frees it at once, and its watchdog threads end."""
    _, tm = models
    eng = LLMEngine(tm, EngineConfig(
        block_size=4, num_blocks=10, max_num_seqs=4, max_model_len=32,
        swap_mode="host", step_timeout_s=5.0))
    monitor = eng.install_preemption_handler(twatchdog.PreemptionMonitor())
    monitor.uninstall()
    eng.generate(_prompts(15, 256, [6, 8, 5, 7]),
                 SamplingParams(max_new_tokens=8))
    assert eng.scheduler.num_swap_outs > 0
    threads = [eng._watchdog._monitor]
    gone = [weakref.ref(x) for x in (eng, eng._watchdog, eng._swapper,
                                     eng._graphs)]
    collecting = gc.isenabled()
    gc.disable()
    try:
        del eng
        assert [r() is None for r in gone] == [True] * len(gone)
    finally:
        if collecting:
            gc.enable()
    for t in threads:
        t.join(timeout=5.0)
        assert not t.is_alive()
