"""Tensor-parallel serving (``EngineConfig(tp_degree=2)``) of the port
against the JAX package's TP engine, on the CPU.

The port runs k = 2 as two gloo processes (``serving/tp.py``); the
reference runs its ``tp_degree=2`` SPMD engine in this process over the
8 virtual CPU devices of ``tests/conftest.py``. Both serve the tiny
Llama (f32) from the same weights (the reference's, seed 0, carried
across by ``models.convert.llama_state_from_jax``), on
``scripts/tp_smoke.py``'s workload: six requests, greedy and sampled,
three sharing a 16-token prefix, with a forced OOM of ``r0`` mid-decode.
Checked: the port at k = 2 gives the reference's tokens and the port's
k = 1 tokens (recompute and host-swap preemption, prefix hits); its
per-rank host pools are the reference's frames (within 1e-5: the two
packages' f32 products round differently); ``param_layouts`` is the
reference's through the [in, out] -> [out, in] map; a checkpoint the JAX
package wrote restores onto the TP shards (each rank's shard the exact
slice, k = 2 logits within 1e-5 of the unsharded restore's);
``block_multihead_attention(tp_degree=2)``; and the ragged path's knobs
at k = 2 (drain, deadlines, admission, a retried step, the watchdog),
with a killed worker failing the step loudly and leaving no process.
"""
import dataclasses
import gc
import importlib.util
import multiprocessing as mp
import os
import time

import numpy as np
import pytest
import torch

from paddle_tpu.distributed.checkpoint import (
    CheckpointManager as JCheckpointManager)
from paddle_tpu.serving import EngineConfig as JEngineConfig
from paddle_tpu.serving import LLMEngine as JLLMEngine
from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
from paddle_tpu_torch.distributed.redistribute import Layout
from paddle_tpu_torch.models.convert import llama_state_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams
from paddle_tpu_torch.serving.engine import EngineStepError, StepHungError
from paddle_tpu_torch.serving.tp import GROUP_TIMEOUT_S
from paddle_tpu_torch.testing import faults, gloo_ranks


def _load_tp_smoke():
    spec = importlib.util.spec_from_file_location(
        "tp_smoke", os.path.join(os.path.dirname(__file__), os.pardir,
                                 "scripts", "tp_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tp_smoke = _load_tp_smoke()
_SP_FIELDS = [f.name for f in dataclasses.fields(SamplingParams)]


@pytest.fixture(scope="module")
def jax_model():
    return tp_smoke.build_model()


@pytest.fixture(scope="module")
def jax_state(jax_model):
    return {k: np.asarray(v.numpy())
            for k, v in jax_model.state_dict().items()}


def _port_model(jax_state):
    """A fresh port model with the reference's weights: a k > 1 engine
    cuts its model down to rank 0's shards, so each engine gets its own."""
    m = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    m.load_state_dict(llama_state_from_jax(jax_state))
    return m.eval()


def _ecfg(tp, **kw):
    kw.setdefault("block_size", 4)
    kw.setdefault("max_num_seqs", 4)
    kw.setdefault("max_model_len", 64)
    kw.setdefault("num_blocks", 48)
    kw.setdefault("drain_grace_s", 0.0)
    return EngineConfig(tp_degree=tp, **kw)


def _workload(vocab):
    prompts, jsps = tp_smoke.make_workload(vocab)
    return prompts, [SamplingParams(**{f: getattr(sp, f) for f in
                                       _SP_FIELDS}) for sp in jsps]


def _serve(eng, force_oom=True):
    """tp_smoke's ``serve`` on the port's engine: the workload, r0's
    forced OOM mid-decode, the block manager's invariants each step."""
    prompts, sps = _workload(eng.model.config.vocab_size)
    rids = [eng.add_request(f"r{i}", p, sampling=sp)
            for i, (p, sp) in enumerate(zip(prompts, sps))]
    if force_oom:
        faults.install(f"{faults.SERVING_FORCE_OOM}.r0:flag*1")
    try:
        while eng.has_unfinished():
            eng.step()
            eng.block_manager.check_invariants()
    finally:
        faults.clear()
    return {r: list(eng.get_request(r).generated) for r in rids}


def _jax_serve(model, **kw):
    """tp_smoke's ``serve`` on the reference's engine (``tp_degree=2``)."""
    prompts, samplings = tp_smoke.make_workload(model.config.vocab_size)
    kw.setdefault("block_size", 4)
    kw.setdefault("max_num_seqs", 4)
    kw.setdefault("max_model_len", 64)
    kw.setdefault("num_blocks", 48)
    eng = JLLMEngine(model, JEngineConfig(tp_degree=2, drain_grace_s=0.0,
                                          **kw))
    rids = [eng.add_request(f"r{i}", p, sampling=sp)
            for i, (p, sp) in enumerate(zip(prompts, samplings))]
    jfaults.install("serving.force_oom.r0:flag*1")
    try:
        while eng.has_unfinished():
            eng.step()
            eng.block_manager.check_invariants()
    finally:
        jfaults.clear()
    return eng, {r: list(eng.get_request(r).generated) for r in rids}


@pytest.fixture(scope="module")
def jax_tp2(jax_model):
    return _jax_serve(jax_model)


@pytest.fixture(scope="module")
def tp2(jax_state):
    """The one k = 2 port engine of this module, with tp_smoke's workload
    served on it."""
    eng = LLMEngine(_port_model(jax_state), _ecfg(2))
    out = _serve(eng)
    yield eng, out
    del eng
    gc.collect()


def _tp_children():
    """The live worker processes of this process's TP engines."""
    gc.collect()
    return [p for p in mp.active_children()
            if p.name.startswith("paddle-tp-")]


# ---------------------------------------------------------------------------
# 1. the workload: k = 2 against the reference's tp=2 and the port's k = 1
# ---------------------------------------------------------------------------
def test_tp2_serves_the_reference_tokens(tp2, jax_tp2, jax_state):
    eng, got = tp2
    jeng, want = jax_tp2
    one = _serve(LLMEngine(_port_model(jax_state), _ecfg(1)))
    assert got == want
    assert got == one
    # greedy and sampled streams both ran, at full length
    assert all(len(v) == sp.max_new_tokens for v, sp in
               zip(got.values(), _workload(256)[1]))
    for s in (eng.metrics.snapshot(), jeng.metrics.snapshot()):
        assert s["preemptions"] >= 1
        assert s["serving_prefix_cache_hits"] >= 1
        assert s["padded_token_frac"] == 0.0
        assert s["serving_kv_reshards"] == 0
    assert eng.tp_degree == 2 and eng.kv_layout == Layout.tp_sharded(5, 3, 2)
    assert eng.kv_layout.to_meta() == jeng.kv_layout.to_meta()
    assert eng._tp.backend == "gloo" and eng._tp.handoff_s > 0
    # rank 0 holds its shard of the cache: KH/k kv heads
    assert tuple(eng._kcs.shape) == (2, 48, 4, 1, 16)
    assert eng.block_manager.num_free_blocks == 48


def test_rank0_holds_only_its_shards(tp2, jax_state):
    """The hand-off cut rank 0's model down in place: q/k/v/gate/up to
    rows r of [out, in], o/down to columns, embeddings, norms and the
    head whole; such a model refuses a second engine."""
    eng, _ = tp2
    full = llama_state_from_jax(jax_state)
    for name, p in eng.model.named_parameters():
        lay = eng.param_layouts()[name]
        want = full[name][lay.shard_slices(tuple(full[name].shape), 0)]
        assert torch.equal(p.detach(), want), name
    attn = eng.model.llama.layers[0].self_attn
    assert (attn.n_heads, attn.n_kv) == (2, 1)
    with pytest.raises(ValueError, match="shard 0 of 2"):
        LLMEngine(eng.model, _ecfg(1))


# ---------------------------------------------------------------------------
# 2. host swap: per-rank host pools are the reference's frames
# ---------------------------------------------------------------------------
def test_host_swap_frames_match_the_reference(jax_model, jax_state):
    jeng, want = _jax_serve(jax_model, swap_mode="host", num_blocks=16)
    eng = LLMEngine(_port_model(jax_state),
                    _ecfg(2, swap_mode="host", num_blocks=16))
    got = _serve(eng)
    one = _serve(LLMEngine(_port_model(jax_state),
                           _ecfg(1, swap_mode="host", num_blocks=16)))
    assert got == want == one
    s = eng.metrics.snapshot()
    assert s["serving_swapped_out"] >= 1 and s["serving_swapped_in"] >= 1
    eng._swapper.fence()
    hk, hv = eng._tp.host_pools(eng._host_k, eng._host_v)
    assert tuple(hk.shape) == jeng._host_k.shape == (2, 2, 16, 4, 1, 16)
    for g, w in ((hk, jeng._host_k), (hv, jeng._host_v)):
        g = g.numpy()
        # the same slots written: the untouched ones are zero in both
        np.testing.assert_array_equal(g == 0, np.asarray(w) == 0)
        assert g.any()
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# 3. param_layouts against the reference's
# ---------------------------------------------------------------------------
def test_param_layouts_match_the_reference(tp2, jax_tp2):
    """The reference's layouts are over [in, out] weights; every weight
    that ``models.convert`` transposes takes its placements reversed."""
    eng, _ = tp2
    jeng, _ = jax_tp2
    ours, theirs = eng.param_layouts(), jeng.param_layouts()
    assert set(ours) == set(theirs)
    split = 0
    for name, lay in theirs.items():
        pl = list(lay.dim_placements)
        if name.endswith("_proj.weight") or name == "lm_head.weight":
            pl = pl[::-1]
        assert ours[name] == Layout(lay.mesh_axes, pl), name
        split += any(p is not None for p in pl)
    assert split == 7 * 2      # q, k, v, o, gate, up, down per layer


# ---------------------------------------------------------------------------
# 4. restore(target_layout=) of a checkpoint the JAX package wrote
# ---------------------------------------------------------------------------
def test_restore_onto_tp_shards(jax_model, jax_state, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    JCheckpointManager(ckpt).save(1, jax_model.state_dict(), block=True)
    # the unsharded restore, into the JAX orientation, then the port's
    full = {k: torch.zeros(v.shape) for k, v in jax_state.items()}
    assert CheckpointManager(ckpt).restore(full, 1) == 1
    for k, v in jax_state.items():
        np.testing.assert_array_equal(full[k].numpy(), v, err_msg=k)
    plain = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu").eval()
    plain.load_state_dict(llama_state_from_jax(
        {k: v.numpy() for k, v in full.items()}))
    ids = np.random.default_rng(5).integers(0, 256, (2, 12))
    with torch.no_grad():
        want = plain(torch.as_tensor(ids)).numpy()
    res = gloo_ranks.run(gloo_ranks.tp_restore, 2, ckpt, 1, ids)
    for rank, r in enumerate(res):
        for name, shard in r["shards"].items():
            v = jax_state[name]
            if shard.shape == v.shape:     # replicated
                np.testing.assert_array_equal(shard, v, err_msg=name)
                continue
            d = next(i for i, (a, b) in enumerate(zip(shard.shape, v.shape))
                     if a != b)
            lo = rank * shard.shape[d]
            np.testing.assert_array_equal(
                shard, np.take(v, range(lo, lo + shard.shape[d]), axis=d),
                err_msg=f"{name} rank {rank}")
    np.testing.assert_allclose(res[0]["logits"], want, rtol=1e-5,
                               atol=1e-5)


def test_restore_target_layout_errors(tmp_path):
    """The reference's errors: a name absent from the state dict
    (``KeyError``), a non-tensor leaf (``TypeError``), a layout that does
    not tile the stored shape (``ValueError``); a degree-1 layout restores
    bit-identically, in place."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.full((8, 8), 3.25), "hot": torch.ones(4),
                 "n": 3}, block=True)
    st = {"w": torch.zeros(8, 8), "hot": torch.zeros(4), "n": 0}
    with pytest.raises(KeyError):
        mgr.restore(st, 1, target_layout={"nope": Layout.tp_sharded(1, 0, 1)})
    with pytest.raises(TypeError):
        mgr.restore(st, 1, target_layout={"n": Layout.tp_sharded(1, 0, 1)})
    with pytest.raises(ValueError):
        mgr.restore(st, 1, target_layout={"hot": Layout.tp_sharded(1, 0, 3)})
    w = st["w"]
    assert mgr.restore_or_initialize(
        st, target_layout={"w": Layout.tp_sharded(2, 0, 1)}) == 1
    assert st["w"] is w and torch.equal(w, torch.full((8, 8), 3.25))
    # rank 1 of 2 along dim 1: a global-shaped leaf is rebound to its
    # shard, a shard-shaped one filled in place
    g, s = torch.zeros(8, 8), torch.zeros(8, 4)
    mgr.restore({"w": g, "hot": torch.zeros(4), "n": 0}, 1,
                target_layout={"w": Layout.tp_sharded(2, 1, 2)}, rank=1)
    mgr.restore({"w": s, "hot": torch.zeros(4), "n": 0}, 1,
                target_layout={"w": Layout.tp_sharded(2, 1, 2)}, rank=1)
    assert tuple(g.shape) == (8, 4) and torch.equal(g, s)


# ---------------------------------------------------------------------------
# 5. block_multihead_attention(tp_degree=2)
# ---------------------------------------------------------------------------
def test_block_multihead_attention_tp2_matches_jax():
    """The per-group packing: each of the 2 groups' 4 head slots leads
    with its 1 kv head (H 8, KH 2, D 16, block 4); output and caches
    within 1e-5 of the reference's, and equal to the port's flat call on
    the same heads unpacked."""
    from paddle_tpu.incubate.nn.functional import (
        block_multihead_attention as jbma)
    from paddle_tpu_torch.incubate.nn.functional import (
        block_multihead_attention)

    rng = np.random.default_rng(6)
    b, s, h, kh, d, bs, nb = 3, 5, 8, 2, 16, 4, 12
    qkv = rng.standard_normal((b, s, 3, h, d)).astype(np.float32)
    kc = rng.standard_normal((nb, bs, kh, d)).astype(np.float32)
    vc = rng.standard_normal((nb, bs, kh, d)).astype(np.float32)
    bt = np.asarray([[0, 1, -1, -1], [2, 3, 4, -1], [-1, -1, -1, -1]],
                    np.int32)
    enc = np.asarray([5, 0, 0], np.int32)
    dec = np.asarray([0, 7, 0], np.int32)
    now = np.asarray([5, 2, 0], np.int32)
    jo, jk, jv = jbma(qkv, kc, vc, enc, dec, now, bt, tp_degree=2)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    to, _, _ = block_multihead_attention(
        torch.from_numpy(qkv), tk, tv, torch.from_numpy(enc),
        torch.from_numpy(dec), torch.from_numpy(now), torch.from_numpy(bt),
        tp_degree=2)
    for got, want in ((to, jo), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                                   rtol=1e-5, atol=1e-5)
    # the same heads packed flat give the same numbers
    flat = qkv.copy()
    for j in (1, 2):
        flat[:, :, j, :kh] = qkv[:, :, j].reshape(b, s, 2, h // 2, d)[
            :, :, :, 0]
    fk, fv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    fo, _, _ = block_multihead_attention(
        torch.from_numpy(flat), fk, fv, torch.from_numpy(enc),
        torch.from_numpy(dec), torch.from_numpy(now), torch.from_numpy(bt))
    assert torch.equal(fo, to) and torch.equal(fk, tk)


# ---------------------------------------------------------------------------
# 6. the ragged path's knobs at k = 2, and a worker that dies
# ---------------------------------------------------------------------------
def test_admission_deadline_and_retry_at_tp2(tp2, jax_state):
    """On the module's engine: a queue past ``max_queue_depth`` rejects
    (admission), a request past its deadline expires, and a step that
    fails before its command goes out is retried with the same tokens as
    k = 1."""
    eng, _ = tp2
    eng.admission.max_queue_depth = 3
    try:
        eng.add_request("late", [9, 10, 11],
                        SamplingParams(max_new_tokens=4, deadline_ms=1e-3))
        ids = [eng.add_request(f"a{i}", [5, 6, 7, 8],
                               SamplingParams(max_new_tokens=2))
               for i in range(3)]
        assert eng.get_request(ids[2]).finish_reason == "rejected"
        time.sleep(0.01)
        with faults.injected(f"{faults.SERVING_STEP}:raise*1"):
            outs = eng.run()
    finally:
        eng.admission.max_queue_depth = None
    final = {o.request_id: o for o in outs if o.finished}
    assert final["late"].finish_reason == "expired"
    assert eng.num_step_retries == 1
    one = LLMEngine(_port_model(jax_state), _ecfg(1))
    for rid in ids[:2]:
        one.add_request(rid, [5, 6, 7, 8], SamplingParams(max_new_tokens=2))
    one.run()
    for rid in ids[:2]:
        assert eng.get_request(rid).generated == \
            one.get_request(rid).generated
        eng.release_request(rid)


def test_drain_at_tp2(jax_state):
    """A drain mid-decode: admission closes, the waiting request aborts
    with 'aborted:drain', the running batch finishes."""
    eng = LLMEngine(_port_model(jax_state),
                    _ecfg(2, max_num_seqs=2, drain_grace_s=30.0))
    for i in range(3):
        eng.add_request(f"d{i}", [1 + i, 2, 3, 4, 5],
                        SamplingParams(max_new_tokens=4))
    eng.step()
    outs = eng.drain()
    reasons = {o.request_id: o.finish_reason for o in outs if o.finished}
    assert reasons == {"d0": "length", "d1": "length",
                       "d2": "aborted:drain"}
    assert eng.drained
    assert eng.get_request("d0").generated == _serve_one(jax_state, [1, 2, 3,
                                                                     4, 5])


def _serve_one(jax_state, prompt, new=4):
    one = LLMEngine(_port_model(jax_state), _ecfg(1))
    one.add_request("x", prompt, SamplingParams(max_new_tokens=new))
    one.run()
    return one.get_request("x").generated


def test_watchdog_at_tp2(jax_state):
    """A warm step that outlives ``step_timeout_s`` fails the engine with
    ``StepHungError``; every request aborts with a structured output."""
    eng = LLMEngine(_port_model(jax_state), _ecfg(2, step_timeout_s=0.5))
    eng.add_request("w", [3, 4, 5], SamplingParams(max_new_tokens=6))
    eng.step()
    eng.step()
    with faults.injected(f"{faults.SERVING_STEP}:sleep:1.2*1"):
        with pytest.raises(StepHungError) as ei:
            eng.step()
    assert [o.finish_reason for o in ei.value.outputs] == ["aborted:error"]


def test_a_killed_worker_fails_the_step_and_leaves_no_process(tp2,
                                                              jax_state):
    """SIGKILL rank 1 between steps: rank 0's next step raises
    ``EngineStepError`` (no retry) well inside the group's timeout, the
    request aborts with a structured output, and once the engine goes no
    process of it is left."""
    eng = LLMEngine(_port_model(jax_state), _ecfg(2))
    eng.add_request("k", [3, 4, 5, 6], SamplingParams(max_new_tokens=6))
    eng.step()
    proc = eng._tp._procs[0]
    proc.kill()
    proc.join(10.0)
    t0 = time.monotonic()
    with pytest.raises(EngineStepError, match="tensor-parallel") as ei:
        eng.step()
    assert time.monotonic() - t0 < GROUP_TIMEOUT_S
    assert eng.num_step_retries == 0
    assert [o.finish_reason for o in ei.value.outputs] == ["aborted:error"]
    assert eng.add_request("after", [1, 2], SamplingParams(
        max_new_tokens=1)) == "after"
    assert eng.get_request("after").finish_reason == "rejected"
    del eng, ei
    # the module's engine's worker is the only one left
    assert _tp_children() == tp2[0]._tp._procs


def test_no_process_outlives_its_engine(tp2, jax_state):
    """An engine dropped without a close: its finalizer shuts the worker
    down, also a speculative engine's (its draft whole on rank 0); a
    refusal at k > 1 raises before any process starts."""
    eng = LLMEngine(_port_model(jax_state), _ecfg(2))
    procs = list(eng._tp._procs)
    assert all(p.is_alive() for p in procs)
    del eng
    gc.collect()
    assert not any(p.is_alive() for p in procs)
    spec = LLMEngine(_port_model(jax_state),
                     _ecfg(2, draft_model=_port_model(jax_state),
                           num_spec_tokens=2))
    procs = list(spec._tp._procs)
    assert len(procs) == 1 and procs[0].is_alive()
    assert spec._spec is not None
    del spec
    gc.collect()
    assert not any(p.is_alive() for p in procs)
    with pytest.raises(ValueError, match="must divide"):
        LLMEngine(_port_model(jax_state), _ecfg(3))
    assert _tp_children() == tp2[0]._tp._procs


def test_the_other_ragged_knobs_at_tp2(jax_state):
    """Chunked prefill (a 6-token budget), a floor of 2 on the buckets, a
    bf16 cache under the f32 model, donated caches, a TTFT SLO and the
    non-finite guard (a poisoned row aborts alone): k = 2 serves the
    k = 1 engine's tokens under the same knobs."""
    knobs = dict(max_batched_tokens=6, min_prefill_bucket=2,
                 dtype="bfloat16", donate_cache=True, ttft_slo_ms=1e6)
    prompts = [[7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17], [3, 4, 5],
               [20, 21, 22, 23, 24, 25, 26]]
    got = {}
    for tp in (1, 2):
        eng = LLMEngine(_port_model(jax_state), _ecfg(tp, **knobs))
        for i, p in enumerate(prompts):
            eng.add_request(f"p{i}", p, SamplingParams(
                max_new_tokens=5, temperature=0.9 if i == 2 else 0.0,
                seed=4))
        with faults.injected(f"{faults.SERVING_NAN_LOGITS}:flag:p1"):
            outs = eng.run()
        got[tp] = ({o.request_id: o.finish_reason for o in outs
                    if o.finished},
                   {f"p{i}": eng.get_request(f"p{i}").generated
                    for i in range(3)},
                   eng.scheduler.num_prefill_chunks)
        assert eng._kcs.dtype == torch.bfloat16
    assert got[1] == got[2]
    reasons, _, chunks = got[2]
    assert reasons == {"p0": "length", "p1": "aborted:nonfinite",
                       "p2": "length"}
    assert chunks >= 2
