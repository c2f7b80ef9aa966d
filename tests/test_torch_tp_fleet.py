"""The fleet's KV and prefix ships at ``tp_degree > 1``: the port's k = 2
engine (two gloo processes, ``serving/tp.py``) against the JAX package's
``tp_degree=2`` engine (one SPMD program over the 8 virtual CPU devices
of ``tests/conftest.py``), on the CPU.

Both packages serve the tiny Llama (f32) from the same weights (the
reference's, seed 0, carried across by ``models.convert.
llama_state_from_jax``). Checked, on ``scripts/tp_smoke.py``'s phases:

* ``cross_degree_ship_phase`` through the port at every pair of degrees
  (1 -> 2, 2 -> 1, 2 -> 2): the continuation gives the JAX package's
  tokens, the importer computes exactly the one uncovered token, and it
  counts a reshard exactly when the degrees differ;
* the k = 2 export is the JAX ``tp_degree=2`` engine's message: the same
  meta, key for key (the checksum is each payload's own), and frames
  within 1e-5 (the two packages' f32 products round differently); a
  payload of either package's k = 2 engine lands in the other's;
* ``fleet_handoff_phase`` through the port's ``FleetRouter`` over a k = 1
  and a k = 2 ``InProcessReplica``: a drain of the k = 1 replica ships
  its requests to the k = 2 one with 0 tokens recomputed, and under a
  ``serving.kv_scatter`` fault goes one rung down the ladder; the same
  tokens either way, every request finished once;
* a prefix ship out of and into a k = 2 engine;
* a worker killed before a gather fails the export loudly, then the
  step, and leaves no process.
"""
import dataclasses
import gc
import importlib.util
import multiprocessing as mp
import os
import time
import zlib

import numpy as np
import pytest
import torch

from paddle_tpu.serving import EngineConfig as JEngineConfig
from paddle_tpu.serving import LLMEngine as JLLMEngine
from paddle_tpu.serving import SamplingParams as JSamplingParams
from paddle_tpu_torch.distributed.redistribute import get_stats, reset_stats
from paddle_tpu_torch.models.convert import llama_state_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams
from paddle_tpu_torch.serving.block_manager import prefix_chain_hashes
from paddle_tpu_torch.serving.engine import EngineStepError
from paddle_tpu_torch.serving.fleet import FleetRouter, InProcessReplica
from paddle_tpu_torch.serving.tp import GROUP_TIMEOUT_S
from paddle_tpu_torch.testing import faults


def _load_tp_smoke():
    spec = importlib.util.spec_from_file_location(
        "tp_smoke", os.path.join(os.path.dirname(__file__), os.pardir,
                                 "scripts", "tp_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tp_smoke = _load_tp_smoke()
MAX_NEW = 6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the tiny engines, restored after the
    module (as ``tests/test_torch_fleet.py`` does)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_model():
    return tp_smoke.build_model()


@pytest.fixture(scope="module")
def jax_state(jax_model):
    return {k: np.asarray(v.numpy())
            for k, v in jax_model.state_dict().items()}


def _port_model(jax_state):
    """A fresh port model with the reference's weights (a k > 1 engine
    cuts its model down to rank 0's shards)."""
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


def _jcfg(tp, **kw):
    kw.setdefault("block_size", 4)
    kw.setdefault("max_num_seqs", 4)
    kw.setdefault("max_model_len", 64)
    kw.setdefault("num_blocks", 48)
    kw.setdefault("drain_grace_s", 0.0)
    return JEngineConfig(tp_degree=tp, **kw)


@pytest.fixture(scope="module")
def ports(jax_state):
    """The module's port engines by degree; each test uses its own
    request ids."""
    engines = {tp: LLMEngine(_port_model(jax_state), _ecfg(tp))
               for tp in (1, 2)}
    yield engines
    engines.clear()
    gc.collect()


@pytest.fixture(scope="module")
def jax_tp2(jax_model):
    return JLLMEngine(jax_model, _jcfg(2))


def _ship_prompt(vocab=256):
    """``cross_degree_ship_phase``'s prompt."""
    rng = np.random.default_rng(23)
    return list(map(int, rng.integers(0, vocab, size=32)))


@pytest.fixture(scope="module")
def ship_ref(jax_model):
    """The JAX package's one-engine tokens for the ship prompt."""
    eng = JLLMEngine(jax_model, _jcfg(1))
    return eng.generate([_ship_prompt()],
                        JSamplingParams(max_new_tokens=MAX_NEW))[0]


def _prefill_and_export(eng, rid, prompt, steps=2):
    """``cross_degree_ship_phase``'s exporter: prefill, one decode step,
    then ``export_kv``. Returns (tokens so far, meta, payload)."""
    sp = (SamplingParams if isinstance(eng, LLMEngine) else JSamplingParams)
    eng.add_request(rid, prompt, sampling=sp(max_new_tokens=MAX_NEW))
    for _ in range(steps):
        eng.step()
    done = list(eng.get_request(rid).generated)
    meta, payload = eng.export_kv(rid)
    return done, meta, payload


def _import_and_finish(eng, rid, prompt, done, meta, payload):
    """The importer's half: ``import_kv`` the shipped KV for the prompt
    plus the tokens so far, serve the rest. Returns (all tokens, prompt
    tokens the importer computed)."""
    sp = (SamplingParams if isinstance(eng, LLMEngine) else JSamplingParams)
    before = eng.metrics.snapshot()["num_prompt_tokens"]
    eng.import_kv(rid, prompt + done,
                  sampling=sp(max_new_tokens=MAX_NEW - len(done)),
                  meta=meta, payload=bytes(payload))
    while eng.has_unfinished():
        eng.step()
        eng.block_manager.check_invariants()
    computed = eng.metrics.snapshot()["num_prompt_tokens"] - before
    return done + list(eng.get_request(rid).generated), computed


def _frames(meta, payload):
    """A ship's K and V frames, each (k, L, n, BS, KH/k, D) float32."""
    k = meta["layout"]["mesh_axes"][0][1]
    L, n, bs, kh, d = meta["shape"]
    a = np.frombuffer(payload, np.float32).reshape(2, k, L, n, bs, kh // k,
                                                   d)
    return a[0], a[1]


def _tp_children():
    gc.collect()
    return [p for p in mp.active_children()
            if p.name.startswith("paddle-tp-")]


# ---------------------------------------------------------------------------
# 1. cross_degree_ship_phase at every pair of degrees
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("src,dst", [(1, 2), (2, 1), (2, 2)],
                         ids=["tp1-to-tp2", "tp2-to-tp1", "tp2-to-tp2"])
def test_cross_degree_ship(ports, ship_ref, src, dst):
    prompt = _ship_prompt()
    rid = f"ship{src}{dst}"
    done, meta, payload = _prefill_and_export(ports[src], rid, prompt)
    assert meta["layout"]["mesh_axes"] == [["tp", src]]
    assert meta["shape"] == [2, 9, 4, 2, 16]
    imp = ports[dst]
    reshards = imp.num_kv_reshards
    reset_stats()
    got, computed = _import_and_finish(imp, rid + "-in", prompt, done,
                                       meta, payload)
    assert got == ship_ref
    # zero recompute: the importer computed the one uncovered token
    assert computed == len(prompt) + len(done) - meta["tokens_covered"] == 1
    assert imp.num_kv_reshards - reshards == int(src != dst)
    assert imp.metrics.snapshot()["serving_kv_reshards"] == \
        imp.num_kv_reshards
    st = get_stats()
    if src != dst:
        assert st["num_redistributes"] == 2 and st["bytes_total"] > 0, st
    else:
        assert st["num_redistributes"] == 0, st


# ---------------------------------------------------------------------------
# 2. the k = 2 message is the JAX tp_degree=2 engine's
# ---------------------------------------------------------------------------
def test_tp2_export_is_the_reference_message(ports, jax_tp2):
    prompt = _ship_prompt()[:27]
    done, meta, payload = _prefill_and_export(ports[2], "meta", prompt)
    jdone, jmeta, jpayload = _prefill_and_export(jax_tp2, "meta", prompt)
    assert done == jdone
    assert set(meta) == set(jmeta)
    for key in meta:
        if key != "crc32":
            assert meta[key] == jmeta[key], key
    assert meta["crc32"] == zlib.crc32(payload) & 0xFFFFFFFF
    assert meta["layout"] == {"mesh_axes": [["tp", 2]],
                              "dim_placements": [None, None, None, "tp",
                                                 None]}
    for got, want in zip(_frames(meta, payload), _frames(jmeta, jpayload)):
        assert got.shape == (2, 2, 7, 4, 1, 16)
        np.testing.assert_array_equal(got == 0, want == 0)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # a prefix export frames the same way
    header = prompt[:24]
    chain = prefix_chain_hashes(header, 4)[-1]
    pmeta, ppayload = ports[2].export_prefix(chain)
    jpmeta, jppayload = jax_tp2.export_prefix(chain)
    for key in pmeta:
        if key != "crc32":
            assert pmeta[key] == jpmeta[key], key
    for got, want in zip(_frames(pmeta, ppayload),
                         _frames(jpmeta, jppayload)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_cross_package_ship_at_tp2(ports, jax_tp2, ship_ref, direction):
    """A k = 2 payload of either package lands in the other's k = 2
    engine frame by frame (no reshard) and continues to the JAX
    package's tokens."""
    prompt = _ship_prompt()
    rid = f"x-{direction}"
    src, dst = ((jax_tp2, ports[2]) if direction == "jax-to-port"
                else (ports[2], jax_tp2))
    done, meta, payload = _prefill_and_export(src, rid, prompt)
    reshards = dst.num_kv_reshards
    got, computed = _import_and_finish(dst, rid, prompt, done, meta,
                                       payload)
    assert got == ship_ref
    assert computed == 1
    assert dst.num_kv_reshards == reshards


# ---------------------------------------------------------------------------
# 3. fleet_handoff_phase: a k = 1 replica drained into a k = 2 peer
# ---------------------------------------------------------------------------
def _workload():
    prompts, jsps = tp_smoke.make_workload(256)
    fields = [f.name for f in dataclasses.fields(SamplingParams)]
    return prompts, jsps, [SamplingParams(**{f: getattr(sp, f)
                                             for f in fields})
                           for sp in jsps]


@pytest.fixture(scope="module")
def handoff_ref(jax_model):
    """``fleet_handoff_phase``'s reference: the JAX package's one
    engine over the workload, request ids f0..f5."""
    prompts, jsps, _ = _workload()
    eng = JLLMEngine(jax_model, _jcfg(1))
    for i, (p, sp) in enumerate(zip(prompts, jsps)):
        eng.add_request(f"f{i}", p, sampling=sp)
    while eng.has_unfinished():
        eng.step()
    return {f"f{i}": list(eng.get_request(f"f{i}").generated)
            for i in range(len(prompts))}


@pytest.mark.parametrize("inject_fault", [False, True],
                         ids=["clean", "scatter-fault"])
def test_fleet_handoff_tp1_into_tp2(jax_state, handoff_ref, inject_fault):
    prompts, _, sps = _workload()
    r1 = InProcessReplica(_port_model(jax_state), _ecfg(1),
                          replica_id="tp1")
    r2 = InProcessReplica(_port_model(jax_state), _ecfg(2),
                          replica_id="tp2")
    assert r2.engine.tp_degree == 2 and len(r2.engine._tp._procs) == 1
    router = FleetRouter([r1, r2])
    for i, (p, sp) in enumerate(zip(prompts, sps)):
        router.add_request(f"f{i}", p, sp)
    for _ in range(3):
        router.step()
    if inject_fault:
        faults.install(f"{faults.SERVING_KV_SCATTER}:raise*1")
    try:
        router.retire_replica(r1, reason="tp-migration")
        steps = 0
        while router.has_unfinished():
            router.step()
            r2.engine.block_manager.check_invariants()
            steps += 1
            assert steps < 600
    finally:
        faults.clear()
    got = {f"f{i}": list(router.get_request(f"f{i}").generated)
           for i in range(len(prompts))}
    assert got == handoff_ref
    snap = router.snapshot()
    assert snap["fleet_finish"] == {"length": len(prompts)}, snap
    assert snap["fleet_kv_ship_requests"] >= 1, snap
    if inject_fault:
        assert snap["fleet_recompute_fallbacks"] == 1, snap
    else:
        assert snap["fleet_tokens_recomputed"] == 0, snap
        assert snap["fleet_recompute_fallbacks"] == 0, snap
    assert r2.engine.num_kv_reshards == snap["fleet_kv_ship_requests"]
    procs = list(r2.engine._tp._procs)
    del router, r1, r2
    gc.collect()
    assert not any(p.is_alive() for p in procs)


# ---------------------------------------------------------------------------
# 4. prefix ships out of and into a k = 2 engine
# ---------------------------------------------------------------------------
def _serve(eng, rid, prompt, n=4):
    sp = (SamplingParams if isinstance(eng, LLMEngine) else JSamplingParams)
    eng.add_request(rid, prompt, sampling=sp(max_new_tokens=n))
    while eng.has_unfinished():
        eng.step()
    return list(eng.get_request(rid).generated)


def test_prefix_ship_round_trip_at_tp2(ports, jax_tp2, jax_model):
    """The port's k = 2 engine exports a cached header; the port's k = 1
    engine (a reshard) and the JAX tp 2 engine (frame by frame) import
    it; the JAX engine exports another header that the port's k = 2
    engine imports. Each importer then serves a request over its header
    computing only the tail, with the JAX package's tokens."""
    rng = np.random.default_rng(4)
    h1 = [int(t) for t in rng.integers(0, 256, size=12)]
    h2 = [int(t) for t in rng.integers(0, 256, size=16)]
    tail = [int(t) for t in rng.integers(0, 256, size=5)]
    ref = JLLMEngine(jax_model, _jcfg(1))
    want = {h: _serve(ref, f"ref{i}", list(h) + tail)
            for i, h in enumerate((tuple(h1), tuple(h2)))}

    _serve(ports[2], "warm-h1", h1 + [7, 7], 2)
    _serve(jax_tp2, "warm-h2", h2 + [7, 7], 2)
    ships = [(ports[2], ports[1], h1, 1), (ports[2], jax_tp2, h1, 0),
             (jax_tp2, ports[2], h2, 0)]
    for i, (src, dst, header, reshard) in enumerate(ships):
        meta, payload = src.export_prefix(
            prefix_chain_hashes(header, 4)[-1])
        assert meta["layout"]["mesh_axes"] == [["tp", src.tp_degree]]
        before = (dst.num_kv_reshards, dst.num_prefix_imports,
                  dst.metrics.snapshot()["num_prompt_tokens"])
        assert dst.import_prefix(meta=meta, payload=bytes(payload)) == \
            len(header)
        assert dst.num_kv_reshards - before[0] == reshard
        assert dst.num_prefix_imports - before[1] == 1
        assert _serve(dst, f"over{i}", header + tail) == want[tuple(header)]
        computed = dst.metrics.snapshot()["num_prompt_tokens"] - before[2]
        assert computed == len(tail)
        dst.block_manager.check_invariants()


# ---------------------------------------------------------------------------
# 5. a worker that dies before a gather or a scatter
# ---------------------------------------------------------------------------
def test_a_killed_worker_fails_the_gather_loudly(ports, jax_state):
    """SIGKILL rank 1 after a step: ``export_kv`` raises (no payload of
    rank 0's frame alone), the group is broken, the next step fails with
    ``EngineStepError``, and once the engine goes no process of it is
    left."""
    eng = LLMEngine(_port_model(jax_state), _ecfg(2))
    eng.add_request("g", [3, 4, 5, 6, 7], SamplingParams(max_new_tokens=6))
    eng.step()
    proc = eng._tp._procs[0]
    proc.kill()
    proc.join(10.0)
    t0 = time.monotonic()
    with pytest.raises(Exception) as ei:
        eng.export_kv("g")
    assert not isinstance(ei.value, ValueError)
    assert eng._tp.broken
    with pytest.raises(EngineStepError, match="tensor-parallel"):
        eng.step()
    assert time.monotonic() - t0 < GROUP_TIMEOUT_S
    del eng, ei
    assert _tp_children() == ports[2]._tp._procs


def test_a_killed_worker_fails_the_scatter_loudly(ports, jax_state):
    """SIGKILL rank 1 before an import's scatter: the replica's
    ``import_kv`` raises the broken group's error, not the ``ValueError``
    of a clean refusal (the router would then recompute on a replica
    whose ranks no longer pair); the claimed blocks are freed, a prefix
    import raises the same way, the next step fails with
    ``EngineStepError``, and once the replica goes no process of it is
    left."""
    prompt = _ship_prompt()
    done, meta, payload = _prefill_and_export(ports[1], "ks", prompt)
    ports[1].abort_request("ks")
    ports[1].release_request("ks")
    rep = InProcessReplica(_port_model(jax_state), _ecfg(2),
                           replica_id="tp2-killed")
    eng = rep.engine
    free = eng.block_manager.num_free_blocks
    proc = eng._tp._procs[0]
    proc.kill()
    proc.join(10.0)
    t0 = time.monotonic()
    with pytest.raises(Exception) as ei:
        rep.import_kv("ks-in", prompt + done,
                      SamplingParams(max_new_tokens=MAX_NEW - len(done)),
                      meta=meta, payload=bytes(payload))
    assert not isinstance(ei.value, ValueError)
    assert eng._tp.broken
    assert eng.block_manager.num_free_blocks == free
    eng.block_manager.check_invariants()
    pmeta, ppayload = ports[1].export_prefix(
        prefix_chain_hashes(prompt, 4)[-1])
    with pytest.raises(Exception) as ei:
        eng.import_prefix(meta=pmeta, payload=bytes(ppayload))
    assert not isinstance(ei.value, ValueError)
    eng.add_request("after", [3, 4, 5], SamplingParams(max_new_tokens=2))
    with pytest.raises(EngineStepError, match="tensor-parallel"):
        eng.step()
    assert time.monotonic() - t0 < GROUP_TIMEOUT_S
    del rep, eng, ei
    assert _tp_children() == ports[2]._tp._procs
