"""Tiered KV at ``tp_degree > 1``: the port's k = 2 tiered engine (two
gloo processes, each with its shard of the host pool and of the host
tier's device mirror, ``serving/tp.py``) against the JAX package's
``tp_degree=2`` tiered engine (8 virtual CPU devices,
``tests/conftest.py``), on the CPU.

Both packages serve the tiny Llama (f32; the reference's seed-0 weights,
carried across by ``models.convert.llama_state_from_jax``) with block 4,
``max_model_len`` 96, 8 device blocks and 24 host blocks (the JAX engine
refuses the default host tier at 8 device blocks: a full-length request
needs 24 blocks). One engine per package serves every test in turn, each
test running the same operations on both. Checked:

* a request past the device pool (a 60-token prompt and 12 new tokens,
  16 blocks of an 8-block pool), greedy and sampled: the same tokens as
  the JAX engine and as an unconstrained one-rank engine, blocks demoted
  on both, the block manager's invariants after every step;
* the host tier's frames: rank r's host pool is frame r of the JAX
  engine's ``(tp, L, NHB, BS, KH/tp, D)`` pool, within 1e-5 (the two
  packages' f32 products round differently);
* a parked session: its tail framed per rank, ``(tp, L, 1, BS, KH/tp,
  D)``, within 1e-5 of the JAX package's ``SessionRecord.tail_k``; the
  resume reuses the whole chain (0 recomputed tokens) and the next turn
  gives the JAX package's tokens.
"""
import gc

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.serving import EngineConfig as JEngineConfig
from paddle_tpu.serving import LLMEngine as JLLMEngine
from paddle_tpu.serving import SamplingParams as JSamplingParams
from paddle_tpu_torch.models.convert import llama_state_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams

TIERS = dict(block_size=4, max_num_seqs=4, max_model_len=96, num_blocks=8,
             kv_tiers={"num_host_blocks": 24}, drain_grace_s=0.0)


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
    paddle.seed(0)
    m = JLlama(JLlamaConfig.tiny())
    m.eval()
    return m


@pytest.fixture(scope="module")
def jax_state(jax_model):
    return {k: np.asarray(v.numpy())
            for k, v in jax_model.state_dict().items()}


def _port_model(jax_state):
    m = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    m.load_state_dict(llama_state_from_jax(jax_state))
    return m.eval()


@pytest.fixture(scope="module")
def engines(jax_model, jax_state):
    """(port k = 2 tiered engine, JAX tp_degree=2 tiered engine)."""
    pair = (LLMEngine(_port_model(jax_state),
                      EngineConfig(tp_degree=2, **TIERS)),
            JLLMEngine(jax_model, JEngineConfig(tp_degree=2, **TIERS)))
    yield pair
    del pair
    gc.collect()


@pytest.fixture(scope="module")
def unconstrained(jax_state):
    """A one-rank untiered port engine with room for everything."""
    return LLMEngine(_port_model(jax_state), EngineConfig(
        block_size=4, max_num_seqs=4, max_model_len=96, num_blocks=256))


def _sp(kind, n, jax=False):
    kw = dict(max_new_tokens=n)
    if kind == "sampled":
        kw.update(temperature=0.8, top_k=20, seed=7)
    return (JSamplingParams if jax else SamplingParams)(**kw)


def _serve(eng, rid, prompt, sp):
    """Serve one request to the end, the block manager's invariants
    after every step; its generated tokens."""
    eng.add_request(rid, prompt, sampling=sp)
    steps = 0
    while eng.has_unfinished():
        eng.step()
        eng.block_manager.check_invariants()
        steps += 1
        assert steps < 600
    if eng._kvtier is not None:
        eng._kvtier.apply_moves()
        eng.block_manager.check_invariants()
    return list(eng.get_request(rid).generated)


def _prompt(seed, n):
    rng = np.random.default_rng(seed)
    return [int(t) for t in rng.integers(0, 255, size=n)]


@pytest.mark.parametrize("kind", ["greedy", "sampled"])
def test_over_pool_request(engines, unconstrained, kind):
    port, jeng = engines
    prompt = _prompt(5, 60)
    rid = f"over-{kind}"
    demotes = (port.block_manager.num_demotes,
               jeng.block_manager.num_demotes)
    got = _serve(port, rid, prompt, _sp(kind, 12))
    want = _serve(jeng, rid, prompt, _sp(kind, 12, jax=True))
    assert got == want
    assert got == _serve(unconstrained, rid, prompt, _sp(kind, 12))
    assert port.block_manager.num_demotes > demotes[0]
    assert jeng.block_manager.num_demotes > demotes[1]
    assert port.block_manager.num_demotes - demotes[0] == \
        jeng.block_manager.num_demotes - demotes[1]
    assert port.tier_stats() == jeng.tier_stats()
    # rank 0 keeps its kv heads of the mirror; so does each worker
    assert tuple(port._htk.shape) == (2, 24, 4, 1, 16)


def test_host_tier_frames_match_the_reference(engines):
    port, jeng = engines
    port._swapper.fence()
    hk, hv = port._tp.host_pools(port._host_k, port._host_v)
    assert tuple(hk.shape) == jeng._host_k.shape == (2, 2, 24, 4, 1, 16)
    for g, w in ((hk, jeng._host_k), (hv, jeng._host_v)):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_array_equal(g == 0, w == 0)
        assert g.any()
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["greedy", "sampled"])
def test_parked_session_resumes_with_zero_recompute(engines, kind):
    port, jeng = engines
    prompt = _prompt(9, 22)                     # 22 + 8: a partial tail
    sid = f"s-{kind}"
    turn1 = _serve(port, sid, prompt, _sp(kind, 8))
    assert turn1 == _serve(jeng, sid, prompt, _sp(kind, 8, jax=True))
    tails = []
    for eng in (port, jeng):
        eng.release_request(sid)
        info = eng.park_session(sid)
        assert info["parked"] and info["tokens_covered"] == 29
        rec = eng._kvtier.sessions[sid]
        tails.append((rec.tail_k, rec.tail_v))
    for got, want in zip(*tails):
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape == (2, 2, 1, 4, 1, 16)
        np.testing.assert_array_equal(got == 0, want == 0)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    prompt2 = prompt + turn1 + [1, 2, 3]
    turn2 = {}
    for eng, jax in ((port, False), (jeng, True)):
        before = eng._kvtier.num_resume_recomputed_tokens
        hit = eng.resume_session(f"{sid}-2", sid, prompt2,
                                 sampling=_sp(kind, 6, jax))
        assert hit == 29
        assert eng._kvtier.num_resume_recomputed_tokens == before
        steps = 0
        while eng.has_unfinished():
            eng.step()
            eng.block_manager.check_invariants()
            steps += 1
            assert steps < 600
        turn2[jax] = list(eng.get_request(f"{sid}-2").generated)
    assert turn2[False] == turn2[True]
    s = port.metrics.snapshot()
    assert s["serving_kv_tier_park_resumes"] >= 1
