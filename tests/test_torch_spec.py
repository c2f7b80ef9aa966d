"""Speculative decoding in the port against the JAX package's.

The same inputs, made from numpy seeds, go through both packages on the
CPU in f32: ``forward_ragged_multi`` logits (allclose at 1e-5, pad slots
and rows shorter than R included), ``SpecDecoder.propose`` proposals
(identical), the scenarios of ``tests/test_spec_decode.py`` through both
engines (identical tokens, final keys and spec counters), the
``rng_state`` hand-off between the packages in both directions
(identical streams). The ``trim`` and verify-row storms are the
``spec`` cases of the storms in ``tests/test_torch_serving.py``. The
weights are the JAX tiny models', carried across
with ``llama_state_from_jax``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.ops import sampling as jsampling
from paddle_tpu.serving import EngineConfig as JEngineConfig
from paddle_tpu.serving import LLMEngine as JLLMEngine
from paddle_tpu.serving import SamplingParams as JSamplingParams
from paddle_tpu.serving.spec import SpecDecoder as JSpecDecoder
from paddle_tpu_torch import profiler as tprofiler
from paddle_tpu_torch.models.convert import llama_state_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import sampling as tsampling
from paddle_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams
from paddle_tpu_torch.serving.spec import SpecDecoder
from paddle_tpu_torch.tools.step_checks import (bucket_keys,
                                                padding_is_inert,
                                                record_step_sizes)


def _pair(seed):
    paddle.seed(seed)
    jm = JLlama(JLlamaConfig.tiny())
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    tm.load_state_dict(llama_state_from_jax(state))
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _pair(0)


@pytest.fixture(scope="module")
def garbage():
    """Same shape, other weights: proposes near-uniformly wrong tokens."""
    return _pair(777)


def _prompts(seed, vocab, lens):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, vocab, size=n))) for n in lens]


# ---------------------------------------------------------------------------
# the model gather and the proposer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("r", [1, 3, 5])
def test_forward_ragged_multi_matches_jax(models, r):
    """Three live slots of 4, 1 and 2 rows (two shorter than R = 3 or 5)
    mid-context, a pad slot, two padding rows past cu[num_seqs]: the
    (S, R, V) logits agree at 1e-5 (f32, summation order only)."""
    jm, tm = models
    cfg = tm.config
    rng = np.random.default_rng(r)
    nl, nb, bs = cfg.num_hidden_layers, 16, 4
    kh = cfg.num_key_value_heads
    d = cfg.hidden_size // cfg.num_attention_heads
    kc = rng.standard_normal((nl, nb, bs, kh, d)).astype(np.float32)
    vc = rng.standard_normal((nl, nb, bs, kh, d)).astype(np.float32)
    cu = np.array([0, 4, 5, 7, 7], np.int32)
    ctx = np.array([9, 5, 2, 0], np.int32)
    bt = np.full((4, 4), -1, np.int32)
    bt[0, :3], bt[1, :2], bt[2, :1] = [0, 1, 2], [3, 4], [5]
    ids = rng.integers(0, cfg.vocab_size, 9).astype(np.int32)
    want, _, _ = jm.forward_ragged_multi(
        jnp.asarray(ids), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(bt), jnp.asarray(cu), jnp.asarray(ctx),
        jnp.asarray(np.int32(3)), np.arange(r, dtype=np.int32))
    want = np.asarray(want._data)
    got, _, _ = tm.forward_ragged_multi(
        torch.from_numpy(ids), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(bt), torch.from_numpy(cu), torch.from_numpy(ctx),
        torch.tensor([3], dtype=torch.int32), r)
    assert tuple(got.shape) == want.shape == (4, r, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("which", ["target", "garbage"])
def test_spec_decoder_propose_matches_jax(models, garbage, k, which):
    """Five prefixes of 1-13 tokens (batch bucket 8, width bucket 16):
    identical (5, k) greedy proposals."""
    jm, tm = models if which == "target" else garbage
    lists = _prompts(40 + k, 256, [5, 13, 1, 8, 3])
    want = JSpecDecoder(jm, k).propose(lists)
    got = SpecDecoder(tm, k).propose(lists)
    assert got.dtype == np.int32 and got.shape == (5, k)
    np.testing.assert_array_equal(got, np.asarray(want))


# ---------------------------------------------------------------------------
# the test_spec_decode.py scenarios through both engines
# ---------------------------------------------------------------------------
def _serve(eng, sp_cls, prompts, samplings):
    rids = [eng.add_request(f"s{i}", p, sampling=sp_cls(**sp))
            for i, (p, sp) in enumerate(zip(prompts, samplings))]
    steps = 0
    while eng.has_unfinished():
        eng.step()
        eng.block_manager.check_invariants()
        steps += 1
        assert steps < 500, "engine failed to converge"
    reqs = [eng.get_request(r) for r in rids]
    return {"tokens": [r.generated for r in reqs],
            "keys": [[int(x) for x in r.device_key] for r in reqs],
            "finish": [r.finish_reason for r in reqs],
            "proposed": eng.num_spec_proposed,
            "accepted": eng.num_spec_accepted, "steps": steps,
            "free": eng.block_manager.num_free_blocks == eng.cfg.num_blocks}


def _both(pair, draft_pair, k, prompts, samplings, **kw):
    kw.setdefault("block_size", 4)
    j = _serve(JLLMEngine(pair[0], JEngineConfig(
        draft_model=draft_pair[0], num_spec_tokens=k, **kw)),
        JSamplingParams, prompts, samplings)
    te = LLMEngine(pair[1], EngineConfig(
        draft_model=draft_pair[1], num_spec_tokens=k, **kw))
    sizes = record_step_sizes(te)
    t = _serve(te, SamplingParams, prompts, samplings)
    # the target steps at the lattice buckets its step sizes round up to
    # (the JAX engine: one shape), the draft at its (batch, width) ones
    assert te._seen_shapes == bucket_keys(te, sizes)
    assert set(te._spec.graphs.keys) <= {
        ("draft", b, w) for b in (1, 2, 4, 8) for w in (8, 16, 32, 64)}
    return j, t


def test_spec_greedy_perfect_draft_is_identical(models):
    """Draft == target, k = 3: every proposal verifies, tokens equal the
    non-speculative engine's in fewer steps; tokens, keys and counters
    equal the JAX engine's."""
    prompts = _prompts(3, 256, [4, 7, 3, 9])
    sps = [dict(max_new_tokens=8)] * 4
    j, t = _both(models, models, 3, prompts, sps)
    assert t == j
    base = LLMEngine(models[1], EngineConfig(block_size=4))
    b = _serve(base, SamplingParams, prompts, sps)
    assert t["tokens"] == b["tokens"] and t["steps"] < b["steps"]
    assert t["proposed"] > 0 and t["accepted"] / t["proposed"] > 0.9
    assert t["free"]


def test_spec_greedy_garbage_draft_is_identical(models, garbage):
    """A bad draft costs acceptance, never correctness: tokens equal the
    baseline engine's and the JAX engine's; the rollback returns every
    block."""
    prompts = _prompts(4, 256, [5, 8, 3])
    sps = [dict(max_new_tokens=6)] * 3
    j, t = _both(models, garbage, 2, prompts, sps)
    assert t == j
    b = _serve(LLMEngine(models[1], EngineConfig(block_size=4)),
               SamplingParams, prompts, sps)
    assert t["tokens"] == b["tokens"]
    assert t["proposed"] > 0 and t["free"]


def test_spec_eos_inside_accepted_prefix_is_identical(models):
    """EOS at a position whose token first occurs there, inside an
    accepted draft prefix: emission stops at EOS in both engines."""
    prompt = _prompts(6, 256, [6])[0]
    base = LLMEngine(models[1], EngineConfig(block_size=4)).generate(
        [prompt], SamplingParams(max_new_tokens=8))[0]
    stop_at = next(i for i in range(2, 7) if base[i] not in base[:i])
    sps = [dict(max_new_tokens=8, eos_token_id=base[stop_at])]
    j, t = _both(models, models, 3, [prompt], sps)
    assert t == j
    assert t["finish"] == ["stop"]
    assert t["tokens"][0] == base[:stop_at + 1]
    assert t["free"]


def test_spec_sampled_is_identical(models, garbage):
    """Seeded sampled requests (temperature 0.8, top-p 0.9; one top-k
    50) through both speculative engines, perfect and garbage drafts:
    identical tokens, keys and counters."""
    prompts = _prompts(8, 256, [5, 7, 4])
    sps = [dict(max_new_tokens=6, temperature=0.8, top_p=0.9,
                seed=100 + i) for i in range(3)]
    sps[2]["top_k"] = 50
    for draft in (models, garbage):
        j, t = _both(models, draft, 2, prompts, sps)
        assert t == j
        assert t["proposed"] > 0


@pytest.mark.parametrize("case", ["all_rejected", "fully_accepted"])
def test_verify_edge_cases_are_identical(case):
    """Greedy target with every draft wrong (one corrected token per
    slot: the argmax of the first verify row), or every draft right (all
    k accepted plus the bonus): identical to the JAX sampler."""
    rng = np.random.default_rng(0 if case == "all_rejected" else 1)
    s, r, v = 4, 3, 32
    logits = rng.normal(size=(s, r, v)).astype(np.float32)
    am = np.argmax(logits, axis=-1)
    draft = (am[:, :r - 1] + (1 if case == "all_rejected" else 0)) % v
    draft = draft.astype(np.int32)
    keys = rng.integers(0, 2 ** 32, size=(s, 2), dtype=np.uint32)
    nd = np.full((s,), r - 1, np.int32)
    zf, zi, one = (np.zeros((s,), np.float32), np.zeros((s,), np.int32),
                   np.ones((s,), np.float32))
    jt, jn, jk = jsampling.sample_or_verify(
        *(jnp.asarray(x) for x in (logits, draft, nd, keys, zf, zi, one)))
    tt, tn, tk = tsampling.sample_or_verify(
        *(torch.from_numpy(x) for x in (logits, draft, nd,
                                        keys.astype(np.int64), zf, zi,
                                        one)))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tk.numpy(),
                                  np.asarray(jk).astype(np.int64))
    if case == "all_rejected":
        assert (tn.numpy() == 1).all()
        np.testing.assert_array_equal(tt.numpy()[:, 0], am[:, 0])
    else:
        assert (tn.numpy() == r).all()
        np.testing.assert_array_equal(tt.numpy(), am)
    np.testing.assert_array_equal(tt.numpy()[:, :1], np.asarray(jt)[:, :1])


def test_k0_is_the_baseline_engine(models):
    eng = LLMEngine(models[1], EngineConfig(block_size=4))
    assert eng._spec is None and eng._spec_R == 1
    eng.add_request([5, 9, 2], SamplingParams(max_new_tokens=4))
    eng.run()
    assert eng.num_spec_proposed == 0 and eng.spec_acceptance_rate == 0.0


def test_spec_gauges_reach_snapshot_and_counters(models):
    _, tm = models
    eng = LLMEngine(tm, EngineConfig(block_size=4, draft_model=tm,
                                     num_spec_tokens=2))
    eng.generate(_prompts(9, 256, [5, 6]), SamplingParams(max_new_tokens=6))
    snap = eng.metrics.snapshot()
    assert snap["serving_spec_proposed"] == eng.num_spec_proposed > 0
    assert snap["serving_spec_accepted"] == eng.num_spec_accepted
    assert snap["serving_spec_acceptance_rate"] == round(
        eng.spec_acceptance_rate, 4)
    c = tprofiler.counters()
    assert c[f"serving/spec_proposed#{id(eng)}"] == eng.num_spec_proposed
    assert c[f"serving/spec_acceptance_rate#{id(eng)}"] == \
        eng.spec_acceptance_rate


def test_draft_on_another_device_raises(models):
    _, tm = models

    class Elsewhere:
        config = tm.config
        device = torch.device("cuda", 0)

    with pytest.raises(ValueError, match="one device"):
        LLMEngine(tm, EngineConfig(draft_model=Elsewhere(),
                                   num_spec_tokens=2))


# ---------------------------------------------------------------------------
# rng_state hand-off between the packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_rng_state_hand_off_continues_the_stream(models, direction):
    """A sampled request runs 3 steps in one package; the other resumes
    it from prompt + generated and its ``device_key``: the whole stream
    equals an uninterrupted run of the first package."""
    jm, tm = models
    sides = {"jax": (JLLMEngine, JEngineConfig, JSamplingParams, jm),
             "torch": (LLMEngine, EngineConfig, SamplingParams, tm)}
    src, dst = direction.split("_to_")
    prompt = _prompts(12, 256, [7])[0]
    kw = dict(max_new_tokens=9, temperature=0.9, top_k=40, seed=5)

    def engine(side):
        eng_cls, cfg_cls, sp_cls, m = sides[side]
        return eng_cls(m, cfg_cls(block_size=4)), sp_cls

    ref, sp_cls = engine(src)
    ref.add_request("h", prompt, sampling=sp_cls(**kw))
    ref.run()
    full = ref.get_request("h").generated

    first, sp_cls = engine(src)
    first.add_request("h", prompt, sampling=sp_cls(**kw))
    for _ in range(3):
        first.step()
    req = first.get_request("h")
    head = list(req.generated)
    key = [int(x) for x in req.device_key]
    assert len(head) == 3

    second, sp_cls = engine(dst)
    rest = dict(kw, max_new_tokens=kw["max_new_tokens"] - len(head))
    second.add_request("h", prompt + head, sampling=sp_cls(**rest),
                       rng_state={"device_key": key})
    second.run()
    assert head + second.get_request("h").generated == full


def test_padded_verify_step_equals_the_exact_step(models):
    """At a verify batch (R = 4: draft == target, k = 3; 1+3-token rows
    in a padded bucket), ``_device_step`` on the bucket's padded buffers
    and on buffers of the exact token count gives identical packed rows
    and identical cache bytes: the pad rows are inert."""
    _, tm = models
    eng = LLMEngine(tm, EngineConfig(block_size=4, draft_model=tm,
                                     num_spec_tokens=3))
    assert eng._spec_R == 4
    for i, p in enumerate(_prompts(10, 256, [5, 7, 4])):
        eng.add_request(f"v{i}", p, SamplingParams(max_new_tokens=8))
    dispatch, checked = eng._dispatch, []

    def checking(reqs, key, arrays):
        if arrays[-1].any() and int(arrays[2][len(reqs)]) < key[1]:
            checked.append(padding_is_inert(eng, reqs, arrays))
        return dispatch(reqs, key, arrays)

    eng._dispatch = checking
    eng.run()
    assert checked, "no padded verify step"
    for res in checked:
        assert res["packed"] and res["key_cache"] and res["value_cache"], res
        assert res["widths"][0] > res["widths"][1] >= 6
