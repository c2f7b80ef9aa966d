"""Speculative decoding at ``tp_degree > 1``: the port's k = 2 engine
(the draft whole on rank 0, the verify rows through the two-rank ragged
step, ``serving/tp.py``) against the JAX package's ``tp_degree=2`` spec
engine (8 virtual CPU devices, ``tests/conftest.py``), on the CPU.

Both packages serve the tiny Llama (f32; the reference's seed-0 weights,
carried across by ``models.convert.llama_state_from_jax``) with the
draft equal to the target and ``num_spec_tokens=2``; the port's draft is
the target model object itself, which the k = 2 engine copies before
the hand-off cuts the target down to rank 0's shards. Checked on
``scripts/tp_smoke.py``'s workload (six requests, three sharing a
prefix) as it is (greedy and sampled requests) and all sampled: the
same tokens and the same proposed and accepted draft counts as the JAX
engine, and as the port's one-rank spec engine.
"""
import dataclasses
import gc
import importlib.util
import os

import numpy as np
import pytest
import torch

from paddle_tpu.serving import EngineConfig as JEngineConfig
from paddle_tpu.serving import LLMEngine as JLLMEngine
from paddle_tpu_torch.models.convert import llama_state_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams


def _load_tp_smoke():
    spec = importlib.util.spec_from_file_location(
        "tp_smoke", os.path.join(os.path.dirname(__file__), os.pardir,
                                 "scripts", "tp_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tp_smoke = _load_tp_smoke()
_SP_FIELDS = [f.name for f in dataclasses.fields(SamplingParams)]
SPEC = dict(block_size=4, max_num_seqs=4, max_model_len=64, num_blocks=48,
            drain_grace_s=0.0, num_spec_tokens=2)


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
    m = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    m.load_state_dict(llama_state_from_jax(jax_state))
    return m.eval()


def _port_engine(jax_state, tp):
    m = _port_model(jax_state)
    return LLMEngine(m, EngineConfig(tp_degree=tp, draft_model=m, **SPEC))


@pytest.fixture(scope="module")
def engines(jax_model, jax_state):
    """{"port2": k = 2, "port1": k = 1, "jax": JAX tp_degree=2}, each a
    spec engine whose draft is its target."""
    out = {"port2": _port_engine(jax_state, 2),
           "port1": _port_engine(jax_state, 1),
           "jax": JLLMEngine(jax_model, JEngineConfig(
               tp_degree=2, draft_model=jax_model, **SPEC))}
    yield out
    out.clear()
    gc.collect()


def _workload(kind):
    prompts, jsps = tp_smoke.make_workload(256)
    if kind == "sampled":
        jsps = [dataclasses.replace(sp, temperature=0.8, top_k=0, top_p=1.0,
                                    seed=100 + i)
                for i, sp in enumerate(jsps)]
    return prompts, jsps


def _serve(eng, kind, jax):
    """The workload through ``eng`` (request ids ``<kind>-<i>``): the
    tokens and the engine's draft counters over the run."""
    prompts, jsps = _workload(kind)
    before = (eng.num_spec_proposed, eng.num_spec_accepted)
    rids = []
    for i, (p, sp) in enumerate(zip(prompts, jsps)):
        if not jax:
            sp = SamplingParams(**{f: getattr(sp, f) for f in _SP_FIELDS})
        rids.append(eng.add_request(f"{kind}-{i}", p, sampling=sp))
    steps = 0
    while eng.has_unfinished():
        eng.step()
        eng.block_manager.check_invariants()
        steps += 1
        assert steps < 600
    return ({r: list(eng.get_request(r).generated) for r in rids},
            eng.num_spec_proposed - before[0],
            eng.num_spec_accepted - before[1])


@pytest.mark.parametrize("kind", ["workload", "sampled"])
def test_tp2_spec_matches_the_reference(engines, kind):
    got = {name: _serve(eng, kind, name == "jax")
           for name, eng in engines.items()}
    tokens, proposed, accepted = got["port2"]
    assert got["port2"] == got["jax"]
    assert got["port2"] == got["port1"]
    assert proposed > 0 and 0 <= accepted <= proposed
    if kind == "workload":
        # its greedy rows accept the target's own proposals (at 0.8 over
        # the tiny model's flat distributions few draws hit the draft)
        assert accepted > 0
    assert all(len(v) == sp.max_new_tokens
               for v, sp in zip(tokens.values(), _workload(kind)[1]))


def test_the_draft_runs_whole_on_rank0(engines):
    """The k = 2 engine's draft is a whole copy of the target taken
    before the hand-off: the target holds rank 0's shards, the draft
    every head."""
    eng = engines["port2"]
    draft = eng._spec.model
    assert draft is not eng.model
    assert getattr(draft, "_tp_shard", None) is None
    assert eng.model._tp_shard == (0, 2)
    full = {n: p.shape for n, p in draft.named_parameters()}
    for name, p in eng.model.named_parameters():
        lay = eng.param_layouts()[name]
        assert tuple(p.shape) == lay.local_shape(tuple(full[name])), name
    attn = draft.llama.layers[0].self_attn
    assert (attn.n_heads, attn.n_kv) == (4, 2)
    assert eng.spec_acceptance_rate > 0
