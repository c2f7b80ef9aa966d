"""The port's fleet transport against the JAX package's:
``tests/test_fleet_transport.py`` (framing, the RPC client, loopback
replicas, the KV ship over the frame, the hand-off budget, the
registry's monotonic clock, the replicated storm) runs again with every
JAX-package name bound to the port's, through
``test_torch_fleet.ported`` (see that module's docstring).

Then across the packages: a request prefilled by one package's engine
ships its KV (``export_kv``) to the other's (``import_kv``), which
decodes the JAX package's greedy and sampled tokens, and a cached
prefix ships the same way (``export_prefix`` / ``import_prefix``); in
both directions the importer's re-export is the same wire message, meta
and payload byte for byte. A bf16 ship is the cache's raw 2-byte words,
and corrupt, mistyped or short payloads are refused before any block is
claimed."""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import test_fleet_transport
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.serving import EngineConfig as JEngineConfig
from paddle_tpu.serving import LLMEngine as JLLMEngine
from paddle_tpu.serving import SamplingParams as JSamplingParams
from paddle_tpu.serving.block_manager import prefix_chain_hashes
from paddle_tpu_torch.serving import EngineConfig as TEngineConfig
from paddle_tpu_torch.serving import LLMEngine as TLLMEngine
from paddle_tpu_torch.serving import SamplingParams as TSamplingParams
from test_torch_fleet import (  # noqa: F401
    PortTinyLlama, _one_torch_thread, export,
)

PORT = export(test_fleet_transport, globals())


# ---------------------------------------------------------------------------
# across the packages: a ship exported by one imports into the other
# ---------------------------------------------------------------------------
_JAX = dict(engine=JLLMEngine, config=JEngineConfig, sp=JSamplingParams)
_TORCH = dict(engine=TLLMEngine, config=TEngineConfig, sp=TSamplingParams)
_XCFG = dict(block_size=4, max_num_seqs=4, max_model_len=64)
_DIRECTIONS = {"jax_to_torch": (_JAX, _TORCH), "torch_to_jax": (_TORCH, _JAX)}


@pytest.fixture(scope="module")
def pair_models():
    jpaddle.seed(0)
    jm = JLlama(JLlamaConfig.tiny())
    jm.eval()
    return {id(_JAX): jm, id(_TORCH): PortTinyLlama()}


def _xsp(side, sampled, n):
    if sampled:
        return side["sp"](max_new_tokens=n, temperature=0.8, top_k=20,
                          seed=11)
    return side["sp"](max_new_tokens=n)


def _finish(eng, rid):
    steps = 0
    while eng.has_unfinished():
        eng.step()
        steps += 1
        assert steps < 200
    return list(eng.get_request(rid).generated)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("direction", sorted(_DIRECTIONS))
def test_cross_package_kv_ship(pair_models, direction, sampled):
    """A request prefilled by one package's engine is exported
    (``export_kv``) and imported (``import_kv``) by the other's, which
    decodes the rest: the tokens equal the JAX package's single engine,
    and the importer's own export of the landed KV is the same wire
    message, meta and payload byte for byte."""
    src_side, dst_side = _DIRECTIONS[direction]
    rng = np.random.default_rng(3)
    prompt = [int(t) for t in rng.integers(0, 256, size=23)]
    n = 10
    ref_eng = JLLMEngine(pair_models[id(_JAX)], JEngineConfig(**_XCFG))
    ref_eng.add_request("x", prompt, sampling=_xsp(_JAX, sampled, n))
    ref = _finish(ref_eng, "x")

    src = src_side["engine"](pair_models[id(src_side)],
                             src_side["config"](**_XCFG))
    src.add_request("x", prompt, sampling=_xsp(src_side, sampled, n))
    src.step()                          # prefill + the first token
    req = src.get_request("x")
    first = list(req.generated)
    assert first == ref[:1] and req.num_cached == len(prompt)
    meta, payload = src.export_kv("x")
    key = [int(k) for k in req.device_key]

    dst = dst_side["engine"](pair_models[id(dst_side)],
                             dst_side["config"](**_XCFG))
    dst.import_kv("x", prompt + first,
                  sampling=_xsp(dst_side, sampled, n - 1), meta=meta,
                  payload=bytes(payload),
                  rng_state={"numpy": None, "device_key": key})
    assert dst.num_continuation_admits == 1
    again = dst.export_kv("x")
    assert again[0] == meta
    assert again[1] == payload
    assert first + _finish(dst, "x") == ref
    assert dst.metrics.num_prompt_tokens == 1   # only the new token


@pytest.mark.parametrize("direction", sorted(_DIRECTIONS))
def test_cross_package_prefix_ship(pair_models, direction):
    """A cached prefix exported by one package (``export_prefix``) lands
    in the other's trie (``import_prefix``): a request over it there
    hits the shipped blocks, computes only its own tail and serves the
    JAX package's tokens; the importer re-exports the same message."""
    src_side, dst_side = _DIRECTIONS[direction]
    rng = np.random.default_rng(4)
    header = [int(t) for t in rng.integers(0, 256, size=12)]
    tail = [int(t) for t in rng.integers(0, 256, size=5)]
    src = src_side["engine"](pair_models[id(src_side)],
                             src_side["config"](**_XCFG))
    src.add_request("warm", header + [7, 7], sampling=_xsp(src_side, 0, 2))
    _finish(src, "warm")
    src.release_request("warm")
    chain = prefix_chain_hashes(header, 4)[-1]
    assert chain in src.prefix_digest()["h"]
    meta, payload = src.export_prefix(chain)

    dst = dst_side["engine"](pair_models[id(dst_side)],
                             dst_side["config"](**_XCFG))
    assert dst.import_prefix(meta=meta, payload=bytes(payload)) == 12
    assert dst.num_prefix_imports == 1
    again = dst.export_prefix(chain)
    assert again[0] == meta and again[1] == payload
    dst.add_request("hit", header + tail, sampling=_xsp(dst_side, 0, 6))
    got = _finish(dst, "hit")
    assert dst.metrics.num_prompt_tokens == len(tail)

    ref_eng = JLLMEngine(pair_models[id(_JAX)], JEngineConfig(**_XCFG))
    ref_eng.add_request("hit", header + tail, sampling=_xsp(_JAX, 0, 6))
    assert got == _finish(ref_eng, "hit")


def test_bf16_wire_is_raw_words_and_round_trips(pair_models):
    """A bf16 cache ships as its 2-byte words under dtype name
    ``bfloat16`` (numpy has no bfloat16 here), byte-equal on re-export,
    and a corrupted byte, a wrong dtype name or a short payload are
    refused with ``ValueError`` before any block is claimed."""
    tm = pair_models[id(_TORCH)]
    cfg = dict(_XCFG, dtype="bfloat16")
    src = TLLMEngine(tm, TEngineConfig(**cfg))
    prompt = list(range(1, 15))
    src.add_request("b", prompt, sampling=TSamplingParams(max_new_tokens=3))
    src.step()
    meta, payload = src.export_kv("b")
    assert meta["dtype"] == "bfloat16"
    assert len(payload) == 2 * 2 * int(np.prod(meta["shape"]))
    dst = TLLMEngine(tm, TEngineConfig(**cfg))
    free = dst.block_manager.num_free_blocks
    bad = bytearray(payload)
    bad[5] ^= 0xFF
    for m, p in ((meta, bytes(bad)), (dict(meta, dtype="float32"), payload),
                 (meta, payload[:-2])):
        with pytest.raises(ValueError):
            dst.import_kv("b", prompt + [1], sampling=TSamplingParams(
                max_new_tokens=2), meta=m, payload=p)
        assert dst.block_manager.num_free_blocks == free
    dst.import_kv("b", prompt + list(src.get_request("b").generated),
                  sampling=TSamplingParams(max_new_tokens=2), meta=meta,
                  payload=payload)
    assert dst.export_kv("b") == (meta, payload)
    table = dst.block_manager.export_blocks("b", meta["tokens_covered"])
    stable = src.block_manager.export_blocks("b", meta["tokens_covered"])
    # landed in place, bit for bit
    assert torch.equal(dst._kcs[:, table], src._kcs[:, stable])
    assert torch.equal(dst._vcs[:, table], src._vcs[:, stable])
