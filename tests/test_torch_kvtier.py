"""The port's tiered KV against the JAX package's.

``tests/test_kvtier.py``'s one-engine classes run through both packages
on the same inputs (the tiny Llama's weights carried across with
``llama_state_from_jax``): the config and its guards
(``TestTiersConfig``), the BlockManager's tier mechanics with their move
ledgers, tables and counters compared exactly (``TestTierMechanics``), a
request whose context exceeds the device pool (``TestOverPool``) and
session park / resume (``TestParkResume``), greedy and sampled tokens
identical across the packages and to an unconstrained engine. The
fleet's classes (``TestFleetSessions``: holder affinity, the watermark
offload to a peer, a dead holder; ``TestMigrationStorm``) run on the
port through ``test_torch_fleet.ported`` (every JAX-package name bound
to the port's; the tiny Llama carries the JAX package's weights), their
tokens held against the port's single engine, which the classes above
hold against the JAX package's.

Then the ragged attention's second pool: the port's plain version with
the host tier's mirror against the JAX package's ``_ragged_attend_ref``
on the concatenated caches (the JAX tiered step's form), with virtual
entries inside the causal range, f32 at the tolerance of
``tests/test_torch_ragged_attention.py`` (rtol = atol = 2e-5); and a row
whose block-table entry is virtual is dropped from the write.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.ops.pallas import ragged_paged_attention as jrpa
from paddle_tpu.serving import EngineConfig as JEngineConfig
from paddle_tpu.serving import LLMEngine as JLLMEngine
from paddle_tpu.serving import SamplingParams as JSamplingParams
from paddle_tpu.serving.block_manager import BlockManager as JBlockManager
from paddle_tpu.serving.kvtier import KVTiersConfig as JKVTiersConfig
from paddle_tpu_torch.models.convert import llama_state_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import ragged_paged_attention as trpa
from paddle_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams
from paddle_tpu_torch.serving.block_manager import BlockManager
from paddle_tpu_torch.serving.kvtier import KVTiersConfig

JAX = dict(engine=JLLMEngine, config=JEngineConfig, sp=JSamplingParams,
           bm=JBlockManager, tiers=JKVTiersConfig)
TORCH = dict(engine=LLMEngine, config=EngineConfig, sp=SamplingParams,
             bm=BlockManager, tiers=KVTiersConfig)
SIDES = (JAX, TORCH)
ATOL = RTOL = 2e-5


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JLlama(JLlamaConfig.tiny())
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    tm.load_state_dict(llama_state_from_jax(state))
    return {id(JAX): jm, id(TORCH): tm}


def _ecfg(side, **kw):
    kw.setdefault("block_size", 4)
    kw.setdefault("max_num_seqs", 8)
    kw.setdefault("max_model_len", 96)
    kw.setdefault("drain_grace_s", 0.0)
    return side["config"](**kw)


def _tiered(side, models, **kw):
    kw.setdefault("kv_tiers", True)
    return side["engine"](models[id(side)], _ecfg(side, **kw))


def _run(eng, max_steps=600):
    steps = 0
    while eng.has_unfinished():
        eng.step()
        steps += 1
        assert steps < max_steps
    if eng._kvtier is not None:
        eng._kvtier.apply_moves()
    eng.block_manager.check_invariants()


def _reference(side, models, rid, prompt, sp):
    """The unconstrained engine: a big device pool, no tiers."""
    eng = side["engine"](models[id(side)], _ecfg(side, num_blocks=256))
    eng.add_request(rid, prompt, sampling=sp)
    _run(eng)
    return list(eng.get_request(rid).generated)


def _sp(side, kind, n=8):
    if kind == "greedy":
        return side["sp"](max_new_tokens=n)
    return side["sp"](max_new_tokens=n, temperature=0.8, top_k=20, seed=7)


def _prompt(seed, n):
    rng = np.random.default_rng(seed)
    return [int(t) for t in rng.integers(0, 255, size=n)]


def _stats(eng):
    st = eng.tier_stats()
    return None if st is None else {k: st[k] for k in sorted(st)}


# ---------------------------------------------------------------------------
# config + guards
# ---------------------------------------------------------------------------
class TestTiersConfig:
    @pytest.mark.parametrize("side", SIDES, ids=["jax", "torch"])
    def test_from_any_forms(self, side):
        C = side["tiers"]
        assert C.from_any(None) is None
        assert C.from_any(False) is None
        assert isinstance(C.from_any(True), C)
        cfg = C.from_any({"num_host_blocks": 12, "host_watermark": 0.5})
        assert (cfg.num_host_blocks, cfg.host_watermark) == (12, 0.5)
        same = C(max_sessions=3)
        assert C.from_any(same) is same
        with pytest.raises(ValueError):
            C.from_any("yes")
        assert vars(C()) == vars(JKVTiersConfig())

    @pytest.mark.parametrize("side", SIDES, ids=["jax", "torch"])
    @pytest.mark.parametrize("kw", [dict(host_watermark=1.5),
                                    dict(num_host_blocks=0),
                                    dict(max_sessions=0),
                                    dict(demote_headroom=0),
                                    dict(promote_headroom=-1)])
    def test_validation(self, side, kw):
        with pytest.raises(ValueError):
            side["tiers"](**kw)

    def test_bucketed_fallback_rejects_tiers(self, models):
        for side in SIDES:
            with pytest.raises(ValueError, match="ragged"):
                side["engine"](models[id(side)],
                               _ecfg(side, ragged=False, kv_tiers=True))

    def test_bucketed_fallback_rejects_tp(self, models):
        """Both packages refuse ``tp_degree > 1`` on the bucketed path,
        with the reference's words."""
        with pytest.raises(ValueError, match="degree-1"):
            JLLMEngine(models[id(JAX)], _ecfg(JAX, ragged=False,
                                              tp_degree=2))
        with pytest.raises(ValueError, match="degree-1"):
            LLMEngine(models[id(TORCH)], _ecfg(TORCH, ragged=False,
                                               tp_degree=2))

    def test_tiers_require_prefix_cache(self, models):
        for side in SIDES:
            with pytest.raises(ValueError, match="prefix"):
                _tiered(side, models, prefix_cache=False)

    def test_tiers_force_host_pool(self, models):
        got = []
        for side in SIDES:
            eng = _tiered(side, models, num_blocks=8)
            assert eng.cfg.num_host_blocks >= eng.cfg.num_blocks
            assert eng.block_manager.reachable_blocks > eng.cfg.num_blocks
            got.append((eng.cfg.num_host_blocks,
                        eng.block_manager.reachable_blocks, _stats(eng),
                        eng.metrics.snapshot()["serving_kv_tier_demotes"]))
        assert got[0] == got[1]

    def test_untiered_engine_gauges_are_zero(self, models):
        for side in SIDES:
            eng = side["engine"](models[id(side)], _ecfg(side))
            snap = eng.metrics.snapshot()
            assert all(snap[f"serving_kv_tier_{g}"] == 0 for g in (
                "demotes", "promotes", "host_blocks_used",
                "peer_blocks_used", "park_resumes"))


# ---------------------------------------------------------------------------
# BlockManager tier mechanics: each scenario on both managers, the
# records (move ledgers, tables, counters, stats) compared exactly
# ---------------------------------------------------------------------------
def _bm(side, **kw):
    kw.setdefault("num_blocks", 8)
    kw.setdefault("block_size", 4)
    kw.setdefault("num_host_blocks", 8)
    kw.setdefault("enable_prefix_cache", True)
    kw.setdefault("tiered", True)
    return side["bm"](**kw)


def _commit_chain(bm, rid, tokens):
    bm.allocate(rid, len(tokens), tokens=tokens)
    bm.commit_prefix(rid, tokens, len(tokens))


def _both(scenario):
    """Run ``scenario(side) -> record`` on both managers; the records
    must be equal."""
    recs = [scenario(side) for side in SIDES]
    assert recs[0] == recs[1], recs
    return recs[1]


class TestTierMechanics:
    def test_demote_cached_free_moves_cold_end(self):
        def run(side):
            bm = _bm(side)
            tokens = list(range(16))
            _commit_chain(bm, "r0", tokens)
            bm.free("r0")
            bm.check_invariants()
            free_before = bm.num_uncached_free_blocks
            got = bm.demote_cached_free(2)
            moves = bm.take_tier_moves()
            after = bm.num_uncached_free_blocks
            table = bm.allocate("r1", 16, tokens=tokens)
            rec = (got, moves, bm.num_demotes, free_before, after, table,
                   bm.last_hit_tokens, bm.take_tier_moves(),
                   bm.host_tier_stats())
            bm.check_invariants()
            return rec

        rec = _both(run)
        got, moves, demotes, before, after, table = rec[:6]
        assert got == 2 == demotes and after == before + 2
        assert [m[0] for m in moves] == ["demote", "demote"]
        assert rec[6] > 0 and any(e >= 8 for e in table)

    def test_promote_blocks_round_trip(self):
        def run(side):
            bm = _bm(side)
            tokens = list(range(16))
            _commit_chain(bm, "r0", tokens)
            bm.free("r0")
            got = bm.demote_cached_free(4)
            bm.take_tier_moves()
            table = bm.allocate("r1", 16, tokens=tokens)
            virt = [e for e in table if bm.is_host_entry(e)]
            before = bm.num_promotes
            promoted = bm.promote_blocks("r1", len(virt))
            moves = bm.take_tier_moves()
            rec = (got, table, virt, promoted, bm.num_promotes - before,
                   moves, bm.block_table("r1"), bm.host_tier_stats())
            bm.check_invariants()
            return rec

        got, _, virt, promoted, delta, moves, table, _ = _both(run)
        assert got == 4 and virt and promoted == len(virt) == delta
        assert all(m[0] == "promote" for m in moves)
        assert all(e < 8 for e in table)

    def test_demote_chain_parks_slots_unowned(self):
        def run(side):
            bm = _bm(side)
            tokens = list(range(16))
            _commit_chain(bm, "r0", tokens)
            bm.free("r0")
            demoted = bm.demote_chain(tokens, len(tokens))
            moves = bm.take_tier_moves()
            parked = bm.host_tier_stats()
            bm.check_invariants()
            table, hit, tail = bm.resume_chain("r1", tokens + [99], 16,
                                               want_tail=False)
            rec = (demoted, moves, parked, table, hit, tail,
                   bm.host_tier_stats(), bm.num_host_blocks_used)
            bm.check_invariants()
            return rec

        demoted, _, parked, _, hit, _, resumed, _ = _both(run)
        assert demoted == 4 and hit == 16
        assert (parked["registered"], parked["used"], parked["free"]) \
            == (4, 0, 8)
        assert resumed["used"] == 4

    def test_demote_chain_skips_referenced_blocks(self):
        def run(side):
            bm = _bm(side)
            tokens = list(range(16))
            _commit_chain(bm, "r0", tokens)
            rec = (bm.demote_chain(tokens, len(tokens)),
                   bm.take_tier_moves())
            bm.check_invariants()
            return rec

        assert _both(run) == (0, [])

    def test_evict_chain_drops_both_tiers(self):
        def run(side):
            bm = _bm(side)
            tokens = list(range(16))
            _commit_chain(bm, "r0", tokens)
            bm.free("r0")
            bm.demote_chain(tokens, len(tokens))
            bm.take_tier_moves()
            rec = (bm.evict_chain(tokens, len(tokens)),
                   bm.host_tier_stats(), bm.match_prefix(tokens),
                   list(bm._free), list(bm._host_free))
            bm.check_invariants()
            return rec

        dropped, st, hit = _both(run)[:3]
        assert dropped == 4 and st["registered"] == 0 and hit == 0

    def test_move_ledger_preserves_order(self):
        def run(side):
            bm = _bm(side, num_blocks=4, num_host_blocks=4)
            tokens = list(range(16))
            _commit_chain(bm, "r0", tokens)
            bm.free("r0")
            bm.demote_chain(tokens, len(tokens))
            table, hit, _ = bm.resume_chain("r1", tokens + [99], 16,
                                            want_tail=False)
            bm.promote_blocks("r1", 4)
            rec = (table, hit, bm.take_tier_moves())
            bm.check_invariants()
            return rec

        kinds = [m[0] for m in _both(run)[2]]
        assert kinds.index("promote") > kinds.index("demote")

    @pytest.mark.parametrize("seed", range(4))
    def test_tiered_storm_matches_the_reference(self, seed):
        """A random sequence of allocations (prefix hits on shared
        prompts), growth under ``append_slot`` with demote-before-OOM,
        commits, frees, parks, resumes, promotions and evictions: every
        ledger, table and counter equal, invariants after each op."""
        def run(side):
            rng = np.random.default_rng(seed)
            bm = _bm(side, num_blocks=12, num_host_blocks=16)
            heads = [list(rng.integers(0, 50, size=8)) for _ in range(3)]
            live, parked, log = {}, [], []
            for i in range(60):
                op = rng.integers(0, 6)
                if op == 0 or not live:
                    rid = f"r{i}"
                    toks = heads[rng.integers(0, 3)] + list(
                        rng.integers(0, 50, size=rng.integers(1, 9)))
                    try:
                        t = bm.allocate(rid, len(toks), tokens=toks)
                        live[rid] = toks
                        log.append(("alloc", rid, t, bm.last_hit_tokens))
                    except Exception as e:
                        log.append(("alloc-oom", type(e).__name__))
                elif op == 1:
                    rid = sorted(live)[rng.integers(0, len(live))]
                    n = len(live[rid]) + int(rng.integers(1, 6))
                    for _ in range(4):
                        try:
                            log.append(("grow", rid,
                                        bm.append_slot(rid, n)))
                            live[rid] = live[rid] + [7] * (
                                n - len(live[rid]))
                            break
                        except Exception as e:
                            got = bm.demote_request_blocks(
                                rid, len(live[rid]) - 1, 4)
                            log.append(("relief", type(e).__name__, got))
                            if not got:
                                break
                elif op == 2:
                    rid = sorted(live)[rng.integers(0, len(live))]
                    bm.commit_prefix(rid, live[rid], len(live[rid]) - 1)
                    toks = live.pop(rid)
                    bm.free(rid)
                    parked.append(toks)
                    log.append(("free", rid))
                elif op == 3 and parked:
                    toks = parked[rng.integers(0, len(parked))]
                    log.append(("park", bm.demote_chain(toks, len(toks))))
                elif op == 4 and parked:
                    toks = parked.pop(rng.integers(0, len(parked)))
                    rid = f"s{i}"
                    t, hit, tail = bm.resume_chain(
                        rid, toks + [1], len(toks) - 1, want_tail=True)
                    log.append(("resume", t, hit, tail))
                    if hit == 0:
                        bm.free(rid)
                    else:
                        live[rid] = toks[:hit]
                        log.append(("promote", bm.promote_blocks(rid, 2)))
                else:
                    log.append(("cached", bm.demote_cached_free(2)))
                log.append(("moves", bm.take_tier_moves(),
                            bm.take_cow_pairs()))
                bm.check_invariants()
            log.append((bm.num_demotes, bm.num_promotes,
                        bm.num_cow_copies, bm.host_tier_stats()))
            return log

        _both(run)


# ---------------------------------------------------------------------------
# over-device-pool serving
# ---------------------------------------------------------------------------
class TestOverPool:
    @pytest.mark.parametrize("kind", ["greedy", "sampled"])
    def test_context_exceeds_device_pool(self, models, kind):
        """40-token prompt + 12 new = 13 blocks against an 8-block device
        pool: both engines demote the request's own cold prefix and
        decode token-identically to each other and to an unconstrained
        run; their tier counters agree."""
        prompt = _prompt(3, 40)
        got = []
        for side in SIDES:
            sp = _sp(side, kind, 12)
            eng = _tiered(side, models, num_blocks=8)
            assert eng.block_manager.reachable_blocks >= 13
            eng.add_request("big", prompt, sampling=sp)
            _run(eng)
            toks = list(eng.get_request("big").generated)
            assert eng.block_manager.num_demotes > 0
            assert toks == _reference(side, models, "big", prompt, sp)
            snap = eng.metrics.snapshot()
            got.append((toks, _stats(eng),
                        [snap[f"serving_kv_tier_{g}"] for g in (
                            "demotes", "promotes", "host_blocks_used")]))
        assert got[0] == got[1]

    def test_admission_rejects_past_reachable(self, models):
        prompt = _prompt(4, 60)
        for side in SIDES:
            eng = _tiered(side, models, num_blocks=4,
                          kv_tiers={"num_host_blocks": 4})
            with pytest.raises(ValueError, match="reachable"):
                eng.add_request("huge", prompt,
                                sampling=side["sp"](max_new_tokens=30))


# ---------------------------------------------------------------------------
# session park / resume (single engine)
# ---------------------------------------------------------------------------
class _TornTail:
    """A tail whose copy to the device dies mid-restore."""

    def to(self, *a, **k):
        raise RuntimeError("torn tail copy")


class TestParkResume:
    @pytest.mark.parametrize("kind", ["greedy", "sampled"])
    @pytest.mark.parametrize("plen", [21, 22],
                             ids=["aligned-tail", "partial-tail"])
    def test_zero_prompt_recompute(self, models, kind, plen):
        got = []
        for side in SIDES:
            rng = np.random.default_rng(plen)
            prompt = [int(t) for t in rng.integers(0, 255, size=plen)]
            sp = _sp(side, kind)
            eng = _tiered(side, models, num_blocks=16)
            eng.add_request("turn1", prompt, sampling=sp)
            _run(eng)
            turn1 = list(eng.get_request("turn1").generated)
            eng.release_request("turn1")
            info = eng.park_session("turn1")
            assert info is not None and info["parked"]
            assert eng.park_session("turn1")["parked"]
            prompt2 = prompt + turn1 + [int(t) for t in
                                        rng.integers(0, 255, size=5)]
            hit = eng.resume_session("turn2", "turn1", prompt2,
                                     sampling=sp)
            assert hit == info["tokens_covered"]
            _run(eng)
            turn2 = list(eng.get_request("turn2").generated)
            kvt = eng._kvtier
            assert kvt.num_resume_recomputed_tokens == 0
            assert kvt.num_park_resumes == 1
            assert eng.metrics.snapshot()[
                "serving_kv_tier_park_resumes"] == 1
            assert turn2 == _reference(side, models, "turn2", prompt2, sp)
            got.append((turn1, turn2, info, hit, _stats(eng),
                        eng.scheduler.num_continuation_resumes))
        assert got[0] == got[1]

    def test_resume_mismatch_keeps_session(self, models):
        prompt = _prompt(9, 12)
        for side in SIDES:
            eng = _tiered(side, models, num_blocks=16)
            eng.add_request("s", prompt, sampling=_sp(side, "greedy"))
            _run(eng)
            eng.park_session("s")
            bad = list(reversed(prompt)) + [1, 2, 3]
            with pytest.raises(ValueError, match="extend"):
                eng.resume_session("s2", "s", bad,
                                   sampling=_sp(side, "greedy"))
            assert eng.session_info("s") is not None

    def test_resume_after_eviction_recomputes(self, models):
        prompt = _prompt(10, 16)
        got = []
        for side in SIDES:
            sp = _sp(side, "greedy")
            eng = _tiered(side, models, num_blocks=16)
            eng.add_request("s", prompt, sampling=sp)
            _run(eng)
            turn1 = list(eng.get_request("s").generated)
            eng.park_session("s")
            rec = eng._kvtier.sessions["s"]
            eng.block_manager.evict_chain(rec.tokens, rec.covered)
            prompt2 = prompt + turn1 + [5, 6, 7]
            hit = eng.resume_session("s2", "s", prompt2, sampling=sp)
            assert hit == 0
            _run(eng)
            stats = eng.tier_stats()
            assert stats["resume_recomputes"] == 1
            assert stats["resume_recomputed_tokens"] > 0
            turn2 = list(eng.get_request("s2").generated)
            assert turn2 == _reference(side, models, "s2", prompt2, sp)
            got.append((turn1, turn2, _stats(eng)))
        assert got[0] == got[1]

    def test_torn_tail_restore_frees_resumed_claim(self, models):
        """A tail restore that dies mid-copy frees the whole resumed
        claim and keeps the session, so the same resume retries
        cleanly (the reference's fault is raised by its cache pinning,
        the port's by the tail's copy to the device)."""
        prompt = _prompt(13, 22)
        got = []
        for side in SIDES:
            sp = _sp(side, "greedy")
            eng = _tiered(side, models, num_blocks=16)
            eng.add_request("s", prompt, sampling=sp)
            _run(eng)
            turn1 = list(eng.get_request("s").generated)
            eng.release_request("s")
            info = eng.park_session("s")
            prompt2 = prompt + turn1 + [1, 2, 3]
            rec = eng._kvtier.sessions["s"]
            if side is JAX:
                def torn(*a):
                    raise RuntimeError("torn tail copy")
                eng._pin_caches = torn
            else:
                saved = rec.tail_k
                rec.tail_k = _TornTail()
            try:
                with pytest.raises(RuntimeError, match="torn tail copy"):
                    eng.resume_session("s2", "s", prompt2, sampling=sp)
            finally:
                if side is JAX:
                    del eng._pin_caches
                else:
                    rec.tail_k = saved
            assert not eng.block_manager.has_table("s2")
            eng.block_manager.check_invariants()
            assert eng.session_info("s") is not None
            hit = eng.resume_session("s2", "s", prompt2, sampling=sp)
            assert hit == info["tokens_covered"]
            _run(eng)
            turn2 = list(eng.get_request("s2").generated)
            assert turn2 == _reference(side, models, "s2", prompt2, sp)
            got.append((turn1, turn2, hit))
        assert got[0] == got[1]

    def test_session_bound(self, models):
        got = []
        for side in SIDES:
            eng = _tiered(side, models, num_blocks=32,
                          kv_tiers={"max_sessions": 2})
            rng = np.random.default_rng(11)
            for i in range(3):
                p = [int(t) for t in rng.integers(0, 255, size=8)]
                eng.add_request(f"s{i}", p, sampling=_sp(side, "greedy"))
                _run(eng)
            got.append(sorted(eng._kvtier.sessions))
        assert got[0] == got[1] == ["s1", "s2"]

    def test_untired_engine_refuses_sessions(self, models):
        for side in SIDES:
            eng = side["engine"](models[id(side)], _ecfg(side))
            with pytest.raises(ValueError, match="kv_tiers"):
                eng.park_session("nope")
            assert eng.tier_stats() is None
            assert eng.session_info("nope") is None
            assert eng.drop_session("nope") is False


def test_drop_and_adopt_sessions(models):
    """``drop_session`` forgets a record (``to_peer`` also evicts the
    local chain and counts its blocks in the peer tier);
    ``adopt_session`` names a chain the trie holds as resumable."""
    prompt = _prompt(12, 16)
    got = []
    for side in SIDES:
        eng = _tiered(side, models, num_blocks=16)
        eng.add_request("a", prompt, sampling=_sp(side, "greedy"))
        other = _prompt(14, 16)
        eng.add_request("b", other, sampling=_sp(side, "greedy"))
        _run(eng)
        toks = eng._kvtier.sessions["a"].tokens
        assert eng.drop_session("a", to_peer=True)
        assert not eng.drop_session("a")
        evicted = eng.block_manager.match_prefix(toks)
        assert eng.drop_session("b")
        adopted = eng.adopt_session("c", other, 12)
        got.append((evicted, adopted, eng.session_info("c"),
                    eng.tier_stats()["peer_blocks"],
                    eng.block_manager.host_tier_stats()))
    assert got[0][:4] == got[1][:4]
    assert got[0][0] == 0 and got[0][1] and got[0][3] > 0


# ---------------------------------------------------------------------------
# the ragged attention's second pool
# ---------------------------------------------------------------------------
def _two_pool_batch(seed=0, h=4, kh=2, d=16, bs=4, nb=24, nhb=12,
                    s_slots=5, mb=8, virtual_write=False):
    """A mixed batch (decode and prefill rows, a padding slot) whose
    block tables name both pools: in each live slot the blocks that this
    step does not write are moved to the second pool (their entries
    become virtual, ``nb + slot``) and the device copy is overwritten
    with garbage. With ``virtual_write`` one slot's written block is
    virtual too."""
    rng = np.random.default_rng(seed)
    nq = [1, 6, 1, 5]
    ctx_live = [9, 13, 8, 11]
    ns = len(nq)
    cu = np.zeros((s_slots + 1,), np.int32)
    cu[1:ns + 1] = np.cumsum(nq)
    cu[ns + 1:] = cu[ns]
    t_total = int(cu[ns]) + 3
    ctx = np.zeros((s_slots,), np.int32)
    ctx[:ns] = ctx_live
    f = np.float32
    kc = rng.standard_normal((nb, bs, kh, d)).astype(f)
    vc = rng.standard_normal((nb, bs, kh, d)).astype(f)
    hk = rng.standard_normal((nhb, bs, kh, d)).astype(f)
    hv = rng.standard_normal((nhb, bs, kh, d)).astype(f)
    bt = np.full((s_slots, mb), -1, np.int32)
    perm = rng.permutation(nb)
    slots = iter(rng.permutation(nhb))
    k = 0
    for i, c in enumerate(ctx_live):
        need = -(-c // bs)
        bt[i, :need] = perm[k:k + need]
        k += need
        first_write = (c - nq[i]) // bs
        for j in range(need):
            if j < first_write or (virtual_write and i == 1):
                s = next(slots)
                hk[s], hv[s] = kc[bt[i, j]], vc[bt[i, j]]
                kc[bt[i, j]] = vc[bt[i, j]] = 1e3
                bt[i, j] = nb + s
    return dict(
        q=rng.standard_normal((t_total, h, d)).astype(f),
        k_new=rng.standard_normal((t_total, kh, d)).astype(f),
        v_new=rng.standard_normal((t_total, kh, d)).astype(f),
        key_cache=kc, value_cache=vc, block_tables=bt, cu_seqlens=cu,
        context_lens=ctx, num_seqs=np.int32(ns)), hk, hv


def _jax_concat(b, hk, hv):
    """The JAX tiered step's attention: the mirror concatenated onto the
    cache along the blocks axis, the written cache sliced back."""
    nb = b["key_cache"].shape[0]
    args = {k: jnp.asarray(v) for k, v in b.items()}
    args["key_cache"] = jnp.concatenate([args["key_cache"], hk])
    args["value_cache"] = jnp.concatenate([args["value_cache"], hv])
    out, kc, vc = jrpa.ragged_paged_attention(
        *(args[k] for k in ("q", "k_new", "v_new", "key_cache",
                            "value_cache", "block_tables", "cu_seqlens",
                            "context_lens", "num_seqs")), impl="ref")
    return np.asarray(out), np.asarray(kc)[:nb], np.asarray(vc)[:nb]


def _torch_two_pool(b, hk, hv):
    args = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    hkt, hvt = torch.from_numpy(hk.copy()), torch.from_numpy(hv.copy())
    out, kc, vc = trpa.ragged_paged_attention(
        **args, host_key_cache=hkt, host_value_cache=hvt)
    assert torch.equal(hkt, torch.from_numpy(hk))   # read only
    return out.numpy(), kc.numpy(), vc.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_two_pool_plain_matches_the_concatenated_reference(seed):
    b, hk, hv = _two_pool_batch(seed)
    assert (b["block_tables"] >= b["key_cache"].shape[0]).sum() >= 4
    out_j, kc_j, vc_j = _jax_concat(b, hk, hv)
    out_t, kc_t, vc_t = _torch_two_pool(b, hk, hv)
    np.testing.assert_allclose(out_t, out_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(kc_t, kc_j)
    np.testing.assert_array_equal(vc_t, vc_j)


def test_a_write_to_a_virtual_entry_is_dropped():
    """A row whose block-table entry is virtual: the JAX step writes it
    into the concatenated copy and slices it away; the port drops it.
    The device caches come out equal, and the mirror is untouched."""
    b, hk, hv = _two_pool_batch(3, virtual_write=True)
    _, kc_j, vc_j = _jax_concat(b, hk, hv)
    _, kc_t, vc_t = _torch_two_pool(b, hk, hv)
    np.testing.assert_array_equal(kc_t, kc_j)
    np.testing.assert_array_equal(vc_t, vc_j)


def test_two_pool_bf16_rounded_form_against_f32():
    """The kernel's bf16 form of the plain version (P rounded per chunk)
    reads the second pool as the f32 form does: it stays within bf16
    rounding of it."""
    b, hk, hv = _two_pool_batch(4)
    t = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    args = (t["q"], t["key_cache"], t["value_cache"], t["block_tables"],
            t["cu_seqlens"], t["context_lens"],
            t["num_seqs"].reshape(1), 0.25)
    pools = dict(hkc=torch.from_numpy(hk), hvc=torch.from_numpy(hv))
    plain = trpa._ragged_attend_ref(*args, **pools)
    rounded = trpa._ragged_attend_ref(*args, round_to=torch.bfloat16,
                                      **pools)
    torch.testing.assert_close(rounded, plain, rtol=2e-2, atol=2e-2)
    no_pool = trpa._ragged_attend_ref(*args)
    assert not torch.allclose(no_pool, plain)


def test_rng_state_hand_off_takes_the_device_key(models):
    """``rng_state``'s composite form: both packages take the device key
    (the stream the in-graph sampler draws from) on ``add_request`` and
    ``resume_session``; the port has no host sampler to give the
    ``"numpy"`` half to, and sampled tokens still agree."""
    prompt = _prompt(15, 14)
    key = [12345, 67890]
    got = []
    for side in SIDES:
        sp = _sp(side, "sampled")
        eng = _tiered(side, models, num_blocks=16)
        state = {"numpy": np.random.default_rng(0).bit_generator.state,
                 "device_key": key}
        eng.add_request("a", prompt, sampling=sp, rng_state=state)
        assert list(eng.get_request("a").device_key) == key
        _run(eng)
        turn1 = list(eng.get_request("a").generated)
        eng.park_session("a")
        eng.resume_session("b", "a", prompt + turn1 + [3, 4], sampling=sp,
                           rng_state={"device_key": key})
        assert list(eng.get_request("b").device_key) == key
        _run(eng)
        got.append((turn1, list(eng.get_request("b").generated)))
    assert got[0] == got[1]


# ---------------------------------------------------------------------------
# the fleet's classes of tests/test_kvtier.py, on the port
# ---------------------------------------------------------------------------
import test_kvtier  # noqa: E402
from test_torch_fleet import _one_torch_thread, export  # noqa: E402,F401

_FLEET = export(test_kvtier, globals(),
                only=("TestFleetSessions", "TestMigrationStorm"))
