"""TieredKVStore — policy and byte movement for the device/host KV
hierarchy (port of ``paddle_tpu/serving/kvtier/store.py``).

The :class:`~paddle_tpu_torch.serving.block_manager.BlockManager` owns the
*mechanism*: virtual block ids, the ordered ``_tier_moves`` ledger,
tier-blind trie registration. This module owns the *policy* and the
actual bytes:

* :meth:`TieredKVStore.apply_moves` drains the ledger once per engine
  iteration and lands every demote and promote in record order. A demote
  copies the device blocks into the host tier's device mirror (one
  device-side ``index_copy_``, stream-ordered before the next step, so a
  host-tier block is attendable the same iteration it demotes) and into
  the pinned host pool (one async device-to-host copy, landed by the
  swapper's ``fence`` before anything reads the pool); a promote copies
  the host pool back into the device cache IN PLACE (the captured step
  graphs hold the caches' addresses);
* :meth:`balance` keeps an uncached-free device headroom by demoting
  cold registered blocks, and opportunistically promotes running
  requests' host-tier blocks back while the device pool has slack;
* :meth:`relief` is the scheduler's OOM hook: demote-before-preempt,
  so a growing request sheds its own cold prefix to the host tier
  instead of evicting a batch peer;
* sessions: every cleanly finished request is captured as a
  :class:`SessionRecord` (full token chain committed to the trie, the
  partial tail block's bytes stashed host-side), ``park`` demotes the
  chain off-device between turns, and ``claim_resume`` re-shares it —
  walking the ladder down to plain recompute when the chain was partly
  or wholly evicted, never losing or duplicating a block.

Every byte move goes through the engine's swapper, so at ``tp_degree``
k > 1 it reaches every rank: demotes, promotes and mirror copies queue
for the workers in the order rank 0 runs them (ahead of the step that
reads them), a session tail is gathered from and scattered back to all
k ranks, framed per rank as the JAX package frames it.

Ordering contract: swap-out spills and demote copies queue in the
swapper in record order and land (``fence``) before the host pool is
read, and device-side copies are ordered on the step's stream, so within
one schedule round a block or slot freed by one move and reclaimed by a
later one ends with the later writer's bytes, as the allocator's event
order says.

The third tier is a peer's cache reached through the fleet router
(:mod:`paddle_tpu_torch.serving.fleet`): past ``host_watermark`` the
router ships a parked session's chain to a peer replica, which adopts
it; ``drop(to_peer=True)`` then evicts the local chain and counts its
blocks in ``peer_blocks``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from paddle_tpu_torch.serving.block_manager import prefix_chain_hashes

__all__ = ["KVTiersConfig", "SessionRecord", "TieredKVStore"]


@dataclass
class KVTiersConfig:
    """Knobs for the tiered hierarchy.

    ``num_host_blocks``      — host-tier size; None = at least the
                               device pool again in host RAM.
    ``demote_headroom``      — uncached-free device blocks ``balance``
                               maintains by demoting cold cached
                               content.
    ``promote_headroom``     — device free blocks that must REMAIN
                               after opportunistic promotion (promotion
                               is a locality optimization — host blocks
                               are attendable in place — so it never
                               competes with admissions for headroom).
    ``host_watermark``       — host-pool occupancy in [0, 1] past which
                               the fleet router offloads parked
                               sessions to a peer's pool.
    ``max_sessions``         — bounded session registry; the oldest
                               record drops first (its chain stays
                               behind as ordinary evictable cache).
    """

    num_host_blocks: Optional[int] = None
    demote_headroom: int = 2
    promote_headroom: int = 4
    host_watermark: float = 0.85
    max_sessions: int = 32

    def __post_init__(self):
        if self.num_host_blocks is not None and self.num_host_blocks < 1:
            raise ValueError("kv_tiers.num_host_blocks must be >= 1")
        if self.demote_headroom < 1:
            raise ValueError("kv_tiers.demote_headroom must be >= 1")
        if self.promote_headroom < 0:
            raise ValueError("kv_tiers.promote_headroom must be >= 0")
        if not 0.0 < self.host_watermark <= 1.0:
            raise ValueError("kv_tiers.host_watermark must be in (0, 1]")
        if self.max_sessions < 1:
            raise ValueError("kv_tiers.max_sessions must be >= 1")

    @classmethod
    def from_any(cls, v) -> Optional["KVTiersConfig"]:
        """Normalize ``EngineConfig(kv_tiers=...)``: None/False = off,
        True = defaults, a dict = kwargs, an instance passes through."""
        if v is None or v is False:
            return None
        if v is True:
            return cls()
        if isinstance(v, cls):
            return v
        if isinstance(v, dict):
            return cls(**v)
        raise ValueError(
            f"kv_tiers must be True, a dict of KVTiersConfig fields, or "
            f"a KVTiersConfig — got {type(v).__name__}")


@dataclass
class SessionRecord:
    """One parked (or park-eligible) multi-turn session: the full token
    chain whose KV survives the request, plus the partial tail block's
    bytes that the trie cannot hold, as host tensors: (L, 1, BS, KH, D)
    at one rank, framed per rank at ``tp_degree`` k > 1, (k, L, 1, BS,
    KH/k, D) (the JAX package's ``tail_k`` layout)."""

    session_id: str
    tokens: List[int]
    covered: int                       # tokens with cached KV at finish
    tail_k: Optional[torch.Tensor] = None
    tail_v: Optional[torch.Tensor] = None
    tenant: Optional[str] = None
    chain_hash: Optional[str] = None   # full-block chain id (offload)
    parked: bool = False
    remote_blocks: int = 0             # blocks offloaded to a peer tier

    def summary(self) -> dict:
        return {"session_id": self.session_id,
                "tokens_covered": int(self.covered),
                "tokens": len(self.tokens),
                "chain_hash": self.chain_hash,
                "parked": bool(self.parked),
                "tenant": self.tenant}


class TieredKVStore:
    def __init__(self, engine, cfg: KVTiersConfig):
        self._eng = engine
        self.cfg = cfg
        self.sessions: Dict[str, SessionRecord] = {}
        # lifetime counters (serving/kv_tier_* gauges; demote/promote
        # counts live on the BlockManager next to the mechanism)
        self.num_parks = 0
        self.num_park_resumes = 0
        self.num_resume_recomputes = 0        # resumes with zero reuse
        self.num_resume_recomputed_tokens = 0  # chain tokens recomputed
        self.peer_blocks = 0                   # blocks held on peer tiers
        self._spills = 0                       # demote copies queued

    # -- byte movement ----------------------------------------------------
    def apply_moves(self) -> int:
        """Drain the BlockManager's ordered move ledger and land the
        bytes. Runs once per engine iteration, after scheduling and
        before COW pairs and the step. Returns moves applied."""
        eng = self._eng
        moves = eng.block_manager.take_tier_moves()
        if not moves:
            return 0
        # pending swap-out spills were recorded before any of these
        # moves could reclaim their slots: land them first so a reused
        # slot's last writer wins in true event order
        eng._swapper.fence()
        i = 0
        while i < len(moves):
            kind = moves[i][0]
            j = i
            while j < len(moves) and moves[j][0] == kind:
                j += 1
            run = moves[i:j]
            if kind == "demote":
                self._demote_bytes(run)
            else:
                self._promote_bytes(run)
            i = j
        return len(moves)

    @staticmethod
    def _dedupe_last(pairs: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
        """Keep only the LAST write per destination (a batched indexed
        copy with duplicate indices must match sequential last-writer-
        wins semantics)."""
        last = {dst: k for k, (_, dst) in enumerate(pairs)}
        return [p for k, p in enumerate(pairs)
                if last[p[1]] == k]

    def _demote_bytes(self, run: List[tuple]) -> None:
        pairs = self._dedupe_last([(dev, slot) for _, dev, slot in run])
        # the device mirror the tiered step reads as its second pool —
        # updated incrementally, never re-uploaded wholesale — and the
        # host pool, the swap source of truth: one async copy, landed by
        # the swapper's next fence
        self._spills += 1
        self._eng._swapper.demote(("tier", self._spills),
                                  [d for d, _ in pairs],
                                  [s for _, s in pairs])

    def _promote_bytes(self, run: List[tuple]) -> None:
        pairs = self._dedupe_last([(slot, dev) for _, slot, dev in run])
        self._eng._swapper.restore([s for s, _ in pairs],
                                   [d for _, d in pairs])

    # -- per-iteration policy ---------------------------------------------
    def balance(self) -> None:
        """Pressure-driven tier rebalancing, once per engine iteration
        BEFORE scheduling: demote cold cached-free blocks when the
        uncached-free device headroom dips, promote running requests'
        host-tier blocks back while the device pool has slack."""
        bm = self._eng.block_manager
        deficit = self.cfg.demote_headroom - bm.num_uncached_free_blocks
        if deficit > 0:
            bm.demote_cached_free(deficit)
            return
        budget = bm.num_free_blocks - self.cfg.promote_headroom
        if budget <= 0:
            return
        for r in self._eng.scheduler.running:
            if budget <= 0:
                break
            budget -= bm.promote_blocks(r.request_id, budget)

    def relief(self, request) -> bool:
        """Scheduler OOM hook: demote-before-preempt. Frees device
        blocks by demoting cold cached content — or, failing that, the
        requesting row's OWN committed prefix — so a single request
        whose context exceeds the device pool keeps growing instead of
        evicting batch peers. True when >= 1 device block was freed
        (the caller retries its claim; each True strictly grows the
        free list, so the retry loop is bounded)."""
        bm = self._eng.block_manager
        got = bm.demote_cached_free(self.cfg.demote_headroom)
        if got == 0 and request.num_cached > 0 \
                and bm.has_table(request.request_id):
            got = bm.demote_request_blocks(
                request.request_id, request.num_cached, 4)
        return got > 0

    # -- session capture / park / resume ----------------------------------
    def on_finish(self, req) -> None:
        """Finish-time session capture (runs BEFORE the scheduler frees
        the table): commit the FULL chain — generated tokens included —
        so the blocks survive as cached-free trie entries, and stash
        the partial tail block's bytes that the trie cannot register.
        Only clean finishes capture; aborted requests leave nothing."""
        eng = self._eng
        bm = eng.block_manager
        rid = req.request_id
        if req.finish_reason not in ("stop", "length"):
            return
        covered = req.num_cached
        if covered <= 0 or not bm.has_table(rid):
            return
        bs = eng.cfg.block_size
        tokens = list(req.tokens)
        bm.commit_prefix(rid, tokens, covered)
        tail_k = tail_v = None
        if covered % bs:
            table = bm.block_table(rid)
            idx = covered // bs
            if idx < len(table):
                # pending moves land first: their bytes may still be on
                # the device side of a copy
                self.apply_moves()
                tail_k, tail_v = eng._swapper.gather([table[idx]])
        full = (covered // bs) * bs
        chain_hash = (prefix_chain_hashes(tokens[:full], bs)[-1]
                      if full >= bs else None)
        self.sessions[rid] = SessionRecord(
            session_id=rid, tokens=tokens, covered=covered,
            tail_k=tail_k, tail_v=tail_v,
            tenant=req.sampling.tenant_id, chain_hash=chain_hash)
        self._bound_sessions()

    def _bound_sessions(self) -> None:
        # drop oldest first; the evicted chain stays behind as ordinary
        # cached-free trie content (reusable, evictable — never leaked)
        while len(self.sessions) > self.cfg.max_sessions:
            self.sessions.pop(next(iter(self.sessions)))

    def park(self, session_id: str) -> Optional[dict]:
        """Demote a captured session's chain off-device (host tier).
        Idempotent; None when the session is unknown. The chain blocks
        that are still shared by a running request stay put — they are
        reachable either way."""
        rec = self.sessions.get(session_id)
        if rec is None:
            return None
        bm = self._eng.block_manager
        demoted = bm.demote_chain(rec.tokens, rec.covered)
        if not rec.parked:
            rec.parked = True
            self.num_parks += 1
        out = rec.summary()
        out["demoted"] = int(demoted)
        return out

    def claim_resume(self, session_id: str, request_id: str,
                     prompt_ids: Sequence[int]
                     ) -> Tuple[SessionRecord, int]:
        """Re-share a session's chain for a continuation request and
        restore the stashed tail bytes. Returns ``(record, hit)`` where
        ``hit`` is the token coverage actually reused (0 = the chain
        was evicted — the caller admits the request cold: the ladder's
        recompute floor). Raises ValueError when the prompt does not
        extend the session's chain. The record is consumed either way
        (one resume per park)."""
        eng = self._eng
        bm = eng.block_manager
        rec = self.sessions.get(session_id)
        if rec is None:
            raise ValueError(f"unknown session {session_id!r}")
        prompt = [int(t) for t in prompt_ids]
        covered = min(rec.covered, len(prompt) - 1)
        if covered <= 0 or prompt[:covered] != rec.tokens[:covered]:
            raise ValueError(
                f"session {session_id!r}: the prompt does not extend "
                f"the parked chain ({covered} covered tokens)")
        bs = eng.cfg.block_size
        # land any pending park demotes NOW: resume_chain reclaims
        # freed device blocks, and the tail restore below writes one
        # directly — reusing a not-yet-copied demote source would let
        # the late copy ship the tail's bytes into the chain's host slot
        self.apply_moves()
        # the stashed tail bytes restore only into the SAME tail block
        # the session finished in (a clamped resume still shares its
        # full-block prefix; the partial tail recomputes)
        want_tail = (rec.tail_k is not None and covered % bs != 0
                     and covered // bs == rec.covered // bs)
        table, hit, tail_block = bm.resume_chain(
            request_id, prompt, covered, want_tail=want_tail)
        if hit == 0:
            bm.free(request_id)   # the empty claim must not linger
            self.num_resume_recomputes += 1
        elif tail_block is not None:
            try:
                eng._swapper.scatter([tail_block], rec.tail_k, rec.tail_v)
            except Exception:
                # a failed tail restore must not strand the resumed
                # claim: free the whole chain before the error
                # propagates (the session record stays for a retry)
                bm.free(request_id)
                raise
        self.num_park_resumes += 1
        self.num_resume_recomputed_tokens += max(0, covered - hit)
        self.sessions.pop(session_id, None)
        return rec, hit

    def adopt(self, session_id: str, tokens: Sequence[int],
              covered: int, *, tenant: Optional[str] = None) -> bool:
        """Register a session whose chain the trie already holds (the
        fleet's offload ships it in): the record just names the
        blocks. Coverage clamps to what the trie actually matches; False
        when nothing matches (the adopter stays cold, harmlessly)."""
        tokens = [int(t) for t in tokens]
        bs = self._eng.cfg.block_size
        full = (min(int(covered), len(tokens)) // bs) * bs
        hit = self._eng.block_manager.match_prefix(tokens[:full]) \
            if full >= bs else 0
        if hit < bs:
            return False
        self.sessions[session_id] = SessionRecord(
            session_id=session_id, tokens=tokens, covered=hit,
            tenant=tenant, parked=True,
            chain_hash=prefix_chain_hashes(tokens[:hit], bs)[-1])
        self._bound_sessions()
        return True

    def drop(self, session_id: str, *, to_peer: bool = False) -> bool:
        """Forget a session. ``to_peer=True`` marks an offload: the
        local chain is evicted from the trie (the peer's copy is now
        authoritative) and the blocks count toward the peer-tier
        gauge."""
        rec = self.sessions.pop(session_id, None)
        if rec is None:
            return False
        if to_peer:
            bm = self._eng.block_manager
            dropped = bm.evict_chain(rec.tokens, rec.covered)
            self.peer_blocks += dropped
        return True

    # -- observability ----------------------------------------------------
    def host_pressure(self) -> float:
        bm = self._eng.block_manager
        if bm.num_host_blocks <= 0:
            return 0.0
        return bm.num_host_blocks_used / bm.num_host_blocks

    def stats(self) -> dict:
        bm = self._eng.block_manager
        st = bm.host_tier_stats()
        st.update({
            "pressure": round(self.host_pressure(), 4),
            "watermark": self.cfg.host_watermark,
            "demotes": bm.num_demotes,
            "promotes": bm.num_promotes,
            "sessions": len(self.sessions),
            "parks": self.num_parks,
            "park_resumes": self.num_park_resumes,
            "resume_recomputes": self.num_resume_recomputes,
            "resume_recomputed_tokens": self.num_resume_recomputed_tokens,
            "peer_blocks": self.peer_blocks,
        })
        return st
