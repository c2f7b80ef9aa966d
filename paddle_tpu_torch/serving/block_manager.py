"""Paged KV-cache block allocator (vLLM PagedAttention block manager),
adapted from the JAX package's ``serving/block_manager.py``.

The physical cache is ``num_blocks`` fixed-size blocks per layer (one
shared free list — every layer's cache uses the same block ids, so the
block table a request holds indexes all layers at once, exactly how
``incubate.nn.functional.block_multihead_attention`` and the ragged
kernel consume it).

Prefix caching (``enable_prefix_cache=True``): device blocks are
refcounted and FULL prompt blocks are registered in a prefix trie keyed
by the token-content chain (block i's key folds block i-1's key, so a
block is only shared when the ENTIRE prefix up to it matches). A request
admitted with a matching prompt prefix shares those device blocks
instead of recomputing them; the first write into a block another
request still holds triggers copy-on-write (``take_cow_pairs`` hands the
engine the (src, dst) device copies to apply before the next step).
Freed blocks whose content is still registered go to the COLD end of the
free list, so cached prefixes survive until capacity actually needs
them (LRU-ish eviction: claiming a cached-free block drops its key).

Invariants (pinned by tests/test_torch_serving.py storms and
tests/test_torch_kvtier.py against the JAX package):
  * a block id appears in tables exactly ``refcount`` times,
  * ``len(free) + len(distinct owned) == num_blocks`` always,
  * free and owned are disjoint; trie keys map 1:1 onto keyed blocks,
  * ``free``/preemption returns every exclusively-owned block.

Swap pool: ``num_host_blocks > 0`` adds a second, host-side slot
allocator for swap-based preemption: ``swap_out`` trades a victim's
device blocks for refcounted host slots (the engine copies the KV bytes),
``swap_in`` trades them back. Host slots are refcounted so a
prefix-cache can share one spilled prefix between requests. The same
exact-accounting invariants hold for the host pool, and ``free()``
releases BOTH sides, so no lifecycle path (abort while swapped
included) can leak.

Tiered mode (``tiered=True``): the host pool stops being a swap-only
side channel and becomes a second ADDRESSABLE tier. A block table entry
``>= num_blocks`` is a VIRTUAL id naming host slot ``entry -
num_blocks``; the tiered engine step hands the ragged attention the host
tier's device mirror as a second pool, so virtual entries are directly
attendable — a running request's context can exceed the device pool.
The prefix trie spans tiers by registering virtual ids in the same
``_prefix_index``/``_block_key`` maps, so ``match_prefix``,
``commit_prefix`` and hash advertisement are tier-blind. ``demote_*``
moves cold fully-committed content device->host (table entries turn
virtual, device blocks free); ``promote_blocks`` moves it back. Byte
copies are NOT performed here: every migration appends to an ORDERED
``_tier_moves`` queue (("demote", dev, slot) / ("promote", slot,
dev)) the engine drains via :meth:`take_tier_moves` and applies
in-order BEFORE pending COW pairs and before the next step writes —
order matters because a block freed by one move may be re-claimed by a
later one in the same scheduling round. Writes never target the host
region: only fully-committed blocks strictly below a request's write
frontier are demote-eligible, and the capped-write block of a prefix
hit that lands on a virtual entry is promote-copied first (the
cross-tier analogue of COW).

The fleet's half: every registered chain key also carries a content
chain hash (:func:`prefix_chain_hashes`, stable across processes and
across the two packages), advertised by :meth:`prefix_digest` and
resolved back by :meth:`prefix_blocks_by_hash`; :meth:`export_blocks` /
:meth:`import_blocks` name the blocks of a KV ship. :meth:`trim` is the
speculative-decode rollback."""
from __future__ import annotations

import hashlib
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from paddle_tpu_torch.testing import faults

__all__ = ["BlockManager", "NoFreeBlocksError", "prefix_chain_hashes"]


class NoFreeBlocksError(RuntimeError):
    """Raised when an allocation is attempted past capacity; the
    scheduler catches this OOM signal and preempts."""


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _fold_hash(parent_hex: Optional[str],
               block_tokens: Sequence[int]) -> str:
    """Fold one full block of tokens into the content chain hash. The
    chain mirrors the trie key structure ((key_{i-1}, block_i_tokens)),
    so equal hashes imply (modulo blake2b collision) the entire prefix
    matches — and a collision can at worst misroute or waste a ship,
    never corrupt: the trie itself is keyed by actual token content."""
    base = (parent_hex or "").encode()
    body = ",".join(str(int(t)) for t in block_tokens).encode()
    return hashlib.blake2b(base + b"|" + body,
                           digest_size=8).hexdigest()


def prefix_chain_hashes(tokens: Sequence[int],
                        block_size: int) -> List[str]:
    """Chain hash for every FULL-block prefix of ``tokens``:
    ``hashes[i]`` identifies ``tokens[:(i + 1) * block_size]``. This is
    the router-side mirror of the hashes a BlockManager advertises, so
    the two sides agree without sharing any state but the tokens."""
    out: List[str] = []
    h: Optional[str] = None
    i = 0
    while (i + 1) * block_size <= len(tokens):
        h = _fold_hash(h, tokens[i * block_size:(i + 1) * block_size])
        out.append(h)
        i += 1
    return out


class BlockManager:
    def __init__(self, num_blocks: int, block_size: int,
                 num_host_blocks: int = 0,
                 enable_prefix_cache: bool = False,
                 kv_layout=None, tiered: bool = False):
        if num_blocks < 1 or block_size < 1:
            raise ValueError("num_blocks and block_size must be >= 1")
        if num_host_blocks < 0:
            raise ValueError("num_host_blocks must be >= 0")
        if tiered and num_host_blocks < 1:
            raise ValueError("tiered mode needs num_host_blocks >= 1 "
                             "(the host tier IS the host pool)")
        if tiered and not enable_prefix_cache:
            raise ValueError("tiered mode needs enable_prefix_cache=True "
                             "(the trie is what spans tiers)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.enable_prefix_cache = enable_prefix_cache
        # the Layout of the paged caches these block ids index (TP
        # serving shards the kv-head dim; None = unsharded). Allocation
        # is layout-agnostic — a block id covers block_size tokens
        # regardless of how its bytes are framed — but the KV-ship
        # import gate below uses it to reject wire payloads whose
        # layout cannot possibly reshard onto this cache.
        self.kv_layout = kv_layout
        # free list: pop() takes the HOT (right) end — recently freed,
        # never-cached blocks; cached-free blocks park at the COLD (left)
        # end so registered prefixes are evicted last, oldest first
        self._free = deque(range(num_blocks - 1, -1, -1))
        self._tables: Dict[str, List[int]] = {}
        # device refcounts for owned blocks (block -> #table occurrences)
        self._refs: Dict[int, int] = {}
        # prefix trie: chain-key -> block id, and its inverse. The key for
        # prompt block i is (key_{i-1}, tuple(block_i_tokens)), so equal
        # keys imply the whole prefix matches. Keys outlive free(): a
        # cached-free block keeps its registration until reclaimed.
        self._prefix_index: Dict[tuple, int] = {}
        self._block_key: Dict[int, tuple] = {}
        self._cow_pairs: List[Tuple[int, int]] = []
        # fleet advertisement layer: every registered chain key also
        # carries a content chain HASH (stable across processes, unlike
        # the tuple key which is only meaningful locally). `_hash_key`
        # is the inverse used to resolve an incoming ship/export request
        # by hash; `_hash_tokens` caches covered-token counts for the
        # digest. `_trie_rev` bumps on any registration change so the
        # heartbeat-rate digest is computed at most once per change.
        self._key_hash: Dict[tuple, str] = {}
        self._hash_key: Dict[str, tuple] = {}
        self._hash_tokens: Dict[str, int] = {}
        self._trie_rev = 0
        self._digest_cache: Optional[Tuple[tuple, dict]] = None
        # observability (engine surfaces these through ServingMetrics)
        self.num_prefix_hits = 0
        self.num_prefix_hit_tokens = 0
        self.num_cow_copies = 0
        self.last_hit_tokens = 0
        # host swap pool (0 = swap disabled)
        self.num_host_blocks = num_host_blocks
        self._host_free: List[int] = list(range(num_host_blocks - 1, -1,
                                                -1))
        self._host_tables: Dict[str, List[int]] = {}
        self._host_refs: Dict[int, int] = {}  # slot -> refcount
        # tiered mode: virtual table entries + ordered
        # pending byte-moves between tiers (see module docstring)
        self.tiered = tiered
        self._tier_moves: List[Tuple[str, int, int]] = []
        self.num_demotes = 0
        self.num_promotes = 0

    # -- tier addressing --------------------------------------------------
    def is_host_entry(self, entry: int) -> bool:
        """True when a block-table entry is a VIRTUAL id naming a host
        slot (tiered mode only produces these)."""
        return entry >= self.num_blocks

    def host_slot_of(self, entry: int) -> int:
        return entry - self.num_blocks

    def virtual_of(self, slot: int) -> int:
        return self.num_blocks + slot

    def tier_of(self, entry: int) -> str:
        return "host" if self.is_host_entry(entry) else "device"

    # -- accounting ------------------------------------------------------
    @property
    def num_free_blocks(self) -> int:
        return len(self._free)

    @property
    def num_used_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    def blocks_needed(self, num_tokens: int) -> int:
        return cdiv(num_tokens, self.block_size)

    def can_allocate(self, num_tokens: int) -> bool:
        """Conservative (prefix hits can only reduce the real need)."""
        return self.blocks_needed(num_tokens) <= len(self._free)

    def has_table(self, request_id: str) -> bool:
        return request_id in self._tables

    def block_table(self, request_id: str) -> List[int]:
        return list(self._tables[request_id])

    def utilization(self) -> float:
        return self.num_used_blocks / self.num_blocks

    def ref_count(self, block: int) -> int:
        return self._refs.get(block, 0)

    # -- prefix cache ----------------------------------------------------
    def match_prefix(self, tokens: Sequence[int]) -> int:
        """Tokens of ``tokens`` covered by registered FULL blocks whose
        whole prefix chain matches. Read-only (no refcount changes)."""
        if not self.enable_prefix_cache:
            return 0
        bs = self.block_size
        key: Optional[tuple] = None
        hit = 0
        while hit + bs <= len(tokens):
            key = (key, tuple(tokens[hit:hit + bs]))
            if key not in self._prefix_index:
                break
            hit += bs
        return hit

    def _drop_registration(self, entry: int):
        """Forget the trie registration of a (device or virtual) id —
        the cache-eviction point: reuse invalidates content."""
        key = self._block_key.pop(entry, None)
        if key is not None and self._prefix_index.get(key) == entry:
            self._prefix_index.pop(key)
            h = self._key_hash.pop(key, None)
            if h is not None and self._hash_key.get(h) == key:
                self._hash_key.pop(h)
                self._hash_tokens.pop(h, None)
            self._trie_rev += 1

    def _move_registration(self, src_entry: int, dst_entry: int):
        """Re-point a trie registration at the id the content moved to
        (demotion/promotion keep cached prefixes discoverable)."""
        key = self._block_key.pop(src_entry, None)
        if key is None:
            return
        self._block_key[dst_entry] = key
        if self._prefix_index.get(key) == src_entry:
            self._prefix_index[key] = dst_entry
        self._trie_rev += 1

    def _claim(self) -> int:
        """Pop a free block, dropping any stale prefix registration (this
        is the cache-eviction point: reuse invalidates content)."""
        b = self._free.pop()
        self._drop_registration(b)
        self._refs[b] = 1
        return b

    def _claim_host(self) -> int:
        """Pop a free host slot (hot end), dropping any stale host-tier
        registration, born at refcount 1."""
        s = self._host_free.pop()
        self._drop_registration(self.virtual_of(s))
        # no pending-move filtering needed here: moves apply in record
        # order, so a stale copy into a reclaimed slot is overwritten by
        # the later move that claimed it before any step reads the slot
        self._host_refs[s] = 1
        return s

    def _release(self, block: int):
        """Drop one reference; at zero the block returns to the free list
        (cold end if its content is still registered). Virtual entries
        release their host slot instead."""
        if self.is_host_entry(block):
            self._unref_host([self.host_slot_of(block)])
            return
        n = self._refs.get(block, 0) - 1
        if n <= 0:
            self._refs.pop(block, None)
            if self._cow_pairs:
                # a pending COW whose destination was freed (its owner
                # evicted before the copy landed) must not clobber the
                # block's next owner
                self._cow_pairs = [(s, d) for (s, d) in self._cow_pairs
                                   if d != block]
            if block in self._block_key:
                self._free.appendleft(block)
            else:
                self._free.append(block)
        else:
            self._refs[block] = n

    def _cow(self, request_id: str, idx: int) -> int:
        """Replace table[idx] with a fresh private copy target; the
        engine applies the recorded (src, dst) device copy before the
        next step runs."""
        table = self._tables[request_id]
        src = table[idx]
        dst = self._claim()
        table[idx] = dst
        self._refs[src] -= 1  # caller guarantees refs[src] > 1
        self._cow_pairs.append((src, dst))
        self.num_cow_copies += 1
        return dst

    def take_cow_pairs(self) -> List[Tuple[int, int]]:
        """Drain pending copy-on-write (src, dst) block copies."""
        pairs, self._cow_pairs = self._cow_pairs, []
        return pairs

    # -- tier migration ---------------------------------------------------
    def take_tier_moves(self) -> List[Tuple[str, int, int]]:
        """Drain pending cross-tier byte moves, IN RECORD ORDER:
        ``("demote", device_block, host_slot)`` copies device->host,
        ``("promote", host_slot, device_block)`` host->device. The
        engine must apply them in order (a block freed by one move may
        be the destination of a later one) and BEFORE pending COW
        pairs and before the next step writes."""
        moves, self._tier_moves = self._tier_moves, []
        return moves

    def _promote_entry(self, request_id: str, idx: int,
                       take_registration: bool) -> int:
        """Materialize a virtual table entry on device: claim a fresh
        device block, record the host->device byte move, drop this
        table's host reference. With ``take_registration`` a sole owner
        carries the trie registration to the device block (pure
        promotion); without it the registration stays on the host slot
        — the about-to-be-written device copy diverges from the cached
        content (the cross-tier analogue of COW keeping src registered)."""
        table = self._tables[request_id]
        slot = self.host_slot_of(table[idx])
        dst = self._claim()
        table[idx] = dst
        self._tier_moves.append(("promote", slot, dst))
        self.num_promotes += 1
        if take_registration and self._host_refs.get(slot, 0) <= 1:
            self._move_registration(self.virtual_of(slot), dst)
        self._unref_host([slot])
        return dst

    def demote_request_blocks(self, request_id: str, covered_tokens: int,
                              max_blocks: int) -> int:
        """Demote up to ``max_blocks`` of a request's leading device
        blocks to host slots, coldest (lowest index) first. Only blocks
        FULLY covered by ``covered_tokens`` (the request's committed
        frontier) and held exclusively (refcount 1) are eligible, so
        the step never writes a demoted block and no other table needs
        repointing. Trie registrations move with the content. Returns
        blocks demoted (0 when not tiered / nothing eligible)."""
        if not self.tiered:
            return 0
        table = self._tables.get(request_id)
        if table is None:
            return 0
        bs = self.block_size
        done = 0
        for idx in range(min(len(table), covered_tokens // bs)):
            if done >= max_blocks or not self._host_free:
                break
            b = table[idx]
            if self.is_host_entry(b) or self._refs.get(b, 0) != 1:
                continue
            slot = self._claim_host()
            self._tier_moves.append(("demote", b, slot))
            table[idx] = self.virtual_of(slot)
            self._move_registration(b, self.virtual_of(slot))
            self._release(b)   # registration moved: plain hot free
            self.num_demotes += 1
            done += 1
        return done

    def demote_cached_free(self, max_blocks: int) -> int:
        """Demote registered cached-free DEVICE blocks (the cold end of
        the free list) to host slots: device room becomes uncached-free
        without evicting the prefixes. Slots park cold and unowned —
        host-tier cached-free — until a prefix hit shares them or
        capacity reclaims them. Returns blocks demoted."""
        if not self.tiered:
            return 0
        done = 0
        budget = len(self._host_free)
        i = 0
        while done < max_blocks and done < budget \
                and i < len(self._free):
            b = self._free[i]
            if b not in self._block_key:
                i += 1
                continue
            del self._free[i]
            slot = self._host_free.pop()
            self._drop_registration(self.virtual_of(slot))
            self._tier_moves.append(("demote", b, slot))
            self._move_registration(b, self.virtual_of(slot))
            self._free.append(b)            # now uncached: hot end
            self._host_free.insert(0, slot)  # cached-free: cold end
            self.num_demotes += 1
            done += 1
        return done

    def promote_blocks(self, request_id: str, max_blocks: int) -> int:
        """Opportunistically move a request's leading virtual entries
        back to device blocks (never raises: stops at device-OOM —
        host-resident entries stay directly attendable)."""
        if not self.tiered:
            return 0
        table = self._tables.get(request_id)
        if table is None:
            return 0
        done = 0
        for idx in range(len(table)):
            if done >= max_blocks:
                break
            if not self.is_host_entry(table[idx]):
                continue
            if not self._free:
                break
            self._promote_entry(request_id, idx, True)
            done += 1
        return done

    def demote_chain(self, tokens: Sequence[int], covered: int) -> int:
        """Demote a registered chain's CACHED-FREE device blocks to
        host slots (session park: the chain leaves HBM but stays
        trie-discoverable). Blocks still referenced by a running
        request skip — they are reachable either way — and a broken
        chain link stops the walk (everything past it is undiscoverable
        anyway). Returns blocks demoted."""
        if not self.tiered:
            return 0
        bs = self.block_size
        full = (min(covered, len(tokens)) // bs) * bs
        key: Optional[tuple] = None
        done = 0
        hit = 0
        while hit + bs <= full:
            key = (key, tuple(tokens[hit:hit + bs]))
            b = self._prefix_index.get(key)
            if b is None:
                break
            hit += bs
            if self.is_host_entry(b) or self._refs.get(b, 0) != 0 \
                    or not self._host_free:
                continue
            self._free.remove(b)
            # the slot stays UNOWNED (refcount 0, cached-free) — same
            # shape as demote_cached_free, not a table-backed claim
            slot = self._host_free.pop()
            self._drop_registration(self.virtual_of(slot))
            self._tier_moves.append(("demote", b, slot))
            self._move_registration(b, self.virtual_of(slot))
            self._free.append(b)             # now uncached: hot end
            self._host_free.insert(0, slot)  # cached-free: cold end
            self.num_demotes += 1
            done += 1
        return done

    def evict_chain(self, tokens: Sequence[int], covered: int) -> int:
        """Forget a registered chain's LOCAL copy (session offloaded to
        a peer: the remote copy is now authoritative, keeping this one
        discoverable would double-count the session). Registrations
        drop on either tier; blocks a running request still references
        merely become unregistered-owned. Returns registrations
        dropped."""
        bs = self.block_size
        full = (min(covered, len(tokens)) // bs) * bs
        key: Optional[tuple] = None
        entries: List[int] = []
        hit = 0
        while hit + bs <= full:
            key = (key, tuple(tokens[hit:hit + bs]))
            b = self._prefix_index.get(key)
            if b is None:
                break
            entries.append(b)
            hit += bs
        for b in entries:
            self._drop_registration(b)
            if self.is_host_entry(b):
                s = self.host_slot_of(b)
                if self._host_refs.get(s, 0) == 0:
                    # re-park the now-unregistered slot at the hot end
                    self._host_free.remove(s)
                    self._host_free.append(s)
            elif self._refs.get(b, 0) == 0:
                self._free.remove(b)
                self._free.append(b)
        return len(entries)

    def commit_prefix(self, request_id: str, tokens: Sequence[int],
                      covered: int):
        """Register the request's prompt blocks whose content is fully
        written (``covered`` tokens computed so far). Called AFTER the
        step that wrote them — a block must never be discoverable before
        its K/V bytes exist on device."""
        if not self.enable_prefix_cache:
            return
        table = self._tables.get(request_id)
        if table is None:
            return
        bs = self.block_size
        limit = min(covered, len(tokens))
        key: Optional[tuple] = None
        chash: Optional[str] = None
        idx = 0
        while (idx + 1) * bs <= limit:
            part = tuple(tokens[idx * bs:(idx + 1) * bs])
            key = (key, part)
            chash = _fold_hash(chash, part)
            b = table[idx]
            if key in self._prefix_index:
                # someone committed this prefix first; keep their block
                idx += 1
                continue
            if b not in self._block_key:
                self._prefix_index[key] = b
                self._block_key[b] = key
                self._key_hash[key] = chash
                self._hash_key[chash] = key
                self._hash_tokens[chash] = (idx + 1) * bs
                self._trie_rev += 1
            idx += 1

    @property
    def num_uncached_free_blocks(self) -> int:
        """Free blocks holding NO registered prefix content — the room a
        proactive prefix import may consume without evicting anything
        the cache already holds (and the device headroom the tier's
        ``balance`` keeps)."""
        return sum(1 for b in self._free if b not in self._block_key)

    # -- fleet prefix advertisement ---------------------------------------
    def prefix_digest(self, max_entries: int = 128) -> dict:
        """Bounded advertisement of the committed prefix trie, shaped
        for heartbeat meta: ``{"bs": block_size, "n": total_entries,
        "h": {chain_hash: covered_tokens}}``. Entries are kept
        SHALLOW-first (fewest covered tokens) when capped — shallow
        chains (shared system prompts) are the broadly useful ones, and
        keeping every ancestor of a kept entry means a router walking
        the chain front-to-back never breaks early on a capped-out
        middle link. Cached per trie revision, so heartbeat-rate calls
        are O(1) between registration changes."""
        ck = (self._trie_rev, int(max_entries))
        if self._digest_cache is not None \
                and self._digest_cache[0] == ck:
            return self._digest_cache[1]
        items = sorted(self._hash_tokens.items(),
                       key=lambda kv: (kv[1], kv[0]))
        digest = {"bs": self.block_size, "n": len(items),
                  "h": dict(items[:max_entries])}
        self._digest_cache = (ck, digest)
        return digest

    def prefix_blocks_by_hash(
            self, chain_hash: str,
    ) -> Optional[Tuple[List[int], List[int]]]:
        """Resolve an advertised chain hash back to ``(tokens,
        blocks)`` — the full token content and the device blocks of the
        registered chain it names. Returns None when the hash is
        unknown or any link of the chain has since been evicted (the
        caller treats that as a plain miss; advertisement staleness is
        expected, never an error). Read-only."""
        key = self._hash_key.get(chain_hash)
        if key is None:
            return None
        parts: List[tuple] = []
        k: Optional[tuple] = key
        while k is not None:
            k, part = k
            parts.append(part)
        parts.reverse()
        tokens: List[int] = []
        blocks: List[int] = []
        k = None
        for part in parts:
            k = (k, part)
            b = self._prefix_index.get(k)
            if b is None:
                return None   # ancestor evicted since registration
            blocks.append(b)
            tokens.extend(part)
        return tokens, blocks

    # -- allocation ------------------------------------------------------
    def allocate(self, request_id: str, num_tokens: int,
                 tokens: Optional[Sequence[int]] = None) -> List[int]:
        """Claim blocks covering ``num_tokens`` for a request being
        admitted (prefill). With ``tokens`` (the prompt) and prefix
        caching on, registered full blocks covering a matching prefix are
        SHARED (refcount bump) instead of claimed fresh;
        ``last_hit_tokens`` reports the effective cached-token count,
        capped at ``num_tokens - 1`` so at least one token is always
        computed (the capped write lands in a shared block and triggers
        COW). The request must not already own a table."""
        if request_id in self._tables:
            raise ValueError(
                f"request {request_id!r} already holds a block table — "
                f"free() it before re-allocating")
        bs = self.block_size
        need_total = self.blocks_needed(num_tokens)
        shared: List[int] = []
        if self.enable_prefix_cache and tokens is not None:
            key: Optional[tuple] = None
            hit = 0
            while (hit + bs <= min(len(tokens), num_tokens)
                   and len(shared) < need_total):
                key = (key, tuple(tokens[hit:hit + bs]))
                b = self._prefix_index.get(key)
                if b is None:
                    break
                shared.append(b)
                hit += bs
        hit_tok = len(shared) * bs
        eff = min(hit_tok, max(num_tokens - 1, 0))
        fresh_need = need_total - len(shared)
        shared_free = sum(1 for b in shared
                          if not self.is_host_entry(b)
                          and self._refs.get(b, 0) == 0)
        # the capped write position lands inside a shared block someone
        # else still references -> one extra block for the COW copy;
        # on a HOST-tier hit the write needs a device copy regardless
        # (writes never target the host region)
        cow_idx = eff // bs if (0 < eff < hit_tok) else None
        cow_need = 0
        if cow_idx is not None:
            cb = shared[cow_idx]
            cow_need = 1 if (self.is_host_entry(cb)
                             or self._refs.get(cb, 0) >= 1) else 0
        if fresh_need + shared_free + cow_need > len(self._free):
            raise NoFreeBlocksError(
                f"need {fresh_need + cow_need} fresh block(s) for "
                f"{num_tokens} tokens ({hit_tok} prefix-cached), "
                f"{len(self._free) - shared_free} free")
        table: List[int] = []
        for b in shared:
            table.append(self._share_entry(b))
        for _ in range(fresh_need):
            table.append(self._claim())
        self._tables[request_id] = table
        self.last_hit_tokens = eff
        if eff > 0:
            self.num_prefix_hits += 1
            self.num_prefix_hit_tokens += eff
        if cow_idx is not None:
            if self.is_host_entry(table[cow_idx]):
                self._promote_entry(request_id, cow_idx, False)
            elif self._refs[table[cow_idx]] > 1:
                self._cow(request_id, cow_idx)
        return list(table)

    def _share_entry(self, b: int) -> int:
        """Take one reference on a trie-hit table entry (either tier),
        un-freeing a cached-free block/slot (registration kept)."""
        if self.is_host_entry(b):
            slot = self.host_slot_of(b)
            if self._host_refs.get(slot, 0) == 0:
                self._host_free.remove(slot)
                self._host_refs[slot] = 1
            else:
                self._host_refs[slot] += 1
        elif self._refs.get(b, 0) == 0:
            self._free.remove(b)  # un-free a cached block, key kept
            self._refs[b] = 1
        else:
            self._refs[b] += 1
        return b

    def resume_chain(self, request_id: str, tokens: Sequence[int],
                     covered: int, want_tail: bool = True
                     ) -> Tuple[List[int], int, Optional[int]]:
        """Rebuild a block table for a parked session being resumed:
        share the registered chain blocks (EITHER tier) covering the
        leading full blocks of ``tokens[:covered]``, then — with
        ``want_tail``, i.e. the caller holds restorable bytes for THIS
        partial tail — claim one fresh private device block for it. No
        hit cap — the caller guarantees the resumed prompt extends past
        ``covered``. Returns ``(table, hit_tokens, tail_block)``;
        ``hit_tokens < covered`` when chain links were evicted since
        parking or the tail block cannot be claimed — the caller
        recomputes exactly the difference (fault-back: never loss,
        never duplication)."""
        if request_id in self._tables:
            raise ValueError(
                f"request {request_id!r} already holds a block table — "
                f"free() it before resuming")
        bs = self.block_size
        full = (covered // bs) * bs
        shared: List[int] = []
        key: Optional[tuple] = None
        hit = 0
        while hit + bs <= full:
            key = (key, tuple(tokens[hit:hit + bs]))
            b = self._prefix_index.get(key)
            if b is None:
                break
            shared.append(b)
            hit += bs
        table = [self._share_entry(b) for b in shared]
        tail_block: Optional[int] = None
        hit_tokens = hit
        if want_tail and hit == full and covered > full and self._free:
            tail_block = self._claim()
            table.append(tail_block)
            hit_tokens = covered
        self._tables[request_id] = table
        self.last_hit_tokens = hit_tokens
        if hit_tokens > 0:
            self.num_prefix_hits += 1
            self.num_prefix_hit_tokens += hit_tokens
        return list(table), hit_tokens, tail_block

    def can_append(self, request_id: str, new_len: int) -> bool:
        """Would growing this request's sequence to ``new_len`` tokens
        fit (either inside its last block or with one free block)?"""
        need = self.blocks_needed(new_len) - len(self._tables[request_id])
        return need <= len(self._free)

    def append_slot(self, request_id: str, new_len: int,
                    write_from: Optional[int] = None) -> List[int]:
        """Ensure the table covers ``new_len`` tokens, growing by at most
        one block per decode step (a prefill chunk may grow by several).
        ``write_from`` is the first token position this step writes
        (default: ``new_len - 1``, the decode case) — any still-shared
        block in the write span is copy-on-write'd first. Raises
        NoFreeBlocksError on OOM (the scheduler's preemption trigger)."""
        table = self._tables[request_id]
        need = self.blocks_needed(new_len) - len(table)
        if write_from is None:
            write_from = new_len - 1
        bs = self.block_size
        span = range(max(write_from, 0) // bs,
                     min(len(table), cdiv(new_len, bs)))
        cow_idxs = [i for i in span
                    if self._refs.get(table[i], 0) > 1]
        # a virtual entry in the write span must land on device first
        # (defensive: demotion never covers the write frontier, but a
        # resumed chain hitting host-tier blocks can reach here)
        promo_idxs = [i for i in span if self.is_host_entry(table[i])]
        if need <= 0 and not cow_idxs and not promo_idxs:
            return list(table)
        # deterministic forced-OOM injection points: a `flag` fault at
        # the global point (any request) or the per-request one
        # (`serving.force_oom.<request_id>`) makes this growth OOM
        # exactly like a genuinely exhausted free list, so
        # preemption/swap paths are testable with a roomy cache
        if faults.check(faults.SERVING_FORCE_OOM) or \
                faults.check(f"{faults.SERVING_FORCE_OOM}.{request_id}"):
            raise NoFreeBlocksError(
                f"request {request_id!r}: injected OOM "
                f"(PADDLE_FAULTS serving.force_oom)")
        want = max(need, 0) + len(cow_idxs) + len(promo_idxs)
        if want > len(self._free):
            raise NoFreeBlocksError(
                f"request {request_id!r}: {want} "
                f"more block(s) needed for length {new_len}, "
                f"{len(self._free)} free")
        for i in promo_idxs:
            self._promote_entry(request_id, i, False)
        for i in cow_idxs:
            self._cow(request_id, i)
        for _ in range(max(need, 0)):
            table.append(self._claim())
        return list(table)

    # -- fleet KV-ship ----------------------------------------------------
    def export_blocks(self, request_id: str, num_tokens: int) -> List[int]:
        """The leading blocks of the request's table that cover its first
        ``num_tokens`` committed tokens — the device gather list for a
        fleet KV-ship. Read-only: refcounts and the prefix trie are
        untouched (the source keeps ownership until it releases; shared
        prefix blocks export fine, the peer receives a private copy)."""
        table = self._tables.get(request_id)
        if table is None:
            raise KeyError(f"request {request_id!r} holds no block table")
        need = self.blocks_needed(num_tokens)
        if need > len(table):
            raise ValueError(
                f"request {request_id!r}: table covers {len(table)} "
                f"block(s), {need} needed for {num_tokens} tokens")
        return list(table[:need])

    def import_blocks(self, request_id: str, num_tokens: int,
                      src_layout=None) -> List[int]:
        """Claim fresh device blocks to receive a shipped KV payload
        covering ``num_tokens`` tokens (fleet KV-ship import side). Every
        block is private (refcount 1) and starts unregistered — shipped
        content only becomes prefix-discoverable through the normal
        :meth:`commit_prefix` after the engine scatters the bytes, so a
        block is never shared before its K/V exists on device. Raises
        :class:`NoFreeBlocksError` when the pool cannot take the payload
        (the router falls back to recompute).

        ``src_layout`` is the wire payload's Layout (per-shard frames
        from the exporter's TP mesh). The block COUNT is layout-
        invariant — frames partition the kv-head dim, not tokens — but
        a payload whose layout has the wrong rank for this cache can
        never land, so it is refused here, before any block is claimed
        (a ValueError the router treats as a clean ladder fall)."""
        if request_id in self._tables:
            raise ValueError(
                f"request {request_id!r} already holds a block table — "
                f"free() it before importing")
        if (src_layout is not None and self.kv_layout is not None
                and src_layout.ndim != self.kv_layout.ndim):
            raise ValueError(
                f"request {request_id!r}: shipped payload layout has "
                f"rank {src_layout.ndim}, cache layout has rank "
                f"{self.kv_layout.ndim} — cannot reshard")
        need = self.blocks_needed(num_tokens)
        if need < 1:
            raise ValueError(
                f"request {request_id!r}: nothing to import for "
                f"{num_tokens} tokens")
        if need > len(self._free):
            raise NoFreeBlocksError(
                f"request {request_id!r}: {need} block(s) needed to "
                f"import {num_tokens} shipped tokens, "
                f"{len(self._free)} free")
        table = [self._claim() for _ in range(need)]
        self._tables[request_id] = table
        return list(table)

    def trim(self, request_id: str, num_tokens: int) -> int:
        """Shrink the table to cover exactly ``num_tokens`` tokens,
        releasing trailing blocks back to the free list — the
        speculative-decode rollback: slots claimed for draft tokens the
        target rejected return immediately. Trailing blocks were claimed
        via :meth:`append_slot` this step (never prefix-registered, which
        only ever covers the prompt), so ``_release`` just frees them.
        No-op when the table already fits. Returns blocks released."""
        table = self._tables.get(request_id)
        if table is None:
            return 0
        keep = max(self.blocks_needed(max(num_tokens, 1)), 1)
        released = 0
        while len(table) > keep:
            self._release(table.pop())
            released += 1
        return released

    def free(self, request_id: str) -> int:
        """Release every block the request owns — device AND host swap
        slots (completion, preemption, abort-while-swapped). Shared
        blocks just drop one reference. Returns the number of device
        block references released; idempotent for unknown ids (a request
        preempted before admission owns none)."""
        self.free_host(request_id)
        table = self._tables.pop(request_id, None)
        if table is None:
            return 0
        for b in table:
            self._release(b)
        return len(table)

    # -- host swap pool ---------------------------------------------------
    @property
    def num_free_host_blocks(self) -> int:
        return len(self._host_free)

    @property
    def num_used_host_blocks(self) -> int:
        return self.num_host_blocks - len(self._host_free)

    @property
    def num_host_blocks_used(self) -> int:
        """Host-tier occupancy for the pressure watermark + gauge:
        slots either owned (swap tables, virtual entries) or holding
        registered cached-free content. Only plain-free unregistered
        slots count as room."""
        unreg_free = sum(1 for s in self._host_free
                         if self.virtual_of(s) not in self._block_key)
        return self.num_host_blocks - unreg_free

    @property
    def reachable_blocks(self) -> int:
        """Admission capacity across tiers: the block count a single
        request may ultimately occupy. Tiered engines admit against
        this instead of the device pool alone."""
        return self.num_blocks + (self.num_host_blocks if self.tiered
                                  else 0)

    def host_tier_stats(self) -> Dict[str, int]:
        """Host-tier occupancy for watermark policy + gauges:
        ``used`` counts owned slots (swap tables + virtual entries),
        ``registered`` counts slots holding trie-discoverable content
        (owned or parked cached-free)."""
        reg = sum(1 for e in self._block_key if self.is_host_entry(e))
        return {"total": self.num_host_blocks,
                "free": len(self._host_free),
                "used": self.num_used_host_blocks,
                "registered": reg}

    def has_host_table(self, request_id: str) -> bool:
        return request_id in self._host_tables

    def host_table(self, request_id: str) -> List[int]:
        return list(self._host_tables[request_id])

    def can_swap_out(self, request_id: str, num_tokens: int) -> bool:
        """Could ``num_tokens`` worth of this request's cached K/V move
        to host slots right now?"""
        return (self.num_host_blocks > 0
                and request_id in self._tables
                and request_id not in self._host_tables
                # a tiered table holding virtual entries is already
                # partially host-resident; whole-table swap would
                # double-count those slots — the ladder falls through
                # to demotion or recompute instead
                and not any(self.is_host_entry(b)
                            for b in self._tables[request_id])
                and self.blocks_needed(num_tokens) <= len(self._host_free))

    def swap_out(self, request_id: str,
                 num_tokens: int) -> Tuple[List[int], List[int]]:
        """Trade the request's device blocks for host slots covering its
        first ``num_tokens`` tokens. Returns ``(device_table,
        host_table)`` — the caller must copy device->host before the
        freed device blocks are rewritten (synchronously, or async with
        a fence ahead of the next step that could reuse them; the
        engine's _KVSwapper does the latter). Each host slot starts at
        refcount 1."""
        if not self.can_swap_out(request_id, num_tokens):
            raise NoFreeBlocksError(
                f"request {request_id!r}: cannot swap out "
                f"{self.blocks_needed(num_tokens)} block(s) "
                f"({len(self._host_free)} host slots free, "
                f"pool={self.num_host_blocks})")
        need = self.blocks_needed(num_tokens)
        host = [self._claim_host() for _ in range(need)]
        self._host_tables[request_id] = host
        dev = self._tables.pop(request_id)
        for b in dev:
            self._release(b)
        return dev, host

    def can_swap_in(self, request_id: str) -> bool:
        return (request_id in self._host_tables
                and len(self._host_tables[request_id]) <= len(self._free))

    def swap_in(self, request_id: str) -> Tuple[List[int], List[int]]:
        """Trade host slots back for fresh device blocks (one per spilled
        block). Returns ``(host_table, device_table)`` — the caller
        copies host->device, after which the host refs are already
        dropped. Raises on OOM (the scheduler re-tries next iteration)."""
        host = self._host_tables.get(request_id)
        if host is None:
            raise KeyError(f"request {request_id!r} holds no host table")
        if request_id in self._tables:
            raise ValueError(
                f"request {request_id!r} already holds a device table")
        if len(host) > len(self._free):
            raise NoFreeBlocksError(
                f"request {request_id!r}: {len(host)} device block(s) "
                f"needed to swap in, {len(self._free)} free")
        dev = [self._claim() for _ in range(len(host))]
        self._tables[request_id] = dev
        self._host_tables.pop(request_id)
        self._unref_host(host)
        return host, dev

    def free_host(self, request_id: str) -> int:
        """Drop the request's host slots (abort while swapped)."""
        host = self._host_tables.pop(request_id, None)
        if host is None:
            return 0
        self._unref_host(host)
        return len(host)

    def _unref_host(self, slots: List[int]):
        for s in slots:
            n = self._host_refs.get(s, 0) - 1
            if n <= 0:
                self._host_refs.pop(s, None)
                if self.virtual_of(s) in self._block_key:
                    # cached-free host slot: registered content parks at
                    # the cold end so host-tier prefixes are reclaimed
                    # last, oldest first (mirrors the device free list)
                    self._host_free.insert(0, s)
                else:
                    self._host_free.append(s)
            else:
                self._host_refs[s] = n

    # -- introspection (tests + metrics) ---------------------------------
    def check_invariants(self):
        """Exact free-block accounting; raises AssertionError on any
        violation (used by the randomized-sequence tests every step)."""
        owned = [b for t in self._tables.values() for b in t]
        virt_owned = [self.host_slot_of(b) for b in owned
                      if self.is_host_entry(b)]
        owned = [b for b in owned if not self.is_host_entry(b)]
        assert self.tiered or not virt_owned, \
            "virtual table entries in a non-tiered manager"
        counts: Dict[int, int] = {}
        for b in owned:
            counts[b] = counts.get(b, 0) + 1
        assert counts == self._refs, (
            f"refcount drift: tables imply {counts}, refs track "
            f"{self._refs}")
        assert len(counts) + len(self._free) == self.num_blocks, (
            f"block leak: {len(counts)} owned + {len(self._free)} free "
            f"!= {self.num_blocks}")
        assert len(set(self._free)) == len(self._free), \
            "duplicate block in free list"
        both = set(counts) & set(self._free)
        assert not both, f"blocks both owned and free: {sorted(both)}"
        if not self.enable_prefix_cache:
            assert all(n == 1 for n in self._refs.values()), \
                "shared block without prefix caching"
        # trie bijection: every key maps to a block that maps back
        assert len(self._prefix_index) == len(self._block_key), \
            "prefix index / block key size drift"
        for key, b in self._prefix_index.items():
            assert self._block_key.get(b) == key, \
                f"trie drift: block {b} does not map back to its key"
        # advertisement maps ride the trie exactly: every registered key
        # has a hash, every hash maps back, token counts track hashes
        assert set(self._key_hash) == set(self._prefix_index), \
            "key-hash map drifted from the prefix index"
        for h, k in self._hash_key.items():
            assert self._key_hash.get(k) == h, \
                f"hash map drift: {h} does not map back to its key"
        assert set(self._hash_tokens) == set(self._hash_key), \
            "hash token-count map drifted from the hash map"
        assert not self._cow_pairs, \
            "pending COW pairs not drained before invariant check"
        assert not self._tier_moves, \
            "pending tier moves not drained before invariant check"
        # host pool: same exact accounting as the device side — a slot
        # appears across swap tables AND virtual table entries exactly
        # ``_host_refs[slot]`` times
        h_owned = [s for t in self._host_tables.values() for s in t]
        assert len(h_owned) == len(set(h_owned)), \
            "double-allocated host swap slot"
        h_owned += virt_owned
        h_counts: Dict[int, int] = {}
        for s in h_owned:
            h_counts[s] = h_counts.get(s, 0) + 1
        assert h_counts == self._host_refs, (
            f"host refcount drift: tables imply {h_counts}, refs track "
            f"{self._host_refs}")
        assert all(n >= 1 for n in self._host_refs.values()), \
            "host slot with refcount < 1 still tracked"
        assert len(h_counts) + len(self._host_free) == \
            self.num_host_blocks, (
                f"host slot leak: {len(h_counts)} owned + "
                f"{len(self._host_free)} free != {self.num_host_blocks}")
        h_both = set(h_counts) & set(self._host_free)
        assert not h_both, \
            f"host slots both owned and free: {sorted(h_both)}"
        assert len(set(self._host_free)) == len(self._host_free), \
            "duplicate slot in host free list"
        # every registered host-tier id names a real slot, owned or
        # parked cached-free — never dangling
        for e in self._block_key:
            if self.is_host_entry(e):
                s = self.host_slot_of(e)
                assert 0 <= s < self.num_host_blocks, \
                    f"registered virtual id {e} out of range"
                assert s in h_counts or s in self._host_free, \
                    f"registered host slot {s} neither owned nor free"
