"""Paged KV-cache block allocator (vLLM PagedAttention block manager),
adapted from the JAX package's ``serving/block_manager.py``.

The physical cache is ``num_blocks`` fixed-size blocks per layer (one
shared free list — every layer's cache uses the same block ids, so the
block table a request holds indexes all layers at once, exactly how the
ragged kernel consumes it).

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

Invariants (pinned by tests/test_torch_serving.py storms against the
JAX package):
  * a block id appears in tables exactly ``refcount`` times,
  * ``len(free) + len(distinct owned) == num_blocks`` always,
  * free and owned are disjoint; trie keys map 1:1 onto keyed blocks,
  * ``free``/preemption returns every exclusively-owned block.

Swap pool: ``num_host_blocks > 0`` adds a second, host-side slot
allocator for swap-based preemption: ``swap_out`` trades a victim's
device blocks for refcounted host slots (the engine copies the KV
bytes), ``swap_in`` trades them back. The same exact-accounting
invariants hold for the host pool, and ``free()`` releases BOTH sides,
so no lifecycle path (abort while swapped included) can leak.

The JAX package's KV tiers (virtual host entries, ``demote_*``,
``promote_blocks``, ``reachable_blocks``: C1) and fleet KV-ship paths
(C2) are left out; the engine refuses the configurations that would
need them. :meth:`trim` is the speculative-decode rollback."""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from paddle_tpu_torch.testing import faults

__all__ = ["BlockManager", "NoFreeBlocksError"]


class NoFreeBlocksError(RuntimeError):
    """Raised when an allocation is attempted past capacity; the
    scheduler catches this OOM signal and preempts."""


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


class BlockManager:
    def __init__(self, num_blocks: int, block_size: int,
                 num_host_blocks: int = 0,
                 enable_prefix_cache: bool = False, kv_layout=None):
        if num_blocks < 1 or block_size < 1:
            raise ValueError("num_blocks and block_size must be >= 1")
        if num_host_blocks < 0:
            raise ValueError("num_host_blocks must be >= 0")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.enable_prefix_cache = enable_prefix_cache
        # the layout of the paged caches these block ids index, opaque
        # here: allocation is layout-agnostic (a block id covers
        # block_size tokens however its bytes are framed)
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

    def _claim(self) -> int:
        """Pop a free block, dropping any stale prefix registration (this
        is the cache-eviction point: reuse invalidates content)."""
        b = self._free.pop()
        key = self._block_key.pop(b, None)
        if key is not None and self._prefix_index.get(key) == b:
            self._prefix_index.pop(key)
        self._refs[b] = 1
        return b

    def _claim_host(self) -> int:
        """Pop a free host slot (hot end), born at refcount 1."""
        s = self._host_free.pop()
        self._host_refs[s] = 1
        return s

    def _release(self, block: int):
        """Drop one reference; at zero the block returns to the free list
        (cold end if its content is still registered)."""
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
        idx = 0
        while (idx + 1) * bs <= limit:
            key = (key, tuple(tokens[idx * bs:(idx + 1) * bs]))
            b = table[idx]
            if key not in self._prefix_index and b not in self._block_key:
                # (a prefix someone committed first keeps their block)
                self._prefix_index[key] = b
                self._block_key[b] = key
            idx += 1

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
        shared_free = sum(1 for b in shared if self._refs.get(b, 0) == 0)
        # the capped write position lands inside a shared block someone
        # else still references -> one extra block for the COW copy
        cow_idx = eff // bs if (0 < eff < hit_tok) else None
        cow_need = 0
        if cow_idx is not None and self._refs.get(shared[cow_idx], 0) >= 1:
            cow_need = 1
        if fresh_need + shared_free + cow_need > len(self._free):
            raise NoFreeBlocksError(
                f"need {fresh_need + cow_need} fresh block(s) for "
                f"{num_tokens} tokens ({hit_tok} prefix-cached), "
                f"{len(self._free) - shared_free} free")
        table: List[int] = []
        for b in shared:
            if self._refs.get(b, 0) == 0:
                self._free.remove(b)  # un-free a cached block, key kept
                self._refs[b] = 1
            else:
                self._refs[b] += 1
            table.append(b)
        for _ in range(fresh_need):
            table.append(self._claim())
        self._tables[request_id] = table
        self.last_hit_tokens = eff
        if eff > 0:
            self.num_prefix_hits += 1
            self.num_prefix_hit_tokens += eff
        if cow_idx is not None and self._refs[table[cow_idx]] > 1:
            self._cow(request_id, cow_idx)
        return list(table)

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
        cow_idxs = [i for i in span if self._refs.get(table[i], 0) > 1]
        if need <= 0 and not cow_idxs:
            return list(table)
        # deterministic forced-OOM injection points: a `flag` fault at
        # the global point (any request) or the per-request one
        # (`serving.force_oom.<request_id>`) makes this growth OOM
        # exactly like a genuinely exhausted free list, so preemption is
        # testable with a roomy cache
        if faults.check(faults.SERVING_FORCE_OOM) or \
                faults.check(f"{faults.SERVING_FORCE_OOM}.{request_id}"):
            raise NoFreeBlocksError(
                f"request {request_id!r}: injected OOM "
                f"(PADDLE_FAULTS serving.force_oom)")
        want = max(need, 0) + len(cow_idxs)
        if want > len(self._free):
            raise NoFreeBlocksError(
                f"request {request_id!r}: {want} "
                f"more block(s) needed for length {new_len}, "
                f"{len(self._free)} free")
        for i in cow_idxs:
            self._cow(request_id, i)
        for _ in range(max(need, 0)):
            table.append(self._claim())
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
        """Host-pool occupancy: owned slots (no tiers here, so no
        registered cached-free host content either)."""
        return self.num_used_host_blocks

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
                and self.blocks_needed(num_tokens) <= len(self._host_free))

    def swap_out(self, request_id: str,
                 num_tokens: int) -> Tuple[List[int], List[int]]:
        """Trade the request's device blocks for host slots covering its
        first ``num_tokens`` tokens. Returns ``(device_table,
        host_table)`` — the caller must copy device->host before the
        freed device blocks are rewritten (the engine's _KVSwapper
        enqueues the copy on the step's stream, ahead of the next step).
        Each host slot starts at refcount 1."""
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
                self._host_free.append(s)
            else:
                self._host_refs[s] = n

    # -- introspection (tests + metrics) ---------------------------------
    def check_invariants(self):
        """Exact free-block accounting; raises AssertionError on any
        violation (used by the randomized-sequence tests every step)."""
        counts: Dict[int, int] = {}
        for t in self._tables.values():
            for b in t:
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
        assert not self._cow_pairs, \
            "pending COW pairs not drained before invariant check"
        # host pool: same exact accounting as the device side — a slot
        # appears across the swap tables exactly ``_host_refs[slot]``
        # times
        h_owned = [s for t in self._host_tables.values() for s in t]
        assert len(h_owned) == len(set(h_owned)), \
            "double-allocated host swap slot"
        h_counts: Dict[int, int] = {}
        for s in h_owned:
            h_counts[s] = h_counts.get(s, 0) + 1
        assert h_counts == self._host_refs, (
            f"host refcount drift: tables imply {h_counts}, refs track "
            f"{self._host_refs}")
        assert len(h_counts) + len(self._host_free) == \
            self.num_host_blocks, (
                f"host slot leak: {len(h_counts)} owned + "
                f"{len(self._host_free)} free != {self.num_host_blocks}")
        h_both = set(h_counts) & set(self._host_free)
        assert not h_both, \
            f"host slots both owned and free: {sorted(h_both)}"
        assert len(set(self._host_free)) == len(self._host_free), \
            "duplicate slot in host free list"
