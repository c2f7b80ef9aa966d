"""Iteration-level (continuous-batching) scheduler, adapted from the JAX
package's ``serving/scheduler.py``: its mixed, chunked-prefill policy
(``_schedule_mixed``), which is the one the ragged engine step runs.

Orca's insight, as shipped by vLLM: scheduling decisions happen every
model iteration, not per request. Each call to :meth:`schedule` packs
one MIXED batch under a raw token budget — decode rows first, then
in-flight prefill chunks, then new admissions whose prompts are chunked
to the budget — so late-arriving requests join the running batch at the
next iteration boundary instead of waiting for a full drain.

Preemption: when a row needs a block and none are free, the
lowest-priority running request (largest ``(priority, arrival)`` key)
is evicted — never a higher-priority one — until the victim set frees
enough. The victim is reset to WAITING and recomputes its whole prefix
on re-admission (vLLM's default). Priority-then-FCFS admission plus
eviction-from-the-back gives the most important request a monotonically
growing claim on the cache, so every admitted request eventually
finishes.

Deadlines: every :meth:`schedule` call first expires requests whose
``deadline_ms`` TTL has passed — waiting or running — freeing their
blocks and reporting them in ``ScheduledBatch.expired`` so the engine
can emit structured ``finish_reason='expired'`` outputs.

The JAX package's classic prefill-xor-decode policy, host swap, tier
relief, speculative verify rows and KV-ship continuations are left out:
the engine refuses the configurations that would need them."""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional

from paddle_tpu_torch.serving.block_manager import (BlockManager,
                                                    NoFreeBlocksError)
from paddle_tpu_torch.serving.request import Request, RequestStatus

__all__ = ["SchedulerConfig", "ScheduledBatch", "Scheduler"]


@dataclass
class SchedulerConfig:
    """Admission/batching knobs.

    ``max_num_seqs``   — max concurrently RUNNING requests (rows of a
                         batch).
    ``max_batched_tokens`` — per-iteration RAW token budget (the ragged
                         step pads nothing, so the raw token count is
                         the work).
    """

    max_num_seqs: int = 8
    max_batched_tokens: int = 2048

    def __post_init__(self):
        if self.max_num_seqs < 1:
            raise ValueError("max_num_seqs must be >= 1")
        if self.max_batched_tokens < self.max_num_seqs:
            raise ValueError(
                "max_batched_tokens must be >= max_num_seqs (every "
                "running row must afford its decode token)")


@dataclass
class ScheduledBatch:
    """One iteration's work: rows, the tokens scheduled for each
    (parallel to ``requests``), and the batch kind. ``preempted`` lists
    requests evicted while forming this batch (reset to WAITING for
    recompute); ``expired`` lists requests whose deadline passed
    (already terminal, blocks freed — the engine emits their
    outputs)."""

    kind: str                       # "prefill" | "decode" | "mixed" | "idle"
    requests: List[Request] = field(default_factory=list)
    preempted: List[Request] = field(default_factory=list)
    expired: List[Request] = field(default_factory=list)
    num_scheduled: List[int] = field(default_factory=list)

    @property
    def is_empty(self) -> bool:
        return not self.requests


class Scheduler:
    def __init__(self, block_manager: BlockManager,
                 config: Optional[SchedulerConfig] = None):
        self.block_manager = block_manager
        self.config = config or SchedulerConfig()
        self.waiting: Deque[Request] = deque()
        self.running: List[Request] = []
        self.num_preemptions = 0
        # pieces scheduled for prompts the budget ever split (every
        # piece of a split prompt counts, including the final one)
        self.num_prefill_chunks = 0

    # -- queue ops -------------------------------------------------------
    def add(self, request: Request):
        request.status = RequestStatus.WAITING
        self.waiting.append(request)

    def has_unfinished(self) -> bool:
        return bool(self.waiting or self.running)

    @property
    def num_waiting(self) -> int:
        return len(self.waiting)

    @property
    def num_waiting_tokens(self) -> int:
        """Uncached tokens queued for prefill — the work ahead of a new
        arrival, which the admission controller's TTFT estimate weighs
        so long prompts can't sneak past the SLO gate."""
        return sum(len(r.tokens_to_run()) for r in self.waiting)

    @property
    def num_running(self) -> int:
        return len(self.running)

    def finish(self, request: Request):
        """Completion: reclaim blocks, drop from the running set."""
        self.block_manager.free(request.request_id)
        if request in self.running:
            self.running.remove(request)

    def abort(self, request_id: str, reason: str = "aborted:user") -> bool:
        """Cancel a request wherever it is — waiting or running (its
        blocks freed); True when found."""
        for q in (self.running, self.waiting):
            for r in list(q):
                if r.request_id == request_id:
                    self.block_manager.free(r.request_id)
                    q.remove(r)
                    r.abort(reason)
                    return True
        return False

    def expire_deadlines(self, now: Optional[float] = None
                         ) -> List[Request]:
        """TTL sweep: terminate every request whose deadline passed,
        on every lifecycle queue, freeing its blocks. Returns the
        expired requests (engine emits their structured outputs)."""
        now = time.monotonic() if now is None else now
        out: List[Request] = []
        for q in (self.running, self.waiting):
            for r in list(q):
                if r.expired(now):
                    self.block_manager.free(r.request_id)
                    q.remove(r)
                    r.abort("expired")
                    out.append(r)
        return out

    # -- preemption ------------------------------------------------------
    def _evict(self, victim: Request):
        """Evict ``victim`` from the running set: every block returns to
        the free list and the victim goes to the FRONT of the waiting
        queue for recompute, so it is not starved behind newer
        arrivals."""
        self.running.remove(victim)
        self.num_preemptions += 1
        self.block_manager.free(victim.request_id)
        victim.preempt()
        self.waiting.appendleft(victim)

    def _preempt_one(self, for_request: Request) -> Optional[Request]:
        """Evict the lowest-priority running request — largest
        ``(priority, arrival)`` key — to free blocks for
        ``for_request``, but never a HIGHER-priority one: when
        ``for_request`` is itself the lowest priority, returns None and
        the caller self-preempts."""
        candidates = [r for r in self.running
                      if r is not for_request
                      and r.sort_key >= for_request.sort_key]
        if not candidates:
            return None
        victim = max(candidates, key=lambda r: r.sort_key)
        self._evict(victim)
        return victim

    # -- the per-iteration decision --------------------------------------
    def schedule(self) -> ScheduledBatch:
        """One MIXED batch under a raw token budget: (A) decode rows
        first — one token each, bounding TPOT; (B) mid-prefill rows
        continue with whatever budget remains, chunked; (C) new
        admissions fill the rest, their prompts chunked too (and served
        from the prefix cache where full prompt blocks match). Each pass
        runs the same evict-lowest-priority OOM loop, so the starvation
        guard holds throughout."""
        expired = self.expire_deadlines()
        bm = self.block_manager
        budget = self.config.max_batched_tokens
        rows: List[Request] = []
        nsched: List[int] = []
        preempted: List[Request] = []
        used = 0
        any_prefill = False
        any_decode = False

        def drop_row(victim: Request):
            nonlocal used
            if victim in rows:
                i = rows.index(victim)
                rows.pop(i)
                used -= nsched.pop(i)

        def claim_slots(req: Request, new_len: int,
                        write_from: int) -> bool:
            """append_slot with the preempt-or-self-evict loop; False
            means req itself was evicted."""
            while True:
                try:
                    bm.append_slot(req.request_id, new_len,
                                   write_from=write_from)
                    return True
                except NoFreeBlocksError:
                    victim = self._preempt_one(req)
                    if victim is None:
                        self._evict(req)
                        preempted.append(req)
                        return False
                    preempted.append(victim)
                    drop_row(victim)

        # pass A — decode rows (fully caught-up requests, cost 1 each)
        running = sorted(self.running, key=lambda r: r.sort_key)
        decode_rows = [r for r in running
                       if len(r.tokens) - r.num_cached == 1
                       and r.num_generated > 0]
        chunk_rows = [r for r in running if r not in decode_rows]
        for req in decode_rows:
            if req not in self.running:
                continue  # evicted saving a more important row
            if used >= budget:
                break
            if claim_slots(req, len(req.tokens), len(req.tokens) - 1):
                rows.append(req)
                nsched.append(1)
                used += 1
                any_decode = True

        # pass B — continue mid-prefill rows (chunk = remaining budget);
        # a preempted/recomputed request catching back up is the same
        # shape: everything in ``tokens`` past ``num_cached`` is prefill
        for req in chunk_rows:
            if req not in self.running:
                continue
            left = budget - used
            if left <= 0:
                break
            remaining = len(req.tokens) - req.num_cached
            n = min(remaining, left)
            if claim_slots(req, req.num_cached + n, req.num_cached):
                rows.append(req)
                nsched.append(n)
                used += n
                any_prefill = True
                if n < remaining:
                    req.was_chunked = True
                if req.was_chunked:
                    self.num_prefill_chunks += 1

        # pass C — admit waiting requests (priority, then FCFS);
        # head-of-line: the first candidate that doesn't fit ends
        # admission so a starved high-priority request is never overtaken
        admitted: List[Request] = []
        for req in sorted(self.waiting, key=lambda r: r.sort_key):
            if len(self.running) + len(admitted) >= \
                    self.config.max_num_seqs:
                break
            left = budget - used
            if left <= 0:
                break
            total = len(req.tokens)
            eff = min(bm.match_prefix(req.tokens), total - 1)
            n = min(total - eff, left)
            try:
                bm.allocate(req.request_id, eff + n, tokens=req.tokens)
            except NoFreeBlocksError:
                break  # blocks free up as running requests finish
            req.num_cached = bm.last_hit_tokens
            req.status = RequestStatus.RUNNING
            admitted.append(req)
            rows.append(req)
            nsched.append(n)
            used += n
            any_prefill = True
            if n < total - req.num_cached:
                req.was_chunked = True
            if req.was_chunked:
                self.num_prefill_chunks += 1
        if admitted:
            taken = set(id(r) for r in admitted)
            self.waiting = deque(r for r in self.waiting
                                 if id(r) not in taken)
            self.running.extend(admitted)

        if not rows:
            return ScheduledBatch(kind="idle", preempted=preempted,
                                  expired=expired)
        kind = ("mixed" if (any_prefill and any_decode)
                else "prefill" if any_prefill else "decode")
        return ScheduledBatch(kind=kind, requests=rows,
                              preempted=preempted, expired=expired,
                              num_scheduled=nsched)
