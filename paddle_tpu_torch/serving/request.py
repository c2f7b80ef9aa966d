"""Serving request/state primitives.

Reference capability: the AnalysisPredictor request lifecycle
(paddle/fluid/inference/api/analysis_predictor.h) generalized to the
Orca/vLLM continuous-batching model: a request is admitted, prefilled
once, then produces one token per engine iteration until EOS/max-token
completion — and may be preempted back to WAITING when the paged KV
cache runs out of blocks: back to WAITING for recompute, or SWAPPED with
its KV spilled to the host pool and restored on re-admission."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, List, Optional

import numpy as np

__all__ = ["SamplingParams", "RequestStatus", "Request", "RequestOutput",
           "FINISH_REASONS"]


@dataclass
class SamplingParams:
    """Per-request decode knobs. ``temperature<=0`` is greedy argmax;
    otherwise softmax sampling at that temperature, optionally truncated
    to the ``top_k`` highest-probability tokens and/or the smallest
    nucleus with cumulative mass >= ``top_p``.

    SLO knobs: ``deadline_ms`` is a TTL from arrival — the scheduler
    expires the request (``finish_reason='expired'``) the first
    iteration boundary after arrival+deadline, wherever it is in its
    lifecycle. ``priority`` orders admission and protects against
    preemption: LOWER values are MORE important (scheduled first,
    evicted last); default 0, ties broken FCFS by arrival.

    ``seed`` fixes the request's sampling stream; without it the stream
    derives from the request id.

    ``tenant_id`` names the traffic source for fleet-level fairness:
    the multi-replica router (``paddle_tpu_torch.serving.fleet``) runs
    weighted deficit-round-robin across tenants so one tenant's burst
    cannot starve the others. A single engine ignores it."""

    max_new_tokens: int = 32
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0
    eos_token_id: Optional[int] = None
    seed: Optional[int] = None
    deadline_ms: Optional[float] = None
    priority: int = 0
    tenant_id: str = "default"

    def __post_init__(self):
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError("deadline_ms must be > 0")


class RequestStatus(Enum):
    WAITING = "waiting"      # queued (new, or preempted for recompute)
    RUNNING = "running"      # KV cached; decoding one token per step
    SWAPPED = "swapped"      # preempted with KV spilled to the host pool
    FINISHED = "finished"    # done — see Request.finish_reason for how


# Request.finish_reason vocabulary (every terminal path names one):
#   "stop"              hit eos_token_id
#   "length"            hit max_new_tokens
#   "expired"           deadline_ms TTL passed before completion
#   "rejected"          admission controller refused it (never scheduled)
#   "aborted:user"      abort_request() cancellation
#   "aborted:drain"     engine drained (SIGTERM/preemption) before it ran
#   "aborted:nonfinite" its logits went NaN/Inf (batch peers continue)
#   "aborted:error"     engine step failed past the retry budget
#   "fenced"            lease lost to another router; the local copy is
#                       dropped without emitting (the adopter finishes it)
FINISH_REASONS = ("stop", "length", "expired", "rejected", "aborted:user",
                  "aborted:drain", "aborted:nonfinite", "aborted:error",
                  "fenced")


@dataclass
class Request:
    """One in-flight generation. ``tokens`` is prompt + generated so far;
    ``num_cached`` counts the leading tokens whose K/V live in the paged
    cache (0 after admission or preemption — preempted requests recompute
    their whole prefix on re-admission)."""

    request_id: str
    prompt_ids: List[int]
    sampling: SamplingParams = field(default_factory=SamplingParams)
    callback: Optional[Callable] = None   # (request_id, token, finished)
    arrival_time: float = field(default_factory=time.monotonic)

    status: RequestStatus = RequestStatus.WAITING
    tokens: List[int] = field(default_factory=list)
    num_cached: int = 0
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    num_preemptions: int = 0
    num_swaps: int = 0
    finish_reason: Optional[str] = None
    # True once the scheduler ever split this request's prefill into
    # budget-sized chunks (sticky; drives the prefill_chunks metric)
    was_chunked: bool = False
    # Speculative-decode proposals pending verification this step. NOT
    # part of ``tokens`` — they become real tokens only if the target
    # accepts them; any interruption (preempt/abort) drops them.
    draft_tokens: List[int] = field(default_factory=list)

    def __post_init__(self):
        if not self.prompt_ids:
            raise ValueError(f"request {self.request_id!r}: empty prompt")
        self.tokens = list(self.prompt_ids)
        seed = self.sampling.seed
        if seed is None:
            # deterministic per request id ACROSS processes (str hash()
            # is salted per interpreter), so a preempt/re-admit cycle —
            # or a replayed run — samples the same stream
            import hashlib

            digest = hashlib.sha256(
                b"paddle_tpu.serving:" +
                self.request_id.encode()).digest()
            seed = int.from_bytes(digest[:8], "little")
        # The request's RNG: a threefry key in the same uint32[2] layout
        # as jax.random.PRNGKey(seed), advanced on the device by the
        # engine's sampler (a fixed number of splits per emitting step)
        # and written back after each fetch. Derived with the same salt
        # as the JAX package, so it is deterministic across processes
        # and a key carried between the two packages resumes the
        # identical stream.
        self.device_key = np.array(
            [(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)

    # -- derived ---------------------------------------------------------
    @property
    def num_prompt_tokens(self) -> int:
        return len(self.prompt_ids)

    @property
    def generated(self) -> List[int]:
        return self.tokens[len(self.prompt_ids):]

    @property
    def num_generated(self) -> int:
        return len(self.tokens) - len(self.prompt_ids)

    @property
    def is_finished(self) -> bool:
        return self.status == RequestStatus.FINISHED

    @property
    def priority(self) -> int:
        return self.sampling.priority

    @property
    def sort_key(self):
        """Total scheduling order: (priority, arrival) — lower tuples
        are more important. Preserved across preemption (arrival_time
        never resets), so an evicted request keeps its place."""
        return (self.sampling.priority, self.arrival_time)

    @property
    def deadline(self) -> Optional[float]:
        """Absolute monotonic expiry instant, or None (no TTL)."""
        if self.sampling.deadline_ms is None:
            return None
        return self.arrival_time + self.sampling.deadline_ms / 1e3

    def expired(self, now: Optional[float] = None) -> bool:
        dl = self.deadline
        if dl is None or self.is_finished:
            return False
        return (time.monotonic() if now is None else now) > dl

    def tokens_to_run(self) -> List[int]:
        """Tokens whose K/V must be computed this iteration: the whole
        uncached prefix for a prefill, the single newest token for a
        decode step."""
        return self.tokens[self.num_cached:]

    def preempt(self):
        """Back to WAITING for recompute: the scheduler has freed this
        request's blocks; all progress (generated tokens) is kept, only
        the KV cache contents are recomputed on re-admission."""
        self.status = RequestStatus.WAITING
        self.num_cached = 0
        self.num_preemptions += 1
        self.draft_tokens = []

    def swap_out(self):
        """Preemption by host spill: device blocks freed, their contents
        parked in the BlockManager's host pool. ``num_cached`` is KEPT —
        for a SWAPPED request it counts tokens whose K/V live in host
        slots; swap-in restores them and the request resumes decoding
        with no recompute."""
        self.status = RequestStatus.SWAPPED
        self.num_preemptions += 1
        self.num_swaps += 1
        self.draft_tokens = []

    def swap_in(self):
        self.status = RequestStatus.RUNNING

    def abort(self, reason: str):
        """Terminal, without a sampled token: drain, expiry, rejection,
        user cancel, poisoned logits, step failure."""
        self.status = RequestStatus.FINISHED
        self.finish_reason = reason
        if self.finish_time is None:
            self.finish_time = time.monotonic()

    def append_token(self, token: int) -> bool:
        """Record a sampled token; returns True when the request is now
        finished (EOS or max_new_tokens)."""
        self.tokens.append(int(token))
        if self.first_token_time is None:
            self.first_token_time = time.monotonic()
        sp = self.sampling
        hit_eos = (sp.eos_token_id is not None and
                   int(token) == sp.eos_token_id)
        done = hit_eos or self.num_generated >= sp.max_new_tokens
        if done:
            self.status = RequestStatus.FINISHED
            self.finish_reason = "stop" if hit_eos else "length"
            self.finish_time = time.monotonic()
        return done


@dataclass
class RequestOutput:
    """One step's emission for a request (streamed via ``callback`` and
    returned from ``LLMEngine.step``). ``token`` is None on tokenless
    terminal emissions — expiry, rejection, user/nonfinite/error aborts
    — whose ``finish_reason`` says why; ``generated`` still carries
    whatever the request produced before the abort."""

    request_id: str
    token: Optional[int]
    finished: bool
    generated: List[int]
    finish_reason: Optional[str] = None

    @property
    def aborted(self) -> bool:
        return self.finished and self.finish_reason not in (
            None, "stop", "length")

    @property
    def text_tokens(self) -> List[int]:  # parity alias
        return self.generated
