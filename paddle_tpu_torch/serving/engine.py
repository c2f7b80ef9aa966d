"""LLMEngine — continuous-batching inference over a paged KV cache (port
of ``paddle_tpu/serving/engine.py``, the one-card paths).

* the KV cache is ONE stacked device tensor per K and V —
  ``(layers, num_blocks, block_size, kv_heads, head_dim)`` — allocated on
  the model's device in the model's dtype, indexed by per-request block
  tables from :class:`BlockManager`, and updated IN PLACE by each step;
* on the ragged path (the default for models exposing
  ``forward_ragged``) every iteration is ONE ragged step: the scheduled
  rows of prefill chunks and decode rows are packed into a (T,) token
  stream over S sequence slots and run through ``model.forward_ragged``,
  whose attention is the hand-written ragged paged attention kernel on
  the card. T is a bucket of a fixed lattice, ``min_prefill_bucket * 2**i``
  capped at the token budget: the smallest that holds the step's
  tokens, the rest pad rows (id 0, past ``cu_seqlens[num_seqs]``, so
  they never reach the cache or attention). On the card each bucket's
  step is captured once as a CUDA graph and replayed
  (:class:`~paddle_tpu_torch.jit.trace.StepGraphs`); ``_seen_shapes``
  holds the ``("ragged", T, S)`` keys stepped, on the card the captured
  ones. (The JAX engine compiles one shape, the whole budget: a decode
  step of 8 rows would then push 2048 rows through every GEMM);
* prompt prefixes are cached: full prompt blocks register in the
  BlockManager's trie after the step that writes them, later requests
  share them by refcount, and the first divergent write copies on write
  (``_apply_cow`` lands the block copies before the step);
* sampling runs on the device (:mod:`paddle_tpu_torch.ops.sampling`,
  threefry streams identical to the JAX package's): the step ends in
  ONE host fetch of a packed (S, R+4) int32 tensor —
  ``[tokens(R), n_emit, key_hi, key_lo, finite]`` per slot — never the
  S x vocab logits;
* ``EngineConfig(draft_model=, num_spec_tokens=k)`` proposes k greedy
  draft tokens per decode row (:class:`~paddle_tpu_torch.serving.spec.
  SpecDecoder`, on the draft's flash-attention forward) at the top of
  each step; the target verifies them as one 1+k-token mid-context row
  of the same ragged step (``forward_ragged_multi`` gathers R = k+1
  logit rows per slot) and the sampler rejection-samples them.
  Rejected drafts' KV slots roll back through ``BlockManager.trim``.
  The draft's k forwards are one CUDA graph per (batch, width) bucket.
* the caches are updated in place, as the JAX engine's donated buffers
  are: with ``donate_cache`` (the default on the card) a failed step is
  not retried — it may have written part of the cache, and on the card
  an error inside a graph replay is sticky — and the engine aborts
  every request with structured outputs.
* ``ragged=False`` is the bucketed path, for models without
  ``forward_ragged``: classic prefill-xor-decode batches padded to
  (B, S) buckets (``_batch_bucket``, ``_seq_bucket``) through
  ``model.forward_paged``, whose attention is plain torch ops
  (``block_multihead_attention``); on the card one graph per
  ``(kind, B, S)`` key, so ``_seen_shapes`` holds the reference's keys.

Resilience:

* **swap-based preemption** — ``swap_mode='host'`` spills an OOM
  victim's KV blocks to a pinned host pool of ``num_host_blocks`` slots
  (:class:`_KVSwapper`, an async device-to-host copy on the step's
  stream) and restores them in place on re-admission, token-identical
  to the recompute path;
* **graceful drain** — :meth:`LLMEngine.install_preemption_handler`
  wires SIGTERM into the step loop: a draining engine stops admitting,
  aborts waiting/swapped requests with ``finish_reason='aborted:drain'``
  and finishes the running batch within ``drain_grace_s``;
* **the step watchdog** — ``step_timeout_s > 0`` times every dispatch
  with a process-local :class:`~paddle_tpu_torch.distributed.watchdog.
  StepWatchdog` (a key's first step, which captures its graph, gets
  ``COMPILE_ALLOWANCE`` x the deadline): a step past its deadline fails
  the engine with :class:`StepHungError` and structured outputs.

Tiered KV (``kv_tiers``, the ragged path only): the host pool becomes a
second cache tier (:mod:`~paddle_tpu_torch.serving.kvtier`). Cold
prefixes and parked sessions demote there instead of being evicted, a
request's context may exceed the device pool (admission counts the
blocks reachable across tiers), and ``park_session`` /
``resume_session`` serve multi-turn traffic with zero re-prefill. The
step reads the host tier through its device mirror, ``(L,
num_host_blocks, BS, KH, D)``, allocated once at a fixed address (the
captured graphs hold it) and handed to the ragged attention as a second
pool: a block-table entry ``>= num_blocks`` reads the mirror. The JAX
engine instead concatenates the mirror onto the cache every step and
slices the written cache back; the port's caches are updated in place,
and a per-step concatenation would copy the whole pool each step.

Not ported yet, refused at construction with the item that brings it:
tensor parallelism (C3). The tier's fleet half (the peer tier, the
router's offload) comes with C2.
"""
from __future__ import annotations

import itertools
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core.dtype import to_torch
from paddle_tpu_torch.jit.trace import StepGraphs
from paddle_tpu_torch.ops import kernel_launches
from paddle_tpu_torch.ops.sampling import sample_or_verify
from paddle_tpu_torch.serving.block_manager import BlockManager, cdiv
from paddle_tpu_torch.serving.kvtier import KVTiersConfig, TieredKVStore
from paddle_tpu_torch.serving.metrics import ServingMetrics
from paddle_tpu_torch.serving.request import (
    Request, RequestOutput, SamplingParams,
)
from paddle_tpu_torch.serving.scheduler import Scheduler, SchedulerConfig
from paddle_tpu_torch.testing import faults

__all__ = ["EngineConfig", "LLMEngine", "AdmissionController",
           "EngineStepError", "StepHungError", "token_buckets"]


class EngineStepError(RuntimeError):
    """The serving step failed past the retry budget. The engine has
    already drained: every in-flight request was aborted with a
    structured ``finish_reason='aborted:error'`` output — available on
    ``.outputs`` — and every KV block was reclaimed."""

    def __init__(self, msg: str, outputs: List[RequestOutput]):
        super().__init__(msg)
        self.outputs = outputs


class StepHungError(EngineStepError):
    """The watchdog deadline passed while a dispatched step was still
    incomplete on the device. Raised once the dispatch finally returns
    (a slow-but-alive device); a truly hung device never returns — a
    watchdog built without ``on_timeout`` exits the process for that
    case."""


@dataclass
class EngineConfig:
    """Engine knobs. ``num_blocks=None`` sizes the cache so every one of
    ``max_num_seqs`` concurrent requests can reach ``max_model_len`` (no
    preemption ever needed); smaller values oversubscribe the cache and
    rely on preemption."""

    block_size: int = 16
    num_blocks: Optional[int] = None
    max_num_seqs: int = 8
    tp_degree: int = 1
    max_batched_tokens: int = 2048
    max_model_len: Optional[int] = None   # default: model max positions
    dtype: Optional[str] = None           # KV cache; default: the model's
    # in-place cache updates without retry on a failed step; default:
    # True on the card, False on the CPU
    donate_cache: Optional[bool] = None
    # the smallest step bucket: T runs over min_prefill_bucket * 2**i
    min_prefill_bucket: int = 8
    swap_mode: str = "recompute"
    num_host_blocks: Optional[int] = None
    kv_tiers: Optional[object] = None
    ragged: Optional[bool] = None
    prefix_cache: Optional[bool] = None
    chunked_prefill: Optional[bool] = None
    # admission control: reject (first-class 'rejected' output) when the
    # waiting queue is this deep, or when the estimated TTFT for a new
    # arrival exceeds the SLO (None = unbounded / no SLO)
    max_queue_depth: Optional[int] = None
    ttft_slo_ms: Optional[float] = None
    draft_model: Optional[object] = None
    num_spec_tokens: int = 0
    # drain: running requests get this long to finish after a drain
    # starts; the watchdog's deadline per dispatch (0 = off)
    drain_grace_s: float = 30.0
    step_timeout_s: float = 0.0
    # bounded retry with exponential backoff on step failures, and the
    # on-device NaN/Inf logits guard
    max_step_retries: int = 2
    step_retry_backoff_s: float = 0.05
    nonfinite_guard: bool = True

    def __post_init__(self):
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")
        if self.num_blocks is not None and self.num_blocks < 1:
            raise ValueError("num_blocks must be >= 1")
        if self.min_prefill_bucket < 1:
            raise ValueError("min_prefill_bucket must be >= 1")
        if self.max_model_len is not None and self.max_model_len < 1:
            raise ValueError("max_model_len must be >= 1")
        if self.swap_mode not in ("recompute", "host"):
            raise ValueError(f"unknown swap_mode {self.swap_mode!r} "
                             f"(want 'recompute' or 'host')")
        if self.num_host_blocks is not None and self.num_host_blocks < 0:
            raise ValueError("num_host_blocks must be >= 0")
        if self.max_queue_depth is not None and self.max_queue_depth < 0:
            raise ValueError("max_queue_depth must be >= 0")
        if self.ttft_slo_ms is not None and self.ttft_slo_ms <= 0:
            raise ValueError("ttft_slo_ms must be > 0")
        if self.drain_grace_s < 0:
            raise ValueError("drain_grace_s must be >= 0")
        if self.step_timeout_s < 0:
            raise ValueError("step_timeout_s must be >= 0")
        if self.max_step_retries < 0:
            raise ValueError("max_step_retries must be >= 0")
        if self.num_spec_tokens < 0:
            raise ValueError("num_spec_tokens must be >= 0")
        if (self.draft_model is None) != (self.num_spec_tokens == 0):
            raise ValueError(
                "speculative decoding takes BOTH draft_model and "
                "num_spec_tokens >= 1, or neither")
        # what the port does not serve yet, named with the item that
        # brings it (ROADMAP.md, queue 1)
        later = []
        if self.tp_degree != 1:
            later.append(f"tp_degree={self.tp_degree} (C3: tensor-"
                         f"parallel serving, queue 1 item 5)")
        if later:
            raise ValueError("not ported to paddle_tpu_torch yet: "
                             + "; ".join(later))
        # max_num_seqs / max_batched_tokens validate in SchedulerConfig


class AdmissionController:
    """SLO-aware admission: reject at ``add_request`` time when the
    waiting queue is ``max_queue_depth`` deep, or when the estimated TTFT
    of a new arrival exceeds ``ttft_slo_ms``. Rejection is a verdict
    string, never an exception."""

    def __init__(self, max_queue_depth: Optional[int] = None,
                 ttft_slo_ms: Optional[float] = None):
        self.max_queue_depth = max_queue_depth
        self.ttft_slo_ms = ttft_slo_ms

    def verdict(self, engine: "LLMEngine",
                prompt_tokens: int = 0) -> Optional[str]:
        depth = engine.scheduler.num_waiting
        if self.max_queue_depth is not None \
                and depth >= self.max_queue_depth:
            return (f"queue depth {depth} >= max_queue_depth "
                    f"{self.max_queue_depth}")
        if self.ttft_slo_ms is not None:
            est = engine.metrics.estimated_ttft_ms(
                depth,
                queued_prefill_tokens=engine.scheduler.num_waiting_tokens,
                prompt_tokens=prompt_tokens,
                tokens_per_step=engine.cfg.max_batched_tokens)
            if est is not None and est > self.ttft_slo_ms:
                return (f"estimated TTFT {est:.1f}ms exceeds SLO "
                        f"{self.ttft_slo_ms}ms at queue depth {depth} "
                        f"({prompt_tokens}-token prompt)")
        return None


def token_buckets(cfg: EngineConfig) -> tuple:
    """The step widths of an engine built with ``cfg``: ``min_prefill_
    bucket * 2**i``, capped at the most tokens one step may pack (the
    token budget, clamped to what a full batch could ever schedule)."""
    cap = min(cfg.max_batched_tokens, cfg.max_num_seqs * cfg.max_model_len)
    buckets = [cfg.min_prefill_bucket]
    while buckets[-1] < cap:
        buckets.append(buckets[-1] * 2)
    return tuple(min(b, cap) for b in buckets)


def _to_int32(keys: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the same bits as int32."""
    return torch.where(keys >= 2 ** 31, keys - 2 ** 32, keys).to(torch.int32)


def _weak_method(method) -> Callable:
    """A callable that forwards to ``method`` while its object lives (a
    watchdog thread holding it must not keep an engine alive)."""
    ref = weakref.WeakMethod(method)

    def call(*args):
        m = ref()
        if m is not None:
            return m(*args)

    return call


class _KVSwapper:
    """Block mover for swap-based preemption between the stacked (L, NB,
    BS, KH, D) device caches and the (L, num_host_blocks, BS, KH, D)
    host pool (pinned on the card). It holds the tensors, not the
    engine.

    ``copy_out`` is ASYNC: it gathers the victim's blocks into a fresh
    device buffer on the current stream — the one the step graphs replay
    on, so the gather reads the bytes the last step wrote and precedes
    the next step, which may reuse the freed blocks — then starts a
    non-blocking copy into pinned staging and records an event. The
    staging stays referenced until :meth:`fence` waits on the event and
    lands it in the pool slots (a host-side scatter: an advanced-index
    assignment from device memory would go through a synchronous
    temporary). Insertion order makes a reused host slot's last writer
    win. ``copy_in`` fences, then writes the device caches IN PLACE
    (``index_copy_`` from pinned memory): the captured graphs hold the
    caches' addresses. The tier's demotes and promotes go through the
    same two halves (:meth:`spill`, :meth:`restore`), and :meth:`gather`
    reads blocks of either tier to the host. The fleet's ``scatter``
    comes with C2."""

    def __init__(self, kcs, vcs, host_k, host_v):
        self._kcs, self._vcs = kcs, vcs
        self._host_k, self._host_v = host_k, host_v
        self._on_card = kcs.device.type == "cuda"
        # request_id -> (host slot ids, K staging, V staging, event)
        self._pending: Dict[str, tuple] = {}

    def copy_out(self, request: Request, dev_table: List[int],
                 host_table: List[int]):
        # the device table may hold one more block than was written (a
        # decode-step slot claimed before the eviction); spill only the
        # blocks the host table covers
        self.spill(request.request_id, dev_table[:len(host_table)],
                   host_table)

    def spill(self, key, dev_blocks: List[int], host_slots: List[int]):
        """Queue the copy of device blocks into host slots under ``key``
        (landed by :meth:`fence`)."""
        dev = torch.as_tensor(dev_blocks, dtype=torch.long,
                              device=self._kcs.device)
        staged, done = [], None
        for cache in (self._kcs, self._vcs):
            blocks = cache.index_select(1, dev)   # its own buffer
            if self._on_card:
                # the device buffer may go at once: the caching
                # allocator reuses it only behind this copy, in stream
                # order
                stage = torch.empty(blocks.shape, dtype=blocks.dtype,
                                    pin_memory=True)
                stage.copy_(blocks, non_blocking=True)
                blocks = stage
            staged.append(blocks)
        if self._on_card:
            done = torch.cuda.Event()
            done.record()
        self._pending[key] = (list(host_slots), *staged, done)

    def fence(self):
        """Land every in-flight spill in the host pool (blocking). Runs
        before any host slot is read back."""
        for host, k, v, done in self._pending.values():
            if done is not None:
                done.synchronize()
            idx = torch.as_tensor(host, dtype=torch.long)
            self._host_k.index_copy_(1, idx, k)
            self._host_v.index_copy_(1, idx, v)
        self._pending.clear()

    def copy_in(self, request: Request, host_table: List[int],
                dev_table: List[int]):
        self.restore(host_table, dev_table)

    def restore(self, host_slots: List[int], dev_blocks: List[int]):
        """Write host slots into device blocks, in place (fenced first:
        the spill may still be in flight)."""
        self.fence()
        hidx = torch.as_tensor(host_slots, dtype=torch.long)
        didx = torch.as_tensor(dev_blocks, dtype=torch.long,
                               device=self._kcs.device)
        for cache, pool in ((self._kcs, self._host_k),
                            (self._vcs, self._host_v)):
            if self._on_card:
                src = torch.empty((pool.shape[0], len(host_slots))
                                  + tuple(pool.shape[2:]),
                                  dtype=pool.dtype, pin_memory=True)
                torch.index_select(pool, 1, hidx, out=src)
                src = src.to(cache.device, non_blocking=True)
            else:
                src = pool.index_select(1, hidx)
            cache.index_copy_(1, didx, src)

    def gather(self, table: List[int], num_blocks: int):
        """Host copies ``(K, V)``, each (L, len(table), BS, KH, D), of the
        blocks a tiered table names: a device block through one
        device-to-host copy, a virtual entry (``>= num_blocks``) from the
        host pool, read after :meth:`fence`."""
        self.fence()
        dev_pos = [(i, b) for i, b in enumerate(table) if b < num_blocks]
        host_pos = [(i, b - num_blocks) for i, b in enumerate(table)
                    if b >= num_blocks]
        out = []
        for cache, pool in ((self._kcs, self._host_k),
                            (self._vcs, self._host_v)):
            got = torch.empty((cache.shape[0], len(table))
                              + tuple(cache.shape[2:]), dtype=cache.dtype)
            if dev_pos:
                idx = torch.as_tensor([b for _, b in dev_pos],
                                      dtype=torch.long, device=cache.device)
                got[:, [i for i, _ in dev_pos]] = \
                    cache.index_select(1, idx).cpu()
            if host_pos:
                got[:, [i for i, _ in host_pos]] = pool.index_select(
                    1, torch.as_tensor([s for _, s in host_pos]))
            out.append(got)
        return tuple(out)


class LLMEngine:
    """Drive a :class:`~paddle_tpu_torch.models.llama.LlamaForCausalLM`
    as a continuously-batched token server on the model's device::

        eng = LLMEngine(model, EngineConfig(max_num_seqs=8))
        eng.add_request("r0", prompt_ids, SamplingParams(max_new_tokens=16))
        while eng.has_unfinished():
            for out in eng.step():
                if out.finished:
                    eng.release_request(out.request_id)

    The model decides the device: build it with ``device="cpu"`` to
    serve on the CPU (the plain attention), with no device for the card
    (the kernel)."""

    def __init__(self, model, config: Optional[EngineConfig] = None):
        self.model = model
        self.cfg = config or EngineConfig()
        mcfg = model.config
        self.device = model.device
        if self.cfg.max_model_len is None:
            self.cfg.max_model_len = mcfg.max_position_embeddings
        if self.cfg.max_model_len > mcfg.max_position_embeddings:
            raise ValueError(
                f"max_model_len {self.cfg.max_model_len} exceeds the "
                f"model's rope table "
                f"({mcfg.max_position_embeddings} positions)")
        self.max_blocks_per_seq = cdiv(self.cfg.max_model_len,
                                       self.cfg.block_size)
        if self.cfg.num_blocks is None:
            self.cfg.num_blocks = (self.cfg.max_num_seqs *
                                   self.max_blocks_per_seq)
        if self.cfg.num_host_blocks is None:
            self.cfg.num_host_blocks = (
                self.cfg.num_blocks if self.cfg.swap_mode == "host" else 0)
        # tiered KV: normalize the knob, then force a host pool at least
        # as large as the device pool (the host tier IS the host pool;
        # swap-mode spills share it)
        self._tiers_cfg = KVTiersConfig.from_any(self.cfg.kv_tiers)
        self._tiered = self._tiers_cfg is not None
        if self._tiered:
            want_host = (self._tiers_cfg.num_host_blocks
                         if self._tiers_cfg.num_host_blocks is not None
                         else self.cfg.num_blocks)
            self.cfg.num_host_blocks = max(self.cfg.num_host_blocks,
                                           want_host)

        # -- path resolution (model-dependent, so not in EngineConfig):
        # ragged auto-enables on models exposing forward_ragged; chunked
        # prefill is inseparable from it, prefix caching defaults on
        # with it; the bucketed path takes neither
        if self.cfg.ragged is None:
            self.cfg.ragged = hasattr(model, "forward_ragged")
        elif self.cfg.ragged and not hasattr(model, "forward_ragged"):
            raise ValueError(
                "ragged=True needs a model exposing forward_ragged "
                "(fall back to the bucketed path with ragged=False)")
        if not self.cfg.ragged and not hasattr(model, "forward_paged"):
            raise ValueError("the engine needs a model exposing "
                             "forward_ragged or forward_paged")
        if not self.cfg.ragged and self._tiered:
            raise ValueError(
                "kv_tiers rides the ragged step (host-tier blocks are "
                "attended through its attention's second pool) — it "
                "cannot run with ragged=False")
        if self.cfg.chunked_prefill is None:
            self.cfg.chunked_prefill = self.cfg.ragged
        if self.cfg.prefix_cache is None:
            self.cfg.prefix_cache = self.cfg.ragged
        if self._tiered and not self.cfg.prefix_cache:
            raise ValueError(
                "kv_tiers needs prefix_cache (the trie is what spans "
                "tiers) — do not disable it with tiering on")
        if self.cfg.chunked_prefill != self.cfg.ragged:
            raise ValueError(
                "chunked_prefill rides the ragged step: a lone "
                "over-budget prompt must chunk to fit the token budget, "
                "and the bucketed step cannot run a mid-prefill "
                "continuation — set both or neither")
        if self.cfg.prefix_cache and not self.cfg.ragged:
            raise ValueError(
                "prefix_cache needs the ragged path (the classic "
                "scheduler never passes prompt tokens to allocate)")
        self._ragged = bool(self.cfg.ragged)
        # the ragged step widths; the widest, _ragged_T, is the most
        # tokens one step may pack (the JAX engine's one compiled width)
        self.step_buckets = token_buckets(self.cfg)
        self._ragged_T = self.step_buckets[-1]
        # the step keys stepped (on the card: captured): ("ragged", T, S)
        # on the ragged path, (kind, B, S) on the bucketed one
        self._seen_shapes: set = set()
        donate = self.cfg.donate_cache
        self._donated = (self.device.type != "cpu" if donate is None
                         else bool(donate))

        # -- device caches: (L, NB, BS, KH, D) stacked per layer, in
        # cfg.dtype (default: the model's). Never reallocated: the
        # captured steps hold their addresses.
        cache_dtype = (model.dtype if self.cfg.dtype is None
                       else to_torch(self.cfg.dtype))
        if self.device.type == "cuda" and cache_dtype != model.dtype:
            raise ValueError(
                f"EngineConfig.dtype={self.cfg.dtype!r} with a "
                f"{model.dtype} model: on the card the ragged attention "
                f"kernel takes q and the cache in one dtype")
        kh = mcfg.num_key_value_heads
        hd = mcfg.hidden_size // mcfg.num_attention_heads
        shape = (mcfg.num_hidden_layers, self.cfg.num_blocks,
                 self.cfg.block_size, kh, hd)
        self._kcs = torch.zeros(shape, dtype=cache_dtype, device=self.device)
        self._vcs = torch.zeros(shape, dtype=cache_dtype, device=self.device)
        # host swap pool (L, num_host_blocks, BS, KH, D), allocated once:
        # pinned on the card, so spills and restores are async copies
        if self.cfg.num_host_blocks > 0:
            hshape = (mcfg.num_hidden_layers, self.cfg.num_host_blocks,
                      self.cfg.block_size, kh, hd)
            pin = self.device.type == "cuda"
            self._host_k = torch.zeros(hshape, dtype=cache_dtype,
                                       pin_memory=pin)
            self._host_v = torch.zeros(hshape, dtype=cache_dtype,
                                       pin_memory=pin)
        else:
            self._host_k = self._host_v = None
        # tiered: the host tier's device mirror, the ragged attention's
        # second pool, allocated once (the captured graphs hold it)
        if self._tiered:
            mshape = (mcfg.num_hidden_layers, self.cfg.num_host_blocks,
                      self.cfg.block_size, kh, hd)
            self._htk = torch.zeros(mshape, dtype=cache_dtype,
                                    device=self.device)
            self._htv = torch.zeros(mshape, dtype=cache_dtype,
                                    device=self.device)
        else:
            self._htk = self._htv = None
        self._swapper = _KVSwapper(self._kcs, self._vcs, self._host_k,
                                   self._host_v)
        self._graphs = StepGraphs(self.device, counters=kernel_launches)

        self.block_manager = BlockManager(
            self.cfg.num_blocks, self.cfg.block_size,
            num_host_blocks=self.cfg.num_host_blocks,
            enable_prefix_cache=self.cfg.prefix_cache, tiered=self._tiered)
        self._kvtier = (TieredKVStore(self, self._tiers_cfg)
                        if self._tiered else None)
        self.scheduler = Scheduler(
            self.block_manager,
            SchedulerConfig(max_num_seqs=self.cfg.max_num_seqs,
                            max_batched_tokens=(
                                self._ragged_T if self._ragged
                                else self.cfg.max_batched_tokens),
                            chunked_prefill=self.cfg.chunked_prefill),
            swap_mode=self.cfg.swap_mode, kv_swapper=self._swapper)
        if self._kvtier is not None:
            # demote-before-preempt: every scheduler OOM path tries
            # this before evicting a batch peer
            self.scheduler.tier_relief = self._kvtier.relief
        self.admission = AdmissionController(
            max_queue_depth=self.cfg.max_queue_depth,
            ttft_slo_ms=self.cfg.ttft_slo_ms)

        # -- speculative-decoding resolution ----------------------------
        if self.cfg.draft_model is not None:
            if not self._ragged:
                raise ValueError(
                    "speculative decoding rides the ragged step (verify "
                    "rows are mid-context multi-token rows) — it cannot "
                    "run with ragged=False")
            draft = self.cfg.draft_model
            dcfg = getattr(draft, "config", None)
            dv = getattr(dcfg, "vocab_size", None)
            if dv != mcfg.vocab_size:
                raise ValueError(
                    f"draft/target tokenizer-width mismatch: draft "
                    f"vocab_size {dv} != target vocab_size "
                    f"{mcfg.vocab_size} — the models must share one "
                    f"tokenizer")
            if not hasattr(model, "forward_ragged_multi"):
                raise ValueError(
                    "speculative decoding needs the target model to "
                    "expose forward_ragged_multi (the per-row "
                    "multi-logit gather)")
            if getattr(draft, "device", None) != self.device:
                raise ValueError(
                    f"the draft model is on {getattr(draft, 'device', None)}"
                    f", the target on {self.device}: build both on one "
                    f"device")
            from paddle_tpu_torch.serving.spec import SpecDecoder

            self._spec = SpecDecoder(draft, self.cfg.num_spec_tokens,
                                     pool=self._graphs.pool)
        else:
            self._spec = None
        # R = verify width: logit rows gathered (and token slots packed)
        # per slot in the step — 1 without speculation
        self._spec_R = self.cfg.num_spec_tokens + 1

        self._requests: Dict[str, Request] = {}
        self._auto_id = itertools.count()
        # steps whose batch held >= 1 sampled (temperature > 0) request
        self.num_sampled_steps = 0
        # speculative-decode lifetime counters (serving/spec_* gauges)
        self.num_spec_proposed = 0
        self.num_spec_accepted = 0
        # lifetime counters (survive reset_metrics; serving/* gauges)
        self.num_expired = 0
        self.num_rejected = 0
        self.num_step_retries = 0
        self.num_poisoned_aborts = 0
        self.num_drains_started = 0
        self.num_drain_aborted = 0
        self.num_drains_completed = 0
        # per-terminal-reason histogram (serving/finish/*)
        self.finish_counts: Dict[str, int] = {}
        self._draining = False
        self._drain_reason: Optional[str] = None
        self._drain_deadline: Optional[float] = None
        self._preempt = None            # PreemptionMonitor once installed
        self._pending_outputs: List[RequestOutput] = []
        # hung-step hand-off: the watchdog's monitor thread writes the
        # tags, the dispatching thread swaps them out
        self._hung_lock = threading.Lock()
        self._hung_tags: Optional[str] = None
        if self.cfg.step_timeout_s > 0:
            from paddle_tpu_torch.distributed.watchdog import StepWatchdog

            # process-local; its threads reach the engine through a
            # weak reference only
            self._watchdog = StepWatchdog(
                timeout=self.cfg.step_timeout_s,
                on_timeout=_weak_method(self._on_step_timeout),
                broadcast_abort=False)
        else:
            self._watchdog = None
        self.metrics = ServingMetrics(self)

    # -- request lifecycle ----------------------------------------------
    def add_request(self, request_id, prompt_ids: Sequence[int] = None,
                    sampling: Optional[SamplingParams] = None,
                    callback: Optional[Callable] = None, *,
                    rng_state=None) -> str:
        """Admit a request into the waiting queue. ``request_id`` may be
        omitted by passing the prompt first — ``add_request(prompt_ids)``
        or ``add_request(prompt_ids, SamplingParams(...))``. Returns the
        request id. ``rng_state`` (``{"device_key": [hi, lo]}``) resumes
        the request's sampling stream mid-way, also one that the JAX
        package's engine started: both draw from the same threefry
        keys."""
        if isinstance(prompt_ids, SamplingParams):
            if sampling is not None:
                raise TypeError("sampling passed twice")
            prompt_ids, sampling = None, prompt_ids
        if prompt_ids is None:
            request_id, prompt_ids = None, request_id
        if request_id is None:
            request_id = f"req-{next(self._auto_id)}"
        if request_id in self._requests:
            raise ValueError(f"duplicate request id {request_id!r}")
        sampling = sampling or SamplingParams()
        prompt_ids = [int(t) for t in prompt_ids]
        total = len(prompt_ids) + sampling.max_new_tokens
        if total > self.cfg.max_model_len:
            raise ValueError(
                f"request {request_id!r}: prompt ({len(prompt_ids)}) + "
                f"max_new_tokens ({sampling.max_new_tokens}) = {total} "
                f"exceeds max_model_len {self.cfg.max_model_len}")
        self._check_fits(request_id, total)
        req = Request(request_id=request_id, prompt_ids=prompt_ids,
                      sampling=sampling, callback=callback)
        self._apply_rng_state(req, rng_state)
        self._requests[request_id] = req
        # admission control: a draining (or failed) engine admits
        # nothing; a live one consults the controller. Rejection is a
        # structured output.
        verdict = ("engine is draining" if self._draining
                   else self.admission.verdict(
                       self, prompt_tokens=len(prompt_ids)))
        if verdict is not None:
            req.abort("rejected")
            self.num_rejected += 1
            self._pending_outputs.append(self._terminal_output(req))
            return request_id
        self.scheduler.add(req)
        return request_id

    def _check_fits(self, request_id: str, total: int):
        """Refuse a request whose full length needs more blocks than are
        reachable (the device pool, plus the host tier when tiered)."""
        reach = self.block_manager.reachable_blocks
        if cdiv(total, self.cfg.block_size) > reach:
            raise ValueError(
                f"request {request_id!r} needs "
                f"{cdiv(total, self.cfg.block_size)} KV blocks at full "
                f"length but only {reach} are reachable across tiers — it "
                f"could never be served even alone")

    @staticmethod
    def _apply_rng_state(req: Request, rng_state) -> None:
        """Resume a request's sampling stream from a hand-off state
        ``{"device_key": [hi, lo]}`` (the composite form's ``"numpy"``
        half, which the JAX engine's host sampler draws from, has no
        reader here: the port samples on the device only)."""
        if rng_state is not None and rng_state.get("device_key") is not None:
            req.device_key = np.asarray(rng_state["device_key"], np.uint32)

    def abort_request(self, request_id: str) -> bool:
        found = self.scheduler.abort(request_id, "aborted:user")
        if found:
            self._count_finish("aborted:user")
        return found

    def _count_finish(self, reason: Optional[str]):
        if reason is not None:
            self.finish_counts[reason] = \
                self.finish_counts.get(reason, 0) + 1

    # -- graceful drain --------------------------------------------------
    def install_preemption_handler(self, monitor=None):
        """Wire SIGTERM into the step loop: once the (process-wide by
        default) :class:`~paddle_tpu_torch.distributed.watchdog.
        PreemptionMonitor` reports a notice, the next :meth:`step`
        starts a drain. Pass a monitor to share one across engines (or
        to inject a test one); must run on the main thread (the signal
        module's rule). The caller uninstalls it (``monitor.uninstall()``)
        when done."""
        if monitor is None:
            from paddle_tpu_torch.distributed.watchdog import (
                preemption_monitor)

            monitor = preemption_monitor()
        monitor.install()
        self._preempt = monitor
        return monitor

    @property
    def is_draining(self) -> bool:
        return self._draining

    @property
    def drained(self) -> bool:
        """True once a drain ran to completion: nothing unfinished,
        every request either completed or holds a structured abort."""
        return self._draining and not self.scheduler.has_unfinished()

    def start_drain(self, reason: str = "manual",
                    grace_s: Optional[float] = None
                    ) -> List[RequestOutput]:
        """Begin a graceful drain: admission closes, every WAITING and
        SWAPPED request aborts NOW with ``finish_reason='aborted:drain'``
        (their structured outputs are returned), and the running batch
        keeps stepping until done or until ``grace_s`` (default
        ``drain_grace_s``) elapses — stragglers then abort the same
        way. Idempotent."""
        if self._draining:
            return []
        self._draining = True
        self._drain_reason = reason
        grace = self.cfg.drain_grace_s if grace_s is None else grace_s
        self._drain_deadline = time.monotonic() + grace
        self.num_drains_started += 1
        outs = []
        pending = list(self.scheduler.waiting) + list(self.scheduler.swapped)
        for r in pending:
            self.scheduler.abort(r.request_id, "aborted:drain")
            self.num_drain_aborted += 1
            outs.append(self._terminal_output(r))
        return outs

    def drain(self, grace_s: Optional[float] = None,
              reason: str = "manual") -> List[RequestOutput]:
        """``start_drain`` + step to completion. Returns every output
        emitted during the drain (completions and aborts)."""
        outs = self.start_drain(reason=reason, grace_s=grace_s)
        while self.scheduler.has_unfinished():
            outs.extend(self.step())
        outs.extend(self._flush_pending())
        return outs

    def _abort_running(self, reason: str) -> List[RequestOutput]:
        """Terminal sweep of every live request (running, waiting AND
        swapped) — the grace-budget-expired / step-failed path. All
        blocks and host slots are reclaimed; each request gets a
        structured output. (The reference also parks a drained request's
        blocks for the fleet's KV hand-off, which comes with C2.)"""
        outs = []
        live = (list(self.scheduler.running) + list(self.scheduler.waiting)
                + list(self.scheduler.swapped))
        for r in live:
            self.scheduler.abort(r.request_id, reason)
            if reason == "aborted:drain":
                self.num_drain_aborted += 1
            outs.append(self._terminal_output(r))
        return outs

    def _finish_drain(self):
        if self._drain_deadline is not None:
            self._drain_deadline = None
            self.num_drains_completed += 1

    def _fail_closed(self):
        """Latch the engine shut after a fatal step failure: admission
        closes (new requests get 'rejected' outputs, not a crash on the
        next dispatch — a failed replay may have written part of the
        caches), and no further drain bookkeeping runs."""
        self._draining = True
        self._drain_reason = "step-failure"
        self._drain_deadline = None

    def _on_step_timeout(self, expired):
        """Watchdog thread callback: note the hang; the dispatching
        thread surfaces it as StepHungError when (if) the step
        completes."""
        with self._hung_lock:
            self._hung_tags = ", ".join(ent[0] for ent in expired)

    def _terminal_output(self, req: Request) -> RequestOutput:
        """Structured tokenless emission for an aborted/expired/rejected
        request; streams through its callback like a sampled token."""
        self._count_finish(req.finish_reason)
        out = RequestOutput(request_id=req.request_id, token=None,
                            finished=True, generated=list(req.generated),
                            finish_reason=req.finish_reason)
        if req.callback is not None:
            req.callback(req.request_id, None, True)
        return out

    def _flush_pending(self) -> List[RequestOutput]:
        out, self._pending_outputs = self._pending_outputs, []
        return out

    def release_request(self, request_id: str) -> Optional[Request]:
        """Drop a FINISHED request's bookkeeping. Returns the released
        request, or None if unknown; refuses to release an unfinished
        request (use :meth:`abort_request`)."""
        req = self._requests.get(request_id)
        if req is None:
            return None
        if not req.is_finished:
            raise ValueError(
                f"request {request_id!r} is {req.status.value}, not "
                f"finished — abort_request() cancels in-flight requests")
        return self._requests.pop(request_id)

    def reset_metrics(self) -> ServingMetrics:
        """Fresh metrics window (e.g. after a warm-up pass)."""
        self.metrics = ServingMetrics(self)
        return self.metrics

    def get_request(self, request_id: str) -> Request:
        return self._requests[request_id]

    def has_unfinished(self) -> bool:
        return self.scheduler.has_unfinished()

    # -- tiered sessions (park / resume) ----------------------------------
    def _require_tiers(self) -> TieredKVStore:
        if self._kvtier is None:
            raise ValueError(
                "kv_tiers is off — build the engine with "
                "EngineConfig(kv_tiers=True) for session park/resume")
        return self._kvtier

    def park_session(self, session_id: str) -> Optional[dict]:
        """Demote a finished request's captured session chain to the
        host tier (multi-turn park: the KV leaves HBM but stays
        trie-discoverable for the next turn). Returns the session
        summary, or None for an unknown/expired session. Idempotent."""
        return self._require_tiers().park(session_id)

    def resume_session(self, request_id: str, session_id: str,
                       prompt_ids: Sequence[int],
                       sampling: Optional[SamplingParams] = None,
                       callback: Optional[Callable] = None, *,
                       rng_state=None) -> int:
        """Admit a new request continuing a parked session: the new
        prompt must extend the session's token chain, whose cached KV
        (either tier) is re-shared — zero prompt recompute on a full
        hit. Returns the token count actually reused; 0 means the chain
        was evicted since parking and the request admitted cold (the
        ladder's recompute floor — never loss, never duplication).
        Clean rejections raise ``ValueError`` (unknown session,
        non-extending prompt, draining, duplicate id); the session
        record is only consumed on success."""
        kvt = self._require_tiers()
        if self._draining:
            raise ValueError("engine is draining")
        if request_id in self._requests:
            raise ValueError(f"duplicate request id {request_id!r}")
        sampling = sampling or SamplingParams()
        prompt_ids = [int(t) for t in prompt_ids]
        total = len(prompt_ids) + sampling.max_new_tokens
        if total > self.cfg.max_model_len:
            raise ValueError(
                f"request {request_id!r}: prompt ({len(prompt_ids)}) + "
                f"max_new_tokens ({sampling.max_new_tokens}) = {total} "
                f"exceeds max_model_len {self.cfg.max_model_len}")
        self._check_fits(request_id, total)
        _, hit = kvt.claim_resume(session_id, request_id, prompt_ids)
        req = Request(request_id=request_id, prompt_ids=prompt_ids,
                      sampling=sampling, callback=callback)
        self._apply_rng_state(req, rng_state)
        self._requests[request_id] = req
        if hit > 0:
            req.num_cached = hit
            self.scheduler.add_continuation(req)
        else:
            self.scheduler.add(req)
        return hit

    def drop_session(self, session_id: str, *,
                     to_peer: bool = False) -> bool:
        """Forget a captured session; ``to_peer=True`` additionally
        evicts its local chain (an offload hand-off; the peer tier comes
        with C2). True when the session existed."""
        if self._kvtier is None:
            return False
        return self._kvtier.drop(session_id, to_peer=to_peer)

    def adopt_session(self, session_id: str, tokens: Sequence[int],
                      covered: int, *,
                      tenant: Optional[str] = None) -> bool:
        """Register a session whose chain this engine's trie already
        holds (the fleet's offload lands it, C2) as resumable. False
        when the chain does not match the local trie — the adopter stays
        cold, harmlessly."""
        if self._kvtier is None:
            return False
        return self._kvtier.adopt(session_id, tokens, covered,
                                  tenant=tenant)

    def session_info(self, session_id: str) -> Optional[dict]:
        if self._kvtier is None:
            return None
        rec = self._kvtier.sessions.get(session_id)
        return None if rec is None else rec.summary()

    def tier_stats(self) -> Optional[dict]:
        """Host-tier occupancy/pressure + migration counters; None when
        tiering is off."""
        if self._kvtier is None:
            return None
        return self._kvtier.stats()

    # -- one engine iteration -------------------------------------------
    def step(self) -> List[RequestOutput]:
        """Schedule + run ONE iteration — on the ragged path decode and
        verify rows, prefill chunks and new admissions packed together;
        on the bucketed path a prefill or a decode batch — sample the
        tokens of every row that finished its prompt, retire finished
        requests. Returns this step's per-request outputs — sampled
        tokens plus any structured terminal emissions (expired,
        rejected, drain-aborted, poisoned)."""
        outputs: List[RequestOutput] = self._flush_pending()

        # preemption notice (SIGTERM / programmatic) -> drain
        if self._preempt is not None and not self._draining \
                and self._preempt.requested():
            outputs.extend(self.start_drain("preemption"))
        if self._draining:
            if not self.scheduler.has_unfinished():
                self._finish_drain()
                return outputs
            if time.monotonic() > self._drain_deadline:
                # grace budget spent: the stragglers abort, structured
                outputs.extend(self._abort_running("aborted:drain"))
                self._finish_drain()
                return outputs

        if self._spec is not None:
            self._propose_drafts()
        if self._kvtier is not None:
            # pressure-driven rebalancing BEFORE scheduling, so the
            # scheduler sees the post-demotion free list
            self._kvtier.balance()
        t0 = time.perf_counter()
        batch = self.scheduler.schedule()
        outputs.extend(self._terminal_output(r) for r in batch.expired)
        self.num_expired += len(batch.expired)
        if batch.is_empty:
            if self.scheduler.has_unfinished() and not (
                    batch.preempted or batch.swapped_in
                    or self.scheduler.num_swapped):
                raise RuntimeError(
                    "scheduler produced an empty batch with unfinished "
                    "requests — KV cache too small for any waiting "
                    "request (admission validation should prevent this)")
            return outputs
        reqs = batch.requests
        n_run = (list(batch.num_scheduled) if batch.num_scheduled
                 else [len(r.tokens_to_run()) for r in reqs])
        T = int(sum(n_run))
        if self._ragged:
            key = ("ragged", self._bucket(T), self.cfg.max_num_seqs)
            arrays = self._pack(reqs, n_run, key[1])
        else:
            key, arrays = self._pack_paged(batch.kind, reqs, n_run)

        # pending tier moves land FIRST (a COW source may be a block a
        # promote just filled), then copy-on-write block copies — both
        # before the step writes the destination blocks
        if self._kvtier is not None:
            self._kvtier.apply_moves()
        self._apply_cow()
        if any(r.sampling.temperature > 0.0 for r in reqs):
            self.num_sampled_steps += 1
        R = self._spec_R
        try:
            out_np = self._dispatch(reqs, key, arrays)
        except EngineStepError as e:
            # this step's already-produced structured outputs must not
            # vanish with the failure — they ride the exception ahead of
            # the abort sweep
            e.outputs = outputs + e.outputs
            raise

        # non-finite-logits guard: abort ONLY the poisoned row(s); the
        # rest of the batch continues untouched
        poisoned = self._poisoned_rows(reqs, out_np[:, R + 3])
        if self._ragged:
            # a verify row costs 1 + its draft count but is one decode
            # row
            prompt_toks = sum(
                min(n, max(len(r.prompt_ids) - r.num_cached, 0))
                for r, n in zip(reqs, n_run))
            decode_rows = sum(
                1 for r, n in zip(reqs, n_run)
                if n - len(r.draft_tokens) == 1 and r.num_generated > 0)
            # padded_tokens counts attention-path padding; the bucket's
            # pad rows never reach attention, as in the JAX engine's
            # ragged step
            self.metrics.record_step(
                batch.kind, len(reqs), T, self.cfg.max_num_seqs,
                time.perf_counter() - t0, padded_tokens=0,
                prompt_tokens=prompt_toks, decode_rows=decode_rows)
        else:
            # the (B, S) pack's padding reaches attention
            self.metrics.record_step(
                batch.kind, len(reqs), T, self.cfg.max_num_seqs,
                time.perf_counter() - t0,
                padded_tokens=key[1] * key[2] - T)
        # unpack the step's single host fetch: per row [tokens(R),
        # n_emit, key_hi, key_lo, finite]
        tokens_mat = out_np[:, :R]
        n_emit_np = out_np[:, R]
        keys_np = np.ascontiguousarray(out_np[:, R + 1:R + 3]).view(
            np.uint32)
        for i, r in enumerate(reqs):
            if i in poisoned:
                self.scheduler.abort(r.request_id, "aborted:nonfinite")
                self.num_poisoned_aborts += 1
                outputs.append(self._terminal_output(r))
                continue
            d = len(r.draft_tokens)
            r.draft_tokens = []
            # committed cache coverage: drafts are NOT tokens until
            # accepted below
            r.num_cached += n_run[i] - d
            if self.cfg.prefix_cache:
                # register fully-written prompt blocks AFTER the step
                # that wrote them (never discoverable before their K/V
                # bytes exist on device)
                self.block_manager.commit_prefix(
                    r.request_id, r.prompt_ids, r.num_cached)
            if r.num_cached < len(r.tokens):
                continue  # mid-prefill chunk: its row logit is a prompt
                # position — never sampled, no output this step
            pre_len = len(r.tokens)
            emit = [int(t) for t in tokens_mat[i, :int(n_emit_np[i])]]
            accepted = max(int(n_emit_np[i]) - 1, 0)
            if d:
                self.num_spec_proposed += d
                self.num_spec_accepted += accepted
            finished = False
            appended = 0
            for token in emit:
                finished = r.append_token(token)
                self.metrics.record_token()
                appended += 1
                out = RequestOutput(request_id=r.request_id, token=token,
                                    finished=finished,
                                    generated=list(r.generated),
                                    finish_reason=r.finish_reason)
                outputs.append(out)
                if r.callback is not None:
                    r.callback(r.request_id, token, finished)
                if finished:
                    break  # EOS inside an accepted draft prefix: the
                    # tokens behind it are never emitted
            # the accepted prefix's K/V (written this step at draft
            # positions) is valid and stays committed; the corrected/
            # bonus token recomputes next step
            r.num_cached = pre_len + min(appended, accepted)
            # the sampler advanced this row's key by a fixed split
            # count; persist it only for emitting rows, so a request's
            # key position is a pure function of its emitted-step count
            r.device_key = keys_np[i].copy()
            if finished:
                if self._kvtier is not None:
                    # session capture BEFORE the table frees: the full
                    # chain commits to the trie and the partial tail's
                    # bytes stash host-side, so a multi-turn follow-up
                    # resumes with zero prompt recompute
                    self._kvtier.on_finish(r)
                self.scheduler.finish(r)
                self.metrics.record_finish(r)
                self._count_finish(r.finish_reason)
            elif d:
                # speculative rollback: free the slots claimed for
                # rejected (or post-EOS) draft tokens
                self.block_manager.trim(r.request_id, len(r.tokens))
        if self._draining and not self.scheduler.has_unfinished():
            self._finish_drain()  # this step emptied the engine
        return outputs

    def _bucket(self, n: int) -> int:
        """The smallest ragged step bucket that holds ``n`` tokens."""
        return next(b for b in self.step_buckets if b >= n)

    # -- bucketed padding -----------------------------------------------
    def _batch_bucket(self, n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return min(b, self.cfg.max_num_seqs)

    def _seq_bucket(self, n: int) -> int:
        s = self.cfg.min_prefill_bucket
        while s < n:
            s *= 2
        cap = cdiv(self.cfg.max_model_len, 8) * 8
        return min(s, cap)

    def _sampling_arrays(self, reqs, rows: int) -> tuple:
        """Each slot's sampling state for the on-device sampler: keys,
        knobs, and the draft rows under verification (``rows`` slots)."""
        R = self._spec_R
        skeys = np.zeros((rows, 2), np.int64)
        stemp = np.zeros((rows,), np.float32)
        stopk = np.zeros((rows,), np.int32)
        stopp = np.ones((rows,), np.float32)
        sdraft = np.zeros((rows, R - 1), np.int32)
        sndraft = np.zeros((rows,), np.int32)
        for i, r in enumerate(reqs):
            skeys[i] = r.device_key
            stemp[i] = r.sampling.temperature
            stopk[i] = r.sampling.top_k
            stopp[i] = r.sampling.top_p
            d = len(r.draft_tokens)
            if d:
                sdraft[i, :d] = r.draft_tokens
                sndraft[i] = d
        return skeys, stemp, stopk, stopp, sdraft, sndraft

    def _pack_paged(self, kind: str, reqs, n_run) -> tuple:
        """The bucketed step's key ``(kind, B, S)`` and host arrays: a
        prefill batch pads every row to the seq bucket of its longest,
        a decode batch takes one token per row; rows pad to the batch
        bucket. Per row: ids (B, S), the block table, the length
        tensors (encoder: prefill length; decoder: cached prefix; this
        time: real tokens), then the sampling state."""
        is_prefill = kind == "prefill"
        S = self._seq_bucket(max(n_run)) if is_prefill else 1
        B = self._batch_bucket(len(reqs))
        ids = np.zeros((B, S), np.int32)
        enc = np.zeros((B,), np.int32)
        dec = np.zeros((B,), np.int32)
        now = np.zeros((B,), np.int32)
        bt = np.full((B, self.max_blocks_per_seq), -1, np.int32)
        for i, r in enumerate(reqs):
            run = r.tokens_to_run()
            ids[i, :len(run)] = run
            now[i] = len(run)
            if is_prefill:
                enc[i] = len(run)
            dec[i] = r.num_cached
            table = self.block_manager.block_table(r.request_id)
            bt[i, :len(table)] = table
        return (kind, B, S), (ids, bt, enc, dec, now,
                              *self._sampling_arrays(reqs, B))

    def _pack(self, reqs, n_run, T: int) -> tuple:
        """The step's host arrays at width ``T`` (at least
        ``sum(n_run)``): the packed token stream (T,) over S sequence
        slots — prefill chunks and decode rows differ only in their
        cu_seqlens deltas; rows past ``cu[len(reqs)]`` are pad rows of id
        0 — then each slot's sampling state for the on-device sampler:
        keys, knobs, and the draft rows under verification."""
        S = self.cfg.max_num_seqs
        ids = np.zeros((T,), np.int32)
        cu = np.zeros((S + 1,), np.int32)
        ctx = np.zeros((S,), np.int32)
        bt = np.full((S, self.max_blocks_per_seq), -1, np.int32)
        off = 0
        for i, r in enumerate(reqs):
            n = n_run[i]
            # a verify row's stream is its newest committed token
            # followed by the draft proposals (scheduled as one 1+d
            # mid-context row)
            src = (r.tokens + r.draft_tokens if r.draft_tokens
                   else r.tokens)
            ids[off:off + n] = src[r.num_cached:r.num_cached + n]
            off += n
            cu[i + 1] = off
            ctx[i] = r.num_cached + n
            table = self.block_manager.block_table(r.request_id)
            bt[i, :len(table)] = table
        cu[len(reqs) + 1:] = off
        return (ids, bt, cu, ctx, np.asarray([len(reqs)], np.int32),
                *self._sampling_arrays(reqs, S))

    def _propose_drafts(self):
        """One draft-model pass proposing ``num_spec_tokens`` greedy
        continuations for every decode-eligible running request (fully
        caught-up, past its first sampled token, with headroom under
        both max_new_tokens and max_model_len). Proposals park on
        ``Request.draft_tokens`` for the scheduler to claim as one
        1+d verify row; a preemption drops them."""
        k = self.cfg.num_spec_tokens
        cand = []
        for r in self.scheduler.running:
            if r.draft_tokens or r.num_generated < 1:
                continue  # pending verify, or still prefilling
            if len(r.tokens) - r.num_cached != 1:
                continue
            d = min(k, r.sampling.max_new_tokens - r.num_generated - 1,
                    self.cfg.max_model_len - len(r.tokens) - 1)
            if d > 0:
                cand.append((r, d))
        if not cand:
            return
        rows = self._spec.propose([r.tokens for r, _ in cand])
        for (r, d), row in zip(cand, rows):
            r.draft_tokens = [int(t) for t in row[:d]]

    @property
    def spec_acceptance_rate(self) -> float:
        """Fraction of proposed draft tokens the target accepted (0.0
        before any proposal)."""
        if self.num_spec_proposed == 0:
            return 0.0
        return self.num_spec_accepted / self.num_spec_proposed

    def _apply_cow(self):
        """Apply pending copy-on-write block copies (prefix-cache
        divergence) as one batched gather/scatter on the device, ahead
        of the step that writes into the fresh destination blocks."""
        pairs = self.block_manager.take_cow_pairs()
        if not pairs:
            return
        src = torch.as_tensor([p[0] for p in pairs], device=self.device)
        dst = torch.as_tensor([p[1] for p in pairs], device=self.device)
        self._kcs[:, dst] = self._kcs[:, src]
        self._vcs[:, dst] = self._vcs[:, src]

    def _device_step(self, *arrays):
        """The model forward + on-device sampling (rejection-sampling
        verify where draft rows ride along), on the tensors of
        :meth:`_pack`'s arrays (ragged: ids, bt, cu, ctx, nseq) or
        :meth:`_pack_paged`'s (bucketed: ids, bt, enc, dec, now), each
        followed by the six sampling arrays; a tiered engine's ragged
        step also reads the host tier's device mirror (its second pool).
        Returns the packed (S, R+4)
        int32 tensor and the (S, R, V) logit rows the sampler read, on
        the device. This is the function each key's graph captures: no
        host synchronisation, inputs read only, the caches written in
        place."""
        ids, bt, a, b, c = arrays[:5]
        skeys, stemp, stopk, stopp, sdraft, sndraft = arrays[5:]
        if not self._ragged:
            logits, _, _ = self.model.forward_paged(
                ids, self._kcs, self._vcs, bt, a, b, c)
            lg3 = logits[:, None, :]
        elif self._spec_R > 1:
            lg3, _, _ = self.model.forward_ragged_multi(
                ids, self._kcs, self._vcs, bt, a, b, c, self._spec_R,
                self._htk, self._htv)
        else:
            logits, _, _ = self.model.forward_ragged(
                ids, self._kcs, self._vcs, bt, a, b, c, self._htk,
                self._htv)
            lg3 = logits[:, None, :]
        finite = torch.isfinite(lg3).all(dim=-1).all(dim=-1)
        toks, n_emit, nkeys = sample_or_verify(
            lg3, sdraft, sndraft, skeys, stemp, stopk, stopp)
        packed = torch.cat([
            toks, n_emit[:, None], _to_int32(nkeys),
            finite.to(torch.int32)[:, None]], dim=1)
        return packed, lg3

    def _step_done(self):
        """What the watchdog waits on: a CUDA event recorded after the
        step on its stream; None on the CPU, where the step is done when
        its call returns."""
        if self.device.type != "cuda":
            return None
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return done

    def _dispatch(self, reqs, key, arrays) -> np.ndarray:
        """Run the step of ``key`` on ``arrays`` under the fault-isolation
        envelope — the watchdog armed before the dispatch (a key's first
        step, which captures its graph on the card, gets
        ``COMPILE_ALLOWANCE`` x the deadline), bounded retry-with-backoff
        on failures — and fetch its one packed host view: ``(len(reqs),
        R+4)`` int32 rows of ``[tokens(R), n_emit, key_hi, key_lo,
        finite]``.

        The KV writes of a step are idempotent (the same rows land in
        the same slots), so a retry after a partial step is exact. A
        failure with donated caches, or past the retry budget, aborts
        EVERY live request with ``finish_reason='aborted:error'``
        structured outputs, closes the engine to admission, and raises
        :class:`EngineStepError` carrying them; a step that outlived the
        watchdog's deadline does the same with :class:`StepHungError`
        once it returns."""
        wd = self._watchdog
        if self._ragged:
            tag = f"serving.ragged[T={key[1]},S={key[2]}]"
        else:
            tag = f"serving.{key[0]}[B={key[1]},S={key[2]}]"
        cold = key not in self._seen_shapes
        attempt = 0
        while True:
            eid = 0
            try:
                # arm BEFORE anything that can block: a hang may happen
                # inside the dispatch call itself
                if wd is not None:
                    from paddle_tpu_torch.distributed.watchdog import (
                        COMPILE_ALLOWANCE)

                    eid = wd.arm(tag, factor=COMPILE_ALLOWANCE if cold
                                 else 1.0)
                faults.fire(faults.SERVING_STEP)  # slow/raise/sigterm point
                with torch.no_grad():
                    packed, _ = self._graphs.run(key, self._device_step,
                                                 arrays)
                if wd is not None:
                    wd.attach(eid, self._step_done())
                # the step's whole host boundary: one int32 row per slot
                out = self._graphs.fetch(packed[:len(reqs)])
            except Exception as e:
                if wd is not None:
                    wd.disarm(eid)
                if self._donated or attempt >= self.cfg.max_step_retries:
                    why = ("donated caches make a failed step "
                           "non-retryable" if self._donated else
                           f"retry budget ({self.cfg.max_step_retries}) "
                           f"exhausted")
                    outs = self._abort_running("aborted:error")
                    self._fail_closed()
                    raise EngineStepError(
                        f"serving step {tag} failed ({why}): {e!r} — "
                        f"engine drained, {len(outs)} request(s) aborted "
                        f"with structured outputs", outs) from e
                attempt += 1
                self.num_step_retries += 1
                time.sleep(self.cfg.step_retry_backoff_s
                           * (2 ** (attempt - 1)))
                continue
            break
        self._seen_shapes.add(key)
        with self._hung_lock:
            tags, self._hung_tags = self._hung_tags, None
        if tags is not None:
            # the deadline fired while this (eventually completed) step
            # was in flight: the device is unhealthy-slow; fail the
            # engine with drain semantics rather than serve SLO-less
            outs = self._abort_running("aborted:error")
            self._fail_closed()
            raise StepHungError(
                f"serving step(s) [{tags}] exceeded the "
                f"{self.cfg.step_timeout_s}s watchdog deadline — engine "
                f"drained, {len(outs)} request(s) aborted with "
                f"structured outputs", outs)
        return out

    def _poisoned_rows(self, reqs, finite_np) -> set:
        """Row indices whose logits are non-finite (or deterministically
        poisoned via the ``serving.nan_logits`` flag fault, whose arg
        picks the row by index or request id)."""
        if not self.cfg.nonfinite_guard:
            return set()
        poisoned = {i for i in range(len(reqs)) if not finite_np[i]}
        for arg in faults.check(faults.SERVING_NAN_LOGITS):
            for i, r in enumerate(reqs):
                if arg in (None, "", str(i), r.request_id):
                    poisoned.add(i)  # as-if this row's logits went NaN
        return poisoned

    # -- run-to-completion convenience ----------------------------------
    def run(self, max_steps: Optional[int] = None) -> List[RequestOutput]:
        outs: List[RequestOutput] = []
        steps = 0
        while self.has_unfinished():
            outs.extend(self.step())
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return outs

    def generate(self, prompts: Sequence[Sequence[int]],
                 sampling: Optional[SamplingParams] = None
                 ) -> List[List[int]]:
        """Batch convenience: admit every prompt, serve to completion,
        return the GENERATED token lists in input order. Finished
        requests are released."""
        rids = [self.add_request(list(p), sampling=sampling)
                for p in prompts]
        self.run()
        return [self.release_request(rid).generated for rid in rids]
