"""LLMEngine — continuous-batching inference over a paged KV cache (port
of ``paddle_tpu/serving/engine.py``, the ragged path).

* the KV cache is ONE stacked device tensor per K and V —
  ``(layers, num_blocks, block_size, kv_heads, head_dim)`` — allocated on
  the model's device in the model's dtype, indexed by per-request block
  tables from :class:`BlockManager`, and updated IN PLACE by each step;
* every iteration is ONE ragged step: the scheduled rows of prefill
  chunks and decode rows are packed into a (T,) token stream over S
  sequence slots and run through ``model.forward_ragged``, whose
  attention is the hand-written ragged paged attention kernel on the
  card. T is a bucket of a fixed lattice, ``min_prefill_bucket * 2**i``
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

Not ported yet, refused at construction with the slice that brings
them: the bucketed path (``ragged=False``), tensor parallelism, tiered
KV, host swap (``num_host_blocks``), drain (``drain_grace_s``) and the
step watchdog.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core.dtype import to_torch
from paddle_tpu_torch.jit.trace import StepGraphs
from paddle_tpu_torch.ops import kernel_launches
from paddle_tpu_torch.ops.sampling import sample_or_verify
from paddle_tpu_torch.serving.block_manager import BlockManager, cdiv
from paddle_tpu_torch.serving.metrics import ServingMetrics
from paddle_tpu_torch.serving.request import (
    Request, RequestOutput, SamplingParams,
)
from paddle_tpu_torch.serving.scheduler import Scheduler, SchedulerConfig
from paddle_tpu_torch.testing import faults

__all__ = ["EngineConfig", "LLMEngine", "AdmissionController",
           "EngineStepError", "token_buckets"]


class EngineStepError(RuntimeError):
    """The serving step failed past the retry budget. The engine has
    already drained: every in-flight request was aborted with a
    structured ``finish_reason='aborted:error'`` output — available on
    ``.outputs`` — and every KV block was reclaimed."""

    def __init__(self, msg: str, outputs: List[RequestOutput]):
        super().__init__(msg)
        self.outputs = outputs


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
        # what the port does not serve yet, named with the slice that
        # brings it (ROADMAP.md, queue 1)
        later = []
        if self.ragged is False:
            later.append("ragged=False (the bucketed forward_paged path)")
        if self.tp_degree != 1:
            later.append(f"tp_degree={self.tp_degree} (slice C: tensor "
                         f"parallelism)")
        if self.kv_tiers is not None:
            later.append("kv_tiers (the swap-and-tiers slice)")
        if self.swap_mode != "recompute":
            later.append(f"swap_mode={self.swap_mode!r} (the "
                         f"swap-and-tiers slice)")
        if self.num_host_blocks is not None:
            later.append("num_host_blocks (the host swap pool, queue 1 "
                         "item 2)")
        if self.drain_grace_s != 30.0:
            later.append("drain_grace_s (drain, queue 1 item 2)")
        if self.step_timeout_s != 0:
            later.append("step_timeout_s > 0 (the step watchdog, with "
                         "the fleet slice)")
        if later:
            raise ValueError("not ported to paddle_tpu_torch yet: "
                             + "; ".join(later))
        if self.chunked_prefill is False:
            raise ValueError(
                "chunked_prefill rides the ragged step: a lone "
                "over-budget prompt must chunk to fit the token budget")
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
        if not hasattr(model, "forward_ragged"):
            raise ValueError("the engine needs a model exposing "
                             "forward_ragged")
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
        self.cfg.ragged = True
        self.cfg.chunked_prefill = True
        if self.cfg.prefix_cache is None:
            self.cfg.prefix_cache = True
        # the step widths; the widest, _ragged_T, is the most tokens one
        # step may pack (the JAX engine's one compiled width)
        self.step_buckets = token_buckets(self.cfg)
        self._ragged_T = self.step_buckets[-1]
        # ("ragged", T, S) keys stepped (on the card: captured)
        self._seen_shapes: set = set()
        donate = self.cfg.donate_cache
        self._donated = (self.device.type != "cpu" if donate is None
                         else bool(donate))

        self.block_manager = BlockManager(
            self.cfg.num_blocks, self.cfg.block_size,
            enable_prefix_cache=self.cfg.prefix_cache)
        self.scheduler = Scheduler(
            self.block_manager,
            SchedulerConfig(max_num_seqs=self.cfg.max_num_seqs,
                            max_batched_tokens=self._ragged_T))
        self.admission = AdmissionController(
            max_queue_depth=self.cfg.max_queue_depth,
            ttft_slo_ms=self.cfg.ttft_slo_ms)

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
        self._graphs = StepGraphs(self.device, counters=kernel_launches)

        # -- speculative-decoding resolution ----------------------------
        if self.cfg.draft_model is not None:
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
        # per-terminal-reason histogram (serving/finish/*)
        self.finish_counts: Dict[str, int] = {}
        self._closed = False            # latched by a fatal step failure
        self._pending_outputs: List[RequestOutput] = []
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
        if cdiv(total, self.cfg.block_size) > self.cfg.num_blocks:
            raise ValueError(
                f"request {request_id!r} needs "
                f"{cdiv(total, self.cfg.block_size)} KV blocks at full "
                f"length but the cache holds {self.cfg.num_blocks} — it "
                f"could never be served even alone")
        req = Request(request_id=request_id, prompt_ids=prompt_ids,
                      sampling=sampling, callback=callback)
        if rng_state is not None and rng_state.get("device_key") is not None:
            req.device_key = np.asarray(rng_state["device_key"], np.uint32)
        self._requests[request_id] = req
        # admission control: a closed engine admits nothing; a live one
        # consults the controller. Rejection is a structured output.
        verdict = ("engine is closed after a step failure" if self._closed
                   else self.admission.verdict(
                       self, prompt_tokens=len(prompt_ids)))
        if verdict is not None:
            req.abort("rejected")
            self.num_rejected += 1
            self._pending_outputs.append(self._terminal_output(req))
            return request_id
        self.scheduler.add(req)
        return request_id

    def abort_request(self, request_id: str) -> bool:
        found = self.scheduler.abort(request_id, "aborted:user")
        if found:
            self._count_finish("aborted:user")
        return found

    def _count_finish(self, reason: Optional[str]):
        if reason is not None:
            self.finish_counts[reason] = \
                self.finish_counts.get(reason, 0) + 1

    def _abort_running(self, reason: str) -> List[RequestOutput]:
        """Terminal sweep of every live request (running AND queued) —
        the step-failed path. All blocks are reclaimed; each request
        gets a structured output."""
        outs = []
        for r in list(self.scheduler.running) + list(self.scheduler.waiting):
            self.scheduler.abort(r.request_id, reason)
            outs.append(self._terminal_output(r))
        return outs

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

    # -- one engine iteration -------------------------------------------
    def step(self) -> List[RequestOutput]:
        """Schedule + run ONE ragged iteration (decode and verify rows,
        prefill chunks and new admissions packed together), sample the
        tokens of every row that finished its prompt, retire finished
        requests. Returns this step's per-request outputs — sampled
        tokens plus any structured terminal emissions (expired,
        rejected, poisoned)."""
        outputs: List[RequestOutput] = self._flush_pending()
        if self._spec is not None:
            self._propose_drafts()
        t0 = time.perf_counter()
        batch = self.scheduler.schedule()
        outputs.extend(self._terminal_output(r) for r in batch.expired)
        self.num_expired += len(batch.expired)
        if batch.is_empty:
            if self.scheduler.has_unfinished() and not batch.preempted:
                raise RuntimeError(
                    "scheduler produced an empty batch with unfinished "
                    "requests — KV cache too small for any waiting "
                    "request (admission validation should prevent this)")
            return outputs
        reqs = batch.requests
        n_run = list(batch.num_scheduled)
        T = int(sum(n_run))
        key = ("ragged", self._bucket(T), self.cfg.max_num_seqs)
        arrays = self._pack(reqs, n_run, key[1])

        # copy-on-write block copies land before the step writes the
        # destination blocks
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
        # a verify row costs 1 + its draft count but is one decode row
        prompt_toks = sum(
            min(n, max(len(r.prompt_ids) - r.num_cached, 0))
            for r, n in zip(reqs, n_run))
        decode_rows = sum(
            1 for r, n in zip(reqs, n_run)
            if n - len(r.draft_tokens) == 1 and r.num_generated > 0)
        # padded_tokens counts attention-path padding; the bucket's pad
        # rows never reach attention, as in the JAX engine's ragged step
        self.metrics.record_step(
            batch.kind, len(reqs), T, self.cfg.max_num_seqs,
            time.perf_counter() - t0, padded_tokens=0,
            prompt_tokens=prompt_toks, decode_rows=decode_rows)
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
                self.scheduler.finish(r)
                self.metrics.record_finish(r)
                self._count_finish(r.finish_reason)
            elif d:
                # speculative rollback: free the slots claimed for
                # rejected (or post-EOS) draft tokens
                self.block_manager.trim(r.request_id, len(r.tokens))
        return outputs

    def _bucket(self, n: int) -> int:
        """The smallest step bucket that holds ``n`` tokens."""
        return next(b for b in self.step_buckets if b >= n)

    def _pack(self, reqs, n_run, T: int) -> tuple:
        """The step's host arrays at width ``T`` (at least
        ``sum(n_run)``): the packed token stream (T,) over S sequence
        slots — prefill chunks and decode rows differ only in their
        cu_seqlens deltas; rows past ``cu[len(reqs)]`` are pad rows of id
        0 — then each slot's sampling state for the on-device sampler:
        keys, knobs, and the draft rows under verification."""
        S, R = self.cfg.max_num_seqs, self._spec_R
        ids = np.zeros((T,), np.int32)
        cu = np.zeros((S + 1,), np.int32)
        ctx = np.zeros((S,), np.int32)
        bt = np.full((S, self.max_blocks_per_seq), -1, np.int32)
        skeys = np.zeros((S, 2), np.int64)
        stemp = np.zeros((S,), np.float32)
        stopk = np.zeros((S,), np.int32)
        stopp = np.ones((S,), np.float32)
        sdraft = np.zeros((S, R - 1), np.int32)
        sndraft = np.zeros((S,), np.int32)
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
            skeys[i] = r.device_key
            stemp[i] = r.sampling.temperature
            stopk[i] = r.sampling.top_k
            stopp[i] = r.sampling.top_p
            d = len(r.draft_tokens)
            if d:
                sdraft[i, :d] = r.draft_tokens
                sndraft[i] = d
        cu[len(reqs) + 1:] = off
        return (ids, bt, cu, ctx, np.asarray([len(reqs)], np.int32),
                skeys, stemp, stopk, stopp, sdraft, sndraft)

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

    def _device_step(self, ids, bt, cu, ctx, nseq, skeys, stemp, stopk,
                     stopp, sdraft, sndraft):
        """The model forward + on-device sampling (rejection-sampling
        verify where draft rows ride along), on the tensors of
        :meth:`_pack`'s arrays. Returns the packed (S, R+4) int32 tensor
        and the (S, R, V) logit rows the sampler read, on the device.
        This is the function each bucket's graph captures: no host
        synchronisation, inputs read only, the caches written in
        place."""
        if self._spec_R > 1:
            lg3, _, _ = self.model.forward_ragged_multi(
                ids, self._kcs, self._vcs, bt, cu, ctx, nseq,
                self._spec_R)
        else:
            logits, _, _ = self.model.forward_ragged(
                ids, self._kcs, self._vcs, bt, cu, ctx, nseq)
            lg3 = logits[:, None, :]
        finite = torch.isfinite(lg3).all(dim=-1).all(dim=-1)
        toks, n_emit, nkeys = sample_or_verify(
            lg3, sdraft, sndraft, skeys, stemp, stopk, stopp)
        packed = torch.cat([
            toks, n_emit[:, None], _to_int32(nkeys),
            finite.to(torch.int32)[:, None]], dim=1)
        return packed, lg3

    def _dispatch(self, reqs, key, arrays) -> np.ndarray:
        """Run the step of bucket ``key`` on ``arrays`` (:meth:`_pack`)
        with bounded retry-with-backoff on failures, and fetch its one
        packed host view: ``(len(reqs), R+4)`` int32 rows of
        ``[tokens(R), n_emit, key_hi, key_lo, finite]``.

        The KV writes of a step are idempotent (the same rows land in
        the same slots), so a retry after a partial step is exact. A
        failure with donated caches, or past the retry budget, aborts
        EVERY live request with ``finish_reason='aborted:error'``
        structured outputs, closes the engine to admission, and raises
        :class:`EngineStepError` carrying them."""
        attempt = 0
        while True:
            try:
                faults.fire(faults.SERVING_STEP)  # slow/raise point
                with torch.no_grad():
                    packed, _ = self._graphs.run(key, self._device_step,
                                                 arrays)
                # the step's whole host boundary: one int32 row per slot
                out = self._graphs.fetch(packed[:len(reqs)])
                self._seen_shapes.add(key)
                return out
            except Exception as e:
                if self._donated or attempt >= self.cfg.max_step_retries:
                    why = ("donated caches make a failed step "
                           "non-retryable" if self._donated else
                           f"retry budget ({self.cfg.max_step_retries}) "
                           f"exhausted")
                    outs = self._abort_running("aborted:error")
                    self._closed = True
                    raise EngineStepError(
                        f"serving step {key} failed ({why}): {e!r} — "
                        f"engine drained, {len(outs)} request(s) aborted "
                        f"with structured outputs", outs) from e
                attempt += 1
                self.num_step_retries += 1
                time.sleep(self.cfg.step_retry_backoff_s
                           * (2 ** (attempt - 1)))

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
