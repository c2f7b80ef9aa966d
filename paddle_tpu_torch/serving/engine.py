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
  card. PyTorch runs eagerly, so T is exactly this step's token count
  (the JAX engine pads to a fixed budget so that XLA compiles one
  shape; a CUDA graph would bring that back);
* prompt prefixes are cached: full prompt blocks register in the
  BlockManager's trie after the step that writes them, later requests
  share them by refcount, and the first divergent write copies on write
  (``_apply_cow`` lands the block copies before the step);
* sampling runs on the device (:mod:`paddle_tpu_torch.ops.sampling`):
  the step ends in ONE host fetch of a packed (S, 5) int32 tensor —
  ``[token, n_emit, key_hi, key_lo, finite]`` per slot — never the
  S x vocab logits.

Not ported yet, refused at construction with the slice that brings
them: the bucketed path (``ragged=False``), tensor parallelism, tiered
KV, speculative decoding, host swap and the step watchdog.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.ops.sampling import sample_tokens
from paddle_tpu_torch.serving.block_manager import BlockManager, cdiv
from paddle_tpu_torch.serving.metrics import ServingMetrics
from paddle_tpu_torch.serving.request import (
    Request, RequestOutput, SamplingParams,
)
from paddle_tpu_torch.serving.scheduler import Scheduler, SchedulerConfig
from paddle_tpu_torch.testing import faults

__all__ = ["EngineConfig", "LLMEngine", "AdmissionController",
           "EngineStepError"]


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
    swap_mode: str = "recompute"
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
        if self.max_model_len is not None and self.max_model_len < 1:
            raise ValueError("max_model_len must be >= 1")
        if self.max_queue_depth is not None and self.max_queue_depth < 0:
            raise ValueError("max_queue_depth must be >= 0")
        if self.ttft_slo_ms is not None and self.ttft_slo_ms <= 0:
            raise ValueError("ttft_slo_ms must be > 0")
        if self.max_step_retries < 0:
            raise ValueError("max_step_retries must be >= 0")
        # what the port does not serve yet, named with the slice that
        # brings it (ROADMAP.md, queue 2)
        later = []
        if self.ragged is False:
            later.append("ragged=False (the bucketed forward_paged path)")
        if self.tp_degree != 1:
            later.append(f"tp_degree={self.tp_degree} (slice C: tensor "
                         f"parallelism)")
        if self.kv_tiers is not None:
            later.append("kv_tiers (the swap-and-tiers slice)")
        if self.draft_model is not None or self.num_spec_tokens:
            later.append("draft_model/num_spec_tokens (the speculative "
                         "decoding slice)")
        if self.swap_mode != "recompute":
            later.append(f"swap_mode={self.swap_mode!r} (the "
                         f"swap-and-tiers slice)")
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
        # the most tokens one step may pack: the configured budget,
        # clamped to what a full batch could ever schedule
        self._token_budget = min(self.cfg.max_batched_tokens,
                                 self.cfg.max_num_seqs
                                 * self.cfg.max_model_len)

        self.block_manager = BlockManager(
            self.cfg.num_blocks, self.cfg.block_size,
            enable_prefix_cache=self.cfg.prefix_cache)
        self.scheduler = Scheduler(
            self.block_manager,
            SchedulerConfig(max_num_seqs=self.cfg.max_num_seqs,
                            max_batched_tokens=self._token_budget))
        self.admission = AdmissionController(
            max_queue_depth=self.cfg.max_queue_depth,
            ttft_slo_ms=self.cfg.ttft_slo_ms)

        # -- device caches: (L, NB, BS, KH, D) stacked per layer, in the
        # model's dtype (the kernel takes one dtype for q and the cache)
        kh = mcfg.num_key_value_heads
        hd = mcfg.hidden_size // mcfg.num_attention_heads
        shape = (mcfg.num_hidden_layers, self.cfg.num_blocks,
                 self.cfg.block_size, kh, hd)
        self._kcs = torch.zeros(shape, dtype=model.dtype, device=self.device)
        self._vcs = torch.zeros(shape, dtype=model.dtype, device=self.device)

        self._requests: Dict[str, Request] = {}
        self._auto_id = itertools.count()
        # steps whose batch held >= 1 sampled (temperature > 0) request
        self.num_sampled_steps = 0
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
        the request's sampling stream mid-way."""
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
        """Schedule + run ONE ragged iteration (decode rows, prefill
        chunks and new admissions packed together), sample one token per
        row that finished its prompt, retire finished requests. Returns
        this step's per-request outputs — sampled tokens plus any
        structured terminal emissions (expired, rejected, poisoned)."""
        outputs: List[RequestOutput] = self._flush_pending()
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
        # the packed token stream (T,) over S sequence slots — prefill
        # chunks and decode rows differ only in their cu_seqlens deltas
        S = self.cfg.max_num_seqs
        T = int(sum(n_run))
        ids = np.zeros((T,), np.int32)
        cu = np.zeros((S + 1,), np.int32)
        ctx = np.zeros((S,), np.int32)
        bt = np.full((S, self.max_blocks_per_seq), -1, np.int32)
        off = 0
        for i, r in enumerate(reqs):
            n = n_run[i]
            ids[off:off + n] = r.tokens[r.num_cached:r.num_cached + n]
            off += n
            cu[i + 1] = off
            ctx[i] = r.num_cached + n
            table = self.block_manager.block_table(r.request_id)
            bt[i, :len(table)] = table
        cu[len(reqs) + 1:] = off
        arrays = (ids, bt, cu, ctx, np.asarray([len(reqs)], np.int32))

        # copy-on-write block copies land before the step writes the
        # destination blocks
        self._apply_cow()
        # per-slot sampling state for the on-device sampler
        skeys = np.zeros((S, 2), np.int64)
        stemp = np.zeros((S,), np.float32)
        stopk = np.zeros((S,), np.int32)
        stopp = np.ones((S,), np.float32)
        for i, r in enumerate(reqs):
            skeys[i] = r.device_key
            stemp[i] = r.sampling.temperature
            stopk[i] = r.sampling.top_k
            stopp[i] = r.sampling.top_p
        if any(r.sampling.temperature > 0.0 for r in reqs):
            self.num_sampled_steps += 1
        try:
            out_np = self._dispatch(reqs, arrays,
                                    (skeys, stemp, stopk, stopp))
        except EngineStepError as e:
            # this step's already-produced structured outputs must not
            # vanish with the failure — they ride the exception ahead of
            # the abort sweep
            e.outputs = outputs + e.outputs
            raise

        # non-finite-logits guard: abort ONLY the poisoned row(s); the
        # rest of the batch continues untouched
        poisoned = self._poisoned_rows(reqs, out_np[:, 4])
        prompt_toks = sum(
            min(n, max(len(r.prompt_ids) - r.num_cached, 0))
            for r, n in zip(reqs, n_run))
        decode_rows = sum(1 for r, n in zip(reqs, n_run)
                          if n == 1 and r.num_generated > 0)
        self.metrics.record_step(
            batch.kind, len(reqs), T, self.cfg.max_num_seqs,
            time.perf_counter() - t0, padded_tokens=0,
            prompt_tokens=prompt_toks, decode_rows=decode_rows)
        # unpack the step's single host fetch: per row [token, n_emit,
        # key_hi, key_lo, finite]
        keys_np = np.ascontiguousarray(out_np[:, 2:4]).view(np.uint32)
        for i, r in enumerate(reqs):
            if i in poisoned:
                self.scheduler.abort(r.request_id, "aborted:nonfinite")
                self.num_poisoned_aborts += 1
                outputs.append(self._terminal_output(r))
                continue
            r.num_cached += n_run[i]
            if self.cfg.prefix_cache:
                # register fully-written prompt blocks AFTER the step
                # that wrote them (never discoverable before their K/V
                # bytes exist on device)
                self.block_manager.commit_prefix(
                    r.request_id, r.prompt_ids, r.num_cached)
            if r.num_cached < len(r.tokens):
                continue  # mid-prefill chunk: its row logit is a prompt
                # position — never sampled, no output this step
            token = int(out_np[i, 0])
            finished = r.append_token(token)
            self.metrics.record_token()
            out = RequestOutput(request_id=r.request_id, token=token,
                                finished=finished,
                                generated=list(r.generated),
                                finish_reason=r.finish_reason)
            outputs.append(out)
            if r.callback is not None:
                r.callback(r.request_id, token, finished)
            # the sampler advanced this row's key by its fixed map;
            # persist it only for emitting rows, so a request's key
            # position is a pure function of its emitted-step count
            r.device_key = keys_np[i].copy()
            if finished:
                self.scheduler.finish(r)
                self.metrics.record_finish(r)
                self._count_finish(r.finish_reason)
        return outputs

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

    def _device_step(self, arrays, sampling_arrays) -> torch.Tensor:
        """The model forward + on-device sampling. Returns the packed
        (S, 5) int32 tensor, still on the device."""
        dev = self.device
        ids, bt, cu, ctx, nseq = (torch.as_tensor(a, device=dev)
                                  for a in arrays)
        skeys, stemp, stopk, stopp = (torch.as_tensor(a, device=dev)
                                      for a in sampling_arrays)
        logits, _, _ = self.model.forward_ragged(
            ids, self._kcs, self._vcs, bt, cu, ctx, nseq)
        finite = torch.isfinite(logits).all(dim=-1)
        tok, nkeys = sample_tokens(logits, skeys, stemp, stopk, stopp)
        return torch.stack([
            tok, torch.ones_like(tok), _to_int32(nkeys[:, 0]),
            _to_int32(nkeys[:, 1]), finite.to(torch.int32)], dim=1)

    def _dispatch(self, reqs, arrays, sampling_arrays) -> np.ndarray:
        """Run the step with bounded retry-with-backoff on failures, and
        fetch its one packed host view: ``(len(reqs), 5)`` int32 rows of
        ``[token, n_emit, key_hi, key_lo, finite]``.

        The KV writes of a step are idempotent (the same rows land in
        the same slots), so a retry after a partial step is exact. A
        failure past the retry budget aborts EVERY live request with
        ``finish_reason='aborted:error'`` structured outputs, closes the
        engine to admission, and raises :class:`EngineStepError`
        carrying them."""
        attempt = 0
        while True:
            try:
                faults.fire(faults.SERVING_STEP)  # slow/raise point
                with torch.no_grad():
                    packed = self._device_step(arrays, sampling_arrays)
                # the step's whole host boundary: one int32 row per slot
                return packed[:len(reqs)].cpu().numpy()
            except Exception as e:
                if attempt >= self.cfg.max_step_retries:
                    outs = self._abort_running("aborted:error")
                    self._closed = True
                    raise EngineStepError(
                        f"serving step failed (retry budget "
                        f"{self.cfg.max_step_retries} exhausted): {e!r} — "
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
