"""Serving observability: queue/batch/KV gauges + latency aggregates.

Exposed two ways:

* pull — every gauge registers with
  ``profiler.register_counter_provider``, so ``profiler.counters()``
  reports ``serving/<name>``;
* snapshot — :meth:`ServingMetrics.snapshot` returns one dict.

Copied from the JAX package's ``serving/metrics.py``.

TTFT (time-to-first-token) and TPOT (time-per-output-token, a.k.a.
inter-token latency) follow the standard serving definitions: TTFT is
arrival -> first sampled token; TPOT is (finish - first token) /
(n_generated - 1)."""
from __future__ import annotations

import time
import weakref
from collections import deque
from typing import Dict, List, Optional

from paddle_tpu_torch.serving.request import FINISH_REASONS

__all__ = ["ServingMetrics"]


def _mean(xs: List[float]) -> float:
    return sum(xs) / len(xs) if xs else 0.0


def _percentile(xs: List[float], q: float) -> float:
    if not xs:
        return 0.0
    s = sorted(xs)
    i = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return s[i]


class ServingMetrics:
    """Owned by one :class:`~paddle_tpu_torch.serving.LLMEngine`."""

    GAUGES = ("queue_depth", "num_running", "num_waiting",
              "kv_block_utilization", "tokens_per_sec", "ttft_ms_avg",
              "tpot_ms_avg", "preemptions", "batch_occupancy",
              # resilience: lifetime engine/scheduler counters
              "num_swapped", "swapped_out", "swapped_in", "expired",
              "rejected", "step_retries", "poisoned_aborts",
              "drain_started", "drain_aborted", "drain_completed",
              # ragged hot path: attention-path padding waste plus
              # prefix-cache, copy-on-write, and chunked-prefill traffic
              "padded_token_frac", "prefix_cache_hits",
              "prefix_cache_hit_tokens", "cow_copies", "prefill_chunks",
              # on-device sampling + speculative decoding: draft
              # proposal/acceptance traffic and sampled-step count
              "spec_proposed", "spec_accepted", "spec_acceptance_rate",
              "sampled_steps",
              # disaggregated serving: requests admitted mid-context
              # with shipped KV instead of recompute
              "continuation_admits",
              # fleet-global prefix cache: whole cached prefixes shipped
              # to/from peer replicas, no request attached
              "prefix_exports", "prefix_imports",
              # shipped KV payloads that landed through a cross-layout
              # redistribute, and ship continuations the mixed scheduler
              # resumed mid-context
              "kv_reshards", "continuation_resumes",
              # tiered KV: cross-tier migration traffic, host/peer-tier
              # occupancy, and parked-session resumes (all 0 on an
              # untiered engine)
              "kv_tier_demotes", "kv_tier_promotes",
              "kv_tier_host_blocks_used", "kv_tier_peer_blocks_used",
              "kv_tier_park_resumes")

    # per-terminal-reason histogram: every request's end state lands in
    # exactly one bucket — `serving/finish/<reason>` counters,
    # `serving_finish/<reason>` snapshot keys
    FINISH_GAUGES = tuple(f"finish/{r}" for r in FINISH_REASONS)

    # gauges read straight off the engine/scheduler (they outlive
    # reset_metrics, like `preemptions` always has)
    _ENGINE_GAUGES = {
        "num_swapped": lambda eng: eng.scheduler.num_swapped,
        "swapped_out": lambda eng: eng.scheduler.num_swap_outs,
        "swapped_in": lambda eng: eng.scheduler.num_swap_ins,
        "expired": lambda eng: eng.num_expired,
        "rejected": lambda eng: eng.num_rejected,
        "step_retries": lambda eng: eng.num_step_retries,
        "poisoned_aborts": lambda eng: eng.num_poisoned_aborts,
        "drain_started": lambda eng: eng.num_drains_started,
        "drain_aborted": lambda eng: eng.num_drain_aborted,
        "drain_completed": lambda eng: eng.num_drains_completed,
        "prefix_cache_hits": lambda eng: eng.block_manager.num_prefix_hits,
        "prefix_cache_hit_tokens":
            lambda eng: eng.block_manager.num_prefix_hit_tokens,
        "cow_copies": lambda eng: eng.block_manager.num_cow_copies,
        "prefill_chunks": lambda eng: eng.scheduler.num_prefill_chunks,
        "spec_proposed": lambda eng: eng.num_spec_proposed,
        "spec_accepted": lambda eng: eng.num_spec_accepted,
        "sampled_steps": lambda eng: eng.num_sampled_steps,
        "continuation_admits": lambda eng: eng.num_continuation_admits,
        "prefix_exports": lambda eng: eng.num_prefix_exports,
        "prefix_imports": lambda eng: eng.num_prefix_imports,
        "kv_reshards": lambda eng: eng.num_kv_reshards,
        "continuation_resumes":
            lambda eng: eng.scheduler.num_continuation_resumes,
        # tiered-KV gauges: 0 on an untiered engine
        "kv_tier_demotes": lambda eng: eng.block_manager.num_demotes,
        "kv_tier_promotes": lambda eng: eng.block_manager.num_promotes,
        "kv_tier_host_blocks_used": lambda eng: (
            eng.block_manager.num_host_blocks_used
            if eng._kvtier is not None else 0),
        "kv_tier_peer_blocks_used": lambda eng: (
            eng._kvtier.peer_blocks if eng._kvtier is not None else 0),
        "kv_tier_park_resumes": lambda eng: (
            eng._kvtier.num_park_resumes if eng._kvtier is not None else 0),
    }

    def __init__(self, engine):
        self._engine = weakref.ref(engine)
        self.start_time = time.monotonic()
        self.num_prompt_tokens = 0
        self.num_generated_tokens = 0
        self.num_finished = 0
        self.engine_steps = 0
        self.prefill_steps = 0
        self.decode_steps = 0
        self.mixed_steps = 0
        # attention-path padding: slots the compiled step attended that
        # held no real token (bucketed rows x longest-row padding; the
        # ragged step packs, so it contributes zero — its fixed token
        # budget is dense-MLP headroom, not attention work, and is NOT
        # counted here)
        self.num_padded_tokens = 0
        self.num_slot_tokens = 0          # real + padded
        self.ttfts_s: List[float] = []
        self.tpots_s: List[float] = []
        # batch occupancy: scheduled seqs / max_num_seqs per decode step
        self._occupancy_sum = 0.0
        self._occupancy_n = 0
        # rolling window of recent step wall times — the admission
        # controller's TTFT estimator input
        self._step_times_s: deque = deque(maxlen=64)
        self._registered: List[str] = []
        self._register(engine)

    # -- recording (called by the engine) --------------------------------
    def record_step(self, kind: str, n_seqs: int, n_tokens: int,
                    max_num_seqs: int, dt_s: Optional[float] = None,
                    padded_tokens: int = 0,
                    prompt_tokens: Optional[int] = None,
                    decode_rows: Optional[int] = None):
        """``prompt_tokens``/``decode_rows`` split a MIXED (ragged) batch
        explicitly; None infers them from ``kind`` (the classic
        prefill-xor-decode accounting). ``padded_tokens`` counts
        attention-path pad slots the step attended (0 for ragged)."""
        self.engine_steps += 1
        if dt_s is not None:
            self._step_times_s.append(dt_s)
        self.num_slot_tokens += n_tokens + padded_tokens
        self.num_padded_tokens += padded_tokens
        if prompt_tokens is None:
            prompt_tokens = n_tokens if kind == "prefill" else 0
        if decode_rows is None:
            decode_rows = n_seqs if kind == "decode" else 0
        self.num_prompt_tokens += prompt_tokens
        if kind == "prefill":
            self.prefill_steps += 1
        elif kind == "decode":
            self.decode_steps += 1
        elif kind == "mixed":
            self.mixed_steps += 1
        if decode_rows:
            self._occupancy_sum += decode_rows / max_num_seqs
            self._occupancy_n += 1

    def estimated_ttft_ms(self, queue_depth: int,
                          queued_prefill_tokens: int = 0,
                          prompt_tokens: int = 0,
                          tokens_per_step: Optional[int] = None
                          ) -> Optional[float]:
        """Predicted time-to-first-token for a request arriving behind
        ``queue_depth`` waiting peers: each needs roughly one engine
        iteration before this one prefills, PLUS the prefill work those
        peers (and this prompt itself) queue up — token counts divided
        by the per-iteration token budget ``tokens_per_step`` — so a
        burst of long prompts raises the estimate even at a shallow
        queue depth. None while the engine has no step history (cold
        start — admission abstains rather than reject on a guess)."""
        # snapshot first: the engine thread appends concurrently, and
        # iterating a deque that grows past maxlen mid-sum raises
        # "deque mutated during iteration" (tuple() is atomic under the GIL)
        times = tuple(self._step_times_s)
        if not times:
            return None
        avg = sum(times) / len(times)
        steps = queue_depth + 1.0
        if tokens_per_step:
            steps += (queued_prefill_tokens + prompt_tokens) / tokens_per_step
        return steps * avg * 1e3

    def record_token(self):
        self.num_generated_tokens += 1

    def record_finish(self, request):
        self.num_finished += 1
        if request.first_token_time is not None:
            self.ttfts_s.append(
                request.first_token_time - request.arrival_time)
            if request.num_generated > 1 and request.finish_time:
                self.tpots_s.append(
                    (request.finish_time - request.first_token_time)
                    / (request.num_generated - 1))

    # -- derived ---------------------------------------------------------
    @property
    def tokens_per_sec(self) -> float:
        dt = time.monotonic() - self.start_time
        return self.num_generated_tokens / dt if dt > 0 else 0.0

    @property
    def batch_occupancy(self) -> float:
        return (self._occupancy_sum / self._occupancy_n
                if self._occupancy_n else 0.0)

    @property
    def padded_token_frac(self) -> float:
        """Fraction of attended token slots that were padding — the
        waste the ragged step eliminates by construction."""
        return (self.num_padded_tokens / self.num_slot_tokens
                if self.num_slot_tokens else 0.0)

    def snapshot(self) -> Dict[str, float]:
        eng = self._engine()
        out = {
            "num_prompt_tokens": self.num_prompt_tokens,
            "num_generated_tokens": self.num_generated_tokens,
            "num_finished": self.num_finished,
            "engine_steps": self.engine_steps,
            "prefill_steps": self.prefill_steps,
            "decode_steps": self.decode_steps,
            "mixed_steps": self.mixed_steps,
            "padded_token_frac": round(self.padded_token_frac, 4),
            "tokens_per_sec": round(self.tokens_per_sec, 2),
            "ttft_ms_avg": round(_mean(self.ttfts_s) * 1e3, 3),
            "ttft_ms_p90": round(
                _percentile(self.ttfts_s, 0.9) * 1e3, 3),
            "tpot_ms_avg": round(_mean(self.tpots_s) * 1e3, 3),
            "batch_occupancy": round(self.batch_occupancy, 4),
        }
        if eng is not None:
            out.update({
                "num_running": eng.scheduler.num_running,
                "num_waiting": eng.scheduler.num_waiting,
                "preemptions": eng.scheduler.num_preemptions,
                "kv_block_utilization": round(
                    eng.block_manager.utilization(), 4),
                "kv_blocks_total": eng.block_manager.num_blocks,
                "kv_host_blocks_total": eng.block_manager.num_host_blocks,
            })
            # resilience + ragged-path counters: swap traffic, TTL
            # expiry, admission rejects, step retries, poisoned-row
            # aborts, drain lifecycle, prefix cache
            out.update({f"serving_{name}": int(get(eng))
                        for name, get in self._ENGINE_GAUGES.items()})
            # the one float engine gauge (kept out of the int() wrap)
            out["serving_spec_acceptance_rate"] = round(
                eng.spec_acceptance_rate, 4)
            out.update({f"serving_finish/{r}":
                        int(eng.finish_counts.get(r, 0))
                        for r in FINISH_REASONS})
        return out

    # -- profiler counter providers --------------------------------------
    def _register(self, engine):
        from paddle_tpu_torch import profiler

        ref = weakref.ref(engine)
        mref = weakref.ref(self)

        def provider(name):
            def get():
                eng, m = ref(), mref()
                if eng is None or m is None:
                    return None  # counters() drops dead providers
                if name in ServingMetrics._ENGINE_GAUGES:
                    return ServingMetrics._ENGINE_GAUGES[name](eng)
                if name == "spec_acceptance_rate":
                    return eng.spec_acceptance_rate
                if name.startswith("finish/"):
                    return eng.finish_counts.get(name[len("finish/"):], 0)
                if name == "queue_depth":
                    return eng.scheduler.num_waiting
                if name == "num_running":
                    return eng.scheduler.num_running
                if name == "num_waiting":
                    return eng.scheduler.num_waiting
                if name == "kv_block_utilization":
                    return eng.block_manager.utilization()
                if name == "tokens_per_sec":
                    return m.tokens_per_sec
                if name == "ttft_ms_avg":
                    return _mean(m.ttfts_s) * 1e3
                if name == "tpot_ms_avg":
                    return _mean(m.tpots_s) * 1e3
                if name == "preemptions":
                    return eng.scheduler.num_preemptions
                if name == "batch_occupancy":
                    return m.batch_occupancy
                if name == "padded_token_frac":
                    return m.padded_token_frac
                return None
            return get

        for g in self.GAUGES + self.FINISH_GAUGES:
            cname = f"serving/{g}#{id(engine)}"
            profiler.register_counter_provider(cname, provider(g))
            self._registered.append(cname)
        # an app that never reads counters() must not leak providers
        weakref.finalize(engine, _unregister_all, list(self._registered))


def _unregister_all(names):
    from paddle_tpu_torch import profiler

    for n in names:
        profiler.unregister_counter_provider(n)
