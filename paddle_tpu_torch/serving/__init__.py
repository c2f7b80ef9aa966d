"""paddle_tpu_torch.serving — continuous-batching LLM inference on the
card (port of ``paddle_tpu.serving``, the ragged engine step).

=================  ====================================================
:class:`BlockManager`  paged KV allocator: free-list, per-request block
                       tables, prefix trie with copy-on-write
:class:`Scheduler`     iteration-level admission, chunked prefill mixed
                       with decode rows, preemption-on-OOM
:class:`LLMEngine`     the ragged step (hand-written attention kernel on
                       the card), on-device sampling, one host fetch per
                       step, nonfinite-row isolation
:class:`ServingMetrics` queue/KV/latency gauges through
                       ``profiler.register_counter_provider``
=================  ====================================================

Quick start::

    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import LLMEngine, EngineConfig, SamplingParams
    model = LlamaForCausalLM(LlamaConfig.tiny())      # on the card
    eng = LLMEngine(model, EngineConfig(max_num_seqs=8))
    eng.add_request(prompt_token_ids, SamplingParams(max_new_tokens=64))
    while eng.has_unfinished():
        for out in eng.step():
            if out.finished:
                eng.release_request(out.request_id)
"""
from paddle_tpu_torch.serving.block_manager import (  # noqa: F401
    BlockManager, NoFreeBlocksError,
)
from paddle_tpu_torch.serving.engine import (  # noqa: F401
    AdmissionController, EngineConfig, EngineStepError, LLMEngine,
)
from paddle_tpu_torch.serving.metrics import ServingMetrics  # noqa: F401
from paddle_tpu_torch.serving.request import (  # noqa: F401
    FINISH_REASONS, Request, RequestOutput, RequestStatus, SamplingParams,
)
from paddle_tpu_torch.serving.scheduler import (  # noqa: F401
    ScheduledBatch, Scheduler, SchedulerConfig,
)

__all__ = ["BlockManager", "NoFreeBlocksError", "AdmissionController",
           "EngineConfig", "EngineStepError", "LLMEngine", "ServingMetrics",
           "FINISH_REASONS", "Request", "RequestOutput", "RequestStatus",
           "SamplingParams", "ScheduledBatch", "Scheduler",
           "SchedulerConfig"]
