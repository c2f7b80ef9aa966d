"""Models of the port."""
from paddle_tpu_torch.models.llama import (  # noqa: F401
    LlamaConfig, LlamaForCausalLM, LlamaModel, LlamaPretrainingCriterion,
)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "LlamaPretrainingCriterion"]
