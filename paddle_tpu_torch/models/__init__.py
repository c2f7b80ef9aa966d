"""Models of the port: the Llama decoder and the BERT encoder family."""
from paddle_tpu_torch.models import bert, llama  # noqa: F401
from paddle_tpu_torch.models.bert import (  # noqa: F401
    BertConfig, BertForMaskedLM, BertForSequenceClassification, BertModel,
    BertPretrainingCriterion,
)
from paddle_tpu_torch.models.llama import (  # noqa: F401
    LlamaConfig, LlamaForCausalLM, LlamaModel, LlamaPretrainingCriterion,
)

__all__ = ["BertConfig", "BertModel", "BertForMaskedLM",
           "BertForSequenceClassification", "BertPretrainingCriterion",
           "LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "LlamaPretrainingCriterion"]
