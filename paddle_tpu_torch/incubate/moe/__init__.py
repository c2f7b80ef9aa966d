"""Mixture of experts with expert parallelism (port of
``paddle_tpu/incubate/moe``)."""
from paddle_tpu_torch.incubate.moe.moe_layer import (  # noqa: F401
    GShardGate, MoELayer, NaiveGate, SwitchGate,
)
from paddle_tpu_torch.incubate.moe.grad_clip import (  # noqa: F401
    ClipGradForMOEByGlobalNorm,
)

__all__ = ["MoELayer", "NaiveGate", "GShardGate", "SwitchGate",
           "ClipGradForMOEByGlobalNorm"]
