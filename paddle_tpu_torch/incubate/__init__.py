"""Incubating APIs (port of ``paddle_tpu/incubate/``): the fused ops and
layers (``incubate.nn``), the mixture of experts (``incubate.moe``) and
the namespace's segment, graph, softmax-mask and optimizer-wrapper
functions (``incubate.compat``). ``incubate.asp`` (n:m structured
sparsity) comes with slice E2c and raises until then."""
from paddle_tpu_torch.distributed import _Waiting
from paddle_tpu_torch.incubate import moe  # noqa: F401
from paddle_tpu_torch.incubate import nn  # noqa: F401
from paddle_tpu_torch.incubate.compat import (  # noqa: F401
    LookAhead, ModelAverage, graph_khop_sampler, graph_reindex,
    graph_sample_neighbors, graph_send_recv, identity_loss, segment_max,
    segment_mean, segment_min, segment_sum, softmax_mask_fuse,
    softmax_mask_fuse_upper_triangle,
)
from paddle_tpu_torch.incubate.nn import functional  # noqa: F401
from paddle_tpu_torch.incubate.nn.layer import (  # noqa: F401
    FusedBiasDropoutResidualLayerNorm, FusedDropout, FusedDropoutAdd,
    FusedEcMoe, FusedFeedForward, FusedLinear, FusedMultiHeadAttention,
    FusedMultiTransformer, FusedTransformerEncoderLayer,
)


# n:m structured sparsity: slice E2c
asp = _Waiting("incubate.asp", "E2c (incubate/asp/)")
