"""Fleet (port of ``paddle_tpu/distributed/fleet/``): the tensor-parallel
layers at degree 1. The facade, pipeline and recompute come with slice D."""
from paddle_tpu_torch.distributed.fleet.mp_layers import (  # noqa: F401
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding, mark_placements, sharding_constraint,
)
