"""Fleet: the hybrid-parallel training facade (port of
``paddle_tpu/distributed/fleet/``): the tensor-parallel layers, the
facade, recompute, the utils and pipeline parallelism
(``pipeline_parallel``, ``pp_engine``)."""
from paddle_tpu_torch.distributed.fleet.mp_layers import (  # noqa: F401
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding, mark_placements, sharding_constraint,
)
from paddle_tpu_torch.distributed.fleet.facade import (  # noqa: F401
    DistributedStrategy, distributed_model, distributed_optimizer,
    get_hybrid_communicate_group, init,
)
from paddle_tpu_torch.distributed.fleet.recompute import (  # noqa: F401
    recompute, recompute_sequential,
)
from paddle_tpu_torch.distributed.fleet import utils  # noqa: F401
