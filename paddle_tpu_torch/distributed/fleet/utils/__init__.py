"""Fleet utils (port of ``paddle_tpu/distributed/fleet/utils/``)."""
from paddle_tpu_torch.distributed.fleet.utils.sequence_parallel_utils import (  # noqa: F401
    AllGatherOp, ColumnSequenceParallelLinear, GatherOp, ReduceScatterOp,
    RowSequenceParallelLinear, ScatterOp,
    mark_as_sequence_parallel_parameter,
    register_sequence_parallel_allreduce_hooks,
)
from paddle_tpu_torch.distributed.fleet.utils.hybrid_parallel_util import (  # noqa: F401
    broadcast_dp_parameters, broadcast_mp_parameters,
    broadcast_sharding_parameters, fused_allreduce_gradients,
    fused_parameters,
)
