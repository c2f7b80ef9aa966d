"""paddle_tpu_torch.serving.fleet — multi-replica serving router (port of
the JAX package's ``serving/fleet/``; every replica's engine runs on the
model's device: the card, unless the model was built on the CPU).

The layer above :class:`~paddle_tpu_torch.serving.LLMEngine`: a
:class:`FleetRouter` owns a set of replica handles and provides
SLO-aware dispatch, fleet-wide admission, per-tenant fairness
(weighted deficit round robin), transparent drain hand-off, and
elastic scaling hooks (:class:`FleetController`). See the README
"Fleet serving" section for the architecture.

Quick start::

    from paddle_tpu_torch.serving import EngineConfig, SamplingParams
    from paddle_tpu_torch.serving.fleet import FleetRouter, InProcessReplica

    router = FleetRouter([
        InProcessReplica(model, EngineConfig(), replica_id=f"r{i}")
        for i in range(2)])
    router.add_request(prompt_ids, SamplingParams(
        max_new_tokens=64, tenant_id="team-a"))
    while router.has_unfinished():
        for out in router.step():
            ...  # replica drains/deaths are invisible here
"""
from paddle_tpu_torch.serving.fleet.controller import (  # noqa: F401
    AutoscalePolicy, FleetController, LoadThresholdPolicy,
)
from paddle_tpu_torch.serving.fleet.lease import (  # noqa: F401
    LeaseStore, rendezvous_owner,
)
from paddle_tpu_torch.serving.fleet.metrics import FleetMetrics  # noqa: F401
from paddle_tpu_torch.serving.fleet.replica import (  # noqa: F401
    InProcessReplica, ReplicaHandle, ReplicaLoad,
)
from paddle_tpu_torch.serving.fleet.router import (  # noqa: F401
    FleetConfig, FleetRouter, HANDOFF_REASONS,
)
from paddle_tpu_torch.serving.fleet.sim import (  # noqa: F401
    Arrival, ChaosEvent, FleetSim, LatencyModel, SimReplica,
    VirtualClock, diurnal_trace, sim_token, spike_trace,
)
from paddle_tpu_torch.serving.fleet.supervisor import (  # noqa: F401
    ReplicaSupervisor, SupervisorConfig, WorkerSpec,
)
from paddle_tpu_torch.serving.fleet.tenant import (  # noqa: F401
    TenantQueue, tenant_home,
)
from paddle_tpu_torch.serving.fleet.transport import (  # noqa: F401
    PeerListener, ReplicaGone, ReplicaServicer, RpcClient, RpcError,
    RpcRemoteError, RpcTimeout, SubprocessReplica, connect_replica,
    peer_push, peer_secret, sign_ticket,
)

__all__ = ["AutoscalePolicy", "FleetController", "LoadThresholdPolicy",
           "FleetMetrics", "InProcessReplica", "ReplicaHandle",
           "ReplicaLoad", "FleetConfig", "FleetRouter",
           "HANDOFF_REASONS", "LeaseStore", "rendezvous_owner",
           "TenantQueue", "tenant_home",
           "ReplicaSupervisor", "SupervisorConfig", "WorkerSpec",
           "PeerListener", "ReplicaGone", "ReplicaServicer",
           "RpcClient", "RpcError", "RpcRemoteError", "RpcTimeout",
           "SubprocessReplica", "connect_replica", "peer_push",
           "peer_secret", "sign_ticket",
           "Arrival", "ChaosEvent", "FleetSim", "LatencyModel",
           "SimReplica", "VirtualClock", "diurnal_trace", "sim_token",
           "spike_trace"]
