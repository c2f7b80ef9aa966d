"""Elastic scaling hooks: FleetController.scale_to + autoscale policy
(port of the JAX package's ``serving/fleet/controller.py``).

Scaling DOWN runs through the drain machinery — the victim replica
drains gracefully and its in-flight requests hand off to peers before
it detaches — so elasticity reuses the exact resilience path that
SIGTERM preemption exercises. Scaling UP calls a user-supplied
``replica_factory`` (build an engine, return a handle); acquiring
devices is out of scope, which is why the factory is a
hook and not an implementation.

Autoscale is a pluggable policy object consulted on :meth:`tick`;
its decisions are surfaced as counters
(``fleet/{scale_ups,scale_downs,autoscale_decisions}``) whether or not
they change the target, so a dashboard can watch the policy think.
"""
from __future__ import annotations

from typing import Callable, Optional

from paddle_tpu_torch.serving.fleet.replica import ReplicaHandle
from paddle_tpu_torch.serving.fleet.router import FleetRouter

__all__ = ["AutoscalePolicy", "LoadThresholdPolicy", "FleetController"]


class AutoscalePolicy:
    """Decide a replica-count target from the router's load signal.
    Return the desired dispatchable-replica count, or None for "no
    change"."""

    def decide(self, load: float, replicas_live: int, queued: int,
               tenant_load: float = 0.0) -> Optional[int]:
        raise NotImplementedError


class LoadThresholdPolicy(AutoscalePolicy):
    """Hysteresis band: scale up one replica when fleet load exceeds
    ``high`` (or requests are queued with nothing dispatchable), down
    one when it falls below ``low``; hold inside the band.

    ``tenant_high`` adds a second, skew-sensitive trigger: scale up
    when the router's :meth:`~FleetRouter.tenant_load` — scalar load
    amplified by how concentrated recent dispatches are on one tenant
    — exceeds it. The fleet-MEAN load can sit inside the band while a
    single tenant's burst saturates exactly the replicas its requests
    land on; the tenant signal sees that spike. ``None`` (default)
    keeps the policy bit-identical to the scalar one. Scale-DOWN
    still keys on the scalar load only — concentration of a trickle
    is not a reason to hold capacity."""

    def __init__(self, high: float = 0.8, low: float = 0.2,
                 min_replicas: int = 1, max_replicas: int = 8,
                 tenant_high: Optional[float] = None):
        if not 0.0 <= low < high <= 1.0:
            raise ValueError("need 0 <= low < high <= 1")
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        if tenant_high is not None and not 0.0 < tenant_high <= 1.0:
            raise ValueError("need 0 < tenant_high <= 1")
        self.high = high
        self.low = low
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.tenant_high = tenant_high

    def decide(self, load: float, replicas_live: int, queued: int,
               tenant_load: float = 0.0) -> Optional[int]:
        hot_tenant = (self.tenant_high is not None
                      and tenant_load > self.tenant_high)
        if ((load > self.high or hot_tenant
                or (queued > 0 and replicas_live == 0))
                and replicas_live < self.max_replicas):
            return replicas_live + 1
        if (load < self.low and not hot_tenant
                and replicas_live > self.min_replicas):
            return replicas_live - 1
        return None


class FleetController:
    """Owns the replica count. ``replica_factory(index)`` must return a
    fresh :class:`ReplicaHandle` with a unique ``replica_id``."""

    def __init__(self, router: FleetRouter,
                 replica_factory: Callable[[int], ReplicaHandle],
                 policy: Optional[AutoscalePolicy] = None):
        self.router = router
        self.replica_factory = replica_factory
        self.policy = policy
        self._spawned = len(router.replicas)

    def scale_to(self, n: int, reason: str = "manual") -> None:
        """Move the DISPATCHABLE replica count to ``n``: spin up fresh
        replicas, or drain the least-loaded ones down through the
        hand-off path. Draining victims keep stepping until empty (the
        router reaps them), so scale-down is lossless."""
        if n < 0:
            raise ValueError("n must be >= 0")
        while len(self.router.dispatchable()) < n:
            handle = self.replica_factory(self._spawned)
            self._spawned += 1
            self.router.attach_replica(handle)
            self.router.num_scale_ups += 1
        extra = len(self.router.dispatchable()) - n
        if extra > 0:
            victims = sorted(self.router.dispatchable(),
                             key=lambda h: (h.load().occupancy,
                                            h.replica_id))[:extra]
            for h in victims:
                self.router.retire_replica(h, reason=f"{reason}")
                self.router.num_scale_downs += 1

    def tick(self) -> Optional[int]:
        """Consult the autoscale policy once; apply and return its
        target if it wants a change. Call on the serving loop's cadence
        (every N router steps, or a timer)."""
        if self.policy is None:
            return None
        live = len(self.router.dispatchable())
        tload = getattr(self.router, "tenant_load", None)
        try:
            target = self.policy.decide(
                self.router.load(), live, len(self.router._queue),
                tenant_load=tload() if callable(tload) else 0.0)
        except TypeError:
            # user-supplied policy predating the tenant_load kwarg
            target = self.policy.decide(self.router.load(), live,
                                        len(self.router._queue))
        self.router.num_autoscale_decisions += 1
        if target is not None and target != live:
            self.scale_to(target, reason="autoscale")
            return target
        return None
