"""Weighted deficit-round-robin (DRR) tenant queue (port of the JAX
package's ``serving/fleet/tenant.py``).

The router's admission queue is per-tenant: each tenant id gets its own
FIFO, and dispatch order across tenants follows DRR (Shreedhar &
Varghese) — every visit to a tenant grants it ``quantum_tokens * weight``
of deficit, and the tenant's head request dispatches only once its
token cost fits the accumulated deficit. Cheap requests from a light
tenant therefore cannot be starved behind a burst of expensive requests
from a heavy one: the heavy tenant's big requests must save up turns
while the light tenant spends its quantum every round.

Cost is counted in tokens (prompt + max_new_tokens — the work a request
can demand), not requests, so fairness holds under skewed request
sizes. Hand-off re-enqueues use ``front=True`` with cost 0: the request
already paid its tenant cost when first dispatched, and a replica
failure must not charge (or queue-jump) its tenant twice.

Fairness granularity IS the quantum: a quantum much larger than the
typical request lets one visit burst many requests from the same
tenant before rotating. By default the quantum therefore ADAPTS — it
tracks the mean cost of requests pushed so far (so one DRR visit
grants roughly one typical request), starting from 256 tokens until
the first request is observed. Passing an explicit ``quantum_tokens``
pins it, for workloads that want a fixed granularity.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from .lease import rendezvous_owner

__all__ = ["TenantQueue", "tenant_home"]


def tenant_home(tenant: str, routers: Sequence[str]) -> Optional[str]:
    """Which router's queue a tenant's requests belong to, under the
    replicated control plane: rendezvous hashing over the live router
    ids, so each tenant queue lives at exactly one router at a time and
    a router join/leave only moves the tenants that router owned. The
    submitting client and every router compute the same answer from the
    same router-registry view — there is no assignment table to keep
    consistent."""
    return rendezvous_owner(f"tenant:{tenant}", routers)


class TenantQueue:
    #: adaptive-quantum cold start, before any request cost is observed
    DEFAULT_QUANTUM = 256

    def __init__(self, quantum_tokens: Optional[int] = None,
                 weights: Optional[Dict[str, float]] = None):
        if quantum_tokens is not None and quantum_tokens < 1:
            raise ValueError("quantum_tokens must be >= 1")
        self._fixed_quantum = quantum_tokens
        # observed request costs (tail-pushed, cost > 0): the adaptive
        # quantum is their running mean
        self._cost_sum = 0
        self._cost_n = 0
        self.weights = dict(weights or {})
        for t, w in self.weights.items():
            if w <= 0:
                raise ValueError(f"tenant {t!r}: weight must be > 0")
        self._queues: Dict[str, Deque[Tuple[object, int]]] = {}
        self._deficit: Dict[str, float] = {}
        self._order: List[str] = []   # active tenants, round-robin
        self._cursor = 0
        self._granted = False  # current tenant already got this visit's quantum

    @property
    def quantum(self) -> float:
        """Per-visit deficit grant. Explicit when configured; otherwise
        the mean observed request cost (one typical request per visit),
        ``DEFAULT_QUANTUM`` until the first request arrives."""
        if self._fixed_quantum is not None:
            return self._fixed_quantum
        if self._cost_n == 0:
            return self.DEFAULT_QUANTUM
        return max(1.0, self._cost_sum / self._cost_n)

    def weight(self, tenant: str) -> float:
        return self.weights.get(tenant, 1.0)

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def waiting_by_tenant(self) -> Dict[str, int]:
        return {t: len(q) for t, q in self._queues.items() if q}

    def push(self, tenant: str, item, cost: int,
             front: bool = False) -> None:
        if tenant not in self._queues or not self._queues[tenant]:
            self._queues[tenant] = self._queues.get(tenant, deque())
            if tenant not in self._order:
                # joins the rotation just before the cursor: it waits a
                # full round like any newcomer, with zero banked deficit
                self._cursor = min(self._cursor, len(self._order))
                self._order.insert(self._cursor, tenant)
                self._cursor += 1
                self._deficit.setdefault(tenant, 0.0)
        q = self._queues[tenant]
        if front:
            # unpop refunds and hand-off re-enqueues: the cost was
            # already observed (or is 0) — must not skew the mean
            q.appendleft((item, int(cost)))
        else:
            q.append((item, int(cost)))
            if cost > 0:
                self._cost_sum += int(cost)
                self._cost_n += 1

    def unpop(self, tenant: str, item, cost: int) -> None:
        """Undo a :meth:`pop`: the router pulled a request but no
        replica would admit it — back to the head, deficit refunded."""
        self.push(tenant, item, cost, front=True)
        self._deficit[tenant] = self._deficit.get(tenant, 0.0) + cost

    def pop(self) -> Optional[Tuple[str, object, int]]:
        """Next (tenant, item, cost) in DRR order, or None when empty."""
        if not self._order:
            return None
        # bound: each full rotation banks every tenant one quantum, so
        # the priciest head affords within cost/(quantum*weight) rounds
        max_head = max(q[0][1] for q in self._queues.values() if q)
        min_w = min(self.weight(t) for t in self._order)
        rotations = 2 + int(max_head / (self.quantum * min_w))
        for _ in range(rotations * len(self._order) + 1):
            if self._cursor >= len(self._order):
                self._cursor = 0
            t = self._order[self._cursor]
            q = self._queues.get(t)
            if not q:
                # drained tenant leaves the rotation; banked deficit is
                # forfeit (DRR: no credit accrues while idle)
                self._order.pop(self._cursor)
                self._deficit.pop(t, None)
                self._granted = False
                if not self._order:
                    return None
                continue
            if not self._granted:
                self._deficit[t] += self.quantum * self.weight(t)
                self._granted = True
            item, cost = q[0]
            if cost <= self._deficit[t]:
                q.popleft()
                self._deficit[t] -= cost
                if not q:
                    self._order.pop(self._cursor)
                    self._deficit.pop(t, None)
                    self._granted = False
                return (t, item, cost)
            # head too pricey for this visit: next tenant, keep balance
            self._cursor += 1
            self._granted = False
        raise AssertionError("DRR rotation bound exceeded")  # unreachable
