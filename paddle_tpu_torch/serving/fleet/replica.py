"""Replica handles — the router's transport seam (port of the JAX
package's ``serving/fleet/replica.py``).

The :class:`FleetRouter` never touches an :class:`LLMEngine` directly;
it speaks the :class:`ReplicaHandle` verb set, which is deliberately
small and serializable-shaped (ids, token lists, plain dicts) so a
process-per-replica backend can implement the same verbs over an RPC
channel later without changing the router. :class:`InProcessReplica`
is the first backend: one engine per handle, same process.

Seam notes for a future remote backend:

* ``rng_state``/``add_request(rng_state=...)`` carry the request's
  sampling-stream state across the hand-off as the JAX package's
  composite dict — ``{"numpy": None, "device_key": [hi, lo]}``; the
  device key is what the engine's on-device sampler draws from, so a
  sampled request resumes bit-identically on the peer (the ``numpy``
  half, the JAX engine's host sampler's state, has no reader in the
  port and travels as None, which the JAX engine skips). A remote replica would ship it in the drain notification
  instead of being queried post-mortem;
* ``step()`` returning structured :class:`RequestOutput`\\ s (including
  drain/error aborts) is the only result channel — there is no
  callback registration across the seam;
* engine step failures are absorbed here (``alive`` flips False, the
  structured abort outputs are RETURNED, not raised) because a dead
  remote replica can't raise into the router either.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

from paddle_tpu_torch.serving.engine import EngineConfig, EngineStepError, LLMEngine
from paddle_tpu_torch.serving.request import RequestOutput, SamplingParams

__all__ = ["ReplicaHandle", "ReplicaLoad", "InProcessReplica"]


class ReplicaLoad:
    """One replica's dispatch signals, snapshotted at a step boundary."""

    def __init__(self, queue_depth: int = 0, num_running: int = 0,
                 waiting_tokens: int = 0, kv_utilization: float = 0.0):
        self.queue_depth = queue_depth
        self.num_running = num_running
        self.waiting_tokens = waiting_tokens
        self.kv_utilization = kv_utilization

    @property
    def occupancy(self) -> int:
        """Least-loaded tiebreak key: requests on the replica."""
        return self.queue_depth + self.num_running

    def as_dict(self) -> Dict[str, float]:
        return {"queue_depth": self.queue_depth,
                "num_running": self.num_running,
                "waiting_tokens": self.waiting_tokens,
                "kv_utilization": round(self.kv_utilization, 4)}


class ReplicaHandle:
    """The verbs the router needs from a replica. Implementations must
    keep every argument/return JSON-shaped (plus the composite RNG
    state dict) so the set can move onto a wire protocol unchanged."""

    replica_id: str
    alive: bool
    retiring: bool  # scale-down: drain, then detach once empty
    # True when the replica heartbeats the registry itself (a worker
    # process does); the router must not beat on its behalf, or a hung
    # worker would look alive forever
    self_heartbeat: bool = False
    # disaggregated-serving specialization: "prefill" | "decode" |
    # None (serves both). Advertised through the registry heartbeat so
    # a restarted handle re-learns it (see FleetRouter._health_sweep)
    role: Optional[str] = None
    # peer data plane: "host:port" of the replica's PeerListener, or
    # None when the replica has no direct channel — the router then
    # relays the bytes itself (the pre-peer path, kept as a ladder
    # rung). Advertised through the registry heartbeat like the role.
    peer_endpoint: Optional[str] = None

    # -- dispatch-side reads ---------------------------------------------
    def admission_verdict(self, prompt_tokens: int) -> Optional[str]:
        raise NotImplementedError

    def estimated_ttft_ms(self, prompt_tokens: int) -> Optional[float]:
        raise NotImplementedError

    def load(self) -> ReplicaLoad:
        raise NotImplementedError

    @property
    def is_draining(self) -> bool:
        raise NotImplementedError

    @property
    def drained(self) -> bool:
        raise NotImplementedError

    def has_unfinished(self) -> bool:
        raise NotImplementedError

    # -- request lifecycle -----------------------------------------------
    def add_request(self, request_id: str, prompt_ids: Sequence[int],
                    sampling: SamplingParams, *,
                    rng_state=None) -> None:
        raise NotImplementedError

    def abort_request(self, request_id: str) -> bool:
        raise NotImplementedError

    def release_request(self, request_id: str) -> None:
        raise NotImplementedError

    def rng_state(self, request_id: str):
        """Best-effort sampling-stream state for a hand-off; None when
        unavailable (request unknown, or the replica is unreachable)."""
        raise NotImplementedError

    def fence_request(self, request_id: str, gen: int) -> bool:
        """Replicated control plane: record that ``request_id`` is now
        driven at lease generation ``gen``. Returns False when the
        replica has already seen a HIGHER generation for this request —
        the caller is a stale owner and must drop the request locally
        without emitting (the same refusal a restarted worker's fencing
        gives a stale router's ``peer_commit``). Re-asserting the
        current generation returns True, so the call is idempotent and
        safe to retry. Replica-side state is a bounded recent-request
        table, not a durable ledger; the durable fence is the lease
        store's generation."""
        fences = self.__dict__.setdefault("_request_fences", {})
        cur = fences.get(request_id)
        if cur is not None and cur > int(gen):
            return False
        fences[request_id] = int(gen)
        while len(fences) > 256:  # bounded: oldest-inserted falls out
            fences.pop(next(iter(fences)))
        return True

    # -- fleet KV-ship (optional capability; default: unsupported) --------
    def export_kv(self, request_id: str):
        """(meta dict, payload bytes) packaging the request's committed
        KV blocks, or None when there is nothing to ship — the router
        then falls back to recompute."""
        return None

    def import_kv(self, request_id: str, prompt_ids: Sequence[int],
                  sampling: SamplingParams, *, meta: dict,
                  payload: bytes, rng_state=None) -> bool:
        """Admit a shipped-KV continuation; False on any clean
        rejection (the router falls back to recompute)."""
        return False

    # -- peer data plane (optional capability; default: unsupported) ------
    def park_kv(self, request_id: str) -> Optional[dict]:
        """Gather the request's committed KV to replica-local host
        memory so it survives the engine-side release and can be pushed
        (or relayed) later. Returns a small summary dict
        ({"bytes", "blocks", "tokens_covered"}) or None when
        unsupported/refused — the router then captures the bytes
        router-side as before."""
        return None

    def drop_parked(self, request_id: str) -> None:
        """Release a parked KV snapshot (transfer done or abandoned)."""

    def peer_send(self, ticket: dict, endpoint: str) -> Optional[dict]:
        """Push this replica's payload for ``ticket`` straight to the
        destination's peer listener. Returns a receipt summary dict on
        a staged delivery, None on any failure (dead rung)."""
        return None

    def peer_commit(self, ticket_id: str, *, kind: str = "kv",
                    request_id: Optional[str] = None,
                    prompt_ids: Optional[Sequence[int]] = None,
                    sampling: Optional[SamplingParams] = None,
                    rng_state=None) -> bool:
        """Commit a staged peer delivery into the engine; False when
        nothing is staged under ``ticket_id`` or the import is cleanly
        refused."""
        return False

    # -- tiered-KV sessions (optional capability; default: none) ----------
    def park_session(self, session_id: str) -> Optional[dict]:
        """Demote a finished session's cached KV chain to the host tier
        so the device pool frees up while the session stays resumable.
        Returns the session summary dict, or None when unsupported or
        the session is unknown (the router then treats it as cold)."""
        return None

    def resume_session(self, request_id: str, session_id: str,
                       prompt_ids: Sequence[int],
                       sampling: SamplingParams, *,
                       rng_state=None) -> Optional[int]:
        """Resume a parked session as a continuation request; returns
        the number of prompt tokens served from the session's cached
        chain, or None on any clean refusal (unknown session, prompt
        mismatch, draining) — the router falls back to a plain add."""
        return None

    def drop_session(self, session_id: str, *,
                     to_peer: bool = False) -> bool:
        """Forget a session record; ``to_peer=True`` also evicts its
        cached chain locally (the bytes now live on a peer)."""
        return False

    def adopt_session(self, session_id: str, tokens: Sequence[int],
                      covered: int, *, tenant: Optional[str] = None) -> bool:
        """Register a session record against prefix content that
        arrived over the peer plane; False when the content is not
        actually cached here (the adopt is dropped, resume recomputes)."""
        return False

    def tier_stats(self) -> Optional[dict]:
        """Tier occupancy/pressure snapshot, or None when the replica
        has no tiered KV store."""
        return None

    # -- fleet prefix cache (optional capability; default: none) ----------
    def prefix_digest(self) -> Optional[dict]:
        """Bounded advertisement of the replica's committed prefix trie
        ({"bs", "n", "h": {chain_hash: tokens}}), or None when the
        replica cannot advertise — the router then treats it as cold."""
        return None

    def export_prefix(self, chain_hash: str):
        """(meta dict, payload bytes) packaging one advertised cached
        prefix, or None when the hash is no longer resolvable (evicted
        since advertisement — the router just drops the ship)."""
        return None

    def import_prefix(self, *, meta: dict, payload: bytes) -> bool:
        """Commit a shipped prefix into the local cache with no request
        attached; False on any clean rejection (no room without
        eviction, geometry/checksum mismatch — the ship is dropped,
        requests landing here simply prefill)."""
        return False

    # -- stepping / drain -------------------------------------------------
    def step(self) -> List[RequestOutput]:
        raise NotImplementedError

    def start_drain(self, reason: str = "manual") -> List[RequestOutput]:
        raise NotImplementedError


class InProcessReplica(ReplicaHandle):
    """One :class:`LLMEngine` behind the handle seam, same process.

    Pass ``monitor`` (a
    :class:`~paddle_tpu_torch.distributed.watchdog.PreemptionMonitor`) to give
    THIS replica its own preemption signal — fleet tests drain one
    replica of a pair by calling ``monitor.request()``; a real
    deployment shares the process-global monitor across co-resident
    replicas (SIGTERM preempts the host, not one engine). At
    ``tp_degree`` k > 1 the engine starts its k - 1 worker ranks with
    the replica and shuts them down when it goes; its ships carry k
    frames."""

    def __init__(self, model, config: Optional[EngineConfig] = None,
                 replica_id: Optional[str] = None, monitor=None,
                 role: Optional[str] = None):
        self.replica_id = replica_id or f"replica-{id(self):x}"
        self.engine = LLMEngine(model, config)
        self.alive = True
        self.retiring = False
        self.role = role
        self.created_at = time.monotonic()
        # peer data plane: host-side KV snapshots parked for a ticketed
        # transfer (survive engine-side release), plus the listener that
        # stages inbound peer deliveries. Single-threaded access: only
        # the service/router thread touches _parked; the listener's own
        # accept thread never reaches in here.
        self._parked: Dict[str, tuple] = {}
        self._peer = None
        if monitor is not None:
            self.engine.install_preemption_handler(monitor)

    # -- dispatch-side reads ---------------------------------------------
    def admission_verdict(self, prompt_tokens: int) -> Optional[str]:
        if not self.alive:
            return "replica is dead"
        if self.engine.is_draining:
            return "replica is draining"
        return self.engine.admission.verdict(
            self.engine, prompt_tokens=prompt_tokens)

    def estimated_ttft_ms(self, prompt_tokens: int) -> Optional[float]:
        eng = self.engine
        return eng.metrics.estimated_ttft_ms(
            eng.scheduler.num_waiting,
            queued_prefill_tokens=eng.scheduler.num_waiting_tokens,
            prompt_tokens=prompt_tokens,
            tokens_per_step=eng.cfg.max_batched_tokens)

    def load(self) -> ReplicaLoad:
        sched = self.engine.scheduler
        return ReplicaLoad(
            queue_depth=sched.num_waiting,
            num_running=sched.num_running + sched.num_swapped,
            waiting_tokens=sched.num_waiting_tokens,
            kv_utilization=self.engine.block_manager.utilization())

    @property
    def is_draining(self) -> bool:
        return self.engine.is_draining

    @property
    def drained(self) -> bool:
        return self.engine.drained

    def has_unfinished(self) -> bool:
        return self.alive and self.engine.has_unfinished()

    # -- request lifecycle -----------------------------------------------
    def add_request(self, request_id: str, prompt_ids: Sequence[int],
                    sampling: SamplingParams, *, rng_state=None) -> None:
        self.engine.add_request(request_id, list(prompt_ids),
                                sampling=sampling, rng_state=rng_state)

    def abort_request(self, request_id: str) -> bool:
        return self.engine.abort_request(request_id)

    def release_request(self, request_id: str) -> None:
        try:
            self.engine.release_request(request_id)
        except (KeyError, ValueError):
            pass  # already released, or still in flight on a dead engine

    def rng_state(self, request_id: str):
        try:
            req = self.engine.get_request(request_id)
        except KeyError:
            return None
        return {"numpy": None,
                "device_key": [int(req.device_key[0]),
                               int(req.device_key[1])]}

    # -- fleet KV-ship -----------------------------------------------------
    def export_kv(self, request_id: str):
        if not self.alive:
            return None
        parked = self._parked.get(request_id)
        if parked is not None:
            return parked  # survives release; the router-relay rung
        return self.engine.export_kv(request_id)

    def import_kv(self, request_id: str, prompt_ids: Sequence[int],
                  sampling: SamplingParams, *, meta: dict,
                  payload: bytes, rng_state=None) -> bool:
        if not self.alive:
            return False
        try:
            self.engine.import_kv(request_id, list(prompt_ids),
                                  sampling=sampling, meta=meta,
                                  payload=payload, rng_state=rng_state)
            return True
        except ValueError:
            return False

    # -- peer data plane ---------------------------------------------------
    def start_peer(self) -> str:
        """Open this replica's peer listener (idempotent) and return
        its endpoint. Workers call this at boot; in-process fleets and
        tests opt in per replica."""
        if self._peer is None:
            from paddle_tpu_torch.serving.fleet.transport import PeerListener
            self._peer = PeerListener()
            self.peer_endpoint = self._peer.endpoint
        return self.peer_endpoint

    def close_peer(self) -> None:
        if self._peer is not None:
            self._peer.close()
            self._peer = None
            self.peer_endpoint = None

    @property
    def peer_listener(self):
        return self._peer

    def park_kv(self, request_id: str) -> Optional[dict]:
        if not self.alive:
            return None
        res = self.export_kv(request_id)
        if res is None:
            return None
        meta, payload = res
        self._parked[request_id] = (meta, payload)
        while len(self._parked) > 16:  # bounded host-memory stash
            self._parked.pop(next(iter(self._parked)))
        return {"bytes": len(payload),
                "blocks": int(meta.get("blocks", 0)),
                "tokens_covered": int(meta.get("tokens_covered", 0)),
                "layout": meta.get("layout")}

    def drop_parked(self, request_id: str) -> None:
        self._parked.pop(request_id, None)

    def peer_send(self, ticket: dict, endpoint: str) -> Optional[dict]:
        if not self.alive:
            return None
        kind = ticket.get("kind", "kv")
        if kind == "prefix":
            res = self.export_prefix(ticket.get("chain_hash"))
        else:
            res = self.export_kv(ticket.get("request_id"))
        if res is None:
            return None
        meta, payload = res
        from paddle_tpu_torch.serving.fleet.transport import peer_push
        timeout_s = max(0.05, float(ticket.get("deadline_ms", 30e3)) / 1e3)
        try:
            receipt = peer_push(endpoint, ticket, meta, payload,
                                timeout_s=timeout_s)
        except (OSError, ValueError):
            return None
        if not receipt.get("ok"):
            return None
        return {"bytes": len(payload),
                "blocks": int(meta.get("blocks", 0)),
                "tokens_covered": int(meta.get("tokens_covered", 0)),
                "tokens": len(meta.get("tokens") or ()),
                "layout": meta.get("layout")}

    def peer_commit(self, ticket_id: str, *, kind: str = "kv",
                    request_id: Optional[str] = None,
                    prompt_ids: Optional[Sequence[int]] = None,
                    sampling: Optional[SamplingParams] = None,
                    rng_state=None) -> bool:
        if not self.alive or self._peer is None:
            return False
        ent = self._peer.take(ticket_id)
        if ent is None:
            return False  # never delivered / already committed / GC'd
        ticket, meta, payload = ent
        if ticket.get("kind", kind) == "prefix":
            return self.import_prefix(meta=meta, payload=payload)
        if request_id is None or sampling is None:
            return False
        return self.import_kv(request_id, list(prompt_ids or []),
                              sampling, meta=meta, payload=payload,
                              rng_state=rng_state)

    # -- tiered-KV sessions ------------------------------------------------
    def park_session(self, session_id: str) -> Optional[dict]:
        if not self.alive:
            return None
        try:
            return self.engine.park_session(session_id)
        except ValueError:
            return None  # engine is not tiered

    def resume_session(self, request_id: str, session_id: str,
                       prompt_ids: Sequence[int],
                       sampling: SamplingParams, *,
                       rng_state=None) -> Optional[int]:
        if not self.alive:
            return None
        try:
            return self.engine.resume_session(
                request_id, session_id, list(prompt_ids),
                sampling=sampling, rng_state=rng_state)
        except ValueError:
            return None

    def drop_session(self, session_id: str, *,
                     to_peer: bool = False) -> bool:
        if not self.alive:
            return False
        try:
            return self.engine.drop_session(session_id, to_peer=to_peer)
        except ValueError:
            return False

    def adopt_session(self, session_id: str, tokens: Sequence[int],
                      covered: int, *, tenant: Optional[str] = None) -> bool:
        if not self.alive:
            return False
        try:
            return self.engine.adopt_session(session_id, list(tokens),
                                             covered, tenant=tenant)
        except ValueError:
            return False

    def tier_stats(self) -> Optional[dict]:
        if not self.alive:
            return None
        try:
            return self.engine.tier_stats()
        except ValueError:
            return None

    # -- fleet prefix cache ------------------------------------------------
    def prefix_digest(self) -> Optional[dict]:
        if not self.alive:
            return None
        return self.engine.prefix_digest()

    def export_prefix(self, chain_hash: str):
        if not self.alive:
            return None
        return self.engine.export_prefix(chain_hash)

    def import_prefix(self, *, meta: dict, payload: bytes) -> bool:
        if not self.alive:
            return False
        try:
            self.engine.import_prefix(meta=meta, payload=payload)
            return True   # 0 committed (already cached) is success too
        except ValueError:
            return False

    # -- stepping / drain -------------------------------------------------
    def step(self) -> List[RequestOutput]:
        if not self.alive:
            return []
        if self._peer is not None:
            self._peer.gc()  # orphan-ticket sweep rides the step cadence
        try:
            return self.engine.step()
        except EngineStepError as e:
            # the engine already drained itself and attached structured
            # aborts; across the seam a dead replica returns its last
            # outputs rather than raising into the router
            self.alive = False
            return e.outputs

    def start_drain(self, reason: str = "manual") -> List[RequestOutput]:
        if not self.alive:
            return []
        return self.engine.start_drain(reason)

    def snapshot(self) -> Dict[str, float]:
        return self.engine.metrics.snapshot()

    def tp_report(self) -> Optional[dict]:
        """At ``tp_degree`` k > 1: the worker ranks' pids and each rank's
        K1 and K2 launches so far (rank 0's counted in this process) and
        peak device memory. None at k = 1."""
        tp = getattr(self.engine, "_tp", None)
        if tp is None:
            return None
        import torch

        from paddle_tpu_torch.ops import flash_attention as fa
        from paddle_tpu_torch.ops import ragged_paged_attention as rpa

        dev = self.engine.device
        peak = 0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            peak = int(torch.cuda.max_memory_allocated(dev))
        ranks = [{"rank": 0, "k1_launches": int(rpa.launches),
                  "k2_launches": int(fa.launches["flash_attention_fwd"]),
                  "max_memory_allocated": peak}] + tp.report()
        return {"pids": [p.pid for p in tp._procs], "ranks": ranks}
