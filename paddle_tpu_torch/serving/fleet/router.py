"""FleetRouter — SLO-aware multi-replica dispatch with drain hand-off (port
of the JAX package's ``serving/fleet/router.py``, array-free and copied).

The front end above :class:`~paddle_tpu_torch.serving.LLMEngine`: clients
talk to the router, the router owns a set of replica handles and

* **dispatches** each request to the replica with the best estimated
  TTFT (the per-engine :class:`AdmissionController` estimator, prompt-
  length-aware), falling back to least-loaded while estimates are cold;
* **admits fleet-wide**: a request is rejected only when EVERY
  dispatchable replica's admission verdict rejects it — one overloaded
  replica sheds to its peers instead of to the client;
* **is fair across tenants**: requests queue per ``tenant_id`` and
  dispatch in weighted deficit-round-robin order (:class:`TenantQueue`),
  so one tenant's burst cannot starve the others;
* **hands off on drain/death**: when a replica drains (SIGTERM /
  preemption through the engine's drain) or dies mid-step, its unfinished
  requests re-enqueue on a peer and resume by recompute —
  token-identical to an uninterrupted run (the sampling-stream state
  rides along) — and the client never sees the abort. The engine's
  ``aborted:drain`` / ``aborted:error`` outputs surface only when no
  peer exists (the single-replica behavior, unchanged);
* **tracks liveness** through a store-backed
  :class:`~paddle_tpu_torch.distributed.replica_registry.ReplicaRegistry`:
  replicas heartbeat via the router while in-process; a replica whose
  record goes stale is treated as dead and its requests re-enqueued.

Fault points (``PADDLE_FAULTS`` flag faults, queried once per router
step — the arg selects a replica by id or index, empty = first alive):

=====================  ==================================================
``fleet.kill_replica``  mark the replica dead without drain outputs —
                        the harshest loss mode; recovery runs entirely
                        from router-side bookkeeping
``fleet.drain_replica`` start a graceful drain on the replica (the
                        SIGTERM path, minus the signal)
``fleet.slow_replica``  sleep ``arg`` seconds in the router step —
                        models a straggling replica stalling the loop
``fleet.worker_kill``   SIGKILL the replica's worker PROCESS (handles
                        with a ``hard_kill``, i.e. subprocess/loopback
                        transports). Unlike ``kill_replica`` the router
                        does no bookkeeping here — death must be
                        DETECTED (process exit / connection EOF /
                        heartbeat TTL), which is what the fault exists
                        to exercise
=====================  ==================================================

The transport adds two client-side points (see ``transport.py``):
``fleet.rpc_delay`` (stall a call against its deadline) and
``fleet.rpc_drop`` (lose a frame; idempotent calls retry, mutations
surface as replica death).

KV-ship fault points (disaggregated serving — queried at each ship):

=========================  ==============================================
``fleet.kv_ship_delay``     sleep ``arg`` seconds before the export —
                            models a slow transfer link
``fleet.kv_ship_drop``      lose the exported payload; the router falls
                            back to resume-by-recompute on the peer
``fleet.kv_ship_corrupt``   flip a byte in the payload; the import
                            side's CRC check rejects it and the router
                            falls back to recompute — the request is
                            never duplicated or lost either way
=========================  ==============================================

Peer data plane: with ``peer_data_plane`` on (the default)
KV payloads move worker→worker instead of twice through the router.
The source PARKS the gathered bytes host-side at ship time; at the
next dispatch the router issues a small signed ticket and walks a
degradation ladder — peer-push → router-relay (the pre-peer path,
kept) → recompute — with exactly one counted outcome per ticket
(``ticket_outcomes``) and per-rung deadlines carved from the request's
remaining deadline budget. The transport adds four peer fault points
(``fleet.peer_{connect_fail,send_drop,frame_corrupt,stall}``) that
fire inside the source's push, driving the ladder down a rung.

Replicated control plane: pass ``lease_store`` (and a
``router_id``) to run N routers over ONE shared registry store. Three
invariants carry the whole design:

* **partitioning** — replicas are partitioned across the live routers
  by rendezvous hashing over their ids (``_steps_replica``), so every
  engine is stepped/heartbeaten/dispatched-to by exactly one router;
  tenants are partitioned the same way client-side
  (:func:`~paddle_tpu_torch.serving.fleet.tenant.tenant_home`). Both views
  derive from the router registry (prefix ``fleet_routers``, TTL
  ``router_ttl_s`` — much shorter than the replica TTL, so an adopter
  starts beating inherited replicas before their records expire);
* **renew-before-emit** — the owner renews each request's lease (with
  the new progress and RNG state) BEFORE emitting those tokens; a
  failed renew means fenced, and the only reaction is to self-fence
  (abort the engine copy, emit nothing). The committed progress is
  therefore always >= what the client saw, so an adopter resuming
  from it can never duplicate a token position;
* **generation fencing** — adoption bumps the lease generation, and
  replicas remember the highest generation per request
  (``fence_request``), so a stale router's late dispatch is refused
  the same way a restarted worker refuses a stale ``peer_commit``.

Replicated fault points (KEYED — see ``faults.check(key=...)``):
``fleet.router_kill:flag:<router_id>`` (this router goes silent in
place at its next step — in-process SIGKILL),
``fleet.lease_expire:flag:<rid>`` (one renewal write dropped AND
failed, forcing a self-fence and a peer's expired-lease recompute),
``fleet.lease_steal:flag[:<rid>]`` (the adoption sweep force-adopts a
live foreign lease — the expiry race without the TTL wait).
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set

from paddle_tpu_torch.distributed.replica_registry import ReplicaRegistry
from paddle_tpu_torch.serving.block_manager import prefix_chain_hashes
from paddle_tpu_torch.serving.fleet.lease import LeaseStore, rendezvous_owner
from paddle_tpu_torch.serving.fleet.metrics import FleetMetrics
from paddle_tpu_torch.serving.fleet.replica import ReplicaHandle
from paddle_tpu_torch.serving.fleet.tenant import TenantQueue
from paddle_tpu_torch.serving.request import RequestOutput, SamplingParams
from paddle_tpu_torch.testing import faults

__all__ = ["FleetConfig", "FleetRouter"]

# terminal reasons that mean "the replica failed the request", not
# "the request failed" — these hand off to a peer when one exists
HANDOFF_REASONS = ("aborted:drain", "aborted:error")


@dataclass
class FleetConfig:
    """Router knobs. ``handoff=False`` degrades to one engine's drain
    semantics on every replica (aborts surface to the client)."""

    # None = adaptive: the DRR quantum tracks the mean observed request
    # cost, so one visit grants roughly one typical request regardless
    # of traffic shape; an int pins the granularity explicitly
    tenant_quantum_tokens: Optional[int] = None
    tenant_weights: Optional[Dict[str, float]] = None
    heartbeat_interval_s: float = 0.0   # 0 = every router step
    registry_ttl_s: float = 30.0
    handoff: bool = True
    # a request that keeps landing on dying replicas eventually surfaces
    # its abort rather than bouncing forever
    max_handoffs: int = 8
    # disaggregated serving: replica_id -> "prefill" | "decode". New
    # requests dispatch to prefill-role replicas; on prefill completion
    # the committed KV blocks SHIP to a decode-role replica instead of
    # being recomputed there. Replicas absent from the map (and fleets
    # with roles=None) serve both phases. Role preference, not quota:
    # when no replica of the wanted role is dispatchable, any replica
    # takes the request — availability beats purity
    roles: Optional[Dict[str, str]] = None
    # fleet-global prefix cache: score dispatch by estimated TTFT of
    # the UNMATCHED prompt suffix (advertised cached-prefix tokens are
    # credited at the replica's own prefill-rate model), and
    # proactively ship prefixes that keep matching dispatches
    # (prefix_ship_threshold hits) to cold replicas, at most
    # max_prefix_ships_per_step per router step. Advertisements decay
    # linearly to zero over prefix_decay_s of heartbeat age — a stale
    # advert is worth nothing, and landing on it just prefills
    prefix_affinity: bool = True
    prefix_ship: bool = True
    prefix_ship_threshold: int = 3
    max_prefix_ships_per_step: int = 1
    prefix_decay_s: float = 10.0
    # peer data plane: ticketed worker→worker KV transfers with the
    # router as pure control plane. False pins every transfer to the
    # router-relay path (the pre-peer behavior — also the bench
    # comparison baseline). peer_deadline_s caps each ladder rung's
    # deadline; a request with its own deadline budget gets the
    # smaller of the cap and a third of what remains (leaving room
    # for the relay and recompute rungs below)
    peer_data_plane: bool = True
    peer_deadline_s: float = 30.0
    # tiered KV: when set, a holder whose host tier is past this
    # pressure fraction offloads one parked session per router step to
    # the least-pressured peer over the prefix ticket ladder (peer-push
    # → router-relay → stay-home), flipping the session record to the
    # adopter. None = parked sessions stay on their holder (single-node
    # tiering still works; a dead holder degrades resume to recompute)
    tier_offload_watermark: Optional[float] = None
    # replicated control plane: liveness TTL for ROUTER records (prefix
    # "fleet_routers" in the shared store) and for request leases. The
    # router TTL must be well under registry_ttl_s: replica ownership
    # flips when a router's record goes stale, and the adopter must
    # start beating the inherited replicas before THEIR records expire
    router_ttl_s: float = 2.0
    lease_ttl_s: float = 3.0

    def __post_init__(self):
        if self.heartbeat_interval_s < 0:
            raise ValueError("heartbeat_interval_s must be >= 0")
        if self.router_ttl_s <= 0:
            raise ValueError("router_ttl_s must be > 0")
        if self.lease_ttl_s <= 0:
            raise ValueError("lease_ttl_s must be > 0")
        if self.peer_deadline_s <= 0:
            raise ValueError("peer_deadline_s must be > 0")
        if self.max_handoffs < 0:
            raise ValueError("max_handoffs must be >= 0")
        if self.prefix_ship_threshold < 1:
            raise ValueError("prefix_ship_threshold must be >= 1")
        if self.max_prefix_ships_per_step < 0:
            raise ValueError("max_prefix_ships_per_step must be >= 0")
        if self.prefix_decay_s <= 0:
            raise ValueError("prefix_decay_s must be > 0")
        if self.tier_offload_watermark is not None and not (
                0.0 < self.tier_offload_watermark <= 1.0):
            raise ValueError(
                "tier_offload_watermark must be in (0, 1]")
        if self.roles:
            bad = {r for r in self.roles.values()
                   if r not in ("prefill", "decode")}
            if bad:
                raise ValueError(
                    f"roles values must be 'prefill' or 'decode', "
                    f"got {sorted(bad)!r}")


@dataclass
class _FleetRequest:
    """Router-side bookkeeping for one client request. ``progress`` is
    the full generated-token list observed so far (across replicas);
    ``base_generated`` is the prefix produced before the current
    dispatch — a hand-off folds ``progress`` into it and re-prompts the
    peer with prompt+prefix (resume by recompute)."""

    request_id: str
    prompt_ids: List[int]
    sampling: SamplingParams
    callback: Optional[Callable]
    arrival: float
    deadline_abs: Optional[float]
    tenant: str
    cost: int
    base_generated: List[int] = field(default_factory=list)
    progress: List[int] = field(default_factory=list)
    rng_state: Optional[dict] = None
    # (meta, payload) of shipped KV riding to the next dispatch; the
    # bytes live router-side, so the payload survives the SOURCE
    # replica dying while the request waits in the queue
    kv: Optional[tuple] = None
    # peer data plane: replica that PARKED this request's KV host-side
    # at ship time — the bytes stay at the source and move worker→
    # worker (or router-relay) when the next dispatch runs the ticket
    # ladder. Mutually exclusive with ``kv`` (which is the drain
    # piggyback / relay-capture path)
    ship_src: Optional[str] = None
    # set once the request's prefill completed on a prefill-role
    # replica: from then on it belongs on the decode side, WITH the
    # shipped KV or (fallback) by recompute there — re-prefilling on
    # the prefill side would re-ship and a permanently failing ship
    # would bounce forever
    decode_bound: bool = False
    # tiered-KV resume: the parked session this request continues —
    # dispatch prefers the replica holding the session's KV and admits
    # through ``resume_session`` (zero prompt recompute); a dead holder
    # or evicted chain degrades to a plain re-prefilling dispatch
    session: Optional[str] = None
    replica_id: Optional[str] = None
    dispatch_t: Optional[float] = None
    dispatches: int = 0
    handoffs: int = 0
    rejects: int = 0
    finished: bool = False
    finish_reason: Optional[str] = None
    # replicated control plane: the fencing generation of this
    # request's store lease (None until first dispatch, and always
    # None in single-router mode)
    lease_gen: Optional[int] = None

    @property
    def generated(self) -> List[int]:
        return list(self.progress)


class FleetRouter:
    def __init__(self, replicas: Sequence[ReplicaHandle],
                 config: Optional[FleetConfig] = None,
                 registry: Optional[ReplicaRegistry] = None, *,
                 lease_store: Optional[LeaseStore] = None,
                 router_id: Optional[str] = None):
        self.cfg = config or FleetConfig()
        self.registry = registry if registry is not None else \
            ReplicaRegistry(ttl_s=self.cfg.registry_ttl_s)
        # replicated control plane (module docstring): None = classic
        # single-router mode, byte-identical behavior to before
        self.lease_store = lease_store
        self.router_id = router_id or \
            f"router-{os.getpid():x}-{id(self) & 0xFFFF:x}"
        self.router_dead = False    # fleet.router_kill fired: silent
        self.partitioned = False    # chaos knob: frozen, no store I/O
        self.router_registry: Optional[ReplicaRegistry] = None
        self._routers_view: List[str] = [self.router_id]
        self._failed_routers: Set[str] = set()
        self._sync_step = 0
        self.num_router_failovers = 0
        self.num_requests_fenced = 0
        self.num_requests_handed_over = 0
        if lease_store is not None:
            self.router_registry = ReplicaRegistry(
                self.registry.store, prefix="fleet_routers",
                ttl_s=self.cfg.router_ttl_s)
            self.router_registry.heartbeat(self.router_id)
        self.replicas: List[ReplicaHandle] = []
        self._assigned: Dict[str, Set[str]] = {}
        self._queue = TenantQueue(
            quantum_tokens=self.cfg.tenant_quantum_tokens,
            weights=self.cfg.tenant_weights)
        self._requests: Dict[str, _FleetRequest] = {}
        self._open: Dict[str, _FleetRequest] = {}
        self._pending_outputs: List[RequestOutput] = []
        self._auto_id = itertools.count()
        self._last_hb: Optional[float] = None
        self._dead_counted: Set[str] = set()
        self.start_time = time.monotonic()
        # lifetime counters (surfaced as fleet/* profiler gauges)
        self.num_dispatched = 0
        self.num_handoffs = 0
        self.num_handoff_exhausted = 0
        self.num_rejected_fleetwide = 0
        self.num_replicas_dead = 0
        self.num_scale_ups = 0
        self.num_scale_downs = 0
        self.num_autoscale_decisions = 0
        self.num_tokens_emitted = 0
        # KV-ship accounting (disaggregated serving). kv_ship_* stays
        # the AGGREGATE successful-transfer view (peer or relay alike);
        # the peer data plane splits it below
        self.num_kv_ship_requests = 0
        self.num_kv_ship_blocks = 0
        self.num_kv_ship_bytes = 0
        self.kv_ship_time_s = 0.0
        self.num_recompute_fallbacks = 0
        self.num_tokens_recomputed = 0
        # peer data plane: per-ticket outcome partition (exactly one
        # outcome per issued ticket — the accounting invariant tests
        # pin is sum(ticket_outcomes.values()) == num_tickets_issued),
        # plus the peer/relay byte split. relay_bytes counts every KV
        # payload byte that crossed the ROUTER process (drain
        # piggybacks, relay rungs, prefix relays) — zero in a steady
        # peer-plane fleet
        self.num_tickets_issued = 0
        self.ticket_outcomes: Dict[str, int] = {
            "peer": 0, "relay": 0, "recompute": 0, "cold": 0}
        self.num_peer_ship_requests = 0
        self.num_peer_ship_blocks = 0
        self.num_peer_ship_bytes = 0
        self.num_relay_fallbacks = 0
        self.num_relay_bytes = 0
        self.num_ship_skipped_expired = 0
        self._ticket_seq = itertools.count()
        # fleet-global prefix cache: eventually-consistent adverts
        # (replica_id -> last heartbeat digest), per-prefix dispatch
        # hit counts, and the recent-ship cooldown table
        self._adverts: Dict[str, dict] = {}
        self._prefix_hot: Dict[str, dict] = {}
        self._shipped: Dict[tuple, float] = {}
        self.num_prefix_hit_tokens = 0
        self.num_prefix_affine_dispatches = 0
        self.num_prefix_ships = 0
        self.num_prefix_ship_bytes = 0
        self.num_prefix_ship_failures = 0
        # tiered-KV sessions: router-side view of parked sessions
        # (session_id -> holder/tokens/covered/chain_hash/tenant) —
        # drives resume affinity and the pressure-offload sweep
        self._sessions: Dict[str, dict] = {}
        self.num_session_parks = 0
        self.num_session_resumes = 0
        self.num_session_resume_recomputes = 0
        self.num_session_hit_tokens = 0
        self.num_session_offloads = 0
        # client-visible terminal histogram (the fleet-level aggregate:
        # per-replica engines keep their own serving/finish/* view,
        # which double-counts handed-off attempts by design)
        self.finish_counts: Dict[str, int] = {}
        self.tenant_wait_s: Dict[str, List[float]] = {}
        # per-tenant dispatch gauges: lifetime counts (observability)
        # plus a since-last-poll window that tenant_load() consumes —
        # the window makes a one-tenant burst visible to the autoscale
        # policy even when the fleet-MEAN load it thresholds on stays
        # flat (every dispatch is counted, continuations included)
        self.tenant_dispatches: Dict[str, int] = {}
        self._tenant_window: Dict[str, int] = {}
        for h in replicas:
            self.attach_replica(h)
        self.metrics = FleetMetrics(self)

    # -- replica set ------------------------------------------------------
    def attach_replica(self, handle: ReplicaHandle) -> None:
        if any(h.replica_id == handle.replica_id for h in self.replicas):
            raise ValueError(
                f"duplicate replica id {handle.replica_id!r}")
        self.replicas.append(handle)
        self._assigned.setdefault(handle.replica_id, set())
        if self.cfg.roles and getattr(handle, "role", None) is None:
            handle.role = self.cfg.roles.get(handle.replica_id)
        self.registry.register(handle.replica_id)

    def retire_replica(self, handle: ReplicaHandle,
                       reason: str = "scale-down") -> None:
        """Begin removing a replica: graceful drain now, detach once
        empty. Its drain aborts flow through the normal hand-off path,
        so in-flight requests migrate to peers invisibly."""
        handle.retiring = True
        for out in handle.start_drain(reason):
            self._handle_output(handle, out, self._pending_outputs)

    def kill_replica(self, replica_id: str, why: str = "killed",
                     outputs: Optional[List[RequestOutput]] = None) -> None:
        """Hard replica loss: no drain outputs, no engine cooperation.
        Every request assigned to it re-enqueues from router-side
        bookkeeping (or surfaces ``aborted:error`` when no peer is
        left)."""
        handle = self._by_id(replica_id)
        if handle is None:
            return
        outs = self._pending_outputs if outputs is None else outputs
        stranded = self._assigned.get(replica_id, set())
        if replica_id not in self._dead_counted:
            self._dead_counted.add(replica_id)
            self.num_replicas_dead += 1
        handle.alive = False
        self.registry.deregister(replica_id)
        # sessions parked on the corpse are gone with it: resumes for
        # them degrade to recompute instead of chasing a dead holder
        for sid in [s for s, rec in self._sessions.items()
                    if rec.get("holder") == replica_id]:
            self._sessions.pop(sid, None)
        frs = sorted((self._open[rid] for rid in stranded
                      if rid in self._open), key=lambda fr: fr.arrival)
        self._assigned[replica_id] = set()
        # re-enqueue at the FRONT preserving arrival order (reversed:
        # each push_front lands ahead of the previous)
        for fr in reversed(frs):
            if self.lease_store is None or self._steps_replica(handle):
                # a replica we still own can only have been stepped by
                # us, so its (cached) rng state matches our emissions;
                # a DISOWNED one may have been stepped past them by its
                # new owner — keep the emit-committed fr.rng_state
                state = handle.rng_state(fr.request_id)
                if state is not None:
                    fr.rng_state = state
            if (self.lease_store is not None
                    and fr.lease_gen is not None
                    and not self.lease_store.renew(
                        fr.request_id, self.router_id, fr.lease_gen,
                        progress=list(fr.progress),
                        base=list(fr.progress), rng=fr.rng_state)):
                # fenced while committing the recovery point: a peer
                # owns the request — drop it without re-enqueueing
                self._fence_local(fr)
                continue
            if (self.cfg.handoff and fr.handoffs < self.cfg.max_handoffs
                    and self._has_peer(handle)):
                self._requeue(fr)
                self.num_handoffs += 1
            else:
                if (self.cfg.handoff
                        and fr.handoffs >= self.cfg.max_handoffs):
                    self.num_handoff_exhausted += 1
                self._finalize(fr, "aborted:error", None, outs)

    def dispatchable(self) -> List[ReplicaHandle]:
        return [h for h in self.replicas
                if h.alive and not h.retiring and not h.is_draining]

    def _by_id(self, replica_id: str) -> Optional[ReplicaHandle]:
        for h in self.replicas:
            if h.replica_id == replica_id:
                return h
        return None

    def _has_peer(self, excluding: ReplicaHandle) -> bool:
        return any(h is not excluding for h in self.dispatchable())

    # -- client API -------------------------------------------------------
    def add_request(self, request_id=None,
                    prompt_ids: Sequence[int] = None,
                    sampling: Optional[SamplingParams] = None,
                    callback: Optional[Callable] = None) -> str:
        """Admit a request fleet-wide. Argument forms mirror
        ``LLMEngine.add_request`` (id optional, prompt-first). Rejected
        only when EVERY dispatchable replica's verdict rejects — the
        terminal ``finish_reason='rejected'`` output is emitted from
        the next :meth:`step`, like the engine's."""
        if isinstance(prompt_ids, SamplingParams):
            if sampling is not None:
                raise TypeError("sampling passed twice")
            prompt_ids, sampling = None, prompt_ids
        if prompt_ids is None:
            request_id, prompt_ids = None, request_id
        if request_id is None:
            request_id = f"fleet-{next(self._auto_id)}"
        if request_id in self._requests:
            raise ValueError(f"duplicate request id {request_id!r}")
        sampling = sampling or SamplingParams()
        prompt = [int(t) for t in prompt_ids]
        now = time.monotonic()
        fr = _FleetRequest(
            request_id=request_id, prompt_ids=prompt, sampling=sampling,
            callback=callback, arrival=now,
            deadline_abs=(None if sampling.deadline_ms is None
                          else now + sampling.deadline_ms / 1e3),
            tenant=sampling.tenant_id,
            cost=len(prompt) + sampling.max_new_tokens)
        self._requests[request_id] = fr
        self._open[request_id] = fr
        live = self._own_dispatchable()
        if self.lease_store is not None and not live:
            # a router that currently owns no replica still admits for
            # the FLEET: the dispatch pass hands the request over to a
            # peer through an orphan lease (see _hand_over)
            live = self.dispatchable()
        verdicts = [h.admission_verdict(len(prompt)) for h in live]
        if not live or all(v is not None for v in verdicts):
            self.num_rejected_fleetwide += 1
            self._finalize(fr, "rejected", None, self._pending_outputs)
            return request_id
        self._queue.push(fr.tenant, request_id, fr.cost)
        return request_id

    def abort_request(self, request_id: str) -> bool:
        fr = self._open.get(request_id)
        if fr is None:
            return False
        if fr.replica_id is not None:
            h = self._by_id(fr.replica_id)
            if h is not None and h.alive:
                h.abort_request(request_id)
                h.release_request(request_id)
            # unassign even when the handle is dead, or the health
            # sweep keeps "recovering" the corpse every pass for a
            # request the client already gave up on
            self._assigned.get(fr.replica_id, set()).discard(request_id)
        self._finalize(fr, "aborted:user", None, self._pending_outputs)
        return True

    def get_request(self, request_id: str) -> _FleetRequest:
        return self._requests[request_id]

    def release_request(self, request_id: str) -> Optional[_FleetRequest]:
        fr = self._requests.get(request_id)
        if fr is None:
            return None
        if not fr.finished:
            raise ValueError(f"request {request_id!r} is not finished")
        return self._requests.pop(request_id)

    def has_unfinished(self) -> bool:
        return bool(self._open) or bool(self._pending_outputs)

    # -- tiered-KV sessions (park / resume) -------------------------------
    def park_session(self, session_id: str) -> Optional[dict]:
        """Park a finished request's KV chain fleet-wide: the holding
        replica demotes it to its host tier (the engine captured the
        session at finish, so this works after the terminal output and
        after ``release_request``). Returns the holder's summary dict,
        or None when no live replica knows the session. Idempotent."""
        rec = self._sessions.get(session_id)
        tokens = rec.get("tokens") if rec else None
        holders: List[ReplicaHandle] = []
        if rec is not None:
            h = self._by_id(rec["holder"])
            if h is not None:
                holders.append(h)
        fr = self._requests.get(session_id)
        if not holders and fr is not None and fr.replica_id is not None:
            h = self._by_id(fr.replica_id)
            if h is not None:
                holders.append(h)
            tokens = list(fr.prompt_ids) + list(fr.progress)
        if not holders:
            holders = list(self.replicas)  # released: probe the fleet
        for h in holders:
            if not h.alive:
                continue
            info = h.park_session(session_id)
            if info is None:
                continue
            if session_id not in self._sessions:
                self.num_session_parks += 1
            self._sessions[session_id] = {
                "holder": h.replica_id, "tokens": tokens,
                "covered": int(info.get("tokens_covered", 0)),
                "chain_hash": info.get("chain_hash"),
                "tenant": info.get("tenant")}
            return info
        return None

    def resume_session(self, session_id: str,
                       prompt_ids: Sequence[int],
                       sampling: Optional[SamplingParams] = None,
                       callback: Optional[Callable] = None,
                       request_id: Optional[str] = None) -> str:
        """Admit a continuation of a parked (or just-finished) session.
        The new prompt must extend the session's token chain; dispatch
        then prefers the replica holding the chain's KV, which resumes
        with ZERO prompt tokens recomputed. A dead holder or an evicted
        chain degrades to a plain re-prefilling dispatch — counted, not
        an error. Tenant fairness (DRR queue) and request leases apply
        exactly as for :meth:`add_request`."""
        if request_id is None:
            request_id = f"fleet-{next(self._auto_id)}"
        if request_id in self._requests:
            raise ValueError(f"duplicate request id {request_id!r}")
        if session_id not in self._sessions:
            # un-parked fast path: a just-finished request's session
            # still lives device-side on the replica that ran it
            src = self._requests.get(session_id)
            if src is not None and src.replica_id is not None:
                self._sessions[session_id] = {
                    "holder": src.replica_id,
                    "tokens": (list(src.prompt_ids)
                               + list(src.progress)),
                    "covered": 0, "chain_hash": None,
                    "tenant": src.tenant}
        sampling = sampling or SamplingParams()
        prompt = [int(t) for t in prompt_ids]
        now = time.monotonic()
        fr = _FleetRequest(
            request_id=request_id, prompt_ids=prompt, sampling=sampling,
            callback=callback, arrival=now,
            deadline_abs=(None if sampling.deadline_ms is None
                          else now + sampling.deadline_ms / 1e3),
            tenant=sampling.tenant_id,
            cost=len(prompt) + sampling.max_new_tokens,
            session=session_id)
        self._requests[request_id] = fr
        self._open[request_id] = fr
        live = self._own_dispatchable()
        if self.lease_store is not None and not live:
            live = self.dispatchable()
        verdicts = [h.admission_verdict(len(prompt)) for h in live]
        if not live or all(v is not None for v in verdicts):
            self.num_rejected_fleetwide += 1
            self._finalize(fr, "rejected", None, self._pending_outputs)
            return request_id
        self._queue.push(fr.tenant, request_id, fr.cost)
        return request_id

    def session_info(self, session_id: str) -> Optional[dict]:
        rec = self._sessions.get(session_id)
        return None if rec is None else {
            "holder": rec.get("holder"),
            "tokens_covered": int(rec.get("covered", 0)),
            "chain_hash": rec.get("chain_hash"),
            "tenant": rec.get("tenant")}

    # -- one router iteration --------------------------------------------
    def step(self) -> List[RequestOutput]:
        """Pump faults, heartbeats, health, dispatch, then one engine
        iteration per live replica. Returns this step's client-visible
        outputs (hand-offs emit nothing — the request continues)."""
        if self.lease_store is not None:
            if not self.router_dead and faults.check(
                    faults.FLEET_ROUTER_KILL, key=self.router_id):
                # in-process SIGKILL: this router goes silent NOW — no
                # farewell beat, no lease release, nothing emitted again
                self.router_dead = True
            if self.router_dead or self.partitioned:
                # dead: silent forever. partitioned: FROZEN — no beats,
                # no renewals, no dispatch; pending terminals wait for
                # the heal (their positions are <= the lease's committed
                # progress, so a late emission cannot duplicate)
                return []
            self._router_sync()
        outputs, self._pending_outputs = self._pending_outputs, []
        self._fire_fault_points(outputs)
        self._heartbeat()
        self._health_sweep(outputs)
        self._dispatch_queue(outputs)
        self._ship_hot_prefixes()
        self._offload_pressured_sessions()
        for h in list(self.replicas):
            if not h.alive:
                continue
            if not self._steps_replica(h):
                continue  # a peer router owns this engine
            to_ship: List[str] = []
            for out in h.step():
                self._handle_output(h, out, outputs, to_ship)
            # ship AFTER the whole output list folded into progress —
            # shipping inside the loop would migrate a request while
            # later outputs from the same step still reference it
            for rid in to_ship:
                fr = self._open.get(rid)
                if (fr is not None and not fr.finished
                        and fr.replica_id == h.replica_id):
                    self._ship_from(h, fr)
            if not h.alive and not h.retiring:
                # the engine died mid-step (EngineStepError absorbed at
                # the handle): outputs above carried its structured
                # aborts; anything still assigned re-enqueues now.
                # Retiring handles are exempt — a drained-out worker
                # exits right after its last reply (retiring set from
                # that reply) and is reaped, not counted dead; if one
                # truly crashes mid-drain with work assigned, the next
                # health sweep recovers it
                self.kill_replica(h.replica_id, "step failure", outputs)
        self._reap_retired()
        return outputs

    def run(self, max_steps: Optional[int] = None) -> List[RequestOutput]:
        outs: List[RequestOutput] = []
        steps = 0
        while self.has_unfinished() and not self.router_dead:
            outs.extend(self.step())
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return outs

    def generate(self, prompts: Sequence[Sequence[int]],
                 sampling: Optional[SamplingParams] = None
                 ) -> List[List[int]]:
        rids = [self.add_request(list(p), sampling=sampling)
                for p in prompts]
        self.run()
        return [self.release_request(rid).generated for rid in rids]

    # -- internals --------------------------------------------------------
    def _fire_fault_points(self, outputs: List[RequestOutput]) -> None:
        for arg in faults.check(faults.FLEET_KILL_REPLICA):
            h = self._fault_target(arg)
            if h is not None:
                self.kill_replica(h.replica_id, "fault", outputs)
        for arg in faults.check(faults.FLEET_DRAIN_REPLICA):
            h = self._fault_target(arg)
            if h is not None:
                for out in h.start_drain("fault"):
                    self._handle_output(h, out, outputs)
        for arg in faults.check(faults.FLEET_SLOW_REPLICA):
            time.sleep(float(arg) if arg else 0.01)
        for arg in faults.check(faults.FLEET_WORKER_KILL):
            h = self._fault_target(arg)
            hard_kill = getattr(h, "hard_kill", None)
            if callable(hard_kill):
                # SIGKILL the worker process and do NOTHING router-side:
                # the death must be DETECTED (exit/EOF/heartbeat TTL),
                # which is the failure mode this fault exists to inject
                hard_kill()

    def _fault_target(self, arg) -> Optional[ReplicaHandle]:
        alive = [h for h in self.replicas if h.alive]
        if not alive:
            return None
        if arg in (None, ""):
            return alive[0]
        for h in alive:
            if h.replica_id == arg:
                return h
        try:
            return self.replicas[int(arg)]
        except (ValueError, IndexError):
            return None

    def _heartbeat(self) -> None:
        now = time.monotonic()
        if (self._last_hb is not None
                and now - self._last_hb < self.cfg.heartbeat_interval_s):
            return
        self._last_hb = now
        for h in self.replicas:
            if h.alive and not getattr(h, "self_heartbeat", False):
                if not self._steps_replica(h):
                    continue  # its owner router beats it
                # in-process replicas advertise through the router's
                # own beat (a worker process publishes the same meta
                # shape itself — see fleet/worker.py)
                meta: Dict[str, object] = {}
                role = getattr(h, "role", None)
                if role:
                    meta["role"] = role
                peer = getattr(h, "peer_endpoint", None)
                if peer:
                    meta["peer"] = peer
                dig = h.prefix_digest()
                if dig is not None:
                    meta["prefix"] = dig
                self.registry.heartbeat(h.replica_id,
                                        load=h.load().as_dict(),
                                        meta=meta or None)

    def _health_sweep(self, outputs: List[RequestOutput]) -> None:
        view = self.registry.alive()
        self._refresh_adverts(view)
        for h in list(self.replicas):
            if h.alive and (getattr(h, "role", None) is None
                            or getattr(h, "peer_endpoint", None) is None):
                # a restarted worker advertises its role AND its peer
                # endpoint through the registry heartbeat meta; re-learn
                # both so a fresh router rejoins the topology (and can
                # ticket peer transfers) without re-plumbing anything
                meta = (view.get(h.replica_id) or {}).get("meta") or {}
                if (getattr(h, "role", None) is None
                        and meta.get("role") in ("prefill", "decode")):
                    h.role = meta["role"]
                if (getattr(h, "peer_endpoint", None) is None
                        and meta.get("peer")):
                    h.peer_endpoint = meta["peer"]
            if h.alive and h.replica_id not in view:
                self.kill_replica(h.replica_id, "heartbeat lost", outputs)
            elif not h.alive and self._assigned.get(h.replica_id):
                # the handle died outside the router's sight (an
                # external monitor flipped it between steps): same
                # recovery as a mid-step death
                self.kill_replica(h.replica_id, "found dead", outputs)

    # -- replicated control plane (leases, adoption, fencing) --------------
    def _steps_replica(self, h: ReplicaHandle) -> bool:
        """Replica partitioning: in replicated mode each live replica
        is stepped/heartbeaten/dispatched-to by exactly ONE router —
        the rendezvous owner of its id over the live router view — so
        two routers can never double-step one engine. A single router
        owns everything (unchanged classic behavior)."""
        if self.lease_store is None:
            return True
        return rendezvous_owner(h.replica_id,
                                self._routers_view) == self.router_id

    def _own_dispatchable(self) -> List[ReplicaHandle]:
        return [h for h in self.dispatchable()
                if self._steps_replica(h)]

    def _router_sync(self) -> None:
        """Per-step replicated bookkeeping: beat our router record,
        refresh the live-router view (the partitioning input), adopt
        leases whose owner died or went stale, and migrate requests
        off replicas that rendezvous no longer assigns to us."""
        self.router_registry.heartbeat(self.router_id)
        view = set(self.router_registry.alive())
        view.add(self.router_id)
        view = sorted(view)
        changed = view != self._routers_view
        self._routers_view = view
        # the adoption sweep parses every lease record; amortize it
        # over steps (a membership change always sweeps immediately —
        # that is when adoptions and migrations actually happen)
        self._sync_step += 1
        if changed or self._sync_step % 4 == 1:
            self._adopt_sweep()
            self._migrate_disowned()
            self._reconcile_open()

    def _reconcile_open(self) -> None:
        """Fence open requests whose lease silently changed hands. The
        renew-before-emit fence only fires on an emission — if a peer
        adopted our request (we looked dead during a partition),
        attached to our engine copy, and drove it to a terminal, that
        copy never emits to US again and the renewal path never runs.
        Sweep our leased open requests against the store: a missing
        record (the adopter released at a terminal) or a foreign
        owner/generation means we were superseded — drop our copy
        without emitting."""
        for fr in list(self._open.values()):
            if fr.finished or fr.lease_gen is None:
                continue
            if not self.lease_store.check(
                    fr.request_id, self.router_id, fr.lease_gen):
                self._fence_local(fr)

    def _adopt_sweep(self) -> None:
        """Take over foreign leases that lost their owner. Three
        triggers: the owner's router record left the live view
        (SIGKILL — outcome ``adopted``), the lease itself went stale
        on our clock (the owner stopped renewing — ``expired``), or
        the ``fleet.lease_steal`` fault forced the race. Exactly one
        peer steps up per lease: the rendezvous winner over the live
        routers minus the old owner."""
        ls = self.lease_store
        live = set(self._routers_view)
        for rec in ls.sweep():
            rid, owner = rec.get("rid"), rec.get("owner")
            if rid is None:
                continue
            mine = self._requests.get(rid)
            if owner == self.router_id:
                gen = int(rec.get("gen", 0))
                if (rec.get("orphan") and self._own_dispatchable()
                        and (mine is None or mine.finished)):
                    # reclaim our own orphan: we handed it over with no
                    # replicas to our name, and rendezvous has since
                    # given us some back before any peer took it
                    if ls.renew(rid, self.router_id, gen, orphan=False):
                        self._adopt_request(rid, gen, rec,
                                            owner_dead=False)
                elif rec["stale"] and (mine is None or mine.finished):
                    # our own lease went stale with no live local copy:
                    # we self-fenced on a dropped renew (fenced and
                    # store-refused are indistinguishable by design)
                    # and no peer stepped up — with one router left
                    # there IS no peer. Same owner, same generation, so
                    # this is the same incarnation resuming, not an
                    # adoption: re-freshen the record and recompute
                    # from its committed progress
                    if ls.renew(rid, self.router_id, gen):
                        self._adopt_request(rid, gen, rec,
                                            owner_dead=False)
                continue
            if mine is not None and not mine.finished:
                continue  # we already hold an open copy
            owner_dead = owner not in live
            orphan = bool(rec.get("orphan"))
            steal = (not owner_dead and not rec["stale"]
                     and bool(faults.check(faults.FLEET_LEASE_STEAL,
                                           key=rid)))
            if not (owner_dead or orphan or rec["stale"] or steal):
                continue
            cands = sorted(live - {owner}) or sorted(live)
            if rendezvous_owner(f"adopt:{rid}", cands) != self.router_id:
                continue
            res = ls.adopt(
                rid, self.router_id,
                outcome="adopted" if owner_dead or orphan else "expired")
            if res is None:
                continue
            gen, old = res
            self._adopt_request(rid, gen, old, owner_dead)
            if owner_dead and owner not in self._failed_routers:
                self._failed_routers.add(owner)
                self.num_router_failovers += 1

    def _adopt_request(self, rid: str, gen: int, rec: Dict,
                       owner_dead: bool) -> None:
        """Rebuild a ``_FleetRequest`` from an adopted lease record.
        When the old owner is DEAD and the engine copy still runs on a
        replica we own, attach in place — fence the replica at the new
        generation and fold its cumulative outputs from the
        dispatch-time base (the engine is the source of truth, so no
        token is lost or doubled however stale the lease). Otherwise
        recompute: resume from the lease's committed progress (>= all
        delivered positions, by renew-before-emit) on our own
        replicas, RNG riding the lease."""
        now = time.monotonic()
        sampling = SamplingParams(**(rec.get("sampling") or {}))
        deadline_abs = None
        if rec.get("deadline_ms") is not None:
            deadline_abs = now + float(rec["deadline_ms"]) / 1e3
        prompt = [int(t) for t in rec.get("prompt") or []]
        progress = [int(t) for t in rec.get("progress") or []]
        fr = _FleetRequest(
            request_id=rid, prompt_ids=prompt, sampling=sampling,
            callback=None, arrival=now, deadline_abs=deadline_abs,
            tenant=rec.get("tenant") or sampling.tenant_id,
            cost=len(prompt) + sampling.max_new_tokens,
            base_generated=list(progress), progress=list(progress),
            rng_state=rec.get("rng"),
            handoffs=int(rec.get("handoffs") or 0),
            dispatches=int(rec.get("dispatches") or 0),
            lease_gen=gen)
        self._requests[rid] = fr
        self._open[rid] = fr
        h = self._by_id(rec.get("replica_id") or "")
        if (owner_dead and h is not None and h.alive and not h.retiring
                and self._steps_replica(h)
                and h.fence_request(rid, gen)
                and h.rng_state(rid) is not None):
            fr.base_generated = [int(t) for t in rec.get("base") or []]
            fr.replica_id = h.replica_id
            fr.dispatch_t = now
            self._assigned.setdefault(h.replica_id, set()).add(rid)
            return
        self._queue.push(fr.tenant, rid, 0, front=True)

    def _migrate_disowned(self) -> None:
        """Router membership changed under us: replicas we no longer
        own may still run OUR requests (we hold their leases). Pull
        each one back — commit the recovery point to the lease, abort
        the engine copy, re-dispatch on replicas we do own."""
        for h in list(self.replicas):
            if self._steps_replica(h):
                continue
            rids = self._assigned.get(h.replica_id)
            if not rids:
                continue
            for rid in sorted(rids):
                rids.discard(rid)
                fr = self._open.get(rid)
                if fr is None or fr.finished:
                    continue
                # lease first, engine second: only the current owner
                # may touch the engine copy — if a peer adopted while
                # we were partitioned it may be ATTACHED to this very
                # copy, and aborting it would kill the client-visible
                # stream (_fence_local knows the difference)
                if (fr.lease_gen is not None
                        and not self.lease_store.check(
                            rid, self.router_id, fr.lease_gen)):
                    self._fence_local(fr, h)
                    continue
                if h.alive:
                    # do NOT read rng_state from a disowned replica:
                    # its new owner may already have stepped the engine
                    # past our last emission (dropping our outputs on
                    # its floor), so the live state can run AHEAD of
                    # fr.progress and resuming from it would skip the
                    # unemitted positions. fr.rng_state holds the
                    # emit-committed pair — recover from that.
                    h.abort_request(rid)
                    h.release_request(rid)
                if (fr.lease_gen is not None
                        and not self.lease_store.renew(
                            rid, self.router_id, fr.lease_gen,
                            progress=list(fr.progress),
                            base=list(fr.progress),
                            rng=fr.rng_state)):
                    self._fence_local(fr)
                    continue
                self._requeue(fr, count_handoff=False)

    def _hand_over(self, fr: _FleetRequest) -> None:
        """We own no replica that could run this request, but a peer
        does: publish (or refresh) its lease marked ORPHAN — orphan
        leases are adopted immediately, no TTL wait — and drop our
        copy without emitting. The adopter's stream becomes the
        client-visible one, exactly as after a failover."""
        rid, ls = fr.request_id, self.lease_store
        if fr.lease_gen is None:
            rec = self._lease_record(fr)
            rec["orphan"] = True
            ls.acquire(rid, self.router_id, rec)
        else:
            ls.renew(rid, self.router_id, fr.lease_gen, orphan=True,
                     progress=list(fr.progress), rng=fr.rng_state)
        self.num_requests_handed_over += 1
        fr.lease_gen = None
        fr.finished = True
        fr.finish_reason = "fenced"
        self._open.pop(rid, None)

    def _lease_for_dispatch(self, fr: _FleetRequest,
                            handle: ReplicaHandle) -> bool:
        """Own the lease and fence the destination before any engine
        work. False = the request was dropped locally (foreign owner,
        fenced renew, or replica-side fence refusal) and the caller
        must not dispatch."""
        rid, ls = fr.request_id, self.lease_store
        if fr.lease_gen is None:
            gen = ls.acquire(rid, self.router_id,
                             self._lease_record(fr, handle))
            if gen is None:
                # a FRESH foreign lease exists: someone else runs this
                # request — drop our copy, touch nothing of theirs
                self._fence_local(fr)
                return False
            fr.lease_gen = gen
        elif not ls.renew(rid, self.router_id, fr.lease_gen,
                          replica_id=handle.replica_id,
                          base=list(fr.base_generated),
                          progress=list(fr.progress),
                          rng=fr.rng_state):
            self._fence_local(fr)
            return False
        if not handle.fence_request(rid, fr.lease_gen):
            # the replica has seen a higher generation for this rid:
            # we are the stale side of an adoption race
            self._fence_local(fr)
            return False
        return True

    def _lease_record(self, fr: _FleetRequest,
                      handle: Optional[ReplicaHandle] = None) -> Dict:
        rec = {"tenant": fr.tenant,
               "prompt": list(fr.prompt_ids),
               "sampling": dataclasses.asdict(fr.sampling),
               "base": list(fr.base_generated),
               "progress": list(fr.progress),
               "rng": fr.rng_state,
               "replica_id": (handle.replica_id if handle is not None
                              else fr.replica_id),
               "handoffs": fr.handoffs,
               "dispatches": fr.dispatches}
        if fr.deadline_abs is not None:
            rec["deadline_ms"] = max(
                0.0, (fr.deadline_abs - time.monotonic()) * 1e3)
        return rec

    def _renew_before_emit(self, fr: _FleetRequest,
                           handle: ReplicaHandle, out: RequestOutput,
                           new_progress: List[int]) -> bool:
        """THE replicated-mode invariant: commit progress (and the RNG
        state that continues it) to the lease BEFORE those tokens reach
        the client. The committed progress is then always >= every
        delivered position, so an adopter resuming from it can never
        emit a position twice. A False renewal — fenced or write
        dropped, indistinguishable by design — self-fences."""
        updates: Dict[str, object] = {
            "progress": list(new_progress),
            "replica_id": handle.replica_id}
        if not out.finished:
            updates["rng"] = handle.rng_state(fr.request_id)
        if fr.deadline_abs is not None:
            updates["deadline_ms"] = max(
                0.0, (fr.deadline_abs - time.monotonic()) * 1e3)
        if self.lease_store.renew(fr.request_id, self.router_id,
                                  fr.lease_gen, **updates):
            if "rng" in updates:
                # keep the emit-committed (progress, rng) pair on the
                # request: recovery paths that cannot trust a live
                # engine read (a disowned replica may have been stepped
                # past our emissions by its new owner) resume from this
                fr.rng_state = updates["rng"]
            return True
        self._fence_local(fr, handle)
        return False

    def _fence_local(self, fr: _FleetRequest,
                     handle: Optional[ReplicaHandle] = None) -> None:
        """We lost this request's lease (or never had it): drop our
        copy WITHOUT emitting — the new owner's stream is the only
        client-visible one — and abort any engine-side copy so it
        stops burning steps. Not a client terminal: no finish_counts
        entry, no output record.

        Engine-abort guard: when the CURRENT lease shows the new owner
        on the SAME replica, it attached in place to the very copy we
        dispatched (we looked dead during a partition; we weren't) —
        that copy is now the client-visible stream and only its owner
        may abort it. Any other engine copy of ours is a private
        zombie nobody else references: abort it freely."""
        rid = fr.request_id
        self.num_requests_fenced += 1
        if handle is None and fr.replica_id is not None:
            handle = self._by_id(fr.replica_id)
        if handle is not None and handle.alive:
            rec = self.lease_store._load(rid) \
                if self.lease_store is not None else None
            adopter_attached = (
                rec is not None
                and rec.get("owner") != self.router_id
                and rec.get("replica_id") == handle.replica_id)
            if not adopter_attached:
                handle.abort_request(rid)
                handle.release_request(rid)
        if fr.replica_id is not None:
            self._assigned.get(fr.replica_id, set()).discard(rid)
        fr.lease_gen = None
        fr.finished = True
        fr.finish_reason = "fenced"
        self._open.pop(rid, None)

    def _dispatch_queue(self, outputs: List[RequestOutput]) -> None:
        while True:
            popped = self._queue.pop()
            if popped is None:
                return
            tenant, rid, cost = popped
            fr = self._open.get(rid)
            if fr is None or fr.finished:
                continue  # aborted while queued
            now = time.monotonic()
            if fr.deadline_abs is not None and now >= fr.deadline_abs:
                if fr.ship_src is not None or fr.kv is not None:
                    # expire-before-ship: a pending KV transfer for a
                    # request that can no longer finish is abandoned,
                    # never shipped (the parked snapshot is released)
                    self.num_ship_skipped_expired += 1
                self._finalize(fr, "expired", None, outputs)
                continue
            prompt = fr.prompt_ids + fr.base_generated
            cands = [h for h in self._own_dispatchable()
                     if h.admission_verdict(len(prompt)) is None]
            if not cands:
                if (self.lease_store is not None
                        and not self._own_dispatchable()
                        and len(self._routers_view) > 1):
                    # we own NO replica at all (rendezvous gave them
                    # all to peers): hand the request over instead of
                    # blocking a queue nobody will ever drain
                    self._hand_over(fr)
                    continue
                # head-of-line blocks (DRR order is the fairness
                # contract — skipping ahead would let cheap requests
                # overtake a starved tenant)
                self._queue.unpop(tenant, rid, cost)
                return
            handle = None
            if fr.session is not None:
                rec = self._sessions.get(fr.session)
                holder = self._by_id(rec["holder"]) if rec else None
                if holder is not None and holder in cands:
                    # session affinity beats TTFT scoring: the holder
                    # resumes with zero prompt recompute, which no
                    # estimate can price
                    handle = holder
            if handle is None:
                handle = self._pick(self._role_candidates(cands, fr),
                                    prompt)
            if (self.lease_store is not None
                    and not self._lease_for_dispatch(fr, handle)):
                # fenced or foreign-owned: the local copy was dropped
                # (nothing emitted) — move on to the next queued item
                continue
            shipped = False
            if fr.session is not None:
                shipped = self._resume_session_on(fr, handle, prompt,
                                                  now)
            elif fr.kv is not None:
                meta, payload = fr.kv
                t0 = time.monotonic()
                shipped = handle.import_kv(
                    rid, prompt, self._effective_sampling(fr, now),
                    meta=meta, payload=payload, rng_state=fr.rng_state)
                if shipped:
                    self.kv_ship_time_s += time.monotonic() - t0
                    self.num_kv_ship_requests += 1
                    self.num_kv_ship_blocks += int(meta.get("blocks", 0))
                    self.num_kv_ship_bytes += len(payload)
                    # the payload lived router-side (drain piggyback /
                    # relay capture): those bytes crossed the router
                    self.num_relay_bytes += len(payload)
                    self.num_tokens_recomputed += max(
                        0, len(prompt) - 1
                        - int(meta.get("tokens_covered", 0)))
                else:
                    # clean import rejection (corrupt payload, peer OOM,
                    # capability missing): recompute on the same handle
                    self.num_recompute_fallbacks += 1
                fr.kv = None  # consumed either way
            elif fr.ship_src is not None:
                shipped = self._ticket_ladder(fr, handle, prompt, now)
            if not shipped:
                try:
                    handle.add_request(rid, prompt,
                                       self._effective_sampling(fr, now),
                                       rng_state=fr.rng_state)
                except ValueError:
                    if self.lease_store is None:
                        raise
                    # duplicate rid on this engine: a transiently split
                    # ownership view let another router's copy land
                    # there first — drop OURS without aborting theirs
                    self.num_requests_fenced += 1
                    fr.lease_gen = None
                    fr.finished = True
                    fr.finish_reason = "fenced"
                    self._open.pop(rid, None)
                    continue
                if fr.dispatches > 0:
                    # a continuation without KV re-prefills its whole
                    # context (the single computed position excepted)
                    self.num_tokens_recomputed += max(0, len(prompt) - 1)
            self._assigned.setdefault(handle.replica_id, set()).add(rid)
            fr.replica_id = handle.replica_id
            fr.dispatches += 1
            self.num_dispatched += 1
            self.tenant_dispatches[tenant] = \
                self.tenant_dispatches.get(tenant, 0) + 1
            self._tenant_window[tenant] = \
                self._tenant_window.get(tenant, 0) + 1
            if fr.dispatch_t is None:
                fr.dispatch_t = now
                self.tenant_wait_s.setdefault(tenant, []).append(
                    now - fr.arrival)

    def _pick(self, cands: List[ReplicaHandle],
              prompt: List[int]) -> ReplicaHandle:
        """Best estimated TTFT; least-loaded while estimates are cold
        (fresh replicas have no step history, so their estimator
        abstains rather than guess). With prefix affinity on, each
        candidate's estimate is taken over the UNMATCHED prompt suffix
        only — the cached-prefix credit priced by the replica's own
        prefill-rate model — and advertised match depth breaks ties
        toward the warm replica. With no advertised match anywhere,
        the scoring is bit-identical to plain load balancing."""
        matched = self._affinity_match(cands, prompt) \
            if self.cfg.prefix_affinity else {}
        ests = [(h.estimated_ttft_ms(
                    max(1, len(prompt) - matched.get(h.replica_id, 0))),
                 h) for h in cands]
        warm = [(e, h) for e, h in ests if e is not None]
        if len(warm) == len(ests) and warm:
            best = min(warm, key=lambda p: (
                p[0], -matched.get(p[1].replica_id, 0),
                p[1].load().occupancy, p[1].replica_id))[1]
        else:
            best = min(cands, key=lambda h: (
                -matched.get(h.replica_id, 0), h.load().occupancy,
                h.load().kv_utilization, h.replica_id))
        m = matched.get(best.replica_id, 0)
        if m > 0:
            self.num_prefix_affine_dispatches += 1
            self.num_prefix_hit_tokens += m
        return best

    # -- fleet-global prefix cache -----------------------------------------
    def _refresh_adverts(self, view: Dict[str, dict]) -> None:
        """Rebuild the advert map from the liveness sweep's registry
        view: one digest per live attached replica whose last heartbeat
        carried one. Replicas that stop heartbeating drop out wholesale
        — eventual consistency is the contract, staleness decay handles
        the window in between."""
        adverts: Dict[str, dict] = {}
        for h in self.replicas:
            if not h.alive:
                continue
            meta = (view.get(h.replica_id) or {}).get("meta") or {}
            dig = meta.get("prefix")
            if isinstance(dig, dict) and dig.get("h"):
                adverts[h.replica_id] = dig
        self._adverts = adverts

    def _affinity_match(self, cands: List[ReplicaHandle],
                        prompt: List[int]) -> Dict[str, int]:
        """Advertised matched-token count per candidate, decayed by
        heartbeat age (linear to zero over ``prefix_decay_s``). The
        walk breaks on the first unadvertised link, mirroring the
        engine's own match semantics (the digest keeps SHALLOW entries
        when capped, so every kept entry's ancestors are kept too).
        Also feeds the hot-prefix tracker with the deepest advertised
        match anywhere, which drives proactive shipping."""
        matched: Dict[str, int] = {}
        best_hash: Optional[str] = None
        best_tokens = 0
        hashes_by_bs: Dict[int, List[str]] = {}
        for h in cands:
            adv = self._adverts.get(h.replica_id)
            if not adv:
                continue
            bs = int(adv.get("bs", 0))
            if bs <= 0:
                continue
            if bs not in hashes_by_bs:
                hashes_by_bs[bs] = prefix_chain_hashes(prompt, bs)
            table = adv.get("h") or {}
            raw = 0
            last: Optional[str] = None
            for i, ch in enumerate(hashes_by_bs[bs]):
                if ch not in table:
                    break
                raw = (i + 1) * bs
                last = ch
            if raw <= 0:
                continue
            age = self.registry.age_s(h.replica_id)
            decay = max(0.0, 1.0 - (age or 0.0)
                        / self.cfg.prefix_decay_s)
            m = int(raw * decay)
            if m > 0:
                matched[h.replica_id] = m
            if raw > best_tokens:
                best_tokens, best_hash = raw, last
        if best_hash is not None:
            rec = self._prefix_hot.setdefault(
                best_hash, {"count": 0, "tokens": best_tokens})
            rec["count"] += 1
            if len(self._prefix_hot) > 1024:
                # bound the tracker: drop the coldest half
                keep = sorted(self._prefix_hot.items(),
                              key=lambda kv: -kv[1]["count"])[:512]
                self._prefix_hot = dict(keep)
        return matched

    def _export_prefix_guarded(self, handle: ReplicaHandle,
                               chain_hash: str):
        """``export_prefix`` with the ``fleet.prefix_ship_*`` fault
        points applied. None means the ship is dropped this step — the
        destination stays cold and simply prefills, nothing else."""
        try:
            kv = handle.export_prefix(chain_hash)
        except (KeyError, ValueError, OSError):
            kv = None
        if kv is not None and faults.check(faults.FLEET_PREFIX_SHIP_DROP):
            kv = None
        if kv is None:
            return None
        if faults.check(faults.FLEET_PREFIX_SHIP_CORRUPT):
            # flip one payload byte: the import side's CRC check
            # rejects it and the destination stays cold
            meta, payload = kv
            if payload:
                buf = bytearray(payload)
                buf[0] ^= 0xFF
                kv = (meta, bytes(buf))
        return kv

    def _ship_hot_prefixes(self) -> None:
        """Proactively copy hot advertised prefixes to cold replicas
        over the KV transport — an ``import_kv`` with no continuation
        attached. Failures are cheap (the destination just prefills),
        so policy errs simple: hottest hash first, least-loaded warm
        source, least-loaded cold destination, a per-(hash, dst)
        cooldown so a refusing destination is not hammered, and a
        per-step ship budget so policy never starves serving."""
        cfg = self.cfg
        if not (cfg.prefix_affinity and cfg.prefix_ship
                and self._prefix_hot):
            return
        now = time.monotonic()
        self._shipped = {k: t for k, t in self._shipped.items()
                         if now - t < cfg.prefix_decay_s}
        live = self._own_dispatchable()
        if len(live) < 2:
            return
        budget = cfg.max_prefix_ships_per_step
        for ch, rec in sorted(self._prefix_hot.items(),
                              key=lambda kv: (-kv[1]["count"], kv[0])):
            if budget <= 0:
                return
            if rec["count"] < cfg.prefix_ship_threshold:
                return  # sorted hottest-first: nothing hotter follows
            warm = [h for h in live if ch in
                    (self._adverts.get(h.replica_id) or {}).get("h", {})]
            if not warm:
                continue
            warm_ids = {h.replica_id for h in warm}
            cold = [h for h in live
                    if h.replica_id not in warm_ids
                    and self._role(h) != "decode"
                    and (ch, h.replica_id) not in self._shipped]
            if not cold:
                continue
            src = min(warm, key=lambda h: (h.load().occupancy,
                                           h.replica_id))
            dst = min(cold, key=lambda h: (h.load().occupancy,
                                           h.replica_id))
            budget -= 1
            # cooldown even on failure: a destination that refused
            # (no uncached headroom, draining) will refuse again soon
            self._shipped[(ch, dst.replica_id)] = now
            ok = False
            ticket = None
            # prefix ships walk the same ladder as KV ships: peer-push
            # first (payload never touches the router), router-relay as
            # the fallback, "stay cold" as the harmless floor
            if (cfg.peer_data_plane
                    and getattr(dst, "peer_endpoint", None)):
                ticket = self._issue_ticket(
                    src, dst, "prefix", ch, cfg.peer_deadline_s * 1e3)
                receipt = src.peer_send(ticket, dst.peer_endpoint)
                if receipt is not None and dst.peer_commit(
                        ticket["ticket_id"], kind="prefix"):
                    nbytes = int(receipt.get("bytes", 0))
                    self.num_prefix_ships += 1
                    self.num_prefix_ship_bytes += nbytes
                    self.num_peer_ship_bytes += nbytes
                    adv = self._adverts.setdefault(
                        dst.replica_id, {"bs": None, "n": 0, "h": {}})
                    adv["h"][ch] = int(receipt.get("tokens", 0))
                    ok = True
                    self.ticket_outcomes["peer"] += 1
            if not ok:
                kv = self._export_prefix_guarded(src, ch)
                if kv is not None:
                    meta, payload = kv
                    ok = bool(dst.import_prefix(meta=meta,
                                                payload=payload))
                    if ok:
                        self.num_prefix_ships += 1
                        self.num_prefix_ship_bytes += len(payload)
                        self.num_relay_bytes += len(payload)
                        if ticket is not None:
                            self.num_relay_fallbacks += 1
                            self.ticket_outcomes["relay"] += 1
                        # optimistic advert update so affinity can use
                        # the shipped prefix before a heartbeat confirms
                        adv = self._adverts.setdefault(
                            dst.replica_id,
                            {"bs": meta.get("block_size"), "n": 0,
                             "h": {}})
                        if adv.get("bs") == meta.get("block_size"):
                            adv["h"][ch] = len(meta.get("tokens", ()))
            if not ok:
                self.num_prefix_ship_failures += 1
                if ticket is not None:
                    # a ticketed prefix ship has no recompute rung —
                    # the destination just stays cold
                    self.ticket_outcomes["cold"] += 1

    def _resume_session_on(self, fr: _FleetRequest,
                           handle: ReplicaHandle, prompt: List[int],
                           now: float) -> bool:
        """One resume attempt against the picked replica. The session
        is consumed either way — a refused resume (holder lost the
        chain, prompt diverged, replica died) falls back to a plain
        re-prefilling add and the park is spent. Returns True when the
        replica admitted the continuation itself (including the
        hit==0 recompute floor, where the engine admits cold)."""
        sid, fr.session = fr.session, None
        rec = self._sessions.pop(sid, None)
        if rec is not None and rec.get("holder") == handle.replica_id:
            hit = handle.resume_session(
                fr.request_id, sid, prompt,
                self._effective_sampling(fr, now),
                rng_state=fr.rng_state)
            if hit is not None:
                if hit > 0:
                    self.num_session_resumes += 1
                    self.num_session_hit_tokens += int(hit)
                else:
                    # chain evicted under the park: the engine admitted
                    # the request cold — the ladder's recompute floor
                    self.num_session_resume_recomputes += 1
                return True
        if rec is not None:
            holder = self._by_id(rec.get("holder"))
            if holder is not None and holder.alive:
                holder.drop_session(sid)  # spent park: no record leak
        self.num_session_resume_recomputes += 1
        return False

    def _offload_pressured_sessions(self) -> None:
        """Past ``tier_offload_watermark``, move ONE parked session per
        step from its pressured holder to the least-pressured peer:
        ship the chain over the prefix ticket ladder (peer-push →
        router-relay → stay-home, exactly one counted outcome per
        issued ticket), have the peer adopt the session record, then
        evict the holder's copy (``drop_session(to_peer=True)`` — the
        adopter is now authoritative). Every failure leaves the session
        untouched on its holder."""
        wm = self.cfg.tier_offload_watermark
        if wm is None or not self._sessions:
            return
        live = self._own_dispatchable()
        if len(live) < 2:
            return
        stats = {h.replica_id: h.tier_stats() for h in live}
        for sid, rec in list(self._sessions.items()):
            ch = rec.get("chain_hash")
            tokens = rec.get("tokens")
            if not ch or not tokens:
                continue  # no committed full block / unknown chain
            src = self._by_id(rec.get("holder"))
            st = stats.get(rec.get("holder"))
            if src is None or not src.alive or not st:
                continue
            if st.get("pressure", 0.0) < wm:
                continue
            cold = [h for h in live
                    if h.replica_id != src.replica_id
                    and stats.get(h.replica_id)
                    and stats[h.replica_id].get("pressure", 1.0) < wm]
            if not cold:
                continue
            dst = min(cold, key=lambda h: (
                stats[h.replica_id].get("pressure", 1.0),
                h.replica_id))
            if not self._ship_session_chain(src, dst, ch):
                continue
            if not dst.adopt_session(sid, tokens,
                                     int(rec.get("covered", 0)),
                                     tenant=rec.get("tenant")):
                continue  # adopt refused: dst just keeps a warm prefix
            src.drop_session(sid, to_peer=True)
            rec["holder"] = dst.replica_id
            self.num_session_offloads += 1
            return  # one per step: policy never starves serving

    def _ship_session_chain(self, src: ReplicaHandle,
                            dst: ReplicaHandle, ch: str) -> bool:
        """Move one session's cached chain ``src`` → ``dst`` down the
        prefix ladder: peer-push first (payload never touches the
        router), router-relay as fallback, stay-home as the harmless
        floor. Same per-ticket outcome partition as every other
        ticketed transfer."""
        ok = False
        ticket = None
        if (self.cfg.peer_data_plane
                and getattr(dst, "peer_endpoint", None)):
            ticket = self._issue_ticket(
                src, dst, "prefix", ch, self.cfg.peer_deadline_s * 1e3)
            receipt = src.peer_send(ticket, dst.peer_endpoint)
            if receipt is not None and dst.peer_commit(
                    ticket["ticket_id"], kind="prefix"):
                self.num_peer_ship_bytes += int(receipt.get("bytes", 0))
                self.ticket_outcomes["peer"] += 1
                ok = True
        if not ok:
            kv = self._export_prefix_guarded(src, ch)
            if kv is not None:
                meta, payload = kv
                ok = bool(dst.import_prefix(meta=meta, payload=payload))
                if ok:
                    self.num_relay_bytes += len(payload)
                    if ticket is not None:
                        self.num_relay_fallbacks += 1
                        self.ticket_outcomes["relay"] += 1
        if not ok and ticket is not None:
            # a ticketed session ship has no recompute rung — the
            # session simply stays on its holder
            self.ticket_outcomes["cold"] += 1
        return ok

    def _effective_sampling(self, fr: _FleetRequest,
                            now: float) -> SamplingParams:
        """The sampling params the ENGINE sees this dispatch: max_new
        shrinks by the tokens already produced before a hand-off, and
        the deadline becomes the REMAINING budget (engine TTLs run from
        engine-side arrival, which resets on re-enqueue)."""
        repl = {}
        if fr.base_generated:
            repl["max_new_tokens"] = (fr.sampling.max_new_tokens
                                      - len(fr.base_generated))
        if fr.deadline_abs is not None:
            repl["deadline_ms"] = max(
                (fr.deadline_abs - now) * 1e3, 1e-3)
        return dataclasses.replace(fr.sampling, **repl) if repl \
            else fr.sampling

    def _requeue(self, fr: _FleetRequest, *,
                 count_handoff: bool = True) -> None:
        fr.base_generated = list(fr.progress)
        fr.replica_id = None
        if count_handoff:
            fr.handoffs += 1
        # cost 0, front: the tenant already paid when first dispatched
        self._queue.push(fr.tenant, fr.request_id, 0, front=True)

    # -- KV-ship (disaggregated serving) ----------------------------------
    def _role(self, handle: ReplicaHandle) -> Optional[str]:
        return getattr(handle, "role", None)

    def _export_kv_guarded(self, handle: ReplicaHandle, request_id: str,
                           *, expected: bool,
                           count_fallback: bool = True):
        """``export_kv`` with the ``fleet.kv_ship_*`` fault points
        applied. Returns ``(meta, payload)`` or None — None means the
        next dispatch resumes by recompute. ``expected`` marks exports
        that SHOULD succeed (prefill just completed), so a bare failure
        counts as a recompute fallback; a drain export of a request
        that never ran has nothing to ship and is not a fallback.
        ``count_fallback=False`` leaves ALL fallback accounting to the
        caller (the ticket ladder does its own single-point counting)."""
        for arg in faults.check(faults.FLEET_KV_SHIP_DELAY):
            time.sleep(float(arg) if arg else 0.01)
        try:
            kv = handle.export_kv(request_id)
        except (KeyError, ValueError, OSError):
            kv = None
        dropped = kv is not None and bool(
            faults.check(faults.FLEET_KV_SHIP_DROP))
        if dropped:
            kv = None
        if kv is None:
            if count_fallback and (expected or dropped):
                self.num_recompute_fallbacks += 1
            return None
        if faults.check(faults.FLEET_KV_SHIP_CORRUPT):
            # flip one payload byte: the import side's CRC check
            # rejects it and the dispatch falls back to recompute
            meta, payload = kv
            if payload:
                buf = bytearray(payload)
                buf[0] ^= 0xFF
                kv = (meta, bytes(buf))
        return kv

    def _ship_from(self, handle: ReplicaHandle,
                   fr: _FleetRequest) -> None:
        """Prefill complete on a prefill-role replica: migrate the
        request to the decode side, shipping its committed KV blocks so
        the peer recomputes nothing. A planned transfer, not a failure
        hand-off — it spends no hand-off budget; a failed export/park
        degrades to resume-by-recompute and the request migrates
        anyway.

        With the peer data plane on, the SOURCE parks the gathered
        bytes host-side (surviving the engine-side release) and the
        payload moves worker→worker at the next dispatch's ticket
        ladder; otherwise — or when the handle cannot park — the bytes
        are captured router-side as before (the relay path)."""
        now = time.monotonic()
        if fr.deadline_abs is not None and now >= fr.deadline_abs:
            # expire-before-ship guard: don't gather/park/ship KV for
            # a request that cannot finish in time — surface expired
            self.num_ship_skipped_expired += 1
            handle.abort_request(fr.request_id)
            handle.release_request(fr.request_id)
            self._assigned.get(handle.replica_id, set()).discard(
                fr.request_id)
            self._finalize(fr, "expired", None, self._pending_outputs)
            return
        state = handle.rng_state(fr.request_id)
        if state is not None:
            fr.rng_state = state
        fr.decode_bound = True
        parked = None
        if self.cfg.peer_data_plane:
            try:
                parked = handle.park_kv(fr.request_id)
            except (KeyError, ValueError, OSError):
                parked = None
        if parked:
            fr.ship_src = handle.replica_id
        else:
            t0 = time.monotonic()
            fr.kv = self._export_kv_guarded(handle, fr.request_id,
                                            expected=True)
            if fr.kv is not None:
                self.kv_ship_time_s += time.monotonic() - t0
        handle.abort_request(fr.request_id)
        handle.release_request(fr.request_id)
        self._assigned.get(handle.replica_id, set()).discard(
            fr.request_id)
        self._requeue(fr, count_handoff=False)

    # -- peer data plane (ticketed transfers) ------------------------------
    def _issue_ticket(self, src: ReplicaHandle, dst: ReplicaHandle,
                      kind: str, ref: str, deadline_ms: float) -> dict:
        """Mint one signed transfer ticket. The router never touches
        the payload — the ticket is the entire control-plane cost."""
        from paddle_tpu_torch.serving.fleet.transport import sign_ticket
        ticket = {"ticket_id": f"tkt-{next(self._ticket_seq)}",
                  "src": src.replica_id, "dst": dst.replica_id,
                  "kind": kind, "deadline_ms": int(max(1, deadline_ms))}
        ticket["request_id" if kind == "kv" else "chain_hash"] = ref
        ticket["sig"] = sign_ticket(ticket)
        self.num_tickets_issued += 1
        return ticket

    def _rung_deadline_ms(self, fr: _FleetRequest, now: float) -> float:
        """Per-rung deadline from the request's remaining budget,
        capped at ``peer_deadline_s``. A third of what remains, so a
        peer rung that eats its whole deadline still leaves room for
        the relay and recompute rungs below it."""
        cap = self.cfg.peer_deadline_s * 1e3
        if fr.deadline_abs is None:
            return cap
        remaining = max(0.0, (fr.deadline_abs - now) * 1e3)
        return max(1.0, min(cap, remaining / 3.0))

    def _drop_pending_ship(self, fr: _FleetRequest) -> None:
        """Abandon a request's pending KV transfer: release the
        source-side parked snapshot and the router-side capture. Safe
        on any request (no-op when nothing is pending)."""
        if fr.ship_src is not None:
            src = self._by_id(fr.ship_src)
            if src is not None and src.alive:
                src.drop_parked(fr.request_id)
            fr.ship_src = None
        fr.kv = None

    def _ticket_ladder(self, fr: _FleetRequest, dst: ReplicaHandle,
                       prompt: List[int], now: float) -> bool:
        """Move a parked KV snapshot from ``fr.ship_src`` into ``dst``
        down the degradation ladder: peer-push → router-relay →
        recompute. Exactly one attempt per rung, exactly one counted
        outcome per issued ticket; returns True when the destination
        admitted the continuation (peer or relay), False for recompute
        (the caller falls through to a plain ``add_request``).

        Ambiguity safety: a timed-out ``peer_send`` leaves the source
        alive (the destination's ticket-id idempotence absorbs a late
        or duplicate delivery, and an uncommitted staged payload is
        GC'd at its deadline); a timed-out ``peer_commit`` marks the
        DESTINATION dead, which is exactly what keeps its possibly-
        admitted continuation from ever emitting to the client."""
        rid = fr.request_id
        src = self._by_id(fr.ship_src)
        fr.ship_src = None  # consumed: one ladder walk per park
        sampling = self._effective_sampling(fr, now)
        ticket: Optional[dict] = None
        outcome: Optional[str] = None
        receipt: Optional[dict] = None
        if (self.cfg.peer_data_plane and src is not None and src.alive
                and getattr(dst, "peer_endpoint", None)):
            ticket = self._issue_ticket(
                src, dst, "kv", rid, self._rung_deadline_ms(fr, now))
            t0 = time.monotonic()
            receipt = src.peer_send(ticket, dst.peer_endpoint)
            if receipt is not None and dst.peer_commit(
                    ticket["ticket_id"], kind="kv", request_id=rid,
                    prompt_ids=prompt, sampling=sampling,
                    rng_state=fr.rng_state):
                self.kv_ship_time_s += time.monotonic() - t0
                blocks = int(receipt.get("blocks", 0))
                nbytes = int(receipt.get("bytes", 0))
                self.num_peer_ship_requests += 1
                self.num_peer_ship_blocks += blocks
                self.num_peer_ship_bytes += nbytes
                self.num_kv_ship_requests += 1
                self.num_kv_ship_blocks += blocks
                self.num_kv_ship_bytes += nbytes
                self.num_tokens_recomputed += max(
                    0, len(prompt) - 1
                    - int(receipt.get("tokens_covered", 0)))
                outcome = "peer"
        if outcome is None and src is not None and src.alive \
                and dst.alive:
            # router-relay rung: the pre-peer path, kept as fallback —
            # the parked snapshot answers the export even though the
            # source engine already released the request
            t0 = time.monotonic()
            kv = self._export_kv_guarded(src, rid, expected=True,
                                         count_fallback=False)
            if kv is not None:
                meta, payload = kv
                if dst.import_kv(rid, prompt, sampling, meta=meta,
                                 payload=payload,
                                 rng_state=fr.rng_state):
                    self.kv_ship_time_s += time.monotonic() - t0
                    self.num_kv_ship_requests += 1
                    self.num_kv_ship_blocks += int(meta.get("blocks", 0))
                    self.num_kv_ship_bytes += len(payload)
                    self.num_relay_bytes += len(payload)
                    self.num_tokens_recomputed += max(
                        0, len(prompt) - 1
                        - int(meta.get("tokens_covered", 0)))
                    if ticket is not None:
                        self.num_relay_fallbacks += 1
                        outcome = "relay"
                    else:
                        outcome = "direct"
        if outcome is None:
            self.num_recompute_fallbacks += 1
            outcome = "recompute"
        if src is not None and src.alive:
            src.drop_parked(rid)
        if ticket is not None:
            # "direct" can't occur with a ticket: a ticketed walk ends
            # peer | relay | recompute — the accounting partition
            self.ticket_outcomes[outcome] += 1
        return outcome in ("peer", "relay", "direct")

    def _role_candidates(self, cands: List[ReplicaHandle],
                         fr: _FleetRequest) -> List[ReplicaHandle]:
        """Role preference: KV-carrying continuations avoid prefill
        replicas, everything else avoids decode replicas. Preference
        only — when no replica of the wanted kind is dispatchable, any
        candidate serves (availability beats purity)."""
        if fr.kv is not None or fr.decode_bound:
            pref = [h for h in cands if self._role(h) != "prefill"]
        else:
            pref = [h for h in cands if self._role(h) != "decode"]
        return pref or cands

    def _handle_output(self, handle: ReplicaHandle, out: RequestOutput,
                       outputs: List[RequestOutput],
                       to_ship: Optional[List[str]] = None) -> None:
        fr = self._open.get(out.request_id)
        if fr is None:
            return  # not router-owned (or already finalized)
        new_progress = fr.base_generated + list(out.generated)
        if (self.lease_store is not None and fr.lease_gen is not None
                and not self._renew_before_emit(fr, handle, out,
                                                new_progress)):
            return  # fenced: dropped locally, nothing emitted
        fr.progress = new_progress
        if out.token is not None:
            self.num_tokens_emitted += 1
        if not out.finished:
            outputs.append(RequestOutput(
                request_id=fr.request_id, token=out.token, finished=False,
                generated=list(fr.progress)))
            if fr.callback is not None:
                fr.callback(fr.request_id, out.token, False)
            if (to_ship is not None
                    and self._role(handle) == "prefill"
                    and len(out.generated) == 1
                    and self._has_peer(handle)):
                # first emitted token = prefill complete: ship the KV
                # to the decode side (after this handle's full output
                # list has folded into progress)
                to_ship.append(fr.request_id)
            return
        self._assigned.get(handle.replica_id, set()).discard(
            fr.request_id)
        reason = out.finish_reason
        if (reason in HANDOFF_REASONS and self.cfg.handoff
                and fr.handoffs < self.cfg.max_handoffs
                and self._has_peer(handle)):
            state = handle.rng_state(fr.request_id)
            if state is not None:
                fr.rng_state = state
            if reason == "aborted:drain":
                # drain hand-off upgrades to block transfer: the source
                # engine parks the KV before freeing the table, so the
                # peer resumes without recomputing the prompt. Export
                # BEFORE release — release drops the parked snapshot.
                # Crash hand-offs (aborted:error) recompute: the source
                # can't be trusted to produce bytes
                fr.kv = self._export_kv_guarded(
                    handle, fr.request_id, expected=False)
            handle.release_request(fr.request_id)
            self._requeue(fr)
            self.num_handoffs += 1
            return  # invisible to the client: the request continues
        if (reason == "rejected" and fr.dispatches > 0 and fr.rejects < 3
                and self.dispatchable()):
            # dispatch-time race: the engine's state moved between the
            # router's verdict check and the add — requeue, don't
            # surface a rejection the router never decided
            fr.rejects += 1
            handle.release_request(fr.request_id)
            self._requeue(fr)
            return
        if (reason in HANDOFF_REASONS and self.cfg.handoff
                and fr.handoffs >= self.cfg.max_handoffs):
            # out of hand-off budget: the abort surfaces to the client
            self.num_handoff_exhausted += 1
        handle.release_request(fr.request_id)
        self._finalize(fr, reason, out.token, outputs)

    def _finalize(self, fr: _FleetRequest, reason: Optional[str],
                  token: Optional[int],
                  outputs: List[RequestOutput]) -> None:
        if self.lease_store is not None and fr.lease_gen is not None:
            gen, fr.lease_gen = fr.lease_gen, None
            if not self.lease_store.release(fr.request_id,
                                            self.router_id, gen):
                # fenced at the finish line: a peer adopted the lease
                # between our last renew and this terminal — the
                # adopter's stream is the client-visible one, so our
                # terminal must not emit
                self._fence_local(fr)
                return
        self._drop_pending_ship(fr)  # no KV snapshot outlives its request
        fr.finished = True
        fr.finish_reason = reason
        if reason is not None:
            self.finish_counts[reason] = \
                self.finish_counts.get(reason, 0) + 1
        self._open.pop(fr.request_id, None)
        outputs.append(RequestOutput(
            request_id=fr.request_id, token=token, finished=True,
            generated=list(fr.progress), finish_reason=reason))
        if fr.callback is not None:
            fr.callback(fr.request_id, token, True)

    def _reap_retired(self) -> None:
        for h in list(self.replicas):
            done = (not h.alive) or (h.is_draining
                                     and not h.has_unfinished())
            if h.retiring and done and not self._assigned.get(
                    h.replica_id):
                self.replicas.remove(h)
                self._assigned.pop(h.replica_id, None)
                self.registry.deregister(h.replica_id)

    # -- observability ----------------------------------------------------
    def load(self) -> float:
        """Fleet load in [0, 1]: the dispatchable replicas' mean of
        max(KV utilization, request occupancy / max_num_seqs-ish) —
        what :class:`LoadThresholdPolicy` thresholds on. 1.0 when
        nothing is dispatchable but work remains."""
        live = self.dispatchable()
        if not live:
            return 1.0 if self.has_unfinished() else 0.0
        vals = []
        for h in live:
            ld = h.load()
            cap = getattr(getattr(h, "engine", None), "cfg", None)
            seqs = cap.max_num_seqs if cap is not None else 8
            vals.append(max(ld.kv_utilization,
                            min(1.0, ld.occupancy / max(seqs, 1))))
        return sum(vals) / len(vals)

    def tenant_load(self, consume: bool = True) -> float:
        """Skew-amplified load in [0, 1]: the scalar :meth:`load`
        scaled by ``max_tenant_share * active_tenants`` over the
        dispatches since the last poll. Balanced traffic (share 1/N
        over N tenants) and single-tenant traffic both degenerate to
        plain ``load()``; a one-tenant burst pushes share toward 1
        with N tenants active, amplifying the signal N-fold — which
        is what lets :class:`LoadThresholdPolicy.tenant_high` see a
        hot tenant the fleet mean averages away. Clock-free (counts,
        not rates), so it works on FleetSim's virtual clock.
        ``consume=False`` peeks without resetting the window (the
        metrics snapshot path)."""
        win = self._tenant_window
        if consume:
            self._tenant_window = {}
        total = sum(win.values())
        if total == 0:
            return 0.0
        share = max(win.values()) / total
        active = sum(1 for v in win.values() if v)
        return min(1.0, self.load() * share * active)

    def snapshot(self) -> Dict:
        return self.metrics.snapshot()
