"""Discrete-event fleet simulator: 100+ replicas, N routers, no engines
(port of the JAX package's ``serving/fleet/sim.py``).

The replicated control plane's correctness story — zero token loss,
zero duplication, exact lease accounting under router SIGKILL, lease
expiry races, and registry partitions — cannot be exercised at fleet
scale with real engines on CPU. This module replaces both the clock
and the replica:

* :class:`VirtualClock` — simulated time; every registry and lease
  store gets its reader-monotonic clock pointed here, so TTL expiry,
  staleness, and adoption latency play out in virtual seconds while
  the whole run takes CPU-milliseconds per tick;
* :class:`SimReplica` — a :class:`ReplicaHandle` with no engine. Its
  token stream is a pure function of (request id, absolute position)::

      token(rid, pos) = crc32(f"{rid}:{pos}") % 32000 + 1

  so "every position emitted exactly once, none lost, none doubled"
  is checkable by direct reconstruction, not by statistics. The RNG
  state it hands the router is ``{"pos": <absolute position>}``, which
  rides the lease like the real composite RNG dict and makes adopted
  continuations resume at exactly the right position;
* :class:`LatencyModel` — per-tick virtual costs, the JAX package's
  serving benches (``BENCH_serving_r05``–``r08``, measured on a TPU and
  on the CPU for that package; the simulator's clock, not a number of
  the port), with documented fallback constants when the files are
  absent;
* traffic generators (:func:`diurnal_trace`, :func:`spike_trace`) —
  bursty multi-tenant arrival schedules, deterministic per seed;
* :class:`FleetSim` — wires shared :class:`MemStore` registries, a
  :class:`LeaseStore` per router, chaos events (router SIGKILL, lease
  expiry, lease steal, registry partition, replica kill), client-side
  ``tenant_home`` routing, and the end-state :meth:`FleetSim.check`
  that asserts the exactness invariants.

The virtual tick advances by the MAX cost any stepped replica reported
(replicas step in parallel; routers are control-plane cheap), plus an
idle floor so arrival schedules always make progress.
"""
from __future__ import annotations

import json
import math
import os
import random
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from paddle_tpu_torch.distributed.replica_registry import MemStore, ReplicaRegistry
from paddle_tpu_torch.serving.fleet.controller import (
    FleetController, LoadThresholdPolicy,
)
from paddle_tpu_torch.serving.fleet.lease import LeaseStore
from paddle_tpu_torch.serving.fleet.replica import ReplicaHandle, ReplicaLoad
from paddle_tpu_torch.serving.fleet.router import FleetConfig, FleetRouter
from paddle_tpu_torch.serving.fleet.tenant import tenant_home
from paddle_tpu_torch.serving.request import RequestOutput, SamplingParams
from paddle_tpu_torch.testing import faults
from paddle_tpu_torch.testing.faults import Fault

__all__ = ["VirtualClock", "LatencyModel", "SimReplica", "Arrival",
           "ChaosEvent", "diurnal_trace", "spike_trace", "FleetSim",
           "sim_token"]


def sim_token(request_id: str, pos: int) -> int:
    """The deterministic token at absolute position ``pos`` of
    ``request_id``'s stream. Position-keyed, so a duplicated or lost
    position is detectable from the values alone."""
    return zlib.crc32(f"{request_id}:{pos}".encode()) % 32000 + 1


class VirtualClock:
    """Simulated monotonic time. Inject ``clock.now`` as the ``_mono``
    of every registry/lease-store reader so TTLs run on virtual
    seconds."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        self._t += max(0.0, float(dt))


@dataclass
class LatencyModel:
    """Virtual step costs, taken from the JAX package's serving benches
    (its measurements, not the port's: they pace the virtual clock only).

    Fallback constants are the r05–r08 measurements baked in, so the
    simulator behaves identically whether or not the JSON files are
    present:

    * ``decode_step_s`` — BENCH_serving_r05: 213.03 fleet tokens/s over
      2 replicas → ~9.4 ms per replica decode step;
    * ``prefill_s_per_token`` — BENCH_serving_r07: 8.76 ms cold TTFT
      over a 104-token prompt → ~0.084 ms/token;
    * ``rpc_s`` — per-step control-plane overhead (~2.2 ms measured
      RPC round-trip);
    * ``kv_ship_s`` / ``peer_ship_s`` — BENCH_serving_r06 (17.786 ms
      relay ship) and r08 (6.996 ms peer ship); unused by
      :class:`SimReplica` (no KV capability) but kept so a future
      disaggregated sim prices transfers consistently.
    """

    decode_step_s: float = 2.0 / 213.03
    prefill_s_per_token: float = 8.76e-3 / 104.0
    rpc_s: float = 2.181e-3
    kv_ship_s: float = 17.786e-3
    peer_ship_s: float = 6.996e-3

    @classmethod
    def from_bench(cls, bench_dir: str = ".") -> "LatencyModel":
        def load(name):
            try:
                with open(os.path.join(bench_dir, name)) as f:
                    return json.load(f)
            except (OSError, ValueError):
                return None

        kw = {}
        r05 = load("BENCH_serving_r05.json")
        if r05 and float(r05.get("value") or 0) > 0:
            kw["decode_step_s"] = 2.0 / float(r05["value"])
        r07 = load("BENCH_serving_r07.json")
        if r07:
            extra = r07.get("extra") or {}
            cold = float((extra.get("affine") or {}).get(
                "ttft_cold_ms") or 0)
            plen = float(extra.get("prompt_len") or 0)
            if cold > 0 and plen > 0:
                kw["prefill_s_per_token"] = cold * 1e-3 / plen
        r06 = load("BENCH_serving_r06.json")
        if r06:
            ship = float((r06.get("extra") or {}).get(
                "fleet_kv_ship_ms_avg") or 0)
            if ship > 0:
                kw["kv_ship_s"] = ship * 1e-3
        r08 = load("BENCH_serving_r08.json")
        if r08:
            ship = float(((r08.get("extra") or {}).get("peer") or {})
                         .get("ship_ms_avg") or 0)
            if ship > 0:
                kw["peer_ship_s"] = ship * 1e-3
        return cls(**kw)


class SimReplica(ReplicaHandle):
    """A replica with no engine: deterministic position-keyed tokens,
    measured-latency step costs, and the handle surface the router
    needs (including the inherited ``fence_request`` table). Admission
    is unbounded — load and cost scale with occupancy instead, so
    overload shows up as latency and autoscale pressure, never as
    non-deterministic rejects that would muddy the exactness checks."""

    def __init__(self, replica_id: str,
                 latency: Optional[LatencyModel] = None,
                 max_seqs: int = 8):
        self.replica_id = replica_id
        self.latency = latency or LatencyModel()
        self.max_seqs = max_seqs
        self.alive = True
        self.retiring = False
        self._draining = False
        # rid -> {"pos0", "max_new", "produced", "prompt_len",
        #          "prefilled"}; finished/aborted move to _done so
        # rng_state answers until release_request
        self._active: Dict[str, dict] = {}
        self._done: Dict[str, dict] = {}
        self.last_cost = 0.0
        self.num_steps = 0

    # -- dispatch-side reads ----------------------------------------------
    def admission_verdict(self, prompt_tokens: int) -> Optional[str]:
        if not self.alive:
            return "replica is dead"
        if self._draining or self.retiring:
            return "replica is draining"
        return None

    def estimated_ttft_ms(self, prompt_tokens: int) -> Optional[float]:
        lat = self.latency
        batches = 1 + len(self._active) / max(1, self.max_seqs)
        return (prompt_tokens * lat.prefill_s_per_token
                + batches * lat.decode_step_s) * 1e3

    def load(self) -> ReplicaLoad:
        n = len(self._active)
        return ReplicaLoad(queue_depth=0, num_running=n,
                           waiting_tokens=0,
                           kv_utilization=min(1.0, n / self.max_seqs))

    @property
    def is_draining(self) -> bool:
        return self._draining

    @property
    def drained(self) -> bool:
        return self._draining and not self._active

    def has_unfinished(self) -> bool:
        return self.alive and bool(self._active)

    # -- request lifecycle -------------------------------------------------
    def add_request(self, request_id: str, prompt_ids: Sequence[int],
                    sampling: SamplingParams, *, rng_state=None) -> None:
        if request_id in self._active:
            raise ValueError(f"duplicate request id {request_id!r}")
        self._done.pop(request_id, None)
        pos0 = 0
        if isinstance(rng_state, dict) and "pos" in rng_state:
            pos0 = int(rng_state["pos"])
        self._active[request_id] = {
            "pos0": pos0, "max_new": int(sampling.max_new_tokens),
            "produced": 0, "prompt_len": len(prompt_ids),
            "prefilled": False}

    def abort_request(self, request_id: str) -> bool:
        st = self._active.pop(request_id, None)
        if st is None:
            return False
        self._done[request_id] = st
        return True

    def release_request(self, request_id: str) -> None:
        self._active.pop(request_id, None)
        self._done.pop(request_id, None)

    def rng_state(self, request_id: str):
        st = self._active.get(request_id) or self._done.get(request_id)
        if st is None:
            return None
        return {"pos": st["pos0"] + st["produced"]}

    # -- stepping / drain --------------------------------------------------
    def step(self) -> List[RequestOutput]:
        if not self.alive:
            return []
        outs: List[RequestOutput] = []
        prefill_tokens = 0
        decoded = 0
        for rid, st in list(self._active.items()):
            if not st["prefilled"]:
                st["prefilled"] = True
                prefill_tokens += st["prompt_len"]
            st["produced"] += 1
            decoded += 1
            gen = [sim_token(rid, st["pos0"] + i)
                   for i in range(st["produced"])]
            finished = st["produced"] >= st["max_new"]
            outs.append(RequestOutput(
                request_id=rid, token=gen[-1], finished=finished,
                generated=gen,
                finish_reason="length" if finished else None))
            if finished:
                self._active.pop(rid)
                self._done[rid] = st
        cost = self.latency.rpc_s
        cost += prefill_tokens * self.latency.prefill_s_per_token
        if decoded:
            cost += self.latency.decode_step_s * math.ceil(
                decoded / max(1, self.max_seqs))
        self.last_cost = cost
        self.num_steps += 1
        return outs

    def start_drain(self, reason: str = "manual") -> List[RequestOutput]:
        self._draining = True
        outs: List[RequestOutput] = []
        for rid, st in list(self._active.items()):
            self._active.pop(rid)
            self._done[rid] = st
            gen = [sim_token(rid, st["pos0"] + i)
                   for i in range(st["produced"])]
            outs.append(RequestOutput(
                request_id=rid, token=None, finished=True,
                generated=gen, finish_reason="aborted:drain"))
        return outs

    def kill(self) -> None:
        """Chaos: the replica process dies between steps (the router's
        health sweep or mid-step death handling recovers)."""
        self.alive = False


# -- traffic ---------------------------------------------------------------
@dataclass
class Arrival:
    t: float
    tenant: str
    prompt_len: int
    max_new: int


@dataclass
class ChaosEvent:
    """One scheduled fault. Kinds:

    * ``router_kill`` — arg: router id; installs the targeted
      ``fleet.router_kill`` flag (in-process SIGKILL at its next step);
    * ``lease_expire`` — arg: optional rid (default: first in-flight
      leased request at fire time); drops+fails exactly one renewal;
    * ``lease_steal`` — arg: optional rid (same default); a peer
      force-adopts the live lease;
    * ``partition`` — arg: router id, ``duration_s``: how long the
      router is frozen from the store (no beats, no renews);
    * ``replica_kill`` — arg: replica id (default: first alive).
    """

    t: float
    kind: str
    arg: Optional[str] = None
    duration_s: float = 0.0


def diurnal_trace(*, duration_s: float, tenants: Sequence[str],
                  base_rps: float = 2.0, peak_rps: float = 10.0,
                  period_s: float = 60.0, prompt_len: int = 24,
                  max_new: int = 8, seed: int = 0) -> List[Arrival]:
    """Sinusoidal day/night load: arrival rate swings between
    ``base_rps`` and ``peak_rps`` over ``period_s``, tenants drawn
    uniformly, inter-arrival jitter ±30%. Deterministic per seed."""
    rng = random.Random(seed)
    out: List[Arrival] = []
    t = 0.0
    while t < duration_s:
        phase = 0.5 * (1.0 + math.sin(2.0 * math.pi * t / period_s))
        rate = base_rps + (peak_rps - base_rps) * phase
        t += (1.0 / rate) * rng.uniform(0.7, 1.3)
        if t >= duration_s:
            break
        out.append(Arrival(
            t=t, tenant=rng.choice(list(tenants)),
            prompt_len=max(1, prompt_len + rng.randint(-8, 8)),
            max_new=max(1, max_new + rng.randint(-2, 2))))
    return out


def spike_trace(*, duration_s: float, tenants: Sequence[str],
                base_rps: float = 1.0, spike_at: Sequence[float] = (),
                spike_n: int = 40, spike_tenant: Optional[str] = None,
                prompt_len: int = 24, max_new: int = 8,
                seed: int = 0) -> List[Arrival]:
    """Steady trickle plus thundering herds: ``spike_n`` requests land
    together at each ``spike_at`` instant (one tenant's burst — the
    DRR fairness case), on top of a uniform background."""
    rng = random.Random(seed)
    out: List[Arrival] = []
    t = 0.0
    while t < duration_s:
        t += (1.0 / base_rps) * rng.uniform(0.7, 1.3)
        if t >= duration_s:
            break
        out.append(Arrival(
            t=t, tenant=rng.choice(list(tenants)),
            prompt_len=prompt_len, max_new=max_new))
    for at in spike_at:
        tenant = spike_tenant or tenants[0]
        for _ in range(spike_n):
            out.append(Arrival(
                t=float(at), tenant=tenant,
                prompt_len=prompt_len, max_new=max_new))
    out.sort(key=lambda a: a.t)
    return out


# -- the harness -----------------------------------------------------------
@dataclass
class _Ledger:
    """Client-side view of one request, across every router."""

    tenant: str
    max_new: int
    submitted_to: str
    positions: Set[int] = field(default_factory=set)
    duplicate_positions: List[int] = field(default_factory=list)
    terminals: List[Tuple[str, str, List[int]]] = field(
        default_factory=list)  # (router_id, reason, generated)
    first_token_t: Optional[float] = None
    arrival_t: float = 0.0
    resubmitted: bool = False


class FleetSim:
    """N routers × M sim-replicas over one shared MemStore.

    ``run(arrivals, chaos=...)`` plays the schedule on the virtual
    clock; ``check()`` asserts the exactness invariants afterwards.
    Requests are routed client-side by :func:`tenant_home` over the
    routers the CLIENT currently believes are alive (its own
    TTL-delayed registry reader — a dead router keeps receiving
    traffic until its record goes stale, which is exactly the window
    the resubmission rule and the lease machinery must cover).
    """

    def __init__(self, n_replicas: int = 100, n_routers: int = 3,
                 latency: Optional[LatencyModel] = None,
                 max_seqs: int = 8, seed: int = 0,
                 config: Optional[FleetConfig] = None,
                 autoscale: Optional[LoadThresholdPolicy] = None):
        self.clock = VirtualClock()
        self.store = MemStore()
        self.latency = latency or LatencyModel()
        self.seed = seed
        self.cfg = config or FleetConfig(
            heartbeat_interval_s=0.0, registry_ttl_s=5.0,
            router_ttl_s=0.5, lease_ttl_s=0.8,
            # no engines → no KV to ship, no prefixes to advertise
            prefix_affinity=False, peer_data_plane=False)
        self.replicas: List[SimReplica] = [
            SimReplica(f"sr{i:03d}", latency=self.latency,
                       max_seqs=max_seqs)
            for i in range(n_replicas)]
        self.routers: List[FleetRouter] = []
        for j in range(n_routers):
            reg = ReplicaRegistry(self.store,
                                  ttl_s=self.cfg.registry_ttl_s)
            reg._mono = self.clock.now
            ls = LeaseStore(self.store, ttl_s=self.cfg.lease_ttl_s)
            ls._mono = self.clock.now
            r = FleetRouter(self.replicas, self.cfg, reg,
                            lease_store=ls, router_id=f"R{j}")
            r.router_registry._mono = self.clock.now
            self.routers.append(r)
        # the client's own (TTL-delayed) view of live routers
        self._client_reg = ReplicaRegistry(
            self.store, prefix="fleet_routers",
            ttl_s=self.cfg.router_ttl_s)
        self._client_reg._mono = self.clock.now
        self.ledger: Dict[str, _Ledger] = {}
        self.scale_events: List[dict] = []
        self._auto_id = 0
        self._controller: Optional[FleetController] = None
        if autoscale is not None:
            self._controller = FleetController(
                self.routers[0], self._spawn_replica, policy=autoscale)
        self._partition_heals: List[Tuple[float, FleetRouter]] = []
        self.ticks = 0

    # -- autoscale ---------------------------------------------------------
    def _spawn_replica(self, index: int) -> SimReplica:
        h = SimReplica(f"sr{len(self.replicas):03d}",
                       latency=self.latency,
                       max_seqs=self.replicas[0].max_seqs
                       if self.replicas else 8)
        self.replicas.append(h)
        # every router needs the handle (the controller's router is
        # attached by scale_to itself)
        for r in self.routers[1:]:
            r.attach_replica(h)
        return h

    # -- client side -------------------------------------------------------
    def _live_router(self, tenant: str) -> FleetRouter:
        view = sorted(self._client_reg.alive())
        ids = view or [r.router_id for r in self.routers
                       if not r.router_dead]
        home = tenant_home(tenant, ids)
        for r in self.routers:
            if r.router_id == home:
                return r
        return next(r for r in self.routers if not r.router_dead)

    def submit(self, arr: Arrival) -> str:
        rid = f"sim-{self._auto_id}"
        self._auto_id += 1
        router = self._live_router(arr.tenant)
        prompt = [((zlib.crc32(rid.encode()) + i) % 1000) + 1
                  for i in range(arr.prompt_len)]
        router.add_request(rid, prompt, SamplingParams(
            max_new_tokens=arr.max_new, tenant_id=arr.tenant))
        self.ledger[rid] = _Ledger(
            tenant=arr.tenant, max_new=arr.max_new,
            submitted_to=router.router_id, arrival_t=self.clock.now())
        return rid

    def _resubmit_unleased(self) -> None:
        """The one legitimate client retry: a request submitted to a
        router that died BEFORE ever leasing it left no trace in the
        store — no lease, no peer will adopt it. The client times out
        and resubmits to a live router. Requests with a lease are
        never resubmitted: the adoption machinery owns those."""
        probe = self.routers[0].lease_store
        live = [r for r in self.routers
                if not r.router_dead and not r.partitioned]
        if not live:
            return
        for r in self.routers:
            if not r.router_dead:
                continue
            for rid, fr in list(r._requests.items()):
                led = self.ledger.get(rid)
                if led is None or led.resubmitted or led.terminals:
                    continue
                if fr.finished or fr.lease_gen is not None:
                    continue
                if probe._load(rid) is not None:
                    continue  # leased (or adopted): not the client's job
                led.resubmitted = True
                # route by tenant_home over KNOWN-live routers — the
                # client registry may still list the dead one fresh
                home = tenant_home(
                    led.tenant, [x.router_id for x in live])
                target = next(x for x in live if x.router_id == home)
                target.add_request(
                    rid, list(fr.prompt_ids), fr.sampling)

    # -- chaos -------------------------------------------------------------
    def _fire_chaos(self, ev: ChaosEvent) -> None:
        inj = faults.active_injector()
        if ev.kind == "router_kill":
            inj.add(Fault.parse(f"fleet.router_kill:flag:{ev.arg}*1"))
        elif ev.kind in ("lease_expire", "lease_steal"):
            rid = ev.arg or self._pick_leased_rid()
            if rid is not None:
                inj.add(Fault.parse(f"fleet.{ev.kind}:flag:{rid}*1"))
        elif ev.kind == "partition":
            for r in self.routers:
                if r.router_id == ev.arg:
                    r.partitioned = True
                    self._partition_heals.append(
                        (self.clock.now() + ev.duration_s, r))
        elif ev.kind == "replica_kill":
            for h in self.replicas:
                if h.alive and (ev.arg is None
                                or h.replica_id == ev.arg):
                    h.kill()
                    break
        else:
            raise ValueError(f"unknown chaos kind {ev.kind!r}")

    def _pick_leased_rid(self) -> Optional[str]:
        for r in self.routers:
            if r.router_dead:
                continue
            for rid, fr in r._open.items():
                if fr.lease_gen is not None:
                    return rid
        return None

    # -- the loop ----------------------------------------------------------
    def _collect(self, router: FleetRouter,
                 outs: List[RequestOutput]) -> None:
        for out in outs:
            led = self.ledger.get(out.request_id)
            if led is None:
                continue
            if out.finished:
                led.terminals.append((router.router_id,
                                      out.finish_reason,
                                      list(out.generated)))
                continue
            pos = len(out.generated) - 1
            if pos in led.positions:
                led.duplicate_positions.append(pos)
            led.positions.add(pos)
            if led.first_token_t is None:
                led.first_token_t = self.clock.now()

    def run(self, arrivals: Sequence[Arrival],
            chaos: Sequence[ChaosEvent] = (),
            autoscale_every_s: float = 1.0,
            idle_dt: float = 0.005,
            max_virtual_s: float = 3600.0) -> None:
        arrivals = sorted(arrivals, key=lambda a: a.t)
        chaos = sorted(chaos, key=lambda e: e.t)
        ai = ci = 0
        next_autoscale = 0.0
        while True:
            now = self.clock.now()
            if now > max_virtual_s:
                raise AssertionError(
                    f"simulation did not quiesce within "
                    f"{max_virtual_s} virtual seconds")
            while ci < len(chaos) and chaos[ci].t <= now:
                self._fire_chaos(chaos[ci])
                ci += 1
            while ai < len(arrivals) and arrivals[ai].t <= now:
                self.submit(arrivals[ai])
                ai += 1
            for t_heal, r in list(self._partition_heals):
                if now >= t_heal:
                    r.partitioned = False
                    self._partition_heals.remove((t_heal, r))
            self._resubmit_unleased()
            if (self._controller is not None
                    and now >= next_autoscale):
                next_autoscale = now + autoscale_every_s
                target = self._controller.tick()
                if target is not None:
                    self.scale_events.append(
                        {"t": round(now, 3), "scale_to": target})
            stepped_cost = 0.0
            for r in self.routers:
                self._collect(r, r.step())
            for h in self.replicas:
                if h.num_steps:  # stepped by some router this tick
                    stepped_cost = max(stepped_cost, h.last_cost)
                    h.num_steps = 0
            self.clock.advance(stepped_cost or idle_dt)
            self.ticks += 1
            live = [r for r in self.routers
                    if not r.router_dead and not r.partitioned]
            busy = any(r.has_unfinished() for r in live)
            if (ai >= len(arrivals) and ci >= len(chaos)
                    and not self._partition_heals and not busy
                    and not any(ls.active() for ls in
                                (r.lease_store for r in live))):
                break

    # -- invariants --------------------------------------------------------
    def check(self) -> Dict[str, int]:
        """Assert the exactness invariants; returns summary counters.

        * every submitted request reached EXACTLY ONE client-visible
          terminal, across all routers;
        * its terminal stream is exactly ``[token(rid, 0..max_new-1)]``
          — every position once, none lost, none doubled;
        * no streamed position was ever emitted twice (across routers:
          a failover must not replay what the dead router delivered);
        * fleet-wide lease accounting is exact:
          ``acquired == completed + adopted + expired`` and no lease
          is still open;
        * per-router ticket accounting partitions
          (``sum(ticket_outcomes) == tickets_issued``).
        """
        problems: List[str] = []
        for rid, led in self.ledger.items():
            if len(led.terminals) != 1:
                problems.append(
                    f"{rid}: {len(led.terminals)} terminals "
                    f"{[(r, why) for r, why, _ in led.terminals]}")
                continue
            _, reason, gen = led.terminals[0]
            want = [sim_token(rid, i) for i in range(led.max_new)]
            if reason != "length" or gen != want:
                problems.append(
                    f"{rid}: terminal ({reason}) stream mismatch: "
                    f"want {led.max_new} exact tokens, got {len(gen)}")
            if led.duplicate_positions:
                problems.append(
                    f"{rid}: positions emitted twice: "
                    f"{sorted(set(led.duplicate_positions))}")
        acquired = sum(r.lease_store.num_acquired for r in self.routers)
        completed = sum(r.lease_store.num_completed
                        for r in self.routers)
        adopted = sum(r.lease_store.num_adopted for r in self.routers)
        expired = sum(r.lease_store.num_expired for r in self.routers)
        active = self.routers[0].lease_store.active()
        if active:
            problems.append(f"{active} leases still open at quiesce")
        if acquired != completed + adopted + expired:
            problems.append(
                f"lease buckets leak: acquired={acquired} != "
                f"completed={completed} + adopted={adopted} + "
                f"expired={expired}")
        for r in self.routers:
            if sum(r.ticket_outcomes.values()) != r.num_tickets_issued:
                problems.append(
                    f"{r.router_id}: ticket accounting leak")
        if problems:
            raise AssertionError(
                "fleet sim invariants violated:\n  "
                + "\n  ".join(problems[:20]))
        return {
            "requests": len(self.ledger),
            "ticks": self.ticks,
            "virtual_s": round(self.clock.now(), 3),
            "leases_acquired": acquired,
            "leases_completed": completed,
            "leases_adopted": adopted,
            "leases_expired": expired,
            "router_failovers": sum(r.num_router_failovers
                                    for r in self.routers),
            "requests_fenced": sum(r.num_requests_fenced
                                   for r in self.routers),
            "requests_handed_over": sum(r.num_requests_handed_over
                                        for r in self.routers),
            "scale_events": len(self.scale_events),
        }
