"""Fleet-level observability: router counters + aggregated snapshot (port
of the JAX package's ``serving/fleet/metrics.py``).

Mirrors :class:`~paddle_tpu_torch.serving.metrics.ServingMetrics` one level
up: every gauge registers a ``fleet/<name>#<id>`` profiler counter
provider (weakref'd — a dropped router unregisters itself), and
:meth:`FleetMetrics.snapshot` returns one dict of them all.

The ``fleet_finish`` histogram is the CLIENT-visible aggregate (one
bucket per request, from the router's bookkeeping); the nested
per-replica snapshots keep the engine-side ``serving_finish/*`` view,
which intentionally double-counts handed-off attempts (each donor
engine recorded an ``aborted:drain`` the client never saw).
"""
from __future__ import annotations

import time
import weakref
from typing import Dict, List

__all__ = ["FleetMetrics"]

def _mean(xs: List[float]) -> float:
    return sum(xs) / len(xs) if xs else 0.0


class FleetMetrics:
    """Owned by one :class:`~paddle_tpu_torch.serving.fleet.FleetRouter`."""

    GAUGES = ("dispatched", "handoffs", "handoff_exhausted",
              "rejected_fleetwide", "replicas_live", "tenant_waiting",
              "replicas_dead", "scale_ups", "scale_downs",
              "autoscale_decisions", "tokens_emitted",
              "kv_ship_requests", "kv_ship_blocks", "kv_ship_bytes",
              "kv_ship_ms_avg", "recompute_fallbacks",
              "tokens_recomputed", "prefix_hit_tokens",
              "prefix_affine_dispatches", "prefix_ships",
              "prefix_ship_bytes", "prefix_ship_failures",
              "kv_snapshot_skipped", "tickets_issued",
              "peer_ship_requests", "peer_ship_blocks",
              "peer_ship_bytes", "relay_fallbacks", "relay_bytes",
              "ship_skipped_expired", "session_parks",
              "session_resumes", "session_resume_recomputes",
              "session_hit_tokens", "session_offloads",
              "sessions_tracked", "router_failovers",
              "requests_fenced", "requests_handed_over",
              "leases_acquired", "leases_completed",
              "leases_adopted", "leases_expired", "leases_active",
              "lease_fence_refusals", "lease_renew_dropped")

    _ROUTER_GAUGES = {
        "dispatched": lambda r: r.num_dispatched,
        "handoffs": lambda r: r.num_handoffs,
        "handoff_exhausted": lambda r: r.num_handoff_exhausted,
        "rejected_fleetwide": lambda r: r.num_rejected_fleetwide,
        "replicas_live": lambda r: len(r.dispatchable()),
        "tenant_waiting": lambda r: len(r._queue),
        "replicas_dead": lambda r: r.num_replicas_dead,
        "scale_ups": lambda r: r.num_scale_ups,
        "scale_downs": lambda r: r.num_scale_downs,
        "autoscale_decisions": lambda r: r.num_autoscale_decisions,
        "tokens_emitted": lambda r: r.num_tokens_emitted,
        # KV-ship (disaggregated serving)
        "kv_ship_requests": lambda r: r.num_kv_ship_requests,
        "kv_ship_blocks": lambda r: r.num_kv_ship_blocks,
        "kv_ship_bytes": lambda r: r.num_kv_ship_bytes,
        "kv_ship_ms_avg": lambda r: round(
            r.kv_ship_time_s * 1e3 / r.num_kv_ship_requests, 3)
            if r.num_kv_ship_requests else 0.0,
        "recompute_fallbacks": lambda r: r.num_recompute_fallbacks,
        "tokens_recomputed": lambda r: r.num_tokens_recomputed,
        # fleet-global prefix cache (router side: advert-credited
        # dispatches and proactive ships)
        "prefix_hit_tokens": lambda r: r.num_prefix_hit_tokens,
        "prefix_affine_dispatches":
            lambda r: r.num_prefix_affine_dispatches,
        "prefix_ships": lambda r: r.num_prefix_ships,
        "prefix_ship_bytes": lambda r: r.num_prefix_ship_bytes,
        "prefix_ship_failures": lambda r: r.num_prefix_ship_failures,
        # peer data plane: ticketed worker<->worker transfers. The
        # kv_ship_* gauges above stay the AGGREGATE success counters
        # (peer or relay); these split the path taken and account every
        # issued ticket (sum(ticket_outcomes) == tickets_issued)
        "tickets_issued": lambda r: r.num_tickets_issued,
        "peer_ship_requests": lambda r: r.num_peer_ship_requests,
        "peer_ship_blocks": lambda r: r.num_peer_ship_blocks,
        "peer_ship_bytes": lambda r: r.num_peer_ship_bytes,
        "relay_fallbacks": lambda r: r.num_relay_fallbacks,
        "relay_bytes": lambda r: r.num_relay_bytes,
        "ship_skipped_expired": lambda r: r.num_ship_skipped_expired,
        # tiered-KV sessions: fleet-level park/resume/offload view
        # (the per-engine serving_kv_tier_* gauges keep the device/
        # host-pool occupancy side)
        "session_parks": lambda r: r.num_session_parks,
        "session_resumes": lambda r: r.num_session_resumes,
        "session_resume_recomputes":
            lambda r: r.num_session_resume_recomputes,
        "session_hit_tokens": lambda r: r.num_session_hit_tokens,
        "session_offloads": lambda r: r.num_session_offloads,
        "sessions_tracked": lambda r: len(r._sessions),
        # drain KV snapshots dropped at the frame cap, summed over
        # worker-backed handles
        "kv_snapshot_skipped": lambda r: sum(
            getattr(h, "num_kv_snapshot_skipped", 0)
            for h in r.replicas),
        # replicated control plane: this router's view. The lease_*
        # gauges count THIS router's LeaseStore incarnation buckets
        # (summed fleet-wide: acquired == completed + adopted +
        # expired + active); all zero in single-router mode
        "router_failovers": lambda r: r.num_router_failovers,
        "requests_fenced": lambda r: r.num_requests_fenced,
        "requests_handed_over": lambda r: r.num_requests_handed_over,
        "leases_acquired": lambda r: (
            r.lease_store.num_acquired if r.lease_store else 0),
        "leases_completed": lambda r: (
            r.lease_store.num_completed if r.lease_store else 0),
        "leases_adopted": lambda r: (
            r.lease_store.num_adopted if r.lease_store else 0),
        "leases_expired": lambda r: (
            r.lease_store.num_expired if r.lease_store else 0),
        "leases_active": lambda r: (
            r.lease_store.active() if r.lease_store else 0),
        # fencing-side refusals: stale-incarnation mutations turned
        # away, and renewals dropped after ownership moved (the
        # split-brain guards)
        "lease_fence_refusals": lambda r: (
            r.lease_store.num_fence_refusals if r.lease_store else 0),
        "lease_renew_dropped": lambda r: (
            r.lease_store.num_renew_dropped if r.lease_store else 0),
    }

    def __init__(self, router):
        self._router = weakref.ref(router)
        self._registered: List[str] = []
        self._register(router)

    def snapshot(self) -> Dict:
        r = self._router()
        if r is None:
            return {}
        dt = time.monotonic() - r.start_time
        out = {f"fleet_{name}": int(get(r))
               for name, get in self._ROUTER_GAUGES.items()}
        # the one float gauge — re-emit past the int() wrap above
        out["fleet_kv_ship_ms_avg"] = \
            self._ROUTER_GAUGES["kv_ship_ms_avg"](r)
        out["fleet_replicas_total"] = len(r.replicas)
        out["fleet_tokens_per_sec"] = round(
            r.num_tokens_emitted / dt if dt > 0 else 0.0, 2)
        out["fleet_load"] = round(r.load(), 4)
        # peek — consuming the window here would starve the autoscale
        # policy's view of the same signal
        out["fleet_tenant_load"] = round(
            r.tenant_load(consume=False), 4)
        out["fleet_finish"] = dict(sorted(r.finish_counts.items()))
        out["fleet_ticket_outcomes"] = dict(r.ticket_outcomes)
        tenants = {}
        waiting = r._queue.waiting_by_tenant()
        for t in sorted(set(waiting) | set(r.tenant_wait_s)
                        | set(r.tenant_dispatches)):
            waits = r.tenant_wait_s.get(t, [])
            tenants[t] = {
                "waiting": waiting.get(t, 0),
                "dispatched": len(waits),
                # every dispatch, continuations and handoff retries
                # included ("dispatched" above counts first dispatches)
                "dispatches_total": r.tenant_dispatches.get(t, 0),
                "wait_ms_avg": round(_mean(waits) * 1e3, 3),
                "wait_ms_max": round(max(waits) * 1e3, 3) if waits
                else 0.0,
            }
        out["fleet_tenants"] = tenants
        replicas = {}
        for h in r.replicas:
            rec = {"alive": bool(h.alive),
                   "draining": bool(h.is_draining),
                   "retiring": bool(h.retiring)}
            snap = getattr(h, "snapshot", None)
            if callable(snap):
                try:
                    rec.update(snap())
                except Exception:
                    pass  # a dead handle's snapshot is best-effort
            replicas[h.replica_id] = rec
        out["replicas"] = replicas
        # fleet-wide prefix-cache hit rate: engine-counted hit tokens
        # over ALL submitted prompt tokens (num_prompt_tokens counts
        # only COMPUTED prompt tokens, so submitted = hit + computed)
        hit = sum(int(rec.get("serving_prefix_cache_hit_tokens", 0))
                  for rec in replicas.values())
        computed = sum(int(rec.get("num_prompt_tokens", 0))
                       for rec in replicas.values())
        out["fleet_prefix_hit_rate"] = round(
            hit / (hit + computed), 4) if hit + computed else 0.0
        return out

    # -- profiler counter providers --------------------------------------
    def _register(self, router):
        from paddle_tpu_torch import profiler

        ref = weakref.ref(router)

        def provider(name):
            def get():
                r = ref()
                if r is None:
                    return None  # counters() drops dead providers
                return FleetMetrics._ROUTER_GAUGES[name](r)
            return get

        for g in self.GAUGES:
            cname = f"fleet/{g}#{id(router)}"
            profiler.register_counter_provider(cname, provider(g))
            self._registered.append(cname)
        weakref.finalize(router, _unregister_all,
                         list(self._registered))


def _unregister_all(names):
    from paddle_tpu_torch import profiler

    for n in names:
        profiler.unregister_counter_provider(n)
