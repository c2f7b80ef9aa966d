"""The port's replicated control plane against the JAX package's:
``tests/test_fleet_routers.py`` (rendezvous, leases, fencing,
``SimReplica``, twin routers, the supervisor's restart key, ``FleetSim``)
runs again with every JAX-package name bound to the port's, through
``test_torch_fleet.ported`` (see that module's docstring).

Then the two packages side by side: seeded ``FleetSim`` runs (chaos, a
partition, a tenant spike with the tenant-aware autoscaler) give the
same summaries, terminals, scale events and router snapshots, and the
primitives (rendezvous owners, tenant homes, a DRR storm, a lease's
lifecycle, ticket signatures, a binary frame's bytes) decide alike."""
import importlib
import random
import socket

import pytest

import test_fleet_routers
from test_torch_fleet import _one_torch_thread, _stable, export  # noqa: F401

PORT = export(test_fleet_routers, globals())


# ---------------------------------------------------------------------------
# both packages side by side: the array-free control plane
# ---------------------------------------------------------------------------
_PKGS = ("paddle_tpu", "paddle_tpu_torch")


def _fleet(pkg):
    return importlib.import_module(f"{pkg}.serving.fleet")


def _sim_small_chaos(F):
    sim = F.FleetSim(n_replicas=12, n_routers=2, seed=1)
    trace = F.diurnal_trace(duration_s=6.0, tenants=["a", "b", "c"],
                            base_rps=3, peak_rps=12, period_s=4, seed=1)
    chaos = [F.ChaosEvent(t=1.0, kind="router_kill", arg="R0"),
             F.ChaosEvent(t=2.0, kind="lease_expire"),
             F.ChaosEvent(t=3.0, kind="lease_steal"),
             F.ChaosEvent(t=4.0, kind="replica_kill")]
    sim.run(trace, chaos=chaos, max_virtual_s=120.0)
    return sim


def _sim_partition(F):
    sim = F.FleetSim(n_replicas=12, n_routers=3, seed=2)
    trace = F.diurnal_trace(duration_s=6.0, tenants=["a", "b"],
                            base_rps=4, peak_rps=8, period_s=4, seed=2)
    sim.run(trace, chaos=[F.ChaosEvent(t=1.0, kind="partition", arg="R1",
                                       duration_s=1.5)],
            max_virtual_s=120.0)
    return sim


def _sim_tenant_spike(F):
    sim = F.FleetSim(n_replicas=12, n_routers=1, seed=7,
                     autoscale=F.LoadThresholdPolicy(
                         high=0.95, low=0.0, max_replicas=20,
                         tenant_high=0.6))
    trace = F.spike_trace(duration_s=8.0, tenants=["a", "b", "c", "hot"],
                          base_rps=4, spike_at=[2.0], spike_n=40,
                          spike_tenant="hot", max_new=8, seed=7)
    sim.run(trace, autoscale_every_s=0.05, max_virtual_s=240.0)
    return sim


@pytest.mark.parametrize("scenario", [_sim_small_chaos, _sim_partition,
                                      _sim_tenant_spike],
                         ids=["chaos", "partition", "tenant_spike"])
def test_fleet_sim_runs_identically_in_both_packages(scenario):
    """A seeded ``FleetSim`` (virtual clock, no engines) through both
    packages: the same summary, every request's terminal (router,
    reason, stream), the scale events and each router's snapshot."""
    got = []
    for pkg in _PKGS:
        sim = scenario(_fleet(pkg))
        summary = sim.check()
        terminals = {rid: [tuple(t) for t in led.terminals]
                     for rid, led in sim.ledger.items()}
        got.append((summary, terminals, list(sim.scale_events),
                    [_stable(r.snapshot()) for r in sim.routers]))
    assert got[0] == got[1]
    assert got[1][0]["requests"] > 20


def test_rendezvous_drr_leases_and_tickets_match_the_reference():
    """The control plane's primitives decide alike in both packages:
    rendezvous owners and tenant homes over 300 keys, a DRR queue's pop
    order under a random push / pop / unpop storm, a lease store's
    lifecycle and buckets, and a signed ticket's signature."""
    rng = random.Random(5)
    keys = [f"k{rng.randrange(10 ** 6)}" for _ in range(300)]
    owners = [f"R{i}" for i in range(5)]
    got = []
    for pkg in _PKGS:
        F = _fleet(pkg)
        reg = importlib.import_module(
            f"{pkg}.distributed.replica_registry")
        out = {"owners": [F.rendezvous_owner(k, owners) for k in keys],
               "homes": [F.tenant_home(k, owners[:3]) for k in keys]}
        q = F.TenantQueue(weights={"a": 1, "b": 2})
        r2 = random.Random(9)
        pops = []
        for i in range(400):
            op = r2.random()
            if op < 0.55:
                q.push(r2.choice("abcd"), f"i{i}", r2.randrange(1, 64))
            else:
                p = q.pop()
                pops.append(p)
                if p is not None and r2.random() < 0.1:
                    q.unpop(*p)
        out["drr"] = pops
        store = reg.MemStore()
        ls = F.LeaseStore(store, ttl_s=0.5)
        gen = ls.acquire("r1", "R0", {"progress": 0})
        steps = [gen, ls.renew("r1", "R0", gen, progress=3),
                 ls.renew("r1", "R1", gen, progress=4),
                 ls.acquire("r1", "R1", {"progress": 0}),
                 ls.release("r1", "R0", gen), ls.active()]
        steps.append({k: getattr(ls, k) for k in (
            "num_acquired", "num_completed", "num_adopted", "num_expired",
            "num_fence_refusals", "num_renew_dropped")})
        out["lease"] = steps
        transport = importlib.import_module(
            f"{pkg}.serving.fleet.transport")
        ticket = {"ticket_id": "t1", "src": "a", "dst": "b", "kind": "kv",
                  "request_id": "r9", "deadline_ms": 500}
        out["sig"] = transport.sign_ticket(ticket, b"secret")
        a, b = socket.socketpair()
        try:
            transport.send_frame_with_blob(a, {"id": 3, "x": [1, 2]},
                                           b"\x00\x01payload")
            a.close()
            chunks = []
            while True:
                c = b.recv(65536)
                if not c:
                    break
                chunks.append(c)
        finally:
            b.close()
        out["frame"] = b"".join(chunks)
        got.append(out)
    assert got[0] == got[1]
