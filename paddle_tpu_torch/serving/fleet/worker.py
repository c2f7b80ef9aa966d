"""Replica worker process: ``python -m paddle_tpu_torch.serving.fleet.worker``
(port of the JAX package's ``serving/fleet/worker.py``).

One process, one engine: wraps an :class:`InProcessReplica` in a
:class:`~paddle_tpu_torch.serving.fleet.transport.ReplicaServicer` and
serves the ``ReplicaHandle`` verb set over the socket the supervisor
passed down. The worker IS the failure domain — SIGKILL here kills an
engine and nothing else, and the supervisor/router recover.

Env protocol (set by :class:`ReplicaSupervisor`):

  PADDLE_REPLICA_FD     inherited socketpair fd to serve on (required)
  PADDLE_REPLICA_ID     replica id (also the registry heartbeat key)
  PADDLE_REPLICA_SPEC   JSON worker spec::

        {"model": "tiny_llama" | "pkg.module:factory",
         "seed": 0, "device": "cpu" | "cuda" | null,
         "engine": {...EngineConfig kwargs...},
         "role": "prefill" | "decode" | null,
         "peer": true | false,
         "tcp": true | false}

    ``peer`` (default true) opens the worker's :class:`PeerListener`
    — the direct worker↔worker KV data plane — and advertises its
    endpoint in the heartbeat meta next to the role.

    ``tcp`` (default false) additionally opens a TCP control listener
    and advertises it in the heartbeat meta as ``rpc`` — the
    replicated-control-plane mode: router processes OTHER than the
    spawning supervisor discover the endpoint from the registry and
    drive this worker over their own connections
    (:meth:`ReplicaServicer.serve_multi`), so a SIGKILLed router only
    drops its connection and the worker keeps serving everyone else.

    ``tiny_llama`` builds the deterministic tiny Llama
    (``LlamaConfig.tiny()``, weights from a generator seeded with
    ``seed`` — the same seed gives every process identical weights,
    which is what makes cross-process hand-off bit-identical; they are
    not the JAX package's tiny weights). ``module:factory`` imports and
    calls ``factory(spec_dict)`` for real models (or for weights carried
    across from the JAX package). ``device`` places the engine: the card
    unless it says ``"cpu"``; a worker initialises CUDA itself (it is a
    fresh interpreter, never a forked child).
  PADDLE_REPLICA_STORE  FileStore directory for registry heartbeats
                        (optional — no store, no heartbeat thread)
  PADDLE_REPLICA_HB     heartbeat interval seconds (default 0.5)
  PADDLE_FAULTS         inherited; the in-worker fault points
                        (serving.step etc.) work as in-process

Lifecycle: serve until EOF (supervisor closed the socket or the
parent died), an explicit ``shutdown`` verb, or — the SIGTERM drain
path — the preemption monitor has fired AND the engine has drained
AND the final outputs were already delivered in a reply. SIGTERM
itself only sets the monitor flag (no work in signal handlers); the engine starts its drain at the next ``step``
RPC and the aborts ride back to the router with their RNG states.

Threading: the service loop is single-threaded. Two extra daemon
threads exist, neither of which touches the engine: the registry
heartbeat (sharing only the stop event and the lock-guarded
:class:`_HeartbeatMeta` box the service loop publishes its prefix
digest into after each reply) and the peer listener's accept loop
(staging inbound KV frames behind its own lock until the router's
``peer_commit`` verb imports them ON the service loop). A heartbeat
can never observe a half-stepped engine, and a peer delivery can
never race one.
"""
from __future__ import annotations

import importlib
import json
import os
import socket
import threading
from typing import Optional


class _HeartbeatMeta:
    """The ONLY state the heartbeat thread shares with the service
    loop: a dict of JSON-shaped meta values behind one lock. The
    service loop writes (``update``) between replies; the heartbeat
    thread reads a copy (``get``) each beat. Values are replaced whole,
    never mutated in place, so a reader can never see a torn entry."""

    def __init__(self, initial: Optional[dict] = None):
        self._lock = threading.Lock()
        self._meta = dict(initial or {})

    def update(self, **kw) -> None:
        with self._lock:
            for k, v in kw.items():
                if v is None:
                    self._meta.pop(k, None)
                else:
                    self._meta[k] = v

    def get(self) -> dict:
        with self._lock:
            return dict(self._meta)


def build_model(spec: dict):
    name = spec.get("model", "tiny_llama")
    if name == "tiny_llama":
        import torch

        from paddle_tpu_torch.models.llama import (
            LlamaConfig, LlamaForCausalLM,
        )

        model = LlamaForCausalLM(LlamaConfig.tiny(),
                                 device=spec.get("device"))
        gen = torch.Generator(device=model.device)
        return model.init_weights(gen.manual_seed(int(spec.get("seed", 0))))
    if ":" in name:
        mod_name, _, fn_name = name.partition(":")
        factory = getattr(importlib.import_module(mod_name), fn_name)
        return factory(spec)
    raise ValueError(f"unknown worker model spec {name!r}")


def _start_heartbeat(replica_id: str, store_dir: str, interval_s: float,
                     ttl_s: float,
                     meta: _HeartbeatMeta = None) -> threading.Event:
    """Daemon heartbeat thread. Isolated on purpose: it builds its own
    store/registry and touches nothing the service loop owns except the
    lock-guarded ``meta`` box. The record's meta carries the worker's
    disaggregation ``role`` (so a restarted router re-learns the fleet
    topology from the registry) and the engine's current ``prefix``
    digest (the fleet prefix-cache advertisement)."""
    from paddle_tpu_torch.distributed.replica_registry import ReplicaRegistry
    from paddle_tpu_torch.distributed.store import FileStore

    stop = threading.Event()
    meta = meta or _HeartbeatMeta()

    def beat():
        reg = ReplicaRegistry(FileStore(store_dir), ttl_s=ttl_s)
        while True:
            try:
                reg.heartbeat(replica_id, meta=meta.get())
            except OSError:
                pass  # store dir vanished (teardown); keep trying
            if stop.wait(interval_s):
                return

    threading.Thread(target=beat, daemon=True,
                     name=f"replica-hb-{replica_id}").start()
    return stop


def main() -> int:
    fd = int(os.environ["PADDLE_REPLICA_FD"])
    replica_id = os.environ.get("PADDLE_REPLICA_ID", f"worker-{os.getpid()}")
    spec = json.loads(os.environ.get("PADDLE_REPLICA_SPEC", "{}"))
    store_dir = os.environ.get("PADDLE_REPLICA_STORE", "")
    hb_interval = float(os.environ.get("PADDLE_REPLICA_HB", "0.5"))
    ttl_s = float(os.environ.get("PADDLE_REPLICA_TTL", "5.0"))

    sock = socket.socket(fileno=fd)

    # Import order matters for startup latency: the model (and torch)
    # load AFTER the socket exists, so the supervisor's first ping just
    # waits on a deadline rather than a filesystem race.
    from paddle_tpu_torch.distributed.watchdog import PreemptionMonitor
    from paddle_tpu_torch.serving.engine import EngineConfig
    from paddle_tpu_torch.serving.fleet.replica import InProcessReplica
    from paddle_tpu_torch.serving.fleet.transport import ReplicaServicer

    model = build_model(spec)
    monitor = PreemptionMonitor()
    monitor.install()
    role = spec.get("role") or None
    replica = InProcessReplica(
        model, EngineConfig(**spec.get("engine", {})),
        replica_id=replica_id, monitor=monitor, role=role)

    hb_meta = _HeartbeatMeta({"pid": os.getpid()})
    if role:
        hb_meta.update(role=role)
    hb_meta.update(prefix=replica.prefix_digest())

    # peer data plane: open the worker's listener (a second daemon
    # thread — pure staging, never touches the engine; see PeerListener)
    # and advertise its endpoint next to the role, so the router learns
    # where to ticket KV pushes even across its own restarts.
    if spec.get("peer", True):
        try:
            hb_meta.update(peer=replica.start_peer())
        except OSError:
            pass  # no listener — the router relays, as before

    # replicated control plane: a TCP listener beside the supervisor
    # socketpair, advertised through the heartbeat so ANY router can
    # connect (and a replacement router can reconnect after failover)
    rpc_listener = None
    if spec.get("tcp", False):
        try:
            rpc_listener = socket.socket(socket.AF_INET,
                                         socket.SOCK_STREAM)
            rpc_listener.setsockopt(socket.SOL_SOCKET,
                                    socket.SO_REUSEADDR, 1)
            rpc_listener.bind(("127.0.0.1", 0))
            rpc_listener.listen(16)
            host, port = rpc_listener.getsockname()
            hb_meta.update(rpc=f"{host}:{port}")
        except OSError:
            rpc_listener = None  # supervisor socketpair only

    hb_stop = None
    if store_dir:
        hb_stop = _start_heartbeat(replica_id, store_dir, hb_interval,
                                   ttl_s, meta=hb_meta)

    def on_tick() -> None:
        if store_dir:
            # service-loop side of the advertisement: refresh the
            # digest after each reply (O(1) between trie changes); the
            # next beat carries it to the registry
            hb_meta.update(prefix=replica.prefix_digest())
        if replica.peer_listener is not None:
            replica.peer_listener.gc()  # orphan-ticket sweep

    def drained_out() -> bool:
        # SIGTERM path: the drain aborts (with RNG states) went out in
        # the reply we just wrote; nothing left to serve.
        return (monitor.requested() and replica.drained
                and not replica.has_unfinished())

    try:
        servicer = ReplicaServicer(replica, on_tick=on_tick)
        if rpc_listener is not None:
            servicer.serve_multi(sock, listener=rpc_listener,
                                 should_stop=drained_out)
        else:
            servicer.serve(sock, should_stop=drained_out)
    finally:
        if hb_stop is not None:
            hb_stop.set()
        for s in (sock, rpc_listener):
            if s is None:
                continue
            try:
                s.close()
            except OSError:
                pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
