"""ReplicaSupervisor — spawn, watch, and restart worker processes (port
of the JAX package's ``serving/fleet/supervisor.py``).

The process-level half of the fleet's failure story: the router
decides what a dead replica MEANS (re-enqueue its requests), the
supervisor decides what to DO about the dead process (restart it,
with capped exponential backoff so a crash-looping worker cannot storm
the host). The two meet only at the ``ReplicaHandle``/registry seam:

* :meth:`spawn` forks ``python -m paddle_tpu_torch.serving.fleet.worker``
  over an inherited ``socketpair`` (no ports, no filesystem races),
  waits for the worker's first ``ping``, and returns a
  :class:`SubprocessReplica` (attached to the router when one was
  given);
* workers heartbeat the supervisor's **FileStore-backed registry**
  themselves; the router's health sweep reads the same registry, so
  hang detection (process alive, engine wedged) needs no extra wiring;
* :meth:`poll` notices dead handles (process exit, connection loss,
  RPC-declared death) and relaunches the slot under a **new
  generation id** (``w0-g0`` → ``w0-g1`` — the dead handle keeps its
  id in the router's books; ids are never reused) after a backoff
  that doubles per consecutive failure up to a cap, and gives up for
  good past ``max_restarts`` consecutive failures;
* :meth:`make_replica` is a ready-made ``replica_factory`` for
  :class:`FleetController`, so ``scale_to`` works unchanged on
  subprocess fleets.

Failure detection summary (who notices what):

===========================  =========================================
process exit                 ``SubprocessReplica.alive`` (``poll()``)
                             and the client's EOF, immediately
hang (process up, no beat)   registry heartbeat TTL → router sweep
hang (beats, engine wedged)  per-call RPC deadline exhaustion
===========================  =========================================
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import socket
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from paddle_tpu_torch.distributed.replica_registry import ReplicaRegistry
from paddle_tpu_torch.distributed.store import FileStore
from paddle_tpu_torch.serving.fleet.transport import (
    ReplicaGone, RpcClient, RpcError, SubprocessReplica, peer_secret,
)

__all__ = ["WorkerSpec", "SupervisorConfig", "ReplicaSupervisor"]


@dataclass
class WorkerSpec:
    """What each worker process builds (see worker.py env protocol)."""

    model: str = "tiny_llama"
    seed: int = 0
    # the engine's device: None = the card, "cpu" serves on the CPU
    device: Optional[str] = None
    engine: Dict = field(default_factory=dict)
    # disaggregated serving: "prefill" | "decode" | None (serve both).
    # The default for every slot; spawn(role=...) overrides per slot.
    # The worker advertises it in its registry heartbeat meta, so a
    # router re-learns roles after a supervisor restart
    role: Optional[str] = None
    # peer data plane: open a PeerListener in each worker and advertise
    # its endpoint (heartbeat meta + ping reply). False pins the fleet
    # to the router-relay path — the bench comparison knob.
    peer: bool = True
    # replicated control plane: open a TCP control listener in each
    # worker and advertise it in the heartbeat meta as "rpc", so router
    # processes other than the spawning supervisor can drive the worker
    # (and a replacement router can reconnect after a failover).
    tcp: bool = False


@dataclass
class SupervisorConfig:
    store_dir: str = ""              # FileStore dir for heartbeats
    ttl_s: float = 5.0               # registry liveness TTL
    hb_interval_s: float = 0.5      # worker heartbeat cadence
    spawn_timeout_s: float = 180.0  # first ping (imports + model build)
    deadlines: Optional[Dict[str, float]] = None  # RpcClient overrides
    restart_backoff_s: float = 0.25
    restart_backoff_max_s: float = 8.0
    max_restarts: int = 3           # consecutive failures per slot
    stable_after_s: float = 30.0    # alive this long resets the budget
    env: Dict[str, str] = field(default_factory=dict)


class _Slot:
    """One logical worker position across its restart generations."""

    def __init__(self, name: str):
        self.name = name
        self.generation = 0
        self.role: Optional[str] = None   # sticky across restarts
        self.proc: Optional[subprocess.Popen] = None
        self.handle: Optional[SubprocessReplica] = None
        self.restarts = 0            # consecutive, reset when stable
        self.backoff_s: Optional[float] = None
        self.next_restart_at: Optional[float] = None
        self.failed = False          # out of restart budget
        # generation ids (w0-g2, ...) whose death was already answered
        # with a restart: the restart key is (worker id, GENERATION),
        # not the worker id alone — two routers sharing a supervisor
        # view after an adoption can re-observe the same corpse, and a
        # corpse must never buy a second restart of a slot whose
        # replacement is already alive
        self.handled_gens: set = set()


class ReplicaSupervisor:
    def __init__(self, spec: Optional[WorkerSpec] = None,
                 config: Optional[SupervisorConfig] = None,
                 router=None):
        self.spec = spec or WorkerSpec()
        self.cfg = config or SupervisorConfig()
        if not self.cfg.store_dir:
            raise ValueError("SupervisorConfig.store_dir is required "
                             "(workers heartbeat through a FileStore)")
        os.makedirs(self.cfg.store_dir, exist_ok=True)
        self.registry = ReplicaRegistry(FileStore(self.cfg.store_dir),
                                        ttl_s=self.cfg.ttl_s)
        self.router = router
        self._slots: Dict[str, _Slot] = {}
        self._auto = itertools.count()
        self.num_spawns = 0
        self.num_restarts = 0

    # -- spawning ----------------------------------------------------------
    def spawn(self, slot_name: Optional[str] = None,
              role: Optional[str] = None) -> SubprocessReplica:
        """Launch a worker in a (new or named) slot; attaches the handle
        to the router when the supervisor owns one. ``role`` pins the
        slot to one side of a disaggregated fleet — sticky, so a
        restarted slot rejoins the same side."""
        if slot_name is None:
            while True:
                slot_name = f"w{next(self._auto)}"
                if slot_name not in self._slots:
                    break
        slot = self._slots.setdefault(slot_name, _Slot(slot_name))
        if role is not None:
            if role not in ("prefill", "decode"):
                raise ValueError(
                    f"role must be 'prefill' or 'decode', got {role!r}")
            slot.role = role
        handle = self._launch(slot)
        if self.router is not None:
            self.router.attach_replica(handle)
        return handle

    def make_replica(self, index: int) -> SubprocessReplica:
        """``FleetController`` replica_factory: the controller attaches
        the returned handle itself, so no double-attach here."""
        router, self.router = self.router, None
        try:
            return self.spawn()
        finally:
            self.router = router

    def _launch(self, slot: _Slot) -> SubprocessReplica:
        rid = f"{slot.name}-g{slot.generation}"
        slot.generation += 1  # even a failed boot retires the id
        parent, child = socket.socketpair()
        env = os.environ.copy()
        env.update(self.cfg.env)
        env["PADDLE_REPLICA_FD"] = str(child.fileno())
        env["PADDLE_REPLICA_ID"] = rid
        role = slot.role or self.spec.role
        spec_dict = dataclasses.asdict(self.spec)
        spec_dict["role"] = role
        env["PADDLE_REPLICA_SPEC"] = json.dumps(spec_dict)
        env["PADDLE_REPLICA_STORE"] = self.cfg.store_dir
        env["PADDLE_REPLICA_HB"] = str(self.cfg.hb_interval_s)
        env["PADDLE_REPLICA_TTL"] = str(self.cfg.ttl_s)
        # the worker imports this package whatever its working directory
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH")) if p)
        if self.spec.peer:
            # mint the fleet-shared ticket secret BEFORE the fork so
            # the worker inherits it (peer_secret() is env-idempotent)
            peer_secret()
        proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.serving.fleet.worker"],
            env=env, pass_fds=[child.fileno()])
        child.close()
        client = RpcClient(parent, name=rid,
                           default_deadline_s=self.cfg.spawn_timeout_s)
        handle = SubprocessReplica(rid, client, proc=proc,
                                   deadlines=self.cfg.deadlines,
                                   role=role)
        try:
            pong = client.call("ping", deadline_s=self.cfg.spawn_timeout_s)
        except (RpcError, OSError) as e:
            client.close()
            proc.kill()
            proc.wait(timeout=10)
            raise RuntimeError(f"worker {rid} failed to boot: {e}")
        if isinstance(pong, dict) and pong.get("peer"):
            # first sight of the worker's peer endpoint; the registry
            # heartbeat meta keeps it fresh after router restarts
            handle.peer_endpoint = pong["peer"]
        slot.proc, slot.handle = proc, handle
        self.num_spawns += 1
        return handle

    # -- watching / restarting ---------------------------------------------
    def handles(self) -> List[SubprocessReplica]:
        return [s.handle for s in self._slots.values()
                if s.handle is not None]

    def poll(self) -> List[dict]:
        """One watch pass: reap exits, schedule/execute restarts.
        Call it from the serving loop (between router steps). Returns
        the events taken, for logs and tests."""
        events: List[dict] = []
        now = time.monotonic()
        for slot in self._slots.values():
            h = slot.handle
            if h is None or slot.failed:
                continue
            if h.alive:
                if (slot.restarts and now - h.created_at
                        >= self.cfg.stable_after_s):
                    slot.restarts = 0     # survived: restore the budget
                    slot.backoff_s = None
                continue
            if h.retiring:
                continue  # scale-down drain finishing; not a crash
            gen_id = h.replica_id
            if gen_id in slot.handled_gens:
                continue  # this generation's death already bought its
                # restart; a re-observed corpse is not a new failure
            self._reap(slot)
            if slot.next_restart_at is None:
                if slot.restarts >= self.cfg.max_restarts:
                    slot.failed = True
                    events.append({"slot": slot.name, "event": "failed",
                                   "restarts": slot.restarts})
                    continue
                slot.backoff_s = (self.cfg.restart_backoff_s
                                  if slot.backoff_s is None else
                                  min(slot.backoff_s * 2.0,
                                      self.cfg.restart_backoff_max_s))
                slot.next_restart_at = now + slot.backoff_s
                events.append({"slot": slot.name, "event": "backoff",
                               "delay_s": slot.backoff_s})
                continue
            if now < slot.next_restart_at:
                continue
            slot.next_restart_at = None
            slot.restarts += 1
            try:
                handle = self._launch(slot)
            except RuntimeError:
                continue  # boot failed; next poll reschedules
            slot.handled_gens.add(gen_id)
            self.num_restarts += 1
            if self.router is not None:
                self.router.attach_replica(handle)
            events.append({"slot": slot.name, "event": "restarted",
                           "replica_id": handle.replica_id,
                           "restarts": slot.restarts})
        return events

    def _reap(self, slot: _Slot) -> None:
        if slot.proc is not None and slot.proc.poll() is None:
            slot.proc.kill()        # hung-but-connected worker
            try:
                slot.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        if slot.handle is not None:
            self.registry.deregister(slot.handle.replica_id)
            slot.handle.close()

    # -- teardown ----------------------------------------------------------
    def stop_worker(self, slot_name: str, sig: Optional[int] = None):
        """SIGTERM (default) one worker — the graceful-drain path the
        slow e2e exercises. The slot will NOT be restarted for it; the
        worker exits on its own once drained."""
        import signal as _signal

        slot = self._slots[slot_name]
        slot.failed = True  # deliberate stop, not a crash to heal
        if slot.proc is not None and slot.proc.poll() is None:
            slot.proc.send_signal(
                _signal.SIGTERM if sig is None else sig)

    def shutdown(self, timeout_s: float = 10.0) -> None:
        for slot in self._slots.values():
            slot.failed = True
            h, proc = slot.handle, slot.proc
            if h is not None and h.alive:
                try:
                    h._client.call("shutdown", deadline_s=2.0,
                                   idempotent=False)
                except (RpcError, OSError):
                    pass
            if proc is not None and proc.poll() is None:
                proc.terminate()
        deadline = time.monotonic() + timeout_s
        for slot in self._slots.values():
            proc = slot.proc
            if proc is None:
                continue
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
            if slot.handle is not None:
                slot.handle.close()
