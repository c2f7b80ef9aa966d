"""Elastic membership manager: scale-in/out with re-formed rendezvous
(copied from the JAX package's ``distributed/launch/elastic.py``, which
holds no arrays).

Reference: python/paddle/distributed/fleet/elastic/manager.py:124
(``ElasticManager`` registers nodes in etcd, watches membership, rewrites
endpoints and relaunches when it changes), launch/controllers/master.py
(``--nnodes min:max`` ranges), controllers/watcher.py (local process
monitor).

The etcd role is a Store (a FileStore on shared storage, or the
launcher's own TCPStore, the *management* job's store). Each worker
slot keeps a heartbeat key fresh; the launcher's elastic loop computes
live membership, and on change — a dead worker (scale-in) or a join
request (scale-out) — gang-restarts the job at the new world size,
because a collective job's rendezvous must re-form as a unit. Training
scripts resume from their own checkpoints (PADDLE_RESTART_COUNT tells
them a restart happened).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional, Set

from paddle_tpu_torch.distributed.store import FileStore, TCPStore

__all__ = ["ElasticManager", "Heartbeat", "request_join", "parse_nnodes",
           "make_elastic_store"]


def make_elastic_store(spec: str):
    """Resolve an elastic registry spec: ``tcp://host:port`` -> TCPStore
    client (the management-job store — reference: etcd at
    elastic/manager.py:124; needs no shared filesystem and survives gang
    restarts), anything else -> FileStore directory (single-host
    fallback)."""
    if str(spec).startswith("tcp://"):
        return TCPStore(spec)
    return FileStore(spec)


def parse_nnodes(spec) -> tuple:
    """'4' -> (4, 4); '2:4' -> (2, 4) (reference launch arg surface)."""
    s = str(spec)
    if ":" in s:
        lo, hi = s.split(":", 1)
        lo, hi = int(lo), int(hi)
    else:
        lo = hi = int(s)
    if not (1 <= lo <= hi):
        raise ValueError(f"invalid --nnodes range {spec!r}")
    return lo, hi


class Heartbeat:
    """Worker-side: keep ``nodes/<node_id>`` fresh in the elastic store.

    The reference's node registration + TTL lease (manager.py etcd lease
    refresh)."""

    def __init__(self, store_dir: str, node_id: str, interval: float = 0.5,
                 payload: Optional[dict] = None):
        self._store = make_elastic_store(store_dir)
        self._node_id = node_id
        self._interval = interval
        self._payload = payload or {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _beat(self):
        # a transient registry error (TCP reset, server busy during gang
        # churn) must not kill the heartbeat thread — a missed beat is
        # recoverable, a dead thread reads as a dead NODE
        try:
            self._store.set(f"nodes/{self._node_id}", json.dumps(
                {"ts": time.time(), **self._payload}))
            # start() runs _beat() once before Thread.start(); afterwards
            # only the heartbeat thread touches _misses
            self._misses = 0
        except Exception:
            self._misses = getattr(self, "_misses", 0) + 1
            if self._misses == 3:
                import sys

                print(f"[elastic] heartbeat {self._node_id}: 3 "
                      "consecutive store failures (still retrying)",
                      file=sys.stderr, flush=True)

    def start(self):
        self._beat()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self._interval):
            self._beat()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        try:
            self._store.delete(f"nodes/{self._node_id}")
        except Exception:
            pass  # unreachable registry at teardown must not mask rc


def request_join(store_dir: str, node_id: str = "new"):
    """Ask a running elastic job to scale out (reference: a new node
    registering in etcd triggers the manager's watch)."""
    make_elastic_store(store_dir).set(f"join/{node_id}", json.dumps(
        {"ts": time.time()}))


class ElasticManager:
    """Launcher-side membership watch + world-size decisions."""

    def __init__(self, store_dir: str, min_nodes: int, max_nodes: int,
                 hb_timeout: float = 3.0):
        self.store = make_elastic_store(store_dir)
        self.dir = store_dir
        self.min = min_nodes
        self.max = max_nodes
        self.hb_timeout = hb_timeout

    # -- membership ------------------------------------------------------
    def live_nodes(self) -> Set[str]:
        now = time.time()
        out = set()
        for key in self.store.list("nodes/"):
            raw = self.store.try_get(key.replace("__", "/"))
            if raw is None:
                continue
            try:
                ts = json.loads(raw)["ts"]
            except Exception:
                continue
            if now - ts <= self.hb_timeout:
                out.add(key.split("__", 1)[1])
        return out

    def join_requests(self) -> Set[str]:
        return {k.split("__", 1)[1] for k in self.store.list("join/")}

    def clear_join_requests(self):
        for k in self.join_requests():
            self.store.delete(f"join/{k}")

    def decide_world(self, current: int, lost: int = 0,
                     joins: Optional[Set[str]] = None) -> Optional[int]:
        """New world size after membership change, or None = give up.

        scale-in: lose workers but stay >= min -> shrink; below min ->
        unrecoverable (reference: job fails when under min_nodes).
        scale-out: pending join requests grow the world up to max.
        Pass the ``joins`` snapshot you intend to consume (and delete
        exactly that set afterwards) — re-reading here would race with
        new arrivals and drop them uncounted."""
        want = current - lost
        want += len(self.join_requests() if joins is None else joins)
        want = min(want, self.max)
        if want < self.min:
            return None
        return want

    def consume_join_requests(self, joins: Set[str]):
        """Delete exactly the counted requests; later arrivals survive
        for the next membership decision."""
        for j in joins:
            self.store.delete(f"join/{j}")
