"""Store-backed serving-replica registry with heartbeat liveness (port of
the JAX package's ``distributed/replica_registry.py``).

The fleet router (``paddle_tpu_torch.serving.fleet``) needs a health view of
its replicas that keeps working when replicas move out of process: the
same shape the elastic launcher already uses for worker liveness — a
key per member, refreshed on a heartbeat cadence, considered dead once
its record goes stale. This module packages that pattern over any
store-shaped object (:class:`~paddle_tpu_torch.distributed.store.Store`,
``FileStore``, ``TCPStore``, or the in-memory default), so an
in-process fleet and a future process-per-replica fleet share one
liveness protocol.

Key layout (``/`` flattens to ``__`` in ``list()`` on every store
implementation, which is why replica ids may not contain either)::

    <prefix>/hb/<replica_id>   -> JSON {"ts": wall-clock,
                                        "seq": [writer-nonce, n], ...}

``alive()`` is a read-side filter, not a lease: a stale record is
simply ignored, and a replica that resumes heartbeating after a pause
reappears — the router decides what a disappearance means (it treats
one as replica death and re-enqueues that replica's requests).

Clock discipline: once replicas live in other PROCESSES (even other
hosts), comparing a writer's wall clock against the reader's would
turn NTP skew into false deaths (or worse, mask real ones). So each
writer stamps records with a monotonically increasing ``seq`` (scoped
by a per-writer nonce — restarts and multiple writers always read as
a change), and the reader judges freshness entirely on its OWN
monotonic clock: a member is alive iff its record *changed* within
``ttl_s`` of the reader's ``time.monotonic()``. ``ts`` stays in the
record for humans and for the legacy simulated-clock mode: passing an
explicit ``now=`` to ``alive()``/``is_alive()`` selects the pure
ts-TTL comparison (single-writer tests drive time that way).
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["ReplicaRegistry", "MemStore"]


class MemStore:
    """Dict-backed store with the Store/FileStore surface the registry
    uses (set/try_get/delete/list) — the single-process default, so an
    in-process fleet needs no filesystem or coordination service."""

    def __init__(self):
        self._d: Dict[str, bytes] = {}

    def set(self, key: str, value) -> None:
        if isinstance(value, str):
            value = value.encode()
        self._d[key] = value

    def try_get(self, key: str) -> Optional[bytes]:
        return self._d.get(key)

    def delete(self, key: str) -> None:
        self._d.pop(key, None)

    def list(self, prefix: str = "") -> List[str]:
        # FileStore/TCPStore parity: '/' flattens to '__' in listings
        pat = prefix.replace("/", "__")
        return [k.replace("/", "__") for k in self._d
                if k.replace("/", "__").startswith(pat)]


class ReplicaRegistry:
    """Membership + liveness for one fleet of serving replicas.

    ``ttl_s`` bounds staleness: a replica missing ``ttl_s`` of
    heartbeats is excluded from :meth:`alive` (and :meth:`is_alive`
    returns False) until it heartbeats again. ``now`` parameters exist
    so tests can drive the clock instead of sleeping."""

    # heartbeat meta is topology advertisement, not a payload channel:
    # keys the fleet cannot function without are NEVER dropped by the
    # size guard, everything else (the prefix digest first — it is the
    # only unbounded-ish tenant) goes before a record exceeds the cap
    ESSENTIAL_META_KEYS = ("role", "peer", "pid", "rpc")

    def __init__(self, store=None, prefix: str = "serving_fleet",
                 ttl_s: float = 5.0, meta_cap_bytes: int = 4096):
        if ttl_s <= 0:
            raise ValueError("ttl_s must be > 0")
        if meta_cap_bytes <= 0:
            raise ValueError("meta_cap_bytes must be > 0")
        self.store = store if store is not None else MemStore()
        self.prefix = prefix
        self.ttl_s = ttl_s
        self.meta_cap_bytes = meta_cap_bytes
        # size-guard drops, counted loudly instead of truncating silently
        self.num_meta_keys_dropped = 0
        # write side: per-key heartbeat counter under a writer nonce
        self._nonce = f"{os.getpid():x}.{id(self) & 0xFFFFFF:x}"
        self._seq: Dict[str, int] = {}
        # read side: rid -> (last seq seen, reader-monotonic at change)
        self._obs: Dict[str, Tuple[list, float]] = {}
        self._mono = time.monotonic  # injectable for deterministic tests

    def _key(self, replica_id: str) -> str:
        if "/" in replica_id or "__" in replica_id:
            raise ValueError(
                f"replica id {replica_id!r} may not contain '/' or '__' "
                f"(store listings flatten '/' to '__')")
        return f"{self.prefix}/hb/{replica_id}"

    # -- write side (each replica, or the router on its behalf) ---------
    def register(self, replica_id: str, meta: Optional[dict] = None,
                 now: Optional[float] = None) -> None:
        self.heartbeat(replica_id, load=None, meta=meta, now=now)

    def heartbeat(self, replica_id: str, load: Optional[dict] = None,
                  meta: Optional[dict] = None,
                  now: Optional[float] = None) -> None:
        n = self._seq.get(replica_id, 0) + 1
        self._seq[replica_id] = n
        rec = {"ts": time.time() if now is None else now,
               "seq": [self._nonce, n]}
        if meta:
            rec["meta"] = self._bounded_meta(dict(meta))
        if load:
            rec["load"] = load
        self.store.set(self._key(replica_id), json.dumps(rec))

    def _bounded_meta(self, meta: dict) -> dict:
        """Enforce ``meta_cap_bytes`` on the serialized meta. Drop
        order: the prefix digest first, then the remaining
        non-essential keys (name order, for determinism) — never the
        role / peer endpoint / pid. Each dropped key bumps
        ``num_meta_keys_dropped``; an all-essential meta that still
        exceeds the cap is sent as-is (better a fat beat than a fleet
        that forgets its own topology)."""
        if len(json.dumps(meta)) <= self.meta_cap_bytes:
            return meta
        droppable = ["prefix"] + sorted(
            k for k in meta
            if k != "prefix" and k not in self.ESSENTIAL_META_KEYS)
        for k in droppable:
            if k not in meta:
                continue
            meta.pop(k)
            self.num_meta_keys_dropped += 1
            if len(json.dumps(meta)) <= self.meta_cap_bytes:
                break
        return meta

    def deregister(self, replica_id: str) -> None:
        self.store.delete(self._key(replica_id))
        self._seq.pop(replica_id, None)
        self._obs.pop(replica_id, None)

    # -- read side (the router's health view) ----------------------------
    def record(self, replica_id: str) -> Optional[dict]:
        raw = self.store.try_get(self._key(replica_id))
        if raw is None:
            return None
        try:
            return json.loads(raw.decode() if isinstance(raw, bytes)
                              else raw)
        except (ValueError, UnicodeDecodeError):
            return None  # torn/garbage record reads as absent

    def members(self) -> List[str]:
        flat = f"{self.prefix}/hb/".replace("/", "__")
        out = []
        for name in self.store.list(f"{self.prefix}/hb/"):
            if name.startswith(flat):
                out.append(name[len(flat):])
        return sorted(out)

    def _fresh(self, replica_id: str, rec: dict,
               now: Optional[float]) -> bool:
        if now is not None or "seq" not in rec:
            # explicit simulated clock, or a legacy record without a
            # sequence: pure wall-clock TTL (the pre-monotonic contract)
            wall = time.time() if now is None else now
            return wall - rec.get("ts", 0.0) <= self.ttl_s
        # skew-immune path: freshness = "the record CHANGED within
        # ttl_s of MY monotonic clock". First sighting counts as a
        # change (lease semantics for members discovered mid-life).
        seq = rec["seq"]
        mono = self._mono()
        prev = self._obs.get(replica_id)
        if prev is None or prev[0] != seq:
            self._obs[replica_id] = (seq, mono)
            return True
        return mono - prev[1] <= self.ttl_s

    def alive(self, now: Optional[float] = None) -> Dict[str, dict]:
        """replica_id -> last heartbeat record, for every member whose
        record is fresh (see the module docstring for the two clock
        modes; ``now=None`` is the skew-immune monotonic one)."""
        out: Dict[str, dict] = {}
        for rid in self.members():
            rec = self.record(rid)
            if rec is not None and self._fresh(rid, rec, now):
                out[rid] = rec
        return out

    def is_alive(self, replica_id: str,
                 now: Optional[float] = None) -> bool:
        rec = self.record(replica_id)
        if rec is None:
            return False
        return self._fresh(replica_id, rec, now)

    def age_s(self, replica_id: str) -> Optional[float]:
        """Seconds (on the READER's monotonic clock) since this
        member's record last changed — the staleness basis for decaying
        heartbeat-carried metadata like prefix advertisements. None
        before the reader has ever observed the member (callers treat
        unknown as fully stale). Reads only the observation table
        :meth:`_fresh` maintains, so call it after an ``alive()``
        sweep."""
        prev = self._obs.get(replica_id)
        if prev is None:
            return None
        return max(0.0, self._mono() - prev[1])
