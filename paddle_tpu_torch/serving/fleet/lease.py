"""Store-backed request leases for the replicated control plane (port of
the JAX package's ``serving/fleet/lease.py``).

With N ``FleetRouter`` processes sharing one registry store, every
in-flight request is owned by exactly one router at a time, and that
ownership is a **lease**: a store record carrying the owner's router id,
a fencing **generation**, and the request's resume state (cumulative
progress, RNG snapshot, replica placement). The owner renews the lease
*before* emitting tokens — renew-before-emit — so the committed progress
in the store is always a prefix of what the client has seen, never
behind it by more than the tokens the owner was fenced out of emitting.
A renew that returns False means the caller no longer owns the request
(a peer bumped the generation, or the store refused the write); the only
correct reaction is to self-fence: abort the engine-side copy and drop
the request locally WITHOUT emitting, exactly like a fenced worker
restart.

Freshness is judged on the reader's monotonic clock, never the writer's
wall clock — the same discipline as ``ReplicaRegistry``: a lease is
fresh while its ``seq`` keeps changing within ``ttl_s`` of *our*
``time.monotonic()``, so wall-clock skew between routers can never steal
a live lease.

Accounting: each lease **incarnation** (one acquire or one adoption)
ends in exactly one bucket — ``completed`` (owner released it at a
terminal), ``adopted`` (owner died; a peer took over), or ``expired``
(owner alive but the lease went stale — expiry race or an injected
steal — and a peer recomputed). Adoption closes the old incarnation and
opens a new one, so summed over every ``LeaseStore`` in the fleet::

    num_acquired == num_completed + num_adopted + num_expired + active()

holds exactly at all times, and ``active() == 0`` at quiesce means no
lease was orphaned.

Fault points (see ``paddle_tpu_torch.testing.faults``):

* ``fleet.lease_expire:flag:<rid>`` — checked at :meth:`renew` with
  ``key=rid``: the renewal write is dropped AND the call returns False,
  so the owner cannot distinguish "store refused me" from "I was
  fenced" and must self-fence. The record then goes stale and a peer
  adopts it into the ``expired`` bucket.
* ``fleet.lease_steal`` — checked by the router's adoption sweep with
  ``key=rid``: force-adopts a live foreign lease (generation bumps; the
  old owner's next renew returns False and it self-fences).
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ...testing import faults

__all__ = ["rendezvous_owner", "LeaseStore"]


def rendezvous_owner(key: str, owners: Sequence[str]) -> Optional[str]:
    """Highest-random-weight (rendezvous) hash: which of ``owners`` owns
    ``key``. Stable under join/leave — removing one owner only moves the
    keys that owner held, never reshuffles the rest (the property ring
    and rendezvous hashing share, without the ring's vnode bookkeeping).
    Deterministic across processes: plain blake2b, no PYTHONHASHSEED.
    """
    best: Optional[str] = None
    best_score: Optional[Tuple[int, str]] = None
    for o in owners:
        h = hashlib.blake2b(f"{o}|{key}".encode(), digest_size=8).digest()
        score = (int.from_bytes(h, "big"), o)
        if best_score is None or score > best_score:
            best, best_score = o, score
    return best


class LeaseStore:
    """Request leases in the shared registry store.

    One instance per router; all instances point at the same store under
    the same ``prefix``. Single-threaded by design (only the router's
    step loop touches it), so there is no lock — cross-router mutual
    exclusion comes from generation fencing, not from locking.
    """

    def __init__(self, store: Any, prefix: str = "fleet_leases",
                 ttl_s: float = 3.0):
        if ttl_s <= 0:
            raise ValueError(f"ttl_s must be positive, got {ttl_s}")
        self.store = store
        self.prefix = prefix
        self.ttl_s = float(ttl_s)
        # writer identity for seq provenance (same scheme as the
        # heartbeat registry: pid + object id, unique enough per fleet)
        self._nonce = f"{os.getpid():x}.{id(self) & 0xFFFFFF:x}"
        self._seq: Dict[str, int] = {}
        # reader-side freshness observations: rid -> (last seq, first
        # seen at OUR monotonic clock)
        self._obs: Dict[str, Tuple[List[Any], float]] = {}
        self._mono = time.monotonic  # injectable: sim virtual clock
        # per-incarnation accounting (summed fleet-wide by tests)
        self.num_acquired = 0
        self.num_completed = 0
        self.num_adopted = 0
        self.num_expired = 0
        self.num_fence_refusals = 0   # renew/release by a non-owner
        self.num_renew_dropped = 0    # fleet.lease_expire fired

    # -- store plumbing ----------------------------------------------------
    def _key(self, rid: str) -> str:
        if "/" in rid or "__" in rid:
            raise ValueError(f"request id {rid!r} may not contain '/' "
                             f"or '__'")
        return f"{self.prefix}/ls/{rid}"

    def _load(self, rid: str) -> Optional[Dict[str, Any]]:
        raw = self.store.try_get(self._key(rid))
        if raw is None:
            return None
        try:
            rec = json.loads(bytes(raw).decode())
        except (ValueError, UnicodeDecodeError):
            return None
        return rec if isinstance(rec, dict) else None

    def _write(self, rid: str, rec: Dict[str, Any]):
        self._seq[rid] = self._seq.get(rid, 0) + 1
        rec["seq"] = [self._nonce, self._seq[rid]]
        rec["ts"] = time.time()  # advisory only; never used for expiry
        self.store.set(self._key(rid), json.dumps(rec).encode())

    # -- freshness (reader-monotonic, cloned from ReplicaRegistry) ---------
    def fresh(self, rid: str, rec: Optional[Dict[str, Any]] = None) -> bool:
        """Is ``rid``'s lease live on OUR clock? First sighting counts
        as a change, so a just-read lease is fresh for one full TTL."""
        if rec is None:
            rec = self._load(rid)
        if rec is None:
            self._obs.pop(rid, None)
            return False
        now = self._mono()
        seq = rec.get("seq")
        prev = self._obs.get(rid)
        if prev is None or prev[0] != seq:
            self._obs[rid] = (seq, now)
            return True
        return (now - prev[1]) <= self.ttl_s

    # -- lease lifecycle ---------------------------------------------------
    def acquire(self, rid: str, owner: str,
                record: Dict[str, Any]) -> Optional[int]:
        """Open a lease on ``rid`` for ``owner``. Returns the fencing
        generation, or None when a DIFFERENT owner holds a fresh lease.
        Re-acquiring one's own lease keeps the generation (idempotent
        retry after a lost ack)."""
        cur = self._load(rid)
        if cur is not None and cur.get("owner") != owner \
                and self.fresh(rid, cur):
            return None
        if cur is None:
            gen = 0
            self.num_acquired += 1
        elif cur.get("owner") == owner:
            gen = int(cur.get("gen", 0))
        else:
            # stale foreign record never adopted: supersede it — the
            # old incarnation expired without a peer recomputing it
            gen = int(cur.get("gen", 0)) + 1
            self.num_expired += 1
            self.num_acquired += 1
        rec = dict(record)
        rec.update(rid=rid, owner=owner, gen=gen)
        self._write(rid, rec)
        return gen

    def renew(self, rid: str, owner: str, gen: int,
              **updates: Any) -> bool:
        """Commit progress to the lease. MUST be called before emitting
        the tokens carried in ``updates`` (renew-before-emit). False
        means the caller is fenced — or the write was dropped, which the
        caller must treat identically: self-fence, emit nothing."""
        if faults.check(faults.FLEET_LEASE_EXPIRE, key=rid):
            self.num_renew_dropped += 1
            return False
        cur = self._load(rid)
        if cur is None or cur.get("owner") != owner \
                or int(cur.get("gen", -1)) != int(gen):
            self.num_fence_refusals += 1
            return False
        cur.update({k: v for k, v in updates.items() if v is not None})
        self._write(rid, cur)
        return True

    def release(self, rid: str, owner: str, gen: int,
                outcome: str = "completed") -> bool:
        """Close the lease at a terminal. False = fenced: a peer owns
        the request now, the caller must not emit the terminal."""
        cur = self._load(rid)
        if cur is None or cur.get("owner") != owner \
                or int(cur.get("gen", -1)) != int(gen):
            self.num_fence_refusals += 1
            return False
        self.store.delete(self._key(rid))
        self._obs.pop(rid, None)
        if outcome == "completed":
            self.num_completed += 1
        elif outcome == "adopted":
            self.num_adopted += 1
        else:
            self.num_expired += 1
        return True

    def adopt(self, rid: str, new_owner: str, *,
              outcome: str) -> Optional[Tuple[int, Dict[str, Any]]]:
        """Take over a foreign lease: bump the generation (fencing the
        old owner's future renews) and transfer ownership. ``outcome``
        buckets the CLOSED incarnation: ``adopted`` when the old owner
        is dead, ``expired`` when it is alive but lost the lease (expiry
        race / injected steal). Returns (new generation, old record) or
        None when the lease vanished or is already ours."""
        cur = self._load(rid)
        if cur is None or cur.get("owner") == new_owner:
            return None
        gen = int(cur.get("gen", 0)) + 1
        if outcome == "adopted":
            self.num_adopted += 1
        else:
            self.num_expired += 1
        self.num_acquired += 1  # the new incarnation
        rec = dict(cur)
        rec.pop("orphan", None)  # adoption gives it a live owner
        rec.update(owner=new_owner, gen=gen)
        self._write(rid, rec)
        return gen, cur

    def check(self, rid: str, owner: str, gen: int) -> bool:
        """Read-only: does ``owner`` still hold ``rid`` at ``gen``?"""
        cur = self._load(rid)
        return (cur is not None and cur.get("owner") == owner
                and int(cur.get("gen", -1)) == int(gen))

    # -- sweep / accounting ------------------------------------------------
    def members(self) -> List[str]:
        """Request ids with a lease record (fresh or stale)."""
        flat = f"{self.prefix}/ls/".replace("/", "__")
        out = []
        for name in self.store.list(f"{self.prefix}/ls/"):
            if name.startswith(flat):
                out.append(name[len(flat):])
        return sorted(out)

    def sweep(self) -> List[Dict[str, Any]]:
        """Every lease record, annotated with ``stale`` (TTL lapsed on
        OUR clock). The router's adoption pass iterates this."""
        out = []
        for rid in self.members():
            rec = self._load(rid)
            if rec is None:
                continue
            rec = dict(rec)
            rec["stale"] = not self.fresh(rid, rec)
            out.append(rec)
        return out

    def active(self) -> int:
        """Open leases (any freshness) — 0 at quiesce or something was
        orphaned."""
        return len(self.members())
