"""Out-of-process replica transport: length-prefixed JSON RPC (port of
the JAX package's ``serving/fleet/transport.py``; the frames are
byte-compatible with it).

The :class:`~paddle_tpu_torch.serving.fleet.replica.ReplicaHandle` verb set
was kept JSON-shaped exactly so it could move onto a wire protocol
unchanged; this module is that wire. One socket per replica, frames in
both directions::

    frame    = 4-byte big-endian payload length | UTF-8 JSON payload
    request  = {"id": <seq>, "method": <verb>, "params": {...}}
    response = {"id": <seq>, "ok": true,  "result": ...}
             | {"id": <seq>, "ok": false, "error": <msg>, "type": <exc>}

Failure semantics (the whole point of being out of process):

* every call has a **deadline**; a reply that never arrives raises
  :class:`RpcTimeout`;
* **idempotent queries** (``load``, ``admission_verdict``,
  ``rng_state``, ... — reads with no replica-side effect) retry with
  exponential backoff before giving up;
* **mutations** (``add_request``, ``step``, ``start_drain``, ...) are
  NEVER retried: a lost reply is indistinguishable from a lost request,
  and re-sending could double-apply. A failed mutation surfaces as
  replica death instead — the router's health sweep re-enqueues the
  stranded requests on a peer, which is safe because an emission the
  router never ACKed never reached a client;
* a late reply to an abandoned (timed-out) call is dropped by sequence
  number — it can never complete a different call.

Hand-off after SIGKILL: a dead process cannot answer the router's
post-mortem ``rng_state`` query, so the worker piggybacks every
request's composite RNG state (``{"numpy": ..., "device_key": ...}``)
on each ``step``/``start_drain`` response and
:class:`SubprocessReplica` caches it router-side. The cache always
holds the state after the last **acknowledged** step — exactly the
resume point, since an unacknowledged step's tokens never reached the
router — so ``FleetRouter.kill_replica`` keeps its existing call
sequence and sampled resume stays bit-identical.

Fault points (client side, ``PADDLE_FAULTS``): ``fleet.rpc_delay``
(install with ``sleep:<s>`` to stall a call against its deadline) and
``fleet.rpc_drop`` (``flag`` — the frame is "lost": never sent, the
call times out). ``fleet.worker_kill`` lives in the router and
SIGKILLs a worker via :meth:`SubprocessReplica.hard_kill`.

Peer data plane: :class:`PeerListener` is the worker-side
listening end of the direct worker↔worker KV channel; :func:`peer_push`
is the pushing end, ticketed and HMAC-signed by the router
(:func:`sign_ticket`). The listener is a pure staging area — it never
touches the engine; the actual import happens on the worker's
single-threaded service loop via the ``peer_commit`` verb. Peer-path
fault points: ``fleet.peer_connect_fail``, ``fleet.peer_send_drop``,
``fleet.peer_frame_corrupt`` (``flag``) and ``fleet.peer_stall``
(``sleep:<s>`` — stalls the push against its ticket deadline).

Threading: the client is single-caller — the
router thread issues calls; one daemon reader thread completes them
through a pending table. ``_lock`` guards ONLY the table and the
closed flag; no socket IO ever happens under it. The peer listener's
accept thread follows the same rule: its ``_lock`` guards only the
staging inbox, committed-set and counters.
"""
from __future__ import annotations

import dataclasses
import hashlib
import hmac
import json
import logging
import os
import random
import socket
import struct
import threading
import time
import uuid
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

from paddle_tpu_torch.serving.fleet.replica import ReplicaHandle, ReplicaLoad
from paddle_tpu_torch.serving.request import RequestOutput, SamplingParams
from paddle_tpu_torch.testing import faults

__all__ = [
    "RpcError", "RpcTimeout", "ReplicaGone", "RpcRemoteError",
    "RpcClient", "ReplicaServicer", "SubprocessReplica",
    "connect_replica",
    "send_frame", "recv_frame", "send_frame_with_blob",
    "IDEMPOTENT_METHODS", "MUTATION_METHODS", "DEFAULT_DEADLINES",
    "PeerListener", "peer_push", "peer_secret", "sign_ticket",
]

_log = logging.getLogger(__name__)

_LEN = struct.Struct(">I")
MAX_FRAME = 64 * 1024 * 1024  # torn/garbage length guard; also the
# per-shipped-batch KV payload cap (a bigger hand-off falls back to
# recompute rather than growing frames without bound)


# -- framing ---------------------------------------------------------------
def send_frame(sock: socket.socket, obj: Any) -> None:
    payload = json.dumps(obj).encode()
    sock.sendall(_LEN.pack(len(payload)) + payload)


def send_frame_with_blob(sock: socket.socket, obj: dict,
                         blob: bytes) -> None:
    """Binary-payload extension (fleet KV-ship): a JSON header frame
    whose ``_bin`` key announces the exact length of ONE raw-bytes
    frame that follows on the same socket. Readers that see ``_bin``
    consume the blob frame too, so the stream never desynchronizes;
    both frames obey the :data:`MAX_FRAME` cap."""
    if len(blob) > MAX_FRAME:
        raise ValueError(
            f"blob length {len(blob)} exceeds {MAX_FRAME}")
    obj = dict(obj)
    obj["_bin"] = len(blob)
    payload = json.dumps(obj).encode()
    sock.sendall(_LEN.pack(len(payload)) + payload
                 + _LEN.pack(len(blob)) + blob)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None  # peer closed (clean or SIGKILL — same bytes)
        buf.extend(chunk)
    return bytes(buf)


def recv_frame(sock: socket.socket) -> Optional[Any]:
    """One frame, or None on EOF. Raises OSError on a torn length
    prefix or oversized frame (treated as connection loss upstream).
    A header announcing a binary payload (``_bin``) consumes the raw
    frame that follows and attaches it under ``_blob``."""
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None
    (n,) = _LEN.unpack(head)
    if n > MAX_FRAME:
        raise OSError(f"frame length {n} exceeds {MAX_FRAME}")
    body = _recv_exact(sock, n)
    if body is None:
        raise OSError("connection lost mid-frame")
    msg = json.loads(body.decode())
    if isinstance(msg, dict) and "_bin" in msg:
        head = _recv_exact(sock, _LEN.size)
        if head is None:
            raise OSError("connection lost before announced blob")
        (bn,) = _LEN.unpack(head)
        if bn > MAX_FRAME or bn != int(msg["_bin"]):
            raise OSError(
                f"blob length {bn} disagrees with header "
                f"({msg['_bin']}) or exceeds {MAX_FRAME}")
        blob = _recv_exact(sock, bn)
        if blob is None:
            raise OSError("connection lost mid-blob")
        msg["_blob"] = blob
    return msg


# -- peer data plane -------------------------------------------------------
# Workers push KV payloads straight to each other; the router only
# issues small signed tickets and collects acks. A ticket is a dict
# {ticket_id, src, dst, kind: "kv"|"prefix", request_id|chain_hash,
#  deadline_ms, sig} — the signature keeps a confused or stale source
# from staging bytes at a destination the router never paired it with.

_SECRET_ENV = "PADDLE_PEER_SECRET"


def peer_secret() -> bytes:
    """Fleet-shared ticket-signing secret. First use in the router/
    supervisor process mints one into the environment, and worker
    subprocesses inherit it through ``Popen`` — no extra plumbing, and
    every party derives the same HMAC key."""
    tok = os.environ.get(_SECRET_ENV)
    if not tok:
        tok = uuid.uuid4().hex
        os.environ[_SECRET_ENV] = tok
    return tok.encode()


def sign_ticket(ticket: dict, secret: Optional[bytes] = None) -> str:
    """HMAC-SHA256 over the ticket's canonical JSON (sans ``sig``)."""
    blob = json.dumps({k: v for k, v in ticket.items() if k != "sig"},
                      sort_keys=True).encode()
    return hmac.new(secret or peer_secret(), blob,
                    hashlib.sha256).hexdigest()


def _ticket_ok(ticket: dict, secret: bytes) -> bool:
    sig = ticket.get("sig")
    return isinstance(sig, str) and hmac.compare_digest(
        sig, sign_ticket(ticket, secret))


class PeerListener:
    """Worker-side receiving end of the peer data plane.

    A daemon accept-loop thread stages ticketed frames into a bounded
    inbox; it NEVER touches the engine (which is not thread-safe). The
    worker's single-threaded service loop later pops a staged payload
    with :meth:`take` when the router sends ``peer_commit`` — only then
    do bytes reach the engine. Consequences:

    * duplicate delivery of a ticket is an idempotent no-op (the
      committed-set remembers ticket ids);
    * a ticket whose commit never arrives (router restart, src/dst
      death mid-transfer) is garbage-collected at its deadline — the
      destination provably holds no blocks for it, because staged bytes
      are host memory, not engine blocks;
    * CRC and signature are checked at the door, so a corrupt or forged
      frame is refused in the receipt and the source reports the rung
      dead immediately.

    ``_lock`` guards the inbox, committed-set and counters only; all
    socket IO happens outside it (same discipline as ``RpcClient``).
    """

    def __init__(self, host: str = "127.0.0.1", *,
                 secret: Optional[bytes] = None, max_entries: int = 8,
                 max_bytes: int = 4 * MAX_FRAME,
                 io_timeout_s: float = 30.0):
        self._secret = secret or peer_secret()
        self._max_entries = max_entries
        self._max_bytes = max_bytes
        self._io_timeout_s = io_timeout_s
        self._sock = socket.create_server((host, 0))
        self.endpoint = "%s:%d" % (host, self._sock.getsockname()[1])
        self._lock = threading.Lock()  # inbox + done-set + stats only
        # ticket_id -> (expires_mono, ticket, meta, payload). Expiry is
        # measured from RECEIPT (deadline_ms is a duration, not a wall
        # timestamp) so src/dst clock skew can't pin an orphan forever.
        self._inbox: Dict[str, Tuple[float, dict, dict, bytes]] = {}
        self._inbox_bytes = 0
        self._done: Dict[str, bool] = {}  # committed/taken ticket ids
        self._stats = {"received": 0, "refused": 0, "duplicates": 0,
                       "orphans_gcd": 0}
        self._thread = threading.Thread(
            target=self._serve_loop, daemon=True,
            name=f"peer-listener-{self.endpoint}")
        self._thread.start()

    # -- accept thread -----------------------------------------------------
    def _serve_loop(self) -> None:
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # listener closed
            try:
                self._serve_one(conn)
            except (OSError, ValueError):
                pass  # torn push: nothing staged, source sees the error
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

    def _serve_one(self, conn: socket.socket) -> None:
        conn.settimeout(self._io_timeout_s)
        msg = recv_frame(conn)
        if not isinstance(msg, dict):
            return
        receipt = self._admit(dict(msg.get("ticket") or {}),
                              dict(msg.get("meta") or {}),
                              msg.get("_blob", b""))
        send_frame(conn, receipt)

    def _admit(self, ticket: dict, meta: dict, payload: bytes) -> dict:
        tid = ticket.get("ticket_id")
        if not tid or not _ticket_ok(ticket, self._secret):
            with self._lock:
                self._stats["refused"] += 1
            return {"ok": False, "error": "bad ticket signature"}
        if zlib.crc32(payload) != int(meta.get("crc32", -1)):
            with self._lock:
                self._stats["refused"] += 1
            return {"ok": False, "error": "payload checksum mismatch"}
        if meta.get("layout") is not None:
            # TP-sharded exporters frame the payload per mesh shard;
            # refuse a malformed or payload-incompatible layout stanza
            # AT THE DOOR so the source sees the rung die immediately
            # instead of the commit failing minutes later (the commit
            # path re-validates — this is fail-fast, not the gate)
            from paddle_tpu_torch.distributed.redistribute import Layout
            try:
                lt = Layout.from_meta(meta["layout"])
                # K frames + V frames, one pair per mesh device
                if payload and len(payload) % (2 * lt.size):
                    raise ValueError(
                        f"payload {len(payload)}B does not split into "
                        f"2x{lt.size} shard frames")
            except (ValueError, KeyError, TypeError) as e:
                with self._lock:
                    self._stats["refused"] += 1
                return {"ok": False,
                        "error": f"bad layout stanza: {e}"}
        expires = time.monotonic() + float(
            ticket.get("deadline_ms", 30e3)) / 1e3
        self.gc()  # expired entries never block a fresh admission
        with self._lock:
            if tid in self._done or tid in self._inbox:
                self._stats["duplicates"] += 1
                return {"ok": True, "duplicate": True}
            if (len(self._inbox) >= self._max_entries
                    or self._inbox_bytes + len(payload) > self._max_bytes):
                self._stats["refused"] += 1
                return {"ok": False, "error": "staging inbox full"}
            self._inbox[tid] = (expires, ticket, meta, payload)
            self._inbox_bytes += len(payload)
            self._stats["received"] += 1
        return {"ok": True}

    # -- service-loop side -------------------------------------------------
    def take(self, ticket_id: str):
        """Pop a staged ``(ticket, meta, payload)`` for commit, or None
        if it was never delivered / already committed / GC'd. Taking
        marks the ticket done, so a late duplicate delivery after the
        commit stays a no-op."""
        self.gc()
        with self._lock:
            ent = self._inbox.pop(ticket_id, None)
            if ent is None:
                return None
            self._inbox_bytes -= len(ent[3])
            self._done[ticket_id] = True
            while len(self._done) > 1024:  # bounded duplicate memory
                self._done.pop(next(iter(self._done)))
        return ent[1], ent[2], ent[3]

    def gc(self) -> int:
        """Drop expired staged entries (orphaned tickets); returns the
        number collected. Called from the worker's service-loop tick."""
        now = time.monotonic()
        with self._lock:
            dead = [tid for tid, ent in self._inbox.items()
                    if ent[0] <= now]
            for tid in dead:
                ent = self._inbox.pop(tid)
                self._inbox_bytes -= len(ent[3])
                self._done[tid] = True
                while len(self._done) > 1024:
                    self._done.pop(next(iter(self._done)))
                self._stats["orphans_gcd"] += 1
        return len(dead)

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
            out["staged"] = len(self._inbox)
            out["staged_bytes"] = self._inbox_bytes
        return out

    @property
    def pending_count(self) -> int:
        with self._lock:
            return len(self._inbox)

    def close(self) -> None:
        try:
            self._sock.close()  # accept loop exits on the OSError
        except OSError:
            pass


def peer_push(endpoint: str, ticket: dict, meta: dict, payload: bytes,
              *, timeout_s: float = 30.0) -> dict:
    """Source-side push of one ticketed frame to a peer listener.

    Returns the listener's receipt dict (``{"ok": ...}``); raises
    OSError/ValueError on any transport failure. One attempt, no
    retry — a torn or timed-out push is a dead rung, and the ladder
    above decides what happens next. Fault points:
    ``fleet.peer_connect_fail`` / ``fleet.peer_send_drop`` /
    ``fleet.peer_frame_corrupt`` (flags) and ``fleet.peer_stall``
    (sleep action — a stall that outlives ``timeout_s`` fails the
    push before any bytes move)."""
    t0 = time.monotonic()
    if faults.check(faults.FLEET_PEER_CONNECT_FAIL):
        raise OSError(f"peer connect to {endpoint} refused (injected)")
    faults.fire(faults.FLEET_PEER_STALL)
    if faults.check(faults.FLEET_PEER_SEND_DROP):
        raise OSError(f"peer frame to {endpoint} dropped (injected)")
    if faults.check(faults.FLEET_PEER_FRAME_CORRUPT) and payload:
        buf = bytearray(payload)
        buf[0] ^= 0xFF  # CRC refusal at the listener's door
        payload = bytes(buf)
    remaining = timeout_s - (time.monotonic() - t0)
    if remaining <= 0:
        raise OSError(
            f"peer push to {endpoint} stalled past its "
            f"{timeout_s:g}s deadline before connecting")
    host, _, port = endpoint.rpartition(":")
    with socket.create_connection((host, int(port)),
                                  timeout=remaining) as s:
        s.settimeout(max(0.05, timeout_s - (time.monotonic() - t0)))
        send_frame_with_blob(s, {"ticket": dict(ticket),
                                 "meta": dict(meta)}, payload)
        receipt = recv_frame(s)
    if not isinstance(receipt, dict):
        raise OSError(f"peer receipt from {endpoint} lost")
    return receipt


# -- errors ----------------------------------------------------------------
class RpcError(RuntimeError):
    """Base transport failure."""


class RpcTimeout(RpcError):
    """No reply within the call's deadline."""


class ReplicaGone(RpcError):
    """The connection is closed — the worker exited or was killed."""


class RpcRemoteError(RpcError):
    """The worker executed the call and raised something unexpected."""

    def __init__(self, message: str, type_name: str = "Exception"):
        super().__init__(message)
        self.type_name = type_name


# reads with no replica-side effect: safe to re-send after a lost reply
# (export_kv/export_prefix are pure device->host gathers — the source
# keeps its blocks; re-reading them returns the same bytes)
IDEMPOTENT_METHODS = frozenset({
    "ping", "admission_verdict", "estimated_ttft_ms", "load",
    "is_draining", "drained", "has_unfinished", "rng_state", "snapshot",
    "export_kv", "prefix_digest", "export_prefix", "tier_stats",
    # re-asserting a lease generation is a no-op (max-register update)
    "fence_request",
})

# replica-side effects: exactly one attempt — a retry after a lost
# reply could double-apply (double admit, double abort, a step run
# twice, a staged peer payload committed twice). Together with
# IDEMPOTENT_METHODS this is a total partition of the servicer verb
# table; RpcClient.call refuses a verb in neither set so a new verb
# must be classified where its dispatch arm is added.
MUTATION_METHODS = frozenset({
    "add_request", "abort_request", "release_request", "step",
    "start_drain", "import_kv", "import_prefix", "park_kv",
    "drop_parked", "peer_send", "peer_commit", "park_session",
    "resume_session", "drop_session", "adopt_session", "shutdown",
})

# per-method deadline overrides: step/start_drain cover the engine's
# first steps' graph captures; the KV-ship verbs move whole block batches;
# everything else is a bookkeeping round trip
DEFAULT_DEADLINES: Dict[str, float] = {
    "*": 30.0, "ping": 120.0, "add_request": 120.0,
    "step": 600.0, "start_drain": 600.0,
    "export_kv": 120.0, "import_kv": 120.0,
    "export_prefix": 120.0, "import_prefix": 120.0,
    "park_kv": 120.0, "peer_send": 120.0, "peer_commit": 120.0,
}


class _Call:
    """One in-flight call: the reader thread fills it, the caller waits."""

    __slots__ = ("done", "msg", "err")

    def __init__(self):
        self.done = threading.Event()
        self.msg: Optional[dict] = None
        self.err: Optional[Exception] = None

    def complete(self, msg: Optional[dict], err: Optional[Exception]):
        self.msg = msg
        self.err = err
        self.done.set()


class RpcClient:
    """Router-side end of one replica connection.

    Single-caller by design: the router thread is the only one issuing
    calls (matching the single-threaded router loop), so sends need no
    lock; the daemon reader thread owns ``recv`` exclusively and
    completes calls through ``_pending``. ``_lock`` protects only that
    table and the closed flag."""

    def __init__(self, sock: socket.socket, *,
                 default_deadline_s: float = 30.0, retries: int = 2,
                 backoff_base_s: float = 0.05,
                 backoff_max_s: float = 1.0, name: str = "replica",
                 jitter_seed: Optional[int] = None):
        self._sock = sock
        self.default_deadline_s = default_deadline_s
        self.retries = retries
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        # decorrelated-jitter retry backoff: after the first (base)
        # sleep, each further retry sleeps uniform(base, prev*3) capped
        # at backoff_max_s — N clients retrying after a router restart
        # fan out instead of reconnecting in lockstep. Seedable so
        # tests can pin the exact schedule.
        self._jitter = random.Random(jitter_seed)
        self._lock = threading.Lock()  # pending table + closed flag only
        self._pending: Dict[int, _Call] = {}
        self._next_seq = 0
        self._closed = False
        # wire-overhead accounting for bench (single-caller, no lock);
        # "backoffs" records every retry sleep for the jitter tests
        self.stats: Dict[str, Any] = {
            "calls": 0, "retries": 0, "timeouts": 0, "rpc_time_s": 0.0,
            "backoffs": []}
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True,
            name=f"rpc-reader-{name}")
        self._reader.start()

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    # -- reader thread -----------------------------------------------------
    def _read_loop(self) -> None:
        try:
            while True:
                msg = recv_frame(self._sock)
                if msg is None:
                    break
                with self._lock:
                    call = self._pending.pop(msg.get("id"), None)
                if call is not None:
                    call.complete(msg, None)
                # else: late reply to an abandoned call — dropped; the
                # seq was retired so it can never poison a later call
        except (OSError, ValueError):
            pass
        self._mark_closed()

    def _mark_closed(self) -> None:
        with self._lock:
            self._closed = True
            stranded = list(self._pending.values())
            self._pending.clear()
        err = ReplicaGone("replica connection closed")
        for call in stranded:
            call.complete(None, err)

    # -- caller side -------------------------------------------------------
    def call(self, method: str, params: Optional[dict] = None, *,
             deadline_s: Optional[float] = None,
             idempotent: Optional[bool] = None,
             blob: Optional[bytes] = None) -> Any:
        """One RPC. Idempotent calls retry ``retries`` times on timeout
        with exponential backoff; mutations get exactly one attempt.
        ``blob`` rides as a raw-bytes frame behind the JSON header (the
        KV-ship payload path); a blob-carrying reply is attached to a
        dict result under ``_blob``."""
        if idempotent is None:
            if method in IDEMPOTENT_METHODS:
                idempotent = True
            elif method in MUTATION_METHODS:
                idempotent = False
            else:
                # an unclassified verb must not silently pick a retry
                # policy — the tier_stats regression class
                raise RpcError(
                    f"RPC verb {method!r} is in neither "
                    f"IDEMPOTENT_METHODS nor MUTATION_METHODS — "
                    f"classify it where its dispatch arm is defined "
                    f"(reads retry, mutations get one attempt)")
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        attempts = (self.retries + 1) if idempotent else 1
        delay = self.backoff_base_s
        last: Optional[Exception] = None
        for attempt in range(attempts):
            if attempt:
                self.stats["retries"] += 1
                self.stats["backoffs"].append(delay)
                time.sleep(delay)
                delay = min(self._jitter.uniform(
                    self.backoff_base_s, delay * 3.0),
                    self.backoff_max_s)
            try:
                return self._call_once(method, params or {}, deadline_s,
                                       blob)
            except RpcTimeout as e:
                last = e  # the reply may be lost, the worker may live
        raise last  # type: ignore[misc]

    def _call_once(self, method: str, params: dict,
                   deadline_s: float,
                   blob: Optional[bytes] = None) -> Any:
        faults.fire(faults.FLEET_RPC_DELAY)
        if faults.check(faults.FLEET_RPC_DROP):
            self.stats["timeouts"] += 1
            raise RpcTimeout(f"{method}: frame dropped (injected)")
        with self._lock:
            if self._closed:
                raise ReplicaGone("replica connection closed")
            self._next_seq += 1
            seq = self._next_seq
            call = _Call()
            self._pending[seq] = call
        t0 = time.monotonic()
        req = {"id": seq, "method": method, "params": params}
        try:
            if blob is None:
                send_frame(self._sock, req)
            else:
                send_frame_with_blob(self._sock, req, blob)
        except (OSError, ValueError):
            self._mark_closed()
            raise ReplicaGone(f"{method}: send failed")
        if not call.done.wait(deadline_s):
            with self._lock:
                self._pending.pop(seq, None)
            if not call.done.is_set():  # reader didn't win the race
                self.stats["timeouts"] += 1
                raise RpcTimeout(
                    f"{method}: no reply within {deadline_s:g}s")
        self.stats["calls"] += 1
        self.stats["rpc_time_s"] += time.monotonic() - t0
        if call.err is not None:
            raise call.err
        msg = call.msg or {}
        if msg.get("ok"):
            result = msg.get("result")
            if "_blob" in msg and isinstance(result, dict):
                result["_blob"] = msg["_blob"]
            return result
        etype = msg.get("type", "Exception")
        emsg = str(msg.get("error", "remote error"))
        # known in-process exception types cross the wire as themselves
        # (the call EXECUTED and failed cleanly — no death, no ambiguity)
        if etype == "ValueError":
            raise ValueError(emsg)
        if etype == "KeyError":
            raise KeyError(emsg)
        raise RpcRemoteError(emsg, etype)

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._mark_closed()


# -- wire (de)serialization ------------------------------------------------
def _output_to_wire(o: RequestOutput) -> dict:
    return {"request_id": o.request_id, "token": o.token,
            "finished": o.finished, "generated": list(o.generated),
            "finish_reason": o.finish_reason}


def _output_from_wire(d: dict) -> RequestOutput:
    return RequestOutput(
        request_id=d["request_id"], token=d.get("token"),
        finished=bool(d.get("finished")),
        generated=list(d.get("generated") or []),
        finish_reason=d.get("finish_reason"))


class ReplicaServicer:
    """Worker-side adapter: serves the ``ReplicaHandle`` verb set of a
    wrapped (in-process) replica over frames. Single-threaded: one
    request, one reply, in order — the engine is not thread-safe and
    the protocol does not need pipelining."""

    def __init__(self, replica: ReplicaHandle, on_tick=None):
        self.replica = replica
        # optional post-reply hook: the worker main() publishes the
        # current prefix digest into its heartbeat meta here, so
        # advertisements track the trie without the heartbeat thread
        # ever touching the (not thread-safe) engine
        self.on_tick = on_tick
        # drain KV snapshots dropped for frame-cap reasons (the count
        # rides every step reply)
        self.num_kv_snapshot_skipped = 0

    def handle(self, msg: dict) -> dict:
        seq = msg.get("id")
        try:
            params = dict(msg.get("params") or {})
            if "_blob" in msg:  # incoming binary frame -> verb payload
                params["_blob"] = msg["_blob"]
            result = self._dispatch(msg.get("method", ""), params)
            return {"id": seq, "ok": True, "result": result}
        except Exception as e:  # noqa: BLE001 — every error crosses the wire
            return {"id": seq, "ok": False, "error": str(e),
                    "type": type(e).__name__}

    def serve(self, sock: socket.socket, should_stop=None) -> None:
        """Blocking service loop; returns on EOF (parent closed or
        died), an explicit ``shutdown`` verb, or ``should_stop()``
        turning true after a reply is delivered."""
        while True:
            try:
                msg = recv_frame(sock)
            except OSError:
                return
            if msg is None:
                return
            if self._serve_one(sock, msg, should_stop):
                return
            if self.on_tick is not None:
                self.on_tick()

    def _serve_one(self, sock: socket.socket, msg: dict,
                   should_stop) -> bool:
        """Execute one request and reply on ``sock``. Returns True when
        the loop should exit (shutdown verb, or ``should_stop()``)."""
        reply = self.handle(msg)
        blob = None
        res = reply.get("result")
        if isinstance(res, dict) and "_blob" in res:
            blob = res.pop("_blob")  # rides as a raw frame instead
        stopping = should_stop is not None and should_stop()
        if (stopping and reply.get("ok")
                and isinstance(reply.get("result"), dict)
                and "outputs" in reply["result"]):
            # last breath: tell the client this exit is a finished
            # drain, not a crash — the handle marks itself retiring
            # and the router reaps instead of counting a death
            reply["result"]["drained_out"] = True
        if blob is None:
            send_frame(sock, reply)
        else:
            send_frame_with_blob(sock, reply, blob)
        return msg.get("method") == "shutdown" or stopping

    def serve_multi(self, primary: socket.socket,
                    listener: Optional[socket.socket] = None,
                    should_stop=None) -> None:
        """Service loop for a worker that is reachable by MORE than its
        spawning process: the supervisor's socketpair (``primary``) plus
        a TCP ``listener`` whose endpoint the worker advertises through
        its heartbeat meta (the ``rpc`` key). Router processes connect
        and reconnect at will; a SIGKILLed router only costs its own
        connection — EOF on an accepted socket drops THAT socket and
        the loop returns to select, which is what lets workers outlive
        the router that is being failed over. EOF on ``primary`` (the
        supervisor died) still ends the worker, same contract as
        :meth:`serve`.

        Still strictly single-threaded, one request serviced at a time:
        readiness is multiplexed with ``selectors`` but each frame is
        read and answered to its originating socket before the next is
        picked up — the engine is not thread-safe and does not become
        so here."""
        import selectors
        sel = selectors.DefaultSelector()
        sel.register(primary, selectors.EVENT_READ, "primary")
        if listener is not None:
            sel.register(listener, selectors.EVENT_READ, "listener")
        accepted: List[socket.socket] = []
        try:
            while True:
                for key, _ in sel.select():
                    sock = key.fileobj
                    if key.data == "listener":
                        try:
                            conn, _addr = sock.accept()
                        except OSError:
                            continue
                        sel.register(conn, selectors.EVENT_READ, "conn")
                        accepted.append(conn)
                        continue
                    try:
                        msg = recv_frame(sock)
                    except OSError:
                        msg = None
                    if msg is None:  # this caller is gone
                        if key.data == "primary":
                            return
                        sel.unregister(sock)
                        accepted.remove(sock)
                        try:
                            sock.close()
                        except OSError:
                            pass
                        continue
                    try:
                        if self._serve_one(sock, msg, should_stop):
                            return
                    except OSError:
                        # reply delivery failed mid-service: the caller
                        # died between sending and reading. Its state
                        # change (if any) stands; drop the connection.
                        if key.data == "primary":
                            return
                        sel.unregister(sock)
                        accepted.remove(sock)
                        try:
                            sock.close()
                        except OSError:
                            pass
                        continue
                    if self.on_tick is not None:
                        self.on_tick()
        finally:
            sel.close()
            for conn in accepted:
                try:
                    conn.close()
                except OSError:
                    pass

    def _rng_for(self, outputs: List[RequestOutput]) -> Dict[str, dict]:
        """Post-step RNG states for every request that emitted this
        step — the piggyback that makes post-SIGKILL hand-off
        bit-identical (see module docstring)."""
        out: Dict[str, dict] = {}
        for o in outputs:
            if o.request_id in out:
                continue
            state = self.replica.rng_state(o.request_id)
            if state is not None:
                out[o.request_id] = state
        return out

    def _kv_for(self, outputs: List[RequestOutput]):
        """Drain-parked KV payloads for this reply's drain-aborted
        requests — the block-transfer analog of the RNG piggyback: by
        the time the router could ask, a drained-out worker has already
        exited, so the bytes must ride the same reply that carries the
        structured aborts. One concatenated blob, per-request metas
        with (off, len) spans, capped at MAX_FRAME per reply (the
        shipped-batch cap); requests past the cap get no payload and
        fall back to recompute — counted and logged, never silent."""
        export = getattr(self.replica, "export_kv", None)
        if export is None:
            return {}, b"", 0
        metas: Dict[str, dict] = {}
        chunks: List[bytes] = []
        off = 0
        skipped = 0
        for o in outputs:
            if o.finish_reason != "aborted:drain" \
                    or o.request_id in metas:
                continue
            res = export(o.request_id)
            if res is None:
                continue
            meta, payload = res
            if off + len(payload) > MAX_FRAME:
                skipped += 1
                self.num_kv_snapshot_skipped += 1
                _log.debug(
                    "drain KV snapshot for %s skipped: %dB payload "
                    "would push the reply past the %dB frame cap "
                    "(%dB already packed) — the peer falls back to "
                    "recompute", o.request_id, len(payload), MAX_FRAME,
                    off)
                continue
            meta = dict(meta)
            meta["off"] = off
            meta["len"] = len(payload)
            metas[o.request_id] = meta
            chunks.append(payload)
            off += len(payload)
        return metas, b"".join(chunks), skipped

    def _dispatch(self, method: str, p: dict) -> Any:
        r = self.replica
        if method == "ping":
            return {"replica_id": r.replica_id, "alive": bool(r.alive),
                    "peer": getattr(r, "peer_endpoint", None),
                    "role": getattr(r, "role", None)}
        if method == "admission_verdict":
            return r.admission_verdict(int(p["prompt_tokens"]))
        if method == "estimated_ttft_ms":
            return r.estimated_ttft_ms(int(p["prompt_tokens"]))
        if method == "load":
            return r.load().as_dict()
        if method == "is_draining":
            return bool(r.is_draining)
        if method == "drained":
            return bool(r.drained)
        if method == "has_unfinished":
            return bool(r.has_unfinished())
        if method == "rng_state":
            return r.rng_state(p["request_id"])
        if method == "snapshot":
            snap = getattr(r, "snapshot", None)
            return snap() if callable(snap) else {}
        if method == "add_request":
            r.add_request(p["request_id"],
                          [int(t) for t in p["prompt_ids"]],
                          SamplingParams(**p["sampling"]),
                          rng_state=p.get("rng_state"))
            return True
        if method == "abort_request":
            return bool(r.abort_request(p["request_id"]))
        if method == "release_request":
            r.release_request(p["request_id"])
            return True
        if method == "fence_request":
            return bool(r.fence_request(p["request_id"], int(p["gen"])))
        if method == "step":
            outs = r.step()
            return self._step_reply(outs)
        if method == "start_drain":
            outs = r.start_drain(p.get("reason", "manual"))
            return self._step_reply(outs)
        if method == "export_kv":
            res = r.export_kv(p["request_id"])
            if res is None:
                return None
            meta, payload = res
            out = dict(meta)
            out["_blob"] = payload
            return out
        if method == "import_kv":
            return bool(r.import_kv(
                p["request_id"], [int(t) for t in p["prompt_ids"]],
                SamplingParams(**p["sampling"]), meta=p["meta"],
                payload=p.get("_blob", b""),
                rng_state=p.get("rng_state")))
        if method == "prefix_digest":
            dig = getattr(r, "prefix_digest", None)
            return dig() if callable(dig) else None
        if method == "export_prefix":
            exp = getattr(r, "export_prefix", None)
            res = exp(p["chain_hash"]) if callable(exp) else None
            if res is None:
                return None
            meta, payload = res
            out = dict(meta)
            out["_blob"] = payload
            return out
        if method == "import_prefix":
            imp = getattr(r, "import_prefix", None)
            if not callable(imp):
                return False
            return bool(imp(meta=p["meta"],
                            payload=p.get("_blob", b"")))
        if method == "park_kv":
            return r.park_kv(p["request_id"])
        if method == "drop_parked":
            r.drop_parked(p["request_id"])
            return True
        if method == "peer_send":
            return r.peer_send(dict(p["ticket"]), p["endpoint"])
        if method == "peer_commit":
            sp = p.get("sampling")
            return bool(r.peer_commit(
                p["ticket_id"], kind=p.get("kind", "kv"),
                request_id=p.get("request_id"),
                prompt_ids=[int(t) for t in p.get("prompt_ids") or []],
                sampling=SamplingParams(**sp) if sp else None,
                rng_state=p.get("rng_state")))
        if method == "park_session":
            return r.park_session(p["session_id"])
        if method == "resume_session":
            return r.resume_session(
                p["request_id"], p["session_id"],
                [int(t) for t in p["prompt_ids"]],
                SamplingParams(**p["sampling"]),
                rng_state=p.get("rng_state"))
        if method == "drop_session":
            return bool(r.drop_session(p["session_id"],
                                       to_peer=bool(p.get("to_peer"))))
        if method == "adopt_session":
            return bool(r.adopt_session(
                p["session_id"], [int(t) for t in p["tokens"]],
                int(p["covered"]), tenant=p.get("tenant")))
        if method == "tier_stats":
            return r.tier_stats()
        if method == "shutdown":
            return True
        raise RpcError(f"unknown method {method!r}")

    def _step_reply(self, outs: List[RequestOutput]) -> dict:
        res = {"outputs": [_output_to_wire(o) for o in outs],
               "rng": self._rng_for(outs),
               "alive": bool(self.replica.alive)}
        kv, blob, skipped = self._kv_for(outs)
        if kv:
            res["kv"] = kv
            res["_blob"] = blob
        if skipped:
            res["kv_skipped"] = skipped
        return res


class SubprocessReplica(ReplicaHandle):
    """A worker process behind the ``ReplicaHandle`` seam.

    Death model: the handle goes (and stays) dead when the process
    exits, the connection drops, a mutation call times out, or the
    worker reports its engine died. Queries on a dead handle return the
    same safe values ``InProcessReplica`` returns for ``alive=False``;
    ``rng_state`` answers from the piggyback cache so the router's
    post-mortem hand-off works on a corpse."""

    # the worker heartbeats the registry itself (that is the liveness
    # signal); the router must NOT heartbeat on its behalf, or a hung
    # worker would look alive forever
    self_heartbeat = True

    def __init__(self, replica_id: str, client: RpcClient, *,
                 proc=None, deadlines: Optional[Dict[str, float]] = None,
                 role: Optional[str] = None):
        self.replica_id = replica_id
        self.retiring = False
        self.created_at = time.monotonic()
        self.role = role  # "prefill" | "decode" | None (both)
        self._client = client
        self._proc = proc  # subprocess.Popen, or None for loopback
        self._dead = False
        self._rng_cache: Dict[str, dict] = {}
        # drain-reply KV piggyback cache: (meta, payload) per request,
        # answering export_kv post-mortem exactly like _rng_cache
        self._kv_cache: Dict[str, tuple] = {}
        # worker-side drain snapshots dropped at the frame cap,
        # accumulated from step replies (fleet/kv_snapshot_skipped)
        self.num_kv_snapshot_skipped = 0
        self._deadlines = dict(DEFAULT_DEADLINES)
        if deadlines:
            self._deadlines.update(deadlines)

    def _deadline(self, method: str) -> float:
        return self._deadlines.get(method, self._deadlines["*"])

    # -- liveness ----------------------------------------------------------
    @property
    def alive(self) -> bool:
        if self._dead:
            return False
        if self._client.closed:
            self._dead = True
            return False
        if self._proc is not None and self._proc.poll() is not None:
            self._dead = True
            return False
        return True

    @alive.setter
    def alive(self, value: bool) -> None:
        # the router declares death (kill_replica); resurrection is a
        # NEW handle (new process, new generation id), never this one
        if not value:
            self._dead = True

    def hard_kill(self) -> None:
        """SIGKILL the worker — the ``fleet.worker_kill`` fault
        injector. Detection is left to the normal paths (process exit /
        EOF / heartbeat TTL), which is the point of the exercise."""
        if self._proc is not None:
            self._proc.kill()

    @property
    def proc(self):
        return self._proc

    @property
    def rpc_stats(self) -> Dict[str, float]:
        return dict(self._client.stats)

    # -- queries (idempotent: retried, then safe default) ------------------
    def _query(self, method: str, params: Optional[dict] = None, *,
               default=None):
        if not self.alive:
            return default
        try:
            return self._client.call(
                method, params, deadline_s=self._deadline(method))
        except (RpcError, OSError):
            self._dead = True  # deadline exhausted or connection gone
            return default

    def admission_verdict(self, prompt_tokens: int) -> Optional[str]:
        return self._query("admission_verdict",
                           {"prompt_tokens": prompt_tokens},
                           default="replica is dead")

    def estimated_ttft_ms(self, prompt_tokens: int) -> Optional[float]:
        return self._query("estimated_ttft_ms",
                           {"prompt_tokens": prompt_tokens})

    def load(self) -> ReplicaLoad:
        d = self._query("load")
        return ReplicaLoad(**d) if d else ReplicaLoad()

    @property
    def is_draining(self) -> bool:
        return bool(self._query("is_draining", default=False))

    @property
    def drained(self) -> bool:
        return bool(self._query("drained", default=True))

    def has_unfinished(self) -> bool:
        return bool(self._query("has_unfinished", default=False))

    def snapshot(self) -> dict:
        return self._query("snapshot", default={}) or {}

    def fence_request(self, request_id: str, gen: int) -> bool:
        # default True on unreachability: only an explicit replica-side
        # refusal is a fence verdict — a dead/unreachable worker cannot
        # emit for ANY owner, and the dispatch that follows fails on
        # its own (health sweep requeues with the lease intact)
        return bool(self._query(
            "fence_request", {"request_id": request_id, "gen": int(gen)},
            default=True))

    def rng_state(self, request_id: str):
        # cache-first, deliberately: the cache advances only with step
        # replies the client actually received, so it stays in lockstep
        # with the ACKed progress the router replays from. A live query
        # could return a state AHEAD of that (a step whose reply was
        # lost still advanced the engine) — wrong for resume parity —
        # and on a freshly-exited worker it would hang until deadline.
        state = self._rng_cache.get(request_id)
        if state is None and self.alive:
            state = self._query("rng_state", {"request_id": request_id})
            if state is not None:
                self._rng_cache[request_id] = state
        return state

    # -- mutations (never retried: failure = replica death) ----------------
    def _mutate(self, method: str, params: dict,
                blob: Optional[bytes] = None):
        """One attempt; a transport failure marks the replica dead and
        returns None. No raise: the router's health sweep re-enqueues
        whatever was assigned here, and the abandoned worker can never
        emit to the router again — so no duplication either way.
        (Clean remote ValueError/KeyError DO propagate: the call
        executed and failed deterministically — no death.)"""
        try:
            return self._client.call(method, params, idempotent=False,
                                     deadline_s=self._deadline(method),
                                     blob=blob)
        except (RpcTimeout, ReplicaGone, RpcRemoteError, OSError):
            self._dead = True
            return None

    def add_request(self, request_id: str, prompt_ids: Sequence[int],
                    sampling: SamplingParams, *, rng_state=None) -> None:
        self._mutate("add_request", {
            "request_id": request_id,
            "prompt_ids": [int(t) for t in prompt_ids],
            "sampling": dataclasses.asdict(sampling),
            "rng_state": rng_state})

    def abort_request(self, request_id: str) -> bool:
        if not self.alive:
            return False
        return bool(self._mutate("abort_request",
                                 {"request_id": request_id}))

    def release_request(self, request_id: str) -> None:
        self._rng_cache.pop(request_id, None)
        self._kv_cache.pop(request_id, None)
        if self.alive:
            self._mutate("release_request", {"request_id": request_id})

    # -- fleet KV-ship -----------------------------------------------------
    def export_kv(self, request_id: str):
        """(meta, payload) for the request's committed KV — from the
        drain-reply piggyback cache first (a drained-out worker is
        already gone when the router asks), else a live idempotent
        query carrying the payload back as a raw-bytes frame."""
        cached = self._kv_cache.get(request_id)
        if cached is not None:
            return cached
        if not self.alive:
            return None
        res = self._query("export_kv", {"request_id": request_id})
        if not isinstance(res, dict) or "_blob" not in res:
            return None
        payload = res.pop("_blob")
        return res, payload

    def import_kv(self, request_id: str, prompt_ids: Sequence[int],
                  sampling: SamplingParams, *, meta: dict,
                  payload: bytes, rng_state=None) -> bool:
        """Ship a KV payload into this replica. One attempt (mutation
        semantics); a CLEAN remote rejection (checksum/geometry
        mismatch, cache full, draining) crosses back as ValueError and
        returns False — the replica stays alive and the router falls
        back to recompute."""
        if not self.alive:
            return False
        try:
            return bool(self._mutate("import_kv", {
                "request_id": request_id,
                "prompt_ids": [int(t) for t in prompt_ids],
                "sampling": dataclasses.asdict(sampling),
                "meta": {k: v for k, v in meta.items()
                         if k not in ("off", "len")},
                "rng_state": rng_state}, blob=payload))
        except ValueError:
            return False

    # -- peer data plane ---------------------------------------------------
    def park_kv(self, request_id: str) -> Optional[dict]:
        """Ask the worker to gather a request's committed KV to host
        memory and hold it for a later ticketed transfer. Mutation
        semantics (the stash is replica-side state); a clean remote
        refusal returns None with the replica alive."""
        if not self.alive:
            return None
        try:
            res = self._mutate("park_kv", {"request_id": request_id})
        except (ValueError, KeyError):
            return None
        return res if isinstance(res, dict) else None

    def drop_parked(self, request_id: str) -> None:
        if self.alive:
            try:
                self._mutate("drop_parked", {"request_id": request_id})
            except (ValueError, KeyError):
                pass

    def peer_send(self, ticket: dict, endpoint: str) -> Optional[dict]:
        """Tell the worker to push its parked/exported payload for this
        ticket straight to ``endpoint``. One attempt. An ``RpcTimeout``
        here means the RUNG died, not the replica — the worker's
        service thread was blocked pushing against a slow or dead PEER,
        and the destination-side ticket idempotence makes the ambiguity
        safe — so the source is NOT marked dead. A torn connection or
        an unexpected remote error still is."""
        if not self.alive:
            return None
        deadline = (float(ticket.get("deadline_ms", 30e3)) / 1e3
                    + self._deadline("peer_send"))
        try:
            res = self._client.call(
                "peer_send", {"ticket": dict(ticket),
                              "endpoint": endpoint},
                idempotent=False, deadline_s=deadline)
        except RpcTimeout:
            return None
        except (ReplicaGone, RpcRemoteError, OSError):
            self._dead = True
            return None
        except (ValueError, KeyError):
            return None
        return res if isinstance(res, dict) else None

    def peer_commit(self, ticket_id: str, *, kind: str = "kv",
                    request_id: Optional[str] = None,
                    prompt_ids: Optional[Sequence[int]] = None,
                    sampling: Optional[SamplingParams] = None,
                    rng_state=None) -> bool:
        """Commit a staged peer delivery into the destination engine.
        Full mutation semantics: a lost reply marks the destination
        dead (which is exactly what keeps an ambiguous commit from
        ever producing a duplicate emission); a clean remote refusal
        crosses back as ValueError -> False, replica alive."""
        if not self.alive:
            return False
        params = {"ticket_id": ticket_id, "kind": kind,
                  "request_id": request_id,
                  "prompt_ids": [int(t) for t in prompt_ids or []],
                  "sampling": (dataclasses.asdict(sampling)
                               if sampling is not None else None),
                  "rng_state": rng_state}
        try:
            return bool(self._mutate("peer_commit", params))
        except (ValueError, KeyError):
            return False

    # -- tiered-KV sessions ------------------------------------------------
    def park_session(self, session_id: str) -> Optional[dict]:
        """Mutation semantics (the demotion moves replica-side state);
        a clean remote refusal returns None with the replica alive."""
        if not self.alive:
            return None
        try:
            res = self._mutate("park_session", {"session_id": session_id})
        except (ValueError, KeyError):
            return None
        return res if isinstance(res, dict) else None

    def resume_session(self, request_id: str, session_id: str,
                       prompt_ids: Sequence[int],
                       sampling: SamplingParams, *,
                       rng_state=None) -> Optional[int]:
        if not self.alive:
            return None
        try:
            res = self._mutate("resume_session", {
                "request_id": request_id, "session_id": session_id,
                "prompt_ids": [int(t) for t in prompt_ids],
                "sampling": dataclasses.asdict(sampling),
                "rng_state": rng_state})
        except (ValueError, KeyError):
            return None
        return int(res) if res is not None else None

    def drop_session(self, session_id: str, *,
                     to_peer: bool = False) -> bool:
        if not self.alive:
            return False
        try:
            return bool(self._mutate("drop_session",
                                     {"session_id": session_id,
                                      "to_peer": bool(to_peer)}))
        except (ValueError, KeyError):
            return False

    def adopt_session(self, session_id: str, tokens: Sequence[int],
                      covered: int, *, tenant: Optional[str] = None) -> bool:
        if not self.alive:
            return False
        try:
            return bool(self._mutate("adopt_session", {
                "session_id": session_id,
                "tokens": [int(t) for t in tokens],
                "covered": int(covered), "tenant": tenant}))
        except (ValueError, KeyError):
            return False

    def tier_stats(self) -> Optional[dict]:
        res = self._query("tier_stats")
        return res if isinstance(res, dict) else None

    # -- fleet prefix cache ------------------------------------------------
    def prefix_digest(self) -> Optional[dict]:
        return self._query("prefix_digest")

    def export_prefix(self, chain_hash: str):
        if not self.alive:
            return None
        res = self._query("export_prefix", {"chain_hash": chain_hash})
        if not isinstance(res, dict) or "_blob" not in res:
            return None
        payload = res.pop("_blob")
        return res, payload

    def import_prefix(self, *, meta: dict, payload: bytes) -> bool:
        """Ship a cached prefix into this replica. One attempt
        (mutation semantics); a clean remote rejection crosses back as
        ValueError and returns False — the replica stays alive and the
        ship is simply dropped."""
        if not self.alive:
            return False
        try:
            return bool(self._mutate(
                "import_prefix",
                {"meta": {k: v for k, v in meta.items()
                          if k not in ("off", "len")}},
                blob=payload))
        except ValueError:
            return False

    def _absorb_step_result(self, res) -> List[RequestOutput]:
        if res is None:
            return []
        self.num_kv_snapshot_skipped += int(res.get("kv_skipped", 0))
        outs = [_output_from_wire(d) for d in res.get("outputs", [])]
        for rid, state in (res.get("rng") or {}).items():
            self._rng_cache[rid] = state
        blob = res.get("_blob") or b""
        for rid, meta in (res.get("kv") or {}).items():
            off = int(meta.get("off", 0))
            ln = int(meta.get("len", 0))
            self._kv_cache[rid] = (
                {k: v for k, v in meta.items() if k not in ("off", "len")},
                blob[off:off + ln])
        for o in outs:
            if o.finished and o.finish_reason in (
                    "stop", "length", "expired", "rejected",
                    "aborted:user", "aborted:nonfinite"):
                self._rng_cache.pop(o.request_id, None)  # never handed off
                self._kv_cache.pop(o.request_id, None)
        if not res.get("alive", True):
            self._dead = True  # remote engine died; aborts are in outs
        if res.get("drained_out"):
            # the worker exits right after this reply, having drained
            # everything: a graceful departure, not a failure domain
            self.retiring = True
        return outs

    def step(self) -> List[RequestOutput]:
        if not self.alive:
            return []
        return self._absorb_step_result(self._mutate("step", {}))

    def start_drain(self, reason: str = "manual") -> List[RequestOutput]:
        if not self.alive:
            return []
        return self._absorb_step_result(
            self._mutate("start_drain", {"reason": reason}))

    def close(self) -> None:
        self._client.close()
        self._dead = True


def connect_replica(replica_id: str, endpoint: str, *,
                    deadlines: Optional[Dict[str, float]] = None,
                    role: Optional[str] = None,
                    deadline_s: float = 30.0) -> SubprocessReplica:
    """Attach to an already-running worker by its control endpoint.

    The replicated-control-plane join path: workers spawned with
    ``WorkerSpec(tcp=True)`` advertise a ``host:port`` control listener
    in their heartbeat meta under ``"rpc"`` (serviced by
    :meth:`ReplicaServicer.serve_multi`), so any router process — not
    just the spawning supervisor — can drive them, and a replacement
    router can re-adopt a fleet whose previous router was SIGKILLed.
    Pings once before returning, so a stale endpoint fails fast here
    rather than on the first dispatch."""
    host, _, port = endpoint.rpartition(":")
    sock = socket.create_connection((host, int(port)),
                                    timeout=deadline_s)
    client = RpcClient(sock, name=replica_id)
    handle = SubprocessReplica(replica_id, client, deadlines=deadlines,
                               role=role)
    try:
        pong = client.call("ping", deadline_s=deadline_s)
    except (RpcError, OSError) as e:
        client.close()
        raise ReplicaGone(
            f"worker {replica_id} at {endpoint} unreachable: {e}")
    if isinstance(pong, dict) and pong.get("peer"):
        handle.peer_endpoint = pong["peer"]
    return handle
