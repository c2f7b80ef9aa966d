"""Step watchdog and preemption notice (port of
``paddle_tpu/distributed/watchdog.py``).

The watchable unit is the *step*: a dispatch (on the card, one CUDA graph
replay, or an eager training step) and its completion on the device.
:class:`StepWatchdog` tracks each step in flight with a deadline:
:meth:`~StepWatchdog.arm` before the dispatch, :meth:`~StepWatchdog.attach`
after it with a CUDA event recorded after the step on the step's stream
(``None`` on the CPU, where the step is complete when the dispatch
returns). One daemon prober waits on each attached event and clears its
entry; one daemon monitor fires for every entry past its deadline whose
event has not completed: it dumps the host stacks and calls
``on_timeout`` (without one, the process exits with code 6 so that the
launcher's restart loop can re-form the gang).

The gang half is the reference's. With ``broadcast_abort=True`` (the
default) a firing rank posts ``rank R hung on [tags]`` to the gang
store's ``watchdog_abort`` record, and every rank's monitor polls that
record every ``PADDLE_ABORT_POLL`` seconds: a record posted by another
rank (and changed since this process first looked, so a record of an
earlier incarnation of the gang never counts) makes it exit with code 7,
or calls ``on_remote_abort``. Every rank leaving so (6 or 7) leaves one
poll interval and two monitor periods after the record was posted, so
that the whole gang reads the record before any rank's sockets close
under peers blocked in a gloo collective with it; meanwhile a failure
of its own main thread still ends it with its code. :func:`default_watchdog` is the process-wide watchdog
the training hooks arm (:func:`arm_step`, :func:`attach_step`,
:func:`watch_step`, the eager collectives), driven by the
``step_timeout_s`` flag (``PADDLE_STEP_TIMEOUT``); with no timeout every
hook is a no-op.

Both threads reach the watchdog through a weak reference only and end
once it is freed, so an engine that owns a watchdog is freed when its
last reference drops. They never allocate device memory; the prober
synchronises on events recorded after a step, which the step graphs
allow, as a precaution, while they capture (``jit/trace.py`` captures
in the ``"thread_local"`` mode).

:class:`PreemptionMonitor` turns SIGTERM (a cloud preemption notice, a
launcher's shutdown) into a flag that the train and serving loops poll
between steps, and broadcasts it through the same gang store, so one
rank's notice reaches every rank.
"""
from __future__ import annotations

import atexit
import faulthandler
import json
import os
import queue
import signal as _signal
import sys
import threading
import time
import uuid
import weakref
from typing import Callable, Dict, Optional

__all__ = ["StepWatchdog", "default_watchdog", "arm_step", "attach_step",
           "watch_step", "COMPILE_ALLOWANCE", "PreemptionMonitor",
           "preemption_monitor"]

from paddle_tpu_torch.core import flags as _flags

_flags.define_flag("step_timeout_s", float(os.environ.get(
    "PADDLE_STEP_TIMEOUT", "0") or 0),
    "abort the process if a dispatched step does not complete on device\n"
    "            within this many seconds (0 = disabled); the launcher's\n"
    "            restart loop then re-forms the gang")

ABORT_KEY = "watchdog_abort"
ABORT_POLL_S = float(os.environ.get("PADDLE_ABORT_POLL", "1.0"))

# a step's first run on the card also warms up (and captures): slow, not
# hung, so its deadline stretches by this factor
COMPILE_ALLOWANCE = float(os.environ.get(
    "PADDLE_STEP_COMPILE_ALLOWANCE", "10"))


def _start(target, *args) -> threading.Thread:
    t = threading.Thread(target=target, args=args, daemon=True)
    t.start()
    return t


def _rank():
    try:
        from paddle_tpu_torch.distributed import env

        return env.get_rank()
    except Exception:
        return "?"


class _StoreChannel:
    """One gang-store record under ``key``, shared by the watchdog's
    abort broadcast and the preemption monitor's notice: store lookup
    with a retry backoff, posts stamped with the rank and a generation
    uuid, and changed-since-baseline reads. Whatever record is present
    on the FIRST look predates this process (an earlier incarnation of
    the gang) and only a CHANGED record counts, so no wall clock is
    compared."""

    def __init__(self, key: str):
        self.key = key
        self.store = None  # injectable for tests (False = lookup failed)
        self.retry_at = 0.0
        self.baseline = None
        self.baseline_read = False
        # held around every store call, so that release() returns only
        # once no call is in flight
        self.lock = threading.Lock()
        self.released = False

    def release(self):
        """Stop using the store for good (the world is torn down)."""
        with self.lock:
            self.store = False
            self.released = True

    def get_store(self):
        if self.store not in (None, False):
            return self.store
        if self.released:
            return None
        # a failed lookup is retried after a backoff: the world often
        # comes up after the channel is first used
        now = time.monotonic()
        if self.store is False and now - self.retry_at < 10.0:
            return None
        self.retry_at = now
        try:
            from paddle_tpu_torch.distributed.store import current_store

            self.store = current_store() or False
        except Exception:
            self.store = False
        return self.store or None

    def post(self, payload: dict):
        with self.lock:
            store = self.get_store()
            if store is None:
                return
            try:
                rec = {"rank": _rank(), "ts": time.time(),
                       "gen": uuid.uuid4().hex}
                rec.update(payload)
                store.set(self.key, json.dumps(rec))
            except Exception:
                pass

    def _read(self):
        with self.lock:
            store = self.get_store()
            if store is None:
                return False, None
            try:
                return True, store.try_get(self.key)
            except Exception:
                return False, None

    def read_baseline(self):
        ok, v = self._read()
        if not ok:
            return
        self.baseline = v
        self.baseline_read = True

    def changed(self):
        """The raw record iff it changed since the baseline, else None.
        The first read only records the baseline."""
        ok, v = self._read()
        if not ok:
            return None
        if not self.baseline_read:
            self.baseline = v
            self.baseline_read = True
            return None
        if not v or v == self.baseline:
            return None
        return v


def _watch(ref):
    """The monitor: every tenth of the timeout (0.01-0.2 s), fire for the
    entries past their deadline, and poll the gang's abort record. Ends
    when the watchdog is freed."""
    while True:
        wd = ref()
        if wd is None:
            return
        period = wd._period()
        del wd
        time.sleep(period)
        wd = ref()
        if wd is None:
            return
        wd._check()
        del wd


def _probe(ref, q):
    """The prober: wait for each attached step's event, then clear its
    entry. Ends when the watchdog is freed."""
    while True:
        try:
            eid, done = q.get(timeout=0.5)
        except queue.Empty:
            if ref() is None:
                return
            continue
        try:
            done.synchronize()
        except Exception:
            pass  # a failed step surfaces on the dispatching thread
        wd = ref()
        if wd is None:
            return
        wd.disarm(eid)
        del wd


class StepWatchdog:
    def __init__(self, timeout: Optional[float] = None,
                 on_timeout: Optional[Callable] = None,
                 on_remote_abort: Optional[Callable] = None,
                 broadcast_abort: bool = True):
        """``timeout`` in seconds (None: the ``step_timeout_s`` flag; 0:
        off); ``on_timeout(expired)`` gets the expired ``(tag, deadline,
        event)`` entries; ``on_remote_abort(info)`` gets a peer's abort
        record. ``broadcast_abort=False`` makes this a PROCESS-LOCAL
        watchdog: a timeout neither posts to the gang store nor reacts
        to peers' records (the serving engine's: a hung serving step
        drains that engine, it does not take down a training gang that
        shares the store)."""
        self._timeout = timeout
        self._on_timeout = on_timeout
        self._on_remote_abort = on_remote_abort
        self.broadcast_abort = broadcast_abort
        self._entries: Dict[int, tuple] = {}  # id -> (tag, deadline, event)
        self._lock = threading.Lock()
        self._seq = 0
        self._monitor: Optional[threading.Thread] = None
        self._prober: Optional[threading.Thread] = None
        self._probe_q: Optional[queue.SimpleQueue] = None
        self.fired = False
        self._abort_ch = _StoreChannel(ABORT_KEY)
        self._abort_polled = 0.0

    @property
    def _store(self):
        return self._abort_ch.store

    @_store.setter
    def _store(self, v):
        self._abort_ch.store = v

    @property
    def timeout(self) -> float:
        if self._timeout is not None:
            return float(self._timeout)
        return float(_flags.flag("step_timeout_s") or 0)

    @property
    def enabled(self) -> bool:
        return self.timeout > 0

    def _period(self) -> float:
        return min(0.2, max(0.01, self.timeout / 10))

    # -- tracking --------------------------------------------------------
    def arm(self, tag: str, factor: float = 1.0) -> int:
        """Record a step's start with a deadline ``factor`` x the timeout
        away. Call it BEFORE the dispatch: a hang may happen inside the
        dispatch call itself. Returns the entry id (0 when disabled)."""
        if not self.enabled:
            return 0
        with self._lock:
            self._seq += 1
            eid = self._seq
            self._entries[eid] = (tag,
                                  time.monotonic() + self.timeout * factor,
                                  None)
            if self._monitor is None:
                self._monitor = _start(_watch, weakref.ref(self))
        return eid

    def attach(self, eid: int, done) -> None:
        """After the dispatch: ``done`` is a CUDA event recorded after the
        step, which the prober waits on before it clears the entry; None
        means the step has completed, and the entry clears now. Since a
        slow earlier probe delays later ones, the monitor also queries an
        expired entry's event before it fires, so a probe that is merely
        behind never raises a false alarm."""
        if not eid:
            return
        if done is None:
            self.disarm(eid)
            return
        with self._lock:
            ent = self._entries.get(eid)
            if ent is not None:
                self._entries[eid] = (ent[0], ent[1], done)
            if self._prober is None:
                self._probe_q = queue.SimpleQueue()
                self._prober = _start(_probe, weakref.ref(self),
                                      self._probe_q)
        self._probe_q.put((eid, done))

    def disarm(self, eid: int) -> None:
        with self._lock:
            self._entries.pop(eid, None)

    def track(self, done, tag: str) -> None:
        """arm + attach in one call (a step already dispatched)."""
        self.attach(self.arm(tag), done)

    # -- monitor ---------------------------------------------------------
    @staticmethod
    def _device_done(done) -> bool:
        """Non-blocking: True iff the step's event has completed (its
        probe is only behind)."""
        if done is None:
            return False
        try:
            return bool(done.query())
        except Exception:
            return False

    def _check(self):
        now = time.monotonic()
        with self._lock:
            expired_ids = [k for k, (_, dl, _e) in self._entries.items()
                           if dl < now]
            expired = [self._entries.pop(k) for k in expired_ids]
        really = [ent for ent in expired if not self._device_done(ent[2])]
        if really:
            # the default path exits; a custom on_timeout keeps the
            # monitor alive for later steps
            self._fire(really)
        if self.broadcast_abort and \
                time.monotonic() - self._abort_polled >= ABORT_POLL_S:
            self._abort_polled = time.monotonic()
            self._check_remote_abort()

    # -- cross-rank abort (the comm_task_manager gang-abort role) ---------
    def _post_abort(self, tags: str):
        """Broadcast 'rank R hung on [tags]' so that the surviving ranks
        exit now instead of waiting out their own timeouts."""
        self._abort_ch.post({"tags": tags, "timeout_s": self.timeout})

    def _check_remote_abort(self):
        if self.fired:
            return
        v = self._abort_ch.changed()
        if v is None:
            return
        try:
            info = json.loads(v.decode())
        except Exception:
            info = {"rank": "?", "tags": v.decode(errors="replace")}
        if info.get("rank") == _rank():
            return  # our own post
        self.fired = True
        sys.stderr.write(
            f"\n[watchdog] rank {info.get('rank')} aborted on "
            f"[{info.get('tags')}]; exiting with the gang so that the "
            f"launcher can restart all ranks together\n")
        sys.stderr.flush()
        if self._on_remote_abort is not None:
            self._on_remote_abort(info)
        else:
            self._leave(7, info.get("ts"))

    def start_abort_watch(self):
        """Start the monitor before any step is armed, so that an idle
        rank still reacts to a peer's abort broadcast."""
        if not self.enabled:
            return
        with self._lock:
            if self._monitor is None:
                self._monitor = _start(_watch, weakref.ref(self))

    def _fire(self, expired):
        self.fired = True
        tags = ", ".join(ent[0] for ent in expired)
        sys.stderr.write(
            f"\n[watchdog] rank {_rank()}: step(s) [{tags}] exceeded the "
            f"{self.timeout}s deadline; the device appears hung; dumping "
            f"host stacks"
            + (", broadcasting the abort" if self.broadcast_abort else "")
            + "\n")
        sys.stderr.flush()
        try:
            faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        except Exception:
            pass
        if self.broadcast_abort:
            self._post_abort(tags)
        if self._on_timeout is not None:
            self._on_timeout(expired)
            return
        if self.broadcast_abort:
            self._leave(6)
        os._exit(6)

    def _leave(self, code: int, posted: Optional[float] = None):
        """Exit with ``code`` once every rank of the gang has had a poll
        to read the abort record, a poll interval and two monitor periods
        after it was posted (at ``posted``, the record's stamp; now for
        the rank that posts it): a rank that left at once would close its
        sockets under peers blocked in a collective with it, which would
        fail before they read the record. The wait is never longer than
        that linger, so a stamp from a skewed clock only shortens it. A
        failure the main thread meets meanwhile (a peer that left first)
        still ends the process with ``code``."""
        atexit.register(os._exit, code)
        linger = ABORT_POLL_S + 2 * self._period()
        if posted is not None:
            try:
                linger = min(linger, max(0.0, float(posted) + linger
                                         - time.time()))
            except (TypeError, ValueError):
                pass
        time.sleep(linger)
        os._exit(code)


_default: Optional[StepWatchdog] = None


def default_watchdog() -> StepWatchdog:
    """The process-wide watchdog (``step_timeout_s``, gang broadcast)."""
    global _default
    if _default is None:
        _default = StepWatchdog()
    return _default


def arm_step(tag: str, cold: bool = False) -> int:
    """Pre-dispatch hook for the train-step engines: a no-op unless
    ``step_timeout_s`` / ``PADDLE_STEP_TIMEOUT`` is set. ``cold`` marks a
    step's first run, which gets COMPILE_ALLOWANCE x the deadline."""
    return default_watchdog().arm(
        tag, factor=COMPILE_ALLOWANCE if cold else 1.0)


def attach_step(eid: int, done) -> None:
    """Post-dispatch hook: clears the deadline when the device finishes
    (``done``: a CUDA event recorded after the step, or None)."""
    default_watchdog().attach(eid, done)


def watch_step(done, tag: str) -> None:
    """arm + attach for a step already dispatched."""
    wd = default_watchdog()
    if wd.enabled:
        wd.track(done, tag)


def release_store() -> None:
    """Stop the process-wide watchdog and preemption monitor using the
    gang store (``destroy_process_group``: the world's store goes with
    the world); returns once no store call of theirs is in flight."""
    for ch in ((_default._abort_ch if _default is not None else None),
               (_preempt._ch if _preempt is not None else None)):
        if ch is not None:
            ch.release()


def step_done(device):
    """What a step's watchdog entry waits on: a CUDA event recorded now
    on ``device``'s current stream, or None on the CPU (the step is done
    when its dispatch returns)."""
    import torch

    if device is None or torch.device(device).type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


# ---------------------------------------------------------------------------
# preemption notice (SIGTERM): the save-and-exit side of the restart loop
# ---------------------------------------------------------------------------
PREEMPT_KEY = "preempt_notice"


class PreemptionMonitor:
    """Turn a SIGTERM into a flag the loops poll between steps, and
    broadcast it through the gang store the watchdog uses for aborts, so
    that ONE rank's notice makes every rank take its final checkpoint.
    The record is generation-guarded as the abort record is. The signal
    handler only sets the flag (anything heavier could deadlock on state
    that the interrupted code holds); the next :meth:`requested` poll
    posts the notice."""

    def __init__(self):
        self._flag = threading.Event()
        self._installed = False
        self._prev = {}
        self._ch = _StoreChannel(PREEMPT_KEY)
        self._last_poll = 0.0
        self._posted = False

    @property
    def _store(self):
        return self._ch.store

    @_store.setter
    def _store(self, v):
        self._ch.store = v

    def install(self, signals=None):
        """Chain the handler in front of any existing Python-level one.
        Must run on the main thread (the signal module's rule); off it,
        nothing is installed and :meth:`request` still sets the flag.
        The store's baseline is read now, so that a peer's notice posted
        during this process's first step is not taken for a stale one."""
        if self._installed:
            return self
        sigs = tuple(signals) if signals else (_signal.SIGTERM,)

        def handler(signum, frame):
            self._flag.set()
            prev = self._prev.get(signum)
            if callable(prev):
                prev(signum, frame)

        try:
            for s in sigs:
                self._prev[s] = _signal.signal(s, handler)
            self._installed = True
        except ValueError:
            pass
        self._ch.read_baseline()
        return self

    def uninstall(self):
        for s, prev in self._prev.items():
            try:
                _signal.signal(s, prev if prev is not None
                               else _signal.SIG_DFL)
            except (ValueError, TypeError):
                pass
        self._prev = {}
        self._installed = False

    def request(self):
        """Programmatic preemption (tests, a scheduler draining a host);
        posts the notice before it returns."""
        self._flag.set()
        self._posted = True
        self._ch.post({})

    def requested(self) -> bool:
        if self._flag.is_set():
            if not self._posted:
                # the deferred half of the signal handler
                self._posted = True
                self._ch.post({})
            return True
        now = time.monotonic()
        if now - self._last_poll < ABORT_POLL_S:
            return False
        self._last_poll = now
        if self._ch.changed() is not None:
            # the peer's record is in the store already: no echo
            self._posted = True
            self._flag.set()
            return True
        return False


_preempt: Optional[PreemptionMonitor] = None


def preemption_monitor() -> PreemptionMonitor:
    """The process-wide monitor."""
    global _preempt
    if _preempt is None:
        _preempt = PreemptionMonitor()
    return _preempt
