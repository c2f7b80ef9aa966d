"""Step watchdog and preemption notice, process-local (port of
``paddle_tpu/distributed/watchdog.py``).

The watchable unit is the *step*: a dispatch (on the card, one CUDA graph
replay) and its completion on the device. :class:`StepWatchdog` tracks
each step in flight with a deadline: :meth:`~StepWatchdog.arm` before
the dispatch, :meth:`~StepWatchdog.attach` after it with a CUDA event
recorded after the step on the step's stream (``None`` on the CPU, where
the step is complete when the dispatch returns). One daemon prober waits
on each attached event and clears its entry; one daemon monitor fires
for every entry past its deadline whose event has not completed: it
dumps the host stacks and calls ``on_timeout`` (without one, the process
exits with code 6 so that a supervisor can restart it).

Both threads reach the watchdog through a weak reference only and end
once it is freed, so an engine that owns a watchdog is freed when its
last reference drops. They never allocate device memory; the prober
synchronises on events recorded after a step, which the step graphs
allow, as a precaution, while they capture (``jit/trace.py`` captures
in the ``"thread_local"`` mode).

:class:`PreemptionMonitor` turns SIGTERM (a cloud preemption notice, a
launcher's shutdown) into a flag that the serving loop polls between
steps.

Process-local only. The gang-store record that broadcasts an abort or a
preemption notice to the other ranks of a training gang
(``broadcast_abort=True``, ``on_remote_abort``), and the flag-driven
process-wide watchdog (:func:`default_watchdog`, :func:`arm_step`,
:func:`attach_step`, :func:`watch_step`) come with slice D4 (distributed
training) and raise ``NotImplementedError`` here.
"""
from __future__ import annotations

import faulthandler
import os
import queue
import signal as _signal
import sys
import threading
import time
import weakref
from typing import Callable, Dict, Optional

__all__ = ["StepWatchdog", "COMPILE_ALLOWANCE", "PreemptionMonitor",
           "preemption_monitor"]

_SLICE_D = ("is not ported to paddle_tpu_torch yet: the gang-store abort "
            "broadcast and the process-wide step watchdog come with "
            "slice D4 (the gang half of distributed training)")

# a key's first step on the card also warms up and captures its graph:
# slow, not hung, so its deadline stretches by this factor
COMPILE_ALLOWANCE = float(os.environ.get(
    "PADDLE_STEP_COMPILE_ALLOWANCE", "10"))


def _start(target, *args) -> threading.Thread:
    t = threading.Thread(target=target, args=args, daemon=True)
    t.start()
    return t


def _watch(ref):
    """The monitor: every tenth of the timeout (0.01-0.2 s), fire for the
    entries past their deadline. Ends when the watchdog is freed."""
    while True:
        wd = ref()
        if wd is None:
            return
        period = min(0.2, max(0.01, wd.timeout / 10))
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
                 broadcast_abort: bool = False):
        """``timeout`` in seconds (None or 0: off; the reference's
        flag-driven default is slice D4's);
        ``on_timeout(expired)`` gets the expired ``(tag, deadline,
        event)`` entries. The reference's default ``broadcast_abort=True``
        and ``on_remote_abort`` belong to a training gang and are refused
        (slice D4)."""
        if broadcast_abort:
            raise NotImplementedError(f"StepWatchdog(broadcast_abort=True) "
                                      f"{_SLICE_D}")
        if on_remote_abort is not None:
            raise NotImplementedError(f"StepWatchdog(on_remote_abort=) "
                                      f"{_SLICE_D}")
        self._timeout = timeout
        self._on_timeout = on_timeout
        self.broadcast_abort = False
        self._entries: Dict[int, tuple] = {}  # id -> (tag, deadline, event)
        self._lock = threading.Lock()
        self._seq = 0
        self._monitor: Optional[threading.Thread] = None
        self._prober: Optional[threading.Thread] = None
        self._probe_q: Optional[queue.SimpleQueue] = None
        self.fired = False

    @property
    def timeout(self) -> float:
        return self._timeout or 0.0

    @property
    def enabled(self) -> bool:
        return self.timeout > 0

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
            self._fire(really)

    def _fire(self, expired):
        self.fired = True
        tags = ", ".join(ent[0] for ent in expired)
        sys.stderr.write(
            f"\n[watchdog] step(s) [{tags}] exceeded the {self.timeout}s "
            f"deadline; the device appears hung; dumping host stacks\n")
        sys.stderr.flush()
        try:
            faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        except Exception:
            pass
        if self._on_timeout is not None:
            self._on_timeout(expired)
        else:
            os._exit(6)


def default_watchdog():
    raise NotImplementedError(f"default_watchdog() {_SLICE_D}")


def arm_step(tag: str, cold: bool = False):
    raise NotImplementedError(f"arm_step() {_SLICE_D}")


def attach_step(eid: int, arrays):
    raise NotImplementedError(f"attach_step() {_SLICE_D}")


def watch_step(arrays, tag: str):
    raise NotImplementedError(f"watch_step() {_SLICE_D}")


# ---------------------------------------------------------------------------
# preemption notice (SIGTERM)
# ---------------------------------------------------------------------------
class PreemptionMonitor:
    """Turn a SIGTERM into a flag the serving loop polls between steps.
    The handler only sets the flag: anything heavier could deadlock on
    state that the interrupted code holds."""

    def __init__(self):
        self._flag = threading.Event()
        self._installed = False
        self._prev = {}

    def install(self, signals=None):
        """Chain the handler in front of any existing Python-level one.
        Must run on the main thread (the signal module's rule); off it,
        nothing is installed and :meth:`request` still sets the flag."""
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
        """Programmatic preemption (tests, a scheduler draining a host)."""
        self._flag.set()

    def requested(self) -> bool:
        return self._flag.is_set()


_preempt: Optional[PreemptionMonitor] = None


def preemption_monitor() -> PreemptionMonitor:
    """The process-wide monitor."""
    global _preempt
    if _preempt is None:
        _preempt = PreemptionMonitor()
    return _preempt
