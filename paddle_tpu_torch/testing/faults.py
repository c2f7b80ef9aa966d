"""Fault-injection harness (copied from the JAX package's
``testing/faults.py``: the serving points, the checkpoint commit
protocol's points and ``tear_file``).

Production code calls :func:`fire` at named fault points. With no
faults installed the call is a dict lookup on an empty dict, so the
hooks stay in production code permanently.

Faults are installed programmatically (:func:`install`, or the
:func:`injected` context manager) or through the ``PADDLE_FAULTS``
environment variable. Spec grammar (specs separated by ``;``)::

    point:action[:arg][@skip][*times]

    serving.step:raise*1               raise OSError at the first step
    serving.step:sleep:0.5@2           sleep at the third step
    serving.nan_logits:flag:r1*1       poison request r1's logits once

``@skip`` ignores the first N hits; ``*times`` fires at most N times.
Actions: ``crash`` (``os._exit(FAULT_EXIT)``), ``raise`` (``OSError``),
``sleep:<seconds>``, ``touch:<path>``, ``sigterm``, and ``flag`` (no
side effect of its own: the production code QUERIES it via
:func:`check` and corrupts its own data deterministically, as the
serving engine's NaN-logits and forced-OOM points do).
"""
from __future__ import annotations

import os
import re
import signal
import time
from typing import Dict, List, Optional

__all__ = [
    "FAULT_EXIT", "FAULT_POINTS", "Fault", "FaultInjector", "fire",
    "check", "install", "clear", "injected", "active_injector",
    "tear_file", "SERVING_FORCE_OOM", "SERVING_STEP", "SERVING_NAN_LOGITS",
    "CKPT_BEFORE_COMMIT", "CKPT_BEFORE_MARKER", "CKPT_COMMITTED",
    "CKPT_DATA_WRITTEN",
]

# -- the fault-point registry ----------------------------------------------
# Every production fault point of the port, as a named constant. Keyed
# points compose as f-strings LED by the constant:
# ``f"{faults.SERVING_FORCE_OOM}.{request_id}"``.
SERVING_FORCE_OOM = "serving.force_oom"        # keyed: .<request_id>
SERVING_STEP = "serving.step"
SERVING_NAN_LOGITS = "serving.nan_logits"

# checkpoint commit protocol
CKPT_BEFORE_COMMIT = "ckpt.before_commit"
CKPT_BEFORE_MARKER = "ckpt.before_marker"
CKPT_COMMITTED = "ckpt.committed"
CKPT_DATA_WRITTEN = "ckpt.data_written"

FAULT_POINTS = frozenset({SERVING_FORCE_OOM, SERVING_STEP,
                          SERVING_NAN_LOGITS, CKPT_BEFORE_COMMIT,
                          CKPT_BEFORE_MARKER, CKPT_COMMITTED,
                          CKPT_DATA_WRITTEN})

# exit code for the "crash" action: distinct from every code the runtime
# uses (watchdog 6, gang-abort 7, launch re-form 75) so tests can assert
# the process died AT the injected point and not from collateral damage
FAULT_EXIT = 41

ENV_VAR = "PADDLE_FAULTS"

_SPEC_RE = re.compile(
    r"^(?P<point>[^:@*]+):(?P<action>[^:@*]+)"
    r"(?::(?P<arg>[^@*]*))?(?:@(?P<skip>\d+))?(?:\*(?P<times>\d+))?$")


class Fault:
    """One installed fault: where to fire, what to do, and how often."""

    def __init__(self, point: str, action: str, arg: Optional[str] = None,
                 skip: int = 0, times: Optional[int] = None):
        self.point = point
        self.action = action
        self.arg = arg
        self.skip = int(skip)
        self.times = times  # None = unlimited
        self.hits = 0       # calls that reached the point
        self.fired = 0      # calls that actually performed the action

    @staticmethod
    def parse(spec: str) -> "Fault":
        m = _SPEC_RE.match(spec.strip())
        if m is None:
            raise ValueError(f"bad fault spec {spec!r} "
                             f"(want point:action[:arg][@skip][*times])")
        return Fault(m["point"], m["action"], m["arg"],
                     int(m["skip"] or 0),
                     None if m["times"] is None else int(m["times"]))

    def _perform(self):
        if self.action == "crash":
            # hard death: no cleanup, buffered IO lost — what SIGKILL or
            # a power cut does to a half-written checkpoint
            os._exit(FAULT_EXIT)
        if self.action == "raise":
            raise OSError(f"injected fault at {self.point!r}")
        if self.action == "sleep":
            time.sleep(float(self.arg or 1.0))
            return
        if self.action == "touch":
            with open(self.arg, "w") as f:
                f.write(f"{self.point}\n")
            return
        if self.action == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
            return
        if self.action == "flag":
            return  # queried via check(); no side effect of its own
        raise ValueError(f"unknown fault action {self.action!r}")

    def fire(self) -> bool:
        """Returns True iff the action was actually performed this hit
        (past ``@skip``, within ``*times``)."""
        self.hits += 1
        if self.hits <= self.skip:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        self.fired += 1
        self._perform()
        return True


class FaultInjector:
    def __init__(self, spec: str = ""):
        self._by_point: Dict[str, List[Fault]] = {}
        for part in (spec or "").split(";"):
            if part.strip():
                self.add(Fault.parse(part))

    def add(self, fault: Fault) -> Fault:
        self._by_point.setdefault(fault.point, []).append(fault)
        return fault

    def faults(self, point: Optional[str] = None) -> List[Fault]:
        if point is not None:
            return list(self._by_point.get(point, []))
        return [f for fs in self._by_point.values() for f in fs]

    def fire(self, point: str):
        for f in self._by_point.get(point, ()):
            f.fire()

    def check(self, point: str,
              key: Optional[str] = None) -> List[Optional[str]]:
        """Fire the point and return the ``arg`` of every ``flag`` fault
        that performed this hit (empty when none did). Non-flag faults
        installed at the same point fire their actions as usual.

        ``key`` scopes targeted flags in multi-consumer points: a flag
        fault whose ``arg`` names a specific target only HITS (and so
        only burns ``@skip``/``*times`` budget) when ``key`` matches it
        — an argless flag matches every key. Without this, N routers
        polling the same point would race to consume a ``*1`` fault
        aimed at just one of them."""
        out: List[Optional[str]] = []
        for f in self._by_point.get(point, ()):
            if (key is not None and f.action == "flag"
                    and f.arg not in (None, "", key)):
                continue  # targeted at someone else: not a hit
            if f.fire() and f.action == "flag":
                out.append(f.arg)
        return out


_active = FaultInjector(os.environ.get(ENV_VAR, ""))


def active_injector() -> FaultInjector:
    return _active


def fire(point: str):
    """Production-side hook: perform any fault installed at ``point``."""
    if _active._by_point:
        _active.fire(point)


def check(point: str, key: Optional[str] = None) -> List[Optional[str]]:
    """Production-side hook for data-corruption faults: fire ``point``
    and return the args of the ``flag`` faults that performed, so the
    caller can deterministically poison its own state (e.g. the serving
    engine's NaN-logits row, BlockManager's forced OOM). ``key`` scopes
    targeted flags to one consumer (see :meth:`FaultInjector.check`).
    Free when no faults are installed."""
    if not _active._by_point:
        return []
    return _active.check(point, key)


def install(spec: str) -> FaultInjector:
    """Replace the active injector with one parsed from ``spec``;
    returns it (so tests can read per-fault hit counters)."""
    global _active
    _active = FaultInjector(spec)
    return _active


def clear():
    global _active
    _active = FaultInjector("")


class injected:
    """Context manager: install ``spec`` for the block, restore after.

    >>> with faults.injected("ckpt.data_written:raise"):
    ...     save_state_dict(state, path)   # dies mid-write
    """

    def __init__(self, spec: str):
        self.spec = spec
        self.injector: Optional[FaultInjector] = None

    def __enter__(self) -> FaultInjector:
        global _active
        self._prev = _active
        self.injector = _active = FaultInjector(self.spec)
        return self.injector

    def __exit__(self, *exc):
        global _active
        _active = self._prev
        return False


# -- test-side helpers (no production callers) ----------------------------
def tear_file(path: str, frac: float = 0.5):
    """Truncate ``path`` to ``frac`` of its size: a torn write, the
    on-disk state a crash mid-``write()`` leaves behind."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(0, int(size * frac)))
