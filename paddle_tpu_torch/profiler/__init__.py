"""Observability counters (pull model), copied from the JAX package's
``profiler`` module: providers are only invoked when :func:`counters`
is called, never per step."""
from __future__ import annotations

import threading
from typing import Callable, Dict

__all__ = ["register_counter_provider", "unregister_counter_provider",
           "counters"]

_counter_providers: Dict[str, Callable] = {}
# registrations arrive from arbitrary threads (weakref.finalize callbacks
# fire on whichever thread drops the last reference); the lock covers the
# dict, not the providers — counters() calls those outside it
_prov_lock = threading.Lock()


def register_counter_provider(name: str, fn: Callable) -> None:
    """Register a zero-arg callable whose value appears in
    :func:`counters` under ``name``. A provider returning None (dead
    weakref) is dropped."""
    with _prov_lock:
        _counter_providers[name] = fn


def unregister_counter_provider(name: str) -> None:
    with _prov_lock:
        _counter_providers.pop(name, None)


def counters() -> Dict[str, float]:
    """Current values of every registered observability counter."""
    with _prov_lock:
        providers = list(_counter_providers.items())
    out = {}
    dead = []
    for name, fn in providers:
        try:
            v = fn()
        except Exception:
            continue
        if v is None:  # provider's subject was garbage-collected
            dead.append(name)
            continue
        out[name] = v
    if dead:
        with _prov_lock:
            for name in dead:
                _counter_providers.pop(name, None)
    return out
