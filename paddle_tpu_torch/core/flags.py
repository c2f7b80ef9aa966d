"""Global flag registry (copied from ``paddle_tpu/core/flags.py``, which
is pure Python).

The analog of the reference's gflags-free flag system
(``PHI_DEFINE_EXPORTED_*`` in paddle/common/flags.cc:78 and
paddle/phi/core/flags.cc), surfaced in Python as
``paddle.set_flags``/``paddle.get_flags``. Flags are definable at import
time, overridable from the environment (``PTPU_FLAGS_<name>``), and settable
at runtime.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict

__all__ = ["define_flag", "set_flags", "get_flags", "flag"]

_lock = threading.Lock()
_FLAGS: Dict[str, "_Flag"] = {}


class _Flag:
    __slots__ = ("name", "value", "default", "type", "help")

    def __init__(self, name, default, help_str):
        self.name = name
        self.default = default
        self.type = type(default)
        self.help = help_str
        env = os.environ.get(f"PTPU_FLAGS_{name}")
        if env is None:
            env = os.environ.get(f"FLAGS_{name}")
        self.value = self._parse(env) if env is not None else default

    def _parse(self, text: str):
        if self.type is bool:
            return text.lower() in ("1", "true", "yes", "on")
        return self.type(text)


def define_flag(name: str, default, help_str: str = ""):
    """Register a flag; environment overrides the default at definition time."""
    with _lock:
        if name in _FLAGS:
            return _FLAGS[name].value
        f = _Flag(name, default, help_str)
        _FLAGS[name] = f
        return f.value


def _norm(name: str) -> str:
    """Accept both bare names and the reference's FLAGS_ prefix
    (paddle.set_flags({"FLAGS_check_nan_inf": 1}))."""
    return name[6:] if name.startswith("FLAGS_") else name


def set_flags(flags: Dict[str, Any]):
    with _lock:
        for name, value in flags.items():
            name = _norm(name)
            if name not in _FLAGS:
                raise KeyError(f"unknown flag: {name}")
            f = _FLAGS[name]
            f.value = f._parse(value) if isinstance(value, str) else f.type(value)


def get_flags(names=None) -> Dict[str, Any]:
    with _lock:
        if names is None:
            return {k: f.value for k, f in _FLAGS.items()}
        if isinstance(names, str):
            names = [names]
        return {n: _FLAGS[_norm(n)].value for n in names}


def flag(name: str):
    """Fast read of a single flag value."""
    return _FLAGS[name].value


# -- core flags (analogs of FLAGS_* in paddle/phi/core/flags.cc) ------------
define_flag("check_nan_inf", False,
            "check every op output for nan/inf; for compiled steps the check\n            is baked in at TRACE time — set it before the first step runs\n            (like the reference's static-graph programs, the cached executable\n            keeps whatever the flag said when it was built)")
define_flag("eager_vjp", True, "record vjp tape in eager mode")
define_flag("use_bfloat16_default", False, "default float dtype is bfloat16")
define_flag("allocator_strategy", "xla",
            "memory allocator strategy (kept for get_flags parity; the "
            "port uses torch's caching allocator)")
define_flag("log_level", 0, "verbose log level (VLOG analog)")
