"""Random number generation (port of ``paddle_tpu/core/generator.py``).

A ``Generator`` holds a seed and a counter; every draw takes the key
``fold_in(key(seed), counter)`` and advances the counter by one, so the
state is the pair ``(seed, counter)``, as in the JAX package. The keys are
threefry words computed on the host as Python ints
(:func:`paddle_tpu_torch.ops.threefry.key` / :func:`~paddle_tpu_torch.ops.
threefry.fold_in`, bit-identical to ``jax.random``), so a draw moves no
key to the card and the same state gives the same keys in both packages.
"""
from __future__ import annotations

import contextlib
import threading

from paddle_tpu_torch.ops import threefry

__all__ = [
    "Generator", "default_generator", "seed", "get_rng_state",
    "set_rng_state", "RNGStatesTracker", "get_rng_tracker", "rng_state",
    "active_key", "wrap_replay", "device_key_stream",
]


class Generator:
    """Stateful facade over counter-based threefry keys."""

    def __init__(self, seed_: int = 0):
        self._seed = int(seed_)
        self._root = None
        self._counter = 0
        self._lock = threading.Lock()

    def _root_key(self):
        if self._root is None:
            self._root = threefry.key(self._seed)
        return self._root

    def manual_seed(self, seed_: int) -> "Generator":
        with self._lock:
            self._seed = int(seed_)
            self._root = None
            self._counter = 0
        return self

    def initial_seed(self) -> int:
        return self._seed

    def next_key(self):
        """The next key, a pair of Python ints (threadsafe, replayable
        through the state); under :func:`device_key_stream` the stream's
        next ``(2,)`` key tensor, the counter left as it is."""
        stream = _key_stream
        if stream is not None:
            return stream.next()
        with self._lock:
            c = self._counter
            self._counter += 1
        return threefry.fold_in(self._root_key(), c)

    def get_state(self):
        return (self._seed, self._counter)

    def set_state(self, state):
        with self._lock:
            self._seed, self._counter = int(state[0]), int(state[1])
            self._root = None


default_generator = Generator(0)


class _DeviceKeyStream:
    """Splits a ``(2,)`` key tensor once per draw (``key, sub =
    split(key)``, the draw takes ``sub``), as the JAX package's
    ``_TraceKeyStream`` splits its tracer key."""

    def __init__(self, root):
        self._key = root

    def next(self):
        pair = threefry.split(self._key)
        self._key = pair[0]
        return pair[1]


_key_stream = None


@contextlib.contextmanager
def device_key_stream(root):
    """Draws inside the context take successive splits of the ``(2,)``
    key tensor ``root`` (on the device the draws land on) instead of the
    generators' Python-int keys; no generator's state moves."""
    global _key_stream
    prev = _key_stream
    _key_stream = _DeviceKeyStream(root)
    try:
        yield _key_stream
    finally:
        _key_stream = prev


def seed(s: int) -> Generator:
    """The global manual seed (``paddle.seed``). Also seeds numpy's global
    RNG, as the JAX package does, so host-side randomness (samplers,
    transforms) follows the same call."""
    import numpy as _np

    default_generator.manual_seed(s)
    get_rng_tracker().reset(s)
    _np.random.seed(s % (2 ** 32))
    return default_generator


def get_rng_state():
    return default_generator.get_state()


def set_rng_state(state):
    default_generator.set_state(state)


class RNGStatesTracker:
    """Named RNG streams, each its own :class:`Generator` (a stream asked
    for by name before it was added is seeded from the base seed and a
    stable hash of the name)."""

    def __init__(self):
        self._streams: dict[str, Generator] = {}
        self._base_seed = 0

    def reset(self, base_seed: int = 0):
        self._streams.clear()
        self._base_seed = base_seed

    def add(self, name: str, seed_: int):
        if name in self._streams:
            raise ValueError(f"rng stream {name!r} already exists")
        self._streams[name] = Generator(seed_)

    def get(self, name: str) -> Generator:
        if name not in self._streams:
            self._streams[name] = Generator(self._base_seed +
                                            _stable_hash(name))
        return self._streams[name]

    def states(self):
        return {k: g.get_state() for k, g in self._streams.items()}

    def set_states(self, states):
        for k, st in states.items():
            self.get(k).set_state(st)

    @contextlib.contextmanager
    def rng_state(self, name: str = "global"):
        """Draws inside the context come from the named stream."""
        global _active_generator
        prev = _active_generator
        _active_generator = self.get(name)
        try:
            yield
        finally:
            _active_generator = prev


def _stable_hash(name: str) -> int:
    h = 0
    for ch in name:
        h = (h * 131 + ord(ch)) % (2 ** 31)
    return h


_tracker = RNGStatesTracker()
_active_generator = default_generator


def get_rng_tracker() -> RNGStatesTracker:
    return _tracker


def rng_state(name: str = "global"):
    return _tracker.rng_state(name)


def active_key():
    """The next key of the active stream (the :func:`rng_state` context's,
    else the default generator's)."""
    return _active_generator.next_key()


def wrap_replay(fn, generator, state):
    """``fn`` wrapped so that every call draws from ``generator`` as from
    ``state``, restoring the caller's state afterwards."""

    def replay(*args, **kwargs):
        save = generator.get_state()
        generator.set_state(state)
        try:
            return fn(*args, **kwargs)
        finally:
            generator.set_state(save)

    return replay
