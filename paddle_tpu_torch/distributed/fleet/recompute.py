"""Activation recomputation (port of
``paddle_tpu/distributed/fleet/recompute.py``).

Reference: python/paddle/distributed/fleet/recompute/recompute.py
(RecomputeFunction:109, recompute:403, recompute_sequential:567): run a
function without keeping its activations and run it again in the
backward, under the RNG state of the first run.

The JAX package uses ``jax.checkpoint`` (keys are values, so a replay
draws the same masks; the eager tape wraps the replay in ``wrap_replay``).
Here :func:`recompute` is PyTorch's non-reentrant activation
checkpointing (``torch.utils.checkpoint``, ``use_reentrant=False``
whatever the caller asks: the reentrant form drops the gradients of
parameters that no input leads to). ``torch.utils.checkpoint`` restores
torch's RNG, not the port's threefry generator, so a context pair
replays the port's state too: the first run records the default
generator's and the active stream's states, the device key stream's
key (:func:`~paddle_tpu_torch.core.generator.device_key_stream`, the one a
``TrainStep`` forward draws from) and the batch view, and the recompute runs under them and
restores the caller's afterwards. A dropout inside the recomputed region
thus draws in the backward the mask its forward drew. The recompute runs
the whole function (no early stop), so that the module hooks and the
collectives inside it run as in the forward.
"""
from __future__ import annotations

import contextlib
from typing import Callable

from paddle_tpu_torch.core import generator as gen

__all__ = ["recompute", "recompute_sequential"]


def _snapshot():
    stream = gen._key_stream
    active = gen._active_generator
    return (gen.default_generator.get_state(), active, active.get_state(),
            None if stream is None else stream._key, gen._batch_view)


def _restore(snap):
    state, active, active_state, key, view = snap
    gen.default_generator.set_state(state)
    gen._active_generator = active
    active.set_state(active_state)
    gen._key_stream = None if key is None else gen._DeviceKeyStream(key)
    gen._batch_view = view


def _replaying_contexts():
    """(forward context, recompute context): the second runs under the
    port RNG state the first saw."""
    saved = {}

    @contextlib.contextmanager
    def forward():
        saved["snap"] = _snapshot()
        yield

    @contextlib.contextmanager
    def replay():
        mine = _snapshot()
        _restore(saved["snap"])
        try:
            yield
        finally:
            _restore(mine)

    return forward(), replay()


def recompute(function: Callable, *args, use_reentrant=True,
              preserve_rng_state=True, **kwargs):
    """``function(*args, **kwargs)`` without keeping its activations;
    the backward runs it again. Its parameters' gradients flow as
    usual."""
    from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

    # the recompute runs the whole function: its module hooks (a ZeRO-3
    # gather and its release) and its collectives pair up on every rank
    with set_checkpoint_early_stop(False):
        return checkpoint(function, *args, use_reentrant=False,
                          preserve_rng_state=preserve_rng_state,
                          context_fn=_replaying_contexts, **kwargs)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Recompute a sequence of layers in ``ctx["segments"]`` segments
    (reference :567), each one :func:`recompute`."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    layers = list(functions)
    n = len(layers)
    seg = max(n // max(segments, 1), 1)
    out = args[0] if len(args) == 1 else args
    i = 0
    while i < n:
        chunk = layers[i:i + seg]

        def run_chunk(x, _chunk=chunk):
            for layer in _chunk:
                x = layer(x)
            return x

        out = recompute(run_chunk, out, **kwargs)
        i += seg
    return out
