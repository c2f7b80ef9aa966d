"""Testing hooks of the tensor-parallel serving engine
(:mod:`paddle_tpu_torch.serving.tp`). Not public knobs.

By default ``EngineConfig(tp_degree=k)`` on the card places rank r on
its own card and raises when fewer than k cards are visible, as the JAX
engine raises when fewer devices than ``tp_degree`` are visible. The
JAX package's tests run its TP engine on one host by forcing virtual
CPU devices (``--xla_force_host_platform_device_count``);
:func:`ranks_share_one_device` is this package's counterpart: while it
is active, every rank of an engine built inside it runs on the model's
own device, so a k-rank engine runs on one card (its device group is
then gloo, since NCCL takes one rank per card). Two ranks on one card
share its compute: they check the TP path's numbers and launches, not
its speed::

    with tp_hooks.ranks_share_one_device():
        eng = LLMEngine(model, EngineConfig(tp_degree=2))

On the CPU every rank runs on the CPU whatever the hook says.
"""
from __future__ import annotations

import contextlib

__all__ = ["ranks_share_one_device", "shared_device"]

_state = {"shared": False}


@contextlib.contextmanager
def ranks_share_one_device():
    """Place every rank of a TP engine built inside on the model's
    device."""
    prev = _state["shared"]
    _state["shared"] = True
    try:
        yield
    finally:
        _state["shared"] = prev


def shared_device() -> bool:
    return _state["shared"]

