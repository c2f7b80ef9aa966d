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

The hook also holds for the training ranks of
:mod:`paddle_tpu_torch.distributed`: while it is active,
``init_parallel_env`` puts every rank on the first card and picks gloo.
A process spawned inside the hook inherits it through the environment
variable :data:`ENV`, so ranks started by a driving script inside
``with ranks_share_one_device():`` all share the card.
"""
from __future__ import annotations

import contextlib
import os

__all__ = ["ranks_share_one_device", "shared_device", "ENV"]

# set to "1" while the hook is active: spawned processes inherit it
ENV = "PADDLE_TORCH_RANKS_SHARE_DEVICE"

_state = {"shared": False}


@contextlib.contextmanager
def ranks_share_one_device():
    """Place every rank of a TP engine, or of a training world, built
    inside on the model's device (the first card)."""
    prev, prev_env = _state["shared"], os.environ.get(ENV)
    _state["shared"] = True
    os.environ[ENV] = "1"
    try:
        yield
    finally:
        _state["shared"] = prev
        if prev_env is None:
            os.environ.pop(ENV, None)
        else:
            os.environ[ENV] = prev_env


def shared_device() -> bool:
    return _state["shared"] or os.environ.get(ENV) == "1"

