"""hapi, the Keras-like high-level API (port of ``paddle_tpu/hapi/``):
``Model`` with its callbacks, ``summary`` and ``flops``."""
from paddle_tpu_torch.hapi.callbacks import (  # noqa: F401
    Callback, EarlyStopping, LRScheduler, ModelCheckpoint, ProgBarLogger,
)
from paddle_tpu_torch.hapi.model import Model  # noqa: F401
from paddle_tpu_torch.hapi.model_summary import flops, summary  # noqa: F401

__all__ = ["Model", "summary", "flops", "Callback", "ProgBarLogger",
           "ModelCheckpoint", "LRScheduler", "EarlyStopping"]
