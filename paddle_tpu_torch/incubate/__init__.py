"""Incubating operators (serving-path attention) and the mixture of
experts (``incubate.moe``)."""
from paddle_tpu_torch.incubate import moe  # noqa: F401
