"""Training steps of the port."""
from paddle_tpu_torch.jit.train import TrainStep  # noqa: F401

__all__ = ["TrainStep"]
