"""Training steps of the port, and ``InputSpec``."""
from paddle_tpu_torch.jit.train import TrainStep  # noqa: F401

__all__ = ["TrainStep", "InputSpec"]


class InputSpec:
    """Shape/dtype spec (``paddle.static.InputSpec``)."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.name = name

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype})"
