"""Framework-level utilities (port of ``paddle_tpu/framework/``):
``ParamAttr`` and ``paddle.save`` / ``paddle.load``."""
from paddle_tpu_torch.framework.io_utils import load, save  # noqa: F401
from paddle_tpu_torch.framework.param_attr import ParamAttr  # noqa: F401
