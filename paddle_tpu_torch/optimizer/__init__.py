"""Optimizers and LR schedulers of the port."""
from paddle_tpu_torch.optimizer import lr  # noqa: F401
from paddle_tpu_torch.optimizer.optimizer import (  # noqa: F401
    ASGD, LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,
    Momentum, NAdam, Optimizer, RAdam, RMSProp, Rprop,
)

__all__ = ["Optimizer", "SGD", "Momentum", "Adagrad", "Adadelta", "RMSProp",
           "Adam", "AdamW", "Adamax", "Lamb", "NAdam", "RAdam", "ASGD",
           "Rprop", "LBFGS", "lr"]
