"""Autograd public API (port of ``paddle_tpu/autograd/``) on
``torch.autograd``."""
from paddle_tpu_torch.autograd.engine import (  # noqa: F401
    backward, enable_grad, is_grad_enabled, no_grad,
    register_post_backward_callback, set_grad_enabled,
)
from paddle_tpu_torch.autograd.functional import (  # noqa: F401
    Hessian, Jacobian, grad, hessian, jacobian, jvp, vjp,
)
from paddle_tpu_torch.autograd.py_layer import (  # noqa: F401
    PyLayer, PyLayerContext, once_differentiable,
)


class saved_tensors_hooks:
    """Pack and unpack the tensors autograd saves for backward (CPU
    offload and the like): ``pack_hook(Tensor) -> object`` when a tensor
    is saved, ``unpack_hook(object) -> Tensor`` when backward needs it.
    torch's ``saved_tensors_hooks`` does the interception; the JAX package
    cannot intercept XLA's residuals and raises instead."""

    def __init__(self, pack_hook, unpack_hook):
        import torch

        from paddle_tpu_torch.core.tensor import Tensor

        def pack(t):
            return pack_hook(Tensor._from_data(t))

        def unpack(obj):
            out = unpack_hook(obj)
            return out._data if isinstance(out, Tensor) else out

        self._ctx = torch.autograd.graph.saved_tensors_hooks(pack, unpack)

    def __enter__(self):
        self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        return self._ctx.__exit__(*exc)


__all__ = ["backward", "no_grad", "enable_grad", "is_grad_enabled",
           "set_grad_enabled", "register_post_backward_callback", "grad",
           "vjp", "jvp", "jacobian", "hessian", "Jacobian", "Hessian",
           "PyLayer", "PyLayerContext", "once_differentiable",
           "saved_tensors_hooks"]
