"""nn.utils (port of ``paddle_tpu/nn/utils.py``): gradient clipping in
place, parameters to and from one vector, weight and spectral norm as
forward pre-hooks."""
from __future__ import annotations

from paddle_tpu_torch.core.tensor import Tensor

__all__ = ["clip_grad_norm_", "clip_grad_value_", "parameters_to_vector",
           "vector_to_parameters", "weight_norm", "remove_weight_norm",
           "spectral_norm"]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    from paddle_tpu_torch import ops

    if isinstance(parameters, Tensor):
        parameters = [parameters]
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return None
    if norm_type == float("inf"):
        total = ops.max(ops.stack([ops.max(ops.abs(g)) for g in grads]))
    else:
        total = ops.pow(
            sum(ops.sum(ops.pow(ops.abs(g), norm_type)) for g in grads),
            1.0 / norm_type)
    clip_coef = max_norm / (total + 1e-6)
    coef = ops.clip(clip_coef, max=1.0)
    for p in parameters:
        if p.grad is not None:
            p.grad = (p.grad * coef)._data
    return total


def clip_grad_value_(parameters, clip_value):
    from paddle_tpu_torch import ops

    if isinstance(parameters, Tensor):
        parameters = [parameters]
    for p in parameters:
        if p.grad is not None:
            p.grad = ops.clip(p.grad, -clip_value, clip_value)._data


def parameters_to_vector(parameters, name=None):
    from paddle_tpu_torch import ops
    return ops.concat([ops.reshape(p, [-1]) for p in parameters], axis=0)


def vector_to_parameters(vec, parameters, name=None):
    offset = 0
    for p in parameters:
        n = p.size
        chunk = vec[offset:offset + n]
        p.set_value(chunk.reshape(p.shape) if hasattr(chunk, "reshape")
                    else chunk)
        offset += n


def weight_norm(layer, name="weight", dim=0):
    """Reparameterize weight = g * v / ||v|| via a forward-pre-hook."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.nn.layer import Parameter

    w = getattr(layer, name)
    axes = [i for i in range(w.ndim) if i != dim] if dim is not None else None
    norm = ops.norm(w, p=2, axis=axes, keepdim=True) if axes else \
        ops.norm(w, p=2)
    g = Parameter(norm._data)
    v = Parameter(w._data)
    layer.add_parameter(name + "_g", g)
    layer.add_parameter(name + "_v", v)
    del layer._parameters[name]

    def hook(lyr, inputs):
        vv = lyr._parameters[name + "_v"]
        gg = lyr._parameters[name + "_g"]
        nrm = ops.norm(vv, p=2, axis=axes, keepdim=True) if axes else \
            ops.norm(vv, p=2)
        object.__setattr__(lyr, "_wn_cache", vv * (gg / nrm))
        # expose as plain attribute for forward
        lyr.__dict__[name] = lyr._wn_cache
        return None

    layer._weight_norm_hook = layer.register_forward_pre_hook(hook)
    hook(layer, None)
    return layer


def remove_weight_norm(layer, name="weight"):
    from paddle_tpu_torch.nn.layer import Parameter

    if hasattr(layer, "_weight_norm_hook"):
        layer._weight_norm_hook.remove()
        w = layer.__dict__.pop(name, None)
        if w is not None:
            layer.add_parameter(name, Parameter(w._data))
        del layer._parameters[name + "_g"]
        del layer._parameters[name + "_v"]
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    from paddle_tpu_torch.nn.norm import SpectralNorm

    w = getattr(layer, name)
    sn = SpectralNorm(w.shape, dim=dim or 0, power_iters=n_power_iterations,
                      epsilon=eps)
    layer.add_sublayer(name + "_sn", sn)

    def hook(lyr, inputs):
        lyr.__dict__[name] = sn(lyr._parameters[name])
        return None

    layer.register_forward_pre_hook(hook)
    return layer
