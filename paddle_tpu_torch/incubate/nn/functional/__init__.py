"""Fused-op functions (port of ``paddle_tpu/incubate/nn/functional/``).

``swiglu`` and ``fused_rms_norm`` are registry ops, registered at import
outside the op manifest, as the JAX package registers them;
``fused_rotary_position_embedding`` runs the Llama's ``rope_apply``. The
serving-path attention functions live in ``block_attention.py``, the
rest of the fused surface in ``fused_ops.py``.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.ops import registry as _registry
from paddle_tpu_torch.ops.registry import register_emitter as _register

from paddle_tpu_torch.incubate.nn.functional.block_attention import (  # noqa: F401
    block_multihead_attention, paged_attention, ragged_paged_attention,
    variable_length_memory_efficient_attention,
)

__all__ = ["fused_rotary_position_embedding", "fused_rms_norm", "swiglu",
           "variable_length_memory_efficient_attention",
           "paged_attention", "block_multihead_attention",
           "ragged_paged_attention"]


@_register(name="swiglu")
def _swiglu_emitter(x, y=None):
    """silu(x) * y; with y=None, x is split in half on the last axis."""
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return torch.nn.functional.silu(x) * y


@_register(name="fused_rms_norm")
def _fused_rms_norm_emitter(x, norm_weight, norm_bias=None, epsilon=1e-6,
                            begin_norm_axis=-1):
    """RMSNorm over the last axis in f32, cast back, then the weight and
    the bias (``begin_norm_axis`` is taken and not read, as in the JAX
    emitter)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + epsilon)).to(x.dtype) * norm_weight
    if norm_bias is not None:
        out = out + norm_bias
    return out


if "swiglu" not in _registry.OPS:
    _registry.build_registry([
        {"op": "swiglu", "tensor_args": ["x", "y"], "methods": []},
        {"op": "fused_rms_norm",
         "tensor_args": ["x", "norm_weight", "norm_bias"], "methods": []},
    ])


def swiglu(x, y=None):
    return _registry.API["swiglu"](x, y)


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1):
    return _registry.API["fused_rms_norm"](x, norm_weight, norm_bias,
                                           epsilon=epsilon,
                                           begin_norm_axis=begin_norm_axis)


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True):
    """Rotary embedding on [B, S, H, D] tensors, the halves rotated (the
    neox style) by the Llama's ``rope_apply``; ``v`` passes through as it
    is. ``cos``/``sin`` are [S, D] or [1, S, 1, D] tables.

    ``use_neox_rotary_style=False`` (PaddlePaddle's interleaved pairs)
    raises: the JAX package never reads the flag and rotates the halves
    whatever it says."""
    from paddle_tpu_torch.models.llama import rope_apply

    if not use_neox_rotary_style:
        raise NotImplementedError(
            "fused_rotary_position_embedding(use_neox_rotary_style=False) "
            "rotates interleaved pairs, which is not implemented; the "
            "rotation here is the neox style (the halves)")
    if cos is None or sin is None:
        raise ValueError("cos/sin tables are required")

    def data(t):
        return t._data if isinstance(t, Tensor) else torch.as_tensor(t)

    def table(t):
        d = data(t)
        return d.reshape(d.shape[-3], d.shape[-1]) if d.dim() == 4 else d

    c, s = table(cos), table(sin)
    if k is None:
        q2, _ = rope_apply(data(q), data(q), c, s)
        return Tensor._from_data(q2), None, None
    q2, k2 = rope_apply(data(q), data(k), c, s)
    return Tensor._from_data(q2), Tensor._from_data(k2), v


from paddle_tpu_torch.incubate.nn.functional.fused_ops import (  # noqa: E402,F401
    fused_bias_dropout_residual_layer_norm, fused_dot_product_attention,
    fused_dropout_add, fused_ec_moe, fused_feedforward, fused_gate_attention,
    fused_layer_norm, fused_linear, fused_linear_activation,
    fused_matmul_bias, fused_multi_head_attention, fused_multi_transformer,
    masked_multihead_attention,
)
