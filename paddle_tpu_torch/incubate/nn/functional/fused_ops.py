"""The fused-op functions (port of
``paddle_tpu/incubate/nn/functional/fused_ops.py``).

Each function is the composition the JAX package writes over its
registry ops (the fused CUDA kernels' documented pseudo-code): PyTorch's
eager ops here, with the JAX package's dtypes and order. None launches a
kernel of its own; the attention goes through the registry's plain
``scaled_dot_product_attention``. Two serving mega-kernels,
``fused_multi_transformer`` and ``fused_gate_attention``, raise with a
pointer to the port's own paths.
"""
from __future__ import annotations

import math

import torch

from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.ops import registry as _registry

__all__ = [
    "fused_layer_norm", "fused_dropout_add", "fused_matmul_bias",
    "fused_linear", "fused_linear_activation",
    "fused_dot_product_attention", "fused_ec_moe",
    "masked_multihead_attention", "fused_bias_dropout_residual_layer_norm",
    "fused_feedforward", "fused_multi_head_attention",
    "fused_multi_transformer", "fused_gate_attention",
]


def _d(t):
    return t._data if isinstance(t, Tensor) else torch.as_tensor(t)


def _F():
    from paddle_tpu_torch.nn import functional as F

    return F


def _act(name):
    F = _F()
    acts = {"relu": F.relu, "gelu": F.gelu}
    if name not in acts:
        raise ValueError(
            f"unsupported activation {name!r} (relu|gelu; geglu needs a "
            "split+gate projection — compose it explicitly)")
    return acts[name]


def fused_layer_norm(x, norm_weight, norm_bias, epsilon,
                     residual_alpha=1.0, begin_norm_axis=1, bias=None,
                     residual=None, quant_scale=-1, quant_round_type=0,
                     quant_max_bound=0, quant_min_bound=0):
    """LayerNorm(bias + residual_alpha * residual + x) over the axes from
    ``begin_norm_axis`` on; with neither ``norm_weight`` nor
    ``norm_bias``, the fused add alone."""
    if quant_scale != -1:
        raise NotImplementedError(
            "quantized fused_layer_norm is not implemented: quantize the "
            "model's weights instead")
    y = x
    if bias is not None:
        y = y + bias
    if residual is not None:
        y = y + residual * residual_alpha
    if norm_weight is None and norm_bias is None:
        return y
    shape = list(_d(y).shape)
    axes = range(begin_norm_axis if begin_norm_axis >= 0
                 else len(shape) + begin_norm_axis, len(shape))
    flat = [math.prod(shape[a] for a in axes)]
    lead = shape[:len(shape) - len(axes)]
    return _F().layer_norm(
        y.reshape(lead + flat), normalized_shape=flat,
        weight=norm_weight.reshape(flat) if norm_weight is not None
        else None,
        bias=norm_bias.reshape(flat) if norm_bias is not None else None,
        epsilon=epsilon).reshape(shape)


def fused_dropout_add(x, y, p=0.5, training=True,
                      mode="upscale_in_train", name=None):
    """dropout(x) + y."""
    return _F().dropout(x, p=p, training=training, mode=mode) + y


def fused_matmul_bias(x, y, bias=None, transpose_x=False,
                      transpose_y=False, name=None):
    """matmul with the bias added after it."""
    out = _registry.API["matmul"](x, y, transpose_x=transpose_x,
                                  transpose_y=transpose_y)
    if bias is not None:
        out = out + bias
    return out


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    return fused_matmul_bias(x, weight, bias, transpose_y=transpose_weight)


def fused_linear_activation(x, y, bias=None, trans_x=False, trans_y=False,
                            activation=None):
    """matmul, bias, then ``activation`` (relu, gelu or none)."""
    out = fused_matmul_bias(x, y, bias, transpose_x=trans_x,
                            transpose_y=trans_y)
    if activation in (None, "none"):
        return out
    return _act(activation)(out)


def fused_dot_product_attention(q, k, v, mask=None, scaling_factor=None,
                                dropout_prob=0.0, is_training=True,
                                is_causal_masking=False,
                                use_workspace_opt=None,
                                return_softmax=False):
    """Attention on [B, S, H, D] through the registry's plain
    ``scaled_dot_product_attention``; ``scaling_factor`` replaces its
    1/sqrt(D) (q is pre-scaled)."""
    if return_softmax:
        raise NotImplementedError(
            "return_softmax=True keeps the full [B,H,S,S] matrix alive "
            "— incompatible with flash-style attention; compute softmax "
            "explicitly if you need it")
    if is_causal_masking and mask is not None:
        raise NotImplementedError(
            "combined causal + explicit mask is not supported: fold the "
            "causal structure into the mask and pass "
            "is_causal_masking=False")
    q_ = q
    if scaling_factor is not None:
        q_ = q * (float(scaling_factor) * math.sqrt(_d(q).shape[-1]))
    return _F().scaled_dot_product_attention(
        q_, k, v, attn_mask=mask,
        dropout_p=dropout_prob if is_training else 0.0,
        is_causal=is_causal_masking, training=is_training)


def fused_ec_moe(x, gate, bmm0_weight, bmm0_bias, bmm1_weight, bmm1_bias,
                 act_type):
    """Dense expert-computation MoE: out[b, s] = sum_e softmax(gate)[b, s,
    e] * (act(x @ W0_e + b0_e) @ W1_e + b1_e), every token through every
    expert (gelu is the tanh form, as ``jax.nn.gelu``'s default)."""
    if act_type not in ("gelu", "relu"):
        raise ValueError("act_type must be 'gelu' or 'relu'")
    xd, gd = _d(x), _d(gate)
    w0, b0 = _d(bmm0_weight), _d(bmm0_bias)
    w1, b1 = _d(bmm1_weight), _d(bmm1_bias)
    probs = torch.softmax(gd, dim=-1)                    # [B, S, E]
    h = torch.einsum("bsd,edf->bsef", xd, w0) + b0[:, 0]  # [B, S, E, F]
    h = torch.nn.functional.gelu(h, approximate="tanh") \
        if act_type == "gelu" else torch.clamp_min(h, 0)
    e_, f_, d_ = w0.shape[0], w0.shape[2], xd.shape[-1]
    if tuple(w1.shape) != (e_, f_, d_):
        raise ValueError(
            f"bmm1_weight must be [num_experts, d_ffn, d_model] = "
            f"[{e_}, {f_}, {d_}], got {tuple(w1.shape)} (the reference "
            "docstring's [e, d_model, d_ffn] is inconsistent with the "
            "kernel's contraction; layout sniffing would silently "
            "misinterpret square FFNs)")
    y = torch.einsum("bsef,efd->bsed", h, w1) + b1[:, 0]
    return Tensor._from_data(torch.einsum("bsed,bse->bsd", y, probs))


def masked_multihead_attention(x, cache_kv=None, bias=None, src_mask=None,
                               cum_offsets=None, sequence_lengths=None,
                               rotary_tensor=None, beam_cache_offset=None,
                               qkv_out_scale=None, out_shift=None,
                               out_smooth=None, seq_len=1,
                               rotary_emb_dims=0,
                               use_neox_rotary_style=False,
                               compute_dtype="default", out_scale=-1,
                               quant_round_type=1, quant_max_bound=127.0,
                               quant_min_bound=-127.0):
    """One decode token's attention over a dense KV cache. x: [B, 3*H*D]
    packed qkv; cache_kv: [2, B, H, max_seq, D]; sequence_lengths: [B]
    (default: the cache's full prefix). This step's k/v land at position
    ``sequence_lengths[b]``. Returns ``(out [B, H*D], new cache)``: the
    cache is returned, not written in place, as in the JAX package.
    A length with no free slot raises ``ValueError`` (not checked while a
    CUDA graph is captured)."""
    for unsupported, nm in ((beam_cache_offset, "beam search"),
                            (qkv_out_scale, "quantized qkv"),
                            (out_shift, "out_shift"),
                            (rotary_tensor, "rotary_tensor")):
        if unsupported is not None:
            raise NotImplementedError(
                f"masked_multihead_attention: {nm} is not supported; "
                "use incubate block_multihead_attention for the paged "
                "serving path")
    xd, cache = _d(x), _d(cache_kv)
    _, b, h, s_max, d = cache.shape
    qkv = xd.reshape(b, 3, h, d)
    if bias is not None:
        qkv = qkv + _d(bias).reshape(1, 3, h, d)
    q, k_new, v_new = qkv[:, 0], qkv[:, 1], qkv[:, 2]      # [B, H, D]
    dev = cache.device
    if sequence_lengths is None:
        lens = torch.full((b,), s_max - 1, dtype=torch.int64, device=dev)
    else:
        lens = _d(sequence_lengths).reshape(b).to(torch.int64)
        if not (dev.type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            top = int(lens.max())
            if top >= s_max:
                raise ValueError(
                    f"masked_multihead_attention: sequence length {top} "
                    f"has no free cache slot (max_seq={s_max}); grow the "
                    f"cache")
    onehot = torch.nn.functional.one_hot(
        lens.clamp(0, s_max - 1), s_max).to(cache.dtype)
    onehot = onehot * (lens < s_max)[:, None].to(cache.dtype)
    oh = onehot[:, None, :, None]
    k_cache = cache[0] * (1 - oh) + k_new[:, :, None, :] * oh
    v_cache = cache[1] * (1 - oh) + v_new[:, :, None, :] * oh
    ct = torch.promote_types(cache.dtype, torch.float32)
    scale = 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
    logits = torch.einsum("bhd,bhsd->bhs", q, k_cache).to(ct) \
        * scale.to(dev, ct)
    valid = torch.arange(s_max, device=dev)[None, :] <= lens[:, None]
    neg = torch.tensor(torch.finfo(torch.float32).min, dtype=ct,
                       device=dev)
    logits = torch.where(valid[:, None, :], logits, neg)
    if src_mask is not None:
        logits = logits + _d(src_mask).reshape(b, 1, -1)[:, :, :s_max]
    probs = torch.softmax(logits.float(), dim=-1)
    out = torch.einsum("bhs,bhsd->bhd", probs.to(v_cache.dtype), v_cache)
    return (Tensor._from_data(out.reshape(b, h * d)),
            Tensor._from_data(torch.stack([k_cache, v_cache])))


def fused_bias_dropout_residual_layer_norm(x, residual, bias=None,
                                           ln_scale=None, ln_bias=None,
                                           dropout_rate=0.5,
                                           ln_epsilon=1e-5, training=True,
                                           mode="upscale_in_train",
                                           name=None):
    """layer_norm(residual + dropout(bias + x))."""
    F = _F()
    y = x if bias is None else x + bias
    y = residual + F.dropout(y, p=dropout_rate, training=training,
                             mode=mode)
    return F.layer_norm(y, normalized_shape=[_d(y).shape[-1]],
                        weight=ln_scale, bias=ln_bias, epsilon=ln_epsilon)


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                      pre_layer_norm=False, training=True,
                      mode="upscale_in_train", ring_id=-1,
                      add_residual=True, name=None):
    """residual + dropout2(linear2(dropout1(act(linear1(ln1?(x)))))), then
    ln2 unless pre-norm."""
    F = _F()
    residual = x
    e = _d(x).shape[-1]
    y = x
    if pre_layer_norm:
        y = F.layer_norm(y, normalized_shape=[e], weight=ln1_scale,
                         bias=ln1_bias, epsilon=ln1_epsilon)
    y = _act(activation)(F.linear(y, linear1_weight, linear1_bias))
    y = F.dropout(y, p=dropout1_rate, training=training, mode=mode)
    y = F.linear(y, linear2_weight, linear2_bias)
    y = F.dropout(y, p=dropout2_rate, training=training, mode=mode)
    if add_residual:
        y = y + residual
    if not pre_layer_norm:
        y = F.layer_norm(y, normalized_shape=[e], weight=ln2_scale,
                         bias=ln2_bias, epsilon=ln2_epsilon)
    return y


def fused_multi_head_attention(x, qkv_weight, linear_weight,
                               pre_layer_norm=False, pre_ln_scale=None,
                               pre_ln_bias=None, ln_scale=None,
                               ln_bias=None, pre_ln_epsilon=1e-5,
                               qkv_bias=None, linear_bias=None,
                               cache_kv=None, attn_mask=None,
                               dropout_rate=0.5, attn_dropout_rate=0.5,
                               ln_epsilon=1e-5, training=True,
                               mode="upscale_in_train", ring_id=-1,
                               add_residual=True, num_heads=-1,
                               transpose_qkv_wb=False, name=None):
    """Self-attention block: ln? -> qkv -> attention -> out projection ->
    bias + dropout + residual (+ ln unless pre-norm). qkv_weight:
    [3, H, D, embed], or [embed, 3*embed] with ``transpose_qkv_wb`` and
    ``num_heads``."""
    F = _F()
    if cache_kv is not None:
        raise NotImplementedError(
            "fused_multi_head_attention with cache_kv: use "
            "masked_multihead_attention (dense decode cache) or "
            "block_multihead_attention (paged)")
    residual = x
    b, s, e = _d(x).shape
    y = x
    if pre_layer_norm:
        y = F.layer_norm(y, normalized_shape=[e], weight=pre_ln_scale,
                         bias=pre_ln_bias, epsilon=pre_ln_epsilon)
    wd = _d(qkv_weight)
    if transpose_qkv_wb:
        if num_heads <= 0:
            raise ValueError("num_heads required with transpose_qkv_wb")
        h = num_heads
        hd = e // h
        qkv = torch.einsum("bse,ek->bsk", _d(y), wd)
        if qkv_bias is not None:
            qkv = qkv + _d(qkv_bias)
        qkv = qkv.reshape(b, s, 3, h, hd)
    else:
        _, h, hd, _ = wd.shape
        qkv = torch.einsum("bse,khde->bskhd", _d(y), wd)
        if qkv_bias is not None:
            qkv = qkv + _d(qkv_bias)[None, None]
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]   # [B, S, H, D]
    out = F.scaled_dot_product_attention(
        Tensor._from_data(q), Tensor._from_data(k), Tensor._from_data(v),
        attn_mask=attn_mask,
        dropout_p=attn_dropout_rate if training else 0.0,
        training=training)
    y = Tensor._from_data(torch.matmul(_d(out).reshape(b, s, h * hd),
                                       _d(linear_weight)))
    if pre_layer_norm:
        return _post_pre_ln(y, linear_bias, residual, dropout_rate,
                            training, mode, add_residual)
    return fused_bias_dropout_residual_layer_norm(
        y, residual if add_residual else y * 0.0, bias=linear_bias,
        ln_scale=ln_scale, ln_bias=ln_bias, dropout_rate=dropout_rate,
        ln_epsilon=ln_epsilon, training=training, mode=mode)


def _post_pre_ln(y, linear_bias, residual, dropout_rate, training, mode,
                 add_residual):
    """The pre-norm epilogue: bias + dropout + residual (no final ln)."""
    if linear_bias is not None:
        y = y + linear_bias
    y = _F().dropout(y, p=dropout_rate, training=training, mode=mode)
    if add_residual:
        y = y + residual
    return y


def fused_multi_transformer(*args, **kwargs):
    raise NotImplementedError(
        "fused_multi_transformer is a GPU serving mega-kernel that is not "
        "ported; serve through paddle_tpu_torch.serving (the ragged paged "
        "attention kernel) or incubate block_multihead_attention / "
        "masked_multihead_attention, and train with "
        "paddle_tpu_torch.incubate.nn.FusedTransformerEncoderLayer")


def fused_gate_attention(*args, **kwargs):
    raise NotImplementedError(
        "fused_gate_attention (AlphaFold gating) is not implemented; "
        "compose it from scaled_dot_product_attention + sigmoid gating")
