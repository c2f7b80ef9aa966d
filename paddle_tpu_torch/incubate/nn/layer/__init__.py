"""The fused layers of ``paddle.incubate.nn`` (port of
``paddle_tpu/incubate/nn/layer/__init__.py``).

The classes keep the reference's surface (the pre/post normalization
knob, the fused residual + dropout) over the port's layers and the
functions of ``incubate.nn.functional``; no layer launches a kernel of
its own. ``FusedMultiTransformer`` (a serving mega-kernel stack) raises.
"""
from __future__ import annotations

from paddle_tpu_torch import nn
from paddle_tpu_torch.nn.layer import Layer

__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer", "FusedLinear",
           "FusedDropoutAdd", "FusedDropout", "FusedEcMoe",
           "FusedBiasDropoutResidualLayerNorm", "FusedMultiTransformer"]


def _functional():
    from paddle_tpu_torch.incubate.nn import functional as IF

    return IF


class FusedMultiHeadAttention(Layer):
    """Self-attention with the residual, dropout and layer norm (pre or
    post) around it."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-05,
                 nranks=1, ring_id=-1, name=None):
        super().__init__()
        self.normalize_before = normalize_before
        self.attn = nn.MultiHeadAttention(
            embed_dim, num_heads, dropout=attn_dropout_rate,
            kdim=kdim, vdim=vdim, need_weights=need_weights)
        self.dropout = nn.Dropout(dropout_rate)
        self.norm = nn.LayerNorm(embed_dim, epsilon=epsilon)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        if (key is not None and key is not query) or \
                (value is not None and value is not query
                 and value is not key):
            raise NotImplementedError(
                "FusedMultiHeadAttention supports self-attention only "
                "(matching the reference fused layer); use "
                "nn.MultiHeadAttention for cross-attention")
        residual = query
        if self.normalize_before:
            query = self.norm(query)
        out = self.attn(query, query, query, attn_mask=attn_mask,
                        cache=cache)
        if cache is not None:
            out, new_cache = out
        out = residual + self.dropout(out)
        if not self.normalize_before:
            out = self.norm(out)
        if cache is not None:
            return out, new_cache
        return out


class FusedFeedForward(Layer):
    """linear -> activation -> dropout -> linear, with the residual and
    layer norm (pre or post) around it."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-05, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None,
                 ln2_bias_attr=None, nranks=1, ring_id=-1, name=None):
        super().__init__()
        self.normalize_before = normalize_before
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.dropout1 = nn.Dropout(act_dropout_rate
                                   if act_dropout_rate is not None
                                   else dropout_rate)
        self.dropout2 = nn.Dropout(dropout_rate)
        self.norm = nn.LayerNorm(d_model, epsilon=epsilon)
        self._act = getattr(nn.functional, activation)

    def forward(self, src, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm(src)
        out = self.linear2(self.dropout1(self._act(self.linear1(src))))
        out = residual + self.dropout2(out)
        if not self.normalize_before:
            out = self.norm(out)
        return out


class FusedTransformerEncoderLayer(Layer):
    """``FusedMultiHeadAttention`` then ``FusedFeedForward``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False):
        super().__init__()
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=attn_dropout_rate
            if attn_dropout_rate is not None else dropout_rate,
            normalize_before=normalize_before)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before)

    def forward(self, src, src_mask=None, cache=None):
        if cache is not None:
            out, new_cache = self.fused_attn(src, attn_mask=src_mask,
                                             cache=cache)
            return self.ffn(out), new_cache
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))


class FusedLinear(Layer):
    """A Linear through ``fused_linear`` (weight [in, out], or [out, in]
    with ``transpose_weight``); the attrs as ``nn.Linear`` takes them,
    ``bias_attr=False`` for no bias."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, transpose_weight=False, name=None):
        super().__init__()
        shape = [out_features, in_features] if transpose_weight \
            else [in_features, out_features]
        self.weight = self.create_parameter(shape, attr=weight_attr)
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter(
                [out_features], attr=bias_attr, is_bias=True)
        self._transpose = transpose_weight

    def forward(self, x):
        return _functional().fused_linear(x, self.weight, self.bias,
                                          transpose_weight=self._transpose)


class FusedDropoutAdd(Layer):
    def __init__(self, p=0.5, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.mode = mode

    def forward(self, x, y):
        return _functional().fused_dropout_add(
            x, y, p=self.p, training=self.training, mode=self.mode)


class FusedDropout(nn.Dropout):
    """``nn.Dropout`` under the reference's fused name."""


class FusedEcMoe(Layer):
    """The dense expert-computation MoE of ``fused_ec_moe``."""

    def __init__(self, hidden_size, inter_size, num_experts,
                 act_type="gelu", weight_attr=None, bias_attr=None):
        super().__init__()
        self.bmm0_weight = self.create_parameter(
            [num_experts, hidden_size, inter_size], attr=weight_attr)
        self.bmm1_weight = self.create_parameter(
            [num_experts, inter_size, hidden_size], attr=weight_attr)
        if bias_attr is False:
            # no bias parameters: constants of zeros stand in
            from paddle_tpu_torch import zeros

            self.bmm0_bias = zeros([num_experts, 1, inter_size])
            self.bmm1_bias = zeros([num_experts, 1, hidden_size])
        else:
            self.bmm0_bias = self.create_parameter(
                [num_experts, 1, inter_size], attr=bias_attr, is_bias=True)
            self.bmm1_bias = self.create_parameter(
                [num_experts, 1, hidden_size], attr=bias_attr, is_bias=True)
        self.act_type = act_type

    def forward(self, x, gate):
        return _functional().fused_ec_moe(
            x, gate, self.bmm0_weight, self.bmm0_bias, self.bmm1_weight,
            self.bmm1_bias, self.act_type)


class FusedBiasDropoutResidualLayerNorm(Layer):
    """layer_norm(residual + dropout(x + bias)), each of its parameters
    from its attr (``False``: none)."""

    def __init__(self, embed_dim, dropout_rate=0.5, weight_attr=None,
                 bias_attr=None, epsilon=1e-5, name=None):
        super().__init__()
        from paddle_tpu_torch.nn import initializer as init

        if weight_attr is False:
            self.ln_scale = None
        else:
            self.ln_scale = self.create_parameter(
                [embed_dim], attr=weight_attr,
                default_initializer=init.Constant(1.0))
        if bias_attr is False:
            self.linear_bias = None
            self.ln_bias = None
        else:
            self.linear_bias = self.create_parameter(
                [embed_dim], attr=bias_attr, is_bias=True)
            self.ln_bias = self.create_parameter(
                [embed_dim], attr=bias_attr, is_bias=True)
        self.dropout_rate = dropout_rate
        self.epsilon = epsilon

    def forward(self, x, residual):
        return _functional().fused_bias_dropout_residual_layer_norm(
            x, residual, bias=self.linear_bias, ln_scale=self.ln_scale,
            ln_bias=self.ln_bias, dropout_rate=self.dropout_rate,
            ln_epsilon=self.epsilon, training=self.training)


class FusedMultiTransformer(Layer):
    """A GPU serving mega-kernel stack: not ported, it raises."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        raise NotImplementedError(
            "FusedMultiTransformer is a GPU serving mega-kernel stack that "
            "is not ported; compose FusedTransformerEncoderLayer "
            "(training), or serve through paddle_tpu_torch.serving")
