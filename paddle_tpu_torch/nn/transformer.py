"""Transformer layers (port of ``paddle_tpu/nn/transformer.py``):
``MultiHeadAttention`` (with a key/value ``cache``), the encoder and
decoder layers and stacks, and ``Transformer``, over the registry's
``scaled_dot_product_attention``."""
from __future__ import annotations

from paddle_tpu_torch import ops
from paddle_tpu_torch.nn.activation import GELU, ReLU
from paddle_tpu_torch.nn.common import Dropout, Linear
from paddle_tpu_torch.nn.layer import Layer, LayerList
from paddle_tpu_torch.nn.norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


class MultiHeadAttention(Layer):
    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        b, sq = query.shape[0], query.shape[1]
        h, d = self.num_heads, self.head_dim
        q = ops.reshape(self.q_proj(query), [b, sq, h, d])
        k = ops.reshape(self.k_proj(key), [b, key.shape[1], h, d])
        v = ops.reshape(self.v_proj(value), [b, value.shape[1], h, d])
        if cache is not None:
            k = ops.concat([cache[0], k], axis=1)
            v = ops.concat([cache[1], v], axis=1)
        out = ops.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training)
        out = ops.reshape(out, [b, sq, h * d])
        out = self.out_proj(out)
        if cache is not None:
            return out, (k, v)
        return out


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, dropout if attn_dropout is None else attn_dropout)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout = Dropout(dropout)
        self.dropout1 = Dropout(dropout if act_dropout is None
                                else act_dropout)
        self.activation = ReLU() if activation == "relu" else GELU()

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = self.self_attn(src, attn_mask=src_mask)
        src = residual + self.dropout(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout1(self.activation(self.linear1(src))))
        src = residual + self.dropout(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        import copy
        self.layers = LayerList(
            [encoder_layer] +
            [copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask=src_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout)
        self.cross_attn = MultiHeadAttention(d_model, nhead, dropout)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.dropout = Dropout(dropout)
        self.activation = ReLU() if activation == "relu" else GELU()

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        tgt = self.self_attn(tgt, attn_mask=tgt_mask)
        tgt = residual + self.dropout(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, attn_mask=memory_mask)
        tgt = residual + self.dropout(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        import copy
        self.layers = LayerList(
            [decoder_layer] +
            [copy.deepcopy(decoder_layer) for _ in range(num_layers - 1)])
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None):
        out = tgt
        for layer in self.layers:
            out = layer(out, memory, tgt_mask=tgt_mask,
                        memory_mask=memory_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        self.encoder = custom_encoder or TransformerEncoder(
            TransformerEncoderLayer(d_model, nhead, dim_feedforward, dropout,
                                    activation,
                                    normalize_before=normalize_before),
            num_encoder_layers,
            LayerNorm(d_model) if normalize_before else None)
        self.decoder = custom_decoder or TransformerDecoder(
            TransformerDecoderLayer(d_model, nhead, dim_feedforward, dropout,
                                    activation,
                                    normalize_before=normalize_before),
            num_decoder_layers,
            LayerNorm(d_model) if normalize_before else None)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length):
        import numpy as np
        from paddle_tpu_torch.core.tensor import Tensor
        mask = np.triu(np.full((length, length), -np.inf, dtype=np.float32),
                       k=1)
        return Tensor(mask)
