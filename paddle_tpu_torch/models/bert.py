"""The BERT encoder family (port of ``paddle_tpu/models/bert.py``).

Embeddings, then ``nn.TransformerEncoder`` layers (post-norm, GELU), a
tanh pooler over the first token; a masked-LM head whose decoder is the
word embedding itself (one parameter, so it appears once in
``parameters()`` and ``state_dict()`` and its gradient sums both uses);
a sequence classifier; and the masked-LM criterion. The attention is the
registry's plain ``scaled_dot_product_attention`` under an additive
padding mask, as in the JAX package. The defaults are the published
BERT-base config (``uncased_L-12_H-768_A-12``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn

__all__ = ["BertConfig", "BertModel", "BertForMaskedLM",
           "BertForSequenceClassification", "BertPretrainingCriterion"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0


class BertEmbeddings(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       epsilon=cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None):
        s = input_ids.shape[1]
        if s > self.position_embeddings.num_embeddings:
            raise ValueError(
                f"sequence length {s} exceeds max_position_embeddings "
                f"{self.position_embeddings.num_embeddings}")
        pos = paddle.arange(s, dtype="int32")
        if token_type_ids is None:
            # omitted type ids are type 0, whose embedding is added
            token_type_ids = paddle.zeros_like(input_ids)
        h = (self.word_embeddings(input_ids)
             + self.position_embeddings(pos)[None]
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(h))


class BertModel(nn.Layer):
    """Embeddings -> N encoder layers -> (sequence_output,
    pooled_output)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = BertEmbeddings(cfg)
        enc_layer = nn.TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_attention_heads,
            cfg.intermediate_size, dropout=cfg.hidden_dropout_prob,
            activation="gelu",
            attn_dropout=cfg.attention_probs_dropout_prob,
            act_dropout=0.0)
        self.encoder = nn.TransformerEncoder(enc_layer,
                                             cfg.num_hidden_layers)
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        if attention_mask is None:
            attention_mask = input_ids != self.config.pad_token_id
        # additive mask (B, 1, 1, S) in f32: f32 scores and bf16 scores
        # (under AMP) both promote to f32 when it is added
        neg = float(np.finfo(np.float32).min)
        add_mask = (1.0 - attention_mask.astype("float32")) * neg
        add_mask = paddle.reshape(
            add_mask, [add_mask.shape[0], 1, 1, add_mask.shape[1]])
        h = self.embeddings(input_ids, token_type_ids)
        h = self.encoder(h, add_mask)
        pooled = paddle.tanh(self.pooler(h[:, 0]))
        return h, pooled


class BertForMaskedLM(nn.Layer):
    """The masked-LM head; its decoder weight is the word embedding."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.bert = BertModel(cfg)
        self.transform = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.transform_ln = nn.LayerNorm(cfg.hidden_size,
                                         epsilon=cfg.layer_norm_eps)
        self.decoder_bias = self.create_parameter([cfg.vocab_size],
                                                  is_bias=True)

    @property
    def decoder_weight(self):
        """The decoder's weight: the word embedding's parameter."""
        return self.bert.embeddings.word_embeddings.weight

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        h, _ = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.transform_ln(paddle.ops.gelu(self.transform(h)))
        return paddle.matmul(h, self.decoder_weight, transpose_y=True) \
            + self.decoder_bias


class BertForSequenceClassification(nn.Layer):
    def __init__(self, cfg: BertConfig, num_classes: int = 2):
        super().__init__()
        self.bert = BertModel(cfg)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)
        self.classifier = nn.Linear(cfg.hidden_size, num_classes)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.classifier(self.dropout(pooled))


class BertPretrainingCriterion(nn.Layer):
    """Masked-LM loss: cross entropy over the labelled positions (the
    rest labelled -100)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.vocab_size = cfg.vocab_size

    def forward(self, logits, labels):
        return paddle.nn.functional.cross_entropy(
            paddle.reshape(logits, [-1, self.vocab_size]),
            paddle.reshape(labels, [-1]), ignore_index=-100)
