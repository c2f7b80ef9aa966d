"""Tensor-parallel layers at degree 1 (port of
``paddle_tpu/distributed/fleet/mp_layers.py``).

On one card each layer computes what its unsharded counterpart does, with
the JAX package's parameter shapes and initializers (``XavierNormal``
weights, ``Constant(0)`` biases), so their keys and draws match.
``mark_placements`` and ``sharding_constraint`` are no-ops. A model-parallel
group of more than one rank is refused: sharded training layers come with
slice D (ROADMAP queue 1, distributed training).
"""
from __future__ import annotations

from paddle_tpu_torch import ops
from paddle_tpu_torch.nn import initializer as init
from paddle_tpu_torch.nn.layer import Layer

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "mark_placements",
           "sharding_constraint"]


def _check_degree(mp_group):
    n = 1 if mp_group is None else int(getattr(mp_group, "nranks", 1))
    if n > 1:
        raise NotImplementedError(
            f"model-parallel degree {n}: the port's tensor-parallel layers "
            "run at degree 1; sharded training layers come with slice D "
            "(ROADMAP queue 1, distributed training)")


def mark_placements(param, *placements_by_axis, mesh=None, **named):
    """No-op on one card: returns ``param``."""
    return param


def sharding_constraint(x, spec: dict):
    """No-op on one card: returns ``x``."""
    return x


class VocabParallelEmbedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None):
        _check_degree(mp_group)
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=init.XavierNormal())

    def forward(self, x):
        return ops.embedding(x, self.weight)


class ColumnParallelLinear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        _check_degree(mp_group)
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=init.XavierNormal())
        self.bias = self.create_parameter([out_features], is_bias=True) \
            if has_bias else None

    def forward(self, x):
        return ops.linear(x, self.weight, self.bias)


class RowParallelLinear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        _check_degree(mp_group)
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=init.XavierNormal())
        self.bias = self.create_parameter([out_features], is_bias=True) \
            if has_bias else None

    def forward(self, x):
        return ops.linear(x, self.weight, self.bias)


class ParallelCrossEntropy(Layer):
    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        _check_degree(mp_group)
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, input, label):
        return ops.softmax_with_cross_entropy(
            input, label, ignore_index=self.ignore_index)
