"""Tensor-parallel layers (port of
``paddle_tpu/distributed/fleet/mp_layers.py``).

The JAX layers keep GLOBAL-view weights annotated with mesh placements,
and GSPMD inserts the collectives the reference writes by hand. Here a
layer holds the JAX package's parameter shapes and initializers
(``XavierNormal`` weights ``[in, out]``, ``Constant(0)`` biases) and its
placement hints (:func:`mark_placements`);
:func:`~paddle_tpu_torch.distributed.engine.shard_model_parameters` cuts
the weights to a rank's shard and binds the layer to the mesh's ``"mp"``
group (``_bind_mp``). Bound to a group of k > 1 ranks, each layer
computes the reference's Megatron pair (reference mp_layers.py), each
side a ``torch.autograd.Function`` of
:mod:`paddle_tpu_torch.distributed.communication`:

* ``ColumnParallelLinear``: identity forward / all-reduce backward on
  its input (``_c_identity``), the output's all-gather when
  ``gather_output`` (``_c_concat``);
* ``RowParallelLinear``: its input split unless ``input_is_parallel``
  (``_c_split``), the all-reduce of its output (``_mp_allreduce``), the
  bias added once after it;
* ``VocabParallelEmbedding``: a lookup masked to the rank's rows of the
  vocabulary, then an all-reduce;
* ``ParallelCrossEntropy``: the vocab-sharded log-softmax, with the max,
  the sum of exponentials and the target logit each all-reduced, and
  ``ignore_index`` honoured. It reads its group from the binding, else
  from the current mesh of a ``ParallelTrainStep`` (the JAX layer's
  ``sharding_constraint`` reads the ambient mesh).

16-bit partial sums are reduced in f32 and rounded once. Unbound (or at
k = 1) each layer computes what its unsharded counterpart does.
:func:`sharding_constraint` stays the identity: a rank's activations
carry no sharding, the layers' collectives are written out.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.distributed import communication as comm
from paddle_tpu_torch.distributed.mesh import Shard
from paddle_tpu_torch.nn import initializer as init
from paddle_tpu_torch.nn.layer import Layer

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "mark_placements",
           "sharding_constraint", "parallel_cross_entropy",
           "vocab_parallel_embedding"]


def mark_placements(param, *placements_by_axis, mesh=None, **named):
    """Attach placement hints: ``mark_placements(w, mp=Shard(1))`` (mesh
    axes not named stay replicated). ``shard_model_parameters`` cuts the
    parameter by them. Returns ``param``."""
    param._placement_hints = dict(named)
    if mesh is not None:
        param._process_mesh = mesh
    return param


def sharding_constraint(x, spec: dict):
    """The identity: a rank's activations carry no sharding here (the
    JAX package constrains its global-view activations for GSPMD)."""
    return x


def _on_data(fn, x, *args):
    """``fn`` (a function of torch tensors) applied to a Tensor's data,
    the result wrapped."""
    out = fn(x._data, *args)
    return Tensor._from_data(out, stop_gradient=not out.requires_grad)


def _bound(group):
    return group if group is not None and group.nranks > 1 else None


def vocab_parallel_embedding(ids: torch.Tensor, weight: torch.Tensor,
                             group) -> torch.Tensor:
    """Rows of a vocabulary sharded over ``group`` (rank r holds rows r *
    V/k up to (r + 1) * V/k, ``weight`` its shard): the masked lookup,
    then the sum over the ranks."""
    g = _bound(group)
    if g is None:
        return torch.nn.functional.embedding(ids.long(), weight)
    n = weight.shape[0]
    start = g.rank() * n
    ids = ids.long()
    outside = (ids < start) | (ids >= start + n)
    local = torch.where(outside, 0, ids - start)
    out = torch.nn.functional.embedding(local, weight)
    out = out.masked_fill(outside.unsqueeze(-1), 0)
    return comm.reduce_from_group(out, g)


def parallel_cross_entropy(logits: torch.Tensor, label: torch.Tensor,
                           group, ignore_index: int = -100
                           ) -> torch.Tensor:
    """Per-position cross entropy (the class axis kept with size 1, as
    ``softmax_with_cross_entropy`` gives it) over ``logits`` whose last dim
    is this rank's shard of the vocabulary over ``group``; 16-bit logits
    are taken to f32; positions labelled ``ignore_index`` get 0."""
    from paddle_tpu_torch.ops.nn_ops import softmax_with_cross_entropy

    g = _bound(group)
    if g is None:
        return softmax_with_cross_entropy(logits, label,
                                          ignore_index=ignore_index)
    x = logits.float() if logits.element_size() < 4 else logits
    n = x.shape[-1]
    start = g.rank() * n
    if label.dim() == x.dim():
        label = label.squeeze(-1)
    lab = label.long()
    m = x.detach().amax(dim=-1, keepdim=True)
    comm.all_reduce_(m, comm.ReduceOp.MAX, g)
    z = x - m
    sumexp = comm.reduce_from_group(z.exp().sum(dim=-1, keepdim=True), g)
    inside = ((lab >= start) & (lab < start + n)).unsqueeze(-1)
    local = torch.where(inside, lab.unsqueeze(-1) - start, 0)
    target = torch.where(inside, z.gather(-1, local), 0.0)
    target = comm.reduce_from_group(target, g)
    loss = torch.log(sumexp) - target
    valid = (label != ignore_index).unsqueeze(-1)
    return torch.where(valid, loss, 0.0)


class VocabParallelEmbedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=init.XavierNormal())
        mark_placements(self.weight, mp=Shard(0))
        self._mp_group = mp_group

    def _bind_mp(self, group):
        self._mp_group = group

    def forward(self, x):
        g = _bound(self._mp_group)
        if g is None:
            return ops.embedding(x, self.weight)
        out = vocab_parallel_embedding(x._data, self.weight._data, g)
        return Tensor._from_data(out, stop_gradient=not out.requires_grad)


class ColumnParallelLinear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=init.XavierNormal())
        mark_placements(self.weight, mp=Shard(1))
        if has_bias:
            self.bias = self.create_parameter([out_features], is_bias=True)
            mark_placements(self.bias, mp=Shard(0))
        else:
            self.bias = None
        self._mp_group = mp_group

    def _bind_mp(self, group):
        self._mp_group = group

    def forward(self, x):
        g = _bound(self._mp_group)
        if g is not None:
            x = _on_data(comm.copy_to_group, x, g)
        out = ops.linear(x, self.weight, self.bias)
        if g is not None and self.gather_output:
            out = _on_data(comm.gather_along, out, g, out.ndim - 1)
        return out


class RowParallelLinear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=init.XavierNormal())
        mark_placements(self.weight, mp=Shard(0))
        self.bias = self.create_parameter([out_features], is_bias=True) \
            if has_bias else None
        self._mp_group = mp_group

    def _bind_mp(self, group):
        self._mp_group = group

    def forward(self, x):
        g = _bound(self._mp_group)
        if g is None:
            return ops.linear(x, self.weight, self.bias)
        if not self.input_is_parallel:
            x = _on_data(comm.split_along, x, g, x.ndim - 1)
        out = _on_data(comm.reduce_from_group,
                       ops.linear(x, self.weight, None), g)
        return out if self.bias is None else out + self.bias


class ParallelCrossEntropy(Layer):
    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index
        self._mp_group = mp_group

    def _bind_mp(self, group):
        self._mp_group = group

    def forward(self, input, label):
        from paddle_tpu_torch.distributed.engine import mp_group

        g = _bound(self._mp_group) or mp_group()
        if g is None:
            return ops.softmax_with_cross_entropy(
                input, label, ignore_index=self.ignore_index)
        out = parallel_cross_entropy(input._data, label._data, g,
                                     self.ignore_index)
        return Tensor._from_data(out, stop_gradient=not out.requires_grad)
