"""Megatron-style sequence parallelism (port of
``paddle_tpu/distributed/fleet/utils/sequence_parallel_utils.py``).

Reference: python/paddle/distributed/fleet/utils/
sequence_parallel_utils.py — ScatterOp:85, GatherOp:97, AllGatherOp:111,
ReduceScatterOp:127, ColumnSequenceParallelLinear:395,
RowSequenceParallelLinear:528.

SP splits the sequence dim of the activations between the
tensor-parallel layers (norms, residuals) over the mp group: entering a
column-parallel linear the sequence is all-gathered, and leaving a
row-parallel linear the partial sums are reduce-scattered back onto the
sequence dim. The JAX package writes each as a sharding constraint and
GSPMD inserts the collective; here each op is the reference's pair as a
``torch.autograd.Function`` over the current mesh's ``"mp"`` group
(:func:`~paddle_tpu_torch.distributed.engine.mp_group`, set while a
``ParallelTrainStep`` runs) or the group a layer is bound to. Without
one, each op is the identity. The ops take the sequence ``axis``
(default 0, the reference's [s, b, h]; the Llama passes 1).

The parameters of an SP region (the norms' weights) see only their
rank's slice of the sequence, so their gradients are partial sums over
mp: :func:`mark_as_sequence_parallel_parameter` tags them and the step
sums their gradients over mp (:func:`register_sequence_parallel_
allreduce_hooks` does the same for an eager loop).
"""
from __future__ import annotations

from paddle_tpu_torch import ops
from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.distributed import communication as comm
from paddle_tpu_torch.distributed.fleet.mp_layers import (
    ColumnParallelLinear, RowParallelLinear, _bound, _on_data,
)

__all__ = ["ScatterOp", "GatherOp", "AllGatherOp", "ReduceScatterOp",
           "ColumnSequenceParallelLinear", "RowSequenceParallelLinear",
           "mark_as_sequence_parallel_parameter",
           "register_sequence_parallel_allreduce_hooks"]


def _mp(group=None):
    from paddle_tpu_torch.distributed.engine import mp_group

    return _bound(group) or mp_group()


def _apply(fn, x, axis, group=None):
    g = _mp(group)
    if g is None:
        return x
    if isinstance(x, Tensor):
        return _on_data(fn, x, g, axis % x.ndim)
    return fn(x, g, axis % x.dim())


class ScatterOp:
    """Split the sequence dim across mp (forward split, backward
    all-gather)."""

    @staticmethod
    def apply(x, axis: int = 0, group=None):
        return _apply(comm.split_along, x, axis, group)


class GatherOp:
    """Gather the sequence dim from mp (forward all-gather, backward
    split)."""

    @staticmethod
    def apply(x, axis: int = 0, group=None):
        return _apply(comm.gather_along, x, axis, group)


class AllGatherOp:
    """All-gather the sequence dim before a column-parallel matmul
    (forward all-gather, backward reduce-scatter)."""

    @staticmethod
    def apply(x, axis: int = 0, group=None):
        return _apply(comm.all_gather_along, x, axis, group)


class ReduceScatterOp:
    """Reduce partial sums and scatter them onto the sequence dim after a
    row-parallel matmul (forward reduce-scatter, backward all-gather)."""

    @staticmethod
    def apply(x, axis: int = 0, group=None):
        return _apply(comm.reduce_scatter_along, x, axis, group)


def mark_as_sequence_parallel_parameter(param):
    """Tag a parameter of an SP region: its gradient is summed over mp."""
    param.sequence_parallel = True
    return param


def register_sequence_parallel_allreduce_hooks(model, accumulation_steps=1,
                                               fuse_sequence_parallel_allreduce
                                               =False):
    """For an eager loop: a hook on each tagged parameter that sums its
    gradient over the current mesh's mp group when the gradient is
    accumulated. (``ParallelTrainStep`` sums them itself.) Returns
    ``model``."""
    for p in model.parameters():
        if not getattr(p, "sequence_parallel", False):
            continue
        data = p if not isinstance(p, Tensor) else p._data

        def hook(t):
            g = _mp()
            if g is not None and t.grad is not None:
                comm.all_reduce_(t.grad, comm.ReduceOp.SUM, g)

        data.register_post_accumulate_grad_hook(hook)
    return model


class ColumnSequenceParallelLinear(ColumnParallelLinear):
    """A ColumnParallelLinear whose input arrives sequence-sharded: the
    sequence is all-gathered, then the column-sharded matmul; the output
    stays feature-sharded."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=False, seq_axis: int = 0,
                 mp_group=None, name=None):
        super().__init__(in_features, out_features,
                         weight_attr=weight_attr, has_bias=has_bias,
                         gather_output=gather_output, mp_group=mp_group,
                         name=name)
        self.seq_axis = seq_axis

    def forward(self, x):
        g = _mp(self._mp_group)
        if g is None:
            return super().forward(x)
        x = AllGatherOp.apply(x, axis=self.seq_axis, group=g)
        out = ops.linear(x, self.weight, self.bias)
        if self.gather_output:
            out = _on_data(comm.gather_along, out, g, out.ndim - 1)
        return out


class RowSequenceParallelLinear(RowParallelLinear):
    """A RowParallelLinear whose partial sums are reduce-scattered onto
    the sequence dim; the bias is added after, once on each rank's slice
    of the sequence."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=True, seq_axis: int = 0,
                 mp_group=None, name=None):
        super().__init__(in_features, out_features,
                         weight_attr=weight_attr, has_bias=has_bias,
                         input_is_parallel=input_is_parallel,
                         mp_group=mp_group, name=name)
        self.seq_axis = seq_axis
        if self.bias is not None:
            # added on each rank's slice of the sequence: a partial sum
            mark_as_sequence_parallel_parameter(self.bias)

    def forward(self, x):
        g = _mp(self._mp_group)
        if g is None:
            return super().forward(x)
        if not self.input_is_parallel:
            x = _on_data(comm.split_along, x, g, x.ndim - 1)
        out = ops.linear(x, self.weight, None)
        out = ReduceScatterOp.apply(out, axis=self.seq_axis, group=g)
        return out if self.bias is None else out + self.bias
