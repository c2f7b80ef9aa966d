"""DataParallel with an eager gradient reducer (port of
``paddle_tpu/distributed/parallel_wrapper.py``).

Reference: python/paddle/distributed/parallel.py:202 (DataParallel) and
the C++ EagerReducer (paddle/fluid/distributed/collective/reducer.h:88:
bucketed gradient fusion, ``find_unused_parameters``, ``no_sync``).

Wrapping broadcasts the parameters and buffers from the group's first
rank, so every replica starts from rank 0's values. A
post-accumulate-grad hook on each trainable parameter records the order
in which the gradients land in a backward and queues one flush for the
end of it (``queue_callback`` of the autograd engine, where the JAX
package's reducer registers a post-backward callback): the gradients are
all-reduced in that order, in buckets of about ``comm_buffer_size`` MB
(one flat collective a bucket, in f32 for 16-bit gradients, rounded
once), and divided by the number of ranks. ``no_sync`` turns the hooks
off, so the gradients accumulate locally; the next synced backward
reduces the accumulated values. With ``find_unused_parameters`` a
parameter the backward did not reach takes a zero gradient into the
reduction, keeping the ranks' collectives paired.
"""
from __future__ import annotations

import contextlib
import functools
from typing import List, Optional

import torch

from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.distributed import communication as comm
from paddle_tpu_torch.nn.layer import Layer

__all__ = ["DataParallel"]


def _data(p) -> torch.Tensor:
    return p._data if isinstance(p, Tensor) else p


def _trainable(p) -> bool:
    return not p.stop_gradient if isinstance(p, Tensor) else p.requires_grad


class _EagerReducer:
    """Bucketed end-of-backward gradient all-reduce (EagerReducer role)."""

    def __init__(self, params: List, group, bucket_mb: float = 25.0,
                 find_unused_parameters: bool = False):
        self._datas = [_data(p) for p in params if _trainable(p)]
        self._group = group
        self._bucket_bytes = int(bucket_mb * 1024 * 1024)
        self._find_unused = find_unused_parameters
        self._ready: List[int] = []
        self._queued = False
        self._enabled = True
        self._handles = [d.register_post_accumulate_grad_hook(
            functools.partial(self._note, i))
            for i, d in enumerate(self._datas)]

    def _note(self, i, t):
        if not self._enabled:
            return
        if not self._queued:
            torch.autograd.Variable._execution_engine.queue_callback(
                self._flush)
            self._queued = True
        if i not in self._ready:
            self._ready.append(i)

    @torch.no_grad()
    def _flush(self):
        self._queued = False
        order = list(self._ready)
        self._ready.clear()
        if self._find_unused:
            for i, d in enumerate(self._datas):
                if i not in order:
                    if d.grad is None:
                        d.grad = torch.zeros_like(d)
                    order.append(i)
        grads = [self._datas[i].grad for i in order]
        # DP averages the gradients
        comm.all_reduce_into([g for g in grads if g is not None],
                             self._group, 1.0 / self._group.nranks,
                             self._bucket_bytes)

    def close(self):
        for h in self._handles:
            h.remove()


class DataParallel(Layer):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self.find_unused_parameters = find_unused_parameters
        self._grad_sync_enabled = True
        self._group = group or comm.get_group(0)
        self._reducer: Optional[_EagerReducer] = None
        if self._group.nranks > 1 and self._group.process_group is not None:
            # the reference's sync_params_buffers: every replica starts
            # from the first rank's values
            src = self._group.ranks[0]
            for p in layers.parameters():
                comm.broadcast_(_data(p).data, src, self._group)
            for _, b in layers.named_buffers():
                comm.broadcast_(_data(b).data, src, self._group)
            self._reducer = _EagerReducer(
                list(layers.parameters()), self._group,
                bucket_mb=comm_buffer_size,
                find_unused_parameters=find_unused_parameters)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    @contextlib.contextmanager
    def no_sync(self):
        """Accumulate gradients without cross-rank synchronization; the
        next backward outside the context reduces the accumulated
        gradients."""
        self._grad_sync_enabled = False
        if self._reducer is not None:
            self._reducer._enabled = False
        try:
            yield
        finally:
            self._grad_sync_enabled = True
            if self._reducer is not None:
                self._reducer._enabled = True

    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def named_parameters(self, prefix="", include_sublayers=True):
        return self._layers.named_parameters(prefix, include_sublayers)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, **kwargs):
        return self._layers.set_state_dict(state_dict, **kwargs)

    def scale_loss(self, loss):
        return loss
