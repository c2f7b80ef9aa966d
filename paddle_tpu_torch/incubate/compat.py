"""The rest of the ``incubate`` namespace (port of
``paddle_tpu/incubate/compat.py``): segment reductions, graph message
passing and sampling, the fused softmax masks, ``identity_loss`` and the
optimizer wrappers ``LookAhead`` and ``ModelAverage``.

The graph samplers draw on the host with numpy, as the JAX package does:
``graph_sample_neighbors`` from an unseeded ``np.random.default_rng()``,
so two calls (and the two packages) draw different samples. The
optimizer wrappers change parameters in place, under ``no_grad``, so the
optimizer's slots and a step's captured addresses stay valid.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from paddle_tpu_torch.core.tensor import Tensor

__all__ = ["segment_sum", "segment_mean", "segment_max", "segment_min",
           "graph_send_recv", "graph_khop_sampler", "graph_reindex",
           "graph_sample_neighbors", "identity_loss",
           "softmax_mask_fuse", "softmax_mask_fuse_upper_triangle",
           "LookAhead", "ModelAverage"]


def _d(t):
    return t._data if isinstance(t, Tensor) else torch.as_tensor(t)


def _host(t) -> np.ndarray:
    d = _d(t)
    return d.detach().cpu().numpy()


def _index_tensor(arr: np.ndarray) -> Tensor:
    """A host array as a Tensor on the default device."""
    return Tensor(np.ascontiguousarray(arr))


def _segments(data, segment_ids):
    d = _d(data)
    ids = _d(segment_ids).to(device=d.device, dtype=torch.int64)
    n = int(ids.max()) + 1 if ids.numel() else 0
    return d, ids, n


def _segment_extreme(data, segment_ids, reduce):
    """segment max/min: an empty segment holds the reduction's identity
    (-inf / +inf, an integer type's extreme), as ``jax.ops`` gives."""
    d, ids, n = _segments(data, segment_ids)
    big = reduce == "amin"
    if d.is_floating_point():
        fill = float("inf") if big else float("-inf")
    else:
        info = torch.iinfo(d.dtype)
        fill = info.max if big else info.min
    out = torch.full((n,) + tuple(d.shape[1:]), fill, dtype=d.dtype,
                     device=d.device)
    idx = ids.reshape((-1,) + (1,) * (d.dim() - 1)).expand_as(d)
    return Tensor._from_data(out.scatter_reduce(0, idx, d, reduce))


def segment_sum(data, segment_ids, name=None):
    d, ids, n = _segments(data, segment_ids)
    out = torch.zeros((n,) + tuple(d.shape[1:]), dtype=d.dtype,
                      device=d.device)
    return Tensor._from_data(out.index_add(0, ids, d))


def segment_max(data, segment_ids, name=None):
    return _segment_extreme(data, segment_ids, "amax")


def segment_min(data, segment_ids, name=None):
    return _segment_extreme(data, segment_ids, "amin")


def segment_mean(data, segment_ids, name=None):
    d, ids, n = _segments(data, segment_ids)
    s = torch.zeros((n,) + tuple(d.shape[1:]), dtype=d.dtype,
                    device=d.device).index_add(0, ids, d)
    c = torch.zeros((n,), dtype=d.dtype, device=d.device).index_add(
        0, ids, torch.ones_like(ids, dtype=d.dtype))
    shape = (-1,) + (1,) * (d.dim() - 1)
    return Tensor._from_data(s / torch.clamp_min(c.reshape(shape), 1))


def graph_send_recv(x, src_index, dst_index, reduce_op="sum",
                    out_size=None, name=None):
    from paddle_tpu_torch.ops.registry import API

    return API["graph_send_recv"](x, src_index, dst_index,
                                  reduce_op=reduce_op.lower(),
                                  out_size=out_size or 0)


def graph_sample_neighbors(row, colptr, input_nodes, sample_size=-1,
                           eids=None, return_eids=False, perm_buffer=None,
                           name=None):
    """Uniform neighbour sampling on a CSC graph, on the host: each
    node's neighbours ``row[colptr[v]:colptr[v + 1]]``, down to
    ``sample_size`` drawn without replacement where it has more. Returns
    (the samples concatenated, the count per node as int32)."""
    rows, cp = _host(row), _host(colptr)
    nodes = _host(input_nodes).reshape(-1)
    out_n, out_count = [], []
    rng = np.random.default_rng()
    for v in nodes:
        nb = rows[cp[v]:cp[v + 1]]
        if sample_size > 0 and len(nb) > sample_size:
            nb = rng.choice(nb, sample_size, replace=False)
        out_n.append(nb)
        out_count.append(len(nb))
    flat = np.concatenate(out_n) if out_n else np.zeros((0,), rows.dtype)
    return (_index_tensor(flat),
            _index_tensor(np.asarray(out_count, np.int32)))


def graph_khop_sampler(row, colptr, input_nodes, sample_sizes,
                       sorted_eids=None, return_eids=False, name=None):
    """Multi-hop sampling: :func:`graph_sample_neighbors` once per hop
    from the growing frontier, then the edges reindexed as
    :func:`graph_reindex` does. Returns (src, dst, the nodes in their new
    order, the edge ids 0..E-1)."""
    seeds = _host(input_nodes).reshape(-1)
    frontier = seeds
    all_src, all_dst = [], []
    for k in (sample_sizes if isinstance(sample_sizes, (list, tuple))
              else [sample_sizes]):
        nbrs, counts = graph_sample_neighbors(row, colptr, frontier,
                                              sample_size=int(k))
        nb, cnt = _host(nbrs), _host(counts)
        all_src.append(nb)
        all_dst.append(np.repeat(frontier, cnt))
        frontier = np.unique(np.concatenate([frontier, nb]))
    src, dst = np.concatenate(all_src), np.concatenate(all_dst)
    r_src, r_dst, nodes = _reindex(seeds, src, dst)
    return (_index_tensor(r_src), _index_tensor(r_dst),
            _index_tensor(nodes),
            _index_tensor(np.arange(len(src), dtype=np.int64)))


def _reindex(seed_nodes, src, dst):
    """Node ids compacted to [0, N) in order of first appearance over
    (seeds, src, dst)."""
    remap = {}
    for v in np.concatenate([seed_nodes, src, dst]):
        remap.setdefault(int(v), len(remap))
    return (np.asarray([remap[int(v)] for v in src], np.int64),
            np.asarray([remap[int(v)] for v in dst], np.int64),
            np.asarray(list(remap), np.int64))


def graph_reindex(x, neighbors, count, value_buffer=None,
                  index_buffer=None, flag_buffer_hashtable=False,
                  name=None):
    """Compact node ids to [0, N): (reindexed neighbours, their
    destinations, the nodes in their new order)."""
    seeds = _host(x).reshape(-1)
    nb = _host(neighbors).reshape(-1)
    dst = np.repeat(seeds, _host(count).reshape(-1))
    r_src, r_dst, nodes = _reindex(seeds, nb, dst)
    return (_index_tensor(r_src), _index_tensor(r_dst),
            _index_tensor(nodes))


def identity_loss(x, reduction="none"):
    """The reduction of x itself ("none"/2, "sum"/1, else the mean)."""
    if reduction in ("none", 2):
        return x
    if reduction in ("sum", 1):
        return x.sum()
    return x.mean()


def softmax_mask_fuse(x, mask, name=None):
    """softmax(x + mask) over the last axis."""
    return Tensor._from_data(torch.softmax(_d(x) + _d(mask), dim=-1))


def softmax_mask_fuse_upper_triangle(x):
    """softmax over the last axis with the upper triangle masked out
    (-1e9 added above the diagonal)."""
    d = _d(x)
    s = d.shape[-1]
    mask = torch.triu(torch.full((s, s), -1e9, dtype=d.dtype,
                                 device=d.device), diagonal=1)
    return Tensor._from_data(torch.softmax(d + mask, dim=-1))


def _trainable(optimizer):
    """The optimizer's trainable parameters, as the torch tensors it
    updates."""
    optimizer._follow_wrappers()
    return [p for p in optimizer._parameter_list or [] if p.requires_grad]


class LookAhead:
    """Lookahead over an inner optimizer: every ``k`` steps the slow
    weights move ``alpha`` of the way to the fast ones and the fast
    weights take their value (the slow weights start at the fast ones at
    the first sync, as in the JAX package)."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        self._slow = {}
        self._n = 0

    @torch.no_grad()
    def step(self):
        self.inner_optimizer.step()
        self._n += 1
        if self._n % self.k:
            return
        for i, p in enumerate(_trainable(self.inner_optimizer)):
            slow = self._slow.get(i)
            if slow is None:
                slow = p.detach().clone()
            slow = slow + self.alpha * (p - slow)
            self._slow[i] = slow
            p.copy_(slow)

    def clear_grad(self, *a, **k):
        self.inner_optimizer.clear_grad(*a, **k)

    def minimize(self, loss):
        loss.backward()
        self.step()
        self.clear_grad()

    def state_dict(self):
        return {"inner": getattr(self.inner_optimizer, "state_dict",
                                 dict)(), "n": self._n}


class ModelAverage:
    """The running average of ``parameters``, summed at each
    :meth:`step` and swapped in by :meth:`apply` (a context that restores
    the trained values on exit, or :meth:`restore`)."""

    def __init__(self, average_window_rate=0.15, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        self._params = list(parameters or [])
        self._sum = {}
        self._count = 0
        self._backup = {}

    @torch.no_grad()
    def step(self):
        self._count += 1
        for i, p in enumerate(self._params):
            d = _d(p).detach()
            self._sum[i] = d.clone() if i not in self._sum \
                else self._sum[i] + d

    def apply(self, executor=None, need_restore=True):
        @contextlib.contextmanager
        def ctx():
            with torch.no_grad():
                self._backup = {i: _d(p).detach().clone()
                                for i, p in enumerate(self._params)}
                if self._count:
                    for i, p in enumerate(self._params):
                        if i in self._sum:
                            _d(p).copy_(self._sum[i] / self._count)
            try:
                yield self
            finally:
                if need_restore:
                    self.restore()

        return ctx()

    @torch.no_grad()
    def restore(self, executor=None):
        for i, p in enumerate(self._params):
            if i in self._backup:
                _d(p).copy_(self._backup[i])
        self._backup = {}
