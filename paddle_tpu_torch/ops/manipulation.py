"""Shape, layout and indexing emitters (port of
``paddle_tpu/ops/manipulation.py`` and of ``paddle_tpu/ops/graph_ops.py``).

Every emitter is out of place (``x.at[...].set`` becomes ``index_put``,
``scatter`` and friends without the trailing underscore, or a write into
a fresh clone). Index results are int64 (jnp's without x64 are int32).
Integer index tensors may be int32 or int64; torch ops that take only
int64 get a cast.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.dtype import to_torch
from paddle_tpu_torch.ops.math import as_operand
from paddle_tpu_torch.ops.registry import register_emitter as op


def _as_index(index, device):
    if isinstance(index, torch.Tensor):
        return index.to(device)
    return torch.as_tensor(index, device=device)


@op
def cast(x, dtype):
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    return x.to(to_torch(dtype), copy=True)


@op
def reshape(x, shape):
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    return torch.reshape(x, [int(s) for s in shape])


@op
def flatten(x, start_axis=0, stop_axis=-1):
    nd = x.dim()
    if nd == 0:
        return x.reshape(1)
    sa = start_axis % nd
    ea = stop_axis % nd
    new_shape = list(x.shape[:sa]) + [-1] + list(x.shape[ea + 1:])
    return torch.reshape(x, new_shape)


@op
def squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    if isinstance(axis, (list, tuple)):
        axis = tuple(a % max(x.dim(), 1) for a in axis)
        axis = tuple(a for a in axis if x.shape[a] == 1)
        return torch.squeeze(x, dim=axis) if axis else x.view_as(x)
    axis = axis % max(x.dim(), 1)
    return torch.squeeze(x, dim=axis) if x.shape[axis] == 1 \
        else x.view_as(x)


@op
def unsqueeze(x, axis):
    if isinstance(axis, (list, tuple)):
        out = x
        for a in axis:
            out = torch.unsqueeze(out, int(a))
        return out
    return torch.unsqueeze(x, int(axis))


@op
def transpose(x, perm):
    return x.permute(*[int(p) for p in perm])


@op
def moveaxis(x, source, destination):
    return torch.movedim(x, source, destination)


@op
def swapaxes(x, axis1, axis2):
    return torch.swapaxes(x, axis1, axis2)


@op
def concat(xs, axis=0):
    return torch.cat(list(xs), dim=int(axis))


@op
def stack(xs, axis=0):
    return torch.stack(list(xs), dim=int(axis))


@op
def split(x, num_or_sections, axis=0):
    axis = int(axis)
    if isinstance(num_or_sections, int):
        if x.shape[axis] % num_or_sections:
            raise ValueError("array split does not result in an equal "
                             "division")
        return tuple(torch.tensor_split(x, num_or_sections, dim=axis))
    sections = list(num_or_sections)
    if -1 in sections:
        known = sum(s for s in sections if s != -1)
        sections[sections.index(-1)] = x.shape[axis] - known
    return tuple(torch.split(x, sections, dim=axis))


@op
def chunk(x, chunks, axis=0):
    return tuple(torch.tensor_split(x, chunks, dim=int(axis)))


@op
def unbind(x, axis=0):
    return tuple(torch.unbind(x, dim=int(axis)))


@op
def tile(x, repeat_times):
    return torch.tile(x, tuple(int(r) for r in repeat_times))


@op
def expand(x, shape):
    shape = list(shape)
    nd_in = x.dim()
    nd_out = len(shape)
    xshape = [1] * (nd_out - nd_in) + list(x.shape)
    out_shape = [xshape[i] if shape[i] == -1 else int(shape[i])
                 for i in range(nd_out)]
    return torch.broadcast_to(x.reshape(xshape), out_shape)


@op
def expand_as(x, y):
    return torch.broadcast_to(x, y.shape)


@op
def broadcast_to(x, shape):
    return torch.broadcast_to(x, tuple(int(s) for s in shape))


@op
def broadcast_tensors(xs):
    return tuple(torch.broadcast_tensors(*xs))


@op
def gather(x, index, axis=0):
    index = _as_index(index, x.device)
    if index.dim() == 0:
        index = index[None]
    axis = int(axis) % x.dim()
    out = torch.index_select(x, axis, index.reshape(-1))
    return out.reshape(*x.shape[:axis], *index.shape, *x.shape[axis + 1:])


@op
def gather_nd(x, index):
    index = _as_index(index, x.device)
    return x[tuple(torch.movedim(index, -1, 0))]


@op
def scatter(x, index, updates, overwrite=True):
    index = _as_index(index, x.device).reshape(-1)
    return x.index_put((index,), updates, accumulate=not overwrite)


@op
def scatter_nd_add(x, index, updates):
    index = _as_index(index, x.device)
    return x.index_put(tuple(torch.movedim(index, -1, 0)), updates,
                       accumulate=True)


@op
def index_select(x, index, axis=0):
    return torch.index_select(x, int(axis),
                              _as_index(index, x.device).reshape(-1))


@op
def index_sample(x, index):
    index = _as_index(index, x.device)
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, index]


@op
def index_add(x, index, axis, value):
    index = _as_index(index, x.device).reshape(-1)
    return torch.index_add(x, int(axis), index, value.to(x.dtype))


@op
def index_put(x, indices, value, accumulate=False):
    idx = tuple(_as_index(i, x.device) for i in indices)
    value = as_operand(value, x.dtype, x.device)
    return x.index_put(idx, value.to(x.dtype), accumulate=accumulate)


@op
def take_along_axis(x, indices, axis, broadcast=True):
    return torch.take_along_dim(x, _as_index(indices, x.device).long(),
                                dim=int(axis))


@op
def put_along_axis(x, indices, values, axis, reduce="assign"):
    axis = int(axis) % x.dim()
    indices = _as_index(indices, x.device).long()
    values = torch.broadcast_to(as_operand(values, device=x.device).to(
        x.dtype), indices.shape)
    if reduce == "add":
        return torch.scatter_add(x, axis, indices, values)
    if reduce in ("mul", "multiply"):
        return torch.scatter_reduce(x, axis, indices, values, "prod")
    return torch.scatter(x, axis, indices, values)


@op
def masked_select(x, mask):
    x, mask = torch.broadcast_tensors(x, mask)
    return x[mask]


@op
def masked_fill(x, mask, value):
    return torch.where(mask, as_operand(value, x.dtype, x.device), x)


@op
def masked_scatter(x, mask, value):
    mask = torch.broadcast_to(mask.bool(), x.shape)
    return x.masked_scatter(mask, value.reshape(-1).to(x.dtype))


# -- graph message passing (port of paddle_tpu/ops/graph_ops.py) ------------
def _segment(reduce_op, msgs, dst, n):
    dst = dst.long()
    shape = (n,) + tuple(msgs.shape[1:])
    if reduce_op == "sum":
        return torch.zeros(shape, dtype=msgs.dtype,
                           device=msgs.device).index_add(0, dst, msgs)
    if reduce_op == "mean":
        s = torch.zeros(shape, dtype=msgs.dtype,
                        device=msgs.device).index_add(0, dst, msgs)
        cnt = torch.zeros((n,), dtype=msgs.dtype, device=msgs.device
                          ).index_add(0, dst, torch.ones_like(dst,
                                                              dtype=msgs.dtype))
        return s / torch.clamp(cnt, min=1.0).reshape(
            (-1,) + (1,) * (msgs.ndim - 1))
    if reduce_op in ("min", "max"):
        idx = dst.reshape((-1,) + (1,) * (msgs.ndim - 1)).expand_as(msgs)
        out = torch.zeros(shape, dtype=msgs.dtype, device=msgs.device
                          ).scatter_reduce(0, idx, msgs, "a" + reduce_op,
                                           include_self=False)
        # empty segments are 0, as the JAX op fills them
        return torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    raise ValueError(f"unknown reduce_op {reduce_op!r}")


def _message(xs, e, message_op):
    if message_op == "add":
        return xs + e
    if message_op == "sub":
        return xs - e
    if message_op == "mul":
        return xs * e
    if message_op == "div":
        return xs / e
    raise ValueError(f"unknown message_op {message_op!r}")


@op
def graph_send_recv(x, src_index, dst_index, reduce_op="sum", out_size=0):
    src = _as_index(src_index, x.device).long()
    dst = _as_index(dst_index, x.device)
    n = int(out_size) if out_size else x.shape[0]
    return _segment(reduce_op, x[src], dst, n)


@op
def graph_send_ue_recv(x, y, src_index, dst_index, message_op="add",
                       reduce_op="sum", out_size=0):
    src = _as_index(src_index, x.device).long()
    dst = _as_index(dst_index, x.device)
    n = int(out_size) if out_size else x.shape[0]
    return _segment(reduce_op, _message(x[src], y, message_op), dst, n)


@op
def graph_send_uv(x, y, src_index, dst_index, message_op="add"):
    src = _as_index(src_index, x.device).long()
    dst = _as_index(dst_index, x.device).long()
    return _message(x[src], y[dst], message_op)


# ---------------------------------------------------------------------------
@op
def flip(x, axis):
    if isinstance(axis, int):
        axis = [axis]
    return torch.flip(x, dims=tuple(axis))


@op
def rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(x, k, dims=tuple(axes))


@op
def roll(x, shifts, axis=None):
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, dims=axis)


@op
def repeat_interleave(x, repeats, axis=None):
    if isinstance(repeats, torch.Tensor):
        repeats = repeats.to(x.device)
    return torch.repeat_interleave(x, repeats, dim=axis)


def _pad_index(n, lo, hi, mode, device):
    """Source positions of a dim padded by (lo, hi) in numpy's mode."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return i % n
    # reflect (no edge repeat), folded until in range
    period = 2 * (n - 1) if n > 1 else 1
    i = i % period
    return torch.where(i >= n, period - i, i)


@op
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):
    """paddle.nn.functional.pad semantics, as the JAX op reads ``pad``:
    per-dim (lo, hi) pairs in dim order when it covers every dim, else
    pairs for the trailing dims (NCHW ``[l, r, t, b]``: W then H)."""
    pad = [int(p) for p in pad]
    nd = x.dim()
    if len(pad) == 2 * nd:
        pairs = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        k = len(pad) // 2
        pairs = [(0, 0)] * (nd - k)
        for i in range(k):
            pairs.append((pad[2 * i], pad[2 * i + 1]))
        if k >= 2:
            tail = pairs[-k:]
            pairs = pairs[:-k] + tail[::-1]
    if mode == "constant":
        flat = []
        for lo, hi in reversed(pairs):
            flat += [lo, hi]
        return torch.nn.functional.pad(x, flat, mode="constant",
                                       value=value)
    np_mode = {"reflect": "reflect", "replicate": "edge",
               "circular": "wrap"}[mode]
    out = x
    for d, (lo, hi) in enumerate(pairs):
        if lo or hi:
            out = torch.index_select(
                out, d, _pad_index(x.shape[d], lo, hi, np_mode, x.device))
    return out


@op
def topk(x, k, axis=-1, largest=True, sorted=True):
    vals, idx = torch.topk(x, int(k), dim=int(axis), largest=largest,
                           sorted=True)
    return vals, idx


@op
def sort(x, axis=-1, descending=False):
    out = torch.sort(x, dim=axis, stable=True).values
    if descending:
        out = torch.flip(out, dims=(axis,))
    return out


@op
def argsort(x, axis=-1, descending=False):
    idx = torch.argsort(x, dim=axis, stable=True)
    if descending:
        idx = torch.flip(idx, dims=(axis,))
    return idx


@op
def searchsorted(sorted_sequence, values, out_int32=False, right=False):
    if not isinstance(values, torch.Tensor):
        values = torch.as_tensor(values, device=sorted_sequence.device)
    return torch.searchsorted(sorted_sequence,
                              values.to(sorted_sequence.dtype), right=right,
                              out_int32=bool(out_int32))


@op
def nonzero(x, as_tuple=False):
    if as_tuple:
        return tuple(torch.nonzero(x, as_tuple=True))
    return torch.nonzero(x)


@op
def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None):
    vals, inv, counts = torch.unique(x, sorted=True, return_inverse=True,
                                     return_counts=True, dim=axis)
    res = [vals]
    if return_index:
        n = x.numel() if axis is None else x.shape[axis]
        flat_inv = inv.reshape(-1)
        pos = torch.arange(flat_inv.numel(), device=x.device)
        first = torch.full((vals.shape[0] if axis is not None
                            else vals.numel(),), n, dtype=torch.int64,
                           device=x.device)
        res.append(first.scatter_reduce(0, flat_inv, pos, "amin"))
    if return_inverse:
        res.append(inv)
    if return_counts:
        res.append(counts)
    return tuple(res) if len(res) > 1 else vals


@op
def one_hot(x, num_classes):
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    n = int(num_classes)
    return (x[..., None] == torch.arange(n, device=x.device)).to(
        torch.float32)


@op
def numel(x):
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


@op
def shard_index(x, index_num, nshards, shard_id, ignore_value=-1):
    """Reference: paddle.shard_index (used by parallel cross entropy)."""
    shard_size = (index_num + nshards - 1) // nshards
    lo = shard_id * shard_size
    hi = lo + shard_size
    in_shard = (x >= lo) & (x < hi)
    return torch.where(in_shard, x - lo,
                       as_operand(ignore_value, x.dtype, x.device))


def _components(index):
    return index if isinstance(index, tuple) else (index,)


def _flip_negative_steps(x, index):
    """numpy-style ``x[index]`` where a slice steps backwards: torch takes
    no negative step, so each such dim is flipped first and its slice
    rewritten forwards. Returns (x, index, flipped dims)."""
    comps = list(_components(index))
    if not any(isinstance(c, slice) and c.step is not None and c.step < 0
               for c in comps):
        return x, index, ()

    def width(c):
        if c is None or c is Ellipsis:
            return 0
        if isinstance(c, torch.Tensor) and c.dtype == torch.bool:
            return c.dim()
        return 1

    n_ell = x.dim() - sum(width(c) for c in comps)
    d = 0
    flips = []
    for i, c in enumerate(comps):
        if c is Ellipsis:
            d += n_ell
            continue
        if isinstance(c, slice) and c.step is not None and c.step < 0:
            n = x.shape[d]
            start, stop, step = c.indices(n)
            count = len(range(start, stop, step))
            a = n - 1 - start
            comps[i] = slice(a, a + count * (-step), -step)
            flips.append(d)
        d += width(c)
    if flips:
        x = torch.flip(x, dims=tuple(flips))
    return x, tuple(comps), tuple(flips)


def _torch_index(index, device):
    if isinstance(index, list):
        # the JAX package's error: only a tuple indexes several dimensions
        raise TypeError("Using a non-tuple sequence for multidimensional "
                        "indexing is not allowed; use `arr[array(seq)]` "
                        "instead of `arr[seq]`")
    comps = []
    for c in _components(index):
        if isinstance(c, list):
            c = torch.as_tensor(c, device=device)
        elif isinstance(c, torch.Tensor):
            c = c.to(device)
        comps.append(c)
    return tuple(comps) if isinstance(index, tuple) else comps[0]


@op
def getitem(x, index):
    index = _torch_index(index, x.device)
    x, index, _ = _flip_negative_steps(x, index)
    return x[index]


@op
def setitem(x, value, index):
    index = _torch_index(index, x.device)
    value = as_operand(value, device=x.device).to(x.dtype)
    xf, index, flips = _flip_negative_steps(x, index)
    out = xf.clone()
    out[index] = value
    return torch.flip(out, dims=flips) if flips else out


@op
def as_strided(x, shape, stride, offset=0):
    """The JAX op's gather from the flattened tensor: element i of the
    result is flat[offset + sum(i_d * stride_d)]."""
    idx = torch.zeros(tuple(shape), dtype=torch.int64, device=x.device)
    for d, (n, s) in enumerate(zip(shape, stride)):
        r = torch.arange(int(n), device=x.device) * int(s)
        idx = idx + r.reshape([-1 if j == d else 1
                               for j in range(len(shape))])
    return x.reshape(-1)[offset + idx]


@op
def diff(x, n=1, axis=-1):
    return torch.diff(x, n=n, dim=axis)


@op
def bincount(x, weights=None, minlength=0):
    return torch.bincount(x.reshape(-1), weights=weights,
                          minlength=int(minlength))


@op
def histogram(x, bins=100, min=0, max=0):
    """jnp.histogram's counts: ``bins`` equal bins over [min, max] (the
    data's range when both are 0), the last bin closed, values outside
    dropped; float counts, as jnp gives them."""
    x = x.reshape(-1)
    if not x.is_floating_point():
        x = x.float()
    if min == 0 and max == 0:
        lo, hi = x.min().item(), x.max().item()
    else:
        lo, hi = float(min), float(max)
    bins = int(bins)
    edges = torch.linspace(lo, hi, bins + 1, dtype=x.dtype, device=x.device)
    idx = torch.searchsorted(edges, x, right=True)
    idx = torch.where(x == edges[-1], bins, idx)
    return torch.bincount(idx, minlength=bins + 2)[1:bins + 1].to(x.dtype)
