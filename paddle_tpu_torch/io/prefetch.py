"""The device-resident input pipeline (port of ``paddle_tpu/io/prefetch.py``).

``DevicePrefetcher`` wraps an iterable of batches and hands each one to
the consumer with its arrays already on the device:

* **Overlap**: a background thread pulls batches from the host loader
  and stages each one ``depth`` batches ahead, so that by the time the
  train loop asks for batch N its tensors are on the card.
* **Coalescing**: the array leaves of a batch that share a dtype are
  packed into ONE pinned host buffer and go over in ONE host-to-device
  copy on a side CUDA stream; the device buffer is then cut into the
  leaves as views (a ``split`` and a ``view``: no kernel), where the JAX
  package slices it with a jitted program.
* **Streams**: the copy's event is waited for on the copy thread, so the
  pinned buffer is free to go once the batch is queued; the consumer's
  stream waits on the event, and each device buffer is marked as used
  on the consumer's stream (``record_stream``), so the caching allocator
  does not hand its memory to the next copy while the consumer's kernels
  may still read it.

On the CPU (``device="cpu"``) a batch is packed the same way into one
buffer per dtype, with no stream. ``transfers`` counts the staged copies
(one per dtype per batch; one per leaf with ``coalesce=False``).

Leaves that are not arrays (strings, Python scalars, objects) pass
through untouched, as on the plain loader path. A numpy array of an
extended float dtype (ml_dtypes' ``bfloat16``, known by its dtype name)
lands as a torch tensor of that dtype. Dtypes are kept as they come:
torch has 64-bit integers, where the JAX package canonicalises int64 to
int32. ``mesh``/``placements`` (sharded placement) come with slice D.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable

import numpy as np
import torch

from paddle_tpu_torch.core.device import resolve_device

__all__ = ["DevicePrefetcher", "prefetch_to_device"]


def _flatten(x, leaves):
    """Leaves of a tree of tuples, lists and dicts, and a function that
    builds the same tree from a new list of leaves."""
    if isinstance(x, (list, tuple)):
        subs = [_flatten(v, leaves) for v in x]
        kind = type(x)
        return lambda it: kind(s(it) for s in subs)
    if isinstance(x, dict):
        subs = {k: _flatten(v, leaves) for k, v in x.items()}
        return lambda it: {k: s(it) for k, s in subs.items()}
    leaves.append(x)
    return lambda it: next(it)


def _to_host(leaf, device):
    """An array leaf as a CPU tensor of its own dtype; ``leaf`` itself
    when it is a tensor on ``device`` already; None for a leaf that is
    not an array (it passes through)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.device == device:
            return leaf
        return leaf.detach().cpu()
    if not isinstance(leaf, (np.ndarray, np.generic)):
        return None
    a = np.asarray(leaf, order="C")
    dt = a.dtype
    if dt.kind == "V" and dt.names is None:
        # an extended float (ml_dtypes' bfloat16, fp8): torch's own dtype
        # of that name and width, from the raw bits
        tdt = getattr(torch, dt.name, None)
        if not isinstance(tdt, torch.dtype) or \
                torch.empty((), dtype=tdt).element_size() != dt.itemsize:
            return None
        raw = torch.from_numpy(a.view(np.dtype(f"uint{dt.itemsize * 8}")))
        return raw.view(tdt)
    if dt.kind not in "biufc":
        return None
    return torch.from_numpy(a)


class DevicePrefetcher:
    """Wraps an iterable of batches (trees of numpy arrays and tensors)
    and yields the same trees with every array leaf a tensor on
    ``device``, staged ``depth`` batches ahead on a background thread.
    ``device`` goes through ``resolve_device``: the card by default."""

    def __init__(self, loader: Iterable, depth: int = 2, *,
                 mesh=None, placements=None, device=None,
                 coalesce: bool = True):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        if mesh is not None or placements is not None:
            raise NotImplementedError(
                "DevicePrefetcher(mesh=, placements=) is not ported yet; "
                "mesh placement comes with slice D")
        self._loader = loader
        self._depth = depth
        self._coalesce = coalesce
        self._device = resolve_device(device)
        self.batches = 0      # batches staged
        self.transfers = 0    # staged copies (one per dtype per batch)

    def __len__(self):
        return len(self._loader)

    def _stage(self, batch, stream):
        """(tree with tensors on the device, device buffers, event)."""
        leaves = []
        build = _flatten(batch, leaves)
        out = list(leaves)
        groups = {}
        for i, leaf in enumerate(leaves):
            h = _to_host(leaf, self._device)
            if h is None or h.device == self._device and \
                    self._device.type == "cuda":
                continue            # not an array, or on the card already
            key = h.dtype if self._coalesce else i
            groups.setdefault(key, []).append((i, h))
        on_card = self._device.type == "cuda"
        bufs = []
        for members in groups.values():
            dtype = members[0][1].dtype
            sizes = [h.numel() for _, h in members]
            host = torch.empty((sum(sizes),), dtype=dtype,
                               pin_memory=on_card)
            off = 0
            for (_, h), n in zip(members, sizes):
                host[off:off + n].copy_(h.reshape(-1))
                off += n
            if on_card:
                with torch.cuda.stream(stream):
                    dev = host.to(self._device, non_blocking=True)
                bufs.append(dev)
            else:
                dev = host
            self.transfers += 1
            for (i, h), part in zip(members, dev.split(sizes)):
                out[i] = part.view(h.shape)
        event = None
        if on_card:
            event = torch.cuda.Event()
            event.record(stream)
            event.synchronize()   # the pinned buffers may go now
        self.batches += 1
        return build(iter(out)), bufs, event

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self._depth)
        stop = threading.Event()
        on_card = self._device.type == "cuda"

        def producer():
            try:
                stream = None
                if on_card:
                    torch.cuda.set_device(self._device)
                    stream = torch.cuda.Stream(self._device)
                for batch in self._loader:
                    if stop.is_set():
                        return
                    item = ("ok", self._stage(batch, stream))
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
                payload = ("end", None)
            except BaseException as e:  # propagate to the consumer
                payload = ("err", e)
            while not stop.is_set():
                try:
                    q.put(payload, timeout=0.1)
                    return
                except queue.Full:
                    continue

        t = threading.Thread(target=producer, daemon=True,
                             name="DevicePrefetcher")
        t.start()
        try:
            while True:
                kind, item = q.get()
                if kind == "end":
                    return
                if kind == "err":
                    raise item
                tree, bufs, event = item
                if on_card:
                    cur = torch.cuda.current_stream(self._device)
                    cur.wait_event(event)
                    for b in bufs:
                        b.record_stream(cur)
                del item, bufs, event
                yield tree
        finally:
            # deterministic shutdown: an abandoned iterator must not
            # leave the producer mid-copy at interpreter teardown
            stop.set()
            t.join(timeout=10.0)


def prefetch_to_device(loader: Iterable, depth: int = 2, *,
                       mesh=None, placements=None, device=None,
                       coalesce: bool = True) -> DevicePrefetcher:
    """Wrap ``loader`` so its batches arrive on the device ``depth``
    steps ahead of consumption (see :class:`DevicePrefetcher`)."""
    return DevicePrefetcher(loader, depth, mesh=mesh,
                            placements=placements, device=device,
                            coalesce=coalesce)
