"""A fixed-shape step captured as CUDA graphs (the port's counterpart of
``paddle_tpu/jit/trace.py::functionalize``).

The JAX package jit-compiles a step once per input shape and replays the
compiled program; a shape it has not seen costs a compile. Here a step
function of fixed-shape tensors is captured once per shape key as a
``torch.cuda.CUDAGraph`` and replayed: one launch on the host for the
thousands of kernels of a serving step.

:class:`StepGraphs` owns, per key, the step's static input buffers (the
graph reads them at fixed addresses), its static outputs and its graph:

* :meth:`StepGraphs.run` copies the step's host arrays into the key's
  input buffers — one host-to-device copy from one pinned staging
  buffer — replays the graph and returns the outputs. The first use of
  a key runs the step eagerly once on a side stream (the warm-up: it
  loads the kernel libraries and sets their launch attributes), then
  captures it. All graphs of one :class:`StepGraphs`, and of every other
  one built with the same ``pool``, share one memory pool: they replay
  one at a time on one stream, and every output stays referenced.
* On the CPU there is no graph: :meth:`StepGraphs.run` calls the step
  eagerly on the same padded buffers.
* Neither device has a silent eager path: a capture or a replay that
  fails on the card raises.

The step function is passed to each :meth:`StepGraphs.run`, not held:
a step that is a bound method of its owner would otherwise tie the owner
and its graphs in a reference cycle, and free them only when the garbage
collector runs. Anything the step reads that is not an input buffer
(weights, caches, a tiered engine's host-tier mirror, tables) is baked
into the graph by address, and must never be reallocated while the graph
lives. The step must not
synchronise with the host (no ``.item()``, ``.tolist()``, ``nonzero`` or
data-dependent shapes) and must not change its inputs.

A kernel wrapper counts its launches where it makes them, which under
capture is once per capture and never per replay. So :class:`StepGraphs`
reads the owner's launch counter around each capture, records the
launches each capture made, and :meth:`StepGraphs.since` reports the
launches the card ran through it: the eager warm-ups plus
``captured × replays``.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass
from typing import Callable, Dict, Hashable, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["StepGraphs"]

_ALIGN = 16   # byte alignment of every input buffer inside the block


def _delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


@dataclass
class _Entry:
    """One shape key: the input buffers (views into ``block``), where each
    lies in it, the outputs and the graph (None on the CPU)."""

    block: torch.Tensor
    inputs: List[torch.Tensor]
    layout: List[tuple]          # (offset, nbytes, shape, numpy dtype)
    outputs: object = None
    graph: Optional[object] = None
    nbytes: int = 0


class StepGraphs:
    """Per shape key, a step ``fn(*inputs) -> outputs`` captured as a CUDA
    graph on ``device`` (run eagerly on the CPU).

    ``fn`` (given to :meth:`run`) takes one tensor per host array given
    with it, in that order, with the arrays' shapes and dtypes, and
    returns a tensor or a tuple of tensors. ``counters``: a function that
    returns the kernel launch counts by name as they stand (default: no
    counts), read before and after each capture. ``pool``: a
    ``torch.cuda.graph_pool_handle()`` to share with other
    :class:`StepGraphs` (default: a new one). :meth:`since` reports what
    it did."""

    def __init__(self, device, counters: Optional[
            Callable[[], Dict[str, int]]] = None, pool=None):
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        if self.on_card and pool is None:
            pool = torch.cuda.graph_pool_handle()
        self.pool = pool
        self._counters = counters or dict
        self._entries: Dict[Hashable, _Entry] = {}
        # per key captured: seconds, bytes kept, launches of one replay
        self._capture_s: Dict[Hashable, float] = {}
        self._capture_bytes: Dict[Hashable, int] = {}
        self._captured: Dict[Hashable, Dict[str, int]] = {}
        self._replays: Dict[Hashable, int] = {}
        self._executed: Dict[str, int] = {}    # launches the card ran
        self._stage: Optional[torch.Tensor] = None   # pinned, host -> card
        self._staged = None                          # its last copy's event
        self._host_out: Optional[torch.Tensor] = None  # pinned, card -> host

    @property
    def keys(self) -> List[Hashable]:
        return list(self._entries)

    def inputs(self, key) -> List[torch.Tensor]:
        """The key's static input buffers."""
        return self._entries[key].inputs

    def outputs(self, key):
        """The key's static outputs (on the card, what the last replay
        wrote)."""
        return self._entries[key].outputs

    def run(self, key: Hashable, fn: Callable,
            arrays: Sequence[np.ndarray]):
        """Fill the key's inputs from ``arrays`` and run the step: replay
        its graph (capturing ``fn`` at the key's first use) on the card,
        call ``fn`` on the CPU. Returns the outputs."""
        arrays = [np.ascontiguousarray(a) for a in arrays]
        entry = self._entries.get(key)
        if entry is None:
            entry = self._new_entry(arrays)
            self._fill(entry, arrays)
            if self.on_card:
                self._capture(key, fn, entry)
            self._entries[key] = entry
            self._replays[key] = 0
        else:
            self._fill(entry, arrays)
        if self.on_card:
            entry.graph.replay()
            for name, n in self._captured[key].items():
                self._executed[name] = self._executed.get(name, 0) + n
        else:
            entry.outputs = fn(*entry.inputs)
        self._replays[key] += 1
        return entry.outputs

    def snapshot(self) -> dict:
        """The records as they are now, for :meth:`since`."""
        return {"captured": set(self._capture_s),
                "replays": dict(self._replays),
                "executed": dict(self._executed)}

    def since(self, snap: Optional[dict] = None) -> dict:
        """What this object did since ``snap`` (default: since it was
        built), keys named ``"x".join(key[1:])``: the keys captured, with
        their ``capture_s``, ``capture_bytes`` (device memory still
        allocated after the capture that was not before it: the outputs
        and whatever the graph keeps) and ``captured_launches`` (the
        kernel launches one replay runs, by counter); the ``replays`` per
        key (graph replays on the card, eager runs on the CPU); the
        ``replayed_launches`` (captured x replays, by counter); and the
        ``executed_launches``, every launch the card ran through this
        object (the replays' plus the captures' eager warm-ups)."""
        snap = snap or {"captured": set(), "replays": {}, "executed": {}}

        def name(key):
            return "x".join(map(str, key[1:]))

        new = [k for k in self._capture_s if k not in snap["captured"]]
        replays = {k: n - snap["replays"].get(k, 0)
                   for k, n in self._replays.items()
                   if n != snap["replays"].get(k, 0)}
        replayed: Dict[str, int] = {}
        for k, n in replays.items():
            for counter, m in self._captured.get(k, {}).items():
                replayed[counter] = replayed.get(counter, 0) + m * n
        return {"captures": len(new),
                "capture_s": {name(k): self._capture_s[k] for k in new},
                "capture_bytes": {name(k): self._capture_bytes[k]
                                  for k in new},
                "captured_launches": {name(k): self._captured[k]
                                      for k in new},
                "replays": {name(k): n for k, n in replays.items()},
                "replayed_launches": replayed,
                "executed_launches": _delta(self._executed,
                                            snap["executed"])}

    def fetch(self, t: torch.Tensor) -> np.ndarray:
        """``t`` on the host as a numpy copy: on the card one copy through
        a pinned buffer, waited for."""
        if not self.on_card:
            return t.numpy().copy()
        t = t.contiguous()
        n = t.numel() * t.element_size()
        if self._host_out is None or self._host_out.numel() < n:
            self._host_out = torch.empty((max(n, 1),), dtype=torch.uint8,
                                         pin_memory=True)
        dst = self._host_out[:n].view(t.dtype).view(t.shape)
        dst.copy_(t, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return dst.numpy().copy()

    # -- internals ------------------------------------------------------
    def _new_entry(self, arrays) -> _Entry:
        layout, off = [], 0
        for a in arrays:
            layout.append((off, a.nbytes, a.shape, a.dtype))
            off += -(-a.nbytes // _ALIGN) * _ALIGN
        block = torch.zeros((max(off, _ALIGN),), dtype=torch.uint8,
                            device=self.device)
        inputs = [block[o:o + nb].view(torch.from_numpy(
            np.empty((0,), dt)).dtype).view(shape)
            for o, nb, shape, dt in layout]
        return _Entry(block=block, inputs=inputs, layout=layout, nbytes=off)

    def _fill(self, entry: _Entry, arrays):
        if len(arrays) != len(entry.layout) or any(
                a.shape != shape or a.dtype != dt
                for a, (_, _, shape, dt) in zip(arrays, entry.layout)):
            raise ValueError(
                "step arrays do not match the key's buffers: got "
                f"{[(a.shape, a.dtype) for a in arrays]}, want "
                f"{[(shape, dt) for _, _, shape, dt in entry.layout]}")
        if not self.on_card:
            host = entry.block.numpy()
        else:
            if self._staged is not None:
                self._staged.synchronize()   # the last copy read the stage
            if self._stage is None or self._stage.numel() < entry.nbytes:
                self._stage = torch.empty((entry.block.numel(),),
                                          dtype=torch.uint8, pin_memory=True)
            host = self._stage.numpy()
        for a, (o, nb, _, _) in zip(arrays, entry.layout):
            host[o:o + nb] = a.reshape(-1).view(np.uint8)
        if self.on_card:
            n = entry.nbytes
            entry.block[:n].copy_(self._stage[:n], non_blocking=True)
            self._staged = torch.cuda.Event()
            self._staged.record(torch.cuda.current_stream(self.device))

    def _capture(self, key, fn, entry: _Entry):
        dev = self.device
        t0 = time.perf_counter()
        before = self._counters()
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            fn(*entry.inputs)             # warm-up, eager
        main.wait_stream(side)
        torch.cuda.synchronize(dev)
        warm = self._counters()
        # a dead graph or pinned buffer that the garbage collector frees
        # inside the capture would free device or pinned memory there, an
        # illegal call that invalidates the capture: collect now, and not
        # during it
        gc.collect()
        held = torch.cuda.memory_allocated(dev)
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            # "thread_local": the capturing thread stays barred from
            # unsafe calls, as in the default "global" mode, but other
            # threads are not. The serving watchdog's prober may wait on
            # an earlier step's event, and its monitor may query one,
            # at any moment; in "global" mode such a call during a
            # capture would invalidate it. A precaution: the prober is
            # normally idle by then (the step before synchronised)
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                entry.outputs = fn(*entry.inputs)
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize(dev)
        entry.graph = graph
        self._capture_s[key] = time.perf_counter() - t0
        self._capture_bytes[key] = torch.cuda.memory_allocated(dev) - held
        self._captured[key] = _delta(self._counters(), warm)
        for name, n in _delta(warm, before).items():
            self._executed[name] = self._executed.get(name, 0) + n
