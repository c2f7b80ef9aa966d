"""Checks of the serving engine's bucketed step, shared by the CPU tests,
``tests/test_torch_card.py`` and ``chip_smoke.py``.

* :func:`padding_is_inert` — a step's packed rows and cache bytes are
  the same at its bucket width as at its exact token count (the CPU: on
  the card the two widths run other GEMM shapes, whose sums may round
  otherwise);
* :func:`replay_matches_eager` — a bucket's graph replay and an eager
  ``_device_step`` on the same input buffers give bit-identical packed
  rows and cache bytes (the same shapes and the same kernels, so no
  tolerance applies);
* :func:`record_step_sizes` and :func:`bucket_keys` — the step keys a
  run's step sizes round up to, which ``LLMEngine._seen_shapes`` must
  equal;
* :class:`SwapCheck` — wraps an engine's KV swapper from outside (no
  hook in the engine): the bytes of every block restored from the host
  pool against the bytes spilled, bit for bit, and the host wall time of
  each spill, fence and restore.

The first two start from the engine's caches as they are, and put them
back.
"""
from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["padding_is_inert", "replay_matches_eager", "record_step_sizes",
           "bucket_keys", "SwapCheck"]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8)


def _run(eng, fn):
    """``fn()``'s packed rows and the caches it leaves, from the engine's
    caches as they are now; the caches are restored after."""
    k0, v0 = eng._kcs.clone(), eng._vcs.clone()
    with torch.no_grad():
        packed = fn().clone()
    caches = (eng._kcs.clone(), eng._vcs.clone())
    eng._kcs.copy_(k0)
    eng._vcs.copy_(v0)
    return packed, caches


def _same(a, b) -> dict:
    (pa, (ka, va)), (pb, (kb, vb)) = a, b
    return {"packed": bool(torch.equal(_bits(pa), _bits(pb))),
            "key_cache": bool(torch.equal(_bits(ka), _bits(kb))),
            "value_cache": bool(torch.equal(_bits(va), _bits(vb)))}


def padding_is_inert(eng, reqs, arrays) -> dict:
    """The step of ``reqs`` on ``arrays`` (:meth:`LLMEngine._pack` at its
    bucket width) against the same step packed at its exact token count,
    both through ``_device_step`` eagerly: which of the packed rows of
    the live slots (the rows the engine fetches) and the two caches are
    bit-identical, and the two widths."""
    n_run = np.diff(arrays[2])[:len(reqs)].tolist()
    exact = eng._pack(reqs, n_run, int(sum(n_run)))
    dev = eng.device

    def step(arrs):
        return lambda: eng._device_step(
            *(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in arrs))[0][:len(reqs)]

    res = _same(_run(eng, step(arrays)), _run(eng, step(exact)))
    res["widths"] = [int(arrays[0].shape[0]), int(exact[0].shape[0])]
    return res


def replay_matches_eager(eng, key, arrays) -> dict:
    """The step of bucket ``key`` on ``arrays``: its graph replayed (on
    the CPU its eager run) against an eager ``_device_step`` on the same
    input buffers. Returns which of the packed rows and the two caches
    are bit-identical."""
    replay = _run(eng, lambda: eng._graphs.run(key, eng._device_step,
                                               arrays)[0])
    eager = _run(eng, lambda: eng._device_step(*eng._graphs.inputs(key))[0])
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    return _same(replay, eager)


def record_step_sizes(eng) -> list:
    """From now on, append the token count of every non-empty step that
    ``eng`` schedules to the returned list."""
    sizes = []
    schedule = eng.scheduler.schedule

    def recorded():
        batch = schedule()
        if not batch.is_empty:
            sizes.append(int(sum(batch.num_scheduled)))
        return batch

    eng.scheduler.schedule = recorded
    return sizes


def bucket_keys(eng, sizes) -> set:
    """The ``("ragged", T, S)`` keys of steps of ``sizes`` tokens: each
    at the engine's bucket for it."""
    return {("ragged", eng._bucket(n), eng.cfg.max_num_seqs) for n in sizes}


class SwapCheck:
    """Wrap ``eng._swapper``'s ``copy_out``, ``fence`` and ``copy_in``
    (instance attributes over its methods; :meth:`close` takes them
    away). At each spill, a device copy of the victim's blocks as the
    cache holds them — enqueued on the step's stream ahead of the spill,
    so no synchronisation — and at each restore, the restored blocks
    against it, bit for bit. Records the host wall ms of every call
    (``copy_in``'s includes its ``fence``), the bytes spilled, and the
    restores that differed (``mismatches``, request ids)."""

    def __init__(self, eng):
        self._sw = sw = eng._swapper
        kcs, vcs = eng._kcs, eng._vcs
        self.ms = {"copy_out": [], "fence": [], "copy_in": []}
        self.spilled_bytes = 0
        self.restored = 0
        self.mismatches = []
        pending = {}
        copy_out, fence, copy_in = sw.copy_out, sw.fence, sw.copy_in

        def timed(name, fn, *args):
            t = time.perf_counter()
            fn(*args)
            self.ms[name].append((time.perf_counter() - t) * 1e3)

        def checked_out(request, dev_table, host_table):
            dev = torch.as_tensor(dev_table[:len(host_table)],
                                  device=kcs.device)
            want = (kcs[:, dev].clone(), vcs[:, dev].clone())
            timed("copy_out", copy_out, request, dev_table, host_table)
            pending[request.request_id] = want
            self.spilled_bytes += sum(t.numel() * t.element_size()
                                      for t in want)

        def checked_in(request, host_table, dev_table):
            timed("copy_in", copy_in, request, host_table, dev_table)
            dev = torch.as_tensor(dev_table, device=kcs.device)
            want = pending.pop(request.request_id)
            got = (kcs[:, dev], vcs[:, dev])
            if not all(torch.equal(_bits(a), _bits(b))
                       for a, b in zip(want, got)):
                self.mismatches.append(request.request_id)
            self.restored += 1

        sw.copy_out = checked_out
        sw.fence = lambda: timed("fence", fence)
        sw.copy_in = checked_in

    def close(self):
        """Unwrap the swapper (the wrappers and the swapper refer to each
        other)."""
        for name in ("copy_out", "fence", "copy_in"):
            self._sw.__dict__.pop(name, None)
        self._sw = None
