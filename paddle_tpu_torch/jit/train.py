"""TrainStep: one training step (port of ``paddle_tpu/jit/train.py``).

The JAX package compiles forward, backward and the optimizer update into
one XLA executable and donates the state buffers. PyTorch runs the same
step eagerly: forward and loss, the loss scaled by the ``scaler``'s
device state before ``backward()``, unscale and check (``found_inf``),
the ``skip_nonfinite`` guard (checked after unscaling, before
clipping), the clip the optimizer carries
(``optimizer._grad_clip.clip_fn``), and the optimizer's rule applied
unless ``found_inf`` or the guard skips it. As in the JAX step, only the
``skip_nonfinite`` guard rolls the device step back, a ``found_inf``
skip does not, and the scaler's schedule is never rolled back.

The step's carry lives on the device and is only ever written in place:
the bias-correction step, the count of skipped steps, the scaler's
5-wide state and the lr, a 0-dim f32 tensor (the JAX step's lr array),
refilled only when ``optimizer.get_lr()`` changes. The Python
``GradScaler`` is synced from the device state once per call or
dispatch (one host read), so its divergence guard raises there.
``optimizer._step_count`` is the host mirror.

``donate=True`` (default) applies the rule IN PLACE; ``donate=False``
binds every new parameter value and slot as a new tensor, so a tensor
taken from a parameter or slot before a step keeps its values. The
numerics of the two are bit-identical.

:meth:`TrainStep.run_steps` runs k steps in one dispatch. On the card the
step is captured once per key (the microbatch's shapes and dtypes and
``n_model_inputs``) as a CUDA graph and replayed k times, with no host
read between replays: PyTorch's whole-network recipe (the key's first
step runs eagerly on a side stream as the warm-up, then the capture into
a private memory pool with every ``.grad`` None and the collector off).
The graph reads the state at fixed addresses: under ``donate=True`` the
live parameters and slots themselves (a tensor rebound by the user or a
restore is copied back into them before the next replay); under
``donate=False`` buffers of its own, which take the live state before
the replays and hand new tensors back after them (two copies per tensor
per dispatch). On the CPU ``run_steps`` runs the k steps eagerly.

The model is a ``torch.nn.Module`` or a port ``nn.Layer``. A Layer's
parameters and buffers are lifted in the JAX step's order
(``named_parameters()``, then ``named_buffers()``); the trainable ones
are those with ``stop_gradient`` False; the step calls the Layer on
Tensors and ``loss_fn`` on its Tensor outputs and the label Tensors.
Every parameter and buffer keeps one torch tensor for the step's life
(the address a captured graph reads): a Tensor rebound since the last
step (``set_value``, ``set_state_dict``, a forward that rebinds
BatchNorm's running stats) is copied back into it, so a restore lands
where the graph reads and a buffer's new value is threaded to the next
step, as the JAX step's ``new_buffers`` are (rolled back on a step the
``skip_nonfinite`` guard skips).

Randomness: as in the JAX step, the construction takes ONE key from the
default generator and keeps it on the device as the chain, a ``(2,)``
uint32 pair. Each step splits it (``chain, key = split(chain)``, the
chain written back in place, on a skipped step too) and runs the forward
under :func:`~paddle_tpu_torch.core.generator.device_key_stream` seeded
by ``key``, so each draw of the forward (dropout, ...) splits the step
key once more, in call order, and the generator's counter does not move.
Every mask is a pure device function of the chain, so ``run_steps(k)``
draws the masks of k ``__call__``s.

Refused at construction: ``sharding`` and ``accumulate_steps > 1``,
which the JAX step accepts and never reads (sharded training is
:class:`paddle_tpu_torch.distributed.ParallelTrainStep`, which shares
this step's body through the hooks ``_place``, ``_forward``, ``_sync``,
``_agree``, ``_clip``, ``_update`` and ``_new_slots``).
The JAX step's SOT graph-break path has nothing to port: eager PyTorch
runs data-dependent Python as it is.

Each call and each ``run_steps`` dispatch arms the default step watchdog
(``TrainStep#<step>``; a step of new batch shapes with the
COMPILE_ALLOWANCE deadline) and attaches a CUDA event recorded after it,
as the JAX step does (a no-op without ``PADDLE_STEP_TIMEOUT``).
"""
from __future__ import annotations

import contextlib
import gc
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch import amp as _amp
from paddle_tpu_torch import profiler as _prof
from paddle_tpu_torch.core import generator as gen
from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.jit.trace import _delta
from paddle_tpu_torch.ops import threefry

__all__ = ["TrainStep", "nonfinite_any"]


def nonfinite_any(loss, grads: List[torch.Tensor]) -> torch.Tensor:
    """0-dim bool tensor: the loss or any gradient holds a NaN/Inf."""
    nf = ~torch.isfinite(loss).all()
    for g in grads:
        nf = nf | ~torch.isfinite(g).all()
    return nf


def install_nonfinite_observability(step, optimizer) -> str:
    """A ``train_step/nonfinite_skipped#<id>`` counter provider over the
    step's ``skipped_steps`` (weakref'd, unregistered when the step
    dies), and ``optimizer._applied_step_provider`` returning the
    device-APPLIED step (a skipped step rolls the device step back, and
    a restore must not jump bias correction ahead by the skips).
    Returns the counter name."""
    ref = weakref.ref(step)
    cname = f"train_step/nonfinite_skipped#{id(step)}"
    _prof.register_counter_provider(
        cname, lambda: (None if ref() is None else ref().skipped_steps))
    weakref.finalize(step, _prof.unregister_counter_provider, cname)
    optimizer._applied_step_provider = (
        lambda: None if ref() is None else int(ref()._step.item()))
    return cname


class _Graph:
    """One captured step: its static inputs, its loss output, the graph."""

    def __init__(self, inputs, loss, graph):
        self.inputs = inputs
        self.loss = loss
        self.graph = graph


class TrainStep:
    """``step(*batch)`` runs one optimizer step of ``model`` under
    ``loss_fn(model_outputs..., labels...)`` and returns the loss (a
    detached 0-dim tensor on the model's device). The batch (tensors,
    Tensors or numpy arrays) is moved to the model's device first. By
    default the model takes one input and the rest are labels."""

    def __init__(self, model, loss_fn: Callable, optimizer,
                 accumulate_steps: int = 1, sharding=None, scaler=None,
                 donate: bool = True, skip_nonfinite: bool = False):
        if sharding is not None:
            raise NotImplementedError(
                f"TrainStep(sharding={sharding!r}) is refused: the JAX "
                f"package's TrainStep stores the argument and never reads "
                f"it; sharded training is distributed.ParallelTrainStep")
        if accumulate_steps > 1:
            raise NotImplementedError(
                f"TrainStep(accumulate_steps={accumulate_steps}) is "
                f"refused: the JAX package's TrainStep takes the argument "
                f"and never reads it, so there is no accumulation to port")
        from paddle_tpu_torch.nn.layer import Layer

        self._model = model
        self._loss_fn = loss_fn
        self._opt = optimizer
        self._donate = bool(donate)
        self._skip_nonfinite = bool(skip_nonfinite)
        self._is_layer = isinstance(model, Layer)
        # a Layer's Tensors, each with the one torch tensor the step
        # keeps for it: the parameters (named_parameters order), then the
        # buffers
        self._held: List[Tuple[Tensor, torch.Tensor]] = []
        self._buffers: List[Tuple[Tensor, torch.Tensor]] = []
        if self._is_layer:
            named = [(n, p._data) for n, p in model.named_parameters()]
            self._params = [p._data for _, p in model.named_parameters()
                            if not p.stop_gradient]
            self._buffers = [(b, b._data) for _, b in model.named_buffers()]
            self._held = [(p, p._data) for _, p in model.named_parameters()
                          ] + self._buffers
        else:
            named = list(model.named_parameters())
            self._params = [p for _, p in named if p.requires_grad]
        if optimizer._parameter_list is None:
            optimizer._parameter_list = list(self._params)
        for name, p in named:
            optimizer._model_names.setdefault(id(p), name)
        for p in self._params:   # slots up front, as the JAX step does
            if id(p) not in optimizer._slots:
                optimizer._slots[id(p)] = self._new_slots(p)
        self._device = self._params[0].device
        # the device carry, written only in place (captured graphs hold
        # these addresses): the applied step (bias correction), the
        # skips, the lr
        self._step = torch.tensor(float(optimizer._step_count),
                                  device=self._device)
        self._nskip = torch.zeros((), device=self._device)
        self._lr = torch.zeros((), device=self._device)
        # the rng chain: one key of the default generator, split on the
        # device each step
        self._chain = torch.tensor(gen.default_generator.next_key(),
                                   dtype=torch.int64, device=self._device)
        self._lr_val: Optional[float] = None
        self._host_step_mirror = optimizer._step_count
        self._scaler = scaler if scaler is not None and scaler.is_enable() \
            else None
        self._scaler_state = _amp.scaler_init_state(self._scaler,
                                                    self._device)
        if self._skip_nonfinite:
            install_nonfinite_observability(self, optimizer)
        # run_steps on the card: graphs per key, the state they read, and
        # what they did
        self._graphs: Dict[tuple, _Graph] = {}
        self._pool = None
        self._bufs: Optional[List[torch.Tensor]] = None
        self._capture_s: Dict[str, float] = {}
        self._captured: Dict[str, Dict[str, int]] = {}
        self._replays: Dict[str, int] = {}
        self._executed: Dict[str, int] = {}

    @property
    def skipped_steps(self) -> int:
        """Steps the ``skip_nonfinite`` guard turned into identity
        updates (reading it waits for the last step)."""
        return int(self._nskip.item())

    def _sync_step_carry(self):
        """Re-seed the device step if the optimizer's counter was changed
        from outside (a restored state)."""
        if self._opt._step_count != self._host_step_mirror:
            self._step.fill_(float(self._opt._step_count))
            self._host_step_mirror = self._opt._step_count

    def _sync_lr(self):
        """Refill the device lr when the optimizer's changed (the f32
        value the JAX step's lr array holds)."""
        lr = float(np.float32(self._opt.get_lr()))
        if lr != self._lr_val:
            self._lr.fill_(lr)
            self._lr_val = lr

    @torch.no_grad()
    def _adopt(self):
        """Copy each Layer Tensor rebound since the last step back into
        the torch tensor the step holds for it, and rebind it there."""
        for t, fixed in self._held:
            if t._data is not fixed:
                fixed.copy_(t._data)
                t._data = fixed
        if self._held:
            self._opt._follow_wrappers()

    def _loss(self, datas, n_inputs: int):
        """The forward under the step's key stream (a Layer on Tensors),
        then the loss, as a torch tensor."""
        pair = threefry.split(self._chain)
        self._chain.copy_(pair[0])
        wrap = Tensor._from_data if self._is_layer else (lambda d: d)
        with gen.device_key_stream(pair[1]):
            out = self._forward(*map(wrap, datas[:n_inputs]))
        outs = out if isinstance(out, tuple) else (out,)
        loss = self._loss_fn(*outs, *map(wrap, datas[n_inputs:]))
        return loss._data if isinstance(loss, Tensor) else loss

    # -- what a sharded step (distributed.ParallelTrainStep) overrides -------
    def _new_slots(self, p) -> dict:
        """A trainable parameter's optimizer slots."""
        return self._opt._init_slots_mp(p)

    def _place(self, batch, lead: int = 0) -> List[torch.Tensor]:
        """The batch as tensors on the model's device (``lead``: the
        leading dims before the batch dim, 1 for a stack of
        microbatches)."""
        return [_as_data(b).to(self._device, non_blocking=True)
                for b in batch]

    def _captures(self) -> bool:
        """Whether ``run_steps`` captures its steps (on the card)."""
        return self._device.type == "cuda"

    def _forward(self, *inputs):
        return self._model(*inputs)

    def _sync(self, grads, loss):
        """The gradients and the loss the update sees (one rank: as
        they are)."""
        return grads, loss

    def _agree(self, flag: torch.Tensor) -> torch.Tensor:
        """A 0-dim bool every rank takes alike (one rank: as it is)."""
        return flag

    def _clip(self, grads):
        clip_fn = getattr(self._opt._grad_clip, "clip_fn", None)
        return grads if clip_fn is None else clip_fn(grads)

    def _update(self, grads, step, skip, inplace: bool):
        self._opt._apply(self._params, grads, self._lr, step, skip=skip,
                         cast_grads=False, inplace=inplace)

    @torch.no_grad()
    def _thread_buffers(self, rollback):
        """A buffer the forward rebound lands in its held tensor (the
        old value where ``rollback`` is set)."""
        for b, fixed in self._buffers:
            new = b._data
            if new is fixed:
                continue
            if rollback is not None:
                new = torch.where(rollback, fixed, new)
            fixed.copy_(new)
            b._data = fixed

    def _body(self, datas, n_inputs: int, inplace: bool):
        """One step on device tensors; returns the detached loss. No host
        read and no rebinding of the carry: it runs under capture."""
        state = self._scaler_state
        for p in self._params:
            p.grad = None
        loss = self._loss(datas, n_inputs)
        # loss scaling happens BEFORE backward (fp16 underflow)
        (loss if state is None else loss * state[0]).backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self._params]
        for p in self._params:
            p.grad = None
        grads, loss = self._sync(grads, loss.detach())

        step = self._step + 1
        found_inf = new_state = None
        if state is not None:
            grads, found_inf = _amp.scaler_unscale_and_check(grads, state)
            found_inf = self._agree(found_inf)
            new_state = _amp.scaler_update_state(self._scaler, state,
                                                 found_inf)
        nonfinite = (self._agree(nonfinite_any(loss, grads))
                     if self._skip_nonfinite else None)
        grads = self._clip(grads)
        skip = found_inf
        if nonfinite is not None:
            skip = nonfinite if skip is None else skip | nonfinite
        self._update(grads, step, skip, inplace)
        if nonfinite is not None:
            # only the guard rolls the step and the buffers back; a
            # found_inf skip and the scaler's schedule are never rolled
            # back
            self._nskip.add_(nonfinite.float())
            step = torch.where(nonfinite, step - 1, step)
        self._thread_buffers(nonfinite)
        self._step.copy_(step)
        if new_state is not None:
            self._scaler_state.copy_(new_state)
        return loss

    def _sync_scaler(self):
        if self._scaler_state is not None:
            _amp.scaler_sync_from_state(self._scaler, self._scaler_state)

    # -- the step watchdog (a no-op without PADDLE_STEP_TIMEOUT) -----------
    def _wd_tag(self) -> str:
        return f"TrainStep#{self._opt._step_count}"

    @contextlib.contextmanager
    def _watched(self, datas):
        """Arm the default watchdog around the step run inside (a step of
        new batch shapes, the first, which warms up or captures, with the
        COMPILE_ALLOWANCE deadline); attach a CUDA event recorded after
        it; disarm on a failed dispatch."""
        from paddle_tpu_torch.distributed.watchdog import (
            arm_step, attach_step, default_watchdog, step_done)

        shapes = tuple((tuple(d.shape), str(d.dtype)) for d in datas)
        warm = self.__dict__.setdefault("_wd_warm", set())
        eid = arm_step(self._wd_tag(), cold=shapes not in warm)
        warm.add(shapes)
        try:
            yield
        except BaseException:
            default_watchdog().disarm(eid)
            raise
        if eid:
            attach_step(eid, step_done(self._device))

    def __call__(self, *batch, n_model_inputs: Optional[int] = None):
        n_inputs = 1 if n_model_inputs is None else n_model_inputs
        datas = self._place(batch)
        self._adopt()
        self._sync_step_carry()
        with self._watched(datas):
            self._opt._step_count += 1
            self._host_step_mirror = self._opt._step_count
            self._sync_lr()
            loss = self._body(datas, n_inputs, inplace=self._donate)
        self._sync_scaler()
        return loss

    def run_steps(self, k, *batch, n_model_inputs: Optional[int] = None,
                  stacked: bool = False):
        """Run ``k`` optimizer steps in one dispatch and return the (k,)
        loss tensor.

        With ``stacked=True`` every batch array carries a leading ``k``
        dim (one microbatch per step); otherwise the same batch is used
        by every step. Stacking is explicit, never inferred: a batch dim
        that happens to equal ``k`` is not a stack. The lr is read once
        per dispatch (a host scheduler sees one ``k``-step tick), the
        state after it is the state after ``k`` calls, and
        ``optimizer._step_count`` advances by ``k`` only once the
        dispatch has succeeded. The scaler state and the
        ``skip_nonfinite`` guard run through every step; the Python
        ``GradScaler`` is synced once, after the k steps."""
        n_inputs = 1 if n_model_inputs is None else n_model_inputs
        datas = [_as_data(b) for b in batch]
        if stacked:
            bad = [tuple(d.shape) for d in datas
                   if d.dim() == 0 or d.shape[0] != k]
            if bad:
                raise ValueError(
                    f"run_steps(stacked=True) needs a leading dim of {k} "
                    f"on every batch array; got shapes {bad}")
        datas = self._place(datas, lead=1 if stacked else 0)
        self._adopt()
        self._sync_step_carry()
        self._sync_lr()

        def micro(i):
            return [d[i] for d in datas] if stacked else datas

        with self._watched(micro(0)):
            if self._captures():
                losses = self._replay(k, micro, n_inputs, stacked)
            else:
                losses = torch.stack([self._body(micro(i), n_inputs,
                                                 inplace=self._donate)
                                      for i in range(k)])
        self._opt._step_count += k
        self._host_step_mirror = self._opt._step_count
        self._sync_scaler()
        return losses

    # -- the captured step -------------------------------------------------
    def _state_refs(self):
        """Every state tensor the graphs read by address, as (holder,
        key): a parameter's data (key None) and each slot."""
        refs = []
        for p in self._params:
            refs.append((p, None))
            slots = self._opt._slots[id(p)]
            refs += [(slots, key) for key in sorted(slots)]
        return refs

    @staticmethod
    def _get(ref):
        holder, key = ref
        return holder.data if key is None else holder[key]

    @staticmethod
    def _put(ref, t):
        holder, key = ref
        if key is None:
            holder.data = t
        else:
            holder[key] = t

    @torch.no_grad()
    def _bind_state(self):
        """Make the graphs' state buffers the live state before a
        dispatch: under ``donate=True`` they are the live tensors, and a
        tensor rebound since (a restore, a user's assignment) is copied
        back into its buffer; under ``donate=False`` every live value is
        copied into the graphs' own buffers."""
        refs = self._state_refs()
        if self._bufs is None:
            self._bufs = [self._get(r) if self._donate
                          else self._get(r).clone() for r in refs]
        for buf, ref in zip(self._bufs, refs):
            live = self._get(ref)
            if self._donate and live.data_ptr() == buf.data_ptr():
                continue
            buf.copy_(live)
            self._put(ref, buf)

    @torch.no_grad()
    def _release_state(self):
        """After a ``donate=False`` dispatch: hand new tensors back."""
        if not self._donate:
            for buf, ref in zip(self._bufs, self._state_refs()):
                self._put(ref, buf.clone())

    def _replay(self, k, micro, n_inputs, stacked):
        first = micro(0)
        key = (tuple((tuple(d.shape), d.dtype) for d in first), n_inputs)
        name = "/".join("x".join(map(str, s)) or "scalar"
                        for s, _ in key[0]) + f":n{n_inputs}"
        losses = torch.empty((k,), dtype=torch.float32, device=self._device)
        self._bind_state()
        try:
            g = self._graphs.get(key)
            start = 0
            if g is None:
                g, warm_loss = self._capture(key, name, first, n_inputs)
                losses[0].copy_(warm_loss)
                start = 1
            for i in range(start, k):
                if stacked or i == start:
                    for buf, d in zip(g.inputs, micro(i)):
                        buf.copy_(d)
                g.graph.replay()
                losses[i].copy_(g.loss)
            n = k - start
            self._replays[name] = self._replays.get(name, 0) + n
            for counter, m in self._captured[name].items():
                self._executed[counter] = self._executed.get(counter, 0) \
                    + m * n
        finally:
            self._release_state()
        return losses

    def _capture(self, key, name, first, n_inputs):
        """Warm-up (the dispatch's first step, eager on a side stream),
        then the capture of the step on the same static inputs."""
        from paddle_tpu_torch import ops

        dev = self._device
        t0 = time.perf_counter()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        inputs = [torch.empty(shape, dtype=dtype, device=dev)
                  for shape, dtype in key[0]]
        for buf, d in zip(inputs, first):
            buf.copy_(d)
        before = ops.kernel_launches()
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            warm_loss = self._body(inputs, n_inputs, inplace=True)
        main.wait_stream(side)
        torch.cuda.synchronize(dev)
        warm = ops.kernel_launches()
        # a dead graph or pinned buffer freed by the collector inside the
        # capture would invalidate it: collect now, not during it
        gc.collect()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            # "thread_local": the capturing thread is barred from unsafe
            # calls; the input pipeline's copy thread is not, and may
            # allocate pinned memory and copy on its own stream meanwhile
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode="thread_local"):
                loss = self._body(inputs, n_inputs, inplace=True)
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize(dev)
        self._graphs[key] = g = _Graph(inputs, loss, graph)
        self._capture_s[name] = time.perf_counter() - t0
        self._captured[name] = _delta(ops.kernel_launches(), warm)
        for counter, n in _delta(warm, before).items():
            self._executed[counter] = self._executed.get(counter, 0) + n
        return g, warm_loss

    def graph_stats(self) -> dict:
        """What ``run_steps`` did on the card, keys named by the
        microbatch's shapes: ``capture_s`` per key, the kernel launches
        one replay runs (``captured_launches``, by counter), the
        ``replays`` per key, and ``executed_launches``: every launch the
        card ran through the graphs' dispatches (the warm-ups' plus
        captured x replays)."""
        return {"captures": len(self._graphs),
                "capture_s": dict(self._capture_s),
                "captured_launches": {k: dict(v)
                                      for k, v in self._captured.items()},
                "replays": dict(self._replays),
                "executed_launches": dict(self._executed)}


def _as_data(b) -> torch.Tensor:
    """A batch element as a torch tensor (a Tensor's data as it is)."""
    return b._data if isinstance(b, Tensor) else torch.as_tensor(b)
