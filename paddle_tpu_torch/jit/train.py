"""TrainStep: one training step (port of ``paddle_tpu/jit/train.py``).

The JAX package compiles forward, backward and the optimizer update into
one XLA executable and donates the state buffers. PyTorch runs the same
step eagerly: forward and loss, the loss scaled by the ``scaler``'s
device state before ``backward()``, unscale and check (``found_inf``),
the ``skip_nonfinite`` guard (checked after unscaling, before
clipping), the clip the optimizer carries
(``optimizer._grad_clip.clip_fn``), and the optimizer's rule applied IN
PLACE (donation's effect) unless ``found_inf`` or the guard skips it.
The bias-correction step, the count of skipped steps and the scaler's
5-wide state live on the device; ``optimizer._step_count`` is the host
mirror, advanced per call. As in the JAX step, only the
``skip_nonfinite`` guard rolls the device step back, a ``found_inf``
skip does not, and the scaler's schedule is never rolled back; the
Python ``GradScaler`` is synced from the device state once per call
(one host read), so its divergence guard raises at the same call. The
lr reaches the rule as the f32 value the JAX step's lr array holds.

Refused at construction, each with the slice that brings it:
``sharding`` (slice D), ``accumulate_steps > 1`` and ``donate=False``
(B3). :meth:`TrainStep.run_steps` (B3, as a CUDA graph) raises. The JAX step's SOT graph-break path has nothing to port: eager
PyTorch runs data-dependent Python as it is.
"""
from __future__ import annotations

import weakref
from typing import Callable, List, Optional

import numpy as np
import torch

from paddle_tpu_torch import amp as _amp
from paddle_tpu_torch import profiler as _prof

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


class TrainStep:
    """``step(*batch)`` runs one optimizer step of ``model`` under
    ``loss_fn(model_outputs..., labels...)`` and returns the loss (a
    detached 0-dim tensor on the model's device). The batch (tensors or
    numpy arrays) is moved to the model's device first. By default the
    model takes one input and the rest are labels."""

    def __init__(self, model, loss_fn: Callable, optimizer,
                 accumulate_steps: int = 1, sharding=None, scaler=None,
                 donate: bool = True, skip_nonfinite: bool = False):
        for bad, what, later in (
                (sharding is not None, "sharding", "slice D"),
                (accumulate_steps != 1,
                 f"accumulate_steps={accumulate_steps}", "B3"),
                (not donate, "donate=False", "B3")):
            if bad:
                raise NotImplementedError(
                    f"TrainStep({what}) is not ported yet; it comes with "
                    f"{later}")
        self._model = model
        self._loss_fn = loss_fn
        self._opt = optimizer
        self._skip_nonfinite = bool(skip_nonfinite)
        named = list(model.named_parameters())
        self._params = [p for _, p in named if p.requires_grad]
        if optimizer._parameter_list is None:
            optimizer._parameter_list = list(self._params)
        for name, p in named:
            optimizer._model_names.setdefault(id(p), name)
        for p in self._params:   # slots up front, as the JAX step does
            if id(p) not in optimizer._slots:
                optimizer._slots[id(p)] = optimizer._init_slots_mp(p)
        self._device = self._params[0].device
        # device carry: the applied step (bias correction) and the skips
        self._step = torch.tensor(float(optimizer._step_count),
                                  device=self._device)
        self._nskip = torch.zeros((), device=self._device)
        self._host_step_mirror = optimizer._step_count
        self._scaler = scaler if scaler is not None and scaler.is_enable() \
            else None
        self._scaler_state = _amp.scaler_init_state(self._scaler,
                                                    self._device)
        if self._skip_nonfinite:
            install_nonfinite_observability(self, optimizer)

    @property
    def skipped_steps(self) -> int:
        """Steps the ``skip_nonfinite`` guard turned into identity
        updates (reading it waits for the last step)."""
        return int(self._nskip.item())

    def _sync_step_carry(self):
        """Re-seed the device step if the optimizer's counter was changed
        from outside (a restored state)."""
        if self._opt._step_count != self._host_step_mirror:
            self._step = torch.tensor(float(self._opt._step_count),
                                      device=self._device)
            self._host_step_mirror = self._opt._step_count

    def __call__(self, *batch, n_model_inputs: Optional[int] = None):
        n_inputs = 1 if n_model_inputs is None else n_model_inputs
        datas = [torch.as_tensor(b).to(self._device, non_blocking=True)
                 for b in batch]
        self._sync_step_carry()
        self._opt._step_count += 1
        self._host_step_mirror = self._opt._step_count
        # the JAX step's lr is an f32 array
        lr = float(np.float32(self._opt.get_lr()))
        state = self._scaler_state

        for p in self._params:
            p.grad = None
        out = self._model(*datas[:n_inputs])
        outs = out if isinstance(out, tuple) else (out,)
        loss = self._loss_fn(*outs, *datas[n_inputs:])
        # loss scaling happens BEFORE backward (fp16 underflow)
        (loss if state is None else loss * state[0]).backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self._params]
        for p in self._params:
            p.grad = None
        loss = loss.detach()

        step = self._step + 1
        found_inf = None
        if state is not None:
            grads, found_inf = _amp.scaler_unscale_and_check(grads, state)
            state = _amp.scaler_update_state(self._scaler, state, found_inf)
        nonfinite = (nonfinite_any(loss, grads) if self._skip_nonfinite
                     else None)
        clip_fn = getattr(self._opt._grad_clip, "clip_fn", None)
        if clip_fn is not None:
            grads = clip_fn(grads)
        skip = found_inf
        if nonfinite is not None:
            skip = nonfinite if skip is None else skip | nonfinite
        self._opt._apply(self._params, grads, lr, step, skip=skip,
                         cast_grads=False)
        if nonfinite is not None:
            # only the guard rolls the step back; a found_inf skip and
            # the scaler's schedule are never rolled back
            self._nskip = self._nskip + nonfinite.float()
            step = torch.where(nonfinite, step - 1, step)
        self._step = step
        if state is not None:
            self._scaler_state = state
            _amp.scaler_sync_from_state(self._scaler, state)
        return loss

    def run_steps(self, k, *batch, **kw):
        raise NotImplementedError(
            "TrainStep.run_steps is not ported yet; it comes with B3 as k "
            "steps replayed in one CUDA graph")
