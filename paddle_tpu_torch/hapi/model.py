"""hapi.Model: prepare / fit / evaluate / predict / save / load (port of
``paddle_tpu/hapi/model.py``).

Training goes through the port's ``jit.TrainStep`` (built at the first
training call, when it takes its one generator key), one
``run_steps(1)`` a batch: on the card each batch shape is captured once
as a CUDA graph and replayed, on the CPU the step runs eagerly. As the
JAX package's compiled step is traced once per batch shape, the step
runs in the train/eval mode the network had at its first call for that
shape (an ``evaluate`` inside ``fit`` does not turn later steps' dropout
off).

The JAX package runs ``evaluate``, ``predict`` and ``fit``'s train
metrics through ``jit.to_static``, which slice E3 brings. Here they call
the network directly under ``no_grad``, on the network's device, and
spend the generator's keys as that compiled forward does: one key a
call, which the forward's draws split (``device_key_stream``).
``save(training=False)`` (an inference export through ``jit.save``)
waits for E3 and raises.
"""
from __future__ import annotations

import contextlib
import os
from typing import List

import numpy as np
import torch

from paddle_tpu_torch.core import generator as gen
from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.hapi.callbacks import (
    CallbackList, ModelCheckpoint, ProgBarLogger,
)

__all__ = ["Model"]


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _update_metric(m, res):
    """``metric.update(*res)`` for a tuple from the base ``compute`` (the
    arguments), ``metric.update(res)`` for Accuracy's correct matrix."""
    if isinstance(res, tuple):
        return m.update(*res)
    return m.update(res)


def _log_metric(logs, m, value):
    """One log key per metric name (Accuracy(topk=(1, 5)) names two)."""
    names = m.name()
    if isinstance(names, (list, tuple)):
        vals = value if isinstance(value, (list, tuple)) \
            else [value] * len(names)
        for nm, v in zip(names, vals):
            logs[nm] = v
    else:
        logs[names] = value


def _set_mode(layer, training: bool):
    if training:
        layer.train()
    else:
        layer.eval()


class Model:
    """The high-level training, evaluation and inference facade over a
    Layer. ``inputs``/``labels`` may be lists of ``InputSpec``: their
    count says how many leading batch elements feed the network; the rest
    feed the loss."""

    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs_spec = _to_list(inputs)
        self._labels_spec = _to_list(labels)
        self._n_inputs = max(len(self._inputs_spec), 1) \
            if inputs is not None else 1
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._train_step = None
        self._step_modes = {}
        self._amp_level = "O0"
        self._scaler = None
        self.stop_training = False

    @property
    def _device(self) -> torch.device:
        for p in self.network.parameters():
            return p._data.device
        raise ValueError("Model: the network has no parameters")

    # ------------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        """Bind the optimizer, loss, metrics and AMP. ``amp_configs`` is
        "O1"/"O2" or a dict with ``level`` and ``GradScaler`` keywords
        (``init_loss_scaling`` ...)."""
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _to_list(metrics)
        self._train_step = None   # built at the first training call
        self._step_modes = {}
        self._amp_level = "O0"
        self._scaler = None
        if amp_configs:
            from paddle_tpu_torch import amp as _amp

            if isinstance(amp_configs, str):
                self._amp_level = amp_configs
            else:
                cfg = dict(amp_configs)
                self._amp_level = cfg.pop("level", "O1")
                scaler_kw = {k: v for k, v in cfg.items()
                             if k in ("init_loss_scaling", "incr_ratio",
                                      "decr_ratio", "incr_every_n_steps",
                                      "decr_every_n_nan_or_inf",
                                      "use_dynamic_loss_scaling")}
                if scaler_kw:
                    self._scaler = _amp.GradScaler(**scaler_kw)
            if self._amp_level not in ("O0", "O1", "O2"):
                raise ValueError(f"bad amp level {self._amp_level!r}")
        return self

    def _autocast(self):
        if self._amp_level in ("O1", "O2"):
            from paddle_tpu_torch import amp as _amp

            return _amp.auto_cast(enable=True, level=self._amp_level)
        return contextlib.nullcontext()

    def _ensure_train_step(self):
        if self._train_step is None:
            from paddle_tpu_torch.jit import TrainStep

            if self._optimizer is None or self._loss is None:
                raise RuntimeError(
                    "call prepare(optimizer=..., loss=...) before training")
            self._train_step = TrainStep(self.network, self._loss,
                                         self._optimizer,
                                         scaler=self._scaler)
            self._step_modes = {}
        return self._train_step

    def _as_loader(self, data, batch_size, shuffle, num_workers=0):
        """A Dataset (or anything indexable) batched by a DataLoader onto
        the network's device; a DataLoader or another iterable of batches
        as it is."""
        from paddle_tpu_torch.io import DataLoader, Dataset

        if data is None:
            return None
        if isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset) or hasattr(data, "__getitem__"):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              num_workers=num_workers,
                              places=str(self._device))
        return data

    def _tensors(self, items) -> List[Tensor]:
        """Batch elements as Tensors on the network's device."""
        dev = self._device
        out = []
        for x in items:
            d = x._data if isinstance(x, Tensor) else (
                x if isinstance(x, torch.Tensor) else Tensor(x)._data)
            out.append(Tensor._from_data(d.to(dev)))
        return out

    def _forward(self, inputs) -> List[Tensor]:
        """The network on ``inputs`` under ``no_grad``, in its current
        mode, its draws splitting one generator key."""
        ins = self._tensors(inputs)
        key = torch.tensor(gen.default_generator.next_key(),
                           dtype=torch.int64, device=self._device)
        with torch.no_grad(), gen.device_key_stream(key):
            return _to_list(self.network(*ins))

    def _step(self, batch, n_inputs):
        """One optimizer step on ``batch`` (the first ``n_inputs``
        elements feed the network), in the mode the network had at the
        step's first call for these shapes; returns the loss tensor."""
        step = self._ensure_train_step()
        datas = self._tensors(batch)
        key = (tuple((tuple(d.shape), d.dtype) for d in datas), n_inputs)
        mode = self._step_modes.setdefault(key, self.network.training)
        was = self.network.training
        if mode != was:
            _set_mode(self.network, mode)
        try:
            with self._autocast():
                return step.run_steps(1, *datas,
                                      n_model_inputs=n_inputs)[0]
        finally:
            if mode != was:
                _set_mode(self.network, was)

    # -- the batch-level API ---------------------------------------------
    def train_batch(self, inputs, labels=None):
        inputs, labels = _to_list(inputs), _to_list(labels)
        self.network.train()
        loss = self._step(inputs + labels, len(inputs))
        return [float(loss.item())]

    def eval_batch(self, inputs, labels=None):
        inputs, labels = _to_list(inputs), _to_list(labels)
        self.network.eval()
        outs = self._forward(inputs)
        labels = self._tensors(labels)
        loss = [0.0]
        if self._loss is not None and labels:
            loss = [float(self._loss(*(outs + labels)).item())]
        metrics = [_update_metric(m, m.compute(*(outs + labels)))
                   for m in self._metrics]
        return (loss, metrics) if self._metrics else loss

    def predict_batch(self, inputs):
        self.network.eval()
        return [o.numpy() for o in self._forward(_to_list(inputs))]

    # -- the loops ---------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None, n_model_inputs=None):
        loader = self._as_loader(train_data, batch_size, shuffle,
                                 num_workers)
        eval_loader = self._as_loader(eval_data, batch_size, False,
                                      num_workers)
        n_in = n_model_inputs or self._n_inputs

        cbks = CallbackList(_to_list(callbacks) or
                            [ProgBarLogger(log_freq, verbose=verbose)])
        cbks.set_model(self)
        try:
            steps = len(loader)
        except TypeError:
            steps = None
        cbks.set_params({"epochs": epochs, "steps": steps,
                         "verbose": verbose, "mode": "train",
                         "save_dir": save_dir})
        self.stop_training = False
        self._ensure_train_step()
        self.network.train()

        # auto-resume: a ModelCheckpoint over a CheckpointManager
        # restores the newest committed epoch (after the step exists, so
        # the optimizer's slots are the template) and fit skips the
        # epochs already trained
        start_epoch = 0
        for cb in cbks.callbacks:
            if isinstance(cb, ModelCheckpoint):
                resumed = cb.restore_or_initialize(self)
                if resumed:
                    start_epoch = min(int(resumed), epochs)
                break

        cbks.call("on_train_begin", {})
        history, logs = [], {}
        for epoch in range(start_epoch, epochs):
            cbks.call("on_epoch_begin", epoch, {})
            logs = {}
            for m in self._metrics:
                m.reset()
            for i, batch in enumerate(loader):
                batch = _to_list(batch)
                cbks.call("on_train_batch_begin", i, {})
                logs = {"loss": float(self._step(batch, n_in).item())}
                if self._metrics and i % log_freq == 0:
                    # the train metrics: a separate forward every
                    # log_freq batches, in the network's current mode
                    outs = self._forward(batch[:n_in])
                    labels = self._tensors(batch[n_in:])
                    for m in self._metrics:
                        _update_metric(m, m.compute(*(outs + labels)))
                        _log_metric(logs, m, m.accumulate())
                cbks.call("on_train_batch_end", i, logs)
            cbks.call("on_epoch_end", epoch, logs)
            history.append(logs)
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(
                    eval_loader, batch_size=batch_size, verbose=verbose,
                    callbacks=cbks, num_workers=num_workers,
                    n_model_inputs=n_in)
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
            if save_dir and (epoch + 1) % save_freq == 0:
                self.save(os.path.join(save_dir, str(epoch)))
            if self.stop_training:
                break
        cbks.call("on_train_end", logs)
        return history

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, n_model_inputs=None):
        loader = self._as_loader(eval_data, batch_size, False, num_workers)
        n_in = n_model_inputs or self._n_inputs
        own_cbks = not isinstance(callbacks, CallbackList)
        cbks = callbacks if not own_cbks else CallbackList(
            _to_list(callbacks) or [ProgBarLogger(log_freq,
                                                  verbose=verbose)])
        if own_cbks:
            cbks.set_model(self)
            cbks.set_params({"mode": "eval", "verbose": verbose})
        for m in self._metrics:
            m.reset()
        self.network.eval()
        cbks.call("on_eval_begin", {})
        losses = []
        for i, batch in enumerate(loader):
            batch = _to_list(batch)
            cbks.call("on_eval_batch_begin", i, {})
            outs = self._forward(batch[:n_in])
            labels = self._tensors(batch[n_in:])
            logs = {}
            if self._loss is not None and labels:
                v = float(self._loss(*(outs + labels)).item())
                losses.append(v)
                logs["loss"] = v
            for m in self._metrics:
                _log_metric(logs, m,
                            _update_metric(m, m.compute(*(outs + labels))))
            cbks.call("on_eval_batch_end", i, logs)
        final = {}
        if losses:
            final["loss"] = float(np.mean(losses))
        for m in self._metrics:
            _log_metric(final, m, m.accumulate())
        cbks.call("on_eval_end", final)
        return final

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None):
        loader = self._as_loader(test_data, batch_size, False, num_workers)
        self.network.eval()
        outputs: List[List[np.ndarray]] = []
        for batch in loader:
            outs = self._forward(_to_list(batch)[: self._n_inputs])
            outputs.append([o.numpy() for o in outs])
        n_out = len(outputs[0]) if outputs else 0
        grouped = [[b[i] for b in outputs] for i in range(n_out)]
        if stack_outputs:
            grouped = [np.concatenate(g, axis=0) for g in grouped]
        return grouped

    # -- persistence -------------------------------------------------------
    def save(self, path, training=True):
        """``training=True``: the parameters (``<path>.pdparams``) and the
        optimizer's state (``<path>.pdopt``). ``training=False`` (an
        inference export through ``jit.save``) raises: it comes with
        slice E3."""
        import paddle_tpu_torch as paddle

        if not training:
            raise NotImplementedError(
                "Model.save(training=False) exports an inference program "
                "through jit.save, which is not ported yet; it comes with "
                "slice E3 (static/, jit's to_static, save and load)")
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        paddle.save(self.network.state_dict(), path + ".pdparams")
        if self._optimizer is not None:
            paddle.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        import paddle_tpu_torch as paddle

        self.network.set_state_dict(paddle.load(path + ".pdparams"))
        opt_path = path + ".pdopt"
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(opt_path):
            self._optimizer.set_state_dict(paddle.load(opt_path))
        # the next training call builds a new step, as the JAX package's
        # load drops its compiled one
        self._train_step = None
        self._step_modes = {}

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        from paddle_tpu_torch.hapi.model_summary import summary

        return summary(self.network, input_size, dtypes=dtype)
