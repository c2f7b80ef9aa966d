"""hapi callbacks (port of ``paddle_tpu/hapi/callbacks.py``): the hook
protocol, ``ProgBarLogger``, ``ModelCheckpoint``, ``LRScheduler``,
``EarlyStopping`` and ``VisualDL``.

``ModelCheckpoint`` writes the flat ``<epoch>.pdparams`` / ``.pdopt``
files through ``Model.save``, or, with ``keep_last_n`` or
``async_save``, committed ``step_<epoch>`` directories through
:class:`paddle_tpu_torch.distributed.checkpoint.CheckpointManager`, from
which ``Model.fit`` resumes. ``VisualDL`` writes through the
``visualdl`` package where it is installed, else appends JSON records to
``<log_dir>/scalars.jsonl``.
"""
from __future__ import annotations

import json
import numbers
import os
import time

import numpy as np

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
           "LRScheduler", "EarlyStopping", "VisualDL"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_predict_begin(self, logs=None):
        pass

    def on_predict_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass

    def on_predict_batch_begin(self, step, logs=None):
        pass

    def on_predict_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def call(self, name, *args):
        for c in self.callbacks:
            getattr(c, name)(*args)


class ProgBarLogger(Callback):
    """Progress lines per epoch, and per ``log_freq`` batches at
    ``verbose > 1``."""

    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._t0 = time.perf_counter()
        if self.verbose and self.params.get("mode", "train") == "train":
            print(f"Epoch {epoch + 1}/{self.params.get('epochs', '?')}")

    def _fmt(self, logs):
        items = []
        for k, v in (logs or {}).items():
            if isinstance(v, numbers.Number):
                items.append(f"{k}: {v:.4f}")
            elif isinstance(v, (list, tuple, np.ndarray)):
                items.append(f"{k}: {np.asarray(v).round(4).tolist()}")
        return " - ".join(items)

    def on_train_batch_end(self, step, logs=None):
        if self.verbose > 1 and (step + 1) % self.log_freq == 0:
            ms = (time.perf_counter() - self._t0) / (step + 1) * 1000
            print(f"step {step + 1}/{self.steps or '?'} - "
                  f"{self._fmt(logs)} - {ms:.1f} ms/step")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            print(f"epoch {epoch + 1} done - {self._fmt(logs)}")

    def on_eval_end(self, logs=None):
        if self.verbose:
            print(f"Eval - {self._fmt(logs)}")


class ModelCheckpoint(Callback):
    """Save the model and optimizer every ``save_freq`` epochs, and at
    the end of training.

    By default the flat layout: ``<save_dir>/<epoch>.pdparams`` (and
    ``.pdopt``), ``final`` at the end. With ``keep_last_n`` and/or
    ``async_save``, a ``CheckpointManager`` over ``save_dir`` (committed
    ``step_<epoch>`` directories, retention, background writes), from
    which ``Model.fit`` resumes unless ``auto_resume`` is False."""

    def __init__(self, save_freq=1, save_dir=None, keep_last_n=None,
                 async_save=False, auto_resume=True):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir
        self.keep_last_n = keep_last_n
        self.async_save = async_save
        self.auto_resume = auto_resume
        self._manager = None
        self._last_epoch = None
        self._last_saved = None

    def _use_manager(self):
        return self.save_dir is not None and (
            self.keep_last_n is not None or self.async_save)

    def _get_manager(self):
        if self._manager is None:
            from paddle_tpu_torch.distributed.checkpoint import (
                CheckpointManager)

            self._manager = CheckpointManager(
                self.save_dir,
                # async_save alone keeps every epoch, as the flat layout
                keep_last_n=(self.keep_last_n if self.keep_last_n
                             is not None else 10 ** 9),
                async_save=self.async_save,
                save_interval_steps=self.save_freq)
        return self._manager

    def _state(self):
        state = {"model": self.model.network.state_dict()}
        opt = getattr(self.model, "_optimizer", None)
        if opt is not None:
            state["opt"] = opt.state_dict()
        return state

    def restore_or_initialize(self, model=None):
        """Called by ``Model.fit`` after it built its train step (the
        optimizer's slots exist then, the template a restore fills): with
        the manager and a committed step in ``save_dir``, restore the
        newest into the model and optimizer and return its step (the
        epochs already trained); else None."""
        if model is not None:
            self.model = model
        if not self._use_manager() or not self.auto_resume:
            return None
        mgr = self._get_manager()
        if mgr.latest_step() is None:
            return None
        state = self._state()
        # the parameters as their torch tensors, which the restore fills
        # in place (a tied parameter stays one tensor; a step's captured
        # graph keeps reading them)
        state["model"] = {k: v._data for k, v in state["model"].items()}
        step = mgr.restore_or_initialize(state)
        if step is None:
            return None
        # the leaves that are not tensors (the optimizer's step count)
        # are pushed back
        opt = getattr(self.model, "_optimizer", None)
        if opt is not None and "opt" in state:
            opt.set_state_dict(state["opt"])
        self._last_saved = step
        return step

    def on_epoch_end(self, epoch, logs=None):
        if not self.save_dir:
            return
        if self._use_manager():
            self._last_epoch = epoch + 1
            mgr = self._get_manager()
            if mgr.should_save(epoch + 1) and \
                    mgr.save(epoch + 1, self._state()):
                self._last_saved = epoch + 1
            return
        if (epoch + 1) % self.save_freq == 0:
            self.model.save(os.path.join(self.save_dir, str(epoch)))

    def on_train_end(self, logs=None):
        if not self.save_dir:
            return
        if self._use_manager():
            mgr = self._get_manager()
            if self._last_epoch is not None and \
                    self._last_saved != self._last_epoch:
                # the trained result is saved even off the save_freq grid
                mgr.save(self._last_epoch, self._state(), block=True,
                         force=True)
            mgr.wait()   # raises a background write's failure
            return
        self.model.save(os.path.join(self.save_dir, "final"))


class LRScheduler(Callback):
    """Step the optimizer's LR scheduler after every batch (``by_step``)
    or every epoch (``by_epoch``)."""

    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        if by_step == by_epoch:
            # the JAX package asserts it
            raise AssertionError(
                "exactly one of by_step/by_epoch must be set")
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        return getattr(opt, "_lr_scheduler", None)

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()


class EarlyStopping(Callback):
    """Stop training when ``monitor`` (read at the end of each
    evaluation) has not improved for ``patience`` evaluations; with
    ``save_best_model`` and a ``save_dir``, save each new best as
    ``best_model``."""

    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "auto":
            mode = "min" if "loss" in monitor or "err" in monitor else "max"
        self.mode = mode

    def on_train_begin(self, logs=None):
        self.wait = 0
        self.stopped_epoch = 0
        self.best = self.baseline if self.baseline is not None else (
            np.inf if self.mode == "min" else -np.inf)

    def _improved(self, cur):
        if self.mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_eval_end(self, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        cur = float(np.asarray(cur).reshape(-1)[0])
        if self._improved(cur):
            self.best = cur
            self.wait = 0
            if self.save_best_model and self.params.get("save_dir"):
                self.model.save(
                    os.path.join(self.params["save_dir"], "best_model"))
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True
                if self.verbose:
                    print(f"Early stopping: {self.monitor} did not improve "
                          f"beyond {self.best:.5f}")


class VisualDL(Callback):
    """Scalar logging: through ``visualdl``'s ``LogWriter`` where the
    package is installed, else one ``{"tag", "step", "value"}`` JSON
    record a line appended to ``<log_dir>/scalars.jsonl``."""

    def __init__(self, log_dir="./log"):
        super().__init__()
        self.log_dir = log_dir
        self._writer = None
        self._fallback = None
        self._step = 0
        self._epoch = 0

    def _ensure_writer(self):
        if self._writer is None and self._fallback is None:
            os.makedirs(self.log_dir, exist_ok=True)
            try:
                from visualdl import LogWriter  # optional

                self._writer = LogWriter(logdir=self.log_dir)
            except ImportError:
                self._fallback = open(
                    os.path.join(self.log_dir, "scalars.jsonl"), "a")

    def _scalar(self, tag, value, step):
        self._ensure_writer()
        try:
            v = float(value[0] if isinstance(value, (list, tuple))
                      else value)
        except (TypeError, ValueError):
            return
        if self._writer is not None:
            self._writer.add_scalar(tag=tag, value=v, step=step)
        else:
            self._fallback.write(json.dumps(
                {"tag": tag, "step": step, "value": v}) + "\n")
            self._fallback.flush()

    def _log_all(self, prefix, logs, step):
        for k, v in (logs or {}).items():
            if k in ("batch_size", "steps"):
                continue
            self._scalar(f"{prefix}/{k}", v, step)

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        self._log_all("train", logs, self._step)

    def on_epoch_end(self, epoch, logs=None):
        self._epoch = epoch
        self._log_all("train_epoch", logs, epoch)

    def on_eval_end(self, logs=None):
        self._log_all("eval", logs, self._epoch)

    def on_train_end(self, logs=None):
        # closed, so the same instance can serve a later fit()
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        if self._fallback is not None:
            self._fallback.close()
            self._fallback = None
