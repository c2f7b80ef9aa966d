"""Optimizers (port of ``paddle_tpu/optimizer/optimizer.py``: the
``Optimizer`` base, ``Adam`` and ``AdamW``).

As in the JAX package, each optimizer defines a rule
``_rule(p, g, slots, lr, step) -> (new_p, new_slots)`` over tensors, and
``_rule_mp`` wraps it for ``multi_precision`` (the update runs on an f32
master weight and is cast back to the low-precision parameter). The
port applies the result IN PLACE under ``no_grad``: :meth:`_apply`
copies the new values into the parameter and its slots, or, where a
``skip`` flag (a bool tensor on the device) is set, keeps the old ones
bit for bit with no host sync. ``torch.optim.AdamW`` keeps no master
weights, so it is no drop-in.

Parameters may be given as tensors or as ``(name, tensor)`` pairs (for
example ``model.named_parameters()``); ``apply_decay_param_fun`` gets
that name. ``jit.TrainStep`` names the parameters from its model when
the optimizer was given bare tensors. An ``LRScheduler`` is refused
for now (it comes with B2).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

__all__ = ["Optimizer", "Adam", "AdamW"]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                f"learning_rate={type(learning_rate).__name__}: LR "
                f"schedulers are not ported yet; they come with B2 "
                f"(optimizer/lr.py)")
        self._base_lr = float(learning_rate)
        self._parameter_list: Optional[List[torch.Tensor]] = None
        self._names: Dict[int, str] = {}
        if parameters is not None:
            self._set_parameters(parameters)
        self._weight_decay = 0.0 if weight_decay is None else weight_decay
        self._grad_clip = grad_clip
        self._slots: Dict[int, dict] = {}
        self._step_count = 0
        self._multi_precision = bool(multi_precision)

    def _set_parameters(self, parameters):
        plist = []
        for item in parameters:
            if isinstance(item, tuple):
                name, item = item
                self._names[id(item)] = name
            plist.append(item)
        self._parameter_list = plist

    def _name_of(self, p) -> str:
        """The parameter's given name, else ``param_<position>`` (the JAX
        package's fallback for unnamed parameters)."""
        name = self._names.get(id(p))
        if name is None:
            pos = [id(x) for x in self._parameter_list or []]
            name = f"param_{pos.index(id(p))}" if id(p) in pos else ""
        return name

    # -- lr ----------------------------------------------------------------
    def get_lr(self) -> float:
        return self._base_lr

    # -- functional core (override) ----------------------------------------
    def _init_slots(self, p) -> dict:
        return {}

    def _rule(self, p, g, slots, lr, step):
        raise NotImplementedError

    def _decay_enabled(self, param) -> bool:
        return True

    def _init_slots_mp(self, p) -> dict:
        """_init_slots plus, under multi_precision, an f32 master-weight
        slot for a low-precision parameter; the moments are then made
        from the master copy, so they accumulate in f32."""
        with torch.no_grad():
            if (self._multi_precision and p.is_floating_point()
                    and p.element_size() < 4):
                master = p.detach().float()
                slots = self._init_slots(master)
                slots["master_weight"] = master
                return slots
            return self._init_slots(p.detach())

    def _rule_mp(self, p, g, slots, lr, step):
        """dtype-stable _rule: new values keep their stored dtypes, and
        with a master weight the update runs on it in f32."""
        mw = slots.get("master_weight")
        if mw is not None:
            inner = {k: v for k, v in slots.items() if k != "master_weight"}
            new_mw, ns = self._rule(mw, g.to(mw.dtype), inner, lr, step)
            ns = {k: v.to(inner[k].dtype) for k, v in ns.items()}
            ns["master_weight"] = new_mw.float()
            return new_mw.to(p.dtype), ns
        new_p, ns = self._rule(p, g, slots, lr, step)
        return (new_p.to(p.dtype),
                {k: v.to(slots[k].dtype) for k, v in ns.items()})

    # -- in-place application ----------------------------------------------
    @torch.no_grad()
    def _apply(self, params, grads, lr, step, skip=None):
        """One update of ``params`` from ``grads`` (same order), IN PLACE.
        ``step`` is the bias-correction step (a number or a 0-dim
        tensor); where the 0-dim bool tensor ``skip`` is True, every
        parameter and slot keeps its old bits."""
        for p, g in zip(params, grads):
            slots = self._slots.get(id(p))
            if slots is None:
                slots = self._slots[id(p)] = self._init_slots_mp(p)
            if g.dtype != p.dtype:
                g = g.to(p.dtype)
            self._current_decay_enabled = self._decay_enabled(p)
            new_p, new_slots = self._rule_mp(p.detach(), g, slots, lr, step)
            self._current_decay_enabled = True
            for old, new in [(p, new_p)] + [(slots[k], v)
                                            for k, v in new_slots.items()]:
                old.copy_(new if skip is None else torch.where(skip, old, new))

    _current_decay_enabled = True


class Adam(Optimizer):
    """L2-into-grad weight decay (``AdamW`` decouples it)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision=multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _init_slots(self, p):
        return {"moment1": torch.zeros_like(p),
                "moment2": torch.zeros_like(p)}

    def _decoupled(self):
        return False

    def _rule(self, p, g, slots, lr, step):
        wd = self._weight_decay and self._current_decay_enabled
        if wd and not self._decoupled():
            g = g + float(self._weight_decay) * p
        b1, b2 = self._beta1, self._beta2
        m = b1 * slots["moment1"] + (1 - b1) * g
        v = b2 * slots["moment2"] + (1 - b2) * g.square()
        # the JAX TrainStep's step and lr are f32 arrays, which take the
        # bias-corrected update of a bf16 parameter to f32: so here
        mhat = m.float() / (1 - b1 ** step)
        vhat = v.float() / (1 - b2 ** step)
        upd = lr * mhat / (vhat.sqrt() + self._eps)
        if wd and self._decoupled():
            upd = upd + (lr * float(self._weight_decay)) * p.float()
        return p - upd, {"moment1": m, "moment2": v}


class AdamW(Adam):
    """Decoupled weight decay, 0.01 by default; ``apply_decay_param_fun``
    (called with a parameter's name) returns False for the parameters
    that take no decay."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=False, name=None, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip,
                         multi_precision=multi_precision)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decoupled(self):
        return True

    def _decay_enabled(self, param):
        if self._apply_decay_param_fun is not None:
            return bool(self._apply_decay_param_fun(self._name_of(param)))
        return True
