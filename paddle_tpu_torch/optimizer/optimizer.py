"""Optimizers (port of ``paddle_tpu/optimizer/optimizer.py``: the
``Optimizer`` base and its fourteen rules).

As in the JAX package, each optimizer defines a rule
``_rule(p, g, slots, lr, step) -> (new_p, new_slots)`` over tensors, and
``_rule_mp`` wraps it for ``multi_precision`` (the update runs on an f32
master weight and is cast back to the low-precision parameter). The
port applies the result IN PLACE under ``no_grad``: :meth:`_apply`
copies the new values into the parameter and its slots (or, for
``TrainStep(donate=False)``, binds them as new tensors), or, where a
``skip`` flag (a bool tensor on the device) is set, keeps the old ones
bit for bit with no host sync. ``torch.optim.AdamW`` keeps no master
weights, so it is no drop-in.

The eager :meth:`Optimizer.step` runs the rule over each parameter's
torch ``.grad`` with the Python-float lr and the Python-int step count,
as the JAX package's eager step does; ``jit.TrainStep`` runs it with an
f32 lr and a device step. The clip, when there is one, is called on
``(parameter, grad)`` pairs and scales the grads in place. ``LBFGS``
has its own ``step(closure)``.

Parameters may be given as torch tensors, as Tensor API ``Tensor`` objects
(``to_tensor(..., stop_gradient=False)``: the update is applied to each
one's ``_data`` in place, and a Tensor whose data was rebound since is
followed to its new data, slots and all), or as ``(name, tensor)`` pairs
(for example ``model.named_parameters()``); ``apply_decay_param_fun`` gets
that name, or the model's name for the parameter when ``TrainStep``
names them. ``state_dict`` keys a slot ``<name>.<slot>``: a name given
as a pair, else ``param_<position>`` (the JAX package's key for a
parameter with an automatic name), so a state dict of one package loads
into the other (``models.convert.optimizer_state_from_jax``).
``learning_rate`` may be an :class:`~paddle_tpu_torch.optimizer.lr.
LRScheduler`. Not ported: the ASP n:m masks (``incubate/asp``) and the
ZeRO slot placement of the semi-auto API (``_slot_shard_fn``, slice D2);
``distributed.ParallelTrainStep`` shards its own slots.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from paddle_tpu_torch.optimizer.lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adagrad", "Adadelta", "RMSProp",
           "Adam", "AdamW", "Adamax", "Lamb", "NAdam", "RAdam", "ASGD",
           "Rprop", "LBFGS"]


def _as_tensor(value, device) -> torch.Tensor:
    """A state-dict value (a torch or port tensor, a numpy array, incl.
    ml_dtypes' bfloat16, or a number) as a tensor of its own dtype on
    ``device``."""
    from paddle_tpu_torch.core.tensor import Tensor

    if isinstance(value, Tensor):
        value = value._data
    if isinstance(value, torch.Tensor):
        return value.detach().to(device).clone()
    arr = np.array(value, order="C")
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        self._lr_scheduler: Optional[LRScheduler] = None
        if isinstance(learning_rate, LRScheduler):
            self._lr_scheduler = learning_rate
            self._base_lr = None
        else:
            self._base_lr = float(learning_rate)
        self._parameter_list: Optional[List[torch.Tensor]] = None
        self._names: Dict[int, str] = {}        # given as (name, p) pairs
        self._model_names: Dict[int, str] = {}  # TrainStep's model names
        if parameters is not None:
            self._set_parameters(parameters)
        self._weight_decay = 0.0 if weight_decay is None else weight_decay
        self._grad_clip = grad_clip
        self._slots: Dict[int, dict] = {}
        self._step_count = 0
        # state_dict persists this callable's value as "step" when set: a
        # skip_nonfinite TrainStep advances _step_count per call but rolls
        # its device step back on a skipped update, and a restore must see
        # the APPLIED count (install_nonfinite_observability sets it)
        self._applied_step_provider = None
        self._multi_precision = bool(multi_precision)

    def _set_parameters(self, parameters):
        plist = []
        self._wrappers = []   # (position, Tensor API Tensor)
        for item in parameters:
            name = None
            if isinstance(item, tuple):
                name, item = item
            if not isinstance(item, torch.Tensor) and hasattr(item, "_data"):
                self._wrappers.append((len(plist), item))
                item = item._data
            if name is not None:
                self._names[id(item)] = name
            plist.append(item)
        self._parameter_list = plist

    def _follow_wrappers(self):
        """Re-point the list (and the slots and names keyed by the torch
        tensor) at each Tensor API parameter's current data."""
        for pos, w in getattr(self, "_wrappers", ()):
            old = self._parameter_list[pos]
            new = w._data
            if new is old:
                continue
            self._parameter_list[pos] = new
            for table in (self._slots, self._names, self._model_names):
                if id(old) in table:
                    table[id(new)] = table.pop(id(old))

    def _name_of(self, p) -> str:
        """The name ``apply_decay_param_fun`` gets: the given name, else
        the model's (``TrainStep``), else ``param_<position>``."""
        name = self._names.get(id(p), self._model_names.get(id(p)))
        if name is None:
            pos = [id(x) for x in self._parameter_list or []]
            name = f"param_{pos.index(id(p))}" if id(p) in pos else ""
        return name

    # -- lr ----------------------------------------------------------------
    def get_lr(self) -> float:
        if self._lr_scheduler is not None:
            return float(self._lr_scheduler())
        return self._base_lr

    def set_lr(self, value: float):
        if self._lr_scheduler is not None:
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._base_lr = float(value)

    @property
    def _learning_rate(self):
        return self._lr_scheduler if self._lr_scheduler is not None \
            else self._base_lr

    # -- functional core (override) ----------------------------------------
    def _init_slots(self, p) -> dict:
        return {}

    def _rule(self, p, g, slots, lr, step):
        raise NotImplementedError

    # set per parameter before each _rule call (False where
    # apply_decay_param_fun / exclude_from_weight_decay_fn excludes it)
    _current_decay_enabled = True
    # set per parameter by _apply(norm_reduce=): a squared norm over the
    # slice a rule sees -> the whole parameter's
    _current_norm_reduce = None

    def _norm(self, x):
        """The L2 norm of the parameter ``x`` is a slice of (the whole
        parameter's under ``_apply(norm_reduce=)``)."""
        reduce = self._current_norm_reduce
        if reduce is None:
            return torch.linalg.vector_norm(x)
        return reduce(torch.linalg.vector_norm(x, dtype=torch.float32)
                      .square()).sqrt()

    def _decay_enabled(self, param) -> bool:
        return True

    def _decay_coeff(self) -> float:
        wd = self._weight_decay
        return wd.coeff if hasattr(wd, "coeff") else float(wd)

    def _apply_weight_decay_to_grad(self, p, g):
        if self._weight_decay and self._current_decay_enabled:
            return g + self._decay_coeff() * p
        return g

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
            ns = {k: v.to(inner[k].dtype) if k in inner else v
                  for k, v in ns.items()}
            ns["master_weight"] = new_mw.float()
            return new_mw.to(p.dtype), ns
        new_p, ns = self._rule(p, g, slots, lr, step)
        return (new_p.to(p.dtype),
                {k: v.to(slots[k].dtype) if k in slots else v
                 for k, v in ns.items()})

    # -- in-place application ----------------------------------------------
    @torch.no_grad()
    def _apply(self, params, grads, lr, step, skip=None, cast_grads=True,
               inplace=True, targets=None, norm_reduce=None):
        """One update of ``params`` from ``grads`` (same order), in place
        by default. ``lr`` and ``step`` (the bias-correction step) are numbers or
        0-dim tensors; where the 0-dim bool tensor ``skip`` is True,
        every parameter and slot keeps its old bits. ``cast_grads`` casts
        each gradient to its parameter's dtype first, as the JAX eager
        step does (its TrainStep hands the rule an unscaled f32 gradient
        as it is). ``inplace=False`` binds the new values as new tensors
        instead (``p.data`` and the slot entries), so a tensor taken from
        a parameter or slot before the update keeps its values (the JAX
        step's ``donate=False``). ``targets`` (one per parameter, in
        place only) are the tensors the rule updates in the parameters'
        stead, with the parameters' slots and names: a ZeRO step updates
        the slice of each parameter that its slots cover, and
        ``norm_reduce`` (one per parameter, or None) turns a squared norm
        over the slice into the whole parameter's, for a rule that reads
        a norm (``Lamb``'s trust ratio)."""
        if targets is None:
            targets = params
        elif not inplace:
            raise ValueError("_apply(targets=) updates in place")
        for i, (p, t, g) in enumerate(zip(params, targets, grads)):
            self._current_norm_reduce = None if norm_reduce is None \
                else norm_reduce[i]
            slots = self._slots.get(id(p))
            if slots is None:
                slots = self._slots[id(p)] = self._init_slots_mp(t)
            if cast_grads and g.dtype != p.dtype:
                g = g.to(p.dtype)
            self._current_decay_enabled = self._decay_enabled(p)
            new_p, new_slots = self._rule_mp(t.detach(), g, slots, lr, step)
            self._current_decay_enabled = True
            for key, old, new in [(None, t, new_p)] + [
                    (k, slots[k], v) for k, v in new_slots.items()]:
                if new is old:
                    continue
                val = new if skip is None else torch.where(skip, old, new)
                if inplace:
                    old.copy_(val)
                elif key is None:
                    p.data = val
                else:
                    slots[key] = val
        self._current_norm_reduce = None

    # -- eager step --------------------------------------------------------
    @torch.no_grad()
    def step(self):
        """One update of every parameter that has a ``.grad``, from it."""
        self._follow_wrappers()
        pairs = [(p, p.grad) for p in self._parameter_list or []
                 if p.grad is not None and p.requires_grad]
        if self._grad_clip is not None:
            pairs = self._grad_clip(pairs)
        self._step_count += 1
        self._apply([p for p, _ in pairs], [g for _, g in pairs],
                    self.get_lr(), self._step_count)

    def clear_grad(self, set_to_zero=False):
        """Drop every parameter's ``.grad`` (the JAX package's
        ``Tensor.clear_grad`` sets it to None whatever ``set_to_zero``
        says; so does this)."""
        self._follow_wrappers()
        for p in self._parameter_list or []:
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """Eager: ``loss.backward()``, :meth:`step`, :meth:`clear_grad`."""
        if type(loss).__name__ == "Variable":
            raise NotImplementedError(
                "Optimizer.minimize on a static-graph Variable is not "
                "ported; the static Program comes with slice E (E3)")
        loss.backward()
        self.step()
        self.clear_grad()

    # -- state dict --------------------------------------------------------
    def init_slots(self):
        """Create every parameter's slots now, as ``TrainStep`` does at
        construction (an eager optimizer makes them at its first step),
        so that :meth:`state_dict` holds their keys: the template a
        checkpoint restores into."""
        self._follow_wrappers()
        for p in self._parameter_list or []:
            if id(p) not in self._slots:
                self._slots[id(p)] = self._init_slots_mp(p)
        return self

    def state_dict(self) -> dict:
        """``step``, ``LR_Scheduler`` (with a scheduler) and one
        ``<name>.<slot>`` per slot. The slot values are the live slot
        tensors (detached), as ``torch.nn.Module.state_dict`` gives;
        copy them to keep a snapshot across later steps."""
        self._follow_wrappers()
        step = self._step_count
        if self._applied_step_provider is not None:
            applied = self._applied_step_provider()
            if applied is not None:
                step = int(applied)
        out = {"step": step}
        if self._lr_scheduler is not None:
            out["LR_Scheduler"] = self._lr_scheduler.state_dict()
        for pid, name in self._param_names().items():
            for k, v in self._slots.get(pid, {}).items():
                out[f"{name}.{k}"] = v.detach()
        return out

    def set_state_dict(self, state):
        """Load :meth:`state_dict`'s keys. Each slot lands on its
        parameter's device in the dtype it was saved in; the values are
        copied, never shared."""
        self._follow_wrappers()
        self._step_count = int(state.get("step", 0))
        if self._lr_scheduler is not None and "LR_Scheduler" in state:
            self._lr_scheduler.set_state_dict(state["LR_Scheduler"])
        by_name = {v: k for k, v in self._param_names().items()}
        params = {id(p): p for p in self._parameter_list or []}
        for key, val in state.items():
            if key in ("step", "LR_Scheduler"):
                continue
            pname, _, slot = key.rpartition(".")
            pid = by_name.get(pname)
            if pid is None:
                continue
            slots = self._slots.setdefault(pid, {})
            if slots.get(slot) is not val:   # a restore filled it in place
                slots[slot] = _as_tensor(val, params[pid].device)

    def _param_names(self) -> Dict[int, str]:
        """Stable slot keys: a given name, else the position in the
        parameter list (``param_<i>``, ``param_<i>__auto`` where that
        would collide with a given name), as the JAX package keys them."""
        plist = self._parameter_list or []
        explicit = {self._names[id(p)] for p in plist if id(p) in self._names}
        out = {}
        for i, p in enumerate(plist):
            name = self._names.get(id(p))
            if name is None:
                name = f"param_{i}"
                if name in explicit:
                    name = f"param_{i}__auto"
            out[id(p)] = name
        return out


def _float(x) -> float:
    return float(x.detach()) if isinstance(x, torch.Tensor) else float(x)


def _where(cond, a, b):
    """``a if cond else b`` for a Python bool, else torch.where."""
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    return a if cond else b


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._multi_precision = bool(kw.get("multi_precision", False))

    def _rule(self, p, g, slots, lr, step):
        g = self._apply_weight_decay_to_grad(p, g)
        return p - lr * g, slots


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._multi_precision = bool(kw.get("multi_precision", False))
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_slots(self, p):
        return {"velocity": torch.zeros_like(p)}

    def _rule(self, p, g, slots, lr, step):
        g = self._apply_weight_decay_to_grad(p, g)
        v = self._momentum * slots["velocity"] + g
        if self._nesterov:
            p2 = p - lr * (g + self._momentum * v)
        else:
            p2 = p - lr * v
        return p2, {"velocity": v}


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._multi_precision = bool(kw.get("multi_precision", False))
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def _init_slots(self, p):
        return {"moment": torch.full_like(p, self._init_acc)}

    def _rule(self, p, g, slots, lr, step):
        g = self._apply_weight_decay_to_grad(p, g)
        m = slots["moment"] + g.square()
        return p - lr * g / (m.sqrt() + self._eps), {"moment": m}


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._multi_precision = bool(kw.get("multi_precision", False))
        self._eps = epsilon
        self._rho = rho

    def _init_slots(self, p):
        return {"avg_sq_grad": torch.zeros_like(p),
                "avg_sq_update": torch.zeros_like(p)}

    def _rule(self, p, g, slots, lr, step):
        g = self._apply_weight_decay_to_grad(p, g)
        asg = self._rho * slots["avg_sq_grad"] + (1 - self._rho) * g.square()
        update = g * (slots["avg_sq_update"] + self._eps).sqrt() / \
            (asg + self._eps).sqrt()
        asu = self._rho * slots["avg_sq_update"] + \
            (1 - self._rho) * update.square()
        return p - lr * update, {"avg_sq_grad": asg, "avg_sq_update": asu}


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._multi_precision = bool(kw.get("multi_precision", False))
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_slots(self, p):
        s = {"mean_square": torch.zeros_like(p),
             "momentum": torch.zeros_like(p)}
        if self._centered:
            s["mean_grad"] = torch.zeros_like(p)
        return s

    def _rule(self, p, g, slots, lr, step):
        g = self._apply_weight_decay_to_grad(p, g)
        ms = self._rho * slots["mean_square"] + (1 - self._rho) * g.square()
        new = {"mean_square": ms}
        if self._centered:
            mg = self._rho * slots["mean_grad"] + (1 - self._rho) * g
            denom = (ms - mg.square() + self._eps).sqrt()
            new["mean_grad"] = mg
        else:
            denom = (ms + self._eps).sqrt()
        mom = self._momentum * slots["momentum"] + lr * g / denom
        new["momentum"] = mom
        return p - mom, new


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
        if not self._decoupled():
            g = self._apply_weight_decay_to_grad(p, g)
        b1, b2 = self._beta1, self._beta2
        m = b1 * slots["moment1"] + (1 - b1) * g
        v = b2 * slots["moment2"] + (1 - b2) * g.square()
        # the JAX TrainStep's step and lr are f32 arrays, which take the
        # bias-corrected update of a bf16 parameter to f32: so here
        mhat = m.float() / (1 - b1 ** step)
        vhat = v.float() / (1 - b2 ** step)
        upd = lr * mhat / (vhat.sqrt() + self._eps)
        if self._decoupled() and self._weight_decay and \
                self._current_decay_enabled:
            upd = upd + (lr * self._decay_coeff()) * p.float()
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


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._multi_precision = bool(kw.get("multi_precision", False))
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _init_slots(self, p):
        return {"moment": torch.zeros_like(p),
                "inf_norm": torch.zeros_like(p)}

    def _rule(self, p, g, slots, lr, step):
        g = self._apply_weight_decay_to_grad(p, g)
        b1, b2 = self._beta1, self._beta2
        m = b1 * slots["moment"] + (1 - b1) * g
        u = torch.maximum(b2 * slots["inf_norm"], g.abs())
        p2 = p - lr / (1 - b1 ** step) * m / (u + self._eps)
        return p2, {"moment": m, "inf_norm": u}


class Lamb(Optimizer):
    """Layer-wise adaptive moments."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip)
        self._multi_precision = bool(kw.get("multi_precision", False))
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _decay_enabled(self, param):
        if self._exclude_fn is not None:
            # exclude_from_weight_decay_fn(param) -> True means EXCLUDE
            return not bool(self._exclude_fn(param))
        return True

    def _init_slots(self, p):
        return {"moment1": torch.zeros_like(p),
                "moment2": torch.zeros_like(p)}

    def _rule(self, p, g, slots, lr, step):
        b1, b2 = self._beta1, self._beta2
        m = b1 * slots["moment1"] + (1 - b1) * g
        v = b2 * slots["moment2"] + (1 - b2) * g.square()
        mhat = m / (1 - b1 ** step)
        vhat = v / (1 - b2 ** step)
        r = mhat / (vhat.sqrt() + self._eps)
        wd = (float(self._weight_decay)
              if self._weight_decay and self._current_decay_enabled else 0.0)
        r = r + wd * p
        w_norm = self._norm(p)
        r_norm = self._norm(r)
        ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        return p - lr * ratio * r, {"moment1": m, "moment2": v}


class NAdam(Adam):
    def _rule(self, p, g, slots, lr, step):
        g = self._apply_weight_decay_to_grad(p, g)
        b1, b2 = self._beta1, self._beta2
        m = b1 * slots["moment1"] + (1 - b1) * g
        v = b2 * slots["moment2"] + (1 - b2) * g.square()
        mhat = m / (1 - b1 ** (step + 1))
        vhat = v / (1 - b2 ** step)
        m_bar = b1 * mhat + (1 - b1) * g / (1 - b1 ** step)
        return p - lr * m_bar / (vhat.sqrt() + self._eps), \
            {"moment1": m, "moment2": v}


class RAdam(Adam):
    def _rule(self, p, g, slots, lr, step):
        g = self._apply_weight_decay_to_grad(p, g)
        b1, b2 = self._beta1, self._beta2
        m = b1 * slots["moment1"] + (1 - b1) * g
        v = b2 * slots["moment2"] + (1 - b2) * g.square()
        mhat = m / (1 - b1 ** step)
        rho_inf = 2.0 / (1 - b2) - 1.0
        rho_t = rho_inf - 2.0 * step * (b2 ** step) / (1 - b2 ** step)
        vhat = (v / (1 - b2 ** step)).sqrt()
        num = (rho_t - 4.0) * (rho_t - 2.0) * rho_inf
        den = (rho_inf - 4.0) * (rho_inf - 2.0)
        if isinstance(rho_t, torch.Tensor):
            rt = (num / (den * torch.clamp(rho_t, min=self._eps))).clamp(
                min=0.0).sqrt()
        else:
            rt = math.sqrt(max(num / (den * max(rho_t, self._eps)), 0.0))
        rectified = p - lr * rt * mhat / (vhat + self._eps)
        unrectified = p - lr * mhat
        return _where(rho_t > 4.0, rectified, unrectified), \
            {"moment1": m, "moment2": v}


class ASGD(Optimizer):
    """Averaged SGD over a window of the last ``batch_num`` gradients:
    x <- x - lr (d / min(t, n) + wd x), d the running sum of the last n
    grads held in a circular buffer (n copies of each parameter)."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None, **kw):
        if batch_num is None or batch_num <= 0:
            raise ValueError("batch_num should be greater than 0")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._multi_precision = bool(multi_precision)
        self._n = int(batch_num)

    def _init_slots(self, p):
        return {"d": torch.zeros_like(p),
                "ys": torch.zeros((self._n,) + tuple(p.shape),
                                  dtype=p.dtype, device=p.device)}

    def _rule(self, p, g, slots, lr, step):
        g = self._apply_weight_decay_to_grad(p, g)
        n = self._n
        if isinstance(step, torch.Tensor):
            idx = ((step.long() - 1) % n).view(1)
            m = step.to(p.dtype).clamp(max=float(n)).clamp(min=1.0)
        else:
            idx = torch.tensor([(int(step) - 1) % n], device=p.device)
            m = max(float(min(step, n)), 1.0)
        old = slots["ys"].index_select(0, idx)[0]
        d = slots["d"] - old + g
        ys = slots["ys"].index_copy(0, idx, g[None])
        return p - lr * d / m, {"d": d, "ys": ys}


class Rprop(Optimizer):
    """Resilient backprop: per-element step sizes grown by ``etas[1]`` on
    consecutive same-sign grads, shrunk by ``etas[0]`` on sign flips (the
    flip step is skipped, Rprop-), clipped to ``learning_rate_range``."""

    def __init__(self, learning_rate=0.001,
                 learning_rate_range=(1e-5, 50.0), parameters=None,
                 etas=(0.5, 1.2), grad_clip=None, multi_precision=False,
                 name=None, **kw):
        if not (0.0 < learning_rate_range[0] <= learning_rate
                <= learning_rate_range[1]):
            raise ValueError(
                "'0.0 < learning_rate_range[0] <= learning_rate <= "
                "learning_rate_range[1]' must be true")
        if not (0.0 < etas[0] < 1.0 <= etas[1]):
            raise ValueError("'0.0 < etas[0] < 1.0 <= etas[1]' must be true")
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._multi_precision = bool(multi_precision)
        self._lr0 = float(learning_rate)
        self._range = (float(learning_rate_range[0]),
                       float(learning_rate_range[1]))
        self._etas = (float(etas[0]), float(etas[1]))

    def _init_slots(self, p):
        return {"prev": torch.zeros_like(p),
                "lrs": torch.full_like(p, self._lr0)}

    def _rule(self, p, g, slots, lr, step):
        lo, hi = self._range
        eminus, eplus = self._etas
        sign = torch.sign(g * slots["prev"])
        lrs = torch.where(sign > 0,
                          torch.clamp(slots["lrs"] * eplus, max=hi),
                          torch.where(sign < 0,
                                      torch.clamp(slots["lrs"] * eminus,
                                                  min=lo),
                                      slots["lrs"]))
        g_eff = torch.where(sign < 0, torch.zeros_like(g), g)
        return p - torch.sign(g_eff) * lrs, {"prev": g_eff, "lrs": lrs}


class LBFGS(Optimizer):
    """Limited-memory BFGS with optional strong-Wolfe line search: the
    closure-based ``step(closure)``; two-loop recursion over
    ``history_size`` curvature pairs; ``line_search_fn='strong_wolfe'``
    runs the cubic-interpolation zoom."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._max_iter = int(max_iter)
        self._max_eval = int(max_eval) if max_eval is not None \
            else self._max_iter * 5 // 4
        self._tol_grad = float(tolerance_grad)
        self._tol_change = float(tolerance_change)
        self._history = int(history_size)
        if line_search_fn not in (None, "strong_wolfe"):
            raise ValueError(
                "line_search_fn must be None or 'strong_wolfe'")
        self._line_search = line_search_fn
        self._state = {"old_dirs": [], "old_stps": [], "ro": [],
                       "prev_flat_grad": None, "d": None, "t": None,
                       "H_diag": 1.0, "n_iter": 0, "func_evals": 0}

    # ---- flatten helpers -------------------------------------------------
    def _params(self):
        self._follow_wrappers()
        return [p for p in (self._parameter_list or []) if p.requires_grad]

    def _gather_flat_grad(self):
        gs = []
        for p in self._params():
            g = p.grad.detach().clone() if p.grad is not None else \
                torch.zeros_like(p)
            # weight decay folds into the objective's gradient so the
            # line search sees the regularized objective too
            self._current_decay_enabled = self._decay_enabled(p)
            g = self._apply_weight_decay_to_grad(p.detach(), g)
            self._current_decay_enabled = True
            gs.append(g)
        clip_fn = getattr(self._grad_clip, "clip_fn", None)
        if clip_fn is not None:
            gs = clip_fn(gs)
        elif self._grad_clip is not None:
            raise NotImplementedError(
                "LBFGS supports grad clips with a pure clip_fn "
                "(ClipGradByGlobalNorm)")
        return torch.cat([g.float().reshape(-1) for g in gs])

    @torch.no_grad()
    def _add_to_params(self, step_size, update_flat):
        off = 0
        for p in self._params():
            n = p.numel()
            seg = update_flat[off:off + n].view(p.shape)
            p.copy_(p + (step_size * seg).to(p.dtype))
            off += n

    def _clone_params(self):
        return [p.detach().clone() for p in self._params()]

    @torch.no_grad()
    def _restore_params(self, saved):
        for p, d in zip(self._params(), saved):
            p.copy_(d)

    def _call_closure(self, closure):
        # grad recording must be ON regardless of the caller's context:
        # the closure's backward() is what feeds the line search
        with torch.enable_grad():
            return closure()

    def _eval(self, closure, x0, t, d):
        self._restore_params(x0)
        self._add_to_params(t, d)
        loss = _float(self._call_closure(closure))
        flat_grad = self._gather_flat_grad()
        self._state["func_evals"] += 1
        return loss, flat_grad

    def step(self, closure=None):
        """``closure`` re-evaluates the model and returns the loss (it
        must call ``backward()``)."""
        if closure is None:
            raise ValueError("LBFGS.step requires a closure")
        state = self._state
        self._step_count += 1
        lr = float(self.get_lr())

        orig_loss = self._call_closure(closure)
        loss = _float(orig_loss)
        flat_grad = self._gather_flat_grad()
        if float(flat_grad.abs().max()) <= self._tol_grad:
            return orig_loss

        n_iter = 0
        while n_iter < self._max_iter:
            n_iter += 1
            state["n_iter"] += 1
            if state["n_iter"] == 1:
                d = -flat_grad
                state["old_dirs"], state["old_stps"], state["ro"] = \
                    [], [], []
                H_diag = 1.0
            else:
                y = flat_grad - state["prev_flat_grad"]
                s = state["d"] * state["t"]
                ys = float(torch.dot(y, s))
                if ys > 1e-10:
                    if len(state["old_dirs"]) >= self._history:
                        state["old_dirs"].pop(0)
                        state["old_stps"].pop(0)
                        state["ro"].pop(0)
                    state["old_dirs"].append(y)
                    state["old_stps"].append(s)
                    state["ro"].append(1.0 / ys)
                    H_diag = ys / float(torch.dot(y, y))
                else:
                    H_diag = state["H_diag"]
                # two-loop recursion
                q = -flat_grad
                al = []
                for y_i, s_i, ro_i in zip(reversed(state["old_dirs"]),
                                          reversed(state["old_stps"]),
                                          reversed(state["ro"])):
                    a = ro_i * float(torch.dot(s_i, q))
                    al.append(a)
                    q = q - a * y_i
                d = q * H_diag
                for (y_i, s_i, ro_i), a in zip(
                        zip(state["old_dirs"], state["old_stps"],
                            state["ro"]), reversed(al)):
                    b = ro_i * float(torch.dot(y_i, d))
                    d = d + s_i * (a - b)
            state["H_diag"] = H_diag
            state["prev_flat_grad"] = flat_grad

            gtd = float(torch.dot(flat_grad, d))
            if gtd > -self._tol_change:
                break
            t = min(1.0, 1.0 / float(flat_grad.abs().sum())) * lr \
                if state["n_iter"] == 1 else lr

            if self._line_search == "strong_wolfe":
                x0 = self._clone_params()
                loss, flat_grad, t = self._strong_wolfe(
                    closure, x0, t, d, loss, flat_grad, gtd)
                self._restore_params(x0)
                self._add_to_params(t, d)
            else:
                self._add_to_params(t, d)
                if n_iter < self._max_iter:
                    loss = _float(self._call_closure(closure))
                    flat_grad = self._gather_flat_grad()
            state["d"], state["t"] = d, t

            if state["func_evals"] >= self._max_eval:
                break
            if float(flat_grad.abs().max()) <= self._tol_grad:
                break
            if float((d * t).abs().max()) <= self._tol_change:
                break
        return orig_loss

    def _strong_wolfe(self, closure, x0, t, d, f0, g0, gtd0,
                      c1=1e-4, c2=0.9, max_ls=25):
        """Strong-Wolfe line search with cubic-interpolation zoom."""

        def cubic_min(x1, f1, g1, x2, f2, g2):
            d1 = g1 + g2 - 3 * (f1 - f2) / (x1 - x2)
            sq = d1 * d1 - g1 * g2
            if sq < 0:
                return (x1 + x2) / 2.0
            d2 = np.sqrt(sq)
            if x1 <= x2:
                xm = x2 - (x2 - x1) * ((g2 + d2 - d1) / (g2 - g1 + 2 * d2))
            else:
                xm = x1 - (x1 - x2) * ((g1 + d2 - d1) / (g1 - g2 + 2 * d2))
            lo, hi = min(x1, x2), max(x1, x2)
            return float(np.clip(xm, lo + 0.1 * (hi - lo),
                                 hi - 0.1 * (hi - lo)))

        f_prev, g_prev, t_prev = f0, g0, 0.0
        gtd_prev = gtd0
        ls_iter = 0
        while ls_iter < max_ls:
            f_new, g_new = self._eval(closure, x0, t, d)
            gtd_new = float(torch.dot(g_new, d))
            if f_new > f0 + c1 * t * gtd0 or \
                    (ls_iter > 0 and f_new >= f_prev):
                return self._zoom(closure, x0, d, f0, gtd0, t_prev,
                                  f_prev, gtd_prev, t, f_new, gtd_new,
                                  c1, c2, max_ls - ls_iter, cubic_min)
            if abs(gtd_new) <= -c2 * gtd0:
                return f_new, g_new, t
            if gtd_new >= 0:
                return self._zoom(closure, x0, d, f0, gtd0, t, f_new,
                                  gtd_new, t_prev, f_prev, gtd_prev,
                                  c1, c2, max_ls - ls_iter, cubic_min)
            t_prev, f_prev, gtd_prev = t, f_new, gtd_new
            t = min(t * 2.0, 10.0)
            ls_iter += 1
        return f_new, g_new, t

    def _zoom(self, closure, x0, d, f0, gtd0, t_lo, f_lo, gtd_lo, t_hi,
              f_hi, gtd_hi, c1, c2, max_ls, cubic_min):
        f_new, g_new, t = f_lo, None, t_lo
        for _ in range(max(int(max_ls), 1)):
            t = cubic_min(t_lo, f_lo, gtd_lo, t_hi, f_hi, gtd_hi)
            f_new, g_new = self._eval(closure, x0, t, d)
            gtd_new = float(torch.dot(g_new, d))
            if f_new > f0 + c1 * t * gtd0 or f_new >= f_lo:
                t_hi, f_hi, gtd_hi = t, f_new, gtd_new
            else:
                if abs(gtd_new) <= -c2 * gtd0:
                    return f_new, g_new, t
                if gtd_new * (t_hi - t_lo) >= 0:
                    t_hi, f_hi, gtd_hi = t_lo, f_lo, gtd_lo
                t_lo, f_lo, gtd_lo = t, f_new, gtd_new
            if abs(t_hi - t_lo) < 1e-9:
                break
        if g_new is None:
            f_new, g_new = self._eval(closure, x0, t, d)
        return f_new, g_new, t
