"""Automatic mixed precision (port of ``paddle_tpu/amp/__init__.py``).

* :class:`GradScaler`: dynamic loss scaling with the JAX package's
  schedule, its ``max_consecutive_skips`` divergence guard and state.
  ``unscale_`` reduces every gradient's finiteness to one bool on the
  device and waits on the host once.
* ``scaler_init_state``, ``scaler_unscale_and_check``,
  ``scaler_update_state`` and ``scaler_sync_from_state``: the same
  schedule on a 5-wide f32 device tensor ``[scale, good_steps,
  bad_steps, skipped_total, consecutive_skips]``, for ``jit.TrainStep``.
* :func:`decorate` (O1, O2), :func:`is_bfloat16_supported`,
  :func:`is_float16_supported`.
* :func:`auto_cast` / :data:`amp_guard`: the JAX package casts at its op
  registry's boundary, and so does the port for a Tensor API op
  (:func:`cast_for_op`, the registry's ``_AMP_HOOK``: the op is one cast
  site, and its emitter then runs with torch function modes off). Code
  on raw torch tensors (the Llama modules) is cast by a
  ``torch.overrides.TorchFunctionMode``: the inputs of the torch
  functions, and of the port functions marked as ops
  (:func:`paddle_tpu_torch.core.op.op`). Either way, names in
  :data:`WHITE_LIST` cast f32 inputs to the compute dtype, names in
  :data:`BLACK_LIST` cast floating inputs to f32, and under O2 every call
  but a black-listed one casts f32 inputs to the compute dtype.
  :data:`TORCH_NAMES` maps each list name to the function the mode sees.
"""
from __future__ import annotations

import contextlib
import threading
from typing import List, Optional

import torch
from torch.overrides import TorchFunctionMode

from paddle_tpu_torch.core.dtype import to_torch

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler",
           "is_bfloat16_supported", "is_float16_supported", "white_list",
           "black_list", "scaler_init_state", "scaler_unscale_and_check",
           "scaler_update_state", "scaler_sync_from_state"]

# O1 lists (the JAX package's, after python/paddle/amp/amp_lists.py)
WHITE_LIST = {
    "matmul", "bmm", "mv", "linear", "conv1d", "conv2d", "conv3d",
    "conv2d_transpose", "einsum", "scaled_dot_product_attention",
}
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "logsumexp", "softmax",
    "log_softmax", "cross_entropy", "softmax_with_cross_entropy",
    "binary_cross_entropy", "binary_cross_entropy_with_logits", "nll_loss",
    "kl_div", "layer_norm", "batch_norm", "group_norm", "instance_norm",
    "rms_norm", "mean", "sum", "cumsum", "var", "std", "norm",
}

white_list = WHITE_LIST
black_list = BLACK_LIST

# each list name -> the __name__ of the function the mode sees: a torch
# function or method of that name, or a port op (core/op.py:
# rms_norm, softmax_with_cross_entropy, scaled_dot_product_attention)
TORCH_NAMES = {name: name for name in WHITE_LIST | BLACK_LIST}
TORCH_NAMES["conv2d_transpose"] = "conv_transpose2d"
_BY_TORCH_NAME = {t: n for n, t in TORCH_NAMES.items()}

_state = threading.local()


def amp_state():
    return getattr(_state, "amp", None)


def _cast_tree(x, want):
    """``want(t)`` -> dtype or None, applied to every tensor in x."""
    if isinstance(x, torch.Tensor):
        dt = want(x)
        return x if dt is None or dt == x.dtype else x.to(dt)
    if isinstance(x, (list, tuple)):
        return type(x)(_cast_tree(y, want) for y in x)
    return x


def _tensors(x, out):
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    return out


def _functional(func) -> bool:
    """Not an in-place method, a dunder or a conversion: what O2 may
    hand a cast copy of its inputs (a cast copy of an in-place op's
    target would lose the write)."""
    name = getattr(func, "__name__", "") or ""
    return not (name.endswith("_") or name.startswith("__")
                or name in ("to", "float", "double", "half", "bfloat16",
                            "type", "type_as", "copy_", "set_"))


class _AutoCastMode(TorchFunctionMode):
    def __init__(self, st):
        super().__init__()
        self._st = st

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        st = self._st
        if amp_state() is not st:
            # a nested auto_cast (or enable=False) owns this call; the
            # outer mode sees it again when the inner one runs it
            return func(*args, **kwargs)
        name = _BY_TORCH_NAME.get(getattr(func, "__name__", None))
        dt = st["dtype"]
        if name is not None and name in st["black"]:
            def want(t):
                return torch.float32 if t.is_floating_point() else None
        elif name is not None and name in st["white"] or (
                st["level"] == "O2" and name is None
                and _functional(func)):
            def want(t):
                return dt if t.dtype == torch.float32 else None
        else:
            want = None
        if want is not None:
            args = _cast_tree(args, want)
            kwargs = {k: _cast_tree(v, want) for k, v in kwargs.items()}
        if name is not None and st["observers"]:
            seen = [str(t.dtype).split(".")[-1]
                    for t in _tensors(list(args) + list(kwargs.values()), [])]
            for obs in st["observers"]:
                obs.append((name, seen))
        return func(*args, **kwargs)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """paddle.amp.auto_cast: level O1 casts per the lists, O2 casts every
    f32 input to the compute dtype except a black-listed call's."""
    prev = amp_state()
    if not enable:
        _state.amp = None
        try:
            yield
        finally:
            _state.amp = prev
        return
    wl = set(WHITE_LIST) | set(custom_white_list or ())
    bl = set(BLACK_LIST) | set(custom_black_list or ())
    st = {"dtype": to_torch(dtype), "level": level, "white": wl,
          "black": bl, "observers": list(prev["observers"]) if prev else []}
    _state.amp = st
    try:
        with _AutoCastMode(st):
            yield
    finally:
        _state.amp = prev


amp_guard = auto_cast


def cast_for_op(op_name, datas):
    """The op registry's hook (called with a Tensor API op's name and the
    data of its tensor arguments): the data cast per the active policy,
    or None when no :func:`auto_cast` is active."""
    st = amp_state()
    if st is None:
        return None
    dt = st["dtype"]
    if op_name in st["black"]:
        out = [d.float() if isinstance(d, torch.Tensor)
               and d.is_floating_point() else d for d in datas]
    elif st["level"] == "O2" or op_name in st["white"]:
        out = [d.to(dt) if isinstance(d, torch.Tensor)
               and d.dtype == torch.float32 else d for d in datas]
    else:
        out = list(datas)
    if st["observers"] and (op_name in st["white"]
                            or op_name in st["black"]):
        seen = [str(t.dtype).split(".")[-1] for t in _tensors(out, [])]
        for obs in st["observers"]:
            obs.append((op_name, seen))
    return out


@contextlib.contextmanager
def observe_casts():
    """Inside an :func:`auto_cast`, record ``(list name, input dtypes)``
    of every white- or black-listed call, after the cast; yields the
    list."""
    st = amp_state()
    if st is None:
        raise RuntimeError("observe_casts needs an active auto_cast")
    seen: List = []
    st["observers"].append(seen)
    try:
        yield seen
    finally:
        st["observers"].remove(seen)


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None, **kw):
    """O2: cast the models' floating parameters (in place: the optimizers
    keep them) and state-dict buffers to the compute dtype; master
    weights live in the optimizers' ``multi_precision`` slots. O1 leaves
    the models as they are. Non-persistent buffers (the rope tables,
    which the JAX model rebuilds rather than holds) keep their dtype."""
    single = isinstance(models, torch.nn.Module)
    model_list = [models] if single else list(models)
    if level == "O2":
        dt = to_torch(dtype)
        with torch.no_grad():
            for m in model_list:
                for p in m.parameters():
                    if p.is_floating_point():
                        p.data = p.data.to(dt)
                for mod in m.modules():
                    for name, b in mod._buffers.items():
                        if b is not None and b.is_floating_point() and \
                                name not in mod._non_persistent_buffers_set:
                            mod._buffers[name] = b.to(dt)
    if optimizers is None:
        return models if single else model_list
    return (models if single else model_list), optimizers


class GradScaler:
    """Loss scaler with the JAX package's dynamic schedule. (The JAX
    package's ``step`` also runs ``update``, so a loop that calls both
    updates twice per step, as it does there.)"""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True,
                 max_consecutive_skips=50):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._already_unscaled = False
        # divergence guard: N consecutive found_inf skips means the run
        # is NaN for real, not a transient overflow (0 disables it)
        self._max_consecutive_skips = int(max_consecutive_skips or 0)
        self._skipped_steps = 0
        self._consecutive_skips = 0

    @property
    def skipped_steps(self) -> int:
        """Total optimizer steps skipped because of non-finite grads."""
        return self._skipped_steps

    def _check_diverged(self):
        if self._max_consecutive_skips and \
                self._consecutive_skips >= self._max_consecutive_skips:
            raise RuntimeError(
                f"training diverged: {self._consecutive_skips} "
                f"consecutive steps produced non-finite gradients "
                f"(loss scale is down to {self._scale}); restore from a "
                f"checkpoint with a lower learning rate instead of "
                f"letting the scaler halve the scale forever. Raise "
                f"GradScaler(max_consecutive_skips=...) to tolerate "
                f"longer bursts.")

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Multiply every ``.grad`` by 1/scale in place and set
        ``found_inf`` from one device reduction, read once."""
        if not self._enable or self._already_unscaled:
            return
        inv = 1.0 / self._scale
        grads = [p.grad for p in optimizer._parameter_list or []
                 if p.grad is not None]
        found = False
        if grads:
            torch._foreach_mul_(grads, inv)
            bad = torch.stack([(~torch.isfinite(g)).any() for g in grads])
            found = bool(bad.any())
        self._found_inf = found
        self._already_unscaled = True

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)

    def update(self):
        self._already_unscaled = False
        if self._found_inf:
            self._skipped_steps += 1
            self._consecutive_skips += 1
        else:
            self._consecutive_skips = 0
        if self._dynamic:
            if self._found_inf:
                self._bad_steps += 1
                self._good_steps = 0
                if self._bad_steps >= self._decr_every:
                    self._scale = max(self._scale * self._decr_ratio, 1.0)
                    self._bad_steps = 0
            else:
                self._good_steps += 1
                self._bad_steps = 0
                if self._good_steps >= self._incr_every:
                    self._scale *= self._incr_ratio
                    self._good_steps = 0
        self._check_diverged()

    def is_enable(self):
        return self._enable

    def get_loss_scaling(self):
        return torch.tensor(self._scale)

    def state_dict(self):
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps,
                "skipped_steps": self._skipped_steps,
                "consecutive_skips": self._consecutive_skips}

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)
        self._skipped_steps = int(state.get("skipped_steps", 0))
        self._consecutive_skips = int(state.get("consecutive_skips", 0))


# -- the compiled-step schedule (jit.TrainStep) ------------------------------
def scaler_init_state(scaler, device=None) -> Optional[torch.Tensor]:
    """[scale, good_steps, bad_steps, skipped_total, consecutive_skips]
    as an f32 tensor on ``device``, or None when scaling is off."""
    if scaler is None or not scaler.is_enable():
        return None
    return torch.tensor([scaler._scale, float(scaler._good_steps),
                         float(scaler._bad_steps),
                         float(scaler._skipped_steps),
                         float(scaler._consecutive_skips)],
                        dtype=torch.float32, device=device)


def scaler_unscale_and_check(grads, state):
    """Unscale ``grads`` by the state's scale: each times the f32
    reciprocal, promoted to f32 as the JAX step's ``g * (1 / scale)``
    promotes a bf16 gradient; found_inf = any non-finite gradient, a
    0-dim bool on the device."""
    inv = 1.0 / state[0]
    gs = [g.to(torch.promote_types(g.dtype, torch.float32)) * inv
          for g in grads]
    if not gs:
        return gs, torch.zeros((), dtype=torch.bool, device=state.device)
    found = torch.stack([(~torch.isfinite(g)).any() for g in gs]).any()
    return gs, found


def scaler_update_state(scaler, state, found):
    """The dynamic loss-scale schedule on the device (mirrors
    ``GradScaler.update``)."""
    scale, good, bad = state[0], state[1], state[2]
    zero = torch.zeros_like(scale)
    skipped2 = state[3] + found.float()
    consec2 = torch.where(found, state[4] + 1.0, zero)
    if not scaler._dynamic:
        return torch.stack([scale, good, bad, skipped2, consec2])
    bad2 = torch.where(found, bad + 1.0, zero)
    good2 = torch.where(found, zero, good + 1.0)
    dec = bad2 >= scaler._decr_every
    inc = good2 >= scaler._incr_every
    scale2 = torch.where(dec, torch.clamp(scale * scaler._decr_ratio,
                                          min=1.0),
                         torch.where(inc & ~found,
                                     scale * scaler._incr_ratio, scale))
    return torch.stack([scale2, torch.where(inc, zero, good2),
                        torch.where(dec, zero, bad2), skipped2, consec2])


def scaler_sync_from_state(scaler, state):
    """Write the device state back onto the Python ``GradScaler`` (one
    host read) and apply the divergence guard, so the compiled path
    fails as the eager one does."""
    s = state.detach().cpu().tolist()
    scaler._scale = float(s[0])
    scaler._good_steps = int(s[1])
    scaler._bad_steps = int(s[2])
    if len(s) > 4:  # state from an older checkpoint may be 3 wide
        scaler._skipped_steps = int(s[3])
        scaler._consecutive_skips = int(s[4])
        scaler._check_diverged()


def is_bfloat16_supported(place=None):
    return True


def is_float16_supported(place=None):
    return True


# the op registry's dispatch-boundary hook
from paddle_tpu_torch.ops import registry as _registry  # noqa: E402

_registry.set_amp_hook(cast_for_op)
