"""Weights and state across frameworks: the JAX Llama's state dict,
AdamW slots and optimizer ``state_dict``, and a JAX ``nn.Layer``'s
state dict with the generator's state -> the port's."""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

__all__ = ["llama_state_from_jax", "optimizer_slots_from_jax",
           "optimizer_state_from_jax", "layer_state_from_jax"]


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.array(arr, order="C")   # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":   # ml_dtypes' numpy bfloat16
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def llama_state_from_jax(np_state: Mapping[str, np.ndarray]
                         ) -> Dict[str, torch.Tensor]:
    """Turn the JAX ``LlamaForCausalLM.state_dict()`` (values as numpy
    arrays) into a state dict for
    :class:`paddle_tpu_torch.models.llama.LlamaForCausalLM`. The names
    match; the JAX ``Linear`` weights are stored ``[in, out]`` and are
    transposed to torch's ``[out, in]``. Embedding and norm weights copy
    as they are. The rope tables are not in either state dict: each side
    rebuilds them from the config.

    A tied JAX state (``tie_word_embeddings``) holds the embedding and no
    ``lm_head.weight``; the head is then the embedding itself, as the
    port's tied head computes ``x @ E^T``, and the state loads into a
    tied port model."""
    out = {name: _to_tensor(_torch_layout(name, value))
           for name, value in np_state.items()}
    embed = out.get("llama.embed_tokens.weight")
    if "lm_head.weight" not in out and embed is not None:
        out["lm_head.weight"] = embed
    return out


def _torch_layout(name: str, value) -> np.ndarray:
    """A JAX Llama tensor named ``name`` in the port's layout: Linear
    weights (and their optimizer slots) [in, out] -> [out, in]."""
    arr = np.asarray(value)
    if name.endswith("_proj.weight") or name == "lm_head.weight":
        if arr.ndim != 2:
            raise ValueError(f"{name}: expected a 2-D [in, out] weight, "
                             f"got shape {arr.shape}")
        arr = arr.T
    return arr


def optimizer_slots_from_jax(np_slots: Mapping[str, Mapping[str, np.ndarray]],
                             model: torch.nn.Module, optimizer,
                             step: int) -> None:
    """Carry the JAX optimizer's slots into the port's ``optimizer`` for
    ``model``. ``np_slots`` maps each parameter name of the JAX
    ``LlamaForCausalLM`` (``named_parameters()``; the port uses the same
    names) to its slots as numpy arrays -- for AdamW ``moment1``,
    ``moment2`` and, under ``multi_precision``, ``master_weight``. Linear
    slots are transposed like the weights; each slot keeps the dtype the
    JAX one had and lands on the parameter's device. ``step`` is the JAX
    optimizer's applied step count: the port's bias correction goes on
    from it (``TrainStep`` picks it up at its next call)."""
    params = dict(model.named_parameters())
    for name, slots in np_slots.items():
        if name not in params:
            raise KeyError(f"{name}: no such parameter in the port's model")
        p = params[name]
        optimizer._slots[id(p)] = {
            k: _to_tensor(_torch_layout(name, v)).to(p.device)
            for k, v in slots.items()}
    optimizer._step_count = int(step)


def optimizer_state_from_jax(jax_state: Mapping, model: torch.nn.Module
                             ) -> dict:
    """Turn a JAX optimizer's ``state_dict()`` (over the JAX
    ``LlamaForCausalLM``'s ``parameters()``) into one for the port's
    ``Optimizer.set_state_dict`` over ``model.parameters()``, in the same
    order. ``step`` and ``LR_Scheduler`` carry over as they are. A slot
    key is ``<name>.<slot>``: the JAX package names a parameter with an
    automatic name ``param_<position>``, which the port's optimizer over
    bare tensors does too, so the key stays; a name of the model's
    (``named_parameters``) is kept as well. Each slot keeps its dtype;
    Linear slots are transposed like the weights (``[in, out]`` ->
    ``[out, in]``). Values may be JAX ``Tensor``s or numpy arrays."""
    names = [n for n, _ in model.named_parameters()]
    out = {}
    for key, val in jax_state.items():
        if key in ("step", "LR_Scheduler"):
            out[key] = val
            continue
        pname, _, slot = key.rpartition(".")
        if pname.startswith("param_"):
            pos = int(pname[len("param_"):].split("__")[0])
            layout_name = names[pos]
        elif pname in names:
            layout_name = pname
        else:
            raise KeyError(f"{key}: no parameter of the port's model is "
                           f"named {pname!r}")
        arr = np.asarray(val.numpy() if hasattr(val, "numpy") else val)
        if slot == "ys":   # ASGD's window: [n, *param shape]
            arr = np.stack([_torch_layout(layout_name, a) for a in arr])
        else:
            arr = _torch_layout(layout_name, arr)
        out[key] = _to_tensor(arr)
    return out


def layer_state_from_jax(np_state: Mapping[str, np.ndarray], rng_state
                         ) -> Tuple[Dict[str, torch.Tensor], Tuple[int, int]]:
    """A JAX ``nn.Layer``'s ``state_dict()`` (values as numpy arrays,
    bf16 as ml_dtypes' arrays) and the JAX generator's ``(seed,
    counter)`` -> what the port's ``Layer.set_state_dict`` and
    ``set_rng_state`` take: the same names over torch tensors (both layer
    APIs keep a ``Linear`` weight ``[in, out]``, so nothing is
    transposed) and the pair as ints. Both packages then hold the same
    weights and draw the same next keys."""
    state = {name: _to_tensor(value) for name, value in np_state.items()}
    return state, (int(rng_state[0]), int(rng_state[1]))
