"""Weights and optimizer state across frameworks: the JAX Llama's state
dict and AdamW slots -> the port's."""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["llama_state_from_jax", "optimizer_slots_from_jax"]


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
