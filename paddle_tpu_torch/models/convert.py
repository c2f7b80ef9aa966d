"""Weights across frameworks: the JAX Llama's state dict -> the port's."""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["llama_state_from_jax"]


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
    rebuilds them from the config."""
    out: Dict[str, torch.Tensor] = {}
    for name, value in np_state.items():
        arr = np.asarray(value)
        linear = name.endswith("_proj.weight") or name == "lm_head.weight"
        if linear:
            if arr.ndim != 2:
                raise ValueError(f"{name}: expected a 2-D [in, out] weight, "
                                 f"got shape {arr.shape}")
            arr = arr.T
        out[name] = _to_tensor(arr)
    return out
