"""Weights and state across frameworks: the JAX Llama's state dict,
AdamW slots and optimizer ``state_dict``, a JAX ``nn.Layer``'s state
dict with the generator's state, and the JAX BERT's and vision models'
-> the port's."""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

__all__ = ["llama_state_from_jax", "llama_pipe_state_from_jax",
           "llama_pipe_state_from_causal_lm", "llama_pipe_state_to_jax",
           "optimizer_slots_from_jax",
           "optimizer_state_from_jax", "layer_state_from_jax",
           "bert_state_from_jax", "vision_state_from_jax",
           "moe_state_from_jax"]


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


def _load_exactly(fn: str, state, model) -> None:
    """Load ``state`` into ``model`` once it names exactly the model's
    state keys, parameters and buffers (``KeyError`` otherwise)."""
    own = model.state_dict()
    extra = sorted(set(state) - set(own))
    missing = sorted(set(own) - set(state))
    if extra or missing:
        raise KeyError(f"{fn}: keys left over {extra[:8]}, "
                       f"missing {missing[:8]}")
    model.set_state_dict(state)


def bert_state_from_jax(np_state: Mapping[str, np.ndarray], rng_state,
                        model=None
                        ) -> Tuple[Dict[str, torch.Tensor], Tuple[int, int]]:
    """The JAX BERT's ``state_dict()`` (numpy) and generator ``(seed,
    counter)`` -> the port's, as :func:`layer_state_from_jax` gives them
    (the layouts agree). With ``model`` (a port BERT of the same config)
    the state must name exactly the model's keys (a key left over or
    missing raises ``KeyError``) and is loaded into it; for a
    ``BertForMaskedLM`` the decoder must then still be the word
    embedding, one tensor (``ValueError`` otherwise)."""
    state, rng = layer_state_from_jax(np_state, rng_state)
    if model is None:
        return state, rng
    _load_exactly("bert_state_from_jax", state, model)
    if hasattr(model, "decoder_weight"):
        emb = model.bert.embeddings.word_embeddings.weight
        if model.decoder_weight._data is not emb._data:
            raise ValueError("bert_state_from_jax: the masked-LM decoder "
                             "is no longer the word embedding")
    return state, rng


def vision_state_from_jax(np_state: Mapping[str, np.ndarray], rng_state,
                          model
                          ) -> Tuple[Dict[str, torch.Tensor], Tuple[int, int]]:
    """A JAX ``vision.models`` network's ``state_dict()`` (numpy) and
    generator ``(seed, counter)`` loaded into ``model``, the port's network
    of the same family and config: the parameters and the batch norms'
    running ``_mean`` / ``_variance`` buffers, which
    :func:`layer_state_from_jax` carries as they are but no
    ``set_state_dict`` checks. Every key of the model must be in the state
    and no other (``KeyError``). Returns the state and the generator
    pair."""
    state, rng = layer_state_from_jax(np_state, rng_state)
    _load_exactly("vision_state_from_jax", state, model)
    return state, rng


def llama_pipe_state_from_jax(np_state: Mapping[str, np.ndarray],
                              body_layers=None) -> Dict[str, torch.Tensor]:
    """Turn the JAX ``LlamaForCausalLMPipe``'s ``state_dict()`` (values as
    numpy: ``pre_layers.0.weight``, ``body_layers.<k>.*`` for each of the
    L layers, ``post_layers.0.*``) into the state of a port rank's stage
    of :func:`paddle_tpu_torch.models.llama.LlamaForCausalLMPipe`: the
    same names, the Linear weights turned to torch's ``[out, in]``, and
    of the body only the layers in ``body_layers`` (all when None), the
    layers a rank's ``PipelineLayer`` holds."""
    keep = None if body_layers is None else {int(k) for k in body_layers}
    out = {}
    for name, value in np_state.items():
        if name.startswith("body_layers.") and keep is not None and \
                int(name.split(".")[1]) not in keep:
            continue
        arr = np.asarray(value)
        if name.endswith("_proj.weight") or name.endswith("lm_head.weight"):
            arr = arr.T
        out[name] = _to_tensor(arr)
    return out


def llama_pipe_state_from_causal_lm(state: Mapping[str, torch.Tensor],
                                    body_layers=None
                                    ) -> Dict[str, torch.Tensor]:
    """The port ``LlamaForCausalLM``'s state dict as the state of a
    ``LlamaForCausalLMPipe`` stage (the same tensors, renamed): the
    embedding is ``pre_layers.0.weight``, layer k ``body_layers.<k>``
    (only those in ``body_layers`` when given), the final norm and the
    head ``post_layers.0.*``. A tied model's head is the embedding and
    is left out."""
    keep = None if body_layers is None else {int(k) for k in body_layers}
    out = {}
    for name, t in state.items():
        if name == "llama.embed_tokens.weight":
            out["pre_layers.0.weight"] = t
        elif name.startswith("llama.layers."):
            k, rest = name[len("llama.layers."):].split(".", 1)
            if keep is None or int(k) in keep:
                out[f"body_layers.{k}.{rest}"] = t
        elif name == "llama.norm.weight":
            out["post_layers.0.norm.weight"] = t
        elif name == "lm_head.weight":
            if t is not state.get("llama.embed_tokens.weight"):
                out["post_layers.0.lm_head.weight"] = t
        else:
            raise KeyError(f"no Pipe parameter for {name!r}")
    return out


def llama_pipe_state_to_jax(state: Mapping[str, torch.Tensor]
                            ) -> Dict[str, torch.Tensor]:
    """A port ``LlamaForCausalLMPipe`` stage's parameters (its
    ``state_dict()``, or ``PipelineTrainStep.state_dict()["model"]``)
    under the JAX Pipe's keys and layout: the same names, each Linear
    weight as an ``[in, out]`` view of the same tensor. A view shares its
    tensor's storage, so a multi-rank checkpoint finds the tensor's
    layout (transposed) for it, and a load through it fills the tensor
    in place."""
    return {n: (t.t() if n.endswith("_proj.weight")
                or n.endswith("lm_head.weight") else t)
            for n, t in state.items()}


def moe_state_from_jax(np_state: Mapping[str, np.ndarray], ep_rank: int = 0,
                       ep_size: int = 1) -> Dict[str, torch.Tensor]:
    """A JAX model's state dict holding ``MoELayer``s (values as numpy) ->
    what the port's ``Layer.set_state_dict`` takes: the same names
    (``<layer>.expert_leaf_<i>``, the stacked [E, ...] expert leaves, and
    ``<layer>.gate.weight``; both layer APIs keep a ``Linear`` weight
    [in, out]), each expert leaf cut to ep rank ``ep_rank``'s E/ep_size
    experts when ``ep_size`` > 1 (the slice ``shard_model_parameters``
    leaves on that rank)."""
    out = {}
    for name, value in np_state.items():
        arr = np.asarray(value)
        if ep_size > 1 and name.rsplit(".", 1)[-1].startswith("expert_leaf_"):
            if arr.shape[0] % ep_size:
                raise ValueError(f"{name}: {arr.shape[0]} experts do not "
                                 f"split over {ep_size} ep ranks")
            arr = np.split(arr, ep_size)[ep_rank]
        out[name] = _to_tensor(arr)
    return out
