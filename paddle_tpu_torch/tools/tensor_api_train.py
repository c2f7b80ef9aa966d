"""The Llama training step written over the Tensor API, beside the module
path it must reproduce; shared by ``chip_smoke.py`` (phase 20,
``tensor_api``) and ``tests/test_torch_card.py`` (at a small size).

:func:`forward` is the decoder as a function of ``to_tensor`` parameters
(``stop_gradient=False``) and registry ops only: ``embedding``,
``rms_norm``, ``matmul``, the manipulation ops of the rotary embedding,
``nn.functional.flash_attention`` (causal), ``silu``, ``multiply`` and
``cross_entropy`` (on f32 logits, the module criterion's recipe). Its
parameters are carried from a port ``LlamaForCausalLM`` built from the
same seed (:func:`tensor_params`), so the two paths start from the same
weights; :func:`compare_step0` holds one forward and ``loss.backward()``
of each against the other; :func:`train_tensor_api` runs AdamW steps over
the Tensor parameters (``paddle_tpu_torch.optimizer.AdamW`` takes them)
and :func:`train_module` the same steps over the module.

Run alone on the card::

    python -m paddle_tpu_torch.tools.tensor_api_train
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW

__all__ = ["build", "tensor_params", "batch", "forward", "module_loss",
           "compare_step0", "train_tensor_api", "train_module",
           "double_grad", "unpadded_case", "unpadded", "host_cost_per_op"]


def build(cfg: LlamaConfig, device, seed: int = 0) -> LlamaForCausalLM:
    """A port Llama with random weights from a seeded generator on
    ``device``."""
    model = LlamaForCausalLM(cfg, device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    return model


def tensor_params(model: LlamaForCausalLM) -> Dict[str, "paddle.Tensor"]:
    """Each parameter of ``model`` as a Tensor API leaf (a copy) under the
    module's name."""
    return {name: paddle.to_tensor(p.detach(), stop_gradient=False)
            for name, p in model.named_parameters()}


def batch(cfg: LlamaConfig, b: int, s: int, device, seed: int = 0):
    """(ids, labels) as int64 torch tensors on ``device``: random token
    ids and random labels from ``np.random.RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    x = rng.randint(0, cfg.vocab_size, (b, s))
    y = rng.randint(0, cfg.vocab_size, (b, s))
    return (torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))


def _rot(x):
    x1, x2 = paddle.chunk(x, 2, axis=-1)
    return paddle.concat([-x2, x1], axis=-1)


def _rope(q, k, cos, sin):
    """The module's rope_apply in Tensor ops: f32 tables broadcast over
    (b, s, h, d), the products in f32, cast back."""
    c = cos.unsqueeze([0, 2])
    s = sin.unsqueeze([0, 2])
    return ((q * c + _rot(q) * s).astype(q.dtype),
            (k * c + _rot(k) * s).astype(k.dtype))


def _proj(x, w):
    # an nn.Linear weight is [out, in]: x @ w^T, as F.linear computes
    return paddle.matmul(x, w, transpose_y=True)


def forward(p: Dict[str, "paddle.Tensor"], cfg: LlamaConfig, ids, labels,
            cos, sin):
    """The LM loss of a batch (Tensors ``ids`` and ``labels`` (b, s)),
    ``cos``/``sin`` the (s, head_dim) rope tables as Tensors."""
    b, s = ids.shape
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    hd = cfg.hidden_size // nh
    eps = cfg.rms_norm_eps
    x = F.embedding(ids, p["llama.embed_tokens.weight"])
    for i in range(cfg.num_hidden_layers):
        pre = f"llama.layers.{i}."
        h = F.rms_norm(x, p[pre + "input_layernorm.weight"], epsilon=eps)
        q = _proj(h, p[pre + "self_attn.q_proj.weight"]).reshape(
            [b, s, nh, hd])
        k = _proj(h, p[pre + "self_attn.k_proj.weight"]).reshape(
            [b, s, nkv, hd])
        v = _proj(h, p[pre + "self_attn.v_proj.weight"]).reshape(
            [b, s, nkv, hd])
        q, k = _rope(q, k, cos, sin)
        if nkv != nh:
            k = paddle.repeat_interleave(k, nh // nkv, axis=2)
            v = paddle.repeat_interleave(v, nh // nkv, axis=2)
        attn, _ = F.flash_attention(q, k, v, causal=True)
        x = x + _proj(attn.reshape([b, s, nh * hd]),
                      p[pre + "self_attn.o_proj.weight"])
        h = F.rms_norm(x, p[pre + "post_attention_layernorm.weight"],
                       epsilon=eps)
        gate = F.silu(_proj(h, p[pre + "mlp.gate_proj.weight"]))
        up = _proj(h, p[pre + "mlp.up_proj.weight"])
        x = x + _proj(paddle.multiply(gate, up),
                      p[pre + "mlp.down_proj.weight"])
    x = F.rms_norm(x, p["llama.norm.weight"], epsilon=eps)
    logits = _proj(x, p["lm_head.weight"])
    return F.cross_entropy(logits.astype("float32"), labels)


def _tables(model, s):
    return (paddle.to_tensor(model.llama.rope_cos[:s]),
            paddle.to_tensor(model.llama.rope_sin[:s]))


def module_loss(model, ids, labels):
    """The module path: ``LlamaForCausalLM.forward`` + the criterion."""
    return model.criterion(model.config)(model(ids), labels)


def _rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _cosine(a, b) -> float:
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    return float((a @ b) / (a.norm() * b.norm()).clamp_min(1e-30))


def compare_step0(model, params, ids, labels) -> dict:
    """One forward and ``loss.backward()`` through each path from the
    same weights: both losses, and per parameter the gradients' relative
    L2 difference and cosine similarity (the module's as reference)."""
    model.zero_grad(set_to_none=True)
    lm = module_loss(model, ids, labels)
    lm.backward()
    cos, sin = _tables(model, ids.shape[1])
    lt = forward(params, model.config, paddle.to_tensor(ids),
                 paddle.to_tensor(labels), cos, sin)
    lt.backward()
    rel, cosim = {}, {}
    for name, p in model.named_parameters():
        g = params[name].grad._data
        rel[name] = _rel_l2(g, p.grad)
        cosim[name] = _cosine(g, p.grad)
    out = {"loss_module": lm.item(), "loss_tensor_api": lt.item(),
           "grad_rel_l2_max": max(rel.values()),
           "grad_rel_l2_argmax": max(rel, key=rel.get),
           "grad_cosine_min": min(cosim.values()),
           "grad_cosine_argmin": min(cosim, key=cosim.get)}
    model.zero_grad(set_to_none=True)
    for t in params.values():
        t.clear_grad()
    return out


def _timed_steps(step_fn, steps, cuda) -> dict:
    out = {"losses": [], "step_ms": []}
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = step_fn()
        if cuda:
            torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["losses"].append(loss.item())
    return out


def train_tensor_api(model, params, ids, labels, steps: int,
                     lr: float = 3e-4) -> dict:
    """``steps`` AdamW steps (``tools/gpt_1b_train.py``'s: weight decay
    0.01) through the Tensor API over ``params``: losses and synchronized
    step times (ms)."""
    cfg = model.config
    cos, sin = _tables(model, ids.shape[1])
    tids, tlabels = paddle.to_tensor(ids), paddle.to_tensor(labels)
    opt = AdamW(learning_rate=lr, parameters=list(params.values()))

    def step():
        loss = forward(params, cfg, tids, tlabels, cos, sin)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return _timed_steps(step, steps, ids.is_cuda)


def train_module(model, ids, labels, steps: int, lr: float = 3e-4) -> dict:
    """The same steps through the module path (eager: forward, criterion,
    backward, AdamW, clear_grad)."""
    opt = AdamW(learning_rate=lr, parameters=model.parameters())

    def step():
        loss = module_loss(model, ids, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return _timed_steps(step, steps, ids.is_cuda)


def double_grad(place, shape=(256, 512), seed: int = 0) -> List[np.ndarray]:
    """``paddle.grad(create_graph=True)`` twice through ``tanh(matmul(x,
    w))`` (x ``shape``, w square, f32) on ``place``: the first and second
    gradients wrt x and w, as numpy arrays."""
    rng = np.random.default_rng(seed)
    n, d = shape
    x = paddle.to_tensor(rng.standard_normal((n, d)).astype(np.float32),
                         place=place, stop_gradient=False)
    w = paddle.to_tensor((rng.standard_normal((d, d)) / np.sqrt(d)).astype(
        np.float32), place=place, stop_gradient=False)
    y = paddle.tanh(paddle.matmul(x, w)).sum()
    g1 = paddle.grad(y, [x, w], create_graph=True)
    s = (g1[0] * g1[0]).sum() + (g1[1] * g1[1]).sum()
    g2 = paddle.grad(s, [x, w], create_graph=True)
    return [g.numpy() for g in list(g1) + list(g2)]


def unpadded_case(lengths, h: int, kh: int, d: int, seed: int = 0):
    """Packed q (total, h, d) and k, v (total, kh, d) as f32 numpy arrays
    and cu_seqlens for ``lengths``."""
    rng = np.random.default_rng(seed)
    total = int(sum(lengths))
    cu = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    q = rng.standard_normal((total, h, d)).astype(np.float32)
    k = rng.standard_normal((total, kh, d)).astype(np.float32)
    v = rng.standard_normal((total, kh, d)).astype(np.float32)
    return q, k, v, cu


def unpadded(q, k, v, cu, place, dtype, causal=True):
    """``nn.functional.flash_attn_unpadded`` on ``place`` in ``dtype``;
    the output as f32 numpy."""
    ts = [paddle.to_tensor(a, dtype=dtype, place=place) for a in (q, k, v)]
    m = int(np.max(cu[1:] - cu[:-1]))
    out, _ = F.flash_attn_unpadded(*ts, cu, cu, m, m, causal=causal)
    return out.astype("float32").numpy()


def host_cost_per_op(device, n: int = 2000) -> dict:
    """Host time of one small ``paddle.add`` against ``torch.add`` on the
    same tensors (µs per call, a loop of ``n``; the device work is one
    tiny kernel either way)."""
    a = torch.randn(16, device=device)
    b = torch.randn(16, device=device)
    ta, tb = paddle.to_tensor(a), paddle.to_tensor(b)
    out = {}
    for name, fn in (("registry_add_us", lambda: paddle.add(ta, tb)),
                     ("torch_add_us", lambda: torch.add(a, b))):
        for _ in range(100):
            fn()
        if a.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = (time.perf_counter() - t0) / n * 1e6
        if a.is_cuda:
            torch.cuda.synchronize()
    out["ratio"] = out["registry_add_us"] / out["torch_add_us"]
    return out


def _main():
    from paddle_tpu_torch.tools import gpt_1b_train

    dev = torch.device("cuda", 0)
    paddle.set_device("gpu")
    cfg = gpt_1b_train.config()
    model = build(cfg, dev)
    params = tensor_params(model)
    ids, labels = batch(cfg, gpt_1b_train.BATCH, gpt_1b_train.SEQ, dev)
    print(compare_step0(model, params, ids, labels))
    print({"tensor_api": train_tensor_api(model, params, ids, labels, 4),
           "module": train_module(model, ids, labels, 4)})
    print(host_cost_per_op(dev))


if __name__ == "__main__":
    _main()
