"""The Llama written the way a PaddlePaddle user writes it, over the
layer API: ``paddle.seed``, ``nn.Layer``, ``nn.Embedding``,
``nn.RMSNorm``, ``nn.Linear(bias_attr=False)`` (weights [in, out]), RoPE
on Tensor ops, ``nn.functional.flash_attention(causal=True)``,
``nn.Silu``, ``nn.Dropout`` after the embedding and on each residual
branch, ``nn.CrossEntropyLoss``; trained with
``paddle.optimizer.AdamW(parameters=model.parameters())``,
``loss.backward()``, ``opt.step()``, ``opt.clear_grad()``; saved with
``paddle.save(model.state_dict())``; and through ``paddle.jit.TrainStep``,
whose ``run_steps`` replays one captured step on the card
(:func:`replay_against_calls`). Shared by ``chip_smoke.py`` (phases 21,
``layer_api``, and 22, ``layer_trainstep``) and the tests.

:func:`build` takes the package as its argument, so the CPU tests run
the very same code on ``paddle_tpu`` and ``paddle_tpu_torch``.
:func:`layer_state_from_module` carries a port ``LlamaForCausalLM``'s
weights into the layer model (the projections transposed to [in, out]),
so :func:`compare_step0` can hold the two paths against each other.

Run alone on the card (phase 21's checks)::

    python -m paddle_tpu_torch.tools.layer_api_train
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List

__all__ = ["LayerLlamaConfig", "from_llama_config", "build",
           "layer_state_from_module", "masks_of", "compare_step0", "train",
           "save_load_resume", "mask_draw", "seeded_linear", "train_step",
           "replay_against_calls"]


@dataclass
class LayerLlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_hidden_layers: int = 16
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    dropout: float = 0.0
    dtype: str = "float32"


def from_llama_config(cfg, dropout: float = 0.0, **kw) -> LayerLlamaConfig:
    """The layer model's config for a port ``LlamaConfig`` (its widths,
    depth, rope and epsilon)."""
    fields = dict(vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
                  intermediate_size=cfg.intermediate_size,
                  num_hidden_layers=cfg.num_hidden_layers,
                  num_attention_heads=cfg.num_attention_heads,
                  num_key_value_heads=cfg.num_key_value_heads,
                  max_position_embeddings=cfg.max_position_embeddings,
                  rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta,
                  dropout=dropout, dtype=cfg.dtype)
    fields.update(kw)
    return LayerLlamaConfig(**fields)


def build(paddle, cfg: LayerLlamaConfig):
    """The causal LM as an ``nn.Layer`` of ``paddle`` (either package):
    ``model(ids)`` gives the logits, ``model(ids, labels)`` the mean
    cross entropy on f32 logits. Its parameters draw from the global
    generator in creation order (``XavierUniform`` projections, a
    ``Normal`` embedding, ``Constant`` norms) in f32 and are cast to
    ``cfg.dtype``; they land on the default place."""
    nn = paddle.nn
    F = nn.functional
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    hd = cfg.hidden_size // nh

    def proj(i, o):
        return nn.Linear(i, o, bias_attr=False)

    def rope(q, k, cos, sin):
        # f32 tables broadcast over (b, s, h, d), products in f32, cast
        # back: the module path's rope_apply
        def rot(x):
            x1, x2 = paddle.chunk(x, 2, axis=-1)
            return paddle.concat([-x2, x1], axis=-1)

        c, s = cos.unsqueeze([0, 2]), sin.unsqueeze([0, 2])
        return ((q * c + rot(q) * s).astype(q.dtype),
                (k * c + rot(k) * s).astype(k.dtype))

    class Attention(nn.Layer):
        def __init__(self):
            super().__init__()
            self.q_proj = proj(cfg.hidden_size, nh * hd)
            self.k_proj = proj(cfg.hidden_size, nkv * hd)
            self.v_proj = proj(cfg.hidden_size, nkv * hd)
            self.o_proj = proj(nh * hd, cfg.hidden_size)

        def forward(self, x, cos, sin):
            b, s = x.shape[0], x.shape[1]
            q = self.q_proj(x).reshape([b, s, nh, hd])
            k = self.k_proj(x).reshape([b, s, nkv, hd])
            v = self.v_proj(x).reshape([b, s, nkv, hd])
            q, k = rope(q, k, cos, sin)
            if nkv != nh:
                k = paddle.repeat_interleave(k, nh // nkv, axis=2)
                v = paddle.repeat_interleave(v, nh // nkv, axis=2)
            out, _ = F.flash_attention(q, k, v, causal=True)
            return self.o_proj(out.reshape([b, s, nh * hd]))

    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.gate_proj = proj(cfg.hidden_size, cfg.intermediate_size)
            self.up_proj = proj(cfg.hidden_size, cfg.intermediate_size)
            self.down_proj = proj(cfg.intermediate_size, cfg.hidden_size)
            self.act = nn.Silu()

        def forward(self, x):
            return self.down_proj(self.act(self.gate_proj(x)) *
                                  self.up_proj(x))

    class DecoderLayer(nn.Layer):
        def __init__(self):
            super().__init__()
            self.input_layernorm = nn.RMSNorm(cfg.hidden_size,
                                              cfg.rms_norm_eps)
            self.self_attn = Attention()
            self.post_attention_layernorm = nn.RMSNorm(cfg.hidden_size,
                                                       cfg.rms_norm_eps)
            self.mlp = MLP()
            self.attn_dropout = nn.Dropout(cfg.dropout)
            self.mlp_dropout = nn.Dropout(cfg.dropout)

        def forward(self, x, cos, sin):
            x = x + self.attn_dropout(
                self.self_attn(self.input_layernorm(x), cos, sin))
            return x + self.mlp_dropout(
                self.mlp(self.post_attention_layernorm(x)))

    class Backbone(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed_tokens = nn.Embedding(cfg.vocab_size,
                                             cfg.hidden_size)
            self.embed_dropout = nn.Dropout(cfg.dropout)
            self.layers = nn.LayerList(
                [DecoderLayer() for _ in range(cfg.num_hidden_layers)])
            self.norm = nn.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
            # the module path's f32 rope tables, in the package's own
            # ops; plain attributes, so a cast of the model keeps them f32
            inv = 1.0 / (cfg.rope_theta ** (paddle.arange(
                0, hd, 2, dtype="float32") / hd))
            t = paddle.arange(cfg.max_position_embeddings, dtype="float32")
            emb = paddle.concat([paddle.outer(t, inv)] * 2, axis=-1)
            self.rope_cos, self.rope_sin = paddle.cos(emb), paddle.sin(emb)

        def forward(self, ids):
            s = ids.shape[1]
            cos, sin = self.rope_cos[:s], self.rope_sin[:s]
            x = self.embed_dropout(self.embed_tokens(ids))
            for layer in self.layers:
                x = layer(x, cos, sin)
            return self.norm(x)

    class CausalLM(nn.Layer):
        def __init__(self):
            super().__init__()
            self.llama = Backbone()
            self.lm_head = proj(cfg.hidden_size, cfg.vocab_size)
            self.loss_fn = nn.CrossEntropyLoss()

        def forward(self, ids, labels=None):
            logits = self.lm_head(self.llama(ids))
            if labels is None:
                return logits
            return self.loss_fn(logits.astype("float32"), labels)

    model = CausalLM()
    if cfg.dtype != "float32":
        # drawn in f32, as every initializer draws, then cast
        model.to(dtype=cfg.dtype)
    return model


def layer_state_from_module(model) -> Dict[str, "object"]:
    """A port ``LlamaForCausalLM``'s weights under the layer model's keys:
    every 2-D projection (``nn.Linear``, [out, in]) transposed to the
    layer API's [in, out] (contiguous copies, on the module's device);
    the embedding and the norms as they are."""
    out = {}
    for name, p in model.named_parameters():
        t = p.detach()
        if t.dim() == 2 and "embed_tokens" not in name:
            t = t.t()
        out[name] = t.contiguous().clone()
    return out


def masks_of(paddle, model) -> List:
    """Record, on each call of each ``nn.Dropout`` of ``model``, the mask
    it applied (``out != 0`` where the input was not 0) as numpy bools;
    returns the list the hooks append to."""
    seen: List = []

    def hook(layer, inputs, out):
        if layer.training and layer.p > 0:
            seen.append((out.numpy() != 0) | (inputs[0].numpy() == 0))

    for layer in model.sublayers():
        if isinstance(layer, paddle.nn.Dropout):
            layer.register_forward_post_hook(hook)
    return seen


def compare_step0(module, layer_model, ids, labels) -> dict:
    """One forward and ``loss.backward()`` of the module path and of the
    layer model from the same weights (the layer model's gradients of the
    projections transposed back): both losses, whether they and every
    gradient are bit-identical, the largest gradient relative L2
    difference and the smallest cosine (the module's as reference)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.tools.tensor_api_train import (_cosine, _rel_l2,
                                                         module_loss)

    module.zero_grad(set_to_none=True)
    lm = module_loss(module, ids, labels)
    lm.backward()
    ll = layer_model(paddle.to_tensor(ids), paddle.to_tensor(labels))
    ll.backward()
    own = dict(layer_model.named_parameters())
    rel, cosim, same = {}, {}, True
    for name, p in module.named_parameters():
        g = own[name].grad._data
        if g.dim() == 2 and "embed_tokens" not in name:
            g = g.t()
        rel[name] = _rel_l2(g, p.grad)
        cosim[name] = _cosine(g, p.grad)
        same = same and bool((g == p.grad).all())
    out = {"loss_module": lm.item(), "loss_layer_api": ll.item(),
           "loss_bit_identical": lm.item() == ll.item(),
           "grads_bit_identical": same,
           "grad_rel_l2_max": max(rel.values()),
           "grad_rel_l2_argmax": max(rel, key=rel.get),
           "grad_cosine_min": min(cosim.values()),
           "grad_cosine_argmin": min(cosim, key=cosim.get)}
    module.zero_grad(set_to_none=True)
    layer_model.clear_gradients()
    return out


def train(paddle, model, ids, labels, steps: int, lr: float = 3e-4,
          opt=None, sync=None) -> dict:
    """``steps`` AdamW steps (weight decay 0.01, as ``tools/gpt_1b_train``)
    of the user loop over ``model.parameters()``: losses and step times
    (ms, after ``sync()`` when given). ``ids``/``labels`` are Tensors of
    ``paddle``; pass ``opt`` to go on with an optimizer; the one used is
    returned under ``"opt"``."""
    if opt is None:
        opt = paddle.optimizer.AdamW(learning_rate=lr,
                                     parameters=model.parameters(),
                                     weight_decay=0.01)
    out = {"losses": [], "step_ms": [], "opt": opt}
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = model(ids, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        if sync is not None:
            sync()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["losses"].append(float(loss))
    return out


def save_load_resume(paddle, model, cfg, ids, labels, opt, path,
                     sync=None) -> dict:
    """``paddle.save(model.state_dict())``, then ``paddle.load`` into a
    fresh model with ``set_state_dict``; then the next step of the
    unbroken model (its optimizer ``opt``) and of the restored one (a new
    AdamW), both from the same generator state: their losses, computed
    before either update, must be bit-identical. Reports the file's bytes
    and the save and load seconds. ``path`` is the file written and
    removed."""
    try:
        t0 = time.perf_counter()
        paddle.save(model.state_dict(), path)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        rng = paddle.get_rng_state()
        fresh = build(paddle, cfg)
        t0 = time.perf_counter()
        missing, unexpected = fresh.set_state_dict(paddle.load(path))
        if sync is not None:
            sync()
        load_s = time.perf_counter() - t0
    finally:
        if os.path.exists(path):
            os.remove(path)
    paddle.set_rng_state(rng)
    unbroken = train(paddle, model, ids, labels, 1, opt=opt)
    paddle.set_rng_state(rng)
    resumed = train(paddle, fresh, ids, labels, 1, lr=opt.get_lr())
    return {"bytes": nbytes, "save_s": save_s, "load_s": load_s,
            "missing": missing, "unexpected": unexpected,
            "loss_unbroken": unbroken["losses"][0],
            "loss_resumed": resumed["losses"][0],
            "bit_identical": unbroken["losses"][0] == resumed["losses"][0]}


def mask_draw(paddle, shape, p: float, place: str, state):
    """One ``dropout`` keep mask of ``shape`` on ``place`` (``"cpu"`` or
    ``"gpu:0"``), drawn from the generator state ``state`` (restored
    first): a bool torch tensor on that place."""
    ones = paddle.ones(shape, dtype="float32").to(place)
    paddle.set_rng_state(state)
    return paddle.nn.functional.dropout(ones, p)._data != 0


def seeded_linear(paddle, in_features, out_features, seed: int = 0):
    """``paddle.seed(seed)`` then one ``nn.Linear(in, out)`` on the default
    place: its weight and bias."""
    paddle.seed(seed)
    layer = paddle.nn.Linear(in_features, out_features)
    return layer.weight, layer.bias


def train_step(paddle, model, lr: float = 3e-4):
    """A ``paddle.jit.TrainStep`` of ``model`` (a :func:`build` model,
    called on the ids) with :func:`train`'s AdamW, under the model's own
    cross entropy on f32 logits; returns ``(step, opt)``."""
    opt = paddle.optimizer.AdamW(learning_rate=lr,
                                 parameters=model.parameters(),
                                 weight_decay=0.01)
    return paddle.jit.TrainStep(
        model, lambda logits, labels: model.loss_fn(
            logits.astype("float32"), labels), opt), opt


def _keep_masks(paddle, model) -> List:
    """Record, on each call of each ``nn.Dropout`` of ``model`` that
    drops, where its output is nonzero, as a bool tensor on the model's
    device: no host read, so the hooks run inside a CUDA graph capture
    too (a captured hook's tensor then holds the latest replay's)."""
    seen: List = []

    def hook(layer, inputs, out):
        if layer.training and layer.p > 0:
            seen.append(out._data != 0)

    for layer in model.sublayers():
        if isinstance(layer, paddle.nn.Dropout):
            layer.register_forward_post_hook(hook)
    return seen


def replay_against_calls(paddle, cfg: LayerLlamaConfig, ids, labels,
                         steps: int, rounds: int = 1, seed: int = 0,
                         sync=None) -> dict:
    """Two models of ``cfg`` from ``paddle.seed(seed)``, each behind a
    :func:`train_step` built from the same generator state: one takes
    ``steps * rounds`` ``__call__`` steps, the other ``rounds`` dispatches
    of ``run_steps(steps)`` (on the card: its first step eager, as the
    warm-up of the capture, then replays). ``ids``/``labels`` are Tensors
    of ``paddle``. Returns both loss lists; whether the losses, every
    parameter, the dropout masks (each call's against the replay's
    warm-up step and its last replayed step) and the final chains are
    bit-identical; the generator's counter moves over each TrainStep's
    construction and over its steps; per-step ms (each call synced; each
    dispatch after the first, over ``steps``); and the replayed step's
    ``graph_stats()``."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    models, stepped, moves = [], [], []
    for _ in range(2):
        paddle.seed(seed)
        models.append(build(paddle, cfg))
    masks = [_keep_masks(paddle, m) if cfg.dropout > 0 else []
             for m in models]
    state = paddle.get_rng_state()
    call_ms, replay_ms, losses = [], [], []
    before = dict(fa.launches)
    for i, model in enumerate(models):
        paddle.set_rng_state(state)
        step, _ = train_step(paddle, model)
        built = paddle.get_rng_state()
        if i == 0:
            out = []
            for _ in range(steps * rounds):
                t0 = time.perf_counter()
                out.append(step(ids, labels))
                if sync is not None:
                    sync()
                call_ms.append((time.perf_counter() - t0) * 1e3)
            call_launches = {k: n - before.get(k, 0)
                             for k, n in fa.launches.items()}
            losses.append([float(x) for x in out])
        else:
            out = []
            for r in range(rounds):
                t0 = time.perf_counter()
                out.append(step.run_steps(steps, ids, labels))
                if sync is not None:
                    sync()
                if r:
                    replay_ms.append((time.perf_counter() - t0) * 1e3
                                     / steps)
            losses.append([float(x) for x in torch.cat(out).tolist()])
        moves.append((built[1] - state[1],
                      paddle.get_rng_state()[1] - built[1]))
        stepped.append(step)
    a, b = models
    same_params = all(bool((pa._data == pb._data).all())
                      for pa, pb in zip(a.parameters(), b.parameters()))
    n = len(masks[0]) // (steps * rounds) if masks[0] else 0
    same_masks = None
    if n:
        mc, mr = masks
        same_masks = all(bool(torch.equal(x, y)) for x, y in
                         zip(mc[:n] + mc[-n:], mr[:n] + mr[-n:]))
    return {"steps": steps, "rounds": rounds, "dropout": cfg.dropout,
            "call_losses": losses[0], "replay_losses": losses[1],
            "losses_bit_identical": losses[0] == losses[1],
            "params_bit_identical": same_params,
            "masks_per_step": n, "masks_bit_identical": same_masks,
            "chains_equal": bool(torch.equal(stepped[0]._chain,
                                              stepped[1]._chain)),
            "chain": [int(x) for x in stepped[1]._chain.tolist()],
            "generator_keys": {"call": moves[0], "replay": moves[1]},
            "call_step_ms": call_ms, "replay_step_ms": replay_ms,
            "call_launches": call_launches,
            "graph_stats": stepped[1].graph_stats(),
            "models": models}


def _main():
    import json

    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.tools import gpt_1b_train
    from paddle_tpu_torch.tools.tensor_api_train import batch
    from paddle_tpu_torch.tools.tensor_api_train import build as build_module

    dev = torch.device("cuda", 0)
    paddle.set_device("gpu")
    mcfg = gpt_1b_train.config()
    module = build_module(mcfg, dev)
    cfg = from_llama_config(mcfg)
    model = build(paddle, cfg)
    model.set_state_dict(layer_state_from_module(module))
    ids, labels = batch(mcfg, gpt_1b_train.BATCH, gpt_1b_train.SEQ, dev)
    print(json.dumps(compare_step0(module, model, ids, labels)))
    res = train(paddle, model, paddle.to_tensor(ids),
                paddle.to_tensor(labels), 4, sync=torch.cuda.synchronize)
    res.pop("opt")
    print(json.dumps(res))


if __name__ == "__main__":
    _main()
