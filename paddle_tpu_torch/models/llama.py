"""Llama decoder for serving (port of ``paddle_tpu/models/llama.py``, the
ragged serving path).

Plain ``nn.Linear(bias=False)`` and ``nn.Embedding`` under the JAX
model's attribute names (``q_proj``, ``gate_proj``, ``embed_tokens``,
``lm_head``, ...), so state dicts line up name for name
(:func:`paddle_tpu_torch.models.convert.llama_state_from_jax` carries the
JAX weights across). Tensor parallelism, ``forward`` and the flash path
are not ported yet.

The ragged forward updates the stacked KV caches IN PLACE (the JAX
version returned new caches) and returns the same tensors.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F_t
from torch import nn

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.core.dtype import to_torch
from paddle_tpu_torch.incubate.nn import functional as F
from paddle_tpu_torch.nn.norm import RMSNorm

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "LlamaDecoderLayer", "LlamaAttention", "LlamaMLP"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: str = "float32"

    @staticmethod
    def llama3_8b(**kw):
        return LlamaConfig(vocab_size=128256, hidden_size=4096,
                           intermediate_size=14336, num_hidden_layers=32,
                           num_attention_heads=32, num_key_value_heads=8,
                           max_position_embeddings=8192,
                           rope_theta=500000.0, **kw)

    @staticmethod
    def tiny(**kw):
        return LlamaConfig(vocab_size=256, hidden_size=64,
                           intermediate_size=128, num_hidden_layers=2,
                           num_attention_heads=4, num_key_value_heads=2,
                           max_position_embeddings=128, **kw)


def _rope_tables(seq_len, head_dim, theta, device=None):
    """(cos, sin), each (seq_len, head_dim) f32 — the JAX recipe."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)  # [s, d/2]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def _rope_apply_at(q, k, cos, sin):
    """Rotary embedding at PER-TOKEN absolute positions: q (B,S,H,D) /
    k (B,S,KH,D), cos/sin (B,S,D) gathered per position. Computed in
    the tables' f32 and cast back, as in the JAX code."""

    def rot(x):
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([-x2, x1], dim=-1)

    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return ((q * c + rot(q) * s).to(q.dtype),
            (k * c + rot(k) * s).to(k.dtype))


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        self.config = config
        h = config.hidden_size
        self.n_heads = config.num_attention_heads
        self.n_kv = config.num_key_value_heads
        self.head_dim = h // self.n_heads
        kw = dict(bias=False, device=device, dtype=dtype)
        self.q_proj = nn.Linear(h, h, **kw)
        self.k_proj = nn.Linear(h, self.n_kv * self.head_dim, **kw)
        self.v_proj = nn.Linear(h, self.n_kv * self.head_dim, **kw)
        self.o_proj = nn.Linear(h, h, **kw)

    def forward_ragged(self, x, cos, sin, key_cache, value_cache,
                       block_tables, cu_seqlens, context_lens, num_seqs):
        """Serving attention over a ragged-packed token stream. ``x``
        (1,T,h); ``cos``/``sin`` (1,T,D) gathered at absolute positions;
        caches (num_blocks, block_size, KH, D), updated in place.
        Returns (out (1,T,h), key_cache, value_cache)."""
        b, t, _ = x.shape
        q = self.q_proj(x).view(b, t, self.n_heads, self.head_dim)
        k = self.k_proj(x).view(b, t, self.n_kv, self.head_dim)
        v = self.v_proj(x).view(b, t, self.n_kv, self.head_dim)
        q, k = _rope_apply_at(q, k, cos, sin)
        out, kc, vc = F.ragged_paged_attention(
            q[0], k[0], v[0], key_cache, value_cache,
            block_tables=block_tables, cu_seqlens=cu_seqlens,
            context_lens=context_lens, num_seqs=num_seqs)
        out = out.reshape(1, t, self.n_heads * self.head_dim)
        return self.o_proj(out), kc, vc


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        kw = dict(bias=False, device=device, dtype=dtype)
        self.gate_proj = nn.Linear(h, m, **kw)
        self.up_proj = nn.Linear(h, m, **kw)
        self.down_proj = nn.Linear(m, h, **kw)

    def forward(self, x):
        # swiglu
        return self.down_proj(F_t.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps, **kw)
        self.self_attn = LlamaAttention(config, **kw)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps, **kw)
        self.mlp = LlamaMLP(config, **kw)

    def forward_ragged(self, x, cos, sin, key_cache, value_cache,
                       block_tables, cu_seqlens, context_lens, num_seqs):
        """One decoder block over the ragged stream. ``cos``/``sin``
        (1,T,D) are the rope rows at each token's position (gathered once
        per step by :class:`LlamaModel`; the JAX layer gathers its own)."""
        attn_out, kc, vc = self.self_attn.forward_ragged(
            self.input_layernorm(x), cos, sin, key_cache, value_cache,
            block_tables, cu_seqlens, context_lens, num_seqs)
        h = x + attn_out
        out = h + self.mlp(self.post_attention_layernorm(h))
        return out, kc, vc


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = nn.Embedding(config.vocab_size,
                                         config.hidden_size, **kw)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, **kw)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)
        head_dim = config.hidden_size // config.num_attention_heads
        cos, sin = _rope_tables(config.max_position_embeddings, head_dim,
                                config.rope_theta, device=device)
        # pure functions of the config: not part of the state dict
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    @torch.no_grad()
    def forward_ragged(self, input_ids, key_caches, value_caches,
                       block_tables, cu_seqlens, context_lens, num_seqs):
        """Ragged-packed KV-cache forward: ``input_ids`` (T,) is every
        sequence's new tokens concatenated (no padding rows between
        sequences); ``cu_seqlens`` (S+1,) delimits slots and
        ``context_lens`` (S,) is each slot's post-step cache length.
        ``key_caches``/``value_caches`` are the stacked per-layer caches
        (L, num_blocks, block_size, KH, D), updated in place. Returns
        (hidden (1,T,h), key_caches, value_caches)."""
        cu = cu_seqlens.to(torch.int32)
        ctx = context_lens.to(torch.int32)
        ids = input_ids.reshape(1, -1)
        t = ids.shape[1]
        s_slots = ctx.shape[0]
        # absolute position of token row r of slot i:
        # ctx[i] - (cu[i+1]-cu[i]) + r — pad rows clamp into range and
        # are masked downstream by cu_seqlens/num_seqs
        tok = torch.arange(t, dtype=torch.int32, device=ids.device)
        seg = (torch.searchsorted(cu, tok, right=True, out_int32=True) - 1
               ).clamp(0, s_slots - 1).long()
        positions = (ctx[seg] - (cu[seg + 1] - cu[seg]) + (tok - cu[seg])
                     ).clamp(0, self.rope_cos.shape[0] - 1).long()
        cos = self.rope_cos[positions][None]   # (1, T, D)
        sin = self.rope_sin[positions][None]
        x = self.embed_tokens(ids)
        for i, layer in enumerate(self.layers):
            x, _, _ = layer.forward_ragged(
                x, cos, sin, key_caches[i], value_caches[i], block_tables,
                cu, ctx, num_seqs)
        return self.norm(x), key_caches, value_caches


class LlamaForCausalLM(nn.Module):
    """Llama decoder + LM head. Built on the CUDA device unless
    ``device="cpu"`` is passed; with no GPU and no explicit device it
    raises. Weights come from PyTorch's default initialisation; call
    :meth:`init_weights` with a seeded generator for reproducible random
    weights, or load a state dict."""

    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        dtype = to_torch(config.dtype)
        self.llama = LlamaModel(config, device=dev, dtype=dtype)
        self.lm_head = nn.Linear(config.hidden_size, config.vocab_size,
                                 bias=False, device=dev, dtype=dtype)
        if config.tie_word_embeddings:
            self.lm_head.weight = self.llama.embed_tokens.weight

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.lm_head.weight.dtype

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, std: float = 0.02):
        """Random weights from ``generator`` (on the model's device):
        projections and embeddings ~ N(0, std), norm weights 1."""
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, std, generator=generator)
        return self

    @torch.no_grad()
    def forward_ragged(self, input_ids, key_caches, value_caches,
                       block_tables, cu_seqlens, context_lens, num_seqs):
        """Ragged serving step: one unpadded forward over the packed
        token stream + lm_head on each slot's LAST packed token (the
        sampling position; for a mid-prompt prefill chunk the engine
        discards the row). Returns (logits (S, vocab), key_caches,
        value_caches), the caches updated in place."""
        h, kcs, vcs = self.llama.forward_ragged(
            input_ids, key_caches, value_caches, block_tables,
            cu_seqlens, context_lens, num_seqs)
        cu = cu_seqlens.to(torch.int32)
        t = h.shape[1]
        # pad slots point at cu[num_seqs]-1 (a real row) — harmless, the
        # engine never samples them
        last = (cu[1:] - 1).clamp(0, t - 1).long()
        return self.lm_head(h[0, last]), kcs, vcs

