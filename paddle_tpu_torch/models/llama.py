"""Llama decoder (port of ``paddle_tpu/models/llama.py``): the training
forward and the ragged serving path.

Plain ``nn.Linear(bias=False)`` and ``nn.Embedding`` under the JAX
model's attribute names (``q_proj``, ``gate_proj``, ``embed_tokens``,
``lm_head``, ...), so state dicts line up name for name
(:func:`paddle_tpu_torch.models.convert.llama_state_from_jax` carries the
JAX weights across). ``forward`` is the training path: causal flash
attention (the hand-written kernels on the card), or plain attention
under an ``attn_mask``; :meth:`LlamaForCausalLM.criterion` is the LM
loss. Recompute, sequence/context parallelism and tensor parallelism
are refused at construction; ``forward_paged`` is not ported yet.
``forward_ragged_multi`` is the speculative-verify step: the ragged
forward with ``lm_head`` on each slot's last R packed positions.

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
from paddle_tpu_torch.nn import functional as NF
from paddle_tpu_torch.nn.norm import RMSNorm
from paddle_tpu_torch.ops.nn_ops import softmax_with_cross_entropy

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "LlamaDecoderLayer", "LlamaAttention", "LlamaMLP",
           "LlamaPretrainingCriterion"]


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
    sequence_parallel: bool = False
    use_flash_attention: bool = True
    context_parallel: bool = False
    recompute: bool = False
    tie_word_embeddings: bool = False
    dtype: str = "float32"
    tp_degree: int = 1

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


# what this slice refuses, and the slice of the port that brings it
_NOT_YET = (
    ("recompute", "slice D (distributed/fleet/recompute.py)"),
    ("sequence_parallel", "slice D (fleet/utils/sequence_parallel_utils.py)"),
    ("context_parallel", "slice D (ops/ring_attention.py)"),
)


def _check_config(config: LlamaConfig):
    for field, later in _NOT_YET:
        if getattr(config, field):
            raise NotImplementedError(
                f"LlamaConfig.{field}=True is not ported yet; it comes with "
                f"{later}")
    if config.tp_degree != 1:
        raise NotImplementedError(
            f"LlamaConfig.tp_degree={config.tp_degree} is not ported yet; "
            f"tensor parallelism comes with C3 (serving) and slice D "
            f"(training)")


def rope_apply(q, k, cos, sin):
    """Rotary embedding on [b, s, h, d] q/k given the contiguous cos/sin
    tables [s, d] (f32): computed in f32 and cast back."""

    def rot(x):
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([-x2, x1], dim=-1)

    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return ((q * c + rot(q) * s).to(q.dtype),
            (k * c + rot(k) * s).to(k.dtype))


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

    def forward(self, x, cos, sin, attn_mask=None):
        """Training attention over (b, s, h) activations; ``cos``/``sin``
        the (s, D) rope tables. KV heads are repeated up to the query
        heads before attention."""
        b, s, _ = x.shape
        q = self.q_proj(x).view(b, s, self.n_heads, self.head_dim)
        k = self.k_proj(x).view(b, s, self.n_kv, self.head_dim)
        v = self.v_proj(x).view(b, s, self.n_kv, self.head_dim)
        q, k = rope_apply(q, k, cos, sin)
        if self.n_kv != self.n_heads:
            rep = self.n_heads // self.n_kv
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        if self.config.use_flash_attention and attn_mask is None:
            out, _ = NF.flash_attention(q, k, v, causal=True)
        else:
            out = NF.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, is_causal=attn_mask is None)
        return self.o_proj(out.reshape(b, s, self.n_heads * self.head_dim))

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

    def forward(self, x, cos, sin, attn_mask=None):
        """One decoder block; ``cos``/``sin`` the (s, D) rope tables (the
        JAX layer slices its own; here :class:`LlamaModel` holds them)."""
        h = x + self.self_attn(self.input_layernorm(x), cos, sin, attn_mask)
        return h + self.mlp(self.post_attention_layernorm(h))

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
        _check_config(config)
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

    def forward(self, input_ids, attn_mask=None):
        """(b, s) token ids -> (b, s, hidden) final-norm activations."""
        s = input_ids.shape[1]
        if s > self.rope_cos.shape[0]:
            raise ValueError(f"sequence length {s} > max_position_embeddings "
                             f"{self.rope_cos.shape[0]}")
        cos, sin = self.rope_cos[:s], self.rope_sin[:s]
        x = self.embed_tokens(input_ids.long())
        for layer in self.layers:
            x = layer(x, cos, sin, attn_mask)
        return self.norm(x)

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


class LlamaPretrainingCriterion(nn.Module):
    """LM loss: cross entropy (f32 for bf16 logits, 0 at label -100), then
    the mean over ALL positions, ignored ones included, as the JAX
    criterion takes it. Labels are not shifted here: the caller does."""

    def __init__(self, config: LlamaConfig = None):
        super().__init__()
        self.ignore_index = -100

    def forward(self, logits, labels):
        return softmax_with_cross_entropy(
            logits, labels, ignore_index=self.ignore_index).mean()


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

    def forward(self, input_ids, attn_mask=None):
        """(b, s) token ids -> (b, s, vocab) logits."""
        return self.lm_head(self.llama(input_ids, attn_mask))

    @staticmethod
    def criterion(config=None):
        return LlamaPretrainingCriterion(config)

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


    @torch.no_grad()
    def forward_ragged_multi(self, input_ids, key_caches, value_caches,
                             block_tables, cu_seqlens, context_lens,
                             num_seqs, num_rows: int):
        """Ragged serving step with a PER-ROW MULTI-LOGIT gather: lm_head
        on each slot's last ``R = num_rows`` packed tokens (the
        speculative-verify positions). Returns (logits (S, R, vocab),
        key_caches, value_caches). ``R == 1`` reduces to
        :meth:`forward_ragged`; rows shorter than R clamp to their own
        first position (the sampler masks them by ``n_draft``, so the
        duplicated logits are never consumed)."""
        h, kcs, vcs = self.llama.forward_ragged(
            input_ids, key_caches, value_caches, block_tables,
            cu_seqlens, context_lens, num_seqs)
        cu = cu_seqlens.to(torch.int64)
        r = int(num_rows)
        t = h.shape[1]
        off = torch.arange(r, device=h.device)
        idx = cu[1:, None] - r + off[None, :]              # (S, R)
        idx = torch.maximum(idx, cu[:-1, None]).clamp(0, t - 1)
        logits = self.lm_head(h[0, idx.reshape(-1)])
        return logits.reshape(idx.shape[0], r, -1), kcs, vcs
