"""Llama decoder (port of ``paddle_tpu/models/llama.py``): the training
forward, the ragged and the bucketed serving paths, and ``generate``.

Plain ``nn.Linear(bias=False)`` and ``nn.Embedding`` under the JAX
model's attribute names (``q_proj``, ``gate_proj``, ``embed_tokens``,
``lm_head``, ...), so state dicts line up name for name
(:func:`paddle_tpu_torch.models.convert.llama_state_from_jax` carries the
JAX weights across). ``forward`` is the training path: causal flash
attention (the hand-written kernels on the card), or plain attention
under an ``attn_mask``; :meth:`LlamaForCausalLM.criterion` is the LM
loss. Recompute, sequence/context parallelism and tensor parallelism
are refused at construction. ``forward_ragged_multi`` is the
speculative-verify step: the ragged forward with ``lm_head`` on each
slot's last R packed positions. ``forward_paged`` is the bucketed
serving step over a padded (B, S) batch
(:func:`~paddle_tpu_torch.incubate.nn.functional.block_multihead_attention`,
plain torch ops); :meth:`LlamaForCausalLM.generate` decodes through a
cached serving engine or by full recompute.

The ragged and paged forwards update the stacked KV caches IN PLACE (the
JAX versions returned new caches) and return the same tensors.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F_t
from torch import nn

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.core.dtype import to_torch
from paddle_tpu_torch.incubate.nn import functional as F
from paddle_tpu_torch.ops.nn_ops import (flash_attention, rms_norm,
                                         scaled_dot_product_attention,
                                         softmax_with_cross_entropy)

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "LlamaDecoderLayer", "LlamaAttention", "LlamaMLP",
           "LlamaPretrainingCriterion", "generate_engine_config"]



class _RMSNorm(nn.Module):
    """The Llama's RMSNorm module over the raw :func:`~paddle_tpu_torch.
    ops.nn_ops.rms_norm` (the JAX op's order). ``nn.RMSNorm`` is the
    Tensor API's layer; the Llama stays a ``torch.nn.Module`` (ROADMAP,
    by design)."""

    def __init__(self, hidden_size, epsilon=1e-6, *, device=None,
                 dtype=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight, epsilon=self.epsilon)

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
            out = flash_attention(q, k, v, causal=True)
        else:
            out = scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, is_causal=attn_mask is None)
        return self.o_proj(out.reshape(b, s, self.n_heads * self.head_dim))

    def forward_ragged(self, x, cos, sin, key_cache, value_cache,
                       block_tables, cu_seqlens, context_lens, num_seqs,
                       host_key_cache=None, host_value_cache=None):
        """Serving attention over a ragged-packed token stream. ``x``
        (1,T,h); ``cos``/``sin`` (1,T,D) gathered at absolute positions;
        caches (num_blocks, block_size, KH, D), updated in place; the
        host tier's mirror (num_host_blocks, block_size, KH, D), read
        only, when tiered. Returns (out (1,T,h), key_cache,
        value_cache)."""
        b, t, _ = x.shape
        q = self.q_proj(x).view(b, t, self.n_heads, self.head_dim)
        k = self.k_proj(x).view(b, t, self.n_kv, self.head_dim)
        v = self.v_proj(x).view(b, t, self.n_kv, self.head_dim)
        q, k = _rope_apply_at(q, k, cos, sin)
        out, kc, vc = F.ragged_paged_attention(
            q[0], k[0], v[0], key_cache, value_cache,
            block_tables=block_tables, cu_seqlens=cu_seqlens,
            context_lens=context_lens, num_seqs=num_seqs,
            host_key_cache=host_key_cache, host_value_cache=host_value_cache)
        out = out.reshape(1, t, self.n_heads * self.head_dim)
        return self.o_proj(out), kc, vc

    def forward_paged(self, x, cos, sin, key_cache, value_cache,
                      block_tables, seq_lens_encoder, seq_lens_decoder,
                      seq_lens_this_time):
        """Serving attention over the paged KV cache for a padded batch.
        ``x`` (B,S,h); ``cos``/``sin`` (B,S,D) gathered at absolute token
        positions; caches (num_blocks, block_size, KH, D), updated in
        place. Returns (out (B,S,h), key_cache, value_cache)."""
        b, s, _ = x.shape
        q = self.q_proj(x).view(b, s, self.n_heads, self.head_dim)
        k = self.k_proj(x).view(b, s, self.n_kv, self.head_dim)
        v = self.v_proj(x).view(b, s, self.n_kv, self.head_dim)
        q, k = _rope_apply_at(q, k, cos, sin)
        if self.n_kv != self.n_heads:
            # K/V take the leading n_kv of the H head slots of the packed
            # (B, S, 3, H, D) stack (the fused-projection layout
            # block_multihead_attention unpacks)
            pad = (0, 0, 0, self.n_heads - self.n_kv)
            k = F_t.pad(k, pad)
            v = F_t.pad(v, pad)
        qkv = torch.stack([q, k, v], dim=2)
        out, kc, vc = F.block_multihead_attention(
            qkv, key_cache, value_cache,
            seq_lens_encoder=seq_lens_encoder,
            seq_lens_decoder=seq_lens_decoder,
            seq_lens_this_time=seq_lens_this_time,
            block_tables=block_tables)
        out = out.reshape(b, s, self.n_heads * self.head_dim)
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
        self.input_layernorm = _RMSNorm(config.hidden_size,
                                       config.rms_norm_eps, **kw)
        self.self_attn = LlamaAttention(config, **kw)
        self.post_attention_layernorm = _RMSNorm(config.hidden_size,
                                                config.rms_norm_eps, **kw)
        self.mlp = LlamaMLP(config, **kw)

    def forward(self, x, cos, sin, attn_mask=None):
        """One decoder block; ``cos``/``sin`` the (s, D) rope tables (the
        JAX layer slices its own; here :class:`LlamaModel` holds them)."""
        h = x + self.self_attn(self.input_layernorm(x), cos, sin, attn_mask)
        return h + self.mlp(self.post_attention_layernorm(h))

    def forward_ragged(self, x, cos, sin, key_cache, value_cache,
                       block_tables, cu_seqlens, context_lens, num_seqs,
                       host_key_cache=None, host_value_cache=None):
        """One decoder block over the ragged stream. ``cos``/``sin``
        (1,T,D) are the rope rows at each token's position (gathered once
        per step by :class:`LlamaModel`; the JAX layer gathers its own)."""
        attn_out, kc, vc = self.self_attn.forward_ragged(
            self.input_layernorm(x), cos, sin, key_cache, value_cache,
            block_tables, cu_seqlens, context_lens, num_seqs,
            host_key_cache, host_value_cache)
        h = x + attn_out
        out = h + self.mlp(self.post_attention_layernorm(h))
        return out, kc, vc

    def forward_paged(self, x, cos, sin, key_cache, value_cache,
                      block_tables, seq_lens_encoder, seq_lens_decoder,
                      seq_lens_this_time):
        """One decoder block over the paged cache. ``cos``/``sin``
        (B,S,D) are the rope rows at each token's position (gathered
        once per step by :class:`LlamaModel`; the JAX layer gathers its
        own from the positions); padding rows may hold any position in
        range — the attention masks them by ``seq_lens_this_time``."""
        attn_out, kc, vc = self.self_attn.forward_paged(
            self.input_layernorm(x), cos, sin, key_cache, value_cache,
            block_tables, seq_lens_encoder, seq_lens_decoder,
            seq_lens_this_time)
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
        self.norm = _RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)
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
                       block_tables, cu_seqlens, context_lens, num_seqs,
                       host_key_caches=None, host_value_caches=None):
        """Ragged-packed KV-cache forward: ``input_ids`` (T,) is every
        sequence's new tokens concatenated (no padding rows between
        sequences); ``cu_seqlens`` (S+1,) delimits slots and
        ``context_lens`` (S,) is each slot's post-step cache length.
        ``key_caches``/``value_caches`` are the stacked per-layer caches
        (L, num_blocks, block_size, KH, D), updated in place; a tiered
        engine passes its host tier's stacked device mirror (L,
        num_host_blocks, block_size, KH, D) as ``host_key_caches`` /
        ``host_value_caches``, whose pages the table's virtual entries
        (>= num_blocks) name. Returns (hidden (1,T,h), key_caches,
        value_caches)."""
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
        tiered = host_key_caches is not None
        for i, layer in enumerate(self.layers):
            x, _, _ = layer.forward_ragged(
                x, cos, sin, key_caches[i], value_caches[i], block_tables,
                cu, ctx, num_seqs,
                host_key_caches[i] if tiered else None,
                host_value_caches[i] if tiered else None)
        return self.norm(x), key_caches, value_caches

    @torch.no_grad()
    def forward_paged(self, input_ids, key_caches, value_caches,
                      block_tables, seq_lens_encoder, seq_lens_decoder,
                      seq_lens_this_time):
        """KV-cache forward of a padded (B, S) batch over the stacked
        per-layer paged caches (L, num_blocks, block_size, KH, D),
        updated in place. Per row, by the length tensors (each (B,)):
        ``seq_lens_decoder[b] > 0`` is a decode continuing a cached
        prefix of that many tokens, else a prefill from position 0;
        ``seq_lens_this_time[b]`` counts the row's real tokens. Returns
        (hidden (B,S,h), key_caches, value_caches)."""
        dec = seq_lens_decoder.reshape(-1).long()
        s = input_ids.shape[1]
        # absolute position of each new token: after the cached prefix
        # (decode) or from 0 (prefill); padding rows land in range and
        # are masked downstream by seq_lens_this_time
        positions = (torch.where(dec > 0, dec, 0)[:, None]
                     + torch.arange(s, device=dec.device)[None, :]
                     ).clamp(0, self.rope_cos.shape[0] - 1)
        cos = self.rope_cos[positions]   # (B, S, D)
        sin = self.rope_sin[positions]
        x = self.embed_tokens(input_ids.long())
        for i, layer in enumerate(self.layers):
            x, _, _ = layer.forward_paged(
                x, cos, sin, key_caches[i], value_caches[i], block_tables,
                seq_lens_encoder, seq_lens_decoder, seq_lens_this_time)
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


def generate_engine_config(config: LlamaConfig, batch, prompt_len,
                           max_new_tokens):
    """The :class:`~paddle_tpu_torch.serving.EngineConfig` of the engine
    that a cached :meth:`LlamaForCausalLM.generate` of ``batch`` prompts
    of ``prompt_len`` tokens builds: the cache sized to the padded need,
    not the rope table's full span."""
    from paddle_tpu_torch.serving import EngineConfig

    need_len = prompt_len + max_new_tokens
    mlen = 1
    while mlen < need_len:
        mlen *= 2
    return EngineConfig(
        max_num_seqs=max(batch, 1),
        max_model_len=min(mlen, config.max_position_embeddings),
        max_batched_tokens=max(2048, batch * prompt_len))


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
    def forward_paged(self, input_ids, key_caches, value_caches,
                      block_tables, seq_lens_encoder, seq_lens_decoder,
                      seq_lens_this_time):
        """Bucketed serving step: paged forward + lm_head on each row's
        LAST valid token (the sampling position). Returns (logits (B,
        vocab), key_caches, value_caches), the caches updated in place.
        This is the step ``LLMEngine(ragged=False)`` captures per (kind,
        B, S) bucket."""
        h, kcs, vcs = self.llama.forward_paged(
            input_ids, key_caches, value_caches, block_tables,
            seq_lens_encoder, seq_lens_decoder, seq_lens_this_time)
        now = seq_lens_this_time.reshape(-1).long()
        b = h.shape[0]
        last = (now - 1).clamp(0, h.shape[1] - 1)
        return self.lm_head(h[torch.arange(b, device=h.device), last]), \
            kcs, vcs

    @torch.no_grad()
    def forward_ragged(self, input_ids, key_caches, value_caches,
                       block_tables, cu_seqlens, context_lens, num_seqs,
                       host_key_caches=None, host_value_caches=None):
        """Ragged serving step: one unpadded forward over the packed
        token stream + lm_head on each slot's LAST packed token (the
        sampling position; for a mid-prompt prefill chunk the engine
        discards the row). Returns (logits (S, vocab), key_caches,
        value_caches), the caches updated in place; the host tier's
        mirror, when given, is read only (:meth:`LlamaModel.
        forward_ragged`)."""
        h, kcs, vcs = self.llama.forward_ragged(
            input_ids, key_caches, value_caches, block_tables,
            cu_seqlens, context_lens, num_seqs, host_key_caches,
            host_value_caches)
        cu = cu_seqlens.to(torch.int32)
        t = h.shape[1]
        # pad slots point at cu[num_seqs]-1 (a real row) — harmless, the
        # engine never samples them
        last = (cu[1:] - 1).clamp(0, t - 1).long()
        return self.lm_head(h[0, last]), kcs, vcs


    @torch.no_grad()
    def forward_ragged_multi(self, input_ids, key_caches, value_caches,
                             block_tables, cu_seqlens, context_lens,
                             num_seqs, num_rows: int, host_key_caches=None,
                             host_value_caches=None):
        """Ragged serving step with a PER-ROW MULTI-LOGIT gather: lm_head
        on each slot's last ``R = num_rows`` packed tokens (the
        speculative-verify positions). Returns (logits (S, R, vocab),
        key_caches, value_caches). ``R == 1`` reduces to
        :meth:`forward_ragged`; rows shorter than R clamp to their own
        first position (the sampler masks them by ``n_draft``, so the
        duplicated logits are never consumed). The host tier's mirror as
        in :meth:`forward_ragged`."""
        h, kcs, vcs = self.llama.forward_ragged(
            input_ids, key_caches, value_caches, block_tables,
            cu_seqlens, context_lens, num_seqs, host_key_caches,
            host_value_caches)
        cu = cu_seqlens.to(torch.int64)
        r = int(num_rows)
        t = h.shape[1]
        off = torch.arange(r, device=h.device)
        idx = cu[1:, None] - r + off[None, :]              # (S, R)
        idx = torch.maximum(idx, cu[:-1, None]).clamp(0, t - 1)
        logits = self.lm_head(h[0, idx.reshape(-1)])
        return logits.reshape(idx.shape[0], r, -1), kcs, vcs

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, temperature=0.0,
                 top_k=0, use_cache=None):
        """Decode ``max_new_tokens`` continuations of the (B, S) prompt
        ids; returns (B, S + max_new_tokens) ids on the model's device,
        in the prompt's dtype. ``use_cache`` routes through the paged
        KV-cache serving engine (token-identical to the naive loop for
        greedy decoding); default: the engine for greedy decoding, the
        naive full-recompute loop otherwise. ``use_cache=False`` forces
        the naive loop, which draws sampled tokens from the JAX package's
        global generator: not ported yet (queue 1 item 7, A1's
        ``core/generator.py``), so it is refused. The cached path keeps
        its engine on the model for the next call; the model and that
        engine refer to each other, so call :meth:`close` when done to
        free both without the cycle collector."""
        if use_cache is None:
            use_cache = temperature <= 0
        if use_cache:
            return self._generate_paged(input_ids, max_new_tokens,
                                        temperature, top_k)
        return self._generate_naive(input_ids, max_new_tokens,
                                    temperature, top_k)

    def _generate_naive(self, input_ids, max_new_tokens, temperature,
                        top_k):
        """Full-context recompute per token (the pre-serving fallback),
        through :meth:`forward`: greedy, or with ``temperature > 0`` one
        ``jax.random.categorical`` draw over the batch's last logits
        divided by the temperature, its key from the global generator."""
        from paddle_tpu_torch.core import generator as gen
        from paddle_tpu_torch.ops import threefry

        out = torch.as_tensor(input_ids).to(self.device)
        for _ in range(max_new_tokens):
            last = self(out)[:, -1]
            if temperature > 0:
                nxt = threefry.categorical(
                    gen.active_key(), last / torch.tensor(
                        temperature, dtype=last.dtype, device=last.device))
            else:
                nxt = last.argmax(dim=-1)
            out = torch.cat([out, nxt[:, None].to(out.dtype)], dim=1)
        return out

    def close(self):
        """Drop the serving engine that :meth:`generate` keeps on the
        model (its KV caches and, on the card, its captured graphs); the
        next cached :meth:`generate` builds a new one."""
        self.__dict__.pop("_serving_engine", None)

    def _generate_paged(self, input_ids, max_new_tokens, temperature,
                        top_k):
        """KV-cache decode through a serving engine cached on the model
        (``_serving_engine``, rebuilt when a call outgrows it, dropped by
        :meth:`close`)."""
        import numpy as np

        from paddle_tpu_torch.serving import LLMEngine, SamplingParams

        ids_t = torch.as_tensor(input_ids)
        ids = ids_t.cpu().numpy().astype(np.int64)
        b, s = ids.shape
        need_len = s + max_new_tokens
        if need_len > self.config.max_position_embeddings:
            raise ValueError(
                f"prompt ({s}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_position_embeddings "
                f"({self.config.max_position_embeddings})")
        eng = getattr(self, "_serving_engine", None)
        if (eng is None or eng.cfg.max_num_seqs < b
                or eng.cfg.max_model_len < need_len):
            eng = LLMEngine(self, generate_engine_config(
                self.config, b, s, max_new_tokens))
            self._serving_engine = eng
        sampling = SamplingParams(max_new_tokens=max_new_tokens,
                                  temperature=temperature, top_k=top_k)
        generated = eng.generate([list(row) for row in ids], sampling)
        full = np.concatenate([ids, np.asarray(generated, np.int64)],
                              axis=1)
        return torch.from_numpy(full).to(self.device, ids_t.dtype)
