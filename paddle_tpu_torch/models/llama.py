"""Llama decoder (port of ``paddle_tpu/models/llama.py``): the training
forward, the ragged and the bucketed serving paths, and ``generate``.

Plain ``nn.Linear(bias=False)`` and ``nn.Embedding`` under the JAX
model's attribute names (``q_proj``, ``gate_proj``, ``embed_tokens``,
``lm_head``, ...), so state dicts line up name for name
(:func:`paddle_tpu_torch.models.convert.llama_state_from_jax` carries the
JAX weights across). ``forward`` is the training path: causal flash
attention (the hand-written kernels on the card), or plain attention
under an ``attn_mask``; :meth:`LlamaForCausalLM.criterion` is the LM
loss.

Hybrid-parallel training (``distributed.ParallelTrainStep``): the
parameters carry the JAX model's placement hints in torch's ``[out,
in]`` dims (q, k, v, gate and up column-parallel, ``Shard(0)``; o and
down row-parallel, ``Shard(1)``; the embedding vocab-parallel and
``lm_head`` column-parallel over the vocabulary, both ``Shard(0)``).
``shard_model_parameters`` cuts them and binds the modules to the mp
group (``_bind_mp``): the attention then runs on its rank's H/k query
and KH/k kv heads, each block's input and output take the Megatron pair,
the embedding is a masked lookup plus an all-reduce, and the logits are
the rank's shard of the vocabulary, which the criterion reads with the
vocab-parallel cross entropy. With ``sequence_parallel`` the activations
between the blocks are split along the sequence over mp (all-gathered
entering a block, reduce-scattered leaving it) and the norms' weights
are tagged for the gradient sum over mp. ``recompute`` recomputes each
decoder layer in the backward. Context parallelism is refused (slice
D3). ``tp_degree`` only groups the bucketed path's GQA packing per TP
shard (exact at any value, as in the reference), and the
tensor-parallel serving engine shards the modules itself
(:mod:`paddle_tpu_torch.serving.tp`), with the embedding and the head
replicated. ``forward_ragged_multi`` is the
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
from paddle_tpu_torch.distributed import communication as comm
from paddle_tpu_torch.distributed.mesh import Shard
from paddle_tpu_torch.incubate.nn import functional as F
from paddle_tpu_torch.ops.nn_ops import (flash_attention, rms_norm,
                                         scaled_dot_product_attention,
                                         softmax_with_cross_entropy)

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "LlamaDecoderLayer", "LlamaAttention", "LlamaMLP",
           "LlamaPretrainingCriterion", "LlamaForCausalLMPipe",
           "generate_engine_config"]



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


def _hint(param, dim: int, linear: bool = False):
    """The JAX model's placement hint: ``param`` split over mp on
    ``dim``. A Linear weight is stored transposed from the JAX model's
    ``[in, out]``: ``_dim_order`` names its dims in the JAX order, which a
    ZeRO stage searches for the dim it slices (so each rank holds the
    JAX step's slice)."""
    param._placement_hints = {"mp": Shard(dim)}
    if linear:
        param._dim_order = (1, 0)


def _tp_enter(x, group, sp: bool):
    """A block's input: all-gathered along the sequence under SP, else the
    Megatron ``f`` (identity forward, all-reduce backward)."""
    if group is None:
        return x
    return comm.all_gather_along(x, group, 1) if sp \
        else comm.copy_to_group(x, group)


def _tp_exit(x, group, sp: bool):
    """A block's partial-sum output: reduce-scattered onto the sequence
    under SP, else all-reduced (Megatron ``g``)."""
    if group is None:
        return x
    return comm.reduce_scatter_along(x, group, 1) if sp \
        else comm.reduce_from_group(x, group)


class _VocabEmbedding(nn.Embedding):
    """``nn.Embedding`` that, bound to an mp group, looks up the rank's
    shard of the vocabulary and all-reduces (vocab-parallel)."""

    _mp = None

    def forward(self, input):
        if self._mp is None:
            return super().forward(input)
        from paddle_tpu_torch.distributed.fleet.mp_layers import (
            vocab_parallel_embedding)

        return vocab_parallel_embedding(input, self.weight, self._mp)


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
    # serving tensor parallelism (LLMEngine tp_degree): forward_paged's
    # GQA head packing groups heads per TP shard; exact at any value
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


# what the port refuses, and the slice of the port that brings it
_NOT_YET = (
    ("context_parallel", "slice D3 (ops/ring_attention.py)"),
)


def _check_config(config: LlamaConfig):
    for field, later in _NOT_YET:
        if getattr(config, field):
            raise NotImplementedError(
                f"LlamaConfig.{field}=True is not ported yet; it comes with "
                f"{later}")


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
        for lin in (self.q_proj, self.k_proj, self.v_proj):
            _hint(lin.weight, 0, linear=True)
        _hint(self.o_proj.weight, 1, linear=True)
        self._mp = None

    def _bind_mp(self, group):
        """Run on this rank's share of the heads of ``group``'s k ranks
        (the weights are cut by the caller). The shares come from the
        config, so binding again to the same group changes nothing."""
        k = group.nranks
        heads = {}
        for what in ("num_attention_heads", "num_key_value_heads"):
            n = getattr(self.config, what)
            if n % k:
                raise ValueError(f"{what} ({n}) must be divisible by the "
                                 f"model-parallel degree ({k})")
            heads[what] = n // k
        self.n_heads = heads["num_attention_heads"]
        self.n_kv = heads["num_key_value_heads"]
        self._mp = group

    def forward(self, x, cos, sin, attn_mask=None):
        """Training attention over (b, s, h) activations; ``cos``/``sin``
        the (s, D) rope tables. KV heads are repeated up to the query
        heads before attention."""
        sp = self.config.sequence_parallel
        x = _tp_enter(x, self._mp, sp)
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
        out = self.o_proj(out.reshape(b, s, self.n_heads * self.head_dim))
        return _tp_exit(out, self._mp, sp)

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
        tp = max(1, int(self.config.tp_degree))
        if self.n_kv != self.n_heads:
            # K/V take the leading n_kv/tp slots of EACH TP head group's
            # H/tp-wide stripe of the packed (B, S, 3, H, D) stack (the
            # fused-projection layout block_multihead_attention unpacks
            # with the same tp_degree); tp=1 is the flat packing
            hg, kg = self.n_heads // tp, self.n_kv // tp
            pad = (0, 0, 0, hg - kg)
            k = F_t.pad(k.reshape(b, s, tp, kg, self.head_dim), pad
                        ).reshape(b, s, self.n_heads, self.head_dim)
            v = F_t.pad(v.reshape(b, s, tp, kg, self.head_dim), pad
                        ).reshape(b, s, self.n_heads, self.head_dim)
        qkv = torch.stack([q, k, v], dim=2)
        out, kc, vc = F.block_multihead_attention(
            qkv, key_cache, value_cache,
            seq_lens_encoder=seq_lens_encoder,
            seq_lens_decoder=seq_lens_decoder,
            seq_lens_this_time=seq_lens_this_time,
            block_tables=block_tables, tp_degree=tp)
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
        _hint(self.gate_proj.weight, 0, linear=True)
        _hint(self.up_proj.weight, 0, linear=True)
        _hint(self.down_proj.weight, 1, linear=True)
        self.sequence_parallel = config.sequence_parallel
        self._mp = None

    def _bind_mp(self, group):
        self._mp = group

    def forward(self, x):
        sp = self.sequence_parallel
        x = _tp_enter(x, self._mp, sp)
        # swiglu
        out = self.down_proj(F_t.silu(self.gate_proj(x)) * self.up_proj(x))
        return _tp_exit(out, self._mp, sp)


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
        if config.sequence_parallel:
            # they see the rank's slice of the sequence
            self.input_layernorm.weight.sequence_parallel = True
            self.post_attention_layernorm.weight.sequence_parallel = True

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
        self.embed_tokens = _VocabEmbedding(config.vocab_size,
                                            config.hidden_size, **kw)
        _hint(self.embed_tokens.weight, 0)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, **kw)
             for _ in range(config.num_hidden_layers)])
        self.norm = _RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)
        if config.sequence_parallel:
            self.norm.weight.sequence_parallel = True
        self._mp = None
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
        if self._mp is not None and self.config.sequence_parallel:
            x = comm.split_along(x, self._mp, 1)
        recompute = self.config.recompute and self.training and \
            torch.is_grad_enabled()
        for layer in self.layers:
            if recompute:
                from paddle_tpu_torch.distributed.fleet.recompute import (
                    recompute as _recompute)

                x = _recompute(layer, x, cos, sin, attn_mask)
            else:
                x = layer(x, cos, sin, attn_mask)
        return self.norm(x)

    def _bind_mp(self, group):
        """The embedding's vocabulary is sharded over ``group``; under
        SP the blocks run on the rank's slice of the sequence."""
        self._mp = group
        self.embed_tokens._mp = group

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
        self.vocab_size = None if config is None else config.vocab_size

    def forward(self, logits, labels):
        from paddle_tpu_torch.distributed.engine import mp_group
        from paddle_tpu_torch.distributed.fleet.mp_layers import (
            parallel_cross_entropy)

        g = mp_group()
        if g is not None and logits.shape[-1] != self.vocab_size:
            # inside a ParallelTrainStep over mp: the logits are this
            # rank's shard of the vocabulary
            return parallel_cross_entropy(logits, labels, g,
                                          self.ignore_index).mean()
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
        _hint(self.lm_head.weight, 0, linear=True)
        if config.tie_word_embeddings:
            self.lm_head.weight = self.llama.embed_tokens.weight
        self._mp = None

    def _bind_mp(self, group):
        """``lm_head`` gives this rank's shard of the vocabulary."""
        self._mp = group

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.lm_head.weight.dtype

    def forward(self, input_ids, attn_mask=None):
        """(b, s) token ids -> (b, s, vocab) logits (bound to an mp group:
        this rank's shard of the vocabulary)."""
        h = _tp_enter(self.llama(input_ids, attn_mask), self._mp,
                      self.config.sequence_parallel)
        return self.lm_head(h)

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
        the naive loop, which samples with one ``threefry.categorical``
        draw a token over the batch's last logits divided by the
        temperature, its key the global generator's next key (``core/
        generator.py``), as the JAX package's ``jax.random.categorical``
        draws. The cached path keeps
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


# ---------------------------------------------------------------------------
# the pipeline-parallel Llama
# ---------------------------------------------------------------------------
class _PipeDecoderLayer(LlamaDecoderLayer):
    """A decoder layer that takes the activations alone (the pipeline
    body's contract) and slices its own rope tables, as the JAX layer
    does. The tables are plain attributes, not buffers: the body holds
    parameters only."""

    def __init__(self, config: LlamaConfig, *, device=None, dtype=None):
        super().__init__(config, device=device, dtype=dtype)
        head_dim = config.hidden_size // config.num_attention_heads
        self.rope_cos, self.rope_sin = _rope_tables(
            config.max_position_embeddings, head_dim, config.rope_theta,
            device=device)

    def forward(self, x, attn_mask=None):
        # under SP x holds this rank's slice of the sequence
        s = x.shape[1] * (self.self_attn._mp.nranks
                          if self.self_attn._mp is not None
                          and self.config.sequence_parallel else 1)
        return super().forward(x, self.rope_cos[:s], self.rope_sin[:s],
                               attn_mask)


class _PipeEmbed(nn.Module):
    """The pre section: the (vocab-parallel) embedding; ``weight`` is the
    table, the name a tied head shares."""

    def __init__(self, config: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.embed_tokens = _VocabEmbedding(config.vocab_size,
                                            config.hidden_size,
                                            device=device, dtype=dtype)
        _hint(self.embed_tokens.weight, 0)
        self.weight = self.embed_tokens.weight
        self._mp = None

    def _bind_mp(self, group):
        self._mp = group
        self.embed_tokens._mp = group

    def forward(self, input_ids):
        x = self.embed_tokens(input_ids.long())
        if self._mp is not None and self.config.sequence_parallel:
            x = comm.split_along(x, self._mp, 1)
        return x


class _PipeHead(nn.Module):
    """The post section: the final norm and ``lm_head`` (bound to an mp
    group: this rank's shard of the vocabulary)."""

    def __init__(self, config: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.norm = _RMSNorm(config.hidden_size, config.rms_norm_eps,
                             device=device, dtype=dtype)
        self.lm_head = nn.Linear(config.hidden_size, config.vocab_size,
                                 bias=False, device=device, dtype=dtype)
        _hint(self.lm_head.weight, 0, linear=True)
        self._mp = None

    def _bind_mp(self, group):
        self._mp = group

    def forward(self, x):
        return self.lm_head(_tp_enter(self.norm(x), self._mp,
                                      self.config.sequence_parallel))


class _PipeTiedHead(nn.Module):
    """The tied post section: the final norm, then ``x @ E^T`` with the
    embedding table ``weight`` (a 1-row placeholder until the
    ``SharedLayerDesc`` rebinds it to the embedding's)."""

    def __init__(self, config: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.norm = _RMSNorm(config.hidden_size, config.rms_norm_eps,
                             device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty(
            1, config.hidden_size, device=device, dtype=dtype))
        self._mp = None

    def _bind_mp(self, group):
        self._mp = group

    def forward(self, x):
        h = _tp_enter(self.norm(x), self._mp, self.config.sequence_parallel)
        return F_t.linear(h, self.weight)


def LlamaForCausalLMPipe(config: LlamaConfig, num_stages: int, device=None,
                         **pipeline_kw):
    """The pipeline-parallel Llama (port of the JAX package's
    ``LlamaForCausalLMPipe``): the embedding as the pre section, the
    decoder layers as the homogeneous body, the final norm and the head
    as the post section, ``LlamaPretrainingCriterion`` as ``loss_fn``.
    With ``tie_word_embeddings`` the head computes ``x @ E^T`` on the
    embedding's table through a ``SharedLayerDesc``. Every module is
    built on ``device`` (the card unless ``device="cpu"``) in
    ``config.dtype``, with PyTorch's default initialisation; the
    weights of a JAX Pipe load through
    :func:`paddle_tpu_torch.models.convert.llama_pipe_state_from_jax`.
    ``pipeline_kw`` go to ``PipelineLayer`` (``stage_id``,
    ``topology``, ``num_virtual_pipeline_stages``)."""
    from paddle_tpu_torch.distributed.fleet.pipeline_parallel import (
        LayerDesc, PipelineLayer, SharedLayerDesc)

    _check_config(config)
    kw = dict(device=resolve_device(device), dtype=to_torch(config.dtype))
    body = [LayerDesc(_PipeDecoderLayer, config, **kw)
            for _ in range(config.num_hidden_layers)]
    if config.tie_word_embeddings:
        layers = [SharedLayerDesc("embed", _PipeEmbed, None, "weight",
                                  config, **kw)] + body + \
                 [SharedLayerDesc("embed", _PipeTiedHead, None, "weight",
                                  config, **kw)]
    else:
        layers = [_PipeEmbed(config, **kw)] + body + \
                 [_PipeHead(config, **kw)]
    return PipelineLayer(layers=layers, num_stages=num_stages,
                         loss_fn=LlamaPretrainingCriterion(config),
                         **pipeline_kw)
