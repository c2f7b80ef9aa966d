"""Block / variable-length attention for serving (port of
``paddle_tpu/incubate/nn/functional/block_attention.py``).

* :func:`ragged_paged_attention` — the ragged engine step's attention:
  the hand-written kernel on the card, its plain version on the CPU;
* :func:`block_multihead_attention` — the bucketed ``forward_paged``
  step's attention over a padded (B, S) batch, in plain torch ops, as
  the reference computes it in plain jnp (no Pallas kernel). The cache
  write is in place (the reference returns new caches; here the step's
  captured graphs hold the caches' addresses).

* :func:`variable_length_memory_efficient_attention` and
  :func:`paged_attention` — Tensor in, Tensor out (the JAX package's
  contract), computed in plain torch ops as the reference computes them
  in jnp, except that both products run in f32 whatever the inputs'
  dtype and the output is rounded once (the JAX package's bf16 einsums
  round the scores and the probabilities to bf16 first). Their outputs
  take no part in autograd, as there.

The first two take and return raw torch tensors: the Llama model's
serving forwards call them."""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.ops import ragged_paged_attention as _rpa

__all__ = ["ragged_paged_attention", "block_multihead_attention",
           "variable_length_memory_efficient_attention", "paged_attention"]


def _data(x, device=None):
    if isinstance(x, Tensor):
        return x._data.detach()
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.as_tensor(x, device=device)


@torch.no_grad()
def variable_length_memory_efficient_attention(
        query, key, value, seq_lens, kv_seq_lens, mask=None, scale=None,
        causal=False, pre_cache_length=0):
    """query (B, H, S, D); key/value (B, KH, Sk, D), KH dividing H (query
    head h reads kv head h // (H / KH)); seq_lens/kv_seq_lens (B,) or
    (B, 1) valid lengths. Returns a Tensor (B, H, S, D) with padding rows
    zeroed. Causal is top-left aligned, shifted by ``pre_cache_length``."""
    q = _data(query)
    k = _data(key, q.device)
    v = _data(value, q.device)
    ql = _data(seq_lens, q.device).reshape(-1).to(q.device, torch.int32)
    kl = _data(kv_seq_lens, q.device).reshape(-1).to(q.device, torch.int32)
    b, h, s, d = q.shape
    kh = k.shape[1]
    if kh != h:
        rep = h // kh
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    t = k.shape[2]
    q_valid = torch.arange(s, device=q.device)[None, :] < ql[:, None]
    k_valid = torch.arange(t, device=q.device)[None, :] < kl[:, None]
    neg = torch.tensor(torch.finfo(torch.float32).min, dtype=logits.dtype,
                       device=q.device)
    att_mask = k_valid[:, None, None, :]
    if causal:
        causal_m = (torch.arange(s, device=q.device)[:, None]
                    + pre_cache_length
                    >= torch.arange(t, device=q.device)[None, :])
        att_mask = att_mask & causal_m[None, None]
    logits = torch.where(att_mask, logits, neg)
    if mask is not None:
        logits = logits + _data(mask, q.device).to(logits.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", probs, v.float()).to(v.dtype)
    return Tensor._from_data(out * q_valid[:, None, :, None].to(out.dtype))


@torch.no_grad()
def paged_attention(q, key_cache, value_cache, block_tables, seq_lens,
                    scale=None):
    """Decode attention over a paged cache: q (B, H, D), one new token per
    sequence; caches (num_blocks, block_size, KH, D); block_tables
    (B, max_blocks), -1 pads; seq_lens (B,) cached tokens including the
    new one. Returns a Tensor (B, H, D)."""
    qd = _data(q)
    kc = _data(key_cache, qd.device)
    vc = _data(value_cache, qd.device)
    bt = _data(block_tables, qd.device).to(qd.device).long()
    sl = _data(seq_lens, qd.device).reshape(-1).to(qd.device, torch.int32)
    b, h, d = qd.shape
    nb, bs, kh, _ = kc.shape
    mb = bt.shape[1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    safe_bt = torch.clamp(bt, min=0)
    k_seq = kc[safe_bt].reshape(b, mb * bs, kh, d)
    v_seq = vc[safe_bt].reshape(b, mb * bs, kh, d)
    if kh != h:
        rep = h // kh
        k_seq = torch.repeat_interleave(k_seq, rep, dim=2)
        v_seq = torch.repeat_interleave(v_seq, rep, dim=2)
    logits = torch.einsum("bhd,bthd->bht", qd.float(), k_seq.float()) * scale
    pos = torch.arange(mb * bs, device=qd.device)[None, :]
    valid = (pos < sl[:, None]) & torch.repeat_interleave(bt >= 0, bs, dim=1)
    neg = torch.tensor(torch.finfo(torch.float32).min, dtype=logits.dtype,
                       device=qd.device)
    logits = torch.where(valid[:, None, :], logits, neg)
    probs = torch.softmax(logits.float(), dim=-1)
    return Tensor._from_data(torch.einsum(
        "bht,bthd->bhd", probs, v_seq.float()).to(v_seq.dtype))


def ragged_paged_attention(q, k_new, v_new, key_cache, value_cache,
                           block_tables, cu_seqlens, context_lens,
                           num_seqs, scale=None, host_key_cache=None,
                           host_value_cache=None):
    """Unpadded prefill+decode attention over a concatenated token stream
    (``ops/ragged_paged_attention.py``). q/k_new/v_new: (T, H|KH, D)
    ragged-packed rows; cu_seqlens (S+1,) delimits sequence slots,
    context_lens (S,) is the post-step cache length per slot,
    block_tables (S, MB) the paged-cache indirection; a tiered engine
    passes its host tier's device mirror as ``host_key_cache`` /
    ``host_value_cache`` (entries >= the cache's block count read it).
    Returns (out (T, H, D), key_cache, value_cache) — the caches are
    updated in place and returned."""
    return _rpa.ragged_paged_attention(
        q, k_new, v_new, key_cache, value_cache, block_tables, cu_seqlens,
        context_lens, num_seqs, scale=scale, host_key_cache=host_key_cache,
        host_value_cache=host_value_cache)


def block_multihead_attention(
        qkv, key_cache, value_cache, seq_lens_encoder, seq_lens_decoder,
        seq_lens_this_time, block_tables, max_seq_len=None,
        block_size=None, pre_key_cache=None, pre_value_cache=None,
        rope_emb=None, mask=None, causal=True, num_heads=None,
        kv_num_heads=None, head_dim=None, tp_degree=1):
    """Unified prefill/decode attention over a paged KV cache. Per
    sequence, by the length tensors (each (B,)):

    * prefill (``seq_lens_decoder[b] == 0``): row b's new tokens sit at
      positions ``0 .. seq_lens_this_time[b] - 1`` and attend causally
      among themselves;
    * decode (``seq_lens_decoder[b] > 0``): the new tokens continue a
      cached prefix of ``seq_lens_decoder[b]`` tokens.

    ``qkv`` (B, S, 3, H, D) packs q, k and v with H heads per slot (GQA
    keeps the first KH of the K/V heads); the rows past
    ``seq_lens_this_time`` are padding. The new K/V are written into
    ``key_cache``/``value_cache`` (NB, BS, KH, D) IN PLACE; padding rows
    and positions whose block-table entry is -1 are dropped. Then every
    query at position p attends to cache positions <= p of its row:
    scores in the inputs' dtype, softmax in f32, probabilities cast to
    V's dtype before the PV product, padding rows zero. Returns (out (B,
    S, H, D), key_cache, value_cache). Memory: the scores are (B, H, S,
    MB * BS) per call, in the inputs' dtype and twice in f32.
    ``seq_lens_encoder`` is taken for the reference's signature; the
    mode follows ``seq_lens_decoder``, as in the reference."""
    if rope_emb is not None or pre_key_cache is not None or \
            pre_value_cache is not None:
        raise NotImplementedError(
            "block_multihead_attention: rope_emb / pre_key_cache / "
            "pre_value_cache are not applied (the reference does not "
            "apply them either): apply rotary embeddings to qkv before "
            "the call and fold any prefix cache into the caches")
    if int(tp_degree) != 1:
        raise NotImplementedError(
            f"block_multihead_attention(tp_degree={tp_degree}) is not "
            f"ported yet: tensor parallelism comes with C3")
    kc, vc = key_cache, value_cache
    bt = block_tables.long()
    dec = seq_lens_decoder.reshape(-1).long()
    now = seq_lens_this_time.reshape(-1).long()
    b, s, _, h, d = qkv.shape
    nb, bs, kh, _ = kc.shape
    if block_size is not None and block_size != bs:
        raise ValueError(f"block_size {block_size} != the cache's {bs}")
    q = qkv[:, :, 0]
    k_new = qkv[:, :, 1, :kh]
    v_new = qkv[:, :, 2, :kh]

    # the new K/V land at [start, start + now): after the cached prefix
    # (decode) or from 0 (prefill); padding rows get position -1
    dev = qkv.device
    col = torch.arange(s, device=dev)
    start = torch.where(dec > 0, dec, 0)
    pos = torch.where(col[None, :] < now[:, None],
                      start[:, None] + col[None, :], -1)      # (B, S)
    row = torch.arange(b, device=dev)[:, None].expand(b, s).reshape(-1)
    _rpa._write_kv(kc, k_new.reshape(b * s, kh, d), bt, row,
                   pos.reshape(-1))
    _rpa._write_kv(vc, v_new.reshape(b * s, kh, d), bt, row,
                   pos.reshape(-1))

    # attention against the updated cache
    total = torch.where(dec > 0, dec + now, now)              # (B,)
    mb = bt.shape[1]
    t = mb * bs
    safe_bt = bt.clamp(min=0)
    k_seq = kc[safe_bt].reshape(b, t, kh, d)
    v_seq = vc[safe_bt].reshape(b, t, kh, d)
    if kh != h:
        k_seq = k_seq.repeat_interleave(h // kh, dim=2)
        v_seq = v_seq.repeat_interleave(h // kh, dim=2)
    scale = 1.0 / (d ** 0.5)
    logits = torch.einsum("bshd,bthd->bhst", q, k_seq) * scale
    tpos = torch.arange(t, device=dev)
    cache_valid = ((tpos[None, :] < total[:, None])
                   & (bt >= 0).repeat_interleave(bs, dim=1))  # (B, T)
    att = cache_valid[:, None, None, :]
    if causal:
        att = att & (pos[:, None, :, None] >= tpos[None, None, None, :])
    if mask is not None:
        logits = logits + mask.to(logits.dtype)
    # masked in f32: the f32 minimum would round to -inf in bf16, and a
    # padding row (nothing visible) would then turn NaN, not uniform
    scores = logits.float().masked_fill_(~att,
                                         torch.finfo(torch.float32).min)
    del logits
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs.to(v_seq.dtype), v_seq)
    q_valid = col[None, :] < now[:, None]                     # (B, S)
    out = out * q_valid[:, :, None, None].to(out.dtype)
    return out, kc, vc
