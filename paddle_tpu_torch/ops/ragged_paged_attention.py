"""Ragged paged attention: one kernel over a concatenated token stream.

Port of ``paddle_tpu/ops/pallas/ragged_paged_attention.py``. Prefill and
decode rows of a continuous batch are packed into ONE unpadded token
stream and attended in a single call against the paged KV cache.

Contract (tensors on one device):

* ``q``:            (T, H, D)   new-token queries, ragged-packed; rows in
                                [cu_seqlens[i], cu_seqlens[i+1]) belong to
                                sequence slot i; rows >= cu_seqlens[num_seqs]
                                are padding.
* ``k_new/v_new``:  (T, KH, D)  new K/V for the same rows (GQA: KH <= H).
* ``key_cache/value_cache``: (num_blocks, block_size, KH, D) paged cache.
* ``block_tables``: (S, MB) int32 physical block ids per slot (-1 pads).
* ``cu_seqlens``:   (S+1,) int32 exclusive prefix sum of per-slot new-token
                    counts (cu_seqlens[0] == 0).
* ``context_lens``: (S,) int32 total tokens in cache per slot AFTER this
                    step's new tokens are written (prefix + new).
* ``num_seqs``:     int32 tensor of one element — live slots; trailing
                    slots are padding. It stays on the device: the
                    kernel reads it there.

Returns ``(out (T, H, D), key_cache, value_cache)``. The caches are
updated IN PLACE (the JAX version returned new caches; on the TPU the
update became in-place through buffer donation) and the same tensors
are returned. Each query row attends causally to its sequence's cache
prefix up to and including its own absolute position; rows outside a
live slot come out 0.

Two implementations:

* ``_ragged_attend_ref`` — plain PyTorch, per slot, in f32. The CPU path
  and the reference the kernel is held against on the card.
* ``_ragged_attend_cuda`` — the hand-written Hopper kernel
  (``csrc/ragged_paged_attention.cu``), bound with ``ctypes``.

Selection is by device and nothing else: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["ragged_paged_attention"]

# kernel launches through _ragged_attend_cuda (a run reads it to show the
# main path went through the kernel; reset it to 0 before such a run)
launches = 0

_KERNEL = "ragged_paged_attention"
_MAX_QV = 64     # query vectors per CTA (csrc kMaxQV)
_MAX_D = 128
_KV_CHUNK = 64   # cache positions per loop iteration (csrc kKC)


# ---------------------------------------------------------------------------
# shared prelude: token layout + cache scatter
# ---------------------------------------------------------------------------
def _token_layout(t_total, s_slots, cu, ctx, num_seqs):
    """Per-token (segment id, absolute position, validity) for the packed
    stream. Padding tokens get pos == -1. Runs on the tensors' device
    without a host sync."""
    t = torch.arange(t_total, dtype=torch.int32, device=cu.device)
    seg = (torch.searchsorted(cu, t, right=True, out_int32=True) - 1
           ).clamp(0, s_slots - 1).long()
    ns = num_seqs.reshape(1).long()
    valid = (t < cu.gather(0, ns)) & (seg < ns)
    nq = cu[seg + 1] - cu[seg]
    pos = ctx[seg] - nq + (t - cu[seg])
    pos = torch.where(valid & (pos >= 0), pos, -1)
    return seg, pos, valid


def _write_kv(cache, new, block_tables, seg, pos):
    """Scatter packed new K/V rows into their paged slots, IN PLACE.

    Rows with pos == -1, or whose block-table entry is -1, are dropped
    through an explicit mask: routing them to slot 0 would clobber real
    cached tokens, and ``index_put_`` has no out-of-range drop mode. To
    keep the step free of host syncs, a dropped row is not removed from
    the index list (that would need ``nonzero``): it repeats the write of
    the first valid row, same slot and same bytes, so duplicate indices
    store identical values. With no valid row at all, every row writes
    back the bytes its clamped slot already holds."""
    if pos.numel() == 0:
        return
    bs = cache.shape[1]
    mb = block_tables.shape[1]
    p = pos.long()
    blk = torch.where(p >= 0, p // bs, 0)
    off = torch.where(p >= 0, p % bs, 0)
    entry = block_tables[seg, blk.clamp(max=mb - 1)].long()
    valid = (p >= 0) & (blk < mb) & (entry >= 0)
    flat = entry.clamp(min=0) * bs + off
    cache_flat = cache.view(-1, *cache.shape[2:])
    first = torch.argmax(valid.to(torch.int32)).reshape(1)
    ref_idx = flat.gather(0, first)
    ref_val = torch.where(valid.gather(0, first)[:, None, None],
                          new[first].to(cache.dtype), cache_flat[ref_idx])
    idx = torch.where(valid, flat, ref_idx)
    val = torch.where(valid[:, None, None], new.to(cache.dtype), ref_val)
    cache_flat.index_put_((idx,), val)


# ---------------------------------------------------------------------------
# plain version (the CPU path; the kernel's reference on the card)
# ---------------------------------------------------------------------------
def _ragged_attend_ref(q, kc, vc, bt, cu, ctx, num_seqs, scale,
                       out_dtype=None):
    """Plain PyTorch: for each live slot, gather its pages, take causal
    softmax attention in f32, write its rows. Reads the index arrays on
    the host (this version is for the CPU and for checking the kernel).
    ``out_dtype`` defaults to q's dtype."""
    t_total, h, d = q.shape
    _, bs, kh, _ = kc.shape
    s_slots, mb = bt.shape
    rep = h // kh
    out = torch.zeros((t_total, h, d), dtype=out_dtype or q.dtype,
                      device=q.device)
    cu_h = cu.tolist()
    ctx_h = ctx.tolist()
    ns = min(max(int(num_seqs.reshape(-1)[0]), 0), s_slots)
    for i in range(ns):
        lo, hi = cu_h[i], min(cu_h[i + 1], t_total)
        nq = cu_h[i + 1] - cu_h[i]
        if hi <= lo:
            continue
        c = ctx_h[i]
        npages = min(-(-max(c, 0) // bs), mb)
        if npages == 0:
            continue
        pages = bt[i, :npages].long()
        keys = kc[pages.clamp(min=0)].reshape(npages * bs, kh, d).float()
        vals = vc[pages.clamp(min=0)].reshape(npages * bs, kh, d).float()
        qpos = c - nq + torch.arange(hi - lo, device=q.device)
        col = torch.arange(npages * bs, device=q.device)
        mask = ((col[None, :] <= qpos[:, None])
                & (pages >= 0).repeat_interleave(bs)[None, :])   # (nq, L)
        qs = q[lo:hi].float().reshape(hi - lo, kh, rep, d)
        logits = torch.einsum("tgrd,lgd->tgrl", qs, keys) * scale
        logits = logits.masked_fill(~mask[:, None, None, :], float("-inf"))
        probs = torch.softmax(logits, dim=-1)
        # a row with no visible position (malformed ctx < nq) is 0, as in
        # the kernel, not NaN
        probs = torch.where(mask.any(-1)[:, None, None, None], probs, 0.0)
        o = torch.einsum("tgrl,lgd->tgrd", probs, vals)
        out[lo:hi] = o.reshape(hi - lo, h, d).to(out.dtype)
    return out


# ---------------------------------------------------------------------------
# Hopper kernel wrapper
# ---------------------------------------------------------------------------
_lib = None


def _library():
    global _lib
    if _lib is None:
        from paddle_tpu_torch.ops import _build

        lib = _build.load(_KERNEL)
        fn = lib.ragged_paged_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.ragged_paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.ragged_paged_attention_error_string.restype = ctypes.c_char_p
        lib.ragged_paged_attention_smem_bytes.argtypes = [ctypes.c_int]
        lib.ragged_paged_attention_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def _check(cond, msg):
    if not cond:
        raise ValueError(f"ragged_paged_attention kernel: {msg}")


def _ragged_attend_cuda(q, kc, vc, bt, cu, ctx, num_seqs, scale):
    """Launch the Hopper kernel on PyTorch's current stream. Checks
    device, dtype, shape and contiguity and raises on anything the
    kernel does not take; raises on a refused launch."""
    global launches
    t_total, h, d = q.shape
    nb, bs, kh, d2 = kc.shape
    s_slots, mb = bt.shape
    dev = q.device
    for name, x in (("q", q), ("key_cache", kc), ("value_cache", vc),
                    ("block_tables", bt), ("cu_seqlens", cu),
                    ("context_lens", ctx), ("num_seqs", num_seqs)):
        _check(x.device == dev, f"{name} on {x.device}, q on {dev}")
        _check(x.is_contiguous(), f"{name} is not contiguous")
    _check(q.dtype in (torch.float32, torch.bfloat16),
           f"dtype {q.dtype} (want float32 or bfloat16)")
    _check(kc.dtype == q.dtype and vc.dtype == q.dtype,
           f"cache dtype {kc.dtype}/{vc.dtype} != q dtype {q.dtype}")
    _check(vc.shape == kc.shape, f"value_cache {tuple(vc.shape)} != "
                                 f"key_cache {tuple(kc.shape)}")
    _check(d2 == d and 0 < d <= _MAX_D, f"head_dim {d} (cache {d2}); "
                                        f"want equal and <= {_MAX_D}")
    _check(kh > 0 and h % kh == 0 and h // kh <= _MAX_QV,
           f"heads {h} / kv-heads {kh}")
    _check(bs > 0 and _KV_CHUNK % bs == 0,
           f"block_size {bs} must divide {_KV_CHUNK}")
    for name, x in (("block_tables", bt), ("cu_seqlens", cu),
                    ("context_lens", ctx), ("num_seqs", num_seqs)):
        _check(x.dtype == torch.int32, f"{name} dtype {x.dtype} != int32")
    _check(cu.shape == (s_slots + 1,) and ctx.shape == (s_slots,)
           and num_seqs.numel() == 1,
           f"cu_seqlens {tuple(cu.shape)}, context_lens "
           f"{tuple(ctx.shape)}, num_seqs {tuple(num_seqs.shape)} for "
           f"{s_slots} slots")
    out = torch.empty_like(q)
    if t_total == 0:
        return out
    lib = _library()
    err = lib.ragged_paged_attention_fwd(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), bt.data_ptr(),
        cu.data_ptr(), ctx.data_ptr(), num_seqs.data_ptr(), out.data_ptr(),
        t_total, h, kh, d, nb, bs, s_slots, mb, float(scale),
        0 if q.dtype == torch.float32 else 1,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.ragged_paged_attention_error_string(err).decode()
        raise RuntimeError(f"ragged_paged_attention kernel launch failed: "
                           f"CUDA error {err} ({msg})")
    launches += 1
    return out


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------
def ragged_paged_attention(q, k_new, v_new, key_cache, value_cache,
                           block_tables, cu_seqlens, context_lens,
                           num_seqs, *, scale=None):
    """See module docstring for the contract. Returns (out, key_cache,
    value_cache); the caches are updated in place first, so a row
    attends to its own K/V."""
    t_total, h, d = q.shape
    s_slots = block_tables.shape[0]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    dev = q.device
    cu = cu_seqlens.to(device=dev, dtype=torch.int32)
    ctx = context_lens.to(device=dev, dtype=torch.int32)
    bt = block_tables.to(device=dev, dtype=torch.int32)
    ns = torch.as_tensor(num_seqs, dtype=torch.int32, device=dev).reshape(1)

    seg, pos, _ = _token_layout(t_total, s_slots, cu, ctx, ns)
    _write_kv(key_cache, k_new, bt, seg, pos)
    _write_kv(value_cache, v_new, bt, seg, pos)

    if dev.type == "cuda":
        out = _ragged_attend_cuda(q.contiguous(), key_cache, value_cache,
                                  bt.contiguous(), cu, ctx, ns, scale)
    elif dev.type == "cpu":
        out = _ragged_attend_ref(q, key_cache, value_cache, bt, cu, ctx, ns,
                                 scale)
    else:
        raise ValueError(f"ragged_paged_attention: unsupported device {dev}")
    return out, key_cache, value_cache
