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
* ``host_key_cache/host_value_cache``: optional (NHB, block_size, KH, D)
                    second pool, the device mirror of a tiered engine's
                    host tier: a table entry ``e`` with ``NB <= e < NB +
                    NHB`` (a VIRTUAL entry) names its page ``e - NB``.
                    Entries past ``NB + NHB``, and every -1, are masked.
                    The pool is read only: a row whose entry is virtual
                    is not written (the engine never schedules one; the
                    JAX step's write into its concatenated copy is sliced
                    away).

Returns ``(out (T, H, D), key_cache, value_cache)``. The caches are
updated IN PLACE (the JAX version returned new caches; on the TPU the
update became in-place through buffer donation) and the same tensors
are returned. Each query row attends causally to its sequence's cache
prefix up to and including its own absolute position; rows outside a
live slot come out 0.

Two implementations:

* ``_ragged_attend_ref`` — plain PyTorch, per slot, in f32. The CPU path
  and the reference the kernel is held against on the card.
* ``_ragged_attend_cuda`` — the hand-written Hopper kernels
  (``csrc/ragged_paged_attention.cu``), bound with ``ctypes``: in
  bfloat16 on the tensor cores (wgmma; head_dim 16, 32, 64 or 128), with
  each slot's cache range cut into splits when the batch alone would not
  fill the card (:func:`_splits`; a second kernel merges them); in
  float32 on f32 FMAs (the tensor cores would take float32 as TF32).
  :func:`route_launches` reads the launches by route.

Selection is by device and nothing else: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["ragged_paged_attention"]

# kernel launches through _ragged_attend_cuda (a run reads it to show the
# main path went through the kernel; reset it to 0 before such a run)
launches = 0

_KERNEL = "ragged_paged_attention"
_MAX_QV = 64     # query vectors per CTA (csrc kMaxQV)
_MAX_D = 128
_KV_CHUNK = 64   # cache positions per loop iteration (csrc kKC)
_TC_HEAD_DIMS = (16, 32, 64, 128)   # head dims of the bf16 kernel
_CTAS_PER_SM = 2  # bf16 CTAs an SM holds at once (shared memory, D = 128)
_ROUTES = ("fma", "tensor_cores", "combine")


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

    Rows with pos == -1, or whose block-table entry is -1 or names no
    block of ``cache`` (a virtual entry, >= its block count), are dropped
    through an explicit mask: routing them to slot 0 would clobber real
    cached tokens, and ``index_put_`` has no out-of-range drop mode. To
    keep the step free of host syncs, a dropped row is not removed from
    the index list (that would need ``nonzero``): it repeats the write of
    the first valid row, same slot and same bytes, so duplicate indices
    store identical values. With no valid row at all, every row writes
    back the bytes its clamped slot already holds."""
    if pos.numel() == 0:
        return
    nb, bs = cache.shape[:2]
    mb = block_tables.shape[1]
    p = pos.long()
    blk = torch.where(p >= 0, p // bs, 0)
    off = torch.where(p >= 0, p % bs, 0)
    entry = block_tables[seg, blk.clamp(max=mb - 1)].long()
    valid = (p >= 0) & (blk < mb) & (entry >= 0) & (entry < nb)
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
def _chunked_attend(logits, vals, round_to, split):
    """The bfloat16 kernel's arithmetic on one slot: logits (t, kh, rep, L)
    with -inf where masked, vals (L, kh, d), both f32. Per split of
    ``split`` positions, an online softmax over chunks of ``_KV_CHUNK``
    positions whose P = exp(S - running max) is rounded to ``round_to``
    before each P V product; then the splits merged as the combine kernel
    merges them. A row that sees no position is 0."""
    parts, m_all, num, den = [], None, None, None
    for s0 in range(0, logits.shape[-1], split):
        m = torch.full(logits.shape[:-1], float("-inf"), device=logits.device)
        l = torch.zeros_like(m)
        o = torch.zeros(logits.shape[:-1] + vals.shape[-1:],
                        device=logits.device)
        for c0 in range(s0, min(s0 + split, logits.shape[-1]), _KV_CHUNK):
            sb = logits[..., c0:c0 + _KV_CHUNK]
            m_new = torch.maximum(m, sb.amax(-1))
            seen = torch.isfinite(m_new)             # some position so far
            base = torch.where(seen, m_new, 0.0)
            alpha = torch.where(seen, torch.exp(m - base), 1.0)
            pr = torch.exp(sb - base[..., None])
            l = l * alpha + pr.sum(-1)
            o = o * alpha[..., None] + torch.einsum(
                "tgrl,lgd->tgrd", pr.to(round_to).float(),
                vals[c0:c0 + _KV_CHUNK])
            m = m_new
        parts.append((m, l, o))
        m_all = m if m_all is None else torch.maximum(m_all, m)
    for m, l, o in parts:
        w = torch.where(torch.isfinite(m), torch.exp(m - torch.where(
            torch.isfinite(m_all), m_all, 0.0)), 0.0)
        num = w[..., None] * o if num is None else num + w[..., None] * o
        den = w * l if den is None else den + w * l
    return torch.where(den[..., None] > 0, num / den[..., None], 0.0)


def _ragged_attend_ref(q, kc, vc, bt, cu, ctx, num_seqs, scale,
                       out_dtype=None, round_to=None, split=None,
                       hkc=None, hvc=None):
    """Plain PyTorch: for each live slot, gather its pages, take causal
    softmax attention in f32, write its rows. Reads the index arrays on
    the host (this version is for the CPU and for checking the kernel).
    ``out_dtype`` defaults to q's dtype. A page ``e`` in ``[NB, NB +
    NHB)`` reads the second pool ``hkc``/``hvc`` at ``e - NB``; pages
    past it, and -1 pages, are masked.

    With ``round_to`` (a dtype) it takes the bfloat16 kernel's form
    (:func:`_chunked_attend`): P rounded to ``round_to`` per chunk of
    ``_KV_CHUNK`` positions, in splits of ``split`` positions (default:
    one split; the kernel's is :func:`kernel_split`), as the kernel and
    the TPU kernel round P before their P V products."""
    t_total, h, d = q.shape
    nb, bs, kh, _ = kc.shape
    nhb = 0 if hkc is None else hkc.shape[0]
    s_slots, mb = bt.shape
    rep = h // kh
    out = torch.zeros((t_total, h, d), dtype=out_dtype or q.dtype,
                      device=q.device)

    def gather(cache, pool, pages):
        rows = cache[pages.clamp(0, nb - 1)]
        if nhb:
            rows = torch.where((pages >= nb)[:, None, None, None],
                               pool[(pages - nb).clamp(0, nhb - 1)], rows)
        return rows.reshape(-1, kh, d).float()

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
        keys = gather(kc, hkc, pages)
        vals = gather(vc, hvc, pages)
        qpos = c - nq + torch.arange(hi - lo, device=q.device)
        col = torch.arange(npages * bs, device=q.device)
        mapped = (pages >= 0) & (pages < nb + nhb)
        mask = ((col[None, :] <= qpos[:, None])
                & mapped.repeat_interleave(bs)[None, :])   # (nq, L)
        qs = q[lo:hi].float().reshape(hi - lo, kh, rep, d)
        logits = torch.einsum("tgrd,lgd->tgrl", qs, keys) * scale
        logits = logits.masked_fill(~mask[:, None, None, :], float("-inf"))
        if round_to is not None:
            o = _chunked_attend(logits, vals, round_to,
                                split or logits.shape[-1])
        else:
            probs = torch.softmax(logits, dim=-1)
            # a row with no visible position (malformed ctx < nq) is 0, as
            # in the kernel, not NaN
            probs = torch.where(mask.any(-1)[:, None, None, None], probs,
                                0.0)
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
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 11
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.ragged_paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.ragged_paged_attention_error_string.restype = ctypes.c_char_p
        lib.ragged_paged_attention_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.ragged_paged_attention_smem_bytes.restype = ctypes.c_size_t
        lib.ragged_paged_attention_route_launches.argtypes = [ctypes.c_int]
        lib.ragged_paged_attention_route_launches.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def smem_bytes(head_dim: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Dynamic shared memory of one CTA at ``head_dim`` for ``dtype``."""
    return int(_library().ragged_paged_attention_smem_bytes(
        head_dim, 0 if dtype == torch.float32 else 1))


def route_launches() -> dict:
    """Successful launches so far by route, as the library counts them
    where it launches: ``"fma"`` (the float32 kernel), ``"tensor_cores"``
    (the bfloat16 kernel) and ``"combine"`` (the kernel that merges
    splits)."""
    lib = _library()
    return {name: int(lib.ragged_paged_attention_route_launches(i))
            for i, name in enumerate(_ROUTES)}


def _splits(t_total, s_slots, kv_heads, rep, max_blocks, block_size, sms):
    """``(split, nsplit)`` for the bfloat16 kernel: each slot's cache range
    ``[0, max_blocks * block_size)`` is cut into ``nsplit`` splits of
    ``split`` positions (whole chunks), from shapes the host knows -- no
    index array is read. One split while the grid's (q tile, kv-head)
    CTAs fill ``_CTAS_PER_SM`` per SM; else as many as bring it there (a
    decode batch: one q tile per slot)."""
    span = max_blocks * block_size
    ctas = (-(-t_total // (_MAX_QV // rep)) + s_slots) * kv_heads
    want = max(1, min(-(-_CTAS_PER_SM * sms // ctas),
                      -(-span // _KV_CHUNK)))
    split = -(-span // want)
    split = -(-split // _KV_CHUNK) * _KV_CHUNK
    return split, -(-span // split)


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def kernel_split(q, key_cache, block_tables):
    """``(split, nsplit)`` the bfloat16 kernel takes for these shapes on
    q's card (:func:`_splits`)."""
    dev = q.device
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    kh = key_cache.shape[2]
    return _splits(q.shape[0], block_tables.shape[0], kh, q.shape[1] // kh,
                   block_tables.shape[1], key_cache.shape[1], _sm_count(idx))


def _check(cond, msg):
    if not cond:
        raise ValueError(f"ragged_paged_attention kernel: {msg}")


def _ragged_attend_cuda(q, kc, vc, bt, cu, ctx, num_seqs, scale,
                        hkc=None, hvc=None):
    """Launch the Hopper kernel on PyTorch's current stream (bfloat16:
    the tensor-core kernel, and the combine kernel when it splits; float32:
    the FMA kernel), reading the second pool ``hkc``/``hvc`` too when
    given. Checks device, dtype, shape, contiguity and alignment and
    raises on anything the kernels do not take; raises on a refused
    launch."""
    global launches
    t_total, h, d = q.shape
    nb, bs, kh, d2 = kc.shape
    s_slots, mb = bt.shape
    dev = q.device
    pools = (("key_cache", kc), ("value_cache", vc))
    nhb = 0
    if hkc is not None or hvc is not None:
        _check(hkc is not None and hvc is not None,
               "host_key_cache and host_value_cache go together")
        pools += (("host_key_cache", hkc), ("host_value_cache", hvc))
        nhb = hkc.shape[0]
        _check(hkc.shape == hvc.shape and hkc.shape[1:] == kc.shape[1:],
               f"host pools {tuple(hkc.shape)}/{tuple(hvc.shape)} for a "
               f"cache of pages {tuple(kc.shape[1:])}")
    for name, x in (("q", q),) + pools + (
            ("block_tables", bt), ("cu_seqlens", cu),
            ("context_lens", ctx), ("num_seqs", num_seqs)):
        _check(x.device == dev, f"{name} on {x.device}, q on {dev}")
        _check(x.is_contiguous(), f"{name} is not contiguous")
    _check(q.dtype in (torch.float32, torch.bfloat16),
           f"dtype {q.dtype} (want float32 or bfloat16)")
    for name, x in pools:
        _check(x.dtype == q.dtype, f"{name} dtype {x.dtype} != q dtype "
                                   f"{q.dtype}")
    _check(vc.shape == kc.shape, f"value_cache {tuple(vc.shape)} != "
                                 f"key_cache {tuple(kc.shape)}")
    _check(d2 == d and 0 < d <= _MAX_D, f"head_dim {d} (cache {d2}); "
                                        f"want equal and <= {_MAX_D}")
    tc = q.dtype == torch.bfloat16
    _check(not tc or d in _TC_HEAD_DIMS,
           f"head_dim {d} in bfloat16 (want one of {_TC_HEAD_DIMS})")
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
    for name, x in (("q", q),) + pools:
        _check(x.data_ptr() % 16 == 0, f"{name} is not 16-byte aligned")
    out = torch.empty_like(q)
    if t_total == 0:
        return out
    split, nsplit = 0, 1
    o_part = ml_part = None
    if tc:
        split, nsplit = kernel_split(q, kc, bt)
        if nsplit > 1:
            o_part = torch.empty((nsplit, t_total, h, d), dtype=torch.float32,
                                 device=dev)
            ml_part = torch.empty((nsplit, t_total, h, 2),
                                  dtype=torch.float32, device=dev)
    lib = _library()
    err = lib.ragged_paged_attention_fwd(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
        None if hkc is None else hkc.data_ptr(),
        None if hvc is None else hvc.data_ptr(), bt.data_ptr(),
        cu.data_ptr(), ctx.data_ptr(), num_seqs.data_ptr(), out.data_ptr(),
        None if o_part is None else o_part.data_ptr(),
        None if ml_part is None else ml_part.data_ptr(),
        t_total, h, kh, d, nb, nhb, bs, s_slots, mb, split, nsplit,
        float(scale),
        1 if tc else 0, torch.cuda.current_stream(dev).cuda_stream)
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
                           num_seqs, *, scale=None, host_key_cache=None,
                           host_value_cache=None):
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
                                  bt.contiguous(), cu, ctx, ns, scale,
                                  host_key_cache, host_value_cache)
    elif dev.type == "cpu":
        out = _ragged_attend_ref(q, key_cache, value_cache, bt, cu, ctx, ns,
                                 scale, hkc=host_key_cache,
                                 hvc=host_value_cache)
    else:
        raise ValueError(f"ragged_paged_attention: unsupported device {dev}")
    return out, key_cache, value_cache
