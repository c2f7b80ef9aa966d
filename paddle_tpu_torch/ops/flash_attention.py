"""Flash attention, forward and backward, on [B, S, H, D] tensors.

Port of ``paddle_tpu/ops/pallas/flash_attention.py``: blockwise attention
with an f32 online softmax, causal or not. The causal mask is
bottom-right aligned: query row ``i`` sees key column ``j`` iff
``j <= i + (Sk - Sq)``. The forward returns O and the per-row logsumexp
(``lse``, [B*H, Sq] f32; the TPU kernel stores [BH, 8, S] for its
sublanes); the backward recomputes P = exp(S - lse) and returns
(dq, dk, dv). A row that sees no key (causal with Sq > Sk) gets O = 0,
lse = -inf and zero gradients.

Two implementations of each pass:

* ``_flash_fwd_ref`` / ``_flash_bwd_ref`` -- plain PyTorch in f32. The
  CPU path, and the reference the kernels are held against on the card.
* ``_flash_fwd_cuda``, ``_flash_bwd_dq_cuda``, ``_flash_bwd_dkv_cuda`` --
  the hand-written Hopper kernels (``csrc/flash_attention.cu``), bound
  with ``ctypes``. They take any Sq and Sk and head_dim 16, 32, 64 or
  128, in float32 or bfloat16. In bfloat16 all three run on the tensor
  cores (wgmma, TMA) and round P and dS to bfloat16 before the products
  that take them, as the TPU kernels do; in float32 they compute in f32
  FMAs (the tensor cores would take float32 as TF32).
  :func:`route_launches` reads the launches by route.

Selection is by device and nothing else: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises (an unsupported
head_dim or dtype on the card raises; it never falls back).
:class:`_FlashAttention` is the autograd function (the TPU package's
``jax.custom_vjp``); :func:`flash_attention_data` is the entry point.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["flash_attention_data"]

# kernel launches through the wrappers below, by kernel (a run reads them
# to show the main path went through the kernels; reset them to 0 before
# such a run)
launches = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0}

_KERNEL = "flash_attention"
HEAD_DIMS = (16, 32, 64, 128)
KEY_BLOCK = 128     # keys per online-softmax step of the bf16 K2 kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_IDS = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 1,
                 "flash_attention_bwd_dkv": 2}


# ---------------------------------------------------------------------------
# plain versions (the CPU path; the kernels' reference on the card)
# ---------------------------------------------------------------------------
def _visible(sq, sk, causal, device):
    """(Sq, Sk) bool: which key columns each query row sees, or None."""
    if not causal:
        return None
    row = torch.arange(sq, device=device)[:, None]
    col = torch.arange(sk, device=device)[None, :]
    return col <= row + (sk - sq)


def _scores(q, k, scale):
    """S = scale * Q K^T in f32, [B, H, Sq, Sk]."""
    return torch.matmul(q.float().transpose(1, 2),
                        k.float().transpose(1, 2).transpose(-1, -2)) * scale


def _probs(q, k, lse, scale, causal):
    """P = exp(S - lse) in f32 on [B, H, Sq, Sk], 0 where masked."""
    b, sq, h, _ = q.shape
    p = torch.exp(_scores(q, k, scale) - lse.reshape(b, h, sq, 1))
    vis = _visible(sq, k.shape[1], causal, q.device)
    return p if vis is None else torch.where(vis, p, 0.0)


def _flash_fwd_ref(q, k, v, scale, causal, round_to=None):
    """Plain forward: (o [B, Sq, H, D] in q's dtype, lse [B*H, Sq] f32).

    With ``round_to`` (a dtype) it takes the blockwise form of the bf16
    K2 kernel and of the TPU kernel ``_fwd_kernel``: an online softmax
    over key blocks of :data:`KEY_BLOCK`, whose P = exp(S - running max)
    is rounded to ``round_to`` before each P V product."""
    b, sq, h, _ = q.shape
    s = _scores(q, k, scale)
    vis = _visible(sq, k.shape[1], causal, q.device)
    if vis is not None:
        s = s.masked_fill(~vis, float("-inf"))
    vf = v.float().transpose(1, 2)
    if round_to is None:
        lse = torch.logsumexp(s, dim=-1)                 # -inf: no key
        p = torch.exp(s - lse[..., None])
        p = torch.where(torch.isfinite(lse)[..., None], p, 0.0)
        o = torch.matmul(p, vf)
    else:
        m = torch.full(s.shape[:-1], float("-inf"), device=s.device)
        l = torch.zeros_like(m)
        o = torch.zeros(s.shape[:-1] + vf.shape[-1:], device=s.device)
        for k0 in range(0, s.shape[-1], KEY_BLOCK):
            sb = s[..., k0:k0 + KEY_BLOCK]
            m_new = torch.maximum(m, sb.amax(-1))
            seen = torch.isfinite(m_new)             # some key so far
            base = torch.where(seen, m_new, 0.0)
            alpha = torch.where(seen, torch.exp(m - base), 1.0)
            p = torch.exp(sb - base[..., None])
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + torch.matmul(
                p.to(round_to).float(), vf[..., k0:k0 + KEY_BLOCK, :])
            m = m_new
        lse = torch.where(l > 0, m + torch.log(l), float("-inf"))
        o = torch.where(l[..., None] > 0, o / l[..., None], 0.0)
    return o.transpose(1, 2).to(q.dtype), lse.reshape(b * h, sq)


def _delta(o, do):
    """delta = rowsum(dO o O) as [B*H, Sq] f32 (computed outside the
    kernels, as ``_flash_bwd`` does in the TPU package)."""
    b, sq, h, _ = o.shape
    d = (do.float() * o.float()).sum(-1)                 # [B, Sq, H]
    return d.transpose(1, 2).reshape(b * h, sq).contiguous()


def _flash_bwd_ref(q, k, v, o, lse, do, scale, causal, round_to=None):
    """Plain backward: (dq, dk, dv) in the inputs' dtypes. With
    ``round_to`` (a dtype), P and dS are rounded to it before the
    dQ = dS K, dV = P^T dO and dK = dS^T Q products, as the bf16 K3 and
    K4 kernels and the TPU kernels ``_bwd_dq_kernel`` and
    ``_bwd_dkv_kernel`` round them."""
    p = _probs(q, k, lse, scale, causal)                 # [B, H, Sq, Sk]
    b, sq, h, _ = q.shape
    dof = do.float().transpose(1, 2)
    dp = torch.matmul(dof, v.float().transpose(1, 2).transpose(-1, -2))
    ds = p * (dp - _delta(o, do).reshape(b, h, sq, 1))
    if round_to is not None:
        p, ds = p.to(round_to).float(), ds.to(round_to).float()
    dq = torch.matmul(ds, k.float().transpose(1, 2)) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float().transpose(1, 2)) * scale
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


# ---------------------------------------------------------------------------
# Hopper kernel wrappers
# ---------------------------------------------------------------------------
_lib = None


def _library():
    global _lib
    if _lib is None:
        from paddle_tpu_torch.ops import _build

        lib = _build.load(_KERNEL)
        tail = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]
        lib.flash_attention_fwd.argtypes = [ctypes.c_void_p] * 5 + tail
        lib.flash_attention_bwd_dq.argtypes = [ctypes.c_void_p] * 7 + tail
        lib.flash_attention_bwd_dkv.argtypes = [ctypes.c_void_p] * 8 + tail
        for fn in (lib.flash_attention_fwd, lib.flash_attention_bwd_dq,
                   lib.flash_attention_bwd_dkv):
            fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.flash_attention_smem_bytes.restype = ctypes.c_size_t
        lib.flash_attention_route_launches.argtypes = [ctypes.c_int] * 2
        lib.flash_attention_route_launches.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def smem_bytes(kernel: str, head_dim: int,
               dtype: torch.dtype = torch.bfloat16) -> int:
    """Dynamic shared memory of one CTA of ``kernel`` (a key of
    :data:`launches`) at ``head_dim`` for inputs of ``dtype``."""
    return int(_library().flash_attention_smem_bytes(
        _KERNEL_IDS[kernel], head_dim, _DTYPES[dtype]))


def route_launches() -> dict:
    """Successful kernel launches so far, by kernel (a key of
    :data:`launches`) and route: ``"tensor_cores"`` (the bf16 wgmma
    kernels) or ``"fma"`` (the f32 kernels), as the library counts them
    where it launches."""
    lib = _library()
    return {name: {route: int(lib.flash_attention_route_launches(i, tc))
                   for route, tc in (("fma", 0), ("tensor_cores", 1))}
            for name, i in _KERNEL_IDS.items()}


def _check(cond, msg):
    if not cond:
        raise ValueError(f"flash_attention kernel: {msg}")


def _prepare(q, k, v, *bwd):
    """Check what the kernels take: (q, k, v) and, for the backward,
    (do, lse, delta). Returns them contiguous and the shape
    (B, H, Sq, Sk, D); raises ValueError on anything else."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dev = q.device
    _check(q.dtype in _DTYPES, f"dtype {q.dtype} (want float32 or bfloat16)")
    _check(d in HEAD_DIMS, f"head_dim {d} (want one of {HEAD_DIMS})")
    _check(b * h <= 65535, f"batch x heads {b * h} > 65535")
    want = {"k": ((b, sk, h, d), q.dtype), "v": ((b, sk, h, d), q.dtype),
            "do": (tuple(q.shape), q.dtype),
            "lse": ((b * h, sq), torch.float32),
            "delta": ((b * h, sq), torch.float32)}
    out = []
    for name, x in zip(("q", "k", "v", "do", "lse", "delta"), (q, k, v) + bwd):
        _check(x.device == dev, f"{name} on {x.device}, q on {dev}")
        if name in want:
            shape, dtype = want[name]
            _check(tuple(x.shape) == shape and x.dtype == dtype,
                   f"{name} {tuple(x.shape)} {x.dtype}, want {shape} {dtype}")
        x = x.contiguous()
        _check(x.data_ptr() % 16 == 0, f"{name} is not 16-byte aligned")
        out.append(x)
    return out, (b, h, sq, sk, d)


def _raise_on(err, kernel):
    if err != 0:
        msg = _library().flash_attention_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                           f"{err} ({msg})")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _flash_fwd_cuda(q, k, v, scale, causal):
    """K2 on PyTorch's current stream: (o, lse [B*H, Sq] f32)."""
    (q, k, v), (b, h, sq, sk, d) = _prepare(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    if sq == 0:
        return o, lse
    if sk == 0:
        return o.zero_(), lse.fill_(float("-inf"))
    err = _library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, h, sq, sk, d, float(scale), int(bool(causal)),
        _DTYPES[q.dtype], _stream(q.device))
    _raise_on(err, "flash_attention_fwd")
    launches["flash_attention_fwd"] += 1
    return o, lse


def _flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal):
    """K3: dq from (q, k, v, do, lse, delta)."""
    (q, k, v, do, lse, delta), (b, h, sq, sk, d) = _prepare(q, k, v, do, lse,
                                                          delta)
    dq = torch.empty_like(q)
    if sq == 0 or sk == 0:
        return dq.zero_()
    err = _library().flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, sq, sk, d,
        float(scale), int(bool(causal)), _DTYPES[q.dtype], _stream(q.device))
    _raise_on(err, "flash_attention_bwd_dq")
    launches["flash_attention_bwd_dq"] += 1
    return dq


def _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale, causal):
    """K4: (dk, dv) from (q, k, v, do, lse, delta)."""
    (q, k, v, do, lse, delta), (b, h, sq, sk, d) = _prepare(q, k, v, do, lse,
                                                          delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if sk == 0 or sq == 0:
        return dk.zero_(), dv.zero_()
    err = _library().flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h,
        sq, sk, d, float(scale), int(bool(causal)), _DTYPES[q.dtype],
        _stream(q.device))
    _raise_on(err, "flash_attention_bwd_dkv")
    launches["flash_attention_bwd_dkv"] += 1
    return dk, dv


# ---------------------------------------------------------------------------
# dispatch + autograd
# ---------------------------------------------------------------------------
def _device_kind(x):
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention: unsupported device {x.device}")
    return x.device.type


def _flash_fwd(q, k, v, scale, causal):
    if _device_kind(q) == "cuda":
        return _flash_fwd_cuda(q, k, v, scale, causal)
    return _flash_fwd_ref(q, k, v, scale, causal)


def _flash_bwd(q, k, v, o, lse, do, scale, causal):
    if _device_kind(q) == "cuda":
        delta = _delta(o, do)
        dq = _flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal)
        dk, dv = _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale, causal)
        return dq, dk, dv
    return _flash_bwd_ref(q, k, v, o, lse, do, scale, causal)


class _FlashAttention(torch.autograd.Function):
    """O = attention(q, k, v); backward by recomputation from lse."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        o, lse = _flash_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, o, lse, do, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention_data(q, k, v, causal=False, scale=None):
    """Differentiable flash attention on [B, S, H, D] tensors (k and v
    [B, Sk, H, D]); ``scale`` defaults to 1/sqrt(D). Returns O, shaped
    like q. Any Sq and Sk."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or (
            q.shape[0], q.shape[2], q.shape[3]) != (
            k.shape[0], k.shape[2], k.shape[3]):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; want "
                         f"[B, S, H, D] with matching B, H, D")
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return _FlashAttention.apply(q, k, v, float(scale), bool(causal))
