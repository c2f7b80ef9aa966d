"""Ring attention: context parallelism over a sequence-sharded mesh axis
(port of ``paddle_tpu/ops/ring_attention.py``).

The JAX package runs the ring inside ``shard_map``: each step attends the
local query chunk to the key/value chunk it holds, folds it into a running
online softmax and passes the chunk on with ``lax.ppermute``. Here each
rank is a process and the ring is written out over ``torch.distributed``:

* **the forward.** P hops around the ``group``'s ring. At hop i rank r
  holds the key/value chunk of rank (r - i) mod P; it sends what it holds
  to rank r + 1 and takes the next from rank r - 1 (one batched
  isend/irecv a hop, :func:`~paddle_tpu_torch.distributed.communication.
  shift_many`; a CUDA tensor goes through the host under gloo). Only the
  compact ``[B, S/P, H_kv, D]`` chunks travel (GQA). Causality comes from
  the global indices: the diagonal chunk is causal (Sq = Sk, where the
  bottom-right mask is the top-left one) and earlier chunks are whole; a
  chunk entirely in the future is skipped (the reference computes it
  masked; it adds nothing there). Each chunk gives its output and its row
  logsumexp, and the chunks are merged by their logsumexps in f32;
* **the backward** (a ``torch.autograd.Function``: torch's P2P has no
  autograd) recomputes each chunk's P from the merged (global) logsumexp
  and delta = rowsum(dO o O) of the merged output, so every chunk's P is
  exact. dQ accumulates on the rank; dK and dV accumulate in f32, travel
  the ring with their keys and values, and a last hop brings them back to
  the rank that owns them;
* **the chunks** go through the flash kernels on the card: K2
  (``_flash_fwd_cuda``, which returns the chunk's logsumexp), K3 and K4
  (``_flash_bwd_dq_cuda``, ``_flash_bwd_dkv_cuda``, given the global
  logsumexp and delta). The kernels take as many key/value heads as query
  heads, so a GQA chunk is repeated to H heads before the kernel and its
  dK/dV summed over each group after it. On the CPU each chunk is the
  plain f32 attention of ``ops/flash_attention.py``; a CUDA tensor
  launches the kernels or raises.

Entries: :func:`ring_attention_inner` on this rank's chunk (the
reference's ``shard_map`` body), :func:`ring_attention_data` on the global
view (every rank passes the whole q/k/v; it cuts the rank's chunk, runs
the ring and returns the global output), :func:`ring_attention` the
registry op. Each rank's forward and backward is a generator that yields
what it sends at each hop: :class:`_Ring` drives this rank's over the
group, and :func:`ring_attention_simulated` drives every rank's in one
process, a hop a rotation of their sends. :func:`ring_attention_plain` is
the reference's online-softmax recurrence in f32 on one process: the
card's checks hold the simulated ring against it.
"""
from __future__ import annotations

from typing import Optional

import torch

from paddle_tpu_torch.distributed import communication as comm
from paddle_tpu_torch.ops import flash_attention as fa

__all__ = ["ring_attention_inner", "ring_attention_data", "ring_attention",
           "ring_attention_plain", "ring_attention_simulated"]

_NEG_INF = -1e30


# ---------------------------------------------------------------------------
# one chunk: the kernels on the card, the plain version on the CPU
# ---------------------------------------------------------------------------
def _expand(x: torch.Tensor, rep: int) -> torch.Tensor:
    """[B, S, H_kv, D] -> [B, S, H, D]: each kv head serves ``rep`` query
    heads (query head h reads kv head h // rep)."""
    return x if rep == 1 else x.repeat_interleave(rep, dim=2)


def _fold(dx: torch.Tensor, rep: int) -> torch.Tensor:
    """[B, S, H, D] -> [B, S, H_kv, D] in f32: the sum over each group."""
    if rep == 1:
        return dx.float()
    b, s, h, d = dx.shape
    return dx.float().view(b, s, h // rep, rep, d).sum(3)


def _on_card(x: torch.Tensor) -> bool:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"ring_attention: unsupported device {x.device}")
    return x.device.type == "cuda"


def _chunk_fwd(q, k, v, scale, causal):
    """(o in q's dtype, lse [B*H, Sq] f32) of q against one chunk."""
    if _on_card(q):
        return fa._flash_fwd_cuda(q, k, v, scale, causal)
    return fa._flash_fwd_ref(q, k, v, scale, causal)


def _chunk_bwd_ref(q, k, v, do, lse, delta, scale, causal):
    """Plain chunk backward with the global ``lse`` and ``delta``:
    (dq, dk, dv) in f32."""
    b, sq, h, _ = q.shape
    p = fa._probs(q, k, lse, scale, causal)              # [B, H, Sq, Sk]
    dof = do.float().transpose(1, 2)
    dp = torch.matmul(dof, v.float().transpose(1, 2).transpose(-1, -2))
    ds = p * (dp - delta.reshape(b, h, sq, 1))
    dq = torch.matmul(ds, k.float().transpose(1, 2)) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float().transpose(1, 2)) * scale
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


def _chunk_bwd(q, k, v, do, lse, delta, scale, causal):
    """(dq, dk, dv) of one chunk given the merged lse and delta."""
    if _on_card(q):
        dq = fa._flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal)
        dk, dv = fa._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale,
                                        causal)
        return dq, dk, dv
    return _chunk_bwd_ref(q, k, v, do, lse, delta, scale, causal)


def _merge(parts):
    """The chunks' (o, lse) merged by their logsumexps, in f32: (o f32
    [B, S, H, D], lse [B*H, S])."""
    lse = torch.logsumexp(torch.stack([l for _, l in parts]), 0)
    b, s, h, _ = parts[0][0].shape
    o = None
    for oc, lc in parts:
        w = torch.exp(lc - lse).view(b, h, s).transpose(1, 2)[..., None]
        o = w * oc.float() if o is None else o + w * oc.float()
    return o, lse


def _visits(r: int, n: int, causal: bool):
    """(hop, source rank, causal) of the chunks rank r attends to."""
    for i in range(n):
        src = (r - i) % n
        if causal and src > r:
            continue                         # entirely in the future
        yield i, src, causal and src == r


# ---------------------------------------------------------------------------
# one rank's ring: generators that yield what they send at each hop and are
# sent what they receive, driven by the real ring or by one process
# ---------------------------------------------------------------------------
def _fwd_body(q, k, v, r: int, n: int, causal: bool, scale: float,
              log: Optional[dict] = None):
    """Rank r's forward: k/v go one hop a step around the ring of ``n``
    and q attends each chunk it must. Returns (o in q's dtype, merged
    lse). ``log`` {hop: chunk call} takes each chunk's inputs and
    (o, lse)."""
    rep = q.shape[2] // k.shape[2]
    todo = {i: (src, c) for i, src, c in _visits(r, n, causal)}
    parts = []
    kc, vc = k, v
    for i in range(n):
        if i in todo:
            src, c = todo[i]
            kk, vv = _expand(kc, rep), _expand(vc, rep)
            parts.append(_chunk_fwd(q, kk, vv, scale, c))
            if log is not None:
                log[i] = dict(rank=r, src=src, causal=c, q=q, k=kk, v=vv,
                              o=parts[-1][0], lse=parts[-1][1])
        if i < n - 1:
            kc, vc = yield [kc, vc]
    o, lse = _merge(parts)
    return o.to(q.dtype), lse


def _bwd_body(q, k, v, o, lse, do, r: int, n: int, causal: bool,
              scale: float, log: Optional[dict] = None):
    """Rank r's backward: the chunks again in the forward's order, each
    given the merged ``lse`` and delta; f32 dK/dV travel with their k/v
    and a last hop takes them home. Returns (dq, dk, dv) in the inputs'
    dtypes. ``log`` (the forward's) takes each chunk's do, merged o and
    lse, and its (dq, dk, dv) before the fold over the kv groups."""
    rep = q.shape[2] // k.shape[2]
    delta = fa._delta(o, do)
    todo = {i: c for i, _, c in _visits(r, n, causal)}
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kc, vc = k, v
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    for i in range(n):
        if i in todo:
            a, b_, c = _chunk_bwd(q, _expand(kc, rep), _expand(vc, rep),
                                  do, lse, delta, scale, todo[i])
            dq += a.float()
            dk += _fold(b_, rep)
            dv += _fold(c, rep)
            if log is not None:
                log[i].update(do=do, o_merged=o, lse_merged=lse, dq=a,
                              dk=b_, dv=c)
        if i < n - 1:
            kc, vc, dk, dv = yield [kc, vc, dk, dv]
    if n > 1:
        # the accumulators of the chunk held last go home
        dk, dv = yield [dk, dv]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _drive(bodies, shift) -> list:
    """Run ring bodies in lockstep: at each hop every body yields what it
    sends, and ``shift`` (the bodies' sends, in order) returns what each
    receives. Returns each body's result."""
    got = [None] * len(bodies)
    while True:
        sends, results = [], []
        for body, g in zip(bodies, got):
            try:
                sends.append(body.send(g))
            except StopIteration as stop:
                results.append(stop.value)
        if results:
            assert not sends, "ring bodies out of step"
            return results
        got = shift(sends)


def _place(group):
    """(ranks in the ring, this rank's index); a ring of one without a
    group."""
    return (1, 0) if group is None else (group.nranks, group.rank())


def _over(group):
    """The transport of one rank's body: a batched P2P hop over
    ``group``."""
    return lambda sends: [comm.shift_many(sends[0], group)]


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        n, r = _place(group)
        (o, lse), = _drive([_fwd_body(q, k, v, r, n, causal, scale)],
                           _over(group))
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        n, r = _place(ctx.group)
        (dq, dk, dv), = _drive(
            [_bwd_body(q, k, v, o, lse, do.contiguous(), r, n, ctx.causal,
                       ctx.scale)], _over(ctx.group))
        return dq, dk, dv, None, None, None


def _check_heads(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            (q.shape[0], q.shape[1], q.shape[3]) != \
            (k.shape[0], k.shape[1], k.shape[3]):
        raise ValueError(f"ring_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; want "
                         f"[B, S, H, D] and [B, S, H_kv, D]")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"q heads {q.shape[2]} not a multiple of kv heads "
                         f"{k.shape[2]}")


def ring_attention_inner(q, k, v, group, causal: bool = True,
                         scale: Optional[float] = None):
    """Attention of this rank's sequence chunk over the ring of ``group``
    (the reference's ``ring_attention_inner`` inside ``shard_map``).
    q: [B, S/P, H, D]; k/v: [B, S/P, H_kv, D] with H_kv dividing H; rank
    i of the group holds chunk i of the sequence. Returns [B, S/P, H, D]
    in q's dtype. Differentiable."""
    _check_heads(q, k, v)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return _Ring.apply(q, k, v, group, bool(causal), float(scale))


def _axis_group(mesh, axis: str):
    if axis not in mesh.dim_names:
        raise ValueError(f"ring_attention: mesh axis {axis!r} is not in "
                         f"the mesh's axes {mesh.dim_names}")
    g = mesh.group(axis)
    if g is None:
        raise ValueError(f"ring_attention: this rank is not on the mesh "
                         f"{mesh.process_ids}")
    return g


def ring_attention_data(q, k, v, mesh, axis_name: str = "sp",
                        causal: bool = True, batch_axis: Optional[str] = None):
    """Global-view entry: every rank passes the whole q [B, S, H, D] and
    k/v [B, S, H_kv, D]; S is split over ``axis_name`` of ``mesh`` (a
    :class:`~paddle_tpu_torch.distributed.ProcessMesh`) and B over
    ``batch_axis`` when given. Returns the whole output on every rank;
    the gradients of q, k and v are the whole ones too."""
    g = _axis_group(mesh, axis_name)
    gb = _axis_group(mesh, batch_axis) if batch_axis else None
    q, k, v = (comm.split_along(comm.split_along(x, gb, 0), g, 1)
               for x in (q, k, v))
    out = ring_attention_inner(q, k, v, g, causal)
    return comm.gather_along(comm.gather_along(out, g, 1), gb, 0)


def ring_attention(query, key, value, mesh=None, axis_name: str = "sp",
                   causal: bool = True, batch_axis: Optional[str] = None):
    """Tensor-level ring attention (the registry op; eager tape and
    ``TrainStep`` both work) over ``mesh``, the current step's mesh or
    the one set with ``distributed.init_mesh`` / ``set_mesh``."""
    from paddle_tpu_torch.distributed.engine import current_mesh
    from paddle_tpu_torch.distributed.mesh import get_mesh

    mesh = mesh or current_mesh() or get_mesh()
    if mesh is None:
        raise RuntimeError(
            "ring_attention needs a mesh: pass mesh=... or set one via "
            "distributed.init_mesh/set_mesh")
    from paddle_tpu_torch.ops.registry import API as _API

    return _API["ring_attention"](query, key, value, mesh=mesh,
                                  axis_name=axis_name, causal=causal,
                                  batch_axis=batch_axis)


# ---------------------------------------------------------------------------
# one process: the plain recurrence, and every rank's chunk calls
# ---------------------------------------------------------------------------
def ring_attention_plain(q, k, v, n: int, causal: bool = True,
                         scale: Optional[float] = None) -> torch.Tensor:
    """The reference's ring on one process: q [B, S, H, D], k/v [B, S,
    H_kv, D] cut into ``n`` chunks, each rank's online softmax over the
    chunks in ring order, in f32 (grouped-query einsums, global-index
    causal mask, the masked future chunks included). Returns [B, S, H, D]
    in q's dtype; differentiable."""
    _check_heads(q, k, v)
    b, s_all, h, d = q.shape
    hkv = k.shape[2]
    rep = h // hkv
    s = s_all // n
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    outs = []
    for r in range(n):
        qt = q[:, r * s:(r + 1) * s].transpose(1, 2).float().reshape(
            b, hkv, rep, s, d)
        row = r * s + torch.arange(s, device=q.device)[:, None]
        acc = torch.zeros((b, hkv, rep, s, d), device=q.device)
        m = torch.full((b, hkv, rep, s, 1), _NEG_INF, device=q.device)
        l = torch.zeros((b, hkv, rep, s, 1), device=q.device)
        for i in range(n):
            src = (r - i) % n
            kt = k[:, src * s:(src + 1) * s].transpose(1, 2).float()
            vt = v[:, src * s:(src + 1) * s].transpose(1, 2).float()
            sc = torch.einsum("bgrqd,bgkd->bgrqk", qt, kt) * scale
            if causal:
                col = src * s + torch.arange(s, device=q.device)[None, :]
                sc = torch.where(row >= col, sc, _NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            p = torch.exp(sc - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bgrqk,bgkd->bgrqd", p, vt)
            m = m_new
        out = (acc / torch.where(l == 0.0, 1.0, l)).reshape(b, h, s, d)
        outs.append(out.transpose(1, 2))
    return torch.cat(outs, 1).to(q.dtype)


def ring_attention_simulated(q, k, v, do, n: int, causal: bool = True,
                             scale: Optional[float] = None,
                             keep: bool = False) -> dict:
    """The ring of ``n`` ranks in one process: every rank's body of
    :class:`_Ring`'s forward and backward, driven in lockstep, each hop a
    rotation of the ranks' sends. q [B, S, H, D], k/v [B, S, H_kv, D], do
    the output's cotangent. Returns the whole ``o``, ``dq``, ``dk``,
    ``dv`` and, with ``keep``, each chunk call's inputs and outputs under
    ``"chunks"`` (rank, source, causal, q, k, v, do, its o and lse, the
    merged o and lse, its dq, dk, dv)."""
    _check_heads(q, k, v)
    s = q.shape[1] // n
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)

    def cut(x):
        return [x[:, i * s:(i + 1) * s].contiguous() for i in range(n)]

    def rotate(sends):                     # rank r takes rank r - 1's
        return sends[-1:] + sends[:-1]

    qs, ks, vs, dos = cut(q), cut(k), cut(v), cut(do)
    logs = [{} if keep else None for _ in range(n)]
    fwd = _drive([_fwd_body(qs[r], ks[r], vs[r], r, n, causal, scale,
                            logs[r]) for r in range(n)], rotate)
    bwd = _drive([_bwd_body(qs[r], ks[r], vs[r], o, lse, dos[r], r, n,
                            causal, scale, logs[r])
                  for r, (o, lse) in enumerate(fwd)], rotate)
    out = {"o": torch.cat([o for o, _ in fwd], 1)}
    for j, key in enumerate(("dq", "dk", "dv")):
        out[key] = torch.cat([g[j] for g in bwd], 1)
    if keep:
        out["chunks"] = [c for log in logs for _, c in sorted(log.items())]
    return out


# register as a first-class op (as the reference does)
from paddle_tpu_torch.ops import registry as _registry  # noqa: E402
from paddle_tpu_torch.ops.registry import register_emitter as _register  # noqa


@_register(name="ring_attention")
def _ring_attention_emitter(q, k, v, mesh=None, axis_name="sp", causal=True,
                            batch_axis=None):
    return ring_attention_data(q, k, v, mesh, axis_name, causal, batch_axis)


if "ring_attention" not in _registry.OPS:
    _registry.build_registry([
        {"op": "ring_attention", "tensor_args": ["q", "k", "v"],
         "methods": []}])
