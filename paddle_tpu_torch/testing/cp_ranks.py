"""Rank bodies of the ring-attention tests: each runs in a process of a
gloo world started by :func:`paddle_tpu_torch.testing.gloo_ranks.run` and
imports only the port. (The context-parallel Llama's training cases run
through :func:`paddle_tpu_torch.testing.hybrid_ranks.train_cases`.)

:func:`ring_cases` runs :func:`~paddle_tpu_torch.ops.ring_attention.
ring_attention_data` on the global view of each case's q/k/v (numpy,
seeded) and returns the output and the gradients of
``sum(out * cotangent)``; :func:`tensor_op` drives the registry op
``ring_attention`` on Tensors drawn from the port's generator, as the
reference's ``test_ring_attention_tensor_op`` does.
:func:`ring_path_check` holds the ring's chunked kernel path against the
plain recurrence on one card (``chip_smoke.py`` phase 30 and
``tests/test_torch_card.py``).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

__all__ = ["ring_inputs", "ring_cases", "tensor_op", "ring_path_check",
           "masked_inputs", "masked_call", "masked_reference",
           "masked_errors", "masked_calls", "cp_world"]


def ring_inputs(case: dict):
    """(q, k, v, cotangent) of ``case`` as f32 numpy: q [B, S, H, D],
    k/v [B, S, H_kv, D], the cotangent shaped like q."""
    b, s, h, hkv, d = case["shape"]
    rng = np.random.RandomState(case["seed"])
    q = rng.randn(b, s, h, d).astype(np.float32)
    k = rng.randn(b, s, hkv, d).astype(np.float32)
    v = rng.randn(b, s, hkv, d).astype(np.float32)
    w = rng.randn(b, s, h, d).astype(np.float32)
    return q, k, v, w


def masked_inputs(case: dict):
    """(ids [B, S], the global mask, t [B, S], u [V]) of ``case`` as
    numpy: a padding mask over the keys, ``case["lens"][b]`` valid keys
    in row b, bool ([B, 1, S, S]) or, with ``case["float_mask"]``, 0 where
    valid and -1e4 elsewhere plus a small seeded bias. The loss is
    ``sum(logits * w)`` with the cotangent ``w[b, s, v] = t[b, s] u[v]``
    (an outer product: no [B, S, V] array is made)."""
    b, s = case["batch"]
    v = case["spec"]["vocab_size"]
    rng = np.random.RandomState(case["seed"])
    ids = rng.randint(0, v, (b, s)).astype(np.int64)
    valid = np.arange(s)[None, :] < np.asarray(case["lens"])[:, None]
    mask = np.broadcast_to(valid[:, None, None, :], (b, 1, s, s)).copy()
    if case.get("float_mask"):
        bias = 0.1 * rng.randn(b, 1, s, s).astype(np.float32)
        mask = np.where(mask, bias, np.float32(-1e4)).astype(np.float32)
    t = rng.randn(b, s).astype(np.float32)
    u = rng.randn(v).astype(np.float32)
    return ids, mask, t, u


def _masked_model(case, dev, context_parallel: bool):
    from dataclasses import replace

    from paddle_tpu_torch.models.convert import llama_state_from_jax
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    cfg = replace(LlamaConfig(**case["spec"]),
                  context_parallel=context_parallel)
    model = LlamaForCausalLM(cfg, device=dev)
    if case.get("state") is not None:
        model.load_state_dict(llama_state_from_jax(case["state"]))
    else:
        model.init_weights(torch.Generator(device=dev).manual_seed(0))
    return model


def _masked_loss(logits, t, u):
    return ((logits * u).sum(-1) * t).sum()


def masked_call(rank: int, case: dict, device="cpu") -> dict:
    """One masked forward and backward of the context-parallel Llama of
    ``case`` (the JAX model's weights in ``case["state"]``, else seed-0
    weights) bound to its mesh: this rank's rows and sequence chunk of
    the ids, the GLOBAL mask, the loss ``sum(logits * w)`` over the
    rank's share. Returns the rank's logits, its dp and cp indices, and
    the gradients summed over the world (the global loss's), as torch
    tensors on ``device``."""
    from paddle_tpu_torch.distributed import ProcessMesh
    from paddle_tpu_torch.distributed import communication as comm
    from paddle_tpu_torch.distributed.engine import shard_model_parameters

    dev = torch.device(device)
    model = _masked_model(case, dev, True)
    cp_axis = model.config.cp_axis
    shape, dims = case["mesh"], case["dims"]
    mesh = ProcessMesh(np.arange(int(np.prod(shape))).reshape(shape), dims)
    shard_model_parameters(model, mesh)
    ids, mask, t, u = masked_inputs(case)
    dp = mesh.dim_size("dp")
    di = mesh.axis_index(("dp",), rank) if dp > 1 else 0
    cp = mesh.dim_size(cp_axis)
    ci = mesh.axis_index((cp_axis,), rank)
    b, s = ids.shape[0] // dp, ids.shape[1] // cp
    rows, cols = slice(di * b, (di + 1) * b), slice(ci * s, (ci + 1) * s)
    logits = model(torch.from_numpy(ids[rows, cols]).to(dev),
                   attn_mask=torch.from_numpy(mask).to(dev))
    _masked_loss(logits, torch.from_numpy(t[rows, cols]).to(dev),
                 torch.from_numpy(u).to(dev)).backward()
    names = [n for n, _ in model.named_parameters()]
    grads = [p.grad.detach().contiguous() for _, p in
             model.named_parameters()]
    comm.all_reduce_into(grads, mesh.group(tuple(dims)))
    return {"logits": logits.detach(), "dp": di, "cp": ci,
            "rows": rows, "cols": cols, "grads": dict(zip(names, grads))}


def masked_reference(case: dict, device="cpu") -> dict:
    """The one-rank dense model's masked forward and backward on the
    global view (the reference's branch: attention with the mask, not
    causal): logits and gradients as torch tensors on ``device``."""
    dev = torch.device(device)
    model = _masked_model(case, dev, False)
    ids, mask, t, u = masked_inputs(case)
    logits = model(torch.from_numpy(ids).to(dev),
                   attn_mask=torch.from_numpy(mask).to(dev))
    _masked_loss(logits, torch.from_numpy(t).to(dev),
                 torch.from_numpy(u).to(dev)).backward()
    return {"logits": logits.detach(),
            "grads": {n: p.grad.detach() for n, p in
                      model.named_parameters()}}


def masked_errors(got: dict, ref: dict) -> dict:
    """A rank's :func:`masked_call` against :func:`masked_reference`:
    each reading's largest |diff| over the reference's largest |value|
    (the rank's logits against its rows and chunk; each gradient)."""
    want = ref["logits"][got["rows"], got["cols"]]
    out = {"logits": float((got["logits"] - want).abs().max()
                           / want.abs().max())}
    for n, g in got["grads"].items():
        w = ref["grads"][n]
        out[n] = float((g - w).abs().max() / w.abs().max())
    return out


def masked_calls(rank: int, world: int, cases: List[dict]) -> dict:
    """:func:`masked_call` of each case, by name."""
    import paddle_tpu_torch as paddle

    paddle.set_device("cpu")
    torch.set_num_threads(1)
    out = {}
    for c in cases:
        got = masked_call(rank, c)
        out[c["name"]] = {
            "logits": got["logits"].numpy(), "dp": got["dp"],
            "cp": got["cp"],
            "grads": {n: g.numpy() for n, g in got["grads"].items()}}
    return out


def cp_world(rank: int, world: int, train_cases, pipe_cases,
             masked) -> dict:
    """The context-parallel tests' one world: the ``ParallelTrainStep``
    cases (``hybrid_ranks.train_cases``), the context-parallel Pipe's
    (``pipeline_ranks.pipeline_cases``) and the masked calls, their
    results by case name."""
    from paddle_tpu_torch.testing import hybrid_ranks, pipeline_ranks

    out = hybrid_ranks.train_cases(rank, world, train_cases)
    out.update(pipeline_ranks.pipeline_cases(rank, world, pipe_cases))
    out.update(masked_calls(rank, world, masked))
    return out


def ring_cases(rank: int, world: int, cases: List[dict]) -> dict:
    """Each case's output and the gradients of q, k, v on this rank (the
    global view, on every rank), by name; then :func:`tensor_op`'s result
    under ``"tensor_op"``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import ProcessMesh
    from paddle_tpu_torch.ops.ring_attention import ring_attention_data

    paddle.set_device("cpu")
    out = {}
    for case in cases:
        mesh = ProcessMesh(np.arange(world).reshape(case["mesh"]),
                           case["dims"])
        q, k, v, w = (torch.from_numpy(a) for a in ring_inputs(case))
        for t in (q, k, v):
            t.requires_grad_(True)
        o = ring_attention_data(q, k, v, mesh, axis_name="sp",
                                causal=case["causal"],
                                batch_axis=case.get("batch_axis"))
        (o * w).sum().backward()
        out[case["name"]] = {"o": o.detach().numpy(),
                             "dq": q.grad.numpy(), "dk": k.grad.numpy(),
                             "dv": v.grad.numpy()}
    out["tensor_op"] = tensor_op(rank, world)
    return out


def tensor_op(rank: int, world: int) -> dict:
    """The reference's tensor-op case: ``init_mesh([world], ["sp"])``,
    ``paddle.seed(0)``, q/k/v of ``randn([1, 32, 2, 8])``, the op, then
    ``out.sum().backward()``. Returns the output and the gradients."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed.mesh import init_mesh, set_mesh
    from paddle_tpu_torch.ops import ring_attention as ra

    paddle.set_device("cpu")
    init_mesh([world], ["sp"])
    try:
        paddle.seed(0)
        q, k, v = (paddle.randn([1, 32, 2, 8]) for _ in range(3))
        for t in (q, k, v):
            t.stop_gradient = False
        o = ra.ring_attention(q, k, v, axis_name="sp", causal=True)
        o.sum().backward()
        return {"shape": list(o.shape), "o": o.numpy(),
                "dq": q.grad.numpy(), "dk": k.grad.numpy(),
                "dv": v.grad.numpy()}
    finally:
        set_mesh(None)


def ring_path_check(dev, chunk, n: int = 2, seed: int = 31,
                    dtypes=("float32", "bfloat16")) -> dict:
    """The ring's chunked kernel path on ``dev`` (every rank's body of a
    causal ring of ``n``, ``ring_attention_simulated``: K2 a chunk,
    the merge by logsumexp, K3 and K4 given the merged logsumexp and
    delta), each rank's chunk ``chunk`` = (B, S, H, D). f32: the output
    and dq, dk, dv against the reference's plain recurrence
    (``ring_attention_plain``) and its autograd, element-wise at
    ``flash_check.TOL[float32]``. bf16: each chunk's K2 output and
    logsumexp against its plain version, and its K3 and K4 against
    theirs given the merged output and logsumexp (``flash_check``'s
    forward and backward halves: they round P and dS as the kernels
    do); the merged output's largest error against the f32 plain
    recurrence is reported. Raises on anything out of bounds; returns
    the errors."""
    from paddle_tpu_torch.ops import ring_attention as ra
    from paddle_tpu_torch.testing import flash_check

    b, s, h, d = chunk
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn((b, n * s, h, d), generator=gen, device=dev)
                   for _ in range(4))
    scale = d ** -0.5
    res = {"shape": [b, n * s, h, d], "ranks": n}
    if "float32" in dtypes:
        qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
        plain = ra.ring_attention_plain(qq, kk, vv, n, True)
        plain.backward(do)
        sim = ra.ring_attention_simulated(q, k, v, do, n, True)
        tol = flash_check.TOL[torch.float32]
        errs = {}
        for key, want in (("o", plain.detach()), ("dq", qq.grad),
                          ("dk", kk.grad), ("dv", vv.grad)):
            torch.testing.assert_close(sim[key], want, **tol)
            errs[key] = float((sim[key] - want).abs().max())
        res["float32"] = {"max_abs_err": errs, "tolerance": str(tol)}
        del qq, kk, vv, plain, sim
    if "bfloat16" in dtypes:
        q16, k16, v16, do16 = (x.to(torch.bfloat16) for x in (q, k, v, do))
        sim = ra.ring_attention_simulated(q16, k16, v16, do16, n, True,
                                          keep=True)
        chunks = []
        for c in sim["chunks"]:
            f = flash_check.check(c["q"], c["k"], c["v"], c["do"],
                                  {"o": c["o"], "lse": c["lse"]}, scale,
                                  c["causal"], parts=("fwd",))
            bw = flash_check.check(
                c["q"], c["k"], c["v"], c["do"],
                {"o": c["o_merged"], "lse": c["lse_merged"], "dq": c["dq"],
                 "dk": c["dk"], "dv": c["dv"]}, scale, c["causal"],
                parts=("bwd",))
            chunks.append({"rank": c["rank"], "source": c["src"],
                           "causal": c["causal"],
                           "max_abs_err": {**f["max_abs_err"],
                                           **bw["max_abs_err"]},
                           "near_boundary": {"fwd": f["near_boundary"],
                                             "bwd": bw["near_boundary"]}})
        with torch.no_grad():
            ref = ra.ring_attention_plain(q16.float(), k16.float(),
                                          v16.float(), n, True)
        res["bfloat16"] = {
            "chunks": chunks,
            "tolerance": str(flash_check.TOL[torch.bfloat16]),
            "merged_o_vs_f32_recurrence_max_abs_err":
                float((sim["o"].float() - ref).abs().max())}
    return res
