"""Rank bodies of the pipeline-parallel tests: each runs in a process of
a gloo world started by :func:`paddle_tpu_torch.testing.gloo_ranks.start`
and imports only the port.

The models are the JAX package's pipeline test models rebuilt on the
port's ``nn.Layer`` (the same layer names, so a JAX state dict loads as
it is) and the Llama Pipe (a JAX state dict goes through
``models.convert.llama_pipe_state_from_jax``). :func:`pipeline_cases`
trains (or runs the forward of) each case on the ranks of its mesh and
returns the losses, this rank's parameters with their layouts, the slot
shapes and what else a case asks for.
"""
from __future__ import annotations

import time
import traceback
from typing import Dict, List

import numpy as np
import torch

__all__ = ["Block", "DropBlock", "Other", "TiedEmbed", "head_forward",
           "build_pipe", "pipeline_cases", "rotations", "fleet_pipeline",
           "card_pair", "card_pairs", "pair_faults", "several"]


def _paddle():
    import paddle_tpu_torch as paddle

    paddle.set_device("cpu")
    return paddle


def _layer_classes():
    from paddle_tpu_torch import nn, ops

    class Block(nn.Layer):
        def __init__(self, d):
            super().__init__()
            self.fc1 = nn.Linear(d, 2 * d)
            self.fc2 = nn.Linear(2 * d, d)
            self.norm = nn.LayerNorm(d)

        def forward(self, x):
            return self.norm(x + self.fc2(ops.gelu(self.fc1(x))))

    class DropBlock(nn.Layer):
        def __init__(self, d, p):
            super().__init__()
            self.fc1 = nn.Linear(d, 2 * d)
            self.drop = nn.Dropout(p)
            self.fc2 = nn.Linear(2 * d, d)
            self.norm = nn.LayerNorm(d)

        def forward(self, x):
            return self.norm(x + self.fc2(self.drop(ops.gelu(self.fc1(x)))))

    class Other(nn.Layer):
        def __init__(self, d):
            super().__init__()
            self.fc = nn.Linear(d, d)

        def forward(self, x):
            return self.fc(x)

    class TiedEmbed(nn.Layer):
        def __init__(self, vocab, d):
            super().__init__()
            self.weight = self.create_parameter([vocab, d])

        def forward(self, ids):
            return ops.gather(self.weight, ids, axis=0)

    return Block, DropBlock, Other, TiedEmbed


_CLASSES = None


def _classes():
    global _CLASSES
    if _CLASSES is None:
        _CLASSES = _layer_classes()
    return _CLASSES


def __getattr__(name):
    names = ("Block", "DropBlock", "Other", "TiedEmbed")
    if name in names:
        return _classes()[names.index(name)]
    raise AttributeError(name)


def head_forward(layer, x):
    """The tied head: logits = x @ E^T."""
    from paddle_tpu_torch import ops

    return ops.matmul(x, layer.weight, transpose_y=True)


def build_pipe(spec: dict, n_stages: int, stage_id: int, v: int = 1):
    """A port PipelineLayer of ``spec["model"]``: "block" (Linear, L
    Blocks, Linear), "drop" (DropBlocks), "other" (a LayerDesc(Other)
    before the Blocks, ``seg_method="layer:Block"``), "tied" (a tied
    embedding and head around the Blocks) or "llama" (the Llama Pipe of
    ``spec["config"]``)."""
    _paddle()
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.fleet.pipeline_parallel import (
        LayerDesc, PipelineLayer, SharedLayerDesc)

    Block, DropBlock, Other, TiedEmbed = _classes()
    kind = spec["model"]
    d, n = spec.get("d", 8), spec.get("layers", 4)
    kw = dict(num_stages=n_stages, stage_id=stage_id,
              num_virtual_pipeline_stages=v)
    if kind == "llama":
        from paddle_tpu_torch.models.llama import (LlamaConfig,
                                                   LlamaForCausalLMPipe)

        kw.pop("num_stages")
        return LlamaForCausalLMPipe(LlamaConfig(**spec["config"]),
                                    n_stages, device="cpu", **kw)
    if kind == "block":
        layers = [nn.Linear(d, d)] + [LayerDesc(Block, d)
                                      for _ in range(n)] + [nn.Linear(d, d)]
        return PipelineLayer(layers=layers, loss_fn=nn.MSELoss(), **kw)
    if kind == "drop":
        layers = [nn.Linear(d, d)] + [LayerDesc(DropBlock, d, spec["p"])
                                      for _ in range(n)] + [nn.Linear(d, d)]
        return PipelineLayer(layers=layers, loss_fn=nn.MSELoss(), **kw)
    if kind == "other":
        layers = [LayerDesc(Other, d)] + [LayerDesc(Block, d)
                                          for _ in range(n)] + \
            [nn.Linear(d, d)]
        return PipelineLayer(layers=layers, loss_fn=nn.MSELoss(),
                             seg_method="layer:Block", **kw)
    if kind == "tied":
        vocab = spec["vocab"]
        layers = [SharedLayerDesc("embed", TiedEmbed, None, "weight",
                                  vocab, d)] + \
            [LayerDesc(Block, d) for _ in range(n)] + \
            [SharedLayerDesc("embed", TiedEmbed, head_forward, "weight",
                             vocab, d)]
        return PipelineLayer(layers=layers, loss_fn=nn.CrossEntropyLoss(),
                             **kw)
    raise ValueError(kind)


def _loss_fn(case, pipe):
    from paddle_tpu_torch import nn

    return {"mse": nn.MSELoss, "ce": nn.CrossEntropyLoss}[
        case["loss"]]() if case.get("loss") in ("mse", "ce") \
        else pipe.get_loss_fn()


def _optimizer(case, params):
    from paddle_tpu_torch import optimizer as opt
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm

    kw = dict(case.get("opt_kw", {}))
    if case.get("clip") is not None:
        kw["grad_clip"] = ClipGradByGlobalNorm(case["clip"])
    cls = {"adamw": opt.AdamW, "adam": opt.Adam, "sgd": opt.SGD}[
        case.get("opt", "adamw")]
    return cls(parameters=params, **kw)


def _load(pipe, case):
    """The JAX pipeline's initial weights (this stage's share)."""
    state = case["state"]
    if case["spec"]["model"] == "llama":
        from paddle_tpu_torch.models.convert import llama_pipe_state_from_jax

        mine = llama_pipe_state_from_jax(state, pipe._owned)
    else:
        own = set(pipe.state_dict())
        mine = {k: v for k, v in state.items() if k in own}
    missing, _ = pipe.set_state_dict(mine)
    if missing:
        raise KeyError(f"no JAX weights for {missing}")


def _tensor(p) -> torch.Tensor:
    return p if isinstance(p, torch.Tensor) else p._data


def _run_case(rank: int, case: dict) -> dict:
    paddle = _paddle()
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.distributed import ProcessMesh
    from paddle_tpu_torch.distributed.fleet.pp_engine import (
        PipelineTrainStep)

    paddle.seed(case.get("seed", 0))
    shape, dims = case["mesh"], case["dims"]
    mesh = ProcessMesh(np.arange(int(np.prod(shape))).reshape(shape), dims)
    S = mesh.dim_size("pp")
    stage = mesh.coord(rank)[dims.index("pp")] if "pp" in dims else 0
    V = case.get("V", 2) if case.get("schedule") == "interleave" else 1
    pipe = build_pipe(case["spec"], S, stage, V)
    out: dict = {"stage": stage, "owned": list(pipe._owned),
                 "body_range": list(pipe._body_range),
                 "sections": [len(pipe.pre_layers), len(pipe.body_layers),
                              len(pipe.post_layers)]}
    if case.get("state") is not None:
        _load(pipe, case)
    if case.get("eval_model"):
        pipe.eval()
    params = pipe.parameters()
    optim = None if case.get("predict_only") else _optimizer(case, params)
    scaler = GradScaler(**case["scaler"]) if case.get("scaler") else None
    step = PipelineTrainStep(
        pipe, _loss_fn(case, pipe), optim, mesh,
        n_microbatches=case.get("M"), remat_body=case.get("remat", True),
        scaler=scaler, shard_pre_post=case.get("shard_pre_post", True),
        schedule=case.get("schedule", "1f1b"),
        interleave_degree=case.get("V", 2),
        skip_nonfinite=case.get("skip_nonfinite", False))
    out.update(bubble_fraction=step.bubble_fraction,
               n_chunks=step.n_chunks, layer_perm=step._layer_perm)
    if case.get("predict_before") is not None:
        out["predict_before"] = _np(step.predict(
            torch.from_numpy(case["predict_before"])))
    out["losses"] = []
    batches = [(torch.from_numpy(np.asarray(x)),
                torch.from_numpy(np.asarray(y)))
               for x, y in case.get("batches", [])]
    if case.get("placed"):
        # mesh-placed prefetch: each leaf lands as this rank's block of
        # the batch over dp, the step's share as it is
        from paddle_tpu_torch.distributed import Replicate, Shard
        from paddle_tpu_torch.io.prefetch import prefetch_to_device

        batches = prefetch_to_device(
            batches, depth=1, mesh=mesh, device="cpu",
            placements=[Shard(0) if d == "dp" else Replicate()
                        for d in dims])
        out["placed_rows"] = []
    for x, y in batches:
        if case.get("placed"):
            out["placed_rows"].append(x._data.to_local().shape[0])
        out["losses"].append(float(step(x, y)))
    if case.get("predict_after") is not None:
        out["predict_after"] = _np(step.predict(
            torch.from_numpy(case["predict_after"])))
    if case.get("eval_batch") is not None:
        from paddle_tpu_torch.distributed.fleet.pipeline_parallel import (
            PipelineParallel)

        class _Hcg:
            def __init__(self, mesh, n):
                self.mesh, self._n = mesh, n

            def get_pipe_parallel_world_size(self):
                return self._n

        pp = PipelineParallel(pipe, _Hcg(mesh, S))
        pp._step = step
        x, y = case["eval_batch"]
        out["eval_loss"] = float(_np(pp.eval_batch(
            (torch.from_numpy(x), torch.from_numpy(y)))))
        out["eval_out"] = _np(pp.eval_batch((torch.from_numpy(x),
                                             torch.from_numpy(y)),
                                            compute_loss=False))
    step.sync_params_to_model()
    out["shards"] = {n: _tensor(p).detach().clone().numpy()
                     for n, p in pipe.named_parameters()}
    out["layouts"] = {n: lay.to_meta() for n, lay in step.layouts().items()}
    if optim is not None:
        out["slot_shapes"] = {
            n: {k: tuple(v.shape) for k, v in optim._slots[id(t)].items()}
            for n, t in zip(step._names, step._params)}
        out["slot_bytes"] = step.slot_bytes()
        out["param_bytes"] = step.param_bytes()
    if case.get("skip_nonfinite"):
        out["skipped_steps"] = step.skipped_steps
    return out


def _np(t):
    t = t._data if hasattr(t, "_data") and not isinstance(
        t, torch.Tensor) else t
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().numpy()


def pipeline_cases(rank: int, world: int, cases: List[dict]) -> dict:
    """Each case on the ranks of its mesh: ``{name: result}``; a failed
    case gives its traceback under ``"error"`` and ends the run on this
    rank (the other ranks then fail in their next exchange)."""
    torch.set_num_threads(1)
    results: Dict[str, dict] = {}
    for case in cases:
        if rank >= int(np.prod(case["mesh"])):
            continue
        t0 = time.perf_counter()
        try:
            results[case["name"]] = _run_case(rank, case)
        except Exception:
            results[case["name"]] = {"error": traceback.format_exc()}
            break
        results[case["name"]]["seconds"] = time.perf_counter() - t0
    return results


def rotations(rank: int, world: int, x) -> dict:
    """The three pipeline forwards with identity stages over a pp mesh of
    the world: each must give back its input on every rank."""
    _paddle()
    from paddle_tpu_torch.distributed.fleet.pipeline_parallel import (
        pipeline_forward, pipeline_forward_interleaved,
        pipeline_forward_vpp)
    from paddle_tpu_torch.distributed.mesh import ProcessMesh, set_mesh

    set_mesh(ProcessMesh(np.arange(world), ["pp"]))
    t = torch.from_numpy(np.asarray(x))
    try:
        return {
            "forward": pipeline_forward(lambda p, h: h + 0.0, None, t,
                                        world).numpy(),
            "vpp": pipeline_forward_vpp(lambda p, c, h: h + 0.0, None, t,
                                        world, 2).numpy(),
            "interleaved": pipeline_forward_interleaved(
                lambda p, c, h: h + 0.0, None, t, world, 2).numpy(),
            # a stage that adds its rank: the ring's order shows
            "order": pipeline_forward(
                lambda p, h: h * 10.0 + (rank + 1), None, t[:, :1, :1],
                world).numpy()}
    finally:
        set_mesh(None)


def several(rank: int, world: int, jobs) -> list:
    """Run each ``(body name, args)`` of ``jobs`` in turn in this world
    (one spawn for a test file's bodies)."""
    return [globals()[name](rank, world, *args) for name, args in jobs]


def fleet_pipeline(rank: int, world: int, case: dict) -> dict:
    """``case`` (a pp-4 block case) through the fleet facade: fleet.init
    at pp_degree 4 with accumulate_steps 4, the PipelineLayer taking its
    stage from the hybrid group, ``fleet.distributed_model`` returning a
    PipelineParallel, ``eval_batch`` (before any step), ``train_batch``
    for each batch, then ``eval_batch`` again."""
    paddle = _paddle()
    from paddle_tpu_torch.distributed import fleet

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs["pp_degree"] = world
    strategy.pipeline_configs["accumulate_steps"] = case["M"]
    fleet.init(is_collective=True, strategy=strategy)
    paddle.seed(case.get("seed", 0))
    pipe = build_pipe(case["spec"], world, None)
    _load(pipe, case)
    model = fleet.distributed_model(pipe)
    x, y = case["batches"][0]
    first = model.eval_batch((torch.from_numpy(x), torch.from_numpy(y)))
    optim = _optimizer(case, pipe.parameters())
    losses = [float(model.train_batch(
        (torch.from_numpy(np.asarray(x)), torch.from_numpy(np.asarray(y))),
        optim)) for x, y in case["batches"]]
    ev = model.eval_batch((torch.from_numpy(x), torch.from_numpy(y)))
    return {"type": type(model).__name__, "stage": pipe.stage_id,
            "losses": losses, "eval_loss": float(_np(ev)),
            "eval_before": float(_np(first))}


# the card tests' pp 2 pairs: a small Llama Pipe (head_dim 64: the
# flash kernels' tensor-core route)
CARD_PAIR = dict(config=dict(vocab_size=512, hidden_size=256,
                             intermediate_size=512, num_hidden_layers=4,
                             num_attention_heads=4, num_key_value_heads=4,
                             max_position_embeddings=128),
                 batch=(4, 128))
CARD_LR = 1e-3
# a 16-bit pair's bound: the share of a parameter's master-weight
# elements more than lr / 2 from the one-rank run's. AdamW's first steps
# move an element by about lr whatever its gradient's size, so a small
# gradient whose sign the two runs' summation orders flip puts it up to
# 2 lr a step apart; a parameter left without an update, or the last
# step skipped, puts most of its elements lr or more apart.
HALF_LR_SHARE = 0.01


def pair_faults(r: dict) -> list:
    """What a 16-bit :func:`card_pair` rank result breaks: its losses
    more than 0.02 nats from the one-rank run's, the first step's
    gradients not the f32 chunk sum, or a parameter with
    :data:`HALF_LR_SHARE` or more of its master weight beyond lr / 2."""
    out = []
    worst = max(abs(a - b) for a, b in zip(r["losses"], r["ref_losses"]))
    if worst > 0.02:
        out.append(("losses", worst))
    if r["n_chunks"] < 2 or not r["chunk_sums_exact"]:
        out.append(("chunk sums", r["n_chunks"], r["chunk_sums_exact"]))
    for name, p in r["params"].items():
        if p["beyond_half_lr"] >= HALF_LR_SHARE * p["elements"]:
            out.append((name, p))
    return out


def card_pair(rank: int, world: int, spec: dict, dtype: str,
              tied: bool = False, steps: int = 2,
              device: str = "cuda") -> dict:
    """A pp ``world`` Llama Pipe on the card (every rank on cuda:0, gloo
    through the host) beside the one-rank ``TrainStep`` of the same
    seed-0 ``LlamaForCausalLM`` (each rank runs it), AdamW at
    :data:`CARD_LR`, two chunks of ``world`` microbatches a step: both
    runs' losses, and this stage's parameters against the one-rank
    model's slices (largest |diff|, elements beyond 1e-5 and beyond
    lr / 2). A 16-bit run keeps f32 master weights on both sides
    (``multi_precision``) and compares those; it also reports whether
    the first step's gradients, as the update sees them, are the f32
    sum of the chunks' gradients over the chunk count, bit for bit. With
    ``tied``: the tied table each rank gathers after the steps (rank 0's
    embedding and the last rank's head read it). ``device="cpu"``
    rehearses it."""
    from dataclasses import replace

    from paddle_tpu_torch.distributed import ProcessMesh
    from paddle_tpu_torch.distributed import communication as comm
    from paddle_tpu_torch.distributed.fleet.pp_engine import (
        PipelineTrainStep)
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.convert import (
        llama_pipe_state_from_causal_lm)
    from paddle_tpu_torch.models.llama import (LlamaConfig,
                                               LlamaForCausalLM,
                                               LlamaForCausalLMPipe)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.tools.gpt_1b_pipe_train import _pipe_to_model_name

    dev = torch.device(device, 0) if device == "cuda" else \
        torch.device(device)
    if device == "cpu":
        _paddle()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = replace(LlamaConfig(**spec["config"]), dtype=dtype,
                  tie_word_embeddings=tied)
    wide = dtype != "float32"
    rng = np.random.RandomState(0)
    b, s = spec["batch"]
    x = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s))).to(dev)
    y = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s))).to(dev)

    def model():
        m = LlamaForCausalLM(cfg, device=dev)
        return m.init_weights(torch.Generator(device=dev).manual_seed(0))

    def adamw(params):
        return AdamW(learning_rate=CARD_LR, parameters=params,
                     multi_precision=wide)

    ref = model()
    init = {n: t.detach().clone() for n, t in ref.state_dict().items()}
    ref_opt = adamw(ref.parameters())
    step = TrainStep(ref, ref.criterion(cfg), ref_opt)
    ref_losses = [float(step(x, y)) for _ in range(steps)]
    mesh = ProcessMesh(np.arange(world), ["pp"])
    pipe = LlamaForCausalLMPipe(cfg, world, device=dev, stage_id=rank)
    pipe.set_state_dict(llama_pipe_state_from_causal_lm(init, pipe._owned))
    opt = adamw(pipe.parameters())
    pstep = PipelineTrainStep(pipe, pipe.get_loss_fn(), opt, mesh,
                              n_microbatches=2 * world)
    # the first step: each chunk's gradients, and those the update sees
    chunks, seen = [], []
    grads_of, sync = pstep._grads_of, pstep._sync

    def _grads_of(swapped):
        g = grads_of(swapped)
        chunks.append([None if t is None else t.clone() for t in g])
        return g

    def _sync(grads, loss):
        seen.extend(t.clone() for t in grads)
        return sync(grads, loss)

    pstep._grads_of, pstep._sync = _grads_of, _sync
    losses = [float(pstep(x, y))]
    pstep._grads_of, pstep._sync = grads_of, sync
    losses += [float(pstep(x, y)) for _ in range(steps - 1)]
    exact = True
    for i, got in enumerate(seen):
        parts = [c[i] for c in chunks if c[i] is not None]
        want = None
        for g in parts:
            g = g.float() if g.dtype in (torch.bfloat16, torch.float16) \
                else g
            want = g if want is None else want + g
        # no chunk reached it on this stage: zeros
        want = torch.zeros_like(got) if want is None else want / len(chunks)
        exact = exact and got.dtype == want.dtype and torch.equal(got, want)
    layouts = pstep.layouts()
    params = {}
    named = dict(ref.named_parameters())
    mine = dict(zip(pstep._names, pstep._params))
    for name, p in pipe.named_parameters():
        want = named[_pipe_to_model_name(name)]
        if wide:
            p = opt._slots[id(mine[name])]["master_weight"]
            want = ref_opt._slots[id(want)]["master_weight"]
        want = want.detach()[layouts[name].shard_slices(tuple(want.shape),
                                                        rank)]
        diff = (p.detach().float() - want.float()).abs()
        params[name] = {"max_abs_err": float(diff.max()),
                        "beyond_1e-5": int((diff > 1e-5).sum()),
                        "beyond_half_lr": int((diff > CARD_LR / 2).sum()),
                        "elements": diff.numel()}
    out = {"losses": losses, "ref_losses": ref_losses, "params": params,
           "n_chunks": pstep.n_chunks, "chunk_sums_exact": bool(exact),
           "compared": "master_weight" if wide else "parameter"}
    if tied:
        w = pipe.pre_layers["0"].weight
        assert pipe.post_layers["0"].weight is w
        d = pstep._pp_dim[id(w)]
        out["tied_table"] = comm.all_gather_cat(
            w.detach().contiguous(), d, pstep._pp_group).float().cpu().numpy()
    return out


def card_pairs(device: str = "cuda") -> dict:
    """The card tests' three pp 2 pairs (f32, bf16, tied f32) of
    :data:`CARD_PAIR`, both ranks on the first card (gloo through the
    host): ``{(dtype, tied): [rank 0's result, rank 1's]}``."""
    from paddle_tpu_torch.testing import gloo_ranks, tp_hooks

    out = {}
    with tp_hooks.ranks_share_one_device():
        for dtype, tied in (("float32", False), ("bfloat16", False),
                            ("float32", True)):
            out[(dtype, tied)] = gloo_ranks.run(
                card_pair, 2, CARD_PAIR, dtype, tied, 2, device,
                timeout_s=300)
    return out


if __name__ == "__main__":
    # the pairs' readings, one JSON line a pair and rank:
    #   python -m paddle_tpu_torch.testing.pipeline_ranks
    import json
    import sys

    from paddle_tpu_torch.testing import pipeline_ranks as _pr

    for (dtype, tied), ranks in _pr.card_pairs(*sys.argv[1:2]).items():
        for rank, r in enumerate(ranks):
            r.pop("tied_table", None)
            print(json.dumps({"dtype": dtype, "tied": tied, "rank": rank,
                              "faults": [str(f) for f in _pr.pair_faults(r)]
                              if dtype != "float32" else None, **r}))
