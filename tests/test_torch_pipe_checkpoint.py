"""Multi-rank checkpoints of a ``PipelineTrainStep``: the port's
``distributed/checkpoint`` over a pipeline against the JAX package's.

The JAX package's pipeline checkpoint is what its step leaves in the
layers after ``sync_params_to_model()`` (the parameters by name) and its
optimizer's ``state_dict()``, which holds only ``{"step": n}``: the JAX
step keeps its slots in the step, so a resume starts them from zero.
The cross-package cases carry exactly that. The block pipeline of
``tests/_pipeline_jax.py`` runs at dp 2 x pp 2 in both packages (the JAX
step in this process on conftest's virtual CPU devices; the port's
ranks in one gloo world of 4, ``pipeline_ranks.pipe_checkpoints``):

* the port resumes the JAX package's step-2 checkpoint, and the JAX
  package resumes the port's; each runs steps 3-4 within phase 29's
  bounds (losses rtol 1e-4, each parameter within 2.5e-4) of the JAX
  package's own resume;
* the two manifests hold the same chunks (the pre/post slices over pp,
  the body layers whole), each written once, a body layer's by a rank of
  the stage that owns it.

The Llama Pipe at pp 4 saves the port's own state (the slots by
parameter name): it restores at pp 2 x mp 2 and on one rank (a plain
``TrainStep`` over ``LlamaForCausalLM``) bit for bit, and its JAX-keyed
save (the Linear weights as [in, out] views) loads into the JAX Pipe as
the port's tensors transposed. A SIGTERM to one pipeline rank makes
every rank take its final save at one step, and a rebuilt step restores
it."""
import json
import os

import numpy as np
import pytest

import _pipeline_jax as pj
import paddle_tpu as paddle
from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.distributed.fleet.pp_engine import PipelineTrainStep
from paddle_tpu.distributed.mesh import ProcessMesh
from paddle_tpu_torch.distributed.redistribute import Layout

PARAM_MAX_ABS = 2.5e-4   # phase 29's bound on each parameter


def _block():
    return dict(name="ckpt_block", spec=dict(model="block"), M=4,
                opt="adam", opt_kw=dict(learning_rate=0.01), loss="mse",
                seed=7, mesh=[2, 2], dims=["dp", "pp"],
                batches=pj.block_batches(4, seed=7))


def _llama():
    return dict(name="ckpt_llama", spec=dict(model="llama",
                                             config=dict(pj.LLAMA)),
                M=4, opt="adamw", opt_kw=dict(learning_rate=1e-3),
                seed=42, mesh=[4], dims=["pp"],
                batches=pj.llama_batches(2))


def _jax_pipe(case, state=None):
    """The JAX pipeline of ``case`` (``state`` loaded into its layers
    before the step stacks them) and its step over the case's mesh."""
    paddle.seed(case["seed"])
    shape, dims = case["mesh"], case["dims"]
    pipe = pj.jax_pipe(case["spec"], dict(zip(dims, shape)).get("pp", 1))
    opt = pj._optimizer(case, pipe.parameters())
    if state is not None:
        sd = {"model": dict(pipe.named_parameters()), "opt": opt.state_dict()}
        jckpt.load_state_dict(sd, state)
        opt.set_state_dict(sd["opt"])
    mesh = ProcessMesh(np.arange(int(np.prod(shape))).reshape(shape),
                       dim_names=dims)
    step = PipelineTrainStep(pipe, pj._loss(case, pipe), opt, mesh,
                             n_microbatches=case["M"])
    return pipe, opt, step


def _jax_train(step, batches):
    return [float(step(paddle.to_tensor(x), paddle.to_tensor(y)).item())
            for x, y in batches]


def _jax_params(pipe, step):
    step.sync_params_to_model()
    return {n: np.asarray(p.numpy()) for n, p in pipe.named_parameters()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from paddle_tpu_torch.testing import gloo_ranks, pipeline_ranks

    d = tmp_path_factory.mktemp("pipe_ckpt")
    paths = {k: str(d / k) for k in ("jax", "port", "native", "llama_jax",
                                     "managed")}
    block, llama = _block(), _llama()
    pipe, opt, step = _jax_pipe(block)
    block["state"] = {k: np.asarray(v.numpy()).copy()
                      for k, v in pipe.state_dict().items()}
    paddle.seed(llama["seed"])
    jl = pj.jax_pipe(llama["spec"], 1)
    llama["state"] = {k: np.asarray(v.numpy()).copy()
                      for k, v in jl.state_dict().items()}
    first = _jax_train(step, block["batches"][:2])
    step.sync_params_to_model()
    jckpt.save_state_dict({"model": dict(pipe.named_parameters()),
                           "opt": opt.state_dict()}, paths["jax"])
    world = gloo_ranks.start(pipeline_ranks.pipe_checkpoints, 4, block,
                             llama, paths, timeout_s=240)
    # the JAX package's own resume of its checkpoint: the reference
    pipe, opt, step = _jax_pipe(block, paths["jax"])
    ref = {"first": first, "losses": _jax_train(step, block["batches"][2:]),
           "final": _jax_params(pipe, step)}
    return {"block": block, "llama": llama, "ref": ref, "paths": paths,
            "ranks": world.results()}


def _assemble(ranks, key):
    """The global view of each saved leaf from the ranks that hold it
    (each leaf's shards over its layout's mesh ids)."""
    out = {}
    names = set()
    for r in ranks:
        names |= set(r[key])
    for name in names:
        held = {rank: r[key][name] for rank, r in enumerate(ranks)
                if name in r[key]}
        first = next(iter(held.values()))
        lay = Layout.from_meta(first["layout"])
        out[name] = lay.assemble([held[i]["value"] for i in first["ids"]])
    return out


def _close(got, want, what):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4,
                               err_msg=what)
    assert set(got["final"]) == set(want["final"]), what
    for name, w in want["final"].items():
        diff = float(np.abs(got["final"][name] - w).max())
        assert diff <= PARAM_MAX_ABS, (what, name, diff)


def test_port_resumes_the_jax_pipeline_checkpoint(runs):
    ranks = runs["ranks"]
    final = {k[len("model/"):]: v for k, v in
             _assemble(ranks, "resumed").items() if k.startswith("model/")}
    for r in ranks:
        _close({"losses": r["resumed_losses"], "final": final},
               runs["ref"], "port resumes jax")


def test_jax_resumes_the_port_pipeline_checkpoint(runs):
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["first_losses"], runs["ref"]["first"],
                                   rtol=1e-4)
    pipe, opt, step = _jax_pipe(runs["block"], runs["paths"]["port"])
    assert opt._step_count == 2
    got = {"losses": _jax_train(step, runs["block"]["batches"][2:]),
           "final": _jax_params(pipe, step)}
    _close(got, runs["ref"], "jax resumes port")


def _chunks(path):
    with open(os.path.join(path, "metadata.json")) as f:
        tensors = json.load(f)["tensors"]
    return {name: sorted((tuple(c["global_offset"]), tuple(c["local_shape"]))
                         for c in tm["chunks"])
            for name, tm in tensors.items()}, tensors


def test_manifests_hold_the_same_chunks_each_written_once(runs):
    jax_chunks, _ = _chunks(runs["paths"]["jax"])
    port_chunks, tensors = _chunks(runs["paths"]["port"])
    assert port_chunks == jax_chunks
    # the pre and post Linears sliced over pp: two chunks; a body layer
    # whole: one
    assert len(port_chunks["model/pre_layers.0.weight"]) == 2
    assert len(port_chunks["model/body_layers.1.fc1.weight"]) == 1
    written = {}
    for name, tm in tensors.items():
        offs = [tuple(c["global_offset"]) for c in tm["chunks"]]
        assert len(offs) == len(set(offs)), name
        for c in tm["chunks"]:
            written.setdefault(c["file"], set()).add(c["key"])
    for fname, keys in written.items():
        with np.load(os.path.join(runs["paths"]["port"], fname)) as z:
            assert set(z.files) == keys, fname
    # stage 0 (ranks 0 and 2 at dp 2 x pp 2) holds body layers 0-1, stage
    # 1 (ranks 1 and 3) layers 2-3: the lowest rank of the stage writes
    for layer, f in ((0, "data_0.npz"), (1, "data_0.npz"),
                     (2, "data_1.npz"), (3, "data_1.npz")):
        chunks = tensors[f"model/body_layers.{layer}.fc1.weight"]["chunks"]
        assert [c["file"] for c in chunks] == [f], layer


def test_pp4_save_restores_at_pp2_and_on_one_rank_bit_for_bit(runs):
    import torch

    from paddle_tpu_torch.distributed import checkpoint as tckpt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.convert import (
        llama_pipe_state_from_causal_lm)
    from paddle_tpu_torch.models.llama import (LlamaConfig,
                                               LlamaForCausalLM,
                                               LlamaPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW

    ranks = runs["ranks"]
    saved = _assemble(ranks, "saved")
    pp2 = _assemble(ranks, "pp2")
    assert sorted(saved) == sorted(pp2)
    assert any(k.startswith("opt/") and k.endswith(".moment2")
               for k in saved)
    for name, want in saved.items():
        assert np.array_equal(pp2[name], want), name
    assert all(r["pp2_step"] == 2 for r in ranks)
    # one rank: a LlamaForCausalLM whose tensors take the Pipe's names
    llama = runs["llama"]
    cfg = LlamaConfig(**llama["spec"]["config"])
    model = LlamaForCausalLM(cfg, device="cpu")
    opt = AdamW(parameters=model.parameters(), **llama["opt_kw"])
    TrainStep(model, LlamaPretrainingCriterion(None), opt)
    named = llama_pipe_state_from_causal_lm(dict(model.named_parameters()))
    state = {"model": {n: p.detach() for n, p in named.items()},
             "opt": {"step": 0}}
    for n, p in named.items():
        for k, v in opt._slots[id(p)].items():
            state["opt"][f"{n}.{k}"] = v
    tckpt.load_state_dict(state, runs["paths"]["native"])
    assert state["opt"]["step"] == 2
    for sec in ("model", "opt"):
        for n, t in state[sec].items():
            if isinstance(t, torch.Tensor):
                assert np.array_equal(t.numpy(), saved[f"{sec}/{n}"]), n
    # the JAX-keyed save: the JAX Pipe loads the port's tensors, Linear
    # weights transposed
    paddle.seed(llama["seed"])
    jpipe = pj.jax_pipe(llama["spec"], 1)
    jstate = {"model": dict(jpipe.named_parameters()), "opt": {"step": 0}}
    jckpt.load_state_dict(jstate, runs["paths"]["llama_jax"])
    for n, p in jpipe.named_parameters():
        want = saved[f"model/{n}"]
        if n.endswith("_proj.weight") or n.endswith("lm_head.weight"):
            want = want.T
        assert np.array_equal(np.asarray(p.numpy()), want), n
    assert int(jstate["opt"]["step"]) == 2


def test_a_sigterm_to_one_pipeline_rank_gives_one_final_save(runs):
    got = [r["preempt"] for r in runs["ranks"]]
    at = got[0]["at"]
    assert at is not None and at >= 2
    for g in got:
        assert g["at"] == at and g["restored"] == at and g["equal"], g
        assert g["committed"][-1] == at
