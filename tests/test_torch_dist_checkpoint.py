"""Multi-rank checkpoints (slice D4): the port's
``distributed/checkpoint`` at world 4 against the JAX package's
multi-host format.

The JAX ``ParallelTrainStep`` (the tiny Llama of ``_hybrid_jax``, dp 2 x
mp 2, ZeRO 1) runs in this process on conftest's virtual CPU devices:
four steps unbroken, saving at step 2. The port's ranks run in one gloo
world of 4 processes (``paddle_tpu_torch.testing.gang_ranks``):

* they restore the JAX package's step-2 checkpoint and run steps 3-4:
  losses and parameters within phase 28's bounds of the JAX run's
  unbroken steps 3-4 (losses rtol 1e-4, each parameter within 2.5e-4);
* they train steps 1-2 and save; the JAX package restores that and runs
  steps 3-4, within the same bounds;
* the two packages' manifests hold the same chunks (offsets and shapes)
  for the same layout, each chunk written once;
* the port's save at dp 2 x mp 2 restores at dp 4 and on one rank, bit
  for bit;
* a save of copies of the mp shards (no layout, so taken as replicated)
  fails on every rank, since the ranks' digests of them differ;
* ``CheckpointManager`` at world 4: the agreed restore step is rank 0's,
  a SIGTERM to one rank makes every rank take its final save at one
  step, and a save whose part fails on rank 2 (``ckpt.data_written:
  raise``) commits nothing and every rank restores the step before, and
  a leaf that only one rank holds, with no layout, fails the save on
  every rank.

The Llama's Linear weights are [in, out] in the JAX package and
[out, in] in the port: the port saves and loads the JAX package's keys
through transposed views of its tensors, which carry their layouts
transposed (``gang_ranks.jax_view``)."""
import json
import os

import numpy as np
import pytest

import _hybrid_jax as hj
import paddle_tpu as paddle
from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.distributed.engine import ParallelConfig, ParallelTrainStep
from paddle_tpu.distributed.mesh import ProcessMesh
from paddle_tpu_torch.distributed.redistribute import Layout
from paddle_tpu_torch.models.convert import _torch_layout

PARAM_MAX_ABS = 2.5e-4   # phase 28's bound on each parameter


def _case():
    case = hj.llama_case("ckpt", [2, 2], ["dp", "mp"])
    case["batches"] = hj.llama_batches(n=4)
    return case


def _jax_step(case):
    paddle.seed(case["seed"])
    m = hj.jax_model("llama", case["spec"])
    opt = hj._optimizer(case, m.parameters())
    mesh = ProcessMesh(np.arange(4).reshape(2, 2), dim_names=["dp", "mp"])
    step = ParallelTrainStep(m, hj._loss("llama"), opt, mesh,
                             ParallelConfig(sharding_stage=1))
    return m, opt, step


def _jax_train(step, batches):
    return [float(step(paddle.to_tensor(x), paddle.to_tensor(y)).item())
            for x, y in batches]


def _jax_params(m):
    return {n: _torch_layout(n, np.asarray(p.numpy()))
            for n, p in m.named_parameters()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from paddle_tpu_torch.testing import gang_ranks, gloo_ranks

    d = tmp_path_factory.mktemp("ckpt")
    paths = {k: str(d / k) for k in ("jax", "port", "native")}
    case = _case()
    m, opt, step = _jax_step(case)
    case["state"] = {k: np.asarray(v.numpy()).copy()
                     for k, v in m.state_dict().items()}
    names = [n for n, _ in m.named_parameters()]
    losses = _jax_train(step, case["batches"][:2])
    jckpt.save_state_dict({"model": dict(m.named_parameters()),
                           "opt": opt.state_dict()}, paths["jax"])
    world = gloo_ranks.start(gang_ranks.checkpoints, 4, case, paths["jax"],
                             paths["port"], paths["native"], names,
                             timeout_s=240)
    losses += _jax_train(step, case["batches"][2:])
    ref = {"losses": losses, "final": _jax_params(m)}
    return {"case": case, "ref": ref, "ranks": world.results(),
            "paths": paths, "names": names}


def _assemble(ranks, key, lay_key):
    out = {}
    for name, meta in ranks[0][lay_key].items():
        lay = Layout.from_meta(meta)
        out[name] = lay.assemble([r[key][name] for r in ranks])
    return out


def _close(got, want, what):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4,
                               err_msg=what)
    for name, w in want["final"].items():
        diff = float(np.abs(got["final"][name] - w).max())
        assert diff <= PARAM_MAX_ABS, (what, name, diff)


def test_port_resumes_the_jax_checkpoint(runs):
    ranks = runs["ranks"]
    for r in ranks:
        got = {"losses": r["resumed_losses"],
               "final": _assemble(ranks, "resumed", "layouts")}
        _close(got, {"losses": runs["ref"]["losses"][2:],
                     "final": runs["ref"]["final"]}, "port resumes jax")


def test_jax_resumes_the_port_checkpoint(runs):
    case = runs["case"]
    np.testing.assert_allclose(runs["ranks"][0]["first_losses"],
                               runs["ref"]["losses"][:2], rtol=1e-4)
    m, opt, step = _jax_step(case)
    state = {"model": dict(m.named_parameters()), "opt": opt.state_dict()}
    jckpt.load_state_dict(state, runs["paths"]["port"])
    opt.set_state_dict(state["opt"])
    assert opt._step_count == 2
    # the step trains on the restored moments, not on fresh zeros
    assert all(float(np.abs(np.asarray(s["moment1"])).max()) > 0
               for s in step._slots)
    got = {"losses": _jax_train(step, case["batches"][2:]),
           "final": _jax_params(m)}
    _close(got, {"losses": runs["ref"]["losses"][2:],
                 "final": runs["ref"]["final"]}, "jax resumes port")


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
    # the moments of a ZeRO-1 Llama: sharded over mp and sliced over dp
    assert len(port_chunks["opt/param_0.moment1"]) == 4
    written = {}
    for name, tm in tensors.items():
        offs = [tuple(c["global_offset"]) for c in tm["chunks"]]
        assert len(offs) == len(set(offs)), name
        for c in tm["chunks"]:
            written.setdefault(c["file"], set()).add(c["key"])
    for fname, keys in written.items():
        with np.load(os.path.join(runs["paths"]["port"], fname)) as z:
            assert set(z.files) == keys, fname
    # every rank wrote its file; the replicated norms only rank 0's
    assert sorted(written) == [f"data_{r}.npz" for r in range(4)]
    norm = tensors["model/llama.norm.weight"]["chunks"]
    assert [c["file"] for c in norm] == ["data_0.npz"]


def test_port_save_restores_at_dp4_and_on_one_rank_bit_for_bit(runs):
    import torch

    from paddle_tpu_torch.distributed import checkpoint as tckpt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.convert import llama_state_from_jax
    from paddle_tpu_torch.models.llama import (LlamaConfig,
                                               LlamaForCausalLM,
                                               LlamaPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW

    ranks = runs["ranks"]
    saved = _assemble(ranks, "saved", "saved_layouts")
    dp4 = _assemble(ranks, "dp4", "dp4_layouts")
    assert sorted(saved) == sorted(dp4)
    for name, want in saved.items():
        assert np.array_equal(dp4[name], want), name
    assert all(r["dp4_step"] == 2 for r in ranks)
    # one rank: the whole tensors
    case = runs["case"]
    model = LlamaForCausalLM(LlamaConfig(**case["spec"]), device="cpu")
    model.load_state_dict(llama_state_from_jax(case["state"]))
    opt = AdamW(parameters=model.parameters(), **case["opt_kw"])
    TrainStep(model, LlamaPretrainingCriterion(None), opt)
    state = {"model": model.state_dict(), "opt": opt.state_dict()}
    tckpt.load_state_dict(state, runs["paths"]["native"])
    names = [n for n, _ in model.named_parameters()]
    assert state["opt"]["step"] == 2
    for name, t in state["model"].items():
        if name in saved:
            assert np.array_equal(t.numpy(), saved[name]), name
    for key, t in state["opt"].items():
        if not isinstance(t, torch.Tensor):
            continue
        pos, _, slot = key.rpartition(".")
        name = names[int(pos.split("_")[1])]
        assert np.array_equal(t.numpy(), saved[f"{name}.{slot}"]), key


def test_copied_shards_fail_the_save_everywhere(runs):
    ranks = runs["ranks"]
    assert "ValueError" in ranks[0]["copied"], ranks[0]["copied"]
    assert "different values" in ranks[0]["copied"]
    assert "[[0, 2], [1, 3]]" in ranks[0]["copied"], ranks[0]["copied"]
    assert "model/llama.embed_tokens.weight" in ranks[0]["copied"], \
        ranks[0]["copied"]
    assert all(r["copied"] is not None for r in ranks)
    assert not os.path.exists(runs["paths"]["native"] + "_copied")


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    from paddle_tpu_torch.testing import gang_ranks, gloo_ranks

    root = str(tmp_path_factory.mktemp("manager"))
    old = os.environ.get("PADDLE_ABORT_POLL")
    os.environ["PADDLE_ABORT_POLL"] = "0.1"
    try:
        return gloo_ranks.run(gang_ranks.manager_gang, 4, root,
                              timeout_s=120), root
    finally:
        if old is None:
            os.environ.pop("PADDLE_ABORT_POLL")
        else:
            os.environ["PADDLE_ABORT_POLL"] = old


def test_the_agreed_restore_step_is_rank0s(gang):
    ranks, _ = gang
    for r in ranks:
        assert (r["agreed"]["step"], r["agreed"]["w"], r["agreed"]["n"]) \
            == (2, 2.0, 2)
    assert ranks[2]["agreed"]["own_latest"] == 1


def test_sigterm_to_one_rank_saves_one_final_step_everywhere(gang):
    ranks, root = gang
    at = {r["preempt"]["at"] for r in ranks}
    assert len(at) == 1 and None not in at, at
    step = at.pop()
    assert step >= 3
    final = os.path.join(root, "preempt", f"step_{step}")
    with open(os.path.join(final, "COMMITTED")) as f:
        marker = json.load(f)
    assert (marker["step"], marker["world"]) == (step, 4)
    leftovers = [n for n in os.listdir(os.path.join(root, "preempt"))
                 if n.endswith((".tmp", ".old"))]
    assert not leftovers and ranks[0]["preempt"]["committed"][-1] == step


def test_a_failed_part_commits_nothing_and_every_rank_restores_before(gang):
    ranks, root = gang
    for r in ranks:
        f = r["fault"]
        assert f["error"] is not None
        assert 3 not in f["committed"]
        assert (f["restored"], f["w"]) == (2, 2.0)
    assert "rank 2" in ranks[0]["fault"]["error"]
    assert not os.path.exists(os.path.join(root, "fault", "step_3"))


def test_a_leaf_no_rank_writes_fails_the_save_everywhere(gang):
    ranks, root = gang
    assert "ValueError" in ranks[0]["lost"] and "only_rank1" in \
        ranks[0]["lost"]
    assert all(r["lost"] is not None for r in ranks)
    assert not os.path.exists(os.path.join(root, "lost"))

