"""Context parallelism: the port's ``ParallelTrainStep`` over a Llama with
``context_parallel=True`` against the JAX package's step at the same mesh.

The JAX step runs in this process on conftest's virtual CPU devices (its
ring attention inside ``shard_map``, everything else on the global view
under GSPMD); the port's ranks run in one gloo world of 4 processes
(``paddle_tpu_torch.testing.hybrid_ranks``), the model sequence-sharded
through the whole stack: each rank embeds, projects and takes the loss
for its S/P tokens and attends over the ring. Both start from the JAX
model's weights and take the same global batches (4 x 32); the port's
parameters are assembled from the ranks' shards. Bounds as in
``test_torch_parallel_train.py``: losses rtol 1e-4 on every rank,
parameters rtol 2e-3 / atol 2e-5.

The tiny Llama of ``tests/_hybrid_jax.py`` (2 layers, hidden 64, 4 heads,
2 kv heads: GQA chunks travel the ring) at dp 2 x sp 2 (ZeRO 0, 1 and 3
with recompute), at sp 4 with ``cp_batch_axis=None``, and a cross entropy
over labels not ignored whose ignored labels fall unevenly over the
chunks (each rank's loss weighted by its share of the count).

In the same world:

* the context-parallel ``LlamaForCausalLMPipe`` at pp 2 x sp 2
  (``pipeline_ranks``: each microbatch's sequence cut over sp, rope at
  the chunk's global positions, the body's attention over the ring)
  against the JAX Pipe's ``PipelineTrainStep`` at pp 1 x sp 2 (the JAX
  Pipe fails its step at pp >= 2 on this jax), within the pipeline tests'
  bounds (``tests/_pipeline_jax.py``);
* a masked call of the bound model at dp 2 x sp 2 (``cp_ranks.
  masked_calls``): every rank passes the global mask, takes its query
  rows and attends densely over the all-gathered K and V, not causal, as
  the reference does whenever a mask is given; its logits and the
  gradients summed over the ranks against the JAX model's forward and
  backward on the global view with the same mask (logits rtol 1e-4 /
  atol 1e-5; gradients, sums over ranks in another order, rtol 1e-4 /
  atol 1e-6 of each one's largest entry)."""
import numpy as np
import pytest

import _hybrid_jax as hj
import _pipeline_jax as pj

DPSP = ([2, 2], ["dp", "sp"])
CP = dict(context_parallel=True)


def _ignore_batches():
    """Labels -100 in 3, 11, 5 and 6 positions of the four sequence
    chunks of 8 (sp 4); of the chunks of 16 at dp 2 x sp 2, 14, 3, 0 and
    8."""
    out = []
    for x, y in hj.llama_batches():
        y = y.astype(np.int64)
        for r, cols in enumerate(([1, 4, 6], list(range(8, 19)), [16, 17],
                                  list(range(26, 32)))):
            y[r % 4, cols] = -100
        y[0, 9:12] = -100
        out.append((x.astype(np.int64), y))
    return out


def _pipe_cases():
    """The context-parallel Pipe at pp 2 x sp 2; the JAX Pipe at pp 1 x
    sp 2 (``cp_batch_axis=None``: neither mesh has a
    dp axis)."""
    base = dict(spec=dict(model="llama", config=dict(
        pj.LLAMA, context_parallel=True, cp_batch_axis=None)), M=4,
        opt="adamw", opt_kw=dict(learning_rate=1e-3), seed=42,
        mesh=[2, 2], dims=["pp", "sp"], jax_mesh=([1, 2], ["pp", "sp"]))
    ignored = []
    for x, y in pj.llama_batches():
        y = y.astype(np.int64)
        # chunks of 8 keep 8, 5, 7, 2 ... of their labels
        y[0, 8:11] = -100
        y[1, 0:1] = -100
        y[2, 10:16] = -100
        y[3, 2:4] = -100
        ignored.append((x.astype(np.int64), y))
    return [dict(base, name="cp_pp2_sp2", batches=pj.llama_batches()),
            # one chunk of all four microbatches ("gpipe") on both sides:
            # a chunk's loss is a mean over its labels not ignored, so the
            # chunking must match where the counts differ
            dict(base, name="cp_pp2_sp2_ce_ignore", loss="ce",
                 schedule="gpipe", batches=ignored)]


def _masked_cases():
    base = dict(spec=dict(hj.LLAMA, **CP), mesh=[2, 2], dims=["dp", "sp"],
                batch=(4, 32), lens=[32, 27, 20, 13], seed=3)
    return [dict(base, name="masked_bool"),
            dict(base, name="masked_float", float_mask=True, seed=4)]


def _cases():
    return [
        hj.llama_case("cp_dp2_sp2", *DPSP, spec=CP),
        hj.llama_case("cp_dp2_sp2_z1", *DPSP, spec=CP,
                      config=dict(sharding_stage=1)),
        hj.llama_case("cp_dp2_sp2_z3_remat", *DPSP, spec=CP,
                      config=dict(sharding_stage=3, remat=True)),
        hj.llama_case("cp_sp4", [4], ["sp"],
                      spec=dict(CP, cp_batch_axis=None)),
        dict(hj.llama_case("cp_ce_ignore", *DPSP, spec=CP), loss="ce",
             batches=_ignore_batches()),
        dict(hj.llama_case("cp_sp4_ce_ignore", [4], ["sp"],
                           spec=dict(CP, cp_batch_axis=None)),
             loss="ce", batches=_ignore_batches()),
    ]


def _jax_masked(case):
    """The JAX model's logits and the gradients of ``sum(logits * w)``
    on the global view, the Linear weights' in the port's [out, in]."""
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.convert import _torch_layout
    from paddle_tpu_torch.testing.cp_ranks import masked_inputs

    paddle.seed(case["seed"])
    m = LlamaForCausalLM(LlamaConfig(**case["spec"]))
    case["state"] = {k: np.asarray(v.numpy()).copy()
                     for k, v in m.state_dict().items()}

    def run():
        ids, mask, t, u = masked_inputs(case)
        logits = m(paddle.to_tensor(ids), attn_mask=paddle.to_tensor(mask))
        w = paddle.to_tensor(t[:, :, None] * u[None, None, :])
        (logits * w).sum().backward()
        dense = LlamaForCausalLM(LlamaConfig(**dict(
            case["spec"], context_parallel=False)))
        dense.set_state_dict(m.state_dict())
        causal = dense(paddle.to_tensor(ids))
        return {"logits": np.asarray(logits.numpy()),
                "causal_logits": np.asarray(causal.numpy()),
                "grads": {n: _torch_layout(n, np.asarray(p.grad.numpy()))
                          for n, p in m.named_parameters()}}

    return run


@pytest.fixture(scope="module")
def world_runs():
    """Every case of this file in one world of 4 gloo ranks."""
    from paddle_tpu_torch.testing import cp_ranks, gloo_ranks

    train, pipes, masked = _cases(), _pipe_cases(), _masked_cases()
    finish = [hj.prepare(c) for c in train]
    pipe_finish = [pj.prepare(c) for c in pipes]
    masked_finish = [_jax_masked(c) for c in masked]
    world = gloo_ranks.start(cp_ranks.cp_world, 4, train, pipes, masked,
                             timeout_s=300)
    refs = {c["name"]: f() for c, f in
            zip(train + pipes + masked,
                finish + pipe_finish + masked_finish)}
    cases = {c["name"]: c for c in train + pipes + masked}
    return cases, refs, world.results()


@pytest.fixture(scope="module")
def runs(world_runs):
    return world_runs


@pytest.mark.parametrize("name", [
    "cp_dp2_sp2", "cp_dp2_sp2_z1", "cp_dp2_sp2_z3_remat", "cp_sp4",
    "cp_ce_ignore", "cp_sp4_ce_ignore"])
def test_matches_the_jax_parallel_step(runs, name):
    cases, refs, results = runs
    hj.check_case(results, cases[name], refs[name])


def test_the_ignored_labels_fall_unevenly_over_the_chunks():
    """The ignore case's chunks hold different counts of labels, so the
    ranks' plain mean of their masked means is not the batch's loss."""
    _, y = _ignore_batches()[0]
    counts = [(y[:, 8 * r:8 * r + 8] != -100).sum() for r in range(4)]
    assert len(set(counts)) == 4, counts


def test_config_builds_with_the_cp_fields():
    """The reference's two fields: ``LlamaConfig(context_parallel=True,
    cp_axis=..., cp_batch_axis=...)`` builds (it had raised TypeError)."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.tiny(context_parallel=True, cp_axis="cp",
                           cp_batch_axis=None)
    m = LlamaForCausalLM(cfg, device="cpu")
    assert (m.config.cp_axis, m.config.cp_batch_axis) == ("cp", None)
    assert LlamaConfig().cp_axis == "sp" and \
        LlamaConfig().cp_batch_axis == "dp"


def test_a_mesh_without_the_batch_axis_raises_as_the_reference():
    """``["sp"]`` of 4 with the default ``cp_batch_axis="dp"``: the JAX
    step raises ValueError (its ring's ``shard_map`` names 'dp'), and the
    port's step raises ValueError naming the axis, at construction."""
    import paddle_tpu as jpaddle
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.distributed.engine import ParallelTrainStep as JStep
    from paddle_tpu.distributed.mesh import ProcessMesh as JMesh
    from paddle_tpu.models.llama import (LlamaConfig as JConfig,
                                         LlamaForCausalLM as JModel,
                                         LlamaPretrainingCriterion as JCrit)
    from paddle_tpu_torch.distributed import ParallelTrainStep, ProcessMesh
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    x, y = hj.llama_batches(n=1)[0]
    jpaddle.seed(0)
    jm = JModel(JConfig(**hj.LLAMA, **CP))
    step = JStep(jm, JCrit(), jopt.AdamW(learning_rate=1e-3,
                                         parameters=jm.parameters()),
                 JMesh(np.arange(4), dim_names=["sp"]))
    with pytest.raises(ValueError):
        step(jpaddle.to_tensor(x), jpaddle.to_tensor(y))

    m = LlamaForCausalLM(LlamaConfig(**hj.LLAMA, **CP), device="cpu")
    with pytest.raises(ValueError, match="cp_batch_axis 'dp'"):
        ParallelTrainStep(m, m.criterion(), AdamW(parameters=m.parameters()),
                          ProcessMesh(np.arange(4), ["sp"]))


def test_unbound_context_parallel_model_raises():
    """Outside a context-parallel mesh the model has no ring to run: its
    forward raises (the reference's ring raises without a mesh)."""
    import torch

    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    m = LlamaForCausalLM(LlamaConfig(**hj.LLAMA, **CP), device="cpu")
    with pytest.raises(RuntimeError, match="sequence-sharded"):
        m(torch.zeros((1, 8), dtype=torch.long))


@pytest.mark.parametrize("name", ["cp_pp2_sp2", "cp_pp2_sp2_ce_ignore"])
def test_the_context_parallel_pipe_matches_the_jax_pipe(runs, name):
    cases, refs, results = runs
    pj.check_case(results, cases[name], refs[name])


def test_the_pipe_ranks_hold_their_stage_on_both_sp_ranks(runs):
    """pp 2 x sp 2: ranks 0 and 1 (sp 0 and 1) hold stage 0's two
    layers, ranks 2 and 3 stage 1's; the sp ranks of a stage hold the
    same layers whole."""
    cases, refs, results = runs
    for r in range(4):
        res = results[r]["cp_pp2_sp2"]
        assert res["stage"] == r // 2
        assert res["owned"] == [2 * (r // 2), 2 * (r // 2) + 1]


@pytest.mark.parametrize("name", ["masked_bool", "masked_float"])
def test_a_masked_call_of_a_bound_model_matches_the_jax_model(runs, name):
    """The reference's masked branch on the ranks: dense over the whole
    sequence with the mask, not causal; the chunks and the gradients
    summed over the ranks give the JAX model's global forward and
    backward."""
    cases, refs, results = runs
    ref = refs[name]
    b, s = cases[name]["batch"]
    for r in range(4):
        got = results[r][name]
        rows = slice(got["dp"] * b // 2, (got["dp"] + 1) * b // 2)
        cols = slice(got["cp"] * s // 2, (got["cp"] + 1) * s // 2)
        np.testing.assert_allclose(got["logits"], ref["logits"][rows, cols],
                                   rtol=1e-4, atol=1e-5, err_msg=str(r))
    grads = results[0][name]["grads"]
    assert set(grads) == set(ref["grads"])
    for n, want in ref["grads"].items():
        np.testing.assert_allclose(grads[n], want, rtol=1e-4,
                                   atol=1e-6 * float(np.abs(want).max()),
                                   err_msg=n)


def test_the_mask_changes_the_answer(runs):
    """The mask is not causal and cuts a different number of keys in each
    row, so the masked logits are far from the causal ones on the same
    ids: a mask dropped on the way to the ring would fail the parity
    above."""
    cases, refs, results = runs
    ref = refs["masked_bool"]
    assert len(set(cases["masked_bool"]["lens"])) == 4
    assert float(np.abs(ref["logits"] - ref["causal_logits"]).max()) > 1e-2
