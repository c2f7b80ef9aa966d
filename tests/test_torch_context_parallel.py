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
chunks (each rank's loss weighted by its share of the count)."""
import numpy as np
import pytest

import _hybrid_jax as hj

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


@pytest.fixture(scope="module")
def runs():
    return hj.parity_runs(_cases())


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


def test_a_masked_call_of_a_bound_model_is_refused():
    """Bound to its ring, the model takes no ``attn_mask``: the ring
    attends causally over the whole sequence, so a mask (shaped for the
    chunk or for the whole sequence) raises instead of dropping keys."""
    import torch

    from paddle_tpu_torch.distributed import ProcessMesh
    from paddle_tpu_torch.distributed.engine import shard_model_parameters
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    m = LlamaForCausalLM(LlamaConfig(**hj.LLAMA, **CP, cp_batch_axis=None),
                         device="cpu")
    shard_model_parameters(m, ProcessMesh(np.arange(1), ["sp"]))
    ids = torch.zeros((1, 8), dtype=torch.long)
    assert m(ids).shape[:2] == (1, 8)
    mask = torch.ones((8, 8), dtype=torch.bool).tril()
    with pytest.raises(NotImplementedError, match="attn_mask"):
        m(ids, mask)


def test_the_pipeline_llama_refuses_context_parallel():
    """``LlamaForCausalLMPipe`` with ``context_parallel`` is not ported
    (its step does not cut the sequence over the ring's axis): it raises
    at construction, before a pp x sp mesh could bind its attention to
    the ring."""
    from paddle_tpu_torch.models.llama import (LlamaConfig,
                                               LlamaForCausalLMPipe)

    with pytest.raises(NotImplementedError, match="LlamaForCausalLMPipe"):
        LlamaForCausalLMPipe(LlamaConfig(**hj.LLAMA, **CP), 2, device="cpu")
