"""The port's ``LlamaForCausalLMPipe`` against the JAX package's, through
``PipelineTrainStep`` at pp 4, pp 2 x mp 2, dp 2 x pp 2 and tied at pp
2 (the port's ranks in one gloo world of 4; losses rtol 1e-4 on every
rank, parameters rtol 2e-3 / atol 2e-5, assembled from the ranks'
stages, pp slices and mp shards), and ``models.convert``'s Pipe
conversions.

The JAX package's Pipe does not run its pipelined step at pp >= 2 on
this jax (inside the pp ``shard_map`` its attention's sharding
constraint names an UNCONSTRAINED spec over a Manual axis and jax
raises a ValueError), so the JAX side here is the same Pipe, the same
weights and batches through the JAX ``PipelineTrainStep`` at pp 1: the
global view the port's stages must add up to."""
import numpy as np
import pytest
import torch

import _pipeline_jax as pj


def _llama(name, mesh, dims, M, seed=42, **cfg):
    return dict(name=name, spec=dict(model="llama",
                                     config=dict(pj.LLAMA, **cfg)),
                M=M, opt="adamw", opt_kw=dict(learning_rate=1e-3),
                seed=seed, mesh=mesh, dims=dims, jax_mesh=([1], ["pp"]),
                batches=pj.llama_batches())


def _cases():
    return [
        _llama("pp4", [4], ["pp"], 4),
        _llama("pp2_mp2", [2, 2], ["pp", "mp"], 4),
        _llama("dp2_pp2", [2, 2], ["dp", "pp"], 2),
        _llama("tied_pp2", [2], ["pp"], 2, tie_word_embeddings=True),
    ]


@pytest.fixture(scope="module")
def runs():
    return pj.parity_runs(_cases())


@pytest.mark.parametrize("name", ["pp4", "pp2_mp2", "dp2_pp2",
                                  "tied_pp2"])
def test_matches_the_jax_pipe(runs, name):
    cases, refs, results = runs
    pj.check_case(results, cases[name], refs[name])


def test_each_rank_holds_its_stage_and_slices(runs):
    """pp 4: one decoder layer a rank, and 1/4 of the embedding and the
    head (and of their slots) along the JAX package's first pp-divisible
    dim (the embedding's vocab, the head's hidden: its JAX [h, vocab]
    dim 0); pp 2 x mp 2: two layers a rank cut over mp, the embedding
    cut over mp (vocab) and pp (hidden)."""
    cases, refs, results = runs
    st = cases["pp4"]["state"]
    vocab, h = st["pre_layers.0.weight"].shape
    for r in range(4):
        res = results[r]["pp4"]
        assert res["owned"] == [r]
        assert res["shards"]["pre_layers.0.weight"].shape == (vocab // 4, h)
        assert res["shards"]["post_layers.0.lm_head.weight"].shape == \
            (vocab, h // 4)
        assert res["slot_shapes"]["pre_layers.0.weight"]["moment1"] == \
            (vocab // 4, h)
        res = results[r]["pp2_mp2"]
        assert res["owned"] == [2 * res["stage"], 2 * res["stage"] + 1]
        assert res["shards"]["pre_layers.0.weight"].shape == \
            (vocab // 2, h // 2)


def test_tied_pipe_has_one_table(runs):
    """The tied Pipe's head reads the embedding's table: one parameter,
    one set of slots, no head weight of its own."""
    cases, refs, results = runs
    for r in range(2):
        res = results[r]["tied_pp2"]
        assert not any("lm_head" in n or n.startswith("post_layers.0.weight")
                       for n in res["shards"])
        assert "pre_layers.0.weight" in res["slot_shapes"]


def test_bf16_pipe_pair_holds_master_weights_and_chunk_sums():
    """pp 2 of the bf16 Llama Pipe, two chunks a step, AdamW with f32
    master weights, against the one-rank TrainStep: the first step's
    gradients are the f32 sum of the chunks' over 2, bit for bit, and
    each parameter's master weight has under 1% of its elements more
    than lr / 2 from the one-rank run's (a step left out moves 45-72%
    of them that far, a norm left without its gradient 85-88%)."""
    from paddle_tpu_torch.testing import gloo_ranks, pipeline_ranks

    # the card's bf16 pp 2 pair (tests/test_torch_card.py), rehearsed here
    res = gloo_ranks.run(pipeline_ranks.card_pair, 2,
                         pipeline_ranks.CARD_PAIR, "bfloat16", False, 2,
                         "cpu", timeout_s=300)
    for r in res:
        assert r["n_chunks"] == 2 and r["compared"] == "master_weight"
        assert pipeline_ranks.pair_faults(r) == []


def test_convert_names_the_stage_parameters():
    """``llama_pipe_state_from_jax`` gives exactly a stage's state dict
    (the JAX Pipe's names, torch's [out, in] Linear weights), and
    ``llama_pipe_state_from_causal_lm`` turns a port LlamaForCausalLM's
    state into the Pipe's: at one stage the Pipe's logits are the
    model's."""
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import LlamaConfig as JCfg
    from paddle_tpu.models.llama import LlamaForCausalLMPipe as JPipe
    from paddle_tpu_torch.models.convert import (
        llama_pipe_state_from_causal_lm, llama_pipe_state_from_jax)
    from paddle_tpu_torch.models.llama import (LlamaConfig,
                                               LlamaForCausalLM,
                                               LlamaForCausalLMPipe)

    paddle.seed(0)
    jstate = {k: np.asarray(v.numpy()) for k, v in
              JPipe(JCfg(**pj.LLAMA), 2).state_dict().items()}
    for r in range(2):
        pipe = LlamaForCausalLMPipe(LlamaConfig(**pj.LLAMA), 2,
                                    device="cpu", stage_id=r)
        mine = llama_pipe_state_from_jax(jstate, pipe._owned)
        own = pipe.state_dict()
        assert set(mine) == set(own)
        for k, v in mine.items():
            assert tuple(v.shape) == tuple(own[k].shape), k
        np.testing.assert_array_equal(
            mine["body_layers.%d.self_attn.q_proj.weight" % (2 * r)].numpy(),
            jstate["body_layers.%d.self_attn.q_proj.weight" % (2 * r)].T)

    cfg = LlamaConfig(**pj.LLAMA)
    torch.manual_seed(0)
    model = LlamaForCausalLM(cfg, device="cpu")
    pipe = LlamaForCausalLMPipe(cfg, 1, device="cpu")
    missing, unexpected = pipe.set_state_dict(
        llama_pipe_state_from_causal_lm(model.state_dict()))
    assert not missing and not unexpected
    ids = torch.from_numpy(pj.llama_batches(1)[0][0]).long()
    with torch.no_grad():
        np.testing.assert_allclose(pipe(ids).numpy(), model(ids).numpy(),
                                   rtol=1e-5, atol=1e-5)
