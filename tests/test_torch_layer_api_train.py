"""The slice at small size: ``tools/layer_api_train.build(paddle, cfg)``
(the Llama written with the layer API) run by the same code on both
packages, on the CPU, in f32.

* From one seed both packages build the same model: the same keys,
  shapes and dtypes, the ``XavierUniform`` projections bit-identical.
* From shared weights (``models/convert.layer_state_from_jax``: the
  reference's ``state_dict`` and generator state) and dropout 0.1, three
  AdamW steps draw the same dropout masks bit for bit and give losses
  within rtol 1e-5.
* ``paddle.save`` / ``paddle.load`` resumes the next step bit-identically.
* By design (ROADMAP queue 3): the port's ``LlamaForCausalLM`` stays a
  ``torch.nn.Module``; loaded with the same weights, it and the layer
  model give the same loss.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.core import place as port_place
from paddle_tpu_torch.models.convert import layer_state_from_jax
from paddle_tpu_torch.tools import layer_api_train as L

CFG = L.LayerLlamaConfig(vocab_size=97, hidden_size=64, intermediate_size=96,
                         num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=2, max_position_embeddings=16,
                         dropout=0.1)


@pytest.fixture(autouse=True)
def _cpu_place():
    prev = (port_place._current_place, port_place._current_device)
    tpaddle.set_device("cpu")
    yield
    port_place._current_place, port_place._current_device = prev


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, CFG.vocab_size, (2, 16)),
            rng.randint(0, CFG.vocab_size, (2, 16)))


def test_one_seed_builds_the_same_model():
    jpaddle.seed(5)
    ref = L.build(jpaddle, CFG).state_dict()
    tpaddle.seed(5)
    got = L.build(tpaddle, CFG).state_dict()
    assert [(k, v.shape, v.dtype.name) for k, v in got.items()] == \
        [(k, v.shape, v.dtype.name) for k, v in ref.items()]
    for k, v in ref.items():
        a, b = np.asarray(v.numpy()), got[k].numpy()
        if "embed_tokens" in k:    # Normal: the same uniforms, XLA's erf_inv
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(b, a, k)
    assert tpaddle.get_rng_state() == jpaddle.get_rng_state()


def test_three_adamw_steps_with_dropout_match_the_reference():
    jpaddle.seed(5)
    ref_model = L.build(jpaddle, CFG)
    jpaddle.seed(11)
    state, rng = layer_state_from_jax(
        {k: np.asarray(v.numpy()) for k, v in ref_model.state_dict().items()},
        jpaddle.get_rng_state())
    tpaddle.seed(99)                     # whatever the port's own state
    model = L.build(tpaddle, CFG)
    missing, unexpected = model.set_state_dict(state)
    assert not missing and not unexpected
    tpaddle.set_rng_state(rng)
    ids, labels = _batch()
    ref_masks = L.masks_of(jpaddle, ref_model)
    masks = L.masks_of(tpaddle, model)
    want = L.train(jpaddle, ref_model, jpaddle.to_tensor(ids),
                   jpaddle.to_tensor(labels), 3)["losses"]
    got = L.train(tpaddle, model, tpaddle.to_tensor(ids),
                  tpaddle.to_tensor(labels), 3)["losses"]
    assert len(masks) == len(ref_masks) == 3 * (2 * CFG.num_hidden_layers
                                                + 1)
    for a, b in zip(ref_masks, masks):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert tpaddle.get_rng_state() == jpaddle.get_rng_state() == (11, 15)
    for k, v in ref_model.state_dict().items():
        np.testing.assert_allclose(model.state_dict()[k].numpy(),
                                   np.asarray(v.numpy()), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_eval_draws_no_key_and_returns_the_input():
    tpaddle.seed(1)
    model = L.build(tpaddle, CFG)
    model.eval()
    ids, _ = _batch(1)
    before = tpaddle.get_rng_state()
    a = model(tpaddle.to_tensor(ids)).numpy()
    assert tpaddle.get_rng_state() == before
    b = model(tpaddle.to_tensor(ids)).numpy()
    np.testing.assert_array_equal(a, b)


def test_save_load_resumes_bit_identically(tmp_path):
    tpaddle.seed(2)
    model = L.build(tpaddle, CFG)
    ids, labels = _batch(2)
    tids, tlabels = tpaddle.to_tensor(ids), tpaddle.to_tensor(labels)
    run = L.train(tpaddle, model, tids, tlabels, 2)
    res = L.save_load_resume(tpaddle, model, CFG, tids, tlabels, run["opt"],
                             path=str(tmp_path / "m.pdparams"))
    assert res["bit_identical"] and not res["missing"], res
    assert res["bytes"] > 0 and not (tmp_path / "m.pdparams").exists()


def test_a_reference_checkpoint_trains_on_in_the_port(tmp_path):
    """The reference saves its trained layer model; the port loads the
    file into its own and computes the reference's next loss (the same
    generator state, dropout on)."""
    jpaddle.seed(3)
    ref_model = L.build(jpaddle, CFG)
    ids, labels = _batch(3)
    L.train(jpaddle, ref_model, jpaddle.to_tensor(ids),
            jpaddle.to_tensor(labels), 2)
    path = str(tmp_path / "ref.pdparams")
    jpaddle.save(ref_model.state_dict(), path)
    tpaddle.seed(0)
    model = L.build(tpaddle, CFG)
    model.set_state_dict(tpaddle.load(path))
    tpaddle.set_rng_state(jpaddle.get_rng_state())
    got = float(model(tpaddle.to_tensor(ids), tpaddle.to_tensor(labels)))
    want = float(ref_model(jpaddle.to_tensor(ids),
                           jpaddle.to_tensor(labels)).numpy())
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_the_llama_module_and_the_layer_model_give_the_same_loss():
    """By design the port's ``LlamaForCausalLM`` stays a
    ``torch.nn.Module`` (serving, ``TrainStep`` and the CUDA graphs rest
    on it): the same weights in it and in the layer model give the same
    loss and gradients on the CPU (f32, dropout 0)."""
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.tools import tensor_api_train as T

    mcfg = LlamaConfig(vocab_size=97, hidden_size=64, intermediate_size=96,
                       num_hidden_layers=2, num_attention_heads=4,
                       num_key_value_heads=2, max_position_embeddings=16,
                       dtype="float32")
    module = T.build(mcfg, "cpu", seed=4)
    assert isinstance(module, torch.nn.Module)
    model = L.build(tpaddle, L.from_llama_config(mcfg))
    model.set_state_dict(L.layer_state_from_module(module))
    ids, labels = (torch.from_numpy(a) for a in _batch(4))
    c = L.compare_step0(module, model, ids, labels)
    np.testing.assert_allclose(c["loss_layer_api"], c["loss_module"],
                               rtol=1e-6)
    assert c["grad_rel_l2_max"] < 1e-5, c
