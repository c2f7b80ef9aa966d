"""The port's BERT family (``paddle_tpu_torch/models/bert.py``) against
the JAX package's, at 2 layers, hidden 32, 4 heads, intermediate 64,
vocab 128, 64 positions.

The reference models are built once per module; their weights and the
generator's state cross with ``models.convert.bert_state_from_jax``.
Forwards in f32 at rtol 1e-5 / atol 1e-6; three AdamW ``TrainStep``
steps with dropout 0.1 on at the TrainStep parity tolerance of
``tests/test_torch_trainstep_layer.py`` (rtol 1e-5, atol 1e-6), losses
and every parameter (the masked-LM model's pooler gets no gradient and
is only decayed, in both); a bf16 forward under ``auto_cast`` at
``tests/test_torch_amp.py``'s bf16 tolerance (rtol 2e-2). The tied
decoder is one parameter in both packages and its gradient sums both
uses. ``FusedTransformerEncoderLayer``, pre- and post-norm, forward and
gradients.
"""
import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.core import place as _place
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models.convert import bert_state_from_jax

TOL = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)
# the masked-LM logits are dot products with the N(0, 1) word embedding,
# of std ~5.7 here: atol 1e-6 is below an f32 32-term dot's rounding at
# that scale (6.8e-6 seen), so they are held at rtol 1e-5 / atol 1e-5
LOGITS_TOL = dict(rtol=1e-5, atol=1e-5)
B, S = 4, 16


@pytest.fixture(autouse=True, scope="module")
def _cpu_place():
    saved = (_place._current_place, _place._current_device)
    tpaddle.set_device("cpu")
    yield
    _place._current_place, _place._current_device = saved


def _cfg(P, dropout=0.1):
    mod = jbert if P is jpaddle else tbert
    return mod.BertConfig(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                          num_attention_heads=4, intermediate_size=64,
                          max_position_embeddings=64,
                          hidden_dropout_prob=dropout,
                          attention_probs_dropout_prob=dropout)


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _np_state(model):
    return {k: np.asarray(v._data) for k, v in model.state_dict().items()}


def _ids(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 128, (B, S)).astype("int64")
    ids[0, 11:] = 0                       # padding in one row
    types = (np.arange(S)[None] >= S // 2).astype("int64").repeat(B, 0)
    return ids, types


def _pair(name, seed=0, dropout=0.1):
    """The JAX model ``name`` from ``seed`` and the port's twin, loaded
    through ``bert_state_from_jax`` with the generator's state."""
    jpaddle.seed(seed)
    jm = getattr(jbert, name)(_cfg(jpaddle, dropout))
    tpaddle.seed(seed + 1)    # another draw: the weights must come across
    tm = getattr(tbert, name)(_cfg(tpaddle, dropout))
    _, rng = bert_state_from_jax(_np_state(jm), jpaddle.get_rng_state(), tm)
    tpaddle.set_rng_state(rng)
    return jm, tm


@pytest.fixture(scope="module")
def models():
    out = {name: _pair(name) for name in
           ("BertForMaskedLM", "BertForSequenceClassification")}
    jc, tc = out["BertForSequenceClassification"]
    out["BertModel"] = (jc.bert, tc.bert)
    return out


def test_bert_model_outputs_and_padding_mask(models):
    jm, tm = models["BertModel"]
    ids, types = _ids()
    mask = (ids != 0).astype("int64")
    for m in (jm, tm):
        m.eval()
    for kw in ({}, {"token_type_ids": types, "attention_mask": mask}):
        js, jp = jm(jpaddle.to_tensor(ids),
                    **{k: jpaddle.to_tensor(v) for k, v in kw.items()})
        ts, tp = tm(tpaddle.to_tensor(ids),
                    **{k: tpaddle.to_tensor(v) for k, v in kw.items()})
        assert ts.shape == [B, S, 32] and tp.shape == [B, 32]
        np.testing.assert_allclose(_np(ts), _np(js), **TOL)
        np.testing.assert_allclose(_np(tp), _np(jp), **TOL)
    # a padded position's id does not reach the real ones
    ids2 = ids.copy()
    ids2[0, 11:] = 99
    a, _ = tm(tpaddle.to_tensor(ids), attention_mask=tpaddle.to_tensor(mask))
    b, _ = tm(tpaddle.to_tensor(ids2), attention_mask=tpaddle.to_tensor(mask))
    np.testing.assert_allclose(_np(a)[0, :11], _np(b)[0, :11], **TOL)


@pytest.mark.parametrize("name", ["BertForMaskedLM",
                                  "BertForSequenceClassification"])
def test_heads_forward_match_the_reference(models, name):
    jm, tm = models[name]
    ids, types = _ids(1)
    for m in (jm, tm):
        m.eval()
    jo = jm(jpaddle.to_tensor(ids), jpaddle.to_tensor(types))
    to = tm(tpaddle.to_tensor(ids), tpaddle.to_tensor(types))
    assert to.shape == list(jo.shape)
    np.testing.assert_allclose(_np(to), _np(jo), **(
        LOGITS_TOL if name == "BertForMaskedLM" else TOL))


def test_sequence_longer_than_positions_raises(models):
    _, tm = models["BertModel"]
    with pytest.raises(ValueError):
        tm(tpaddle.to_tensor(np.ones((1, 65), "int64")))


def test_converter_checks_keys_and_the_tie(models):
    jm, _ = models["BertForMaskedLM"]
    state = _np_state(jm)
    rng = jpaddle.get_rng_state()
    tm = tbert.BertForMaskedLM(_cfg(tpaddle))
    extra = dict(state, **{"extra.weight": np.zeros(3, "float32")})
    with pytest.raises(KeyError):
        bert_state_from_jax(extra, rng, tm)
    missing = dict(state)
    missing.pop("decoder_bias")
    with pytest.raises(KeyError):
        bert_state_from_jax(missing, rng, tm)
    # without a model: the state as layer_state_from_jax gives it
    st, r = bert_state_from_jax(state, rng)
    assert set(st) == set(state) and r == tuple(int(x) for x in rng)
    bert_state_from_jax(state, rng, tm)
    emb = tm.bert.embeddings.word_embeddings.weight
    assert tm.decoder_weight is emb
    np.testing.assert_array_equal(_np(emb), state[
        "bert.embeddings.word_embeddings.weight"])


def test_tied_decoder_is_one_parameter_and_sums_both_gradients(models):
    """One vocab x hidden parameter in both packages; its gradient equals
    the sum of an untied twin's embedding and decoder gradients (the
    update this sum drives is held against the reference by the
    TrainStep test below)."""
    jm, tm = models["BertForMaskedLM"]
    v, h = 128, 32
    for m in (jm, tm):
        big = [p for p in m.parameters() if tuple(p.shape) == (v, h)]
        assert len(big) == 1
        assert sum(1 for k in m.state_dict()
                   if k.endswith("word_embeddings.weight")) == 1

    class Untied(tbert.BertForMaskedLM):
        def __init__(self, cfg):
            super().__init__(cfg)
            self.dec = self.create_parameter([v, h])

        @property
        def decoder_weight(self):
            return self.dec

    un = Untied(_cfg(tpaddle))
    state = dict(tm.state_dict())
    un.set_state_dict(dict(state, dec=state[
        "bert.embeddings.word_embeddings.weight"]))
    ids, types = _ids(2)
    grads = []
    for m in (tm, un):
        m.eval()
        m.clear_gradients()
        out = m(tpaddle.to_tensor(ids), tpaddle.to_tensor(types))
        (out * out).mean().backward()
        grads.append(_np(m.bert.embeddings.word_embeddings.weight.grad))
    g_dec = _np(un.dec.grad)
    assert np.abs(g_dec).max() > 0 and np.abs(grads[1]).max() > 0
    np.testing.assert_allclose(grads[0], grads[1] + g_dec, rtol=1e-5,
                               atol=1e-8)
    tm.clear_gradients()


def _same_params(jm, tm, lr, steps):
    """Every parameter at TOL, but the key projections' biases: their
    gradient is zero in exact arithmetic (a key bias adds one constant to
    each query's scores, which the softmax removes), so each package's
    is rounding noise, which Adam's normalised update turns into a step
    of up to ``lr`` either way. Those are held to the most ``steps``
    AdamW steps can move them, in both packages alike."""
    for (name, a), b in zip(jm.named_parameters(), tm.parameters()):
        if name.endswith("self_attn.k_proj.bias"):
            assert np.abs(_np(b) - _np(a)).max() <= 2 * steps * lr * 1.01, \
                name
            continue
        np.testing.assert_allclose(_np(b), _np(a), err_msg=name, **TOL)


def _mlm_batch(seed=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 128, (B, S)).astype("int64")
    labels = np.full((B, S), -100, "int64")
    pick = rng.random((B, S)) < 0.15
    pick[:, 1] = True
    labels[pick] = rng.integers(1, 128, int(pick.sum()))
    return ids, labels


def test_bf16_forward_under_auto_cast(models):
    """The f32 additive mask meets bf16 scores under O1: both packages
    promote to f32 before the f32 softmax, and agree at bf16's
    tolerance."""
    jm, tm = models["BertForSequenceClassification"]
    ids, types = _ids(5)
    mask = (ids != 0).astype("int64")
    jm.eval()
    tm.eval()
    with jpaddle.amp.auto_cast(level="O1"):
        js, jp = jm.bert(jpaddle.to_tensor(ids), jpaddle.to_tensor(types),
                         jpaddle.to_tensor(mask))
    with tpaddle.amp.auto_cast(level="O1"):
        ts, tp = tm.bert(tpaddle.to_tensor(ids), tpaddle.to_tensor(types),
                         tpaddle.to_tensor(mask))
    # the encoder's last op is a black-listed layer norm: f32 in both
    assert str(js.dtype).endswith("float32") and ts.dtype == tpaddle.float32
    np.testing.assert_allclose(_np(ts).astype("float32"),
                               _np(js).astype("float32"), **BF16)
    np.testing.assert_allclose(_np(tp).astype("float32"),
                               _np(jp).astype("float32"), **BF16)
    assert np.isfinite(_np(ts).astype("float32")).all()


def test_sdpa_under_auto_cast_promotes_the_f32_mask_as_jnp_does():
    """Under O1 ``scaled_dot_product_attention`` (white-listed in both
    packages, as ``matmul`` is) casts q/k/v to bf16; the f32 additive
    mask of ``finfo(float32).min`` is added to the bf16 scores, which
    promotes them to f32 in both, then the softmax runs in f32 and the
    output is bf16 (bf16's tolerance)."""
    from paddle_tpu import amp as jamp
    from paddle_tpu_torch import amp as tamp

    for name in ("matmul", "scaled_dot_product_attention"):
        assert (name in jamp.WHITE_LIST) == (name in tamp.WHITE_LIST) \
            is True
    rng = np.random.default_rng(9)
    q, k, v = (rng.normal(size=(2, 6, 2, 8)).astype("float32")
               for _ in range(3))
    keep = np.ones((2, 6), "float32")
    keep[1, 4:] = 0
    mask = ((1.0 - keep) * np.finfo(np.float32).min).reshape(2, 1, 1, 6)
    outs = []
    for P in (jpaddle, tpaddle):
        with P.amp.auto_cast(level="O1"):
            outs.append(P.nn.functional.scaled_dot_product_attention(
                *(P.to_tensor(a) for a in (q, k, v)),
                attn_mask=P.to_tensor(mask), training=False))
    j, t = outs
    assert str(j.dtype).endswith("bfloat16") and t.dtype == tpaddle.bfloat16
    jo, to = _np(j).astype("float32"), _np(t).astype("float32")
    assert np.isfinite(to).all()
    np.testing.assert_allclose(to, jo, **BF16)


def _jax_grads(layer, x, mask):
    """The JAX layer's output and the gradients of sum(out**2) with
    respect to x and each named parameter, through ``jax.grad`` over
    the functionalized layer (no dropout)."""
    import jax

    from paddle_tpu.jit import functionalize

    apply, (names, params), (_, bufs) = functionalize(layer)

    def loss(pd, xd):
        out, _ = apply(pd, [b._data for b in bufs], jax.random.key(0), xd,
                       mask)
        return (out * out).sum(), out

    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))([p._data for p in params], x)
    return (np.asarray(out), np.asarray(gx),
            {n: np.asarray(g) for n, g in zip(names, gp)})


@pytest.mark.parametrize("pre", [True, False], ids=["pre_norm", "post_norm"])
def test_fused_transformer_encoder_layer_forward_and_grads(pre):
    from paddle_tpu.incubate.nn import FusedTransformerEncoderLayer as JL
    from paddle_tpu_torch.incubate.nn import FusedTransformerEncoderLayer as TL
    from paddle_tpu_torch.models.convert import layer_state_from_jax

    jpaddle.seed(11)
    jl = JL(16, 2, 32, dropout_rate=0.0, normalize_before=pre)
    tl = TL(16, 2, 32, dropout_rate=0.0, normalize_before=pre)
    state, _ = layer_state_from_jax(_np_state(jl), jpaddle.get_rng_state())
    tl.set_state_dict(state)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 5, 16)).astype("float32")
    mask = np.zeros((2, 1, 1, 5), "float32")
    mask[0, ..., 3:] = -1e9
    jo, jx, jg = _jax_grads(jl, x, mask)
    xt = tpaddle.to_tensor(x, stop_gradient=False)
    out = tl(xt, tpaddle.to_tensor(mask))
    (out * out).sum().backward()
    to, tx = _np(out), _np(xt.grad)
    tg = {n: _np(p.grad) for n, p in tl.named_parameters()}
    np.testing.assert_allclose(to, jo, **TOL)
    np.testing.assert_allclose(tx, jx, rtol=1e-4, atol=1e-5)
    assert set(tg) == set(jg)
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], rtol=1e-4, atol=1e-5,
                                   err_msg=n)


def test_mlm_trainstep_three_adamw_steps_with_dropout(models):
    """Three AdamW steps through each package's TrainStep, dropout 0.1
    on: losses and every parameter; the pooler (no gradient) is decayed
    alike in both. (Last in the file: it trains the module's models.)"""
    jm, tm = models["BertForMaskedLM"]
    tpaddle.set_rng_state(jpaddle.get_rng_state())
    ids, labels = _mlm_batch()
    pool0 = _np(tm.bert.pooler.weight).copy()
    losses = {}
    for P, m, mod in ((jpaddle, jm, jbert), (tpaddle, tm, tbert)):
        m.train()
        crit = mod.BertPretrainingCriterion(_cfg(P))
        opt = P.optimizer.AdamW(1e-3, parameters=m.parameters(),
                                weight_decay=0.01)
        step = P.jit.TrainStep(m, crit, opt)
        losses[P] = [float(step(P.to_tensor(ids), P.to_tensor(labels)))
                     for _ in range(3)]
    np.testing.assert_allclose(losses[tpaddle], losses[jpaddle], **TOL)
    assert tpaddle.get_rng_state() == tuple(jpaddle.get_rng_state())
    _same_params(jm, tm, lr=1e-3, steps=3)
    pool = _np(tm.bert.pooler.weight)
    np.testing.assert_allclose(pool, pool0 * (1 - 1e-3 * 0.01) ** 3,
                               rtol=1e-6)
