"""The recurrent, transformer and decoding layers of the port
(``paddle_tpu_torch/nn/rnn.py``, ``nn/transformer.py``, ``nn/layers_extra.py``
``BiRNN`` / ``BeamSearchDecoder`` / ``dynamic_decode``) against the JAX
package's, with the reference's weights carried across
(``set_state_dict``): outputs, final states, and the gradients of a
seeded cotangent for every parameter and floating input, at rtol 1e-5 /
atol 1e-5 (the fused recurrences of torch and the reference's
``lax.scan`` add in another order within a step). Both packages are
seeded alike before each forward, so dropout draws the same masks."""
import zlib

import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.core import place as port_place

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu_place():
    prev = (port_place._current_place, port_place._current_device)
    tpaddle.set_device("cpu")
    yield
    port_place._current_place, port_place._current_device = prev


def f(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _flat(o)]
    return [] if out is None else [out]


def _run(P, cid, build, make, call, state=None, train=False):
    seed = zlib.crc32(cid.encode())
    P.seed(seed)
    layer = build(P)
    if state is not None:
        layer.set_state_dict(state)
    if not train:
        layer.eval()
    sd = {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}
    arrays = make(np.random.default_rng(seed))
    inputs = [P.to_tensor(a, stop_gradient=a.dtype != np.float32)
              for a in arrays]
    P.seed(seed + 7)
    outs = [o for o in _flat(call(layer, inputs))
            if o.dtype.name == "float32"]
    c = np.random.default_rng(seed + 1)
    loss = None
    for o in outs:
        term = (o * P.to_tensor(c.standard_normal(o.shape).astype(
            np.float32))).sum()
        loss = term if loss is None else loss + term
    loss.backward()
    grads = {k: (None if p.grad is None else np.asarray(p.grad.numpy()))
             for k, p in layer.named_parameters()}
    in_grads = [None if t.stop_gradient or t.grad is None
                else np.asarray(t.grad.numpy()) for t in inputs]
    return sd, [np.asarray(o.numpy()) for o in outs], grads, in_grads


def compare(cid, build, make, call=lambda m, xs: m(*xs), train=False,
            tol=TOL):
    sd, outs_r, g_r, ig_r = _run(jpaddle, cid, build, make, call,
                                 train=train)
    sd_p, outs_p, g_p, ig_p = _run(tpaddle, cid, build, make, call,
                                   state=sd, train=train)
    assert sorted(sd_p) == sorted(sd)
    assert len(outs_p) == len(outs_r), cid
    for a, b in zip(outs_r, outs_p):
        assert a.shape == b.shape, cid
        np.testing.assert_allclose(b, a, err_msg=cid + " out", **tol)
    assert set(g_p) == set(g_r)
    for k in g_r:
        a = np.zeros_like(g_p[k]) if g_r[k] is None else g_r[k]
        b = np.zeros_like(a) if g_p[k] is None else g_p[k]
        np.testing.assert_allclose(b, a, err_msg=f"{cid} {k}", **tol)
    for a, b in zip(ig_r, ig_p):
        if a is not None or b is not None:
            a = np.zeros_like(b) if a is None else a
            b = np.zeros_like(a) if b is None else b
            np.testing.assert_allclose(b, a, err_msg=cid + " input", **tol)


RNN_CASES = [(cls, direction, layers, tm)
             for cls in ("SimpleRNN", "GRU", "LSTM")
             for direction, layers, tm in (("forward", 1, False),
                                           ("bidirect", 2, False),
                                           ("bidirectional", 1, True))]


@pytest.mark.parametrize("cls,direction,layers,time_major", RNN_CASES,
                         ids=[f"{c}-{d}-{n}-{int(t)}"
                              for c, d, n, t in RNN_CASES])
def test_recurrent_layer_matches_reference(cls, direction, layers,
                                           time_major):
    shape = (5, 3, 4) if time_major else (3, 5, 4)
    compare(f"{cls}{direction}{layers}{time_major}",
            lambda P: getattr(P.nn, cls)(4, 6, num_layers=layers,
                                         direction=direction,
                                         time_major=time_major),
            lambda r: [f(r, *shape)])


@pytest.mark.parametrize("cls", ["SimpleRNN", "GRU", "LSTM"])
def test_recurrent_layer_with_initial_states(cls):
    ndir, L = 2, 2

    def make(r):
        h = [f(r, 3, 4, 5), f(r, L * ndir, 3, 6)]
        if cls == "LSTM":
            h.append(f(r, L * ndir, 3, 6))
        return h

    def call(m, xs):
        st = (xs[1], xs[2]) if cls == "LSTM" else xs[1]
        return m(xs[0], st)

    kw = {"activation": "relu"} if cls == "SimpleRNN" else {}
    compare(f"{cls}-init", lambda P: getattr(P.nn, cls)(
        5, 6, num_layers=L, direction="bidirect", **kw), make, call)


def test_recurrent_dropout_between_layers_draws_the_reference_masks():
    compare("gru-dropout", lambda P: P.nn.GRU(4, 5, num_layers=3,
                                              dropout=0.4),
            lambda r: [f(r, 2, 6, 4)], train=True)


@pytest.mark.parametrize("cell", ["SimpleRNNCell", "LSTMCell", "GRUCell"])
@pytest.mark.parametrize("reverse", [False, True])
def test_cell_through_rnn_matches_reference(cell, reverse):
    compare(f"{cell}{reverse}",
            lambda P: P.nn.RNN(getattr(P.nn, cell)(4, 5),
                               is_reverse=reverse),
            lambda r: [f(r, 2, 4, 4)])


def test_birnn_matches_reference():
    compare("birnn", lambda P: P.nn.BiRNN(P.nn.GRUCell(4, 5),
                                          P.nn.LSTMCell(4, 5)),
            lambda r: [f(r, 2, 3, 4)])


def test_cell_base_initial_states():
    for P in (jpaddle, tpaddle):
        cell = P.nn.GRUCell(3, 7)
        x = P.to_tensor(np.zeros((4, 3), np.float32))
        s = P.nn.RNNCellBase.get_initial_states(cell, x, init_value=0.5)
        assert list(s.shape) == [4, 7]
        np.testing.assert_array_equal(s.numpy(), 0.5)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_layer_matches_reference(normalize_before):
    compare(f"enc{normalize_before}",
            lambda P: P.nn.TransformerEncoder(
                P.nn.TransformerEncoderLayer(
                    8, 2, 16, dropout=0.0, activation="gelu",
                    normalize_before=normalize_before), 2,
                P.nn.LayerNorm(8) if normalize_before else None),
            lambda r: [f(r, 2, 5, 8)])


def test_decoder_layer_matches_reference():
    compare("dec", lambda P: P.nn.TransformerDecoder(
        P.nn.TransformerDecoderLayer(8, 2, 16, dropout=0.0), 2),
            lambda r: [f(r, 2, 4, 8), f(r, 2, 6, 8)])


def test_transformer_with_masks_matches_reference():
    def call(m, xs):
        P = tpaddle if type(m).__module__.startswith("paddle_tpu_torch") \
            else jpaddle
        mask = P.nn.Transformer.generate_square_subsequent_mask(4)
        return m(xs[0], xs[1], tgt_mask=mask)

    compare("transformer", lambda P: P.nn.Transformer(
        d_model=8, nhead=2, num_encoder_layers=1, num_decoder_layers=2,
        dim_feedforward=12, dropout=0.0, normalize_before=True),
            lambda r: [f(r, 2, 5, 8), f(r, 2, 4, 8)], call)


def test_transformer_dropout_draws_the_reference_masks():
    compare("transformer-drop", lambda P: P.nn.TransformerEncoderLayer(
        8, 2, 16, dropout=0.2), lambda r: [f(r, 2, 5, 8)], train=True)


def test_multi_head_attention_cache_matches_reference():
    def call(m, xs):
        return m(xs[0], attn_mask=None, cache=(xs[1], xs[2]))

    compare("mha-cache", lambda P: P.nn.MultiHeadAttention(8, 2, kdim=8,
                                                           vdim=8),
            lambda r: [f(r, 2, 3, 8), f(r, 2, 4, 2, 4), f(r, 2, 4, 2, 4)],
            call)


def test_multi_head_attention_cross_with_other_widths():
    compare("mha-cross", lambda P: P.nn.MultiHeadAttention(8, 4, kdim=6,
                                                           vdim=5),
            lambda r: [f(r, 2, 3, 8), f(r, 2, 4, 6), f(r, 2, 4, 5)],
            lambda m, xs: m(xs[0], xs[1], xs[2]))


def _beam(P, state, beam, batch, vocab=9, end=1):
    P.seed(11)
    emb = P.nn.Embedding(vocab, 4)
    cell = P.nn.GRUCell(4, 6)
    out = P.nn.Linear(6, vocab)
    for m, sd in zip((emb, cell, out), state or (None,) * 3):
        if sd is not None:
            m.set_state_dict(sd)
    dec = P.nn.BeamSearchDecoder(cell, start_token=0, end_token=end,
                                 beam_size=beam, embedding_fn=emb,
                                 output_fn=out)
    h0 = P.to_tensor(np.linspace(-1, 1, batch * beam * 6).reshape(
        batch * beam, 6).astype(np.float32))
    ids, lp = P.nn.dynamic_decode(dec, inits=h0, max_step_num=7,
                                  batch_size=batch)
    sds = [{k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}
           for m in (emb, cell, out)]
    return np.asarray(ids.numpy()), np.asarray(lp.numpy()), sds


@pytest.mark.parametrize("beam,batch", [(3, 2), (4, 1)])
def test_beam_search_dynamic_decode_matches_reference(beam, batch):
    ids_r, lp_r, sds = _beam(jpaddle, None, beam, batch)
    ids_p, lp_p, _ = _beam(tpaddle, sds, beam, batch)
    assert ids_p.shape == ids_r.shape
    np.testing.assert_array_equal(ids_p, ids_r)
    np.testing.assert_allclose(lp_p, lp_r, rtol=1e-5, atol=1e-5)


def test_sequence_ops_are_registered_outside_the_manifest():
    from paddle_tpu.ops import registry as jreg
    from paddle_tpu_torch.ops import registry as treg

    for name in ("lstm_seq", "gru_seq", "rnn_seq"):
        assert name in treg.OPS and name in jreg.OPS
        assert treg.OPS[name].tensor_args == jreg.OPS[name].tensor_args
        assert treg.OPS[name].methods == []


def test_ds2_ctc_model_trains_as_the_reference():
    """``tools/ds2_ctc_train.py`` at small widths through both packages,
    the reference's weights carried across: the losses of three AdamW
    steps agree (rtol 1e-4: three optimizer steps over the recurrence)
    and fall."""
    from paddle_tpu_torch.tools import ds2_ctc_train as D

    kw = dict(layers=2, hidden=8, inputs=6, classes=5, seed=3)
    data = D.batch(4, 24, (3, 6), inputs=6, classes=5, seed=3)
    losses = []
    state = None
    for P in (jpaddle, tpaddle):
        model, loss_fn = D.build(P, **kw)
        if state is None:
            state = {k: np.asarray(v.numpy())
                     for k, v in model.state_dict().items()}
        else:
            model.set_state_dict(state)
        losses.append(D.train(P, model, loss_fn, data, 3, lr=1e-2)["losses"])
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    assert losses[1][-1] < losses[1][0]
