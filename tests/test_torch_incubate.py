"""The port's ``incubate`` (``paddle_tpu_torch/incubate/``) against the
JAX package's: every fused function of ``incubate.nn.functional`` in f32
at rtol 1e-5 / atol 1e-6 (1e-4 / 1e-5 where a softmax or a layer norm
sits between the inputs and the output), with the reference's refusals
(``tests/test_fused_ops.py``'s loud errors, the megakernel pointers, the
cross-attention guard); the fused layers with ``ParamAttr``s; the
segment reductions, ``graph_send_recv``, the host-side graph samplers
(what a draw must satisfy, and ``graph_reindex`` on fixed neighbour
lists), ``identity_loss``, both ``softmax_mask_fuse`` forms; and
``LookAhead`` / ``ModelAverage`` over three eager steps, with a
parameter that gets no gradient. ``use_neox_rotary_style=False`` raises
in the port (the reference ignores the flag) and ``incubate.asp`` waits
for slice E2c.
"""
import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.incubate.nn import functional as JF
from paddle_tpu_torch.core import place as _place
from paddle_tpu_torch.incubate.nn import functional as TF

TOL = dict(rtol=1e-5, atol=1e-6)
SOFT = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _cpu_place():
    saved = (_place._current_place, _place._current_device)
    tpaddle.set_device("cpu")
    yield
    _place._current_place, _place._current_device = saved


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _r(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        "float32")


def _both(fn, *arrays, tol=TOL, **kw):
    """``fn`` of each package's functional on the same arguments (numpy
    arrays as Tensors); the outputs compared; the port's returned."""
    outs = []
    for P, mod in ((jpaddle, JF), (tpaddle, TF)):
        def conv(a):
            return P.to_tensor(a) if isinstance(a, np.ndarray) else a

        outs.append(getattr(mod, fn)(*map(conv, arrays),
                                     **{k: conv(v) for k, v in kw.items()}))
    j, t = outs
    js = j if isinstance(j, tuple) else (j,)
    ts = t if isinstance(t, tuple) else (t,)
    for a, b in zip(js, ts):
        if a is None:
            assert b is None
            continue
        assert list(b.shape) == list(a.shape)
        np.testing.assert_allclose(_np(b), _np(a), **tol)
    return t


def test_swiglu_and_fused_rms_norm_are_registry_ops():
    from paddle_tpu.ops import registry as jreg
    from paddle_tpu_torch.ops import registry as treg

    for name in ("swiglu", "fused_rms_norm"):
        assert name in treg.OPS and name in jreg.OPS
    x, y = _r(2, 3, 8), _r(2, 3, 8, seed=1)
    _both("swiglu", x, y)
    _both("swiglu", x)
    w, b = _r(8, seed=2), _r(8, seed=3)
    _both("fused_rms_norm", x, w, b, epsilon=1e-5)
    _both("fused_rms_norm", x, w)


def test_fused_rotary_position_embedding():
    q, k, v = _r(2, 6, 2, 8), _r(2, 6, 2, 8, seed=1), _r(2, 6, 2, 8, seed=2)
    ang = np.outer(np.arange(6), 1.0 / 10000 ** (np.arange(0, 8, 2) / 8))
    emb = np.concatenate([ang, ang], -1).astype("float32")
    cos, sin = np.cos(emb), np.sin(emb)
    _both("fused_rotary_position_embedding", q, k, v, sin, cos)
    _both("fused_rotary_position_embedding", q, None, None,
          sin[None, :, None], cos[None, :, None])
    with pytest.raises(NotImplementedError):
        TF.fused_rotary_position_embedding(
            tpaddle.to_tensor(q), sin=tpaddle.to_tensor(sin),
            cos=tpaddle.to_tensor(cos), use_neox_rotary_style=False)
    with pytest.raises(ValueError):
        TF.fused_rotary_position_embedding(tpaddle.to_tensor(q))


def test_fused_linear_family():
    x, w, b = _r(4, 8), _r(8, 6, seed=1), _r(6, seed=2)
    _both("fused_matmul_bias", x, w, b)
    _both("fused_matmul_bias", x, w.T.copy(), b, transpose_y=True)
    _both("fused_linear", x, w, b)
    _both("fused_linear", x, w.T.copy(), None, transpose_weight=True)
    for act in ("relu", "gelu", None):
        _both("fused_linear_activation", x, w, b, activation=act)


def test_fused_layer_norm_and_dropout_add():
    x, res = _r(2, 3, 8), _r(2, 3, 8, seed=1)
    bb, gw, gb = _r(8, seed=2), _r(8, seed=3), _r(8, seed=4)
    _both("fused_layer_norm", x, gw, gb, 1e-5, tol=SOFT, residual_alpha=0.5,
          begin_norm_axis=2, bias=bb, residual=res)
    _both("fused_layer_norm", x, gw.repeat(3), gb.repeat(3), 1e-5,
          tol=SOFT, begin_norm_axis=1)
    _both("fused_layer_norm", x, None, None, 1e-5, bias=bb)
    _both("fused_dropout_add", x, res, p=0.7, training=False)
    # training: both packages draw the same mask from the same state
    jpaddle.seed(3)
    tpaddle.seed(3)
    _both("fused_dropout_add", x, res, p=0.5, training=True)
    with pytest.raises(NotImplementedError):
        TF.fused_layer_norm(tpaddle.to_tensor(x), None, None, 1e-5,
                            quant_scale=0.5)


def test_fused_ec_moe_and_its_layout_check():
    x, gate = _r(2, 3, 4), _r(2, 3, 3, seed=1)
    w0, b0 = _r(3, 4, 5, seed=2), _r(3, 1, 5, seed=3)
    w1, b1 = _r(3, 5, 4, seed=4), _r(3, 1, 4, seed=5)
    for act in ("relu", "gelu"):
        _both("fused_ec_moe", x, gate, w0, b0, w1, b1, act, tol=SOFT)
    ones = tpaddle.ones
    with pytest.raises(ValueError):
        TF.fused_ec_moe(ones([1, 2, 4]), ones([1, 2, 2]), ones([2, 4, 4]),
                        ones([2, 1, 4]), ones([2, 5, 4]), ones([2, 1, 4]),
                        "relu")
    with pytest.raises(ValueError):
        TF.fused_ec_moe(ones([1, 2, 4]), ones([1, 2, 2]), ones([2, 4, 4]),
                        ones([2, 1, 4]), ones([2, 4, 4]), ones([2, 1, 4]),
                        "silu")


def test_fused_dot_product_attention():
    q, k, v = _r(1, 3, 2, 4), _r(1, 3, 2, 4, seed=1), _r(1, 3, 2, 4, seed=2)
    mask = np.zeros((1, 1, 3, 3), "float32")
    mask[..., 2] = -1e9
    _both("fused_dot_product_attention", q, k, v, scaling_factor=0.5,
          is_training=False, tol=SOFT)
    _both("fused_dot_product_attention", q, k, v, mask, is_training=False,
          tol=SOFT)
    _both("fused_dot_product_attention", q, k, v, is_causal_masking=True,
          is_training=False, tol=SOFT)
    t = tpaddle.ones([1, 3, 2, 4])
    with pytest.raises(NotImplementedError):   # causal + explicit mask
        TF.fused_dot_product_attention(t, t, t, mask=tpaddle.ones(
            [1, 1, 3, 3]), is_causal_masking=True)
    with pytest.raises(NotImplementedError):
        TF.fused_dot_product_attention(t, t, t, return_softmax=True)
    with pytest.raises(ValueError):            # unsupported activation
        TF.fused_linear_activation(tpaddle.ones([2, 2]),
                                   tpaddle.ones([2, 2]), activation="geglu")


def test_masked_multihead_attention_returns_out_and_new_cache():
    b, h, d, smax = 2, 2, 4, 6
    cache = np.zeros((2, b, h, smax, d), "float32")
    cache[:, :, :, :3] = _r(2, b, h, 3, d)
    x = _r(b, 3 * h * d, seed=1)
    lens = np.array([3, 2], "int32")
    bias = _r(3 * h * d, seed=2)
    src = np.zeros((b, smax), "float32")
    src[1, 0] = -1e9
    t_cache = tpaddle.to_tensor(cache)
    out, new = _both("masked_multihead_attention", x, cache, bias, src,
                     None, lens, tol=SOFT)
    assert new is not t_cache
    np.testing.assert_array_equal(_np(t_cache), cache)   # not in place
    _both("masked_multihead_attention", x, cache, tol=SOFT)
    with pytest.raises(ValueError):       # no free slot: loud, not dropped
        TF.masked_multihead_attention(
            tpaddle.to_tensor(_r(1, 12)),
            tpaddle.to_tensor(np.zeros((2, 1, 1, 4, 4), "float32")),
            sequence_lengths=tpaddle.to_tensor(np.array([4], "int32")))
    with pytest.raises(NotImplementedError):
        TF.masked_multihead_attention(tpaddle.to_tensor(x), t_cache,
                                      rotary_tensor=tpaddle.ones([1]))


def test_feedforward_bias_dropout_residual_layer_norm():
    x, res = _r(2, 3, 8), _r(2, 3, 8, seed=1)
    w1, w2 = _r(8, 16, seed=2), _r(16, 8, seed=3)
    b1, b2 = _r(16, seed=4), _r(8, seed=5)
    s1, s2 = _r(8, seed=6), _r(8, seed=7)
    for pre in (True, False):
        _both("fused_feedforward", x, w1, w2, b1, b2, s1, None, s2, None,
              dropout1_rate=0.0, dropout2_rate=0.0, activation="gelu",
              training=False, pre_layer_norm=pre, tol=SOFT)
    _both("fused_feedforward", x, w1, w2, dropout1_rate=0.0,
          dropout2_rate=0.0, training=False, add_residual=False, tol=SOFT)
    _both("fused_bias_dropout_residual_layer_norm", x, res, b2, s1, s2,
          dropout_rate=0.0, training=False, tol=SOFT)


def test_fused_multi_head_attention():
    e, h = 8, 2
    x = _r(2, 3, e)
    qkvw, lw = _r(3, h, e // h, e, seed=1), _r(e, e, seed=2)
    qkvb, lb = _r(3, h, e // h, seed=3), _r(e, seed=4)
    s, sb = _r(e, seed=5), _r(e, seed=6)
    mask = np.zeros((2, 1, 3, 3), "float32")
    mask[0, ..., 2] = -1e9
    for pre in (True, False):
        _both("fused_multi_head_attention", x, qkvw, lw, pre, s, sb, s, sb,
              1e-5, qkvb, lb, None, mask, dropout_rate=0.0,
              attn_dropout_rate=0.0, training=False, tol=SOFT)
    _both("fused_multi_head_attention", x, qkvw, lw, dropout_rate=0.0,
          attn_dropout_rate=0.0, training=False, add_residual=False,
          tol=SOFT)
    wt = _r(e, 3 * e, seed=7)
    _both("fused_multi_head_attention", x, wt, lw, dropout_rate=0.0,
          attn_dropout_rate=0.0, training=False, num_heads=h,
          transpose_qkv_wb=True, qkv_bias=None, tol=SOFT)
    t = tpaddle.to_tensor(x)
    with pytest.raises(ValueError):
        TF.fused_multi_head_attention(t, tpaddle.to_tensor(wt),
                                      tpaddle.to_tensor(lw),
                                      transpose_qkv_wb=True)
    with pytest.raises(NotImplementedError):
        TF.fused_multi_head_attention(t, tpaddle.to_tensor(qkvw),
                                      tpaddle.to_tensor(lw),
                                      cache_kv=tpaddle.ones([1]))


def test_serving_megakernels_raise_with_a_pointer():
    from paddle_tpu_torch.incubate import nn as inn

    for fn in (TF.fused_multi_transformer, TF.fused_gate_attention,
               inn.FusedMultiTransformer):
        with pytest.raises(NotImplementedError) as e:
            fn()
        assert "TPU" not in str(e.value) and "XLA" not in str(e.value)


def _layers(P, attr):
    """Each package's fused layers from one seed, with ``attr``."""
    inn = P.incubate.nn
    P.seed(4)
    return {
        "lin": inn.FusedLinear(8, 4, weight_attr=attr),
        "lin_t": inn.FusedLinear(8, 4, bias_attr=False,
                                 transpose_weight=True),
        "moe": inn.FusedEcMoe(8, 16, 3, act_type="relu", weight_attr=attr),
        "moe_nobias": inn.FusedEcMoe(8, 16, 3, bias_attr=False),
        "bdr": inn.FusedBiasDropoutResidualLayerNorm(8, dropout_rate=0.0,
                                                     weight_attr=attr),
        "bdr_none": inn.FusedBiasDropoutResidualLayerNorm(
            8, dropout_rate=0.0, weight_attr=False, bias_attr=False),
        "attn": inn.FusedMultiHeadAttention(8, 2, dropout_rate=0.0,
                                            attn_dropout_rate=0.0,
                                            normalize_before=True),
        "ffn": inn.FusedFeedForward(8, 16, dropout_rate=0.0,
                                    normalize_before=True),
    }


def test_fused_layers_with_param_attrs():
    import paddle_tpu.incubate  # noqa: F401
    import paddle_tpu_torch.incubate  # noqa: F401

    x, y, g = _r(2, 3, 8), _r(2, 3, 8, seed=1), _r(2, 3, 3, seed=2)
    outs = []
    for P in (jpaddle, tpaddle):
        attr = P.ParamAttr(initializer=P.nn.initializer.Constant(0.25),
                           learning_rate=0.5)
        L = _layers(P, attr)
        xt, yt, gt = P.to_tensor(x), P.to_tensor(y), P.to_tensor(g)
        outs.append((L, {
            "lin": L["lin"](xt), "lin_t": L["lin_t"](xt),
            "moe": L["moe"](xt, gt), "moe_nobias": L["moe_nobias"](xt, gt),
            "bdr": L["bdr"](xt, yt), "bdr_none": L["bdr_none"](xt, yt)}))
    (jl, jo), (tl, to) = outs
    for name in jo:
        np.testing.assert_allclose(_np(to[name]), _np(jo[name]), **SOFT,
                                   err_msg=name)
        assert [list(p.shape) for p in tl[name].parameters()] == \
            [list(p.shape) for p in jl[name].parameters()], name
    np.testing.assert_array_equal(_np(tl["lin"].weight), 0.25)
    assert tl["lin"].weight.optimize_attr == {"learning_rate": 0.5}
    assert len(list(tl["lin_t"].parameters())) == 1
    assert len(list(tl["bdr_none"].parameters())) == 0
    assert len(list(tl["moe_nobias"].parameters())) == 2
    # the pre-norm attention and feed-forward layers on the JAX weights
    from paddle_tpu_torch.models.convert import layer_state_from_jax

    for name in ("attn", "ffn"):
        state, _ = layer_state_from_jax(
            {k: np.asarray(v._data)
             for k, v in jl[name].state_dict().items()}, (0, 0))
        tl[name].set_state_dict(state)
        np.testing.assert_allclose(
            _np(tl[name](tpaddle.to_tensor(x))),
            _np(jl[name](jpaddle.to_tensor(x))), **SOFT, err_msg=name)
    # self-attention only
    with pytest.raises(NotImplementedError):
        tl["attn"](tpaddle.to_tensor(x), tpaddle.to_tensor(y),
                   tpaddle.to_tensor(y))
    da = tpaddle.incubate.nn.FusedDropoutAdd(p=0.3)
    da.eval()
    np.testing.assert_allclose(
        _np(da(tpaddle.ones([2, 2]), tpaddle.ones([2, 2]))), 2.0)
    dr = tpaddle.incubate.nn.FusedDropout(p=0.5)
    dr.eval()
    np.testing.assert_allclose(_np(dr(tpaddle.ones([3]))), 1.0)


def test_segment_reductions_and_graph_send_recv():
    from paddle_tpu import incubate as JI
    from paddle_tpu_torch import incubate as TI

    data = _r(6, 3)
    ids = np.array([0, 0, 1, 3, 3, 3], "int64")    # segment 2 is empty
    for name in ("segment_sum", "segment_mean", "segment_max",
                 "segment_min"):
        j = getattr(JI, name)(jpaddle.to_tensor(data),
                              jpaddle.to_tensor(ids))
        t = getattr(TI, name)(tpaddle.to_tensor(data),
                              tpaddle.to_tensor(ids))
        np.testing.assert_allclose(_np(t), _np(j), **TOL, err_msg=name)
    src = np.array([0, 1, 2, 3, 4], "int64")
    dst = np.array([1, 1, 0, 2, 2], "int64")
    for op in ("sum", "mean", "max", "MIN"):
        j = JI.graph_send_recv(jpaddle.to_tensor(data[:5]),
                               jpaddle.to_tensor(src),
                               jpaddle.to_tensor(dst), reduce_op=op)
        t = TI.graph_send_recv(tpaddle.to_tensor(data[:5]),
                               tpaddle.to_tensor(src),
                               tpaddle.to_tensor(dst), reduce_op=op)
        np.testing.assert_allclose(_np(t), _np(j), **TOL, err_msg=op)


def _csc():
    """A small CSC graph: node v's neighbours are row[colptr[v]:colptr[v+1]]."""
    nbrs = {0: [1, 2, 3, 4], 1: [0, 2], 2: [5], 3: [0, 1, 2, 4, 5], 4: [],
            5: [3, 2, 1]}
    row = np.concatenate([nbrs[v] for v in range(6)]).astype("int64")
    colptr = np.concatenate([[0], np.cumsum([len(nbrs[v])
                                             for v in range(6)])])
    return nbrs, row, colptr.astype("int64")


def test_graph_sample_neighbors_draws_subsets_without_replacement():
    from paddle_tpu_torch import incubate as TI

    nbrs, row, colptr = _csc()
    nodes = np.array([0, 3, 4, 2], "int64")
    for k in (2, -1, 10):
        for _ in range(5):
            out, cnt = TI.graph_sample_neighbors(
                tpaddle.to_tensor(row), tpaddle.to_tensor(colptr),
                tpaddle.to_tensor(nodes), sample_size=k)
            cnt = _np(cnt)
            assert cnt.dtype == np.int32
            flat = _np(out)
            off = 0
            for v, c in zip(nodes, cnt):
                want = len(nbrs[v]) if k < 0 else min(k, len(nbrs[v]))
                assert c == want
                got = flat[off:off + c].tolist()
                assert len(set(got)) == c and set(got) <= set(nbrs[v])
                off += c
            assert off == len(flat)


def test_graph_reindex_and_khop_sampler():
    from paddle_tpu import incubate as JI
    from paddle_tpu_torch import incubate as TI

    x = np.array([4, 9, 2], "int64")
    neighbors = np.array([9, 7, 2, 4, 11, 7, 9], "int64")
    count = np.array([2, 3, 2], "int32")
    j = JI.graph_reindex(jpaddle.to_tensor(x), jpaddle.to_tensor(neighbors),
                         jpaddle.to_tensor(count))
    t = TI.graph_reindex(tpaddle.to_tensor(x), tpaddle.to_tensor(neighbors),
                         tpaddle.to_tensor(count))
    for a, b in zip(j, t):
        np.testing.assert_array_equal(_np(b), _np(a))
    # khop: every hop's draw is a valid sample; the reindexing maps back
    nbrs, row, colptr = _csc()
    src, dst, nodes, eids = TI.graph_khop_sampler(
        tpaddle.to_tensor(row), tpaddle.to_tensor(colptr),
        tpaddle.to_tensor(np.array([0, 5], "int64")), [2, 2])
    nodes = _np(nodes)
    assert nodes[:2].tolist() == [0, 5]
    assert len(set(nodes.tolist())) == len(nodes)
    for s, d in zip(nodes[_np(src)], nodes[_np(dst)]):
        assert s in nbrs[d]
    np.testing.assert_array_equal(_np(eids), np.arange(len(_np(src))))


def test_identity_loss_and_softmax_mask_fuse():
    from paddle_tpu import incubate as JI
    from paddle_tpu_torch import incubate as TI

    x, mask = _r(2, 2, 4, 4), _r(2, 1, 4, 4, seed=1)
    for red in ("none", "sum", "mean", 0, 1, 2):
        np.testing.assert_allclose(
            _np(TI.identity_loss(tpaddle.to_tensor(x), red)),
            _np(JI.identity_loss(jpaddle.to_tensor(x), red)), **TOL)
    np.testing.assert_allclose(
        _np(TI.softmax_mask_fuse(tpaddle.to_tensor(x),
                                 tpaddle.to_tensor(mask))),
        _np(JI.softmax_mask_fuse(jpaddle.to_tensor(x),
                                 jpaddle.to_tensor(mask))), **TOL)
    up = TI.softmax_mask_fuse_upper_triangle(tpaddle.to_tensor(x))
    np.testing.assert_allclose(
        _np(up), _np(JI.softmax_mask_fuse_upper_triangle(
            jpaddle.to_tensor(x))), **TOL)
    assert np.all(np.triu(_np(up)[0, 0], 1) == 0)


def _eager_three_steps(P, wrapper):
    """Three eager steps of ``Linear(4, 3)`` plus a parameter the loss
    never uses, under SGD wrapped by ``wrapper``; returns (the wrapper,
    the layers)."""
    P.seed(8)
    lin = P.nn.Linear(4, 3)
    idle = P.nn.Linear(2, 2)
    params = list(lin.parameters()) + list(idle.parameters())
    opt = P.optimizer.SGD(learning_rate=0.1, parameters=params)
    inc = P.incubate
    w = inc.LookAhead(opt, alpha=0.5, k=2) if wrapper == "lookahead" \
        else inc.ModelAverage(0.15, parameters=params)
    x = P.to_tensor(_r(8, 4, seed=9))
    for _ in range(3):
        loss = (lin(x) ** 2).mean()
        loss.backward()
        if wrapper == "lookahead":
            w.step()
            w.clear_grad()
        else:
            opt.step()
            opt.clear_grad()
            w.step()
    return w, lin, idle


@pytest.mark.parametrize("wrapper", ["lookahead", "model_average"])
def test_lookahead_and_model_average_three_steps(wrapper):
    import paddle_tpu.incubate  # noqa: F401
    import paddle_tpu_torch.incubate  # noqa: F401

    (jw, jl, ji), (tw, tl, ti) = (_eager_three_steps(P, wrapper)
                                  for P in (jpaddle, tpaddle))
    idle0 = _np(ti.weight).copy()
    if wrapper == "model_average":
        with jw.apply(), tw.apply():
            for a, b in zip(jl.parameters(), tl.parameters()):
                np.testing.assert_allclose(_np(b), _np(a), **TOL)
        trained = [_np(p).copy() for p in tl.parameters()]
        tw.restore()
    for a, b in zip(list(jl.parameters()) + list(ji.parameters()),
                    list(tl.parameters()) + list(ti.parameters())):
        np.testing.assert_allclose(_np(b), _np(a), **TOL)
    np.testing.assert_array_equal(_np(ti.weight), idle0)
    if wrapper == "model_average":
        for p, t in zip(tl.parameters(), trained):
            np.testing.assert_array_equal(_np(p), t)


def test_asp_waits_for_slice_e2c():
    from paddle_tpu_torch import incubate

    with pytest.raises(NotImplementedError, match="E2c"):
        incubate.asp.prune_model(None)
    with pytest.raises(NotImplementedError, match="E2c"):
        incubate.asp()
