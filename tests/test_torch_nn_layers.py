"""Every ported layer class against the JAX package's: the same
constructor arguments give the same ``state_dict`` keys, shapes and
dtypes; after ``set_state_dict`` from the reference's values (shared
numpy) the forward outputs, the gradients of a seeded cotangent for the
parameters and the floating inputs, and BatchNorm's running statistics
agree at rtol 1e-5 / atol 1e-5 (1e-4 for the conv, pool, resampling and
norm layers, whose torch and XLA reductions add in another order). Both
packages are seeded alike, so the dropout layers draw the same masks.
Also: ``nn.utils`` (clips, vector round trip, weight and spectral norm),
the degree-1 tensor-parallel layers, and the same layers at degree 2 on
two gloo ranks."""
import zlib

import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.core import place as port_place

TOL = (1e-5, 1e-5)
LOOSE = (1e-4, 1e-4)


@pytest.fixture(autouse=True)
def _cpu_place():
    prev = (port_place._current_place, port_place._current_device)
    tpaddle.set_device("cpu")
    yield
    port_place._current_place, port_place._current_device = prev


def f(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def pos(rng, *shape):
    return rng.uniform(0.1, 0.9, shape).astype(np.float32)


def ints(rng, hi, *shape):
    return rng.integers(0, hi, shape).astype(np.int64)


# (id, module path under nn, class, args, kwargs, inputs(rng), tol)
CASES = [
    ("Linear", "", "Linear", (4, 3), {}, lambda r: [f(r, 2, 4)], TOL),
    ("Linear_nobias", "", "Linear", (4, 3), {"bias_attr": False},
     lambda r: [f(r, 5, 4)], TOL),
    ("Embedding_pad", "", "Embedding", (10, 4), {"padding_idx": 2},
     lambda r: [np.array([[1, 2, 3], [2, 9, 0]])], TOL),
    ("Dropout", "", "Dropout", (0.3,), {}, lambda r: [f(r, 3, 4)], TOL),
    ("Dropout_axis", "", "Dropout", (0.5,), {"axis": 1},
     lambda r: [f(r, 3, 4)], TOL),
    ("Dropout2D", "", "Dropout2D", (0.5,), {}, lambda r: [f(r, 2, 3, 2, 2)],
     TOL),
    ("Dropout3D", "", "Dropout3D", (0.5,), {},
     lambda r: [f(r, 2, 3, 2, 2, 2)], TOL),
    ("AlphaDropout", "", "AlphaDropout", (0.2,), {}, lambda r: [f(r, 4, 5)],
     TOL),
    ("Flatten", "", "Flatten", (), {}, lambda r: [f(r, 2, 3, 4)], TOL),
    ("Pad1D", "", "Pad1D", ([1, 2],), {}, lambda r: [f(r, 2, 3, 5)], TOL),
    ("Pad2D", "", "Pad2D", ([1, 1, 2, 0],), {"mode": "reflect"},
     lambda r: [f(r, 1, 2, 4, 4)], TOL),
    ("Pad3D", "", "Pad3D", ([1, 0, 0, 1, 1, 1],), {"value": 0.5},
     lambda r: [f(r, 1, 1, 2, 3, 3)], TOL),
    ("Upsample", "", "Upsample", (), {"scale_factor": 2},
     lambda r: [f(r, 1, 2, 3, 3)], LOOSE),
    ("UpsamplingBilinear2D", "", "UpsamplingBilinear2D", (),
     {"scale_factor": 2}, lambda r: [f(r, 1, 2, 3, 3)], LOOSE),
    ("UpsamplingNearest2D", "", "UpsamplingNearest2D", (),
     {"size": [4, 5]}, lambda r: [f(r, 1, 2, 3, 3)], LOOSE),
    ("Unfold", "", "Unfold", (2,), {}, lambda r: [f(r, 1, 2, 4, 4)], LOOSE),
    ("PixelShuffle", "", "PixelShuffle", (2,), {},
     lambda r: [f(r, 1, 8, 2, 2)], TOL),
    ("CosineSimilarity", "", "CosineSimilarity", (), {"axis": 1},
     lambda r: [f(r, 3, 5), f(r, 3, 5)], TOL),
    ("PairwiseDistance", "", "PairwiseDistance", (), {},
     lambda r: [f(r, 3, 5), f(r, 3, 5)], TOL),
    ("Bilinear", "", "Bilinear", (3, 4, 2), {},
     lambda r: [f(r, 5, 3), f(r, 5, 4)], TOL),
    # activations
    *[(name, "", name, (), {}, lambda r: [f(r, 2, 3, 4) * 3], TOL)
      for name in ("ReLU", "ReLU6", "GELU", "Sigmoid", "LogSigmoid", "Silu",
                   "Swish", "Mish", "Softplus", "Softsign", "Hardswish",
                   "Hardsigmoid", "Hardtanh", "LeakyReLU", "ELU", "SELU",
                   "CELU", "GLU", "Tanh", "Tanhshrink", "Hardshrink",
                   "Softshrink", "ThresholdedReLU", "Softmax",
                   "LogSoftmax")],
    ("GELU_tanh", "", "GELU", (), {"approximate": True},
     lambda r: [f(r, 2, 5)], TOL),
    ("PReLU", "", "PReLU", (3,), {}, lambda r: [f(r, 2, 3, 4)], TOL),
    ("Maxout", "", "Maxout", (2,), {}, lambda r: [f(r, 2, 4, 3)], TOL),
    # losses
    ("CrossEntropyLoss", "", "CrossEntropyLoss", (), {},
     lambda r: [f(r, 4, 5), ints(r, 5, 4)], TOL),
    ("CrossEntropyLoss_smooth", "", "CrossEntropyLoss", (),
     {"label_smoothing": 0.1, "reduction": "sum"},
     lambda r: [f(r, 4, 5), ints(r, 5, 4)], TOL),
    ("MSELoss", "", "MSELoss", (), {}, lambda r: [f(r, 3, 4), f(r, 3, 4)],
     TOL),
    ("L1Loss", "", "L1Loss", (), {}, lambda r: [f(r, 3, 4), f(r, 3, 4)],
     TOL),
    ("NLLLoss", "", "NLLLoss", (), {},
     lambda r: [np.log(pos(r, 4, 5)), ints(r, 5, 4)], TOL),
    ("BCELoss", "", "BCELoss", (), {}, lambda r: [pos(r, 3, 4),
                                                  pos(r, 3, 4)], TOL),
    ("BCEWithLogitsLoss", "", "BCEWithLogitsLoss", (), {},
     lambda r: [f(r, 3, 4), pos(r, 3, 4)], TOL),
    ("SmoothL1Loss", "", "SmoothL1Loss", (), {},
     lambda r: [f(r, 3, 4), f(r, 3, 4)], TOL),
    ("KLDivLoss", "", "KLDivLoss", (), {},
     lambda r: [np.log(pos(r, 3, 4)), pos(r, 3, 4)], TOL),
    ("HingeLoss", "", "HingeLoss", (), {},
     lambda r: [f(r, 3, 4), np.sign(f(r, 3, 4))], TOL),
    ("MarginRankingLoss", "", "MarginRankingLoss", (), {"margin": 0.1},
     lambda r: [f(r, 6), f(r, 6), np.sign(f(r, 6))], TOL),
    ("CosineEmbeddingLoss", "", "CosineEmbeddingLoss", (), {"margin": 0.2},
     lambda r: [f(r, 4, 5), f(r, 4, 5),
                np.array([1, -1, 1, -1], np.float32)], TOL),
    # norms
    ("BatchNorm", "", "BatchNorm", (3,), {}, lambda r: [f(r, 4, 3)], LOOSE),
    ("BatchNorm1D", "", "BatchNorm1D", (3,), {}, lambda r: [f(r, 4, 3, 5)],
     LOOSE),
    ("BatchNorm2D", "", "BatchNorm2D", (3,), {"momentum": 0.8},
     lambda r: [f(r, 2, 3, 4, 4)], LOOSE),
    ("BatchNorm3D", "", "BatchNorm3D", (2,), {},
     lambda r: [f(r, 2, 2, 3, 3, 3)], LOOSE),
    ("SyncBatchNorm", "", "SyncBatchNorm", (3,), {},
     lambda r: [f(r, 2, 3, 4, 4)], LOOSE),
    ("LayerNorm", "", "LayerNorm", (4,), {}, lambda r: [f(r, 2, 3, 4)],
     LOOSE),
    ("RMSNorm", "", "RMSNorm", (4,), {}, lambda r: [f(r, 2, 3, 4)], LOOSE),
    ("GroupNorm", "", "GroupNorm", (2, 4), {}, lambda r: [f(r, 2, 4, 3, 3)],
     LOOSE),
    ("InstanceNorm1D", "", "InstanceNorm1D", (3,), {},
     lambda r: [f(r, 2, 3, 6)], LOOSE),
    ("InstanceNorm2D", "", "InstanceNorm2D", (3,), {},
     lambda r: [f(r, 2, 3, 4, 4)], LOOSE),
    ("InstanceNorm3D", "", "InstanceNorm3D", (2,), {},
     lambda r: [f(r, 2, 2, 3, 3, 3)], LOOSE),
    ("LocalResponseNorm", "", "LocalResponseNorm", (3,), {},
     lambda r: [f(r, 1, 4, 3, 3)], LOOSE),
    ("SpectralNorm", "", "SpectralNorm", ([4, 3],), {"power_iters": 2},
     lambda r: [f(r, 4, 3)], LOOSE),
    # conv / pool
    ("Conv1D", "", "Conv1D", (2, 4, 3), {}, lambda r: [f(r, 2, 2, 7)],
     LOOSE),
    ("Conv2D", "", "Conv2D", (2, 4, 3), {"padding": 1, "stride": 2},
     lambda r: [f(r, 2, 2, 6, 6)], LOOSE),
    ("Conv3D", "", "Conv3D", (2, 3, 2), {}, lambda r: [f(r, 1, 2, 4, 4, 4)],
     LOOSE),
    ("Conv2DTranspose", "", "Conv2DTranspose", (2, 3, 3), {"stride": 2},
     lambda r: [f(r, 1, 2, 4, 4)], LOOSE),
    ("MaxPool1D", "", "MaxPool1D", (2,), {}, lambda r: [f(r, 2, 3, 8)],
     LOOSE),
    ("MaxPool2D", "", "MaxPool2D", (2,), {}, lambda r: [f(r, 2, 3, 6, 6)],
     LOOSE),
    ("AvgPool1D", "", "AvgPool1D", (2,), {}, lambda r: [f(r, 2, 3, 8)],
     LOOSE),
    ("AvgPool2D", "", "AvgPool2D", (2,), {"padding": 1},
     lambda r: [f(r, 2, 3, 6, 6)], LOOSE),
    ("AdaptiveAvgPool2D", "", "AdaptiveAvgPool2D", (2,), {},
     lambda r: [f(r, 2, 3, 5, 5)], LOOSE),
    ("AdaptiveMaxPool2D", "", "AdaptiveMaxPool2D", (2,), {},
     lambda r: [f(r, 2, 3, 4, 4)], LOOSE),
    # the tensor-parallel layers at degree 1
    ("VocabParallelEmbedding", "fleet", "VocabParallelEmbedding", (10, 4),
     {}, lambda r: [np.array([[1, 2], [9, 0]])], TOL),
    ("ColumnParallelLinear", "fleet", "ColumnParallelLinear", (4, 6), {},
     lambda r: [f(r, 3, 4)], TOL),
    ("RowParallelLinear", "fleet", "RowParallelLinear", (6, 4),
     {"has_bias": False}, lambda r: [f(r, 3, 6)], TOL),
    ("ParallelCrossEntropy", "fleet", "ParallelCrossEntropy", (), {},
     lambda r: [f(r, 4, 7), ints(r, 7, 4, 1)], TOL),
]


def _cls(P, where, name):
    if where == "fleet":
        import importlib

        return getattr(importlib.import_module(
            P.__name__ + ".distributed.fleet"), name)
    return getattr(P.nn, name)


def _run(P, case, state=None):
    cid, where, name, args, kw, make, _ = case
    seed = zlib.crc32(cid.encode())
    P.seed(seed)
    layer = _cls(P, where, name)(*args, **kw)
    if state is not None:
        layer.set_state_dict(state)
    sd = layer.state_dict()
    meta = [(k, list(v.shape), v.dtype.name) for k, v in sd.items()]
    before = {k: np.asarray(v.numpy()) for k, v in sd.items()}
    rng = np.random.default_rng(seed)
    arrays = make(rng)
    inputs = [P.to_tensor(a, stop_gradient=a.dtype != np.float32)
              for a in arrays]
    out = layer(*inputs)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    c = np.random.default_rng(seed + 1)
    loss = None
    for o in outs:
        if o.dtype.name == "float32" and not o.stop_gradient:
            term = (o * P.to_tensor(c.standard_normal(o.shape).astype(
                np.float32))).sum()
            loss = term if loss is None else loss + term
    if loss is not None:
        loss.backward()
    grads = {k: (None if p.grad is None else np.asarray(p.grad.numpy()))
             for k, p in layer.named_parameters()}
    in_grads = [None if t.stop_gradient or t.grad is None
                else np.asarray(t.grad.numpy()) for t in inputs]
    after = {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}
    return (meta, before, [np.asarray(o.numpy()) for o in outs], grads,
            in_grads, after)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_layer_matches_reference(case):
    rtol, atol = case[-1]
    ref = _run(jpaddle, case)
    meta, state = ref[0], ref[1]
    got = _run(tpaddle, case, state=state)
    assert got[0] == meta, case[0]
    for a, b in zip(ref[2], got[2]):
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol,
                                   err_msg=case[0] + " out")
    assert set(got[3]) == set(ref[3])
    for k in ref[3]:
        if ref[3][k] is None:
            assert got[3][k] is None or not got[3][k].any(), k
            continue
        np.testing.assert_allclose(got[3][k], ref[3][k], rtol=rtol,
                                   atol=atol, err_msg=f"{case[0]} {k}")
    for a, b in zip(ref[4], got[4]):
        if a is not None or b is not None:
            # an input that takes no part (a label) has no gradient in one
            # package and a zero one in the other
            a = np.zeros_like(b) if a is None else a
            b = np.zeros_like(a) if b is None else b
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol,
                                       err_msg=case[0] + " input grad")
    for k in ref[5]:
        np.testing.assert_allclose(got[5][k], ref[5][k], rtol=rtol,
                                   atol=atol, err_msg=f"{case[0]} {k}")


def test_layers_draw_their_weights_as_the_reference():
    """Default initializers under one seed: ``XavierUniform`` (Linear,
    Bilinear, transposed conv) and ``KaimingUniform`` (conv) weights
    bit-identical, ``Normal`` embeddings within an ulp or so."""
    for cls, args, exact in (("Linear", (5, 7), True),
                             ("Conv2D", (3, 4, 3), True),
                             ("Conv2DTranspose", (3, 4, 3), True),
                             ("Bilinear", (3, 4, 2), True),
                             ("Embedding", (9, 5), False)):
        out = []
        for P in (jpaddle, tpaddle):
            P.seed(2)
            layer = getattr(P.nn, cls)(*args)
            out.append({k: np.asarray(v.numpy())
                        for k, v in layer.state_dict().items()})
        for k in out[0]:
            if exact:
                np.testing.assert_array_equal(out[1][k], out[0][k], k)
            else:
                np.testing.assert_allclose(out[1][k], out[0][k], rtol=1e-5,
                                           atol=1e-6)


def test_nn_utils_match_the_reference():
    """``clip_grad_norm_`` (2 and inf), ``clip_grad_value_``,
    ``parameters_to_vector`` / ``vector_to_parameters``, ``weight_norm``
    with ``remove_weight_norm`` and ``spectral_norm`` on a Linear."""
    def run(P):
        U = P.nn.utils
        P.seed(4)
        net = P.nn.Sequential(P.nn.Linear(3, 4), P.nn.Linear(4, 2))
        x = P.to_tensor(np.linspace(-2, 2, 6, dtype=np.float32).reshape(2,
                                                                        3))
        net(x).sum().backward()
        total = U.clip_grad_norm_(net.parameters(), 0.5)
        g1 = [p.grad.numpy() for p in net.parameters()]
        tinf = U.clip_grad_norm_(net.parameters(), 0.1,
                                 norm_type=float("inf"))
        U.clip_grad_value_(net.parameters(), 0.01)
        g2 = [p.grad.numpy() for p in net.parameters()]
        vec = U.parameters_to_vector(net.parameters())
        U.vector_to_parameters(vec * 2.0, net.parameters())
        w = [p.numpy() for p in net.parameters()]
        lin = P.nn.Linear(3, 4)
        U.weight_norm(lin, dim=1)
        wn = lin(x).numpy()
        wn_names = sorted(n for n, _ in lin.named_parameters())
        U.remove_weight_norm(lin)
        rm = lin(x).numpy()
        lin2 = P.nn.Linear(3, 4)
        U.spectral_norm(lin2)
        sn = lin2(x).numpy()
        return (float(total.numpy()), float(tinf.numpy()), g1, g2,
                vec.numpy(), w, wn, wn_names, rm, sn)
    ref = run(jpaddle)
    got = run(tpaddle)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-5)
    for i in (2, 3, 5):
        for a, b in zip(ref[i], got[i]):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[4], ref[4], rtol=1e-6)
    assert got[7] == ref[7]
    for i in (6, 8, 9):
        np.testing.assert_allclose(got[i], ref[i], rtol=1e-4, atol=1e-5)


def test_refusals_name_the_item_that_brings_them():
    """The tensor-parallel layers refuse nothing at degree 2 any more: on
    two gloo ranks, each cut to its shard by ``shard_model_parameters``,
    they give the unsharded layer's output, input gradient and (each
    rank its slice of) the weight gradients, and the vocab-parallel cross
    entropy gives the whole vocabulary's. ``mark_placements`` records the
    hints; ``sharding_constraint`` is the identity."""
    import torch

    from paddle_tpu_torch.distributed import Shard, fleet
    from paddle_tpu_torch.testing import gloo_ranks, hybrid_ranks

    rng = np.random.RandomState(0)
    f = np.float32
    weights = {
        "column": {"weight": rng.randn(8, 12).astype(f),
                   "bias": rng.randn(12).astype(f)},
        "row8": {"weight": rng.randn(8, 6).astype(f),
                 "bias": rng.randn(6).astype(f)},
        "row12": {"weight": rng.randn(12, 6).astype(f),
                  "bias": rng.randn(6).astype(f)},
        "row_in": rng.randn(3, 12).astype(f),
        "embedding": {"weight": rng.randn(16, 6).astype(f)},
        "logits": rng.randn(3, 5, 10).astype(f)}
    x = rng.randn(3, 8).astype(f)
    ids = rng.randint(0, 16, (3, 4)).astype(np.int64)
    labels = rng.randint(0, 10, (3, 5)).astype(np.int64)
    labels[0, 0] = -100
    got = gloo_ranks.run(hybrid_ranks.mp_layers, 2, weights, x, ids,
                         labels, timeout_s=120)

    def dense(fn, inp, params):
        ts = {k: torch.tensor(v, requires_grad=True)
              for k, v in params.items()}
        xt = torch.tensor(inp, requires_grad=inp.dtype.kind == "f")
        out = fn(xt, ts)
        (out * out).sum().backward()
        return (out.detach().numpy(), {k: t.grad.numpy()
                                       for k, t in ts.items()},
                None if xt.grad is None else xt.grad.numpy())

    lin = lambda xt, ts: xt @ ts["weight"] + ts["bias"]
    # (dense run, the output's split dim, each parameter's split dim)
    column, row = {"weight": 1, "bias": 0}, {"weight": 0, "bias": None}
    want = {
        "column_gather0": (dense(lin, x, weights["column"]), -1, column),
        "column_gather1": (dense(lin, x, weights["column"]), None, column),
        "row_parallel0": (dense(lin, x, weights["row8"]), None, row),
        "row_parallel1": (dense(lin, weights["row_in"], weights["row12"]),
                          None, row),
        "vocab_embedding": (dense(
            lambda xt, ts: ts["weight"][xt], ids, weights["embedding"]),
            None, {"weight": 0})}
    for name, ((out, grads, xg), out_dim, splits) in want.items():
        for rank, res in enumerate(got):
            r = res[name]
            o = out if out_dim is None else np.split(out, 2, out_dim)[rank]
            np.testing.assert_allclose(r["out"], o, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
            for pn, g in grads.items():
                split = splits[pn]
                gg = g if split is None else np.split(g, 2, split)[rank]
                np.testing.assert_allclose(r["grads"][pn], gg, rtol=1e-4,
                                           atol=1e-4, err_msg=(name, pn))
            if xg is not None and name != "row_parallel1":
                np.testing.assert_allclose(r["x_grad"], xg, rtol=1e-4,
                                           atol=1e-4, err_msg=name)
    lt = torch.tensor(weights["logits"], requires_grad=True)
    lab = torch.tensor(labels)
    ce = torch.nn.functional.cross_entropy(
        lt.reshape(-1, 10), lab.reshape(-1), ignore_index=-100,
        reduction="none").reshape(3, 5, 1)
    ce.sum().backward()
    for rank, res in enumerate(got):
        r = res["cross_entropy"]
        np.testing.assert_allclose(r["out"], ce.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            r["x_grad"], np.split(lt.grad.numpy(), 2, -1)[rank],
            rtol=1e-5, atol=1e-6)
    w = tpaddle.to_tensor(np.ones([2], np.float32))
    assert fleet.mark_placements(w, mp=Shard(0)) is w
    assert w._placement_hints == {"mp": Shard(0)}
    assert fleet.sharding_constraint(w, {0: "mp"}) is w
