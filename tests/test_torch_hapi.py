"""The port's high-level API (``paddle_tpu_torch/hapi/``, ``metric/``)
against the JAX package's.

``Model.fit`` / ``evaluate`` / ``predict`` on the small BERT classifier
(2 layers, hidden 32, dropout 0.1 on, ``metric.Accuracy``, train metrics
every batch, an evaluation each epoch, ``EarlyStopping``) and on
``tests/test_hapi.py``'s MLP: the same per-batch losses (rtol 1e-5 /
atol 1e-6), metric values, predictions and generator state as the
reference's ``Model``, numpy seeded for the same shuffle. Then the
callbacks (``LRScheduler``, AMP "O1" at bf16's rtol 2e-2, multi-``topk``
accuracy, ``ModelCheckpoint`` flat and through ``CheckpointManager``
with auto-resume, ``VisualDL``'s JSON records), the metrics, ``summary``
and ``flops``, the tied decoder across ``Model.save`` / ``load``, a
``fit`` the JAX package checkpointed resumed by the port, and the two
differences by design: evaluation without ``jit.to_static`` (E3), and
``save(training=False)`` refused until E3.
"""
import json
import os

import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu.io  # noqa: F401
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.io  # noqa: F401
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.core import place as _place
from paddle_tpu_torch.models import bert as tbert

TOL = dict(rtol=1e-5, atol=1e-6)
PACKAGES = (jpaddle, tpaddle)


@pytest.fixture(autouse=True, scope="module")
def _cpu_place():
    saved = (_place._current_place, _place._current_device)
    tpaddle.set_device("cpu")
    yield
    _place._current_place, _place._current_device = saved


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _dataset(P, x, y):
    class DS(P.io.Dataset):
        def __len__(self):
            return len(x)

        def __getitem__(self, i):
            return x[i], y[i]

    return DS()


def _rand_cls(n=64, d=8):
    """tests/test_hapi.py's separable 2-class data."""
    rng = np.random.RandomState(0)
    x = rng.randn(n, d).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.int64)
    x[y == 1] += 1.0
    return x, y


def _mlp_model(P, metrics=None, lr=0.05, amp=None, opt="adam"):
    nn = P.nn
    P.seed(0)
    net = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 2))
    o = (P.optimizer.Adam(learning_rate=lr, parameters=net.parameters())
         if opt == "adam" else opt(net))
    m = P.Model(net)
    m.prepare(o, nn.CrossEntropyLoss(),
              metrics if metrics is not None else P.metric.Accuracy(),
              amp_configs=amp)
    return m


class _Grab:
    """Per-batch train logs and the eval logs, as a callback of ``P``."""

    @staticmethod
    def make(P):
        class Grab(P.hapi.Callback):
            def __init__(self):
                super().__init__()
                self.train, self.eval = [], []

            def on_train_batch_end(self, step, logs=None):
                self.train.append(dict(logs))

            def on_eval_end(self, logs=None):
                self.eval.append(dict(logs))

        return Grab()


def _same_logs(a, b):
    assert len(a) == len(b)
    for la, lb in zip(a, b):
        assert set(la) == set(lb)
        for k in la:
            np.testing.assert_allclose(lb[k], la[k], err_msg=k, **TOL)


def _bert_fit(P):
    mod = jbert if P is jpaddle else tbert
    P.seed(0)
    cfg = mod.BertConfig(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                         num_attention_heads=4, intermediate_size=64,
                         max_position_embeddings=64)
    net = mod.BertForSequenceClassification(cfg, 2)
    m = P.Model(net)
    m.prepare(P.optimizer.AdamW(2e-3, parameters=net.parameters()),
              P.nn.CrossEntropyLoss(), P.metric.Accuracy())
    rng = np.random.default_rng(0)
    x = rng.integers(1, 128, (16, 12)).astype("int64")
    y = rng.integers(0, 2, (16,)).astype("int64")
    ds = _dataset(P, x, y)
    grab = _Grab.make(P)
    es = P.hapi.EarlyStopping(monitor="acc", mode="max", patience=0,
                              verbose=0)
    np.random.seed(0)
    hist = m.fit(ds, eval_data=ds, batch_size=8, epochs=2, verbose=0,
                 log_freq=1, callbacks=[grab, es])
    ev = m.evaluate(ds, batch_size=8, verbose=0)
    pred = m.predict(ds, batch_size=8, stack_outputs=True)
    return {"hist": hist, "train": grab.train, "eval": grab.eval, "ev": ev,
            "pred": pred[0], "rng": tuple(P.get_rng_state()),
            "stopped": m.stop_training,
            "params": [(n, _np(p)) for n, p in net.named_parameters()]}


@pytest.fixture(scope="module")
def bert_fits():
    return {P: _bert_fit(P) for P in PACKAGES}


def test_bert_classifier_fit_evaluate_predict_match_the_reference(bert_fits):
    """Dropout on, train metrics every batch, an evaluation each epoch:
    the same losses, accuracies, predictions and generator state (the
    forwards outside the step spend one key a call, as the reference's
    compiled forward does)."""
    j, t = bert_fits[jpaddle], bert_fits[tpaddle]
    assert len(t["train"]) >= 4 and all("acc" in lg for lg in t["train"])
    _same_logs(j["train"], t["train"])
    _same_logs(j["eval"], t["eval"])
    _same_logs(j["hist"], t["hist"])
    _same_logs([j["ev"]], [t["ev"]])
    np.testing.assert_allclose(t["pred"], j["pred"], **TOL)
    assert t["pred"].shape == (16, 2)
    assert t["rng"] == j["rng"]
    assert t["stopped"] == j["stopped"]
    # every parameter after the AdamW steps (the key biases, whose
    # gradient is rounding noise, within what 4 steps of lr 2e-3 move)
    for (name, a), (_, b) in zip(j["params"], t["params"]):
        if name.endswith("self_attn.k_proj.bias"):
            assert np.abs(b - a).max() <= 2 * 4 * 2e-3 * 1.01, name
        else:
            np.testing.assert_allclose(b, a, err_msg=name, **TOL)


def test_evaluate_runs_without_to_static_and_spends_one_key_a_batch():
    """By design: no ``jit.to_static`` until E3; ``evaluate`` and
    ``predict`` call the network under no_grad, one generator key a
    batch, as the reference's compiled forward takes one."""
    assert not hasattr(tpaddle.jit, "to_static")
    x, y = _rand_cls(32)
    moved = {}
    for P in PACKAGES:
        m = _mlp_model(P)
        ds = _dataset(P, x, y)
        before = P.get_rng_state()[1]
        m.evaluate(ds, batch_size=8, verbose=0)
        m.predict(ds, batch_size=16)
        moved[P] = P.get_rng_state()[1] - before
    assert moved[tpaddle] == moved[jpaddle] == 6


def test_mlp_fit_evaluate_predict_match_the_reference():
    x, y = _rand_cls()
    res = {}
    for P in PACKAGES:
        m = _mlp_model(P)
        ds = _dataset(P, x, y)
        grab = _Grab.make(P)
        np.random.seed(0)
        hist = m.fit(ds, epochs=3, batch_size=16, verbose=0, log_freq=2,
                     callbacks=[grab])
        res[P] = (hist, grab.train, m.evaluate(ds, batch_size=16, verbose=0),
                  m.predict(ds, batch_size=16, stack_outputs=True)[0])
    (jh, jt, je, jp), (th, tt, te, tp) = res[jpaddle], res[tpaddle]
    _same_logs(jt, tt)
    _same_logs(jh, th)
    _same_logs([je], [te])
    np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-5)
    assert th[-1]["loss"] < th[0]["loss"] and te["acc"] > 0.8


def test_train_and_eval_batch_api():
    x, y = _rand_cls(16)
    out = {}
    for P in PACKAGES:
        m = _mlp_model(P)
        tr = [m.train_batch([x[:8]], [y[:8]]) for _ in range(2)]
        loss, metrics = m.eval_batch([x[8:]], [y[8:]])
        out[P] = (tr, loss, metrics, m.predict_batch([x[8:]])[0])
    (jt, jl, jm, jp), (tt, tl, tm, tp) = out[jpaddle], out[tpaddle]
    np.testing.assert_allclose(tt, jt, **TOL)
    np.testing.assert_allclose(tl, jl, **TOL)
    np.testing.assert_allclose(tm, jm, **TOL)
    np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-5)


def test_lr_scheduler_callback():
    x, y = _rand_cls(32)
    out = {}
    for P in PACKAGES:
        def sgd(net, P=P):
            sched = P.optimizer.lr.StepDecay(learning_rate=0.1, step_size=1,
                                             gamma=0.5)
            return P.optimizer.SGD(learning_rate=sched,
                                   parameters=net.parameters())

        m = _mlp_model(P, metrics=[], opt=sgd)
        np.random.seed(1)
        hist = m.fit(_dataset(P, x, y), epochs=2, batch_size=16, verbose=0,
                     callbacks=[P.hapi.LRScheduler(by_step=True)])
        out[P] = (hist, m._optimizer.get_lr())
    _same_logs(out[jpaddle][0], out[tpaddle][0])
    assert out[tpaddle][1] == out[jpaddle][1] == 0.1 * 0.5 ** 4
    with pytest.raises(AssertionError):
        tpaddle.hapi.LRScheduler(by_step=True, by_epoch=True)


def test_amp_o1_fit_matches_the_reference_at_bf16_tolerance():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 8)).astype("float32")
    y = rng.integers(0, 2, (32,)).astype("int64")
    hist = {}
    for P in PACKAGES:
        m = _mlp_model(P, metrics=[], lr=0.01, amp="O1")
        np.random.seed(2)
        hist[P] = [h["loss"] for h in m.fit(_dataset(P, x, y), epochs=4,
                                             batch_size=8, verbose=0)]
    np.testing.assert_allclose(hist[tpaddle], hist[jpaddle], rtol=2e-2)
    assert hist[tpaddle][-1] < hist[tpaddle][0]
    with pytest.raises(ValueError):
        _mlp_model(tpaddle, amp={"level": "O3"})


def test_multi_topk_accuracy_in_fit_and_evaluate():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(16, 8)).astype("float32")
    y = rng.integers(0, 2, (16,)).astype("int64")
    ev = {}
    for P in PACKAGES:
        m = _mlp_model(P, metrics=P.metric.Accuracy(topk=(1, 2)))
        np.random.seed(3)
        m.fit(_dataset(P, x, y), batch_size=4, epochs=1, verbose=0,
              log_freq=1)
        ev[P] = m.evaluate(_dataset(P, x, y), batch_size=4, verbose=0)
    assert set(ev[tpaddle]) == {"loss", "acc_top1", "acc_top2"}
    _same_logs([ev[jpaddle]], [ev[tpaddle]])
    assert ev[tpaddle]["acc_top2"] == 1.0


def test_accuracy_counts_all_sample_dims():
    acc = tpaddle.metric.Accuracy()
    pred = np.zeros((2, 4, 3), "float32")
    pred[..., 1] = 1.0
    label = np.ones((2, 4), "int64")
    assert acc.update(acc.compute(tpaddle.to_tensor(pred),
                                  tpaddle.to_tensor(label))) == 1.0
    assert acc.accumulate() == 1.0 and acc.count[0] == 8


def test_metrics_and_accuracy_match_the_reference():
    rng = np.random.default_rng(5)
    probs = rng.random((40, 2)).astype("float32")
    labels = rng.integers(0, 2, (40, 1)).astype("int64")
    logits = rng.normal(size=(40, 5)).astype("float32")
    cls = rng.integers(0, 5, (40,)).astype("int64")
    res = {}
    for P in PACKAGES:
        M = P.metric
        out = {}
        for name in ("Precision", "Recall", "Auc"):
            m = getattr(M, name)()
            for i in range(0, 40, 10):
                p = probs[i:i + 10, 1] if name != "Auc" else probs[i:i + 10]
                m.update(P.to_tensor(p), P.to_tensor(labels[i:i + 10]))
            out[name] = m.accumulate()
            assert m.name() == name.lower()
        for k in (1, 3):
            out[f"accuracy{k}"] = float(M.accuracy(
                P.to_tensor(logits), P.to_tensor(cls), k=k))
        acc = M.Accuracy(topk=(1, 3))
        acc.update(acc.compute(P.to_tensor(logits), P.to_tensor(cls)))
        out["acc"] = acc.accumulate()
        res[P] = out
    for k in res[jpaddle]:
        np.testing.assert_allclose(res[tpaddle][k], res[jpaddle][k],
                                   err_msg=k, **TOL)
    _, idx = tpaddle.topk(tpaddle.to_tensor(logits), 3)
    assert str(idx.dtype).endswith("int64")


def test_summary_and_flops_match_the_reference(capsys):
    out = {}
    for P in PACKAGES:
        nn = P.nn
        net = nn.Sequential(nn.Linear(8, 16), nn.LayerNorm(16), nn.ReLU(),
                            nn.Linear(16, 2))
        res = P.summary(net, input_size=(4, 8))
        text = capsys.readouterr().out
        fl = P.flops(net, input_size=(4, 8))
        capsys.readouterr()
        summ = P.Model(net).summary(input_size=(4, 8))
        capsys.readouterr()
        out[P] = (res, fl, summ, [ln for ln in text.splitlines()
                                  if not ln.startswith("-")])
    assert out[tpaddle] == out[jpaddle]
    assert out[tpaddle][0]["total_params"] == 8 * 16 + 16 + 32 + 16 * 2 + 2
    assert out[tpaddle][1] == 2 * 4 * (8 * 16 + 16 * 2) + 2 * 4 * 16


def test_summary_resnet(capsys):
    """tests/test_hapi.py::test_summary_resnet on the port, held to the
    reference's counts."""
    from paddle_tpu.vision.models import resnet18 as jresnet18
    from paddle_tpu_torch.vision.models import resnet18

    res = tpaddle.summary(resnet18(num_classes=10),
                          input_size=(1, 3, 32, 32))
    assert res["total_params"] > 1e7 * 1.1  # ~11.2M
    assert res["flops"] > 0
    jpaddle.seed(0)
    assert res == jpaddle.summary(jresnet18(num_classes=10),
                                  input_size=(1, 3, 32, 32))
    capsys.readouterr()


def test_model_checkpoint_flat_and_load(tmp_path):
    x, y = _rand_cls(32)
    m = _mlp_model(tpaddle)
    m.fit(_dataset(tpaddle, x, y), epochs=2, batch_size=16, verbose=0,
          callbacks=[tpaddle.hapi.ModelCheckpoint(save_dir=str(tmp_path))])
    for name in ("0", "1", "final"):
        assert os.path.exists(tmp_path / f"{name}.pdparams")
        assert os.path.exists(tmp_path / f"{name}.pdopt")
    m2 = _mlp_model(tpaddle)
    m2.load(str(tmp_path / "final"))
    np.testing.assert_array_equal(_np(m2.network[0].weight),
                                  _np(m.network[0].weight))
    assert m2._optimizer._step_count == m._optimizer._step_count == 4


def test_tied_decoder_survives_save_and_load(tmp_path):
    tpaddle.seed(0)
    cfg = tbert.BertConfig(vocab_size=128, hidden_size=32,
                           num_hidden_layers=2, num_attention_heads=4,
                           intermediate_size=64, max_position_embeddings=64)
    net = tbert.BertForMaskedLM(cfg)
    m = tpaddle.Model(net)
    m.prepare(tpaddle.optimizer.AdamW(1e-3, parameters=net.parameters()),
              tbert.BertPretrainingCriterion(cfg))
    ids = np.random.default_rng(0).integers(1, 128, (2, 8)).astype("int64")
    labels = np.where(ids % 3 == 0, ids, -100).astype("int64")
    m.train_batch([ids], [labels])
    m.save(str(tmp_path / "ck"))
    tpaddle.seed(1)
    net2 = tbert.BertForMaskedLM(cfg)
    m2 = tpaddle.Model(net2)
    m2.prepare(tpaddle.optimizer.AdamW(1e-3, parameters=net2.parameters()),
               tbert.BertPretrainingCriterion(cfg))
    m2.load(str(tmp_path / "ck"))
    emb = net2.bert.embeddings.word_embeddings.weight
    assert net2.decoder_weight is emb
    assert sum(1 for p in net2.parameters()
               if tuple(p.shape) == (128, 32)) == 1
    np.testing.assert_array_equal(_np(emb), _np(
        net.bert.embeddings.word_embeddings.weight))
    np.testing.assert_array_equal(m2.predict_batch([ids])[0],
                                  m.predict_batch([ids])[0])


def test_model_checkpoint_manager_and_auto_resume(tmp_path):
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager

    x, y = _rand_cls(32)
    ds = _dataset(tpaddle, x, y)
    d = str(tmp_path / "mgr")
    m = _mlp_model(tpaddle)
    m.fit(ds, epochs=3, batch_size=16, verbose=0,
          callbacks=[tpaddle.hapi.ModelCheckpoint(
              save_dir=d, save_freq=2, keep_last_n=2, async_save=True)])
    assert CheckpointManager(d, keep_last_n=2).all_steps() == [2, 3]
    w3 = _np(m.network[0].weight).copy()
    # a fit to the epochs already trained restores them and runs none
    m1 = _mlp_model(tpaddle)
    assert m1.fit(ds, epochs=3, batch_size=16, verbose=0,
                  callbacks=[tpaddle.hapi.ModelCheckpoint(
                      save_dir=d, keep_last_n=2)]) == []
    np.testing.assert_array_equal(_np(m1.network[0].weight), w3)
    assert m1._optimizer._step_count == 6
    # a restarted fit restores step 3 and trains epoch 3 only
    m2 = _mlp_model(tpaddle)
    h = m2.fit(ds, epochs=4, batch_size=16, verbose=0,
               callbacks=[tpaddle.hapi.ModelCheckpoint(
                   save_dir=d, keep_last_n=2)])
    assert len(h) == 1 and m2._optimizer._step_count == 8
    assert not np.array_equal(_np(m2.network[0].weight), w3)
    # trained through: no epoch runs; the opt-out trains from scratch
    assert _mlp_model(tpaddle).fit(
        ds, epochs=4, batch_size=16, verbose=0,
        callbacks=[tpaddle.hapi.ModelCheckpoint(save_dir=d,
                                                keep_last_n=2)]) == []
    assert len(_mlp_model(tpaddle).fit(
        ds, epochs=1, batch_size=16, verbose=0,
        callbacks=[tpaddle.hapi.ModelCheckpoint(
            save_dir=d, keep_last_n=2, auto_resume=False)])) == 1
    cb = tpaddle.hapi.ModelCheckpoint(save_dir=d, async_save=True)
    assert cb._get_manager()._keep >= 10 ** 9


def test_port_resumes_a_fit_the_jax_package_checkpointed(tmp_path):
    """The JAX package fits one epoch with a manager-backed
    ModelCheckpoint; a fresh port Model resumes from its directory and
    its second epoch gives the reference's own resumed losses."""
    x, y = _rand_cls(32)
    d = str(tmp_path / "jax")
    m = _mlp_model(jpaddle)
    np.random.seed(4)
    m.fit(_dataset(jpaddle, x, y), epochs=1, batch_size=16, verbose=0,
          callbacks=[jpaddle.hapi.ModelCheckpoint(save_dir=d,
                                                  keep_last_n=3)])
    out = {}
    for P in PACKAGES:
        m = _mlp_model(P)
        np.random.seed(5)
        out[P] = (m.fit(_dataset(P, x, y), epochs=2, batch_size=16,
                        verbose=0, callbacks=[P.hapi.ModelCheckpoint(
                            save_dir=d, keep_last_n=3)]), m)
        if P is jpaddle:   # the port resumes from the JAX package's step 1
            import shutil

            shutil.rmtree(os.path.join(d, "step_2"))
    (jh, jm), (th, tm) = out[jpaddle], out[tpaddle]
    assert len(th) == len(jh) == 1
    _same_logs(jh, th)
    assert tm._optimizer._step_count == jm._optimizer._step_count == 4
    for a, b in zip(jm.network.parameters(), tm.network.parameters()):
        np.testing.assert_allclose(_np(b), _np(a), **TOL)


def test_visualdl_records_match_the_reference(tmp_path):
    rng = np.random.RandomState(0)
    x = rng.randn(32, 4).astype(np.float32)
    y = np.random.RandomState(1).randn(32, 1).astype(np.float32)
    recs = {}
    for P in PACKAGES:
        P.seed(0)
        net = P.nn.Sequential(P.nn.Linear(4, 8), P.nn.ReLU(),
                              P.nn.Linear(8, 1))
        m = P.hapi.Model(net)
        m.prepare(P.optimizer.SGD(learning_rate=0.05,
                                  parameters=net.parameters()),
                  P.nn.MSELoss())
        logdir = str(tmp_path / P.__name__)
        from importlib import import_module

        vdl = import_module(P.__name__ + ".hapi.callbacks").VisualDL
        m.fit([(x[i], y[i]) for i in range(32)], eval_data=[
            (x[i], y[i]) for i in range(8)], batch_size=8, epochs=2,
            verbose=0, shuffle=False, callbacks=[vdl(log_dir=logdir)])
        with open(os.path.join(logdir, "scalars.jsonl")) as f:
            recs[P] = [json.loads(line) for line in f]
    j, t = recs[jpaddle], recs[tpaddle]
    assert [(r["tag"], r["step"]) for r in t] == \
        [(r["tag"], r["step"]) for r in j]
    np.testing.assert_allclose([r["value"] for r in t],
                               [r["value"] for r in j], **TOL)
    assert {"train/loss", "train_epoch/loss", "eval/loss"} <= \
        {r["tag"] for r in t}


def test_save_for_inference_waits_for_e3(tmp_path):
    from paddle_tpu_torch.jit import InputSpec

    net = tpaddle.nn.Linear(6, 2)
    m = tpaddle.hapi.Model(net, inputs=[InputSpec([4, 6], "float32")])
    assert repr(InputSpec([4, 6])) == "InputSpec(shape=(4, 6), dtype=float32)"
    with pytest.raises(NotImplementedError, match="E3"):
        m.save(str(tmp_path / "m"), training=False)
    assert not os.listdir(tmp_path)


def test_top_level_names():
    for name in ("hapi", "metric", "incubate", "Model", "summary", "flops",
                 "vision"):
        assert hasattr(tpaddle, name), name
    assert tpaddle.Model is tpaddle.hapi.Model
