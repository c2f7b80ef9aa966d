"""BERT-base through the high-level API: the path of ``chip_smoke.py``
phase 33.

The configuration is the published ``uncased_L-12_H-768_A-12``
``bert_config.json`` (google-research/bert): vocab 30522, hidden 768, 12
layers, 12 heads, intermediate 3072, 512 positions, 2 token types,
GELU, dropout 0.1, layer norm eps 1e-12 (``models.bert.BertConfig``'s
defaults). Weights are random from ``paddle.seed``; token ids are
synthetic, from seeded numpy (no tokenizer, nothing downloaded).

* :func:`finetune`: the BERT paper's GLUE recipe, a 2-class
  ``BertForSequenceClassification`` at batch 32 x 128, AdamW at 2e-5,
  through ``Model.prepare(optimizer, CrossEntropyLoss, metric.Accuracy(),
  amp_configs="O1")`` and ``Model.fit`` with ``ModelCheckpoint`` (flat)
  and ``EarlyStopping``, then ``evaluate`` and ``predict``; a ``Model``
  loaded from the epoch's checkpoint predicts the same logits. Each
  training batch after the first replays the captured step.
* :func:`mlm_replay`: the paper's 512-token pre-training phase,
  ``BertForMaskedLM`` with ``BertPretrainingCriterion`` at 16 x 512 (15%
  of positions labelled), bf16 autocast, through ``jit.TrainStep``: a
  warm-up and the capture, then replays, held bit for bit against the
  same steps taken by ``__call__`` on a twin model.
* :func:`card_against_cpu`: three ``Model.fit`` batches of 8 x 128 at
  full widths and 2 layers, f32, on the card and on the CPU.

Run alone on the card::

    python -m paddle_tpu_torch.tools.bert_base_train
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

import numpy as np

__all__ = ["SEQ", "BATCH", "LR", "FINETUNE_BATCHES", "MLM_BATCH", "MLM_SEQ",
           "N_GEMM", "config", "cls_data", "mlm_data", "flops_per_token",
           "finetune", "mlm_replay", "card_against_cpu", "mask_ms"]

SEQ = 128               # the GLUE fine-tuning length
BATCH = 32
LR = 2e-5
FINETUNE_BATCHES = 12
EVAL_BATCHES = 2
MLM_BATCH = 16          # the paper's 512-token phase
MLM_SEQ = 512
MLM_REPLAYS = 4
CLS_TOKEN, SEP_TOKEN = 101, 102
# weights of the GEMMs a token passes through in the encoder: per layer
# the four attention projections and the two FFN matrices
N_GEMM = 12 * (4 * 768 * 768 + 2 * 768 * 3072)     # 84,934,656
N_DECODER = 30522 * 768                            # the tied decoder


def config(layers: int = 12):
    from paddle_tpu_torch.models.bert import BertConfig

    return BertConfig(num_hidden_layers=layers)


def flops_per_token(cfg, seq: int, mlm: bool = False) -> int:
    """Trained FLOPs a token: 6 * N_gemm (the encoder's GEMM weights,
    plus the tied decoder for the masked LM) + 12 * L * S * h for the
    non-causal attention's two matmuls, forward and backward."""
    n = cfg.num_hidden_layers * (
        4 * cfg.hidden_size ** 2
        + 2 * cfg.hidden_size * cfg.intermediate_size)
    if mlm:
        n += cfg.vocab_size * cfg.hidden_size
    return 6 * n + 12 * cfg.num_hidden_layers * seq * cfg.hidden_size


def cls_data(n: int, seed: int):
    """``n`` synthetic sentence pairs: [CLS] a [SEP] b [SEP] with random
    word ids, random lengths from seq/2 to seq, zero padding; token
    types 0/1 for the two segments; random 0/1 labels."""
    rng = np.random.default_rng(seed)
    seq = SEQ
    ids = np.zeros((n, seq), np.int64)
    types = np.zeros((n, seq), np.int64)
    for i in range(n):
        length = int(rng.integers(seq // 2, seq + 1))
        cut = int(rng.integers(2, length - 2))
        ids[i, :length] = rng.integers(1000, 30522, length)
        ids[i, 0] = CLS_TOKEN
        ids[i, cut] = SEP_TOKEN
        ids[i, length - 1] = SEP_TOKEN
        types[i, cut + 1:length] = 1
    labels = rng.integers(0, 2, (n,)).astype(np.int64)
    return ids, types, labels


def mlm_data():
    """16 x 512 random word ids (seed 0); 15% of the positions labelled
    with their id (the rest -100)."""
    rng = np.random.default_rng(0)
    ids = rng.integers(1000, 30522, (MLM_BATCH, MLM_SEQ)).astype(np.int64)
    ids[:, 0] = CLS_TOKEN
    labels = np.where(rng.random((MLM_BATCH, MLM_SEQ)) < 0.15, ids, -100)
    return ids, labels.astype(np.int64)


def _dataset(paddle, arrays):
    import paddle_tpu_torch.io  # noqa: F401

    class Rows(paddle.io.Dataset):
        def __len__(self):
            return len(arrays[0])

        def __getitem__(self, i):
            return tuple(a[i] for a in arrays)

    return Rows()


def _classifier(paddle, cfg, seed: int, amp=None):
    from paddle_tpu_torch.jit import InputSpec
    from paddle_tpu_torch.models.bert import BertForSequenceClassification

    paddle.seed(seed)
    net = BertForSequenceClassification(cfg, num_classes=2)
    model = paddle.Model(net, inputs=[InputSpec([None, SEQ], "int64"),
                                      InputSpec([None, SEQ], "int64")])
    model.prepare(paddle.optimizer.AdamW(LR, parameters=net.parameters()),
                  paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy(),
                  amp_configs=amp)
    return model


def _step_times(paddle, sync):
    """A callback timing each training batch (``sync`` before each clock
    read): step, train-metric forward and callbacks."""

    class StepTimes(paddle.hapi.Callback):
        def __init__(self):
            super().__init__()
            self.ms, self.losses = [], []

        def on_train_batch_begin(self, step, logs=None):
            sync()
            self._t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            sync()
            self.ms.append((time.perf_counter() - self._t0) * 1e3)
            self.losses.append(logs["loss"])

    return StepTimes()


def finetune(paddle, save_dir: str, sync=None) -> dict:
    """``Model.fit`` of the classifier over ``batches`` batches (one
    epoch, one evaluation), with ``ModelCheckpoint`` (flat files in
    ``save_dir``) and ``EarlyStopping``; then ``evaluate`` and
    ``predict`` on the eval rows, and the same ``predict`` from a fresh
    Model loaded from the epoch's checkpoint. Per-batch ms (the first
    batch warms up and captures the step; the train metrics are
    computed on it alone). 12 layers, bf16 autocast ("O1"), seed 0."""
    sync = sync or (lambda: None)
    cfg, batch, batches = config(12), BATCH, FINETUNE_BATCHES
    train = cls_data(batches * batch, seed=0)
    held = cls_data(EVAL_BATCHES * batch, seed=1)
    model = _classifier(paddle, cfg, 0, amp="O1")
    times = _step_times(paddle, sync)
    es = paddle.hapi.EarlyStopping(monitor="loss", patience=1, verbose=0)
    np.random.seed(0)
    history = model.fit(
        _dataset(paddle, train), eval_data=_dataset(paddle, held),
        batch_size=batch, epochs=1, log_freq=batches, verbose=0,
        shuffle=True, callbacks=[
            times, es,
            paddle.hapi.ModelCheckpoint(save_dir=save_dir)])
    ev = model.evaluate(_dataset(paddle, held), batch_size=batch, verbose=0)
    logits = model.predict(_dataset(paddle, held[:2]), batch_size=batch,
                           stack_outputs=True)[0]
    reload = _classifier(paddle, cfg, 1, amp="O1")
    reload.load(os.path.join(save_dir, "0"))
    again = reload.predict(_dataset(paddle, held[:2]), batch_size=batch,
                           stack_outputs=True)[0]
    return {"layers": cfg.num_hidden_layers, "batch": [batch, SEQ],
            "batches": batches, "amp": "O1", "losses": times.losses, "step_ms": times.ms,
            "history": history, "evaluate": ev,
            "files": sorted(os.listdir(save_dir)),
            "logits_shape": list(logits.shape),
            "reload_bit_identical": bool(np.array_equal(logits, again)),
            "logits": logits, "flops_per_token": flops_per_token(cfg, SEQ),
            "model": model}


def card_against_cpu(paddle) -> dict:
    """Three ``Model.fit`` batches of 8 x 128 (dropout on), ``evaluate``
    and ``predict`` at full widths and 2 layers deep, f32, TF32 off, on
    the CPU and on the card, each from the same seed and generator state
    (both models are built on the card, where the initializers' draws
    are fast, and one is moved to the CPU): the losses, the accuracy and
    the logits of both."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, batch, batches = config(2), 8, 3
    train = cls_data(batches * batch, seed=0)
    held = cls_data(batch, seed=1)
    out = {}
    for dev in ("cpu", "gpu"):
        paddle.set_device("gpu")
        model = _classifier(paddle, cfg, 0)
        if dev == "cpu":
            model.network.to("cpu")
            paddle.set_device("cpu")
        losses = _step_times(paddle, lambda: None)
        np.random.seed(0)
        model.fit(_dataset(paddle, train), batch_size=batch, epochs=1,
                  verbose=0, shuffle=False, callbacks=[losses])
        ev = model.evaluate(_dataset(paddle, held), batch_size=batch,
                            verbose=0)
        logits = model.predict(_dataset(paddle, held[:2]),
                               batch_size=batch, stack_outputs=True)[0]
        out[dev] = {"losses": losses.losses, "evaluate": ev,
                    "logits": logits, "device": str(model._device)}
    c, g = out["cpu"], out["gpu"]
    loss_err = max(abs(a - b) / abs(a) for a, b in zip(c["losses"],
                                                        g["losses"]))
    scale = np.abs(c["logits"]).max()
    return {"layers": 2, "batch": [batch, SEQ], "batches": batches,
            "devices": [c["device"], g["device"]],
            "losses_cpu": c["losses"], "losses_card": g["losses"],
            "loss_rel_err_max": float(loss_err),
            "acc_cpu": c["evaluate"]["acc"], "acc_card": g["evaluate"]["acc"],
            "logits_rel_err_max": float(
                np.abs(c["logits"] - g["logits"]).max() / scale)}


def _mlm_step(paddle, cfg):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.bert import (BertForMaskedLM,
                                              BertPretrainingCriterion)

    paddle.seed(0)
    model = BertForMaskedLM(cfg)
    opt = paddle.optimizer.AdamW(1e-4, parameters=model.parameters(),
                                 weight_decay=0.01)
    return model, TrainStep(model, BertPretrainingCriterion(cfg), opt)


@contextlib.contextmanager
def _deterministic():
    """Deterministic kernels inside (``torch.use_deterministic_algorithms``
    with cuBLAS's fixed workspace config, bf16 GEMM reductions in f32):
    on the card the default embedding and index backwards and split-K
    bf16 GEMMs sum in an order that varies from run to run, so two runs
    of the same eager step differ in the last bits."""
    import torch

    mm = torch.backends.cuda.matmul
    saved = (torch.are_deterministic_algorithms_enabled(),
             mm.allow_bf16_reduced_precision_reduction,
             os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0])
        mm.allow_bf16_reduced_precision_reduction = saved[1]
        if saved[2] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved[2]


def _mlm_run(paddle, cfg, how, x, y, replays, sync):
    """``1 + replays`` steps of a fresh masked-LM model through
    ``__call__`` (``how="call"``) or ``run_steps(1)``, each timed:
    (losses, ms, its parameters' copies (call) or None, model, step;
    the model and step None for ``call``)."""
    model, step = _mlm_step(paddle, cfg)
    losses, ms = [], []
    for _ in range(1 + replays):
        sync()
        t0 = time.perf_counter()
        with paddle.amp.auto_cast(level="O1"):
            loss = step(x, y) if how == "call" else \
                step.run_steps(1, x, y)[0]
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    if how == "call":
        return losses, ms, [p._data.detach().clone()
                            for p in model.parameters()], None, None
    return losses, ms, None, model, step


def mlm_replay(paddle, sync=None) -> dict:
    """Two masked-LM models from seed 0 under bf16 autocast, with
    deterministic kernels (:func:`_deterministic`): the first takes ``1 +
    replays`` ``TrainStep.__call__`` steps, the second as many
    ``run_steps(1)`` dispatches (on the card: the warm-up and the
    capture, then ``replays`` replays, each timed). Returns both loss
    lists, whether they and every parameter are bit-identical, and the
    replays' ms. 12 layers, 16 x 512, ``MLM_REPLAYS`` replays, seed 0."""
    import torch

    sync = sync or (lambda: None)
    cfg, batch, seq, replays = config(12), MLM_BATCH, MLM_SEQ, MLM_REPLAYS
    ids, labels = mlm_data()
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if torch.cuda.is_available() else torch.device("cpu")
    x = torch.from_numpy(ids).to(dev)
    y = torch.from_numpy(labels).to(dev)
    runs = {}
    with _deterministic():
        for how in ("call", "replay"):
            runs[how] = _mlm_run(paddle, cfg, how, x, y, replays, sync)
    (c_losses, c_ms, call_params, _, _), (losses, ms, _, model, step) = \
        runs["call"], runs["replay"]
    same = all(bool(torch.equal(a, p._data)) for a, p in
               zip(call_params, model.parameters()))
    return {"layers": cfg.num_hidden_layers, "batch": [batch, seq],
            "labelled": int((labels != -100).sum()),
            "call_losses": c_losses, "replay_losses": losses,
            "losses_bit_identical": c_losses == losses,
            "params_bit_identical": same,
            "call_step_ms": c_ms, "first_dispatch_ms": ms[0],
            "replay_step_ms": ms[1:], "graph_stats": step.graph_stats(),
            "flops_per_token": flops_per_token(cfg, seq, mlm=True),
            "model": model, "step": step}


def mask_ms() -> dict:
    """CUDA-event time of drawing one masked-LM step's dropout masks
    alone (12 layers, 16 x 512: the embeddings', and per layer the
    attention probabilities' and the two residual branches'), each as
    ``ops.dropout`` draws it from one key, after one warm-up draw."""
    import torch

    from paddle_tpu_torch.ops import random_ops

    cfg, batch, seq = config(12), MLM_BATCH, MLM_SEQ
    dev = torch.device("cuda", torch.cuda.current_device())
    h, heads = cfg.hidden_size, cfg.num_attention_heads
    shapes = [(batch, seq, h)] + cfg.num_hidden_layers * [
        (batch, heads, seq, seq), (batch, seq, h), (batch, seq, h)]
    key = torch.tensor([0, 1], dtype=torch.int64, device=dev)

    def draw():
        for shape in shapes:
            random_ops.bernoulli_bits(key, 0.9, shape, dev)

    draw()
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    draw()
    end.record()
    torch.cuda.synchronize(dev)
    return {"masks": len(shapes),
            "elements": int(sum(np.prod(s) for s in shapes)),
            "ms": start.elapsed_time(end)}


def _main():
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.profiler import device_peak_flops

    sync = torch.cuda.synchronize
    paddle.set_device("gpu")
    peak = device_peak_flops()
    with tempfile.TemporaryDirectory(prefix="bert_ft_") as d:
        ft = finetune(paddle, d, sync=sync)
    p50 = float(np.percentile(ft["step_ms"][1:], 50))
    tps = BATCH * SEQ / (p50 / 1e3)
    mlm = mlm_replay(paddle, sync=sync)
    mp50 = float(np.percentile(mlm["replay_step_ms"], 50))
    mtps = MLM_BATCH * MLM_SEQ / (mp50 / 1e3)
    print(json.dumps({
        "finetune": {"step_ms_p50": p50, "tokens_per_s": tps,
                     "mfu": ft["flops_per_token"] * tps / peak,
                     "losses": ft["losses"],
                     "reload_bit_identical": ft["reload_bit_identical"]},
        "mlm": {"step_ms_p50": mp50, "tokens_per_s": mtps,
                "mfu": mlm["flops_per_token"] * mtps / peak,
                "losses_bit_identical": mlm["losses_bit_identical"]},
        "card_against_cpu": card_against_cpu(paddle)}))


if __name__ == "__main__":
    _main()
