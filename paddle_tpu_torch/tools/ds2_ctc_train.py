"""A DeepSpeech2-shaped acoustic model written with the layer API: a
bidirectional ``nn.GRU`` stack over spectrogram frames, ``nn.Linear`` to
the 29 characters of LibriSpeech's alphabet (blank, space, apostrophe,
26 letters), ``nn.CTCLoss`` (warp-ctc semantics), trained with
``paddle.optimizer.AdamW`` and a global-norm clip. The recurrent widths
are DeepSpeech2's (161 spectrogram bins, 1024 hidden a direction, 3
layers); its convolution
front end is left out (the reference has nothing of it either). Weights
are random from ``paddle.seed``, features and labels seeded numpy.

:func:`build` takes the package, so the CPU tests run the same code on
``paddle_tpu`` and ``paddle_tpu_torch``; ``chip_smoke.py`` phase 24 trains
it on the card (:func:`train`) and holds one step against the CPU
(:func:`card_against_cpu`).

Run alone on the card::

    python -m paddle_tpu_torch.tools.ds2_ctc_train
"""
from __future__ import annotations

import json
import time

import numpy as np

__all__ = ["INPUT", "HIDDEN", "LAYERS", "CLASSES", "BATCH", "FRAMES",
           "build", "batch", "train", "loss_and_grads", "card_against_cpu"]

INPUT = 161        # spectrogram bins (20 ms windows at 16 kHz)
HIDDEN = 1024      # GRU units a direction
LAYERS = 3
CLASSES = 29       # blank + space + apostrophe + 26 letters
BATCH = 32
FRAMES = 800       # 8 s of audio at a 10 ms hop
LABELS = (150, 250)  # characters an utterance


def build(paddle, layers=LAYERS, hidden=HIDDEN, inputs=INPUT,
          classes=CLASSES, seed=0):
    """(model, loss layer); the model maps [B, T, inputs] features to
    [T, B, classes] logits."""
    nn = paddle.nn

    class DS2(nn.Layer):
        def __init__(self):
            super().__init__()
            self.rnn = nn.GRU(inputs, hidden, num_layers=layers,
                              direction="bidirect")
            self.fc = nn.Linear(2 * hidden, classes)

        def forward(self, x):
            y, _ = self.rnn(x)
            return paddle.transpose(self.fc(y), [1, 0, 2])

    paddle.seed(seed)
    return DS2(), nn.CTCLoss(blank=0, reduction="mean")


def batch(batch_size=BATCH, frames=FRAMES, labels=LABELS, inputs=INPUT,
          classes=CLASSES, seed=0):
    """Seeded numpy: features [B, T, inputs], labels [B, Lmax] in
    1..classes-1, input lengths (the last frames of some rows padding)
    and label lengths."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((batch_size, frames, inputs)).astype(
        np.float32)
    lo, hi = labels
    lab_len = rng.integers(lo, hi + 1, batch_size).astype(np.int64)
    lab = rng.integers(1, classes, (batch_size, hi)).astype(np.int64)
    in_len = (frames - rng.integers(0, frames // 8 + 1, batch_size)
              ).astype(np.int64)
    in_len[0] = frames
    return feats, lab, in_len, lab_len


def _tensors(paddle, data, place):
    return [paddle.to_tensor(a, place=place) for a in data]


def train(paddle, model, loss_fn, data, steps, lr=3e-4, clip=1.0,
          place=None, sync=None):
    """``steps`` AdamW steps on one batch, gradients clipped to global
    norm ``clip`` (DeepSpeech2 trains with a clipped norm): the losses
    and each step's wall time (``sync`` called before each clock read).
    At lr 1e-3 unclipped the full-size model overshoots on its third
    step on an H100; 3e-4 with the clip falls step by step."""
    x, lab, il, ll = _tensors(paddle, data, place)
    opt = paddle.optimizer.AdamW(
        learning_rate=lr, parameters=model.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(clip))
    losses, ms = [], []
    for _ in range(steps):
        if sync:
            sync()
        t0 = time.perf_counter()
        loss = loss_fn(model(x), lab, il, ll)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
        if sync:
            sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"losses": losses, "step_ms": ms}


def loss_and_grads(paddle, model, loss_fn, data, place=None):
    """One forward and backward: (loss, {parameter: gradient}) as numpy."""
    x, lab, il, ll = _tensors(paddle, data, place)
    loss = loss_fn(model(x), lab, il, ll)
    loss.backward()
    grads = {k: np.asarray(p.grad.numpy(), np.float64)
             for k, p in model.named_parameters()}
    model.clear_gradients()
    return float(loss), grads


def card_against_cpu(paddle, layers=1, batch_size=4, frames=100,
                     labels=(20, 40)):
    """The model at DeepSpeech2's widths, ``layers`` deep, from one set of
    weights on the card and on the CPU: |loss difference| / |loss| and
    each parameter's relative L2 gradient error. Float32, TF32 off."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data = batch(batch_size, frames, labels, seed=1)
    cpu, gpu = paddle.CPUPlace(), paddle.CUDAPlace(0)
    paddle.set_device("cpu")
    model, loss_fn = build(paddle, layers=layers, seed=1)
    state = {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}
    ref_loss, ref_g = loss_and_grads(paddle, model, loss_fn, data, cpu)
    paddle.set_device("gpu")
    model, loss_fn = build(paddle, layers=layers, seed=1)
    model.set_state_dict(state)
    loss, g = loss_and_grads(paddle, model, loss_fn, data, gpu)
    rel = {k: float(np.linalg.norm(g[k] - ref_g[k])
                    / max(np.linalg.norm(ref_g[k]), 1e-30)) for k in g}
    return {"layers": layers, "batch": batch_size, "frames": frames,
            "loss_cpu": ref_loss, "loss_card": loss,
            "loss_rel_err": abs(loss - ref_loss) / abs(ref_loss),
            "grad_rel_l2": rel, "grad_rel_l2_max": max(rel.values())}


def _main():
    import torch

    import paddle_tpu_torch as paddle

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    paddle.set_device("gpu")
    model, loss_fn = build(paddle)
    data = batch()
    torch.cuda.reset_peak_memory_stats()
    res = train(paddle, model, loss_fn, data, 4,
                place=paddle.CUDAPlace(0), sync=torch.cuda.synchronize)
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    res["card_against_cpu"] = card_against_cpu(paddle)
    print(json.dumps(res))


if __name__ == "__main__":
    _main()
