"""ResNet-50 trained through the high-level API from an image folder: the
path of ``chip_smoke.py`` phase 34, and the detection post-processing at
published sizes.

The network is ``vision.models.resnet50(num_classes=1000)`` (v1.5, the
stride on the bottleneck's 3 x 3; 25,557,032 parameters), weights random
from ``paddle.seed``. Training follows the ResNet paper's ImageNet recipe
(He et al. 2015, section 3.4): SGD with momentum 0.9, lr 0.1 divided by
10 at epochs 30 and 60 (``PiecewiseDecay`` stepped by epoch), weight
decay 1e-4, batch 256. The data is an ``ImageFolder`` of synthetic HWC
uint8 ``.npy`` images over 1000 class folders, their sides drawn from
256-500 (ImageNet's usual range), written once into a directory (no
Pillow, nothing downloaded). The training transform is
``RandomResizedCrop(224)``, ``RandomHorizontalFlip``, ``ToTensor`` and
``Normalize`` with the ImageNet mean and std; the evaluation transform
``Resize(256)`` (a 256 x 256 square, as the JAX package's ``Resize(int)``
makes, not the shorter side), ``CenterCrop(224)``, ``ToTensor`` and
``Normalize``. The loader's workers are seeded one by one
(:func:`seed_worker`): neither package reseeds numpy in a forked worker.

* :func:`train`: ``Model.prepare(Momentum, CrossEntropyLoss,
  Accuracy(topk=(1, 5)), amp_configs="O1")`` and ``Model.fit`` over
  1,024 images, two epochs of four batches (the first batch captures the
  step, the other seven replay it), with ``ModelCheckpoint`` (the second
  epoch's save and the final one), ``EarlyStopping`` and the
  ``LRScheduler`` callback; then ``evaluate`` and ``predict`` on 256
  held-out images, and a fresh ``Model.load`` of the final checkpoint.
* :func:`card_against_cpu`: three ``Model.fit`` batches of 4 x 3 x 224 x
  224 from the same folder and seed, float64 with TF32 off, on the card
  and on the CPU, then ``evaluate`` and ``predict``.
* :func:`replay_check`: a warm-up and capture, then three replays of the
  bf16 step at batch 64 against four ``TrainStep.__call__`` steps of an
  identical network, under deterministic kernels.
* :func:`detection`: ``generate_proposals`` at the Faster R-CNN paper's
  test setting (py-faster-rcnn's ``TEST.RPN_*``: one 600 x 1000 image, a
  38 x 63 stride-16 map, 9 anchors), ``yolo_box`` on YOLOv3's three heads
  at 608 x 608 (80 classes, the COCO anchors, batch 8), ``matrix_nms``
  over those 22,743 boxes an image and ``roi_align`` of the 300 proposals
  (1024 channels, 14 x 14), each on the card and on the CPU.

Run alone on the card::

    python -m paddle_tpu_torch.tools.resnet50_train
"""
from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np

__all__ = ["BATCH", "N_TRAIN", "N_EVAL", "EPOCHS", "CLASSES", "MEAN", "STD",
           "write_image_folder", "seed_worker", "transforms", "macs",
           "train", "card_against_cpu", "replay_check", "detection"]

BATCH = 256
N_TRAIN = 1024
N_EVAL = 256
EPOCHS = 2
CLASSES = 1000
SIDES = (256, 500)
WORKERS = 8
LR, MOMENTUM, WEIGHT_DECAY = 0.1, 0.9, 1e-4
LR_EPOCHS, LR_VALUES = [30, 60], [0.1, 0.01, 0.001]
MEAN = [0.485, 0.456, 0.406]
STD = [0.229, 0.224, 0.225]
EVAL_BATCH = 32         # evaluate / predict: a batch for each worker
REPLAY_BATCH = 64
REPLAYS = 3
# py-faster-rcnn's test-time RPN settings (TEST.RPN_PRE_NMS_TOP_N,
# RPN_POST_NMS_TOP_N, RPN_NMS_THRESH, RPN_MIN_SIZE) and its image scale
RPN = dict(pre_nms_top_n=6000, post_nms_top_n=300, nms_thresh=0.7,
           min_size=16.0)
RPN_IMAGE, RPN_STRIDE = (600, 1000), 16
# YOLOv3 at 608 x 608 (yolov3.cfg): per head its stride and COCO anchors
YOLO_SIZE, YOLO_BATCH, YOLO_CLASSES = 608, 8, 80
YOLO_HEADS = ((32, [116, 90, 156, 198, 373, 326]),
              (16, [30, 61, 62, 45, 59, 119]),
              (8, [10, 13, 16, 30, 33, 23]))


def write_image_folder(root: str, n: int, seed: int,
                       classes: int = CLASSES) -> str:
    """``n`` HWC uint8 ``.npy`` images under ``root/<class>/``, each of a
    random class and random sides in ``SIDES``; every one of the
    ``classes`` folders exists, so the folder has that many classes.
    A smooth random pattern (low-resolution noise repeated up) rather
    than white noise, so crops and resizes see structure."""
    rng = np.random.RandomState(seed)
    width = len(str(classes - 1))
    for c in range(classes):
        os.makedirs(os.path.join(root, f"n{c:0{width}d}"), exist_ok=True)
    labels = rng.randint(0, classes, n)
    # fine noise: one field, a window of it an image
    noise = rng.randint(0, 32, (2 * SIDES[1], 2 * SIDES[1], 1),
                        dtype=np.uint8)
    for i in range(n):
        h, w = rng.randint(SIDES[0], SIDES[1] + 1, 2)
        small = rng.randint(0, 256, ((h + 7) // 8, (w + 7) // 8, 3),
                            dtype=np.uint8)
        y, x = rng.randint(0, SIDES[1], 2)
        img = np.repeat(np.repeat(small, 8, 0), 8, 1)[:h, :w] ^ \
            noise[y:y + h, x:x + w]
        np.save(os.path.join(root, f"n{labels[i]:0{width}d}", f"{i}.npy"),
                img)
    return root


def seed_worker(wid: int) -> None:
    """A DataLoader ``worker_init_fn``: reseed numpy in each worker from
    the state it inherited (the parent's, which moves on every epoch) and
    its id, so the workers draw different crops."""
    np.random.seed((int(np.random.randint(0, 2 ** 31 - 1)) + 7919 * wid)
                   % (2 ** 32))


def transforms(paddle, train: bool):
    """The recipe's training or evaluation transform."""
    T = paddle.vision.transforms
    if train:
        head = [T.RandomResizedCrop(224), T.RandomHorizontalFlip()]
    else:
        head = [T.Resize(256), T.CenterCrop(224)]
    return T.Compose(head + [T.ToTensor(), T.Normalize(MEAN, STD)])


def _model(paddle, seed: int, amp=None, net=None, lr=None):
    """ResNet-50 from ``seed`` on the card (or ``net`` as it is) under the
    recipe's optimizer (``lr`` in place of its schedule when given)."""
    if net is None:
        paddle.set_device("gpu")
        paddle.seed(seed)
        net = paddle.vision.models.resnet50(num_classes=CLASSES)
    sched = lr or paddle.optimizer.lr.PiecewiseDecay(LR_EPOCHS, LR_VALUES)
    opt = paddle.optimizer.Momentum(learning_rate=sched, momentum=MOMENTUM,
                                    weight_decay=WEIGHT_DECAY,
                                    parameters=net.parameters())
    model = paddle.Model(net)
    model.prepare(opt, paddle.nn.CrossEntropyLoss(),
                  paddle.metric.Accuracy(topk=(1, 5)), amp_configs=amp)
    return model


def macs(paddle, net, size: int = 224) -> int:
    """Multiply-adds of one image's forward, reckoned from the shapes of
    the convolutions and linear layers it runs (output elements times
    the reduction each sums), by hooks on one forward."""
    total = [0]
    nn = paddle.nn

    def hook(layer, inputs, out):
        if isinstance(layer, nn.Conv2D):
            w = layer.weight.shape          # [out, in / groups, kh, kw]
            total[0] += int(np.prod(out.shape[1:])) * int(np.prod(w[1:]))
        else:
            total[0] += int(layer.weight.shape[0] * layer.weight.shape[1])

    hooks = [lyr.register_forward_post_hook(hook)
             for lyr in net.sublayers()
             if isinstance(lyr, (nn.Conv2D, nn.Linear))]
    try:
        with paddle.no_grad():
            net(paddle.zeros([1, 3, size, size]))
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def _callback(paddle, sync):
    """Per training batch: the step's ms (``sync`` before each clock
    read) and the host's wait for the batch, from the last batch's end
    (the first batch of an epoch waits from the epoch's start: the
    workers' start-up)."""

    class Times(paddle.hapi.Callback):
        def __init__(self):
            super().__init__()
            self.ms, self.wait_ms, self.first_wait_ms = [], [], []
            self.losses = []
            self._last = None

        def on_epoch_begin(self, epoch, logs=None):
            self._last = None
            self._epoch_t = time.perf_counter()

        def on_train_batch_begin(self, step, logs=None):
            now = time.perf_counter()
            if self._last is None:
                self.first_wait_ms.append((now - self._epoch_t) * 1e3)
            else:
                self.wait_ms.append((now - self._last) * 1e3)
            sync()
            self._t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            sync()
            self._last = time.perf_counter()
            self.ms.append((self._last - self._t0) * 1e3)
            self.losses.append(logs["loss"])

    return Times()


def _loader(paddle, ds, shuffle, device, batch=None):
    """The recipe's loader: ``WORKERS`` seeded workers, batches of
    ``batch`` (``BATCH``) through the shared-memory ring, sized for four
    of them (a 256 x 3 x 224 x 224 f32 batch is 154 MB; the ring's
    default holds 64 MiB a record, as the JAX package's does)."""
    batch = batch or BATCH
    loader = paddle.io.DataLoader(ds, batch_size=batch, shuffle=shuffle,
                                  drop_last=shuffle, num_workers=WORKERS,
                                  worker_init_fn=seed_worker,
                                  places=str(device))
    loader.shm_capacity_bytes = max(64 << 20,
                                    4 * (batch * 3 * 224 * 224 * 4 + 4096))
    return loader


def _buffers(net) -> dict:
    return {k: v._data.detach().clone() for k, v in net.state_dict().items()
            if k.endswith(("_mean", "_variance"))}


def train(paddle, train_root: str, eval_root: str, save_dir: str,
          sync=None) -> dict:
    """:func:`train`'s run (see the module's doc) on the card: per-batch
    ms, losses and loader waits, the evaluation, ``predict``'s logits and
    the reload's, the checkpoint files, the step's graph counts."""
    import torch

    sync = sync or (lambda: None)
    model = _model(paddle, 0, amp="O1")
    ImageFolder = paddle.vision.datasets.ImageFolder
    train_ds = ImageFolder(train_root, transform=transforms(paddle, True))
    held = ImageFolder(eval_root, transform=transforms(paddle, False))
    times = _callback(paddle, sync)
    callbacks = [times,
                 paddle.hapi.EarlyStopping(monitor="loss", patience=1,
                                           verbose=0),
                 paddle.hapi.ModelCheckpoint(save_freq=EPOCHS,
                                             save_dir=save_dir),
                 paddle.hapi.LRScheduler(by_step=False, by_epoch=True)]
    dev = model._device
    np.random.seed(0)
    t0 = time.perf_counter()
    history = model.fit(_loader(paddle, train_ds, True, dev),
                        eval_data=_loader(paddle, held, False, dev,
                                          EVAL_BATCH),
                        epochs=EPOCHS, eval_freq=EPOCHS, verbose=0,
                        callbacks=callbacks)
    sync()
    fit_s = time.perf_counter() - t0
    ev = model.evaluate(_loader(paddle, held, False, dev, EVAL_BATCH),
                        verbose=0)
    logits = model.predict(_loader(paddle, held, False, dev, EVAL_BATCH),
                           stack_outputs=True)[0]
    reload = _model(paddle, 1, amp="O1")
    reload.load(os.path.join(save_dir, "final"))
    again = reload.predict(_loader(paddle, held, False, dev, EVAL_BATCH),
                           stack_outputs=True)[0]
    mine, theirs = _buffers(model.network), _buffers(reload.network)
    return {"images": [N_TRAIN, N_EVAL], "batch": BATCH, "epochs": EPOCHS,
            "batches": len(times.ms), "amp": "O1", "losses": times.losses,
            "step_ms": times.ms, "loader_wait_ms": times.wait_ms,
            "loader_first_wait_ms": times.first_wait_ms,
            "fit_s": fit_s, "history": history, "evaluate": ev,
            "lr_after": model._optimizer.get_lr(),
            "files": sorted(os.listdir(save_dir)),
            "logits_shape": list(logits.shape),
            "logits_finite": bool(np.isfinite(logits).all()),
            "reload_bit_identical": bool(np.array_equal(logits, again)),
            "reload_buffers_equal": len(mine) == len(theirs) == 106 and all(
                bool(torch.equal(mine[k], theirs[k])) for k in mine),
            "graph_stats": model._train_step.graph_stats(), "model": model}


def _as_f64(x):
    return np.asarray(x, np.float64)


def card_against_cpu(paddle, train_root: str, eval_root: str) -> dict:
    """Three ``Model.fit`` batches of 4 x 3 x 224 x 224 (the first 12
    training images, in order, the training transform under one numpy
    seed), ``evaluate`` and ``predict`` on 4 held-out images, on the CPU
    and on the card from the same weights (one network built on the
    card, whose initializers draw fast, and a deep copy of it moved to
    the CPU) and generator state: losses, accuracies and logits. In
    float64, with TF32 off (restored after): in f32 this network's
    gradients at batch 4 lie 1.8-2.0% (over all parameters; up to 19% of
    a tensor's largest) from the float64 ones on either device, the
    train-mode batch norms of layer4 cancelling over 196 elements a
    channel, while the two devices' float64 gradients agree within
    1e-13. The lr is the recipe's scaled to the batch (0.1 x 4 / 256, the
    linear scaling rule): at 0.1 a batch of 4 diverges within three
    steps."""
    import copy

    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        T = paddle.vision.transforms
        Subset = paddle.io.Subset
        ImageFolder = paddle.vision.datasets.ImageFolder
        train_ds = Subset(ImageFolder(train_root, transform=T.Compose(
            [transforms(paddle, True), _as_f64])), list(range(12)))
        held = Subset(ImageFolder(eval_root, transform=T.Compose(
            [transforms(paddle, False), _as_f64])), list(range(4)))
        paddle.set_device("gpu")
        paddle.seed(0)
        card_net = paddle.vision.models.resnet50(num_classes=CLASSES)
        card_net.to(dtype="float64")
        nets = {"cpu": copy.deepcopy(card_net).to("cpu"), "gpu": card_net}
        rng = paddle.get_rng_state()
        for dev in ("cpu", "gpu"):
            paddle.set_device(dev)
            paddle.set_rng_state(rng)
            model = _model(paddle, 0, net=nets[dev], lr=LR * 4 / BATCH)
            times = _callback(paddle, lambda: None)
            np.random.seed(0)
            model.fit(train_ds, batch_size=4, epochs=1, shuffle=False,
                      verbose=0, callbacks=[times])
            ev = model.evaluate(held, batch_size=4, verbose=0)
            logits = model.predict(held, batch_size=4,
                                   stack_outputs=True)[0]
            out[dev] = {"losses": times.losses, "evaluate": ev,
                        "logits": logits, "device": str(model._device)}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        paddle.set_device("gpu")
    c, g = out["cpu"], out["gpu"]
    scale = float(np.abs(c["logits"]).max())
    return {"batch": [4, 3, 224, 224], "batches": 3, "lr": LR * 4 / BATCH,
            "dtype": str(c["logits"].dtype),
            "devices": [c["device"], g["device"]],
            "losses_cpu": c["losses"], "losses_card": g["losses"],
            "loss_rel_err_max": max(abs(a - b) / abs(a) for a, b in
                                    zip(c["losses"], g["losses"])),
            "acc_cpu": [c["evaluate"]["acc_top1"], c["evaluate"]["acc_top5"]],
            "acc_card": [g["evaluate"]["acc_top1"],
                         g["evaluate"]["acc_top5"]],
            "eval_loss_rel_err": abs(c["evaluate"]["loss"]
                                     - g["evaluate"]["loss"])
            / abs(c["evaluate"]["loss"]),
            "logits_err_over_largest": float(
                np.abs(c["logits"] - g["logits"]).max() / scale)}


def replay_check(paddle, sync=None) -> dict:
    """Two ResNet-50s from seed 0 (one and its deep copy) under bf16
    autocast and deterministic kernels: ``1 + REPLAYS``
    ``TrainStep.__call__`` steps on one, as many
    ``run_steps(1)`` dispatches on the other (the warm-up and capture,
    then the replays, each timed), on one batch of 64 synthetic images.
    Whether the losses, every parameter and every running statistic are
    bit-identical."""
    import copy

    import torch

    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.tools.bert_base_train import _deterministic

    sync = sync or (lambda: None)
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(REPLAY_BATCH, 3, 224, 224).astype(
        np.float32)).to(dev)
    y = torch.from_numpy(rng.randint(0, CLASSES, REPLAY_BATCH).astype(
        np.int64)).to(dev)
    runs = {}
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    t0 = time.perf_counter()
    paddle.seed(0)
    first = paddle.vision.models.resnet50(num_classes=CLASSES)
    twins = {"call": first, "replay": copy.deepcopy(first)}
    del first
    sync()
    build_s = time.perf_counter() - t0
    try:
        with _deterministic():
            for how in ("call", "replay"):
                net = twins.pop(how)
                net.train()
                opt = paddle.optimizer.Momentum(
                    learning_rate=LR, momentum=MOMENTUM,
                    weight_decay=WEIGHT_DECAY, parameters=net.parameters())
                step = TrainStep(net, paddle.nn.CrossEntropyLoss(), opt)
                losses, ms = [], []
                for _ in range(1 + REPLAYS):
                    sync()
                    t0 = time.perf_counter()
                    with paddle.amp.auto_cast(level="O1"):
                        loss = step(x, y) if how == "call" else \
                            step.run_steps(1, x, y)[0]
                    sync()
                    ms.append((time.perf_counter() - t0) * 1e3)
                    losses.append(float(loss))
                state = {k: v._data.detach().clone()
                         for k, v in net.state_dict().items()}
                runs[how] = (losses, ms, state,
                             step.graph_stats() if how == "replay" else None)
                del net, opt, step
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    (c_losses, c_ms, c_state, _), (losses, ms, state, stats) = \
        runs["call"], runs["replay"]
    params = [k for k in state if not k.endswith(("_mean", "_variance"))]
    bufs = [k for k in state if k.endswith(("_mean", "_variance"))]
    return {"batch": REPLAY_BATCH, "replays": REPLAYS, "build_s": build_s,
            "call_losses": c_losses, "replay_losses": losses,
            "losses_bit_identical": c_losses == losses,
            "params_bit_identical": all(
                bool(torch.equal(c_state[k], state[k])) for k in params),
            "buffers_bit_identical": all(
                bool(torch.equal(c_state[k], state[k])) for k in bufs),
            "n_params": len(params), "n_buffers": len(bufs),
            "call_step_ms": c_ms, "first_dispatch_ms": ms[0],
            "replay_step_ms": ms[1:], "graph_stats": stats}


def _rpn_inputs(rng):
    """One image's RPN outputs at py-faster-rcnn's test scale: scores
    (1, 9, 38, 63), deltas (1, 36, 38, 63), the 9 anchors (scales 8, 16,
    32 x ratios 0.5, 1, 2 of a 16-pixel base) at every stride-16
    position, unit variances."""
    h, w = (RPN_IMAGE[0] + RPN_STRIDE - 1) // RPN_STRIDE, \
        (RPN_IMAGE[1] + RPN_STRIDE - 1) // RPN_STRIDE
    base = []
    for ratio in (0.5, 1.0, 2.0):
        ws = np.round(np.sqrt(256.0 / ratio))
        hs = np.round(ws * ratio)
        for scale in (8, 16, 32):
            bw, bh = ws * scale, hs * scale
            base.append([7.5 - (bw - 1) / 2, 7.5 - (bh - 1) / 2,
                         7.5 + (bw - 1) / 2, 7.5 + (bh - 1) / 2])
    base = np.asarray(base, np.float32)
    sy, sx = np.meshgrid(np.arange(h) * RPN_STRIDE, np.arange(w) * RPN_STRIDE,
                         indexing="ij")
    shift = np.stack([sx, sy, sx, sy], -1).astype(np.float32)
    anchors = (shift[:, :, None, :] + base[None, None]).astype(np.float32)
    scores = rng.uniform(size=(1, 9, h, w)).astype(np.float32)
    deltas = rng.normal(scale=0.2, size=(1, 36, h, w)).astype(np.float32)
    return (scores, deltas, np.asarray([RPN_IMAGE], np.float32), anchors,
            np.ones_like(anchors))


def _timed(fn, sync, iters):
    """``fn()``'s result and, with ``iters``, its mean ms over that many
    more calls (None without)."""
    out = fn()
    if not iters:
        return out, None
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3 / iters


def _err(a, b) -> float:
    """Largest |a - b| over the largest |a| (0 for empty arrays)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.size == 0:
        return 0.0
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def detection(paddle, sync=None) -> dict:
    """:func:`detection`'s ops (see the module's doc) on the card and on
    the CPU from the same inputs: counts, kept indices, boxes and scores
    (their largest difference over the largest value) and the card's ms
    (host clock around ``sync``, the mean of 3 calls after one)."""
    vops = paddle.vision.ops
    sync = sync or (lambda: None)
    rng = np.random.RandomState(5)
    rpn = _rpn_inputs(rng)
    heads = [rng.normal(size=(YOLO_BATCH, 3 * (5 + YOLO_CLASSES),
                              YOLO_SIZE // s, YOLO_SIZE // s)
                        ).astype(np.float32) for s, _ in YOLO_HEADS]
    img_size = np.full((YOLO_BATCH, 2), YOLO_SIZE, np.int32)
    feat = rng.normal(size=(1, 1024) + rpn[0].shape[2:]).astype(np.float32)
    res, out = {}, {}
    for dev in ("cpu", "gpu"):
        paddle.set_device(dev)
        T = paddle.to_tensor
        s = sync if dev == "gpu" else (lambda: None)
        n = 3 if dev == "gpu" else 0         # the card's ms only
        r = {}
        (rois, rscores, num), r["generate_proposals_ms"] = _timed(
            lambda: vops.generate_proposals(*map(T, rpn),
                                            return_rois_num=True, **RPN), s, n)
        boxes, scores = [], []
        for (stride, anchors), x in zip(YOLO_HEADS, heads):
            (b, sc), ms = _timed(lambda: vops.yolo_box(
                T(x), T(img_size), anchors, YOLO_CLASSES, 0.005, stride), s,
                n)
            r[f"yolo_box_{YOLO_SIZE // stride}_ms"] = ms
            boxes.append(b)
            scores.append(sc)
        bb = paddle.concat(boxes, axis=1)
        ss = paddle.transpose(paddle.concat(scores, axis=1), [0, 2, 1])
        (mout, midx, mnum), r["matrix_nms_ms"] = _timed(
            lambda: vops.matrix_nms(bb, ss, score_threshold=0.01,
                                    keep_top_k=100, background_label=-1,
                                    return_index=True), s, n)
        aligned, r["roi_align_ms"] = _timed(
            lambda: vops.roi_align(T(feat), rois, num, 14,
                                   spatial_scale=1.0 / RPN_STRIDE), s, n)
        out[dev] = {"rois": rois.numpy(), "rscores": rscores.numpy(),
                    "num": num.numpy(), "boxes": bb.numpy(),
                    "scores": ss.numpy(), "mout": mout.numpy(),
                    "midx": midx.numpy(), "mnum": mnum.numpy(),
                    "aligned": aligned.numpy(),
                    "on_card": bool(rois._data.is_cuda
                                    and mout._data.is_cuda)}
        res[dev] = r
    paddle.set_device("gpu")
    c, g = out["cpu"], out["gpu"]
    return {
        "anchors": int(np.prod(rpn[0].shape)),
        "yolo_boxes_per_image": int(c["boxes"].shape[1]),
        "proposals": int(g["num"][0]), "matrix_nms_kept": g["mnum"].tolist(),
        "on_card": g["on_card"],
        "proposals_identical": bool(np.array_equal(c["num"], g["num"])),
        "rois_err": _err(c["rois"], g["rois"]) if c["rois"].shape ==
        g["rois"].shape else None,
        "roi_scores_identical": bool(np.array_equal(c["rscores"],
                                                    g["rscores"])),
        "yolo_boxes_err": _err(c["boxes"], g["boxes"]),
        "yolo_scores_err": _err(c["scores"], g["scores"]),
        "matrix_nms_index_identical": bool(
            np.array_equal(c["midx"], g["midx"])
            and np.array_equal(c["mnum"], g["mnum"])),
        "matrix_nms_err": _err(c["mout"], g["mout"]) if c["mout"].shape ==
        g["mout"].shape else None,
        "roi_align_shape": list(g["aligned"].shape),
        "roi_align_err": _err(c["aligned"], g["aligned"]) if
        c["aligned"].shape == g["aligned"].shape else None,
        "card_ms": res["gpu"]}


def _main():
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.profiler import device_peak_flops

    sync = torch.cuda.synchronize
    paddle.set_device("gpu")
    with tempfile.TemporaryDirectory(prefix="resnet50_") as d:
        tr = write_image_folder(os.path.join(d, "train"), N_TRAIN, 0)
        ev = write_image_folder(os.path.join(d, "val"), N_EVAL, 1)
        cc = card_against_cpu(paddle, tr, ev)
        ft = train(paddle, tr, ev, os.path.join(d, "ckpt"), sync=sync)
    net = ft.pop("model").network
    n_macs = macs(paddle, net)
    p50 = float(np.percentile(ft["step_ms"][1:], 50))
    ips = BATCH / (p50 / 1e3)
    print(json.dumps({
        "train": {"step_ms_p50": p50, "images_per_s": ips,
                  "mfu": 6 * n_macs * ips / device_peak_flops(),
                  "losses": ft["losses"],
                  "reload_bit_identical": ft["reload_bit_identical"]},
        "card_against_cpu": cc, "replay": replay_check(paddle, sync),
        "detection": detection(paddle, sync)}))


if __name__ == "__main__":
    _main()
