"""Card-versus-CPU training parity on ``LlamaConfig.tiny``, shared by
``chip_smoke.py`` (phases ``train_parity`` and ``eager_parity``) and
``tests/test_torch_card.py``, so that both hold the port to one check.

Both sides run in f32 with TF32 off, from the same seed-0 weights and the
same ``np.random.RandomState(0)`` batch of (2, 24) ids and labels.
:func:`run`: three ``TrainStep`` steps of AdamW (lr 1e-3, clip 1.0, no
decay on the norms). :func:`run_eager`: three steps of the eager loop
(``scaler.scale(loss).backward(); scaler.step(opt); scaler.update();
opt.clear_grad(); sched.step()``) with ``Momentum`` or ``AdamW`` (clip
1.0) on ``LinearWarmup(CosineAnnealingDecay(1e-3))`` and a
``GradScaler``. The card side goes through the flash attention kernels,
the CPU side through their plain versions; both are held to the same
tolerances.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch import amp
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.optimizer import AdamW, Momentum
from paddle_tpu_torch.optimizer.lr import CosineAnnealingDecay, LinearWarmup

__all__ = ["LR", "STEPS", "run", "run_eager"]

LR = 1e-3
STEPS = 3


def run(device) -> dict:
    """Train on ``device`` and on the CPU, assert that they agree, and
    return the numbers. Raises ``AssertionError`` when they do not, or
    when the card side launched no flash kernel."""
    card_model, cpu_model, x, y = _models(device)
    losses = []
    before = dict(fa.launches)
    for m in (card_model, cpu_model):
        opt = AdamW(LR, parameters=m.parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0),
                    apply_decay_param_fun=lambda n: "norm" not in n)
        step = TrainStep(m, m.criterion(), opt)
        losses.append([float(step(x, y)) for _ in range(STEPS)])
    launches = {k: fa.launches[k] - before[k] for k in before}
    return _compare(card_model, cpu_model, losses, launches,
                    {"model": "tiny", "dtype": "float32", "steps": STEPS})


def _models(device):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig.tiny()
    rng = np.random.RandomState(0)
    x = rng.randint(0, cfg.vocab_size, (2, 24)).astype(np.int64)
    y = rng.randint(0, cfg.vocab_size, (2, 24)).astype(np.int64)
    cpu_model = LlamaForCausalLM(cfg, device="cpu")
    cpu_model.init_weights(torch.Generator().manual_seed(0))
    card_model = LlamaForCausalLM(cfg, device=device)
    card_model.load_state_dict(cpu_model.state_dict())
    return card_model, cpu_model, x, y


def _compare(card_model, cpu_model, losses, launches, info) -> dict:
    assert all(n > 0 for n in launches.values()), launches
    # f32 both sides: losses to float noise; Adam's first step moves a
    # weight by about lr * sign(g), so a near-zero grad whose sign
    # differs lands up to 2 lr per step apart: hold the worst weight to
    # that and all but 0.1% of them to 1e-5
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4, atol=1e-4)
    worst, off, n = 0.0, 0, 0
    card_state = card_model.state_dict()
    for k, t in cpu_model.state_dict().items():
        diff = (card_state[k].cpu() - t).abs()
        worst = max(worst, float(diff.max()))
        off += int((diff > 1e-5).sum())
        n += diff.numel()
    assert worst <= 2 * LR * STEPS and off / n < 1e-3, (worst, off, n)
    return {**info, "losses_card": losses[0], "losses_cpu": losses[1],
            "max_param_diff": worst, "params_off_by_1e-5": off,
            "params": n, "kernel_launches": launches}


def run_eager(device, rule: str = "momentum") -> dict:
    """The eager loop with ``rule`` ("momentum" or "adamw"), a scheduler
    and a scaler, on ``device`` and on the CPU, held to :func:`run`'s
    tolerances; the scaler's states and the lrs must be equal."""
    card_model, cpu_model, x, y = _models(device)
    losses, lrs, scales = [], [], []
    before = dict(fa.launches)
    for m in (card_model, cpu_model):
        dev = next(m.parameters()).device
        sched = LinearWarmup(CosineAnnealingDecay(LR, T_max=8),
                             warmup_steps=2, start_lr=LR / 10, end_lr=LR)
        if rule == "momentum":
            opt = Momentum(sched, momentum=0.9, parameters=m.parameters(),
                           grad_clip=ClipGradByGlobalNorm(1.0))
        else:
            opt = AdamW(sched, parameters=m.parameters(),
                        grad_clip=ClipGradByGlobalNorm(1.0))
        scaler = amp.GradScaler(init_loss_scaling=2.0 ** 12,
                                incr_every_n_steps=2)
        crit = m.criterion()
        xs, ys = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        run_l, run_lr, run_s = [], [], []
        for _ in range(STEPS):
            run_lr.append(opt.get_lr())
            loss = crit(m(xs), ys)
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            sched.step()
            run_l.append(float(loss.detach()))
            run_s.append(scaler.state_dict())
        losses.append(run_l)
        lrs.append(run_lr)
        scales.append(run_s)
    launches = {k: fa.launches[k] - before[k] for k in before}
    assert lrs[0] == lrs[1] and scales[0] == scales[1], (lrs, scales)
    return _compare(card_model, cpu_model, losses, launches,
                    {"model": "tiny", "dtype": "float32", "steps": STEPS,
                     "loop": "eager", "rule": rule, "lrs": lrs[0],
                     "scaler_states": scales[0]})
