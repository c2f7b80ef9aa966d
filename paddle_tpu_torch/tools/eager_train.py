"""The eager training loop of the port, as a user writes it, and the
resume check built on it; shared by ``chip_smoke.py`` (phases 15 and
16), ``tests/test_torch_card.py`` and ``tests/test_torch_checkpoint.py``.

The loop (``step``)::

    loss = criterion(model(x), y)
    scaler.scale(loss).backward()
    scaler.step(opt)          # unscale_, skip on inf, and update()
    scaler.update()
    opt.clear_grad()
    sched.step()

over ``decorate(model, opt, level="O2")``, ``AdamW(multi_precision=True,
grad_clip=ClipGradByGlobalNorm(1.0))`` on ``LinearWarmup(
CosineAnnealingDecay(3e-4, T_max=8), warmup_steps=2, start_lr=0,
end_lr=3e-4)`` and ``GradScaler(init_loss_scaling=2**15,
incr_every_n_steps=2)``; one batch of random ids and labels from
``np.random.RandomState(0)``, repeated every step. The configuration is
the caller's: chip_smoke takes ``tools/gpt_1b_train.py``'s
``bench_gpt_1b`` (16 layers; 2 for the resume), the CPU test the tiny
Llama. Like the JAX package's, ``GradScaler.step`` runs ``update``
itself, so this loop updates the scale twice per step.

:func:`resume` runs the loop without a break for RESUME_STEPS steps
(twice: the two must be bit-identical, or the report names the first
entry where they part), then for RESUME_SPLIT steps, saves the model,
the optimizer state (which carries the scheduler's) and the scaler's
state with ``CheckpointManager.save(block=True)``, builds a fresh model
and optimizer from another seed, restores, and runs the rest: its
losses, final parameters and optimizer slots, and the scaler's and
scheduler's state must equal the unbroken run's bit for bit.
"""
from __future__ import annotations

import copy
import os
import shutil
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch import amp
from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer.lr import CosineAnnealingDecay, LinearWarmup

__all__ = ["PEAK_LR", "Run", "build", "step", "state", "resume"]

PEAK_LR = 3e-4
INIT_SCALE = 2.0 ** 15
RESUME_STEPS = 6        # the unbroken run of the resume check
RESUME_SPLIT = 3        # steps before the save


@dataclass
class Run:
    model: LlamaForCausalLM
    opt: AdamW
    sched: LinearWarmup
    scaler: amp.GradScaler
    x: torch.Tensor
    y: torch.Tensor

    def close(self):
        for p in self.model.parameters():
            p.grad = None


def build(cfg: LlamaConfig, device, batch: Tuple[int, int],
          seed: int = 0) -> Run:
    """A model from ``seed`` with the loop's optimizer, scheduler and
    scaler, and the batch, all on ``device``."""
    model = LlamaForCausalLM(cfg, device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    sched = LinearWarmup(CosineAnnealingDecay(PEAK_LR, T_max=8),
                         warmup_steps=2, start_lr=0.0, end_lr=PEAK_LR)
    opt = AdamW(learning_rate=sched, parameters=model.parameters(),
                multi_precision=True, grad_clip=ClipGradByGlobalNorm(1.0))
    model, opt = amp.decorate(model, opt, level="O2")
    scaler = amp.GradScaler(init_loss_scaling=INIT_SCALE,
                            incr_every_n_steps=2)
    rng = np.random.RandomState(0)
    x = rng.randint(0, cfg.vocab_size, batch).astype(np.int64)
    y = rng.randint(0, cfg.vocab_size, batch).astype(np.int64)
    return Run(model, opt, sched, scaler, torch.from_numpy(x).to(device),
               torch.from_numpy(y).to(device))


def step(run: Run, corrupt=None) -> torch.Tensor:
    """One step of the user's loop; returns the (unscaled) loss.
    ``corrupt(model)``, when given, runs between backward and
    ``scaler.step`` (the inf-injection check)."""
    loss = run.model.criterion()(run.model(run.x), run.y)
    run.scaler.scale(loss).backward()
    if corrupt is not None:
        corrupt(run.model)
    run.scaler.step(run.opt)
    run.scaler.update()
    run.opt.clear_grad()
    run.sched.step()
    return loss.detach()


def state(run: Run) -> dict:
    """What a checkpoint holds: the model, the optimizer (slots, step,
    scheduler) and the scaler."""
    return {"model": run.model.state_dict(), "opt": run.opt.state_dict(),
            "scaler": run.scaler.state_dict()}


def _snapshot(run: Run, device=None) -> dict:
    """A copy of everything a step changes: each parameter and optimizer
    tensor (on ``device``, default its own), the optimizer's step and
    scheduler entries, the scaler's state and the scheduler's."""
    out = {f"param/{k}": v.detach().to(device or v.device, copy=True)
           for k, v in run.model.state_dict().items()}
    for k, v in run.opt.state_dict().items():
        out[f"opt/{k}"] = (v.detach().to(device or v.device, copy=True)
                           if isinstance(v, torch.Tensor)
                           else copy.deepcopy(v))
    out["scaler"] = run.scaler.state_dict()
    out["sched"] = run.sched.state_dict()
    return out


def _first_difference(a: dict, b: dict) -> Optional[str]:
    for k in a:
        same = (torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
                else a[k] == b[k])
        if not same:
            return k
    return None


def _bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def resume(cfg: LlamaConfig, device, batch: Tuple[int, int],
           root: str) -> dict:
    """The resume check (see the module docstring). Raises
    ``AssertionError`` when the resumed run is not bit-identical to the
    unbroken one, or when two unbroken runs already differ (the report
    then names the entry). Leaves ``root`` removed."""
    unbroken = []
    for _ in range(2):
        run = build(cfg, device, batch)
        losses = [step(run) for _ in range(RESUME_STEPS)]
        unbroken.append((torch.stack(losses).cpu(), _snapshot(run)))
        run.close()
        del run
    first = _first_difference(unbroken[0][1], unbroken[1][1])
    if not torch.equal(unbroken[0][0], unbroken[1][0]) or first is not None:
        raise AssertionError(
            f"two unbroken runs differ (nondeterminism): losses "
            f"{unbroken[0][0].tolist()} vs {unbroken[1][0].tolist()}, "
            f"first entry that differs: {first}")
    ref_losses, ref_state = unbroken[0]
    del unbroken

    shutil.rmtree(root, ignore_errors=True)
    mgr = CheckpointManager(root, keep_last_n=1)
    run = build(cfg, device, batch)
    before = [step(run) for _ in range(RESUME_SPLIT)]
    _sync(device)
    t0 = time.perf_counter()
    mgr.save(RESUME_SPLIT, state(run), block=True)
    save_s = time.perf_counter() - t0
    nbytes = _bytes(root)
    run.close()
    del run

    fresh = build(cfg, device, batch, seed=1)
    assert not torch.equal(next(fresh.model.parameters()),
                           ref_state[next(iter(ref_state))]), \
        "the fresh model must start from other weights"
    fresh.opt.init_slots()
    st = state(fresh)
    _sync(device)
    t0 = time.perf_counter()
    restored = mgr.restore(st)
    fresh.opt.set_state_dict(st["opt"])
    fresh.scaler.load_state_dict(st["scaler"])
    _sync(device)
    restore_s = time.perf_counter() - t0
    kind = torch.device(device).type
    on_device = all(t.device.type == kind
                    for t in list(fresh.model.state_dict().values())
                    + [v for v in fresh.opt.state_dict().values()
                       if isinstance(v, torch.Tensor)])
    after = [step(fresh) for _ in range(RESUME_STEPS - RESUME_SPLIT)]
    losses = torch.stack(before + after).cpu()
    final = _snapshot(fresh)
    fresh.close()
    shutil.rmtree(root, ignore_errors=True)
    diff = _first_difference(ref_state, final)
    report = {"steps": RESUME_STEPS, "split": RESUME_SPLIT,
              "restored_step": restored,
              "losses_unbroken": ref_losses.tolist(),
              "losses_resumed": losses.tolist(),
              "bit_identical_losses": bool(torch.equal(losses, ref_losses)),
              "bit_identical_state": diff is None,
              "first_state_difference": diff,
              "state_on_device": on_device,
              "checkpoint_bytes": nbytes, "save_s": save_s,
              "restore_s": restore_s}
    assert report["bit_identical_losses"] and diff is None, report
    assert on_device and restored == RESUME_SPLIT, report
    return report
